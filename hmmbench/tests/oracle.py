"""A frozen copy of the scan engine's sequential NumPy oracles (one row at
a time, the delete chain in strict left-to-right order, float32), kept
here to hold the benchmark's batched reference to at tiny sizes."""

import numpy as np

from hmmbench.reference import hmm as hmm_mod

NEG_INF = np.float32(-np.inf)


def msv(h, tokens: np.ndarray) -> np.float32:
    scores = hmm_mod.msv_table(h)
    b_mk, e_c, e_j = hmm_mod.entry_exit(h.leng)
    loop, move = hmm_mod.length_moves(np.array([len(tokens)]))
    loop, move = loop[0], move[0]
    m = np.full(h.leng + 1, NEG_INF, dtype=np.float32)
    j = c = NEG_INF
    n = np.float32(0.0)
    b = move
    for t in tokens:
        shifted = np.concatenate(([NEG_INF], m[:-1])).astype(np.float32)
        new = (scores[t] + np.maximum(shifted, b + b_mk)).astype(np.float32)
        new[0] = NEG_INF
        e = np.float32(new[1:].max())
        j = np.maximum(np.float32(j + loop), np.float32(e + e_j))
        c = np.maximum(np.float32(c + loop), np.float32(e + e_c))
        n = np.float32(n + loop)
        b = np.maximum(np.float32(n + move), np.float32(j + move))
        m = new
    return np.float32(c + move)


def _shift(x):
    return np.concatenate(([NEG_INF], x[:-1])).astype(np.float32)


def p7(h, tokens: np.ndarray, forward: bool) -> np.float32:
    combine = np.logaddexp if forward else np.maximum
    reduce_ = np.logaddexp.reduce if forward else np.max
    t7 = hmm_mod.p7_tables(h)
    b_mk, e_c, e_j = hmm_mod.entry_exit(h.leng)
    loop, move = hmm_mod.length_moves(np.array([len(tokens)]))
    loop, move = loop[0], move[0]
    mr = h.leng
    m = np.full(mr, NEG_INF, dtype=np.float32)
    i = m.copy()
    d = m.copy()
    j = c = NEG_INF
    n = np.float32(0.0)
    b = move
    for aa in tokens:
        diag = combine(combine(_shift(m + t7.tmm), _shift(i + t7.tim)), _shift(d + t7.tdm))
        new_m = (t7.msc[aa] + combine(diag, np.float32(b + b_mk))).astype(np.float32)
        new_i = (t7.isc[aa] + combine(m + t7.tmi, i + t7.tii)).astype(np.float32)
        new_d = np.full(mr, NEG_INF, dtype=np.float32)
        for k in range(1, mr):
            new_d[k] = combine(np.float32(new_m[k - 1] + t7.tmd[k - 1]),
                               np.float32(new_d[k - 1] + t7.tdd[k - 1]))
        e = combine(reduce_(new_m), reduce_(new_d))
        j = combine(np.float32(j + loop), np.float32(e + e_j))
        c = combine(np.float32(c + loop), np.float32(e + e_c))
        n = np.float32(n + loop)
        b = combine(np.float32(n + move), np.float32(j + move))
        m, i, d = new_m, new_i, new_d
    return np.float32(c + move)
