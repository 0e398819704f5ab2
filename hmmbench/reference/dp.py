"""The plain reference's dynamic programs, in plain PyTorch: MSV in
float32 in the engine's operand order (so its scores are exact, bit for
bit), and the full-model Viterbi and Forward in float64 over the same
float32 tables (so their scores are the model's own, with the program's
rounding left to show).

Rows of several profiles run together: a row carries its profile's
index, each table is padded to the widest profile, and a row is scored
once its own length is consumed. The delete chain ``D_j = max(D_{j-1} +
a_j, X_j)`` is the linear recurrence it is: with ``S_j`` the prefix sum
of ``a``, ``D = S + cummax(X - S)`` (Forward: ``logcumsumexp``).

``precision="bf16"`` is the control of the check: the same programs with
every table and every state rounded to bfloat16 after each step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hmm as hmm_mod

NEG = float("-inf")


def _rounder(precision: str):
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if precision in ("f32", "f64"):
        return lambda x: x
    raise ValueError(f"precision must be f32, f64 or bf16, got {precision!r}")


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x[:, j - 1] at column j, -inf at column 0."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=NEG)


def _blocks(lengths: np.ndarray, rows: int = 4096):
    """Index blocks of at most ``rows`` rows, sorted by length. A step
    costs about the same at any block width here (a few dozen small
    launches), so one block runs to its longest row."""
    order = np.argsort(lengths, kind="stable")
    for start in range(0, len(order), rows):
        yield order[start: start + rows]


def msv(hmms: list, prof: np.ndarray, tokens: np.ndarray, lengths: np.ndarray,
        device, precision: str = "f32") -> np.ndarray:
    """MSV scores (nats, f32) of ``tokens[r, :lengths[r]]`` against
    ``hmms[prof[r]]``."""
    rnd = _rounder(precision)
    m_max = max(h.leng for h in hmms) + 1
    table = np.full((len(hmms), 20, m_max), -np.inf, dtype=np.float32)
    b_mk = np.zeros(len(hmms), dtype=np.float32)
    e_c = np.zeros(len(hmms), dtype=np.float32)
    e_j = np.zeros(len(hmms), dtype=np.float32)
    for p, h in enumerate(hmms):
        table[p, :, : h.leng + 1] = hmm_mod.msv_table(h)
        b_mk[p], e_c[p], e_j[p] = hmm_mod.entry_exit(h.leng)
    table_d = rnd(torch.from_numpy(table.reshape(-1, m_max)).to(device))
    out = np.empty(len(prof), dtype=np.float32)
    for idx in _blocks(lengths):
        out[idx] = _msv_block(table_d, b_mk, e_c, e_j, prof[idx], tokens[idx],
                              lengths[idx], device, rnd)
    return out


def _msv_block(table, b_mk, e_c, e_j, prof, tokens, lengths, device, rnd):
    r = len(prof)
    l_max = int(lengths.max())
    loop, move = hmm_mod.length_moves(lengths)

    def col(x):
        return rnd(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)[:, None])

    loop, move, bmk, ec, ej = col(loop), col(move), col(b_mk[prof]), col(e_c[prof]), col(e_j[prof])
    base = torch.from_numpy(prof.astype(np.int64) * 20).to(device)
    tok = torch.from_numpy(tokens[:, :l_max].astype(np.int64)).to(device)
    last = torch.from_numpy(lengths.astype(np.int64) - 1).to(device)[:, None]
    m = torch.full((r, table.shape[1]), NEG, device=device)
    j = torch.full((r, 1), NEG, device=device)
    c = j.clone()
    n = torch.zeros((r, 1), device=device)
    b = move
    score = torch.full((r, 1), NEG, device=device)
    ends = set((lengths - 1).tolist())
    for t in range(l_max):
        emit = table.index_select(0, base + tok[:, t])
        m = rnd(emit + torch.maximum(_shift(m), rnd(b + bmk)))
        e = m[:, 1:].amax(dim=1, keepdim=True)
        j = rnd(torch.maximum(rnd(j + loop), rnd(e + ej)))
        c = rnd(torch.maximum(rnd(c + loop), rnd(e + ec)))
        n = rnd(n + loop)
        b = rnd(torch.maximum(rnd(n + move), rnd(j + move)))
        if t in ends:
            score = torch.where(last == t, rnd(c + move), score)
    return score[:, 0].cpu().numpy()


def p7(hmms: list, prof: np.ndarray, tokens: np.ndarray, lengths: np.ndarray, device,
       forward: bool, precision: str = "f64") -> np.ndarray:
    """Full local Viterbi (``forward=False``) or Forward scores (nats) of
    ``tokens[r, :lengths[r]]`` against ``hmms[prof[r]]``, in float64
    (``precision="bf16"``: the control)."""
    rnd = _rounder(precision)
    dtype = torch.float64 if precision == "f64" else torch.float32
    mr = max(h.leng for h in hmms)
    names = ("tmm", "tmi", "tmd", "tim", "tii", "tdm", "tdd")
    emit = np.full((2, len(hmms), 20, mr), -np.inf, dtype=np.float32)
    trans = np.full((len(names), len(hmms), mr), -np.inf, dtype=np.float32)
    consts = np.zeros((3, len(hmms)), dtype=np.float32)
    width = np.zeros(len(hmms), dtype=np.int64)
    for p, h in enumerate(hmms):
        t = hmm_mod.p7_tables(h)
        emit[0, p, :, : h.leng] = t.msc
        emit[1, p, :, : h.leng] = t.isc
        for k, name in enumerate(names):
            trans[k, p, : h.leng] = getattr(t, name)
        consts[:, p] = hmm_mod.entry_exit(h.leng)
        width[p] = h.leng

    def dev(x):
        return rnd(torch.from_numpy(x).to(device=device).to(dtype))

    emit_d = dev(emit.reshape(2, -1, mr))
    trans_d = dev(trans)
    out = np.empty(len(prof), dtype=np.float64)
    for idx in _blocks(lengths):
        out[idx] = _p7_block(emit_d, trans_d, consts, width, prof[idx], tokens[idx],
                             lengths[idx], device, dtype, forward, rnd)
    return out


def _p7_block(emit, trans, consts, width, prof, tokens, lengths, device, dtype, forward, rnd):
    r = len(prof)
    mr = emit.shape[2]
    l_max = int(lengths.max())
    if forward:
        comb = torch.logaddexp

        def reduce_(x):
            return torch.logsumexp(x, dim=1, keepdim=True)
    else:
        comb = torch.maximum

        def reduce_(x):
            return x.amax(dim=1, keepdim=True)

    p = torch.from_numpy(prof.astype(np.int64)).to(device)
    tmm, tmi, tmd, tim, tii, tdm, tdd = (trans[k].index_select(0, p) for k in range(7))
    # the delete chain's step a_j = tdd[j - 1], 0 at j = 0 and past a row's model
    states = torch.arange(mr, device=device)[None, :]
    live = states < torch.from_numpy(width[prof]).to(device)[:, None]
    step = torch.where(live & (states > 0), _shift(tdd), torch.zeros((), dtype=dtype, device=device))
    prefix = rnd(torch.cumsum(step, dim=1))

    def col(x):
        return rnd(torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)[:, None])

    loop, move = hmm_mod.length_moves(lengths)
    loop, move = col(loop), col(move)
    bmk, ec, ej = (col(consts[k][prof]) for k in range(3))
    base = p * 20
    tok = torch.from_numpy(tokens[:, :l_max].astype(np.int64)).to(device)
    last = torch.from_numpy(lengths.astype(np.int64) - 1).to(device)[:, None]
    neg = torch.full((r, mr), NEG, dtype=dtype, device=device)
    m, i, d = neg, neg, neg
    j = torch.full((r, 1), NEG, dtype=dtype, device=device)
    c = j.clone()
    n = torch.zeros((r, 1), dtype=dtype, device=device)
    b = move
    score = torch.full((r, 1), NEG, dtype=dtype, device=device)
    ends = set((lengths - 1).tolist())
    for t in range(l_max):
        rows = base + tok[:, t]
        ms = emit[0].index_select(0, rows)
        is_ = emit[1].index_select(0, rows)
        diag = _shift(comb(comb(m + tmm, i + tim), d + tdm))  # a shift commutes with comb
        new_m = rnd(ms + comb(diag, b + bmk))
        i = rnd(is_ + comb(m + tmi, i + tii))
        x = rnd(_shift(new_m + tmd) - prefix)
        run = torch.logcumsumexp(x, dim=1) if forward else torch.cummax(x, dim=1).values
        d = rnd(torch.where(live, prefix + run, neg))
        m = new_m
        e = comb(reduce_(m), reduce_(d))
        j = rnd(comb(j + loop, e + ej))
        c = rnd(comb(c + loop, e + ec))
        n = rnd(n + loop)
        b = rnd(comb(n + move, j + move))
        if t in ends:
            score = torch.where(last == t, rnd(c + move), score)
    return score[:, 0].cpu().numpy()
