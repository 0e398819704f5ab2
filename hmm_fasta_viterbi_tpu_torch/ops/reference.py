"""NumPy golden-model implementations — the oracle every device path is
differentially tested against (the reference's own test strategy:
CPU sequential scan as oracle, algorithms/test_MSV.cpp:19-31).

``msv_oracle`` mirrors the reference recurrence (MSV_HMM.cpp:74-113) in
float32 with a rolling row (the reference's full [L][m+5] matrix is a
memory quirk, not a semantic one — SURVEY.md §3.5).
"""

from __future__ import annotations

import numpy as np

from ..models.msv import MSVProfile, length_transitions

NEG_INF = np.float32(-np.inf)


def msv_oracle(profile: MSVProfile, tokens: np.ndarray) -> np.float32:
    """Score one sequence (int tokens, no sentinel) against an MSV profile.

    Recurrence per residue i (reference MSV_HMM.cpp:100-111):
        M_j = emit[aa][j] + max(M_{j-1}^prev, B^prev + tr_B_Mk)
        E   = max_j M_j
        J   = max(J^prev + tr_loop, E + tr_E_J)
        C   = max(C^prev + tr_loop, E + tr_E_C)
        N   = N^prev + tr_loop
        B   = max(N + tr_move, J + tr_move)
    returning C_final + tr_move (MSV_HMM.cpp:112).
    """
    tokens = np.asarray(tokens)
    L = tokens.shape[0]
    tr_loop, tr_move = length_transitions(L)

    m = profile.model_length
    scores = profile.scores  # [20, m]

    M = np.full(m, NEG_INF, dtype=np.float32)  # previous row, M0..M_{m-1}
    J = NEG_INF
    C = NEG_INF
    N = np.float32(0.0)
    B = tr_move

    for i in range(L):
        emit = scores[tokens[i]]  # [m]
        # shift: new M_j uses previous M_{j-1}; M0 slot never updates
        shifted = np.concatenate(([NEG_INF], M[:-1])).astype(np.float32)
        newM = (emit + np.maximum(shifted, B + profile.tr_B_Mk)).astype(np.float32)
        newM[0] = NEG_INF  # dummy M0 (emit[0] is -inf anyway)
        E = np.float32(newM[1:].max()) if m > 1 else NEG_INF
        J = np.maximum(np.float32(J + tr_loop), np.float32(E + profile.tr_E_J))
        C = np.maximum(np.float32(C + tr_loop), np.float32(E + profile.tr_E_C))
        N = np.float32(N + tr_loop)
        B = np.maximum(np.float32(N + tr_move), np.float32(J + tr_move))
        M = newM

    return np.float32(C + tr_move)


def msv_oracle_batch(profile: MSVProfile, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Oracle over a padded batch [B, Lmax]; returns float32 [B]."""
    return np.array(
        [msv_oracle(profile, tokens[b, : lengths[b]]) for b in range(tokens.shape[0])],
        dtype=np.float32,
    )


def _shift(x: np.ndarray) -> np.ndarray:
    """j-1 shift with -inf fill (state axis)."""
    return np.concatenate(([NEG_INF], x[:-1])).astype(np.float32)


def _p7_oracle(p7, tokens: np.ndarray, combine, reduce_, record_rows=None):
    """Sequential full-profile DP in float32 — the golden model for both
    Viterbi (max) and Forward (logaddexp). Delete chain evaluated in
    strict left-to-right scalar order. ``record_rows`` (a dict) collects
    per-position M/I/D rows for posterior decoding."""
    tokens = np.asarray(tokens)
    seq_len = tokens.shape[0]
    mr = p7.num_states
    from ..models.msv import length_transitions  # local import, avoids cycle

    tr_loop, tr_move = length_transitions(seq_len)

    m = np.full(mr, NEG_INF, dtype=np.float32)
    i_st = np.full(mr, NEG_INF, dtype=np.float32)
    d = np.full(mr, NEG_INF, dtype=np.float32)
    j_st = NEG_INF
    c_st = NEG_INF
    n_st = np.float32(0.0)
    b_st = tr_move

    for t in range(seq_len):
        aa = tokens[t]
        ms = p7.msc[aa]
        is_ = p7.isc[aa]
        diag = combine(
            combine(_shift(m + p7.tmm), _shift(i_st + p7.tim)), _shift(d + p7.tdm)
        )
        new_m = (ms + combine(diag, np.float32(b_st + p7.tr_B_Mk))).astype(np.float32)
        new_i = (is_ + combine(m + p7.tmi, i_st + p7.tii)).astype(np.float32)
        new_d = np.full(mr, NEG_INF, dtype=np.float32)
        for j in range(1, mr):
            new_d[j] = combine(
                np.float32(new_m[j - 1] + p7.tmd[j - 1]),
                np.float32(new_d[j - 1] + p7.tdd[j - 1]),
            )
        e_st = combine(reduce_(new_m), reduce_(new_d)) if mr else NEG_INF
        j_st = combine(np.float32(j_st + tr_loop), np.float32(e_st + p7.tr_E_J))
        c_st = combine(np.float32(c_st + tr_loop), np.float32(e_st + p7.tr_E_C))
        n_st = np.float32(n_st + tr_loop)
        b_st = combine(np.float32(n_st + tr_move), np.float32(j_st + tr_move))
        m, i_st, d = new_m, new_i, new_d
        if record_rows is not None:
            record_rows["m"].append(m.copy())
            record_rows["i"].append(i_st.copy())
            record_rows["d"].append(d.copy())

    return np.float32(c_st + tr_move)


def viterbi_oracle(p7, tokens: np.ndarray) -> np.float32:
    """Full local Viterbi score, sequential float32 golden model."""
    return _p7_oracle(p7, tokens, np.maximum, np.max)


def forward_oracle(p7, tokens: np.ndarray) -> np.float32:
    """Forward (log-space) score, sequential float32 golden model."""
    return _p7_oracle(p7, tokens, np.logaddexp, np.logaddexp.reduce)


def _reduce_lse(x: np.ndarray) -> np.float32:
    m = np.max(x) if x.size else np.float32(NEG_INF)
    if np.isneginf(m):
        return np.float32(NEG_INF)
    return np.float32(m + np.log(np.exp(x - m).sum()))


def forward_rows(p7, tokens: np.ndarray):
    """Forward DP with per-position rows kept: (total, M, I, D) where
    each row array is [L+1, mr] (row t = state after consuming t tokens;
    row 0 is the -inf init). Thin wrapper over the shared _p7_oracle so
    there is exactly one NumPy Forward recurrence."""
    mr = p7.num_states
    init = np.full(mr, NEG_INF, dtype=np.float32)
    rec = {"m": [init.copy()], "i": [init.copy()], "d": [init.copy()]}
    total = _p7_oracle(
        p7, tokens, np.logaddexp, np.logaddexp.reduce, record_rows=rec
    )
    return total, np.stack(rec["m"]), np.stack(rec["i"]), np.stack(rec["d"])


def posterior_match(p7, tokens: np.ndarray):
    """Per-position match-state posteriors: P[t, j] = probability that
    the alignment path emits token t+1 (0-based row t) from match state
    j+1 — the forward-backward decode that underlies HMMER's domain
    postprocessing. Returns ([L, mr] float32, total_score)."""
    tokens = np.asarray(tokens)
    total_f, fm, _, _ = forward_rows(p7, tokens)
    total_b, bm, _, _ = backward_oracle(p7, tokens, return_rows=True)
    if not np.isfinite(total_f):
        return np.zeros((tokens.shape[0], p7.num_states), dtype=np.float32), total_f
    # row t >= 1 of fm pairs with beta row t (state M_j after t tokens)
    post = np.exp((fm[1:] + bm[1:]) - total_f).astype(np.float32)
    return post, total_f


def backward_oracle(p7, tokens: np.ndarray, return_rows: bool = False):
    """Backward (suffix) log-probabilities for the local multihit model.

    beta_t(state) = log P(emit tokens[t:] and reach T | in `state` after
    consuming t tokens). The model total is beta_0(N) (the forward init
    is N = 0), which must equal the Forward score — differentially
    tested. ``return_rows=True`` additionally returns the [L+1, mr]
    M/I/D beta rows for posterior decoding.

    The delete chain runs RIGHT-to-LEFT here (suffix affine chain) —
    the mirror of the forward oracle's left-to-right chain.
    """
    tokens = np.asarray(tokens)
    seq_len = tokens.shape[0]
    mr = p7.num_states
    tr_loop, tr_move = length_transitions(seq_len)
    lse = np.logaddexp
    neg = np.float32(NEG_INF)

    def sl(x):  # align j+1 -> j; -inf fill at j = mr-1
        return np.concatenate((x[1:], [neg])).astype(np.float32)

    # ---- t = L boundary: only emission-free exits remain -------------
    b_c = np.float32(tr_move)  # C -> T
    b_j = neg
    b_n = neg
    b_e = np.float32(p7.tr_E_C + b_c)  # E -> C
    b_d = np.full(mr, NEG_INF, dtype=np.float32)
    for jj in range(mr - 1, -1, -1):
        nxt = b_d[jj + 1] if jj + 1 < mr else neg
        b_d[jj] = lse(np.float32(p7.tdd[jj]) + nxt, b_e)
    b_m = lse(p7.tmd + sl(b_d), b_e).astype(np.float32)
    b_i = np.full(mr, NEG_INF, dtype=np.float32)

    rows_m = [b_m.copy()] if return_rows else None
    rows_i = [b_i.copy()] if return_rows else None
    rows_d = [b_d.copy()] if return_rows else None

    for t in range(seq_len - 1, -1, -1):
        ms_n = p7.msc[tokens[t]]  # emissions of token t+1 (0-based [t])
        is_n = p7.isc[tokens[t]]
        memit = (ms_n + b_m).astype(np.float32)  # ms[x,j] + beta_{t+1}(M_j)
        iemit = (is_n + b_i).astype(np.float32)
        m_next = sl(memit)  # ms[x,j+1] + beta_{t+1}(M_{j+1})

        new_b = _reduce_lse(np.float32(p7.tr_B_Mk) + memit)
        new_j = np.float32(lse(tr_loop + b_j, tr_move + new_b))
        new_n = np.float32(lse(tr_loop + b_n, tr_move + new_b))
        new_c = np.float32(tr_loop + b_c)
        new_e = np.float32(lse(p7.tr_E_C + new_c, p7.tr_E_J + new_j))

        new_i = lse(p7.tim + m_next, p7.tii + iemit).astype(np.float32)
        new_d = np.full(mr, NEG_INF, dtype=np.float32)
        for jj in range(mr - 1, -1, -1):
            nxt = new_d[jj + 1] if jj + 1 < mr else neg
            new_d[jj] = lse(
                lse(np.float32(p7.tdm[jj]) + m_next[jj],
                    np.float32(p7.tdd[jj]) + nxt),
                new_e,
            )
        new_m = lse(
            lse(p7.tmm + m_next, p7.tmi + iemit),
            lse(p7.tmd + sl(new_d), new_e),
        ).astype(np.float32)

        b_m, b_i, b_d, b_j, b_c, b_n = new_m, new_i, new_d, new_j, new_c, new_n
        if return_rows:
            rows_m.append(b_m.copy())
            rows_i.append(b_i.copy())
            rows_d.append(b_d.copy())

    total = np.float32(b_n) if seq_len > 0 else np.float32(NEG_INF)
    if return_rows:
        rows_m.reverse()
        rows_i.reverse()
        rows_d.reverse()
        return total, np.stack(rows_m), np.stack(rows_i), np.stack(rows_d)
    return total


def viterbi_oracle_batch(p7, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return np.array(
        [viterbi_oracle(p7, tokens[b, : lengths[b]]) for b in range(tokens.shape[0])],
        dtype=np.float32,
    )


def forward_oracle_batch(p7, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return np.array(
        [forward_oracle(p7, tokens[b, : lengths[b]]) for b in range(tokens.shape[0])],
        dtype=np.float32,
    )
