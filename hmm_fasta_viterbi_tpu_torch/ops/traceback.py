"""Viterbi traceback and per-domain alignment rendering (host side).

The reference engine stops at scores; this module completes the
hmmsearch-style report: for each sequence that survives the cascade,
the optimal (Viterbi) state path through the multihit local model,
split into domains at B/E boundaries, rendered as aligned text blocks.

TPU-first placement: tracebacks are deliberately NOT a device kernel.
The chips' job is scanning millions of sequences (MSV/Viterbi/Forward
kernels, ops.pallas_*); alignment is only ever needed for the handful
of reported hits, where an O(L*M) vectorized NumPy pass per hit is
microseconds-to-milliseconds — the same division of labor as HMMER's
domain postprocessing, and it keeps argmax bookkeeping (which the MXU
cannot help with) off the hot path.

The DP here runs in float64 with the max-plus delete chain in closed
form: ``D[j] = max_{i<=j}(a0[i] - P[i]) + P[j]`` with P the tdd prefix
sums, i.e. one ``np.maximum.accumulate`` per residue instead of a
scalar chain — exact in real arithmetic, vectorized over states.
Backtracking picks argmax branches from the stored rows, so the walked
path's score reproduces the DP total to f64 rounding; tests pin it to
the f32 Viterbi oracle within 1e-3 (ops.reference.viterbi_oracle).

Reference role: the alignment product the reference's parsed-but-unused
transition data exists for (data_readers/Profile_HMM.hpp:32-42).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.alphabet import AMINO_ACIDS
from ..models.msv import length_transitions

NEG = -np.inf


@dataclasses.dataclass
class DomainAlignment:
    """One aligned domain of a Viterbi path (all coordinates 1-based,
    inclusive; hmm coordinates are match-node indices)."""

    seq_from: int
    seq_to: int
    hmm_from: int
    hmm_to: int
    # parallel strings over alignment columns:
    model_line: str  # consensus letter per column ('.' on insert)
    match_line: str  # letter on identity, '+' on positive score, ' ' else
    seq_line: str  # residue per column ('-' on delete)

    @property
    def n_columns(self) -> int:
        return len(self.seq_line)


# hard ceiling on the stored-rows DP footprint (3 x f64 [L+1, mr]);
# alignment targets reported hits, not genome-scale scans — past this,
# fail with guidance instead of swap-thrashing the host
TRACEBACK_MAX_GIB = 8.0


def _viterbi_rows(p7, tokens: np.ndarray):
    """Forward sweep storing every DP row (f64).

    Returns (score, M, I, D, specials) with M/I/D ``[L+1, mr]`` and
    specials a dict of ``[L+1]`` arrays (E/J/C/N/B); row t = state after
    consuming t tokens. Mirrors ops.reference._p7_oracle's recurrence
    (combine = max) with the delete chain in prefix-sum closed form.
    """
    tokens = np.asarray(tokens)
    seq_len = int(tokens.shape[0])
    mr = p7.num_states
    gib = 3 * 8 * (seq_len + 1) * max(mr, 1) / 2**30
    if gib > TRACEBACK_MAX_GIB:
        raise MemoryError(
            f"viterbi traceback needs ~{gib:.1f} GiB of DP rows for "
            f"L={seq_len}, M={mr} (limit {TRACEBACK_MAX_GIB}); align the "
            "posterior envelope subsequence (--domains env_from/env_to) "
            "instead of the full-length sequence"
        )
    tr_loop, tr_move = length_transitions(seq_len)
    tr_loop = float(tr_loop)
    tr_move = float(tr_move)

    tmm = p7.tmm.astype(np.float64)
    tmi = p7.tmi.astype(np.float64)
    tmd = p7.tmd.astype(np.float64)
    tim = p7.tim.astype(np.float64)
    tii = p7.tii.astype(np.float64)
    tdm = p7.tdm.astype(np.float64)
    tdd = p7.tdd.astype(np.float64)
    msc = p7.msc.astype(np.float64)  # [20, mr]
    isc = p7.isc.astype(np.float64)

    # delete-chain prefix sums: P[j] = sum of tdd[0..j-1]. -inf links
    # ('*' columns / kill_last) would make the closed form indeterminate
    # (inf - inf), so each is clipped to -1e9 — any chain crossing one
    # lands below -1e8 and is restored to -inf after the accumulate
    # (legitimate path scores are bounded by ~L * max|score| << 1e8)
    tdd_c = np.where(np.isfinite(tdd), tdd, -1.0e9)
    p_pref = np.concatenate(([0.0], np.cumsum(tdd_c[: mr - 1])))

    M = np.full((seq_len + 1, mr), NEG)
    I = np.full((seq_len + 1, mr), NEG)
    D = np.full((seq_len + 1, mr), NEG)
    E = np.full(seq_len + 1, NEG)
    J = np.full(seq_len + 1, NEG)
    C = np.full(seq_len + 1, NEG)
    N = np.full(seq_len + 1, NEG)
    B = np.full(seq_len + 1, NEG)
    N[0] = 0.0
    B[0] = tr_move

    def shift(x):
        return np.concatenate(([NEG], x[:-1]))

    with np.errstate(invalid="ignore"):
        for t in range(1, seq_len + 1):
            aa = int(tokens[t - 1])
            m, i_st, d = M[t - 1], I[t - 1], D[t - 1]
            diag = np.maximum(
                np.maximum(shift(m + tmm), shift(i_st + tim)),
                shift(d + tdm),
            )
            new_m = msc[aa] + np.maximum(diag, B[t - 1] + p7.tr_B_Mk)
            new_i = isc[aa] + np.maximum(m + tmi, i_st + tii)
            # closed-form sequential chain (see module docstring)
            a0 = shift(new_m + tmd)
            new_d = np.maximum.accumulate(a0 - p_pref) + p_pref
            new_d[~(new_d > -1.0e8)] = NEG  # clipped links -> true -inf
            E[t] = max(new_m.max(initial=NEG), new_d.max(initial=NEG))
            J[t] = max(J[t - 1] + tr_loop, E[t] + p7.tr_E_J)
            C[t] = max(C[t - 1] + tr_loop, E[t] + p7.tr_E_C)
            N[t] = N[t - 1] + tr_loop
            B[t] = max(N[t] + tr_move, J[t] + tr_move)
            M[t], I[t], D[t] = new_m, new_i, new_d

    score = C[seq_len] + tr_move
    return score, M, I, D, {
        "E": E, "J": J, "C": C, "N": N, "B": B,
        "tr_loop": tr_loop, "tr_move": tr_move,
    }


def viterbi_path(p7, tokens: np.ndarray):
    """(score, path): the optimal state path as a list of
    ``(state, t, j)`` tuples in left-to-right order. ``state`` is one of
    ``'N' 'B' 'M' 'I' 'D' 'E' 'J' 'C'``; ``t`` = tokens consumed (M/I at
    row t emit token t, 1-based); ``j`` = 0-based node index for M/I/D,
    -1 for specials. Empty path (score -inf) when no alignment exists."""
    tokens = np.asarray(tokens)
    seq_len = int(tokens.shape[0])
    mr = p7.num_states
    score, M, I, D, sp = _viterbi_rows(p7, tokens)
    if not np.isfinite(score):
        return float(score), []
    E, J, C, N, B = sp["E"], sp["J"], sp["C"], sp["N"], sp["B"]
    tr_loop = sp["tr_loop"]

    rev: list[tuple[str, int, int]] = []
    state, t, j = "C", seq_len, -1
    guard = 0
    max_steps = 4 * (seq_len + 2) * max(mr, 1)
    while not (state == "N" and t == 0):
        guard += 1
        if guard > max_steps:  # pragma: no cover - structural safety net
            raise RuntimeError("viterbi traceback did not terminate")
        rev.append((state, t, j))
        if state == "C":
            from_e = E[t] + p7.tr_E_C
            state, t = ("E", t) if C[t] == from_e else ("C", t - 1)
        elif state == "J":
            from_e = E[t] + p7.tr_E_J
            state, t = ("E", t) if J[t] == from_e else ("J", t - 1)
        elif state == "N":
            t -= 1
        elif state == "B":
            state = "N" if B[t] == N[t] + sp["tr_move"] else "J"
        elif state == "E":
            jm = int(np.argmax(M[t]))
            jd = int(np.argmax(D[t]))
            if M[t][jm] >= D[t][jd]:
                state, j = "M", jm
            else:
                state, j = "D", jd
        elif state == "M":
            cands = [
                (M[t - 1][j - 1] + p7.tmm[j - 1] if j > 0 else NEG, "M", t - 1, j - 1),
                (I[t - 1][j - 1] + p7.tim[j - 1] if j > 0 else NEG, "I", t - 1, j - 1),
                (D[t - 1][j - 1] + p7.tdm[j - 1] if j > 0 else NEG, "D", t - 1, j - 1),
                (B[t - 1] + p7.tr_B_Mk, "B", t - 1, -1),
            ]
            _, state, t, j = max(cands, key=lambda c: c[0])
        elif state == "I":
            a = M[t - 1][j] + p7.tmi[j]
            b = I[t - 1][j] + p7.tii[j]
            state = "M" if a >= b else "I"
            t -= 1
        elif state == "D":
            a = M[t][j - 1] + p7.tmd[j - 1] if j > 0 else NEG
            b = D[t][j - 1] + p7.tdd[j - 1] if j > 0 else NEG
            state, j = ("M", j - 1) if a >= b else ("D", j - 1)
        else:  # pragma: no cover
            raise AssertionError(state)
    rev.append(("N", 0, -1))
    return float(score), rev[::-1]


def consensus_string(p7) -> str:
    """Per-node consensus residue (argmax match emission log-odds)."""
    return "".join(AMINO_ACIDS[k] for k in np.argmax(p7.msc, axis=0))


def domain_alignments(p7, tokens: np.ndarray) -> tuple[float, list[DomainAlignment]]:
    """Viterbi-path domains of one sequence, rendered as alignments.

    Splits the optimal path at B -> M (domain start) and M/D -> E
    (domain end); each domain becomes aligned model/match/sequence
    lines in hmmsearch style. Returns (viterbi_score, domains)."""
    tokens = np.asarray(tokens)
    score, path = viterbi_path(p7, tokens)
    cons = consensus_string(p7)
    msc = p7.msc
    domains: list[DomainAlignment] = []
    cur: list[tuple[str, int, int]] | None = None
    for state, t, j in path:
        if state == "B":
            cur = []
        elif state in ("M", "I", "D") and cur is not None:
            cur.append((state, t, j))
        elif state == "E" and cur:
            mod, mat, seq = [], [], []
            emitted = [x for x in cur if x[0] in ("M", "I")]
            core = [x for x in cur if x[0] in ("M", "D")]
            for s, tt, jj in cur:
                if s == "M":
                    aa = int(tokens[tt - 1])
                    letter = AMINO_ACIDS[aa]
                    mod.append(cons[jj])
                    mat.append(
                        letter if letter == cons[jj]
                        else "+" if msc[aa, jj] > 0 else " "
                    )
                    seq.append(letter)
                elif s == "I":
                    mod.append(".")
                    mat.append(" ")
                    seq.append(AMINO_ACIDS[int(tokens[tt - 1])].lower())
                else:  # D
                    mod.append(cons[jj])
                    mat.append(" ")
                    seq.append("-")
            domains.append(
                DomainAlignment(
                    seq_from=emitted[0][1] if emitted else 0,
                    seq_to=emitted[-1][1] if emitted else 0,
                    hmm_from=core[0][2] + 1 if core else 0,
                    hmm_to=core[-1][2] + 1 if core else 0,
                    model_line="".join(mod),
                    match_line="".join(mat),
                    seq_line="".join(seq),
                )
            )
            cur = None
    return score, domains


def hit_alignments(
    p7, tokens: np.ndarray, envelopes=None
) -> list[DomainAlignment]:
    """Domain alignments for one hit, with an envelope fallback.

    Tries the full-length traceback first; when the sequence is past the
    TRACEBACK_MAX_GIB DP budget and posterior ``envelopes`` are
    available ([(from, to)] 1-based spans from the --domains decode),
    each envelope subsequence is aligned independently and its
    coordinates shifted back — the same envelope-subsequence semantics
    as the per-domain rescoring (the length model sees the envelope
    length, exactly like HMMER's domain postprocessing). Re-raises the
    MemoryError when no envelopes exist to fall back on."""
    try:
        return domain_alignments(p7, tokens)[1]
    except MemoryError:
        if not envelopes:
            raise
    doms: list[DomainAlignment] = []
    for f, t in envelopes:
        _, sub = domain_alignments(p7, np.asarray(tokens)[f - 1 : t])
        doms.extend(
            dataclasses.replace(
                d, seq_from=d.seq_from + f - 1, seq_to=d.seq_to + f - 1
            )
            for d in sub
        )
    return doms


def alignment_row(dom: DomainAlignment) -> dict:
    """The JSON-serializable form of one domain alignment (the inverse
    mapping is accepted by :func:`format_alignment`)."""
    return {
        "seq_from": dom.seq_from, "seq_to": dom.seq_to,
        "hmm_from": dom.hmm_from, "hmm_to": dom.hmm_to,
        "model": dom.model_line, "match": dom.match_line,
        "aseq": dom.seq_line,
    }


def _as_domain(dom: "DomainAlignment | dict") -> DomainAlignment:
    if isinstance(dom, dict):
        return DomainAlignment(
            seq_from=dom["seq_from"], seq_to=dom["seq_to"],
            hmm_from=dom["hmm_from"], hmm_to=dom["hmm_to"],
            model_line=dom["model"], match_line=dom["match"],
            seq_line=dom["aseq"],
        )
    return dom


def stockholm_msa(
    entries: "list[tuple[str, DomainAlignment | dict]]",
    num_states: int,
    profile_name: str = "",
) -> str:
    """Render domain alignments as one Stockholm 1.0 MSA.

    The multiple-alignment product of ``hmmalign`` / ``hmmsearch -A``
    (the reference never built either; its parsed-but-unused transition
    rows exist for exactly this stage — data_readers/Profile_HMM.hpp:
    32-42): every domain becomes one row named ``target/from-to``,
    aligned in model coordinate space. Column plan follows the HMMER
    convention — one column per match node 1..``num_states`` plus, after
    node k, as many lowercase insert columns as the longest insert run
    any row has there. Match columns hold the residue (upper case) or
    ``-`` on delete; ``.`` marks both insert-column padding and match
    columns outside a row's domain span. ``#=GC RF`` annotates match
    columns ``x``, insert columns ``.``.
    """
    parsed = []
    ins_len: dict[int, int] = {}
    for name, dom in entries:
        d = _as_domain(dom)
        matches: dict[int, str] = {}
        inserts: dict[int, str] = {}
        j = d.hmm_from - 1  # node last consumed; first non-'.' col is hmm_from
        for mod_c, seq_c in zip(d.model_line, d.seq_line):
            if mod_c == ".":  # insert run after node j
                inserts[j] = inserts.get(j, "") + seq_c.lower()
            else:
                j += 1
                matches[j] = "-" if seq_c == "-" else seq_c.upper()
        parsed.append((f"{name}/{d.seq_from}-{d.seq_to}", matches, inserts))
        for k, run in inserts.items():
            ins_len[k] = max(ins_len.get(k, 0), len(run))

    rows: list[tuple[str, str]] = []
    for row_name, matches, inserts in parsed:
        cols: list[str] = []
        for k in range(1, num_states + 1):
            cols.append(matches.get(k, "."))
            if ins_len.get(k):
                run = inserts.get(k, "")
                cols.append(run + "." * (ins_len[k] - len(run)))
        rows.append((row_name, "".join(cols)))

    rf = "".join(
        "x" + "." * ins_len.get(k, 0) for k in range(1, num_states + 1)
    )
    pad = max([len("#=GC RF")] + [len(n) for n, _ in rows]) + 2
    lines = ["# STOCKHOLM 1.0"]
    if profile_name:
        lines.append(f"#=GF ID {profile_name}")
    lines.append("")
    lines.extend(f"{n:<{pad}}{seq}" for n, seq in rows)
    lines.append(f"{'#=GC RF':<{pad}}{rf}")
    lines.append("//")
    return "\n".join(lines) + "\n"


def format_alignment(
    dom: "DomainAlignment | dict", name: str, seq_id: str, width: int = 60
) -> str:
    """hmmsearch-style wrapped alignment block for one domain (accepts
    the dataclass or its :func:`alignment_row` dict form)."""
    dom = _as_domain(dom)
    lines = []
    hp, sp_ = dom.hmm_from, dom.seq_from
    for off in range(0, dom.n_columns, width):
        mod = dom.model_line[off : off + width]
        mat = dom.match_line[off : off + width]
        seq = dom.seq_line[off : off + width]
        h_adv = sum(1 for c in mod if c != ".")
        s_adv = sum(1 for c in seq if c != "-")
        h_end = hp + h_adv - 1
        s_end = sp_ + s_adv - 1
        pad = max(len(name), len(seq_id)) + 2
        lines.append(f"{name:>{pad}} {hp:6d} {mod} {h_end}")
        lines.append(f"{'':>{pad}} {'':6s} {mat}")
        lines.append(f"{seq_id:>{pad}} {sp_:6d} {seq} {s_end}")
        lines.append("")
        hp, sp_ = h_end + 1, s_end + 1
    return "\n".join(lines)
