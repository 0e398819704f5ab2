"""Profile construction from a multiple sequence alignment (the
hmmbuild product) and score calibration (the hmmcalibrate product).

The reference consumes pre-built, pre-calibrated Pfam profiles and
never constructs one; this closes the loop so the engine can go
MSA -> .hmm -> scan end to end (paired with io.msaio / io.hmmwrite).

Estimation is deliberately simple and documented rather than a clone of
hmmbuild's machinery (no Dirichlet mixture priors, no entropy/relative
weighting, no effective-sequence-number tuning):

* match emissions: observed counts + ONE pseudocount distributed as the
  HMMER background -> maximum a posteriori probabilities;
* insert emissions: fixed at the background (H3 does the same);
* transitions: per-state-group counts + fixed pseudocounts; plan-7
  disallowed moves (I->D, D->I) are dropped from counting; the last
  node's m->d / d->d are structural zeros ('*' in the written file);
* calibration: Gumbel with HMMER's fixed slope lambda = log 2 (bits
  domain) for MSV/Viterbi, mu by method of moments over random
  sequences scored by THIS engine's own kernels; Forward's exponential
  tail anchored at the simulated 96th percentile (H3's 0.04 tail mass
  convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.alphabet import AMINO_ACIDS, BACKGROUND_FREQUENCIES, NUM_AMINO_ACIDS
from ..io.hmmio import NUM_TRANSITIONS, ProfileHMM

_GAPS = frozenset("-._~ ")
_EULER = 0.5772156649015329
_LN2 = float(np.log(2.0))

# fixed transition pseudocounts per source-state group (m->m/i/d,
# i->m/i, d->m/d): enough mass that unobserved rows stay sane, small
# enough that a handful of observations dominates
_TM_PRIOR = (1.0, 0.1, 0.1)
_TI_PRIOR = (0.5, 0.5)
_TD_PRIOR = (0.5, 0.5)


def _aa_index(ch: str) -> int:
    return AMINO_ACIDS.find(ch.upper())


def _pb_weights(rows: list[str], match_cols: list[int]) -> np.ndarray:
    """Henikoff position-based sequence weights (H3's default): in each
    match column, a residue type observed c times among k distinct
    types contributes 1/(k*c) to every sequence carrying it — so ten
    identical copies share the weight one unique sequence gets alone.
    Normalized to mean 1 (total statistical mass stays = nseq)."""
    n = len(rows)
    w = np.zeros(n, dtype=np.float64)
    for ci in match_cols:
        col = [_aa_index(r[ci]) if r[ci] not in _GAPS else -1 for r in rows]
        counts: dict[int, int] = {}
        for aa in col:
            if aa >= 0:
                counts[aa] = counts.get(aa, 0) + 1
        k = len(counts)
        if k == 0:
            continue
        for i, aa in enumerate(col):
            if aa >= 0:
                w[i] += 1.0 / (k * counts[aa])
    if w.sum() <= 0.0:
        return np.ones(n, dtype=np.float64)
    return w * (n / w.sum())


def build_profile(
    rows: list[str],
    rf: str | None = None,
    name: str = "msa",
    weighting: str = "pb",
) -> ProfileHMM:
    """Aligned rows (+ optional RF match-column annotation) -> ProfileHMM.

    Match columns come from RF when present (alphanumeric = match, the
    shape ops.traceback.stockholm_msa writes); otherwise the standard
    gap-majority rule (a column with <= 50% gaps is a match column).
    ``weighting``: "pb" (Henikoff position-based, the H3 default —
    redundant copies of a sequence share one vote) or "none". Stats
    fields are zero — run :func:`calibrate_profile` before scanning
    with P-value thresholds.
    """
    if not rows:
        raise ValueError("empty alignment")
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise ValueError("ragged alignment rows")
    if rf is not None:
        match_cols = [i for i, c in enumerate(rf) if c.isalnum()]
    else:
        n = len(rows)
        match_cols = [
            i
            for i in range(width)
            if sum(r[i] in _GAPS for r in rows) * 2 <= n
        ]
    if not match_cols:
        raise ValueError("no match columns in alignment")
    leng = len(match_cols)
    m = leng + 1  # dummy M0, the file convention (SURVEY quirk 3)
    node_of_col = {c: k for k, c in enumerate(match_cols, start=1)}

    if weighting == "pb":
        weights = _pb_weights(rows, match_cols)
    elif weighting == "none":
        weights = np.ones(len(rows), dtype=np.float64)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")

    match_counts = np.zeros((m, NUM_AMINO_ACIDS), dtype=np.float64)
    tm = np.zeros((m, 3), dtype=np.float64)  # m->m, m->i, m->d
    ti = np.zeros((m, 2), dtype=np.float64)  # i->m, i->i
    td = np.zeros((m, 2), dtype=np.float64)  # d->m, d->d

    for row, w in zip(rows, weights):
        state, node = "M", 0  # begin = the silent M0
        for ci in range(width):
            ch = row[ci]
            k = node_of_col.get(ci)
            if k is None:  # insert column
                if ch in _GAPS:
                    continue
                aa = _aa_index(ch)
                if aa < 0:
                    continue  # unknown residue: skip (X/B/Z etc.)
                if state == "M":
                    tm[node, 1] += w
                elif state == "I":
                    ti[node, 1] += w
                # D -> I is not a plan-7 move; drop from counting
                state = "I"
                continue
            gap = ch in _GAPS
            aa = -1 if gap else _aa_index(ch)
            if not gap and aa < 0:
                gap = True  # unknown residue in a match column: delete
            if state == "M":
                tm[node, 2 if gap else 0] += w
            elif state == "I":
                if not gap:  # I -> D is not a plan-7 move
                    ti[node, 0] += w
            else:  # D
                td[node, 1 if gap else 0] += w
            state, node = ("D" if gap else "M"), k
            if not gap:
                match_counts[k, aa] += w
        # exit to E: recorded on the m->m / i->m / d->m slot of the
        # last visited node (the file stores node LENG's exits there)
        if state == "M":
            tm[node, 0] += w
        elif state == "I":
            ti[node, 0] += w
        else:
            td[node, 0] += w

    bg = BACKGROUND_FREQUENCIES.astype(np.float64)
    match = np.zeros((m, NUM_AMINO_ACIDS), dtype=np.float32)
    # +1 total pseudocount shaped like the background (MAP estimate)
    totals = match_counts.sum(axis=1, keepdims=True)
    match[1:] = ((match_counts[1:] + bg[None, :]) / (totals[1:] + 1.0)).astype(
        np.float32
    )
    insert = np.tile(bg.astype(np.float32), (m, 1))

    trans = np.zeros((m, NUM_TRANSITIONS), dtype=np.float32)
    tm_p = tm + np.array(_TM_PRIOR)
    ti_p = ti + np.array(_TI_PRIOR)
    td_p = td + np.array(_TD_PRIOR)
    # structural zeros at the last node: no D_{LENG+1} exists, so m->d
    # and d->d are impossible ('*' when written)
    tm_p[leng, 2] = 0.0
    td_p[leng, 1] = 0.0
    trans[:, 0:3] = (tm_p / tm_p.sum(axis=1, keepdims=True)).astype(np.float32)
    trans[:, 3:5] = (ti_p / ti_p.sum(axis=1, keepdims=True)).astype(np.float32)
    trans[:, 5:7] = (td_p / td_p.sum(axis=1, keepdims=True)).astype(np.float32)

    return ProfileHMM(
        name=name,
        model_length=m,
        match_emissions=match,
        insert_emissions=insert,
        transitions=trans,
    )


def calibrate_profile(
    hmm: ProfileHMM, n: int = 256, seq_len: int | None = None, seed: int = 0,
    device="cuda",
) -> ProfileHMM:
    """Fill the STATS LOCAL fields by simulation with this engine's own
    scan kernels on ``device``: the exact MSV scan, the eager Viterbi
    scan and the log-space Forward scan (the counterparts of ``msv_xla``,
    ``viterbi_xla`` and ``forward_xla``) on a CUDA device, their plain
    versions on the CPU.

    MSV/Viterbi: Gumbel, slope fixed at lambda = log 2 (bits), location
    mu = mean - EulerGamma/lambda over ``n`` uniform-random sequences.
    Forward: exponential tail anchored where 4% of the simulated mass
    lies above (tau = q96 + ln(0.04)/lambda), H3's tail-mass convention.
    """
    from ..pipeline import MSVScanner, forward_scores, viterbi_scores
    from .msv import MSVProfile
    from .p7 import P7Profile
    from .stats import nats_to_bits

    L = seq_len or int(min(400, max(100, hmm.model_length - 1)))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, NUM_AMINO_ACIDS, size=(n, L)).astype(np.int32)
    lengths = np.full(n, L, dtype=np.int32)

    scanner = MSVScanner(device)
    msv_bits = nats_to_bits(
        scanner.scan(
            MSVProfile.from_profile(hmm), scanner.stage(tokens, lengths)
        ).cpu().numpy()
    )
    p7 = P7Profile.from_profile(hmm)
    vit_bits = nats_to_bits(
        viterbi_scores(p7, tokens, lengths, device, lazy=False).cpu().numpy()
    )
    fwd_bits = nats_to_bits(
        forward_scores(p7, tokens, lengths, device, prob_space=False).cpu().numpy()
    )

    lam = _LN2
    return dataclasses.replace(
        hmm,
        stats_local_msv_mu=float(np.mean(msv_bits) - _EULER / lam),
        stats_local_msv_lambda=lam,
        stats_local_viterbi_mu=float(np.mean(vit_bits) - _EULER / lam),
        stats_local_viterbi_lambda=lam,
        stats_local_forward_theta=float(
            np.quantile(fwd_bits, 0.96) + np.log(0.04) / lam
        ),
        stats_local_forward_lambda=lam,
    )
