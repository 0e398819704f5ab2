"""Vectorised hmmemit: sample homologous domains from a profile's core
model, many at once.

The walk is the engine's ``models/sample.py`` (HMMER's hmmemit on the core
model): begin at node 0, take each node's transitions, emit a residue on
entering a match or insert state, leave past node LENG. Every path visits
each node once, in its match or its delete state, so the walk advances
all samples one node at a time: a node's match residues, its insert
runs (a geometric count from ``i->i``) and the state it hands to the next
node are drawn for every sample with one NumPy call each. The profile
must be parsed with ``star_as_zero`` (``*`` is an impossible move).
"""

from __future__ import annotations

import numpy as np

MM, MI, MD, IM, II, DM, DD = range(7)


def _draw(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Index of ``u`` in each row's cumulative distribution ``cdf``."""
    return np.minimum((u[:, None] >= cdf).sum(axis=1), cdf.shape[1] - 1)


def _cdf(rows: np.ndarray) -> np.ndarray:
    rows = rows.astype(np.float64)
    total = rows.sum(axis=-1, keepdims=True)
    return np.cumsum(rows / np.where(total > 0, total, 1.0), axis=-1)


def emit_domains(hmm, count: int, rng: np.random.Generator, max_len: int) -> list[np.ndarray]:
    """``count`` sampled domains of ``hmm`` (a ``reference.hmm.Hmm``), each
    int8 tokens of at most ``max_len`` residues."""
    leng = hmm.leng
    t = hmm.trans.astype(np.float64)
    match_cdf = _cdf(hmm.match)
    insert_cdf = _cdf(hmm.insert)
    from_m = _cdf(t[:, [MM, MI, MD]])
    from_d = _cdf(t[:, [DM, DD]])
    with np.errstate(divide="ignore", invalid="ignore"):
        stay = np.nan_to_num(t[:, II] / (t[:, IM] + t[:, II]))
    stay = np.minimum(stay, 0.99)  # an insert run ends

    match_tok = np.full((count, leng + 1), -1, dtype=np.int16)
    n_ins = np.zeros((count, leng + 1), dtype=np.int64)
    in_d = np.zeros(count, dtype=bool)  # node 0 is the begin state, a match
    for k in range(leng + 1):
        in_m = ~in_d
        if k > 0:
            hit = np.flatnonzero(in_m)
            match_tok[hit, k] = _draw(np.broadcast_to(match_cdf[k], (hit.size, 20)),
                                      rng.random(hit.size))
        move_m = _draw(np.broadcast_to(from_m[k], (count, 3)), rng.random(count))
        move_d = _draw(np.broadcast_to(from_d[k], (count, 2)), rng.random(count))
        runs = rng.geometric(1.0 - stay[k], size=count)
        n_ins[:, k] = np.where(in_m & (move_m == 1), runs, 0)
        in_d = np.where(in_m, move_m == 2, move_d == 1)

    has_m = match_tok >= 0
    per_node = has_m.astype(np.int64) + n_ins
    starts = np.cumsum(per_node.ravel()) - per_node.ravel()
    total = int(per_node.sum())
    flat = np.empty(total, dtype=np.int8)
    flat[starts[has_m.ravel()]] = match_tok.ravel()[has_m.ravel()]
    runs = n_ins.ravel()
    node = np.repeat(np.tile(np.arange(leng + 1), count), runs)
    first = np.repeat(starts + has_m.ravel(), runs)
    within = np.arange(runs.sum()) - np.repeat(np.cumsum(runs) - runs, runs)
    flat[first + within] = _draw(insert_cdf[node], rng.random(node.size))
    ends = np.cumsum(per_node.sum(axis=1))
    return [seq[:max_len] for seq in np.split(flat, ends[:-1])]
