"""The plain reference's profile side: parse a HMMER3/b ``.hmm`` file and
work out the scoring tables and score statistics from it.

A frozen restatement of the scan engine's conventions, kept beside the
benchmark so that a change to the program cannot move its own yardstick.
It imports nothing of the program. The numerics follow the engine's
float32 conventions step for step, so the MSV tables (and with them the
MSV scores) come out bit for bit as the engine states them:

* a stored value ``x`` is the probability ``exp(-x)`` in float32; ``*``
  reads as 0.0, so as probability 1.0 (the engine's parser quirk), or as
  probability 0 with ``star_as_zero`` (what sampling needs);
* a dummy node 0 leads the model, ``m = LENG + 1``;
* emission scores are float32 log-odds against HMMER's background;
* local entry ``B->M_k = log(2 / (m (m + 1)))``, ``E->C = E->J = log(1/2)``,
  length-modelled ``N/C/J`` loops ``log(L / (L + 3))`` and moves
  ``log(3 / (L + 3))``;
* MSV and Viterbi scores are Gumbel-tailed in bits, Forward scores
  exponential-tailed, with the file's ``STATS LOCAL`` parameters.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

# HMMER's protein background (p7_AminoFrequencies), order ACDEFGHIKLMNPQRSTVWY
BACKGROUND = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062, 0.0695071, 0.0229198,
    0.0590092, 0.0594422, 0.0963728, 0.0237718, 0.0414386, 0.0482904, 0.0395639,
    0.0540978, 0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float32)

NEG_INF = np.float32(-np.inf)
LN2 = float(np.log(2.0))


@dataclasses.dataclass
class Hmm:
    name: str
    leng: int
    match: np.ndarray  # [LENG + 1, 20] f32 probabilities, row 0 zeros
    insert: np.ndarray  # [LENG + 1, 20]
    trans: np.ndarray  # [LENG + 1, 7]: m->m m->i m->d i->m i->i d->m d->d
    stats: dict  # "MSV" | "VITERBI" | "FORWARD" -> (mu or tau, lambda)


def _probs(rows: list[list[str]], n: int, star_as_zero: bool) -> np.ndarray:
    """The first ``n`` fields of each row, ``x`` -> ``exp(-x)`` in float32."""
    star = "inf" if star_as_zero else "0"
    vals = np.array([[star if w == "*" else w for w in row[:n]] for row in rows])
    return np.exp(-vals.astype(np.float32)).astype(np.float32)


def parse(path: str | pathlib.Path, star_as_zero: bool = False) -> Hmm:
    lines = pathlib.Path(path).read_text().splitlines()
    head = {}
    stats = {}
    pos = 0
    while not lines[pos].lstrip().startswith("COMPO"):
        words = lines[pos].split()
        if words and words[0] == "STATS":
            stats[words[2]] = (float(np.float32(words[3])), float(np.float32(words[4])))
        elif words:
            head.setdefault(words[0], words[1:])
        pos += 1
    leng = int(head["LENG"][0])
    body = [line.split() for line in lines[pos + 1: pos + 3 + 3 * leng]]
    nodes = body[2::3]
    if [w[0] for w in nodes] != [str(k) for k in range(1, leng + 1)]:
        raise ValueError(f"{path}: the node lines are not 1..{leng}")
    match = np.zeros((leng + 1, 20), dtype=np.float32)
    match[1:] = _probs([w[1:] for w in nodes], 20, star_as_zero)
    insert = _probs(body[0::3], 20, star_as_zero)
    trans = _probs(body[1::3], 7, star_as_zero)
    return Hmm(head["NAME"][0], leng, match, insert, trans, stats)


def _log_odds(probs: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(probs.astype(np.float32) / BACKGROUND[None, :]).astype(np.float32)


def entry_exit(leng: int) -> tuple[np.float32, np.float32, np.float32]:
    """``(B->M_k, E->C, E->J)`` in float32."""
    m = leng + 1
    b_mk = np.float32(np.log(np.float32(2.0) / np.float32(m * (m + 1))))
    nu = np.float32(2.0)
    return b_mk, np.float32(np.log((nu - np.float32(1.0)) / nu)), np.float32(np.log(np.float32(1.0) / nu))


def length_moves(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row float32 ``(loop, move)`` for residue counts ``lengths``."""
    size = np.asarray(lengths).astype(np.float32)
    with np.errstate(divide="ignore"):
        loop = np.log(size / (size + np.float32(3.0))).astype(np.float32)
    move = np.log(np.float32(3.0) / (size + np.float32(3.0))).astype(np.float32)
    return loop, move


def msv_table(hmm: Hmm) -> np.ndarray:
    """[20, LENG + 1] f32 match log-odds, column 0 (the dummy node) -inf."""
    return np.ascontiguousarray(_log_odds(hmm.match).T)


@dataclasses.dataclass
class P7Tables:
    msc: np.ndarray  # [20, LENG] f32, node j + 1 in column j
    isc: np.ndarray  # [20, LENG]
    tmm: np.ndarray  # [LENG] transitions out of node j + 1
    tmi: np.ndarray
    tmd: np.ndarray
    tim: np.ndarray
    tii: np.ndarray
    tdm: np.ndarray
    tdd: np.ndarray


def p7_tables(hmm: Hmm) -> P7Tables:
    """Full-model tables; a transition into the absent node LENG + 1 is -inf."""
    with np.errstate(divide="ignore"):
        t = np.log(hmm.trans[1:].astype(np.float32)).astype(np.float32)
    cols = {}
    for c, name in enumerate(("tmm", "tmi", "tmd", "tim", "tii", "tdm", "tdd")):
        v = np.array(t[:, c], copy=True)
        if name not in ("tmi", "tii"):
            v[-1] = NEG_INF
        cols[name] = v
    return P7Tables(np.ascontiguousarray(_log_odds(hmm.match[1:]).T),
                    np.ascontiguousarray(_log_odds(hmm.insert[1:]).T), **cols)


def gumbel_pvalue(nats: np.ndarray, mu: float, lam: float) -> np.ndarray:
    x = -lam * (np.asarray(nats, dtype=np.float64) / LN2 - mu)
    return -np.expm1(-np.exp(x))


def exp_tail_pvalue(nats: np.ndarray, tau: float, lam: float) -> np.ndarray:
    return np.minimum(1.0, np.exp(-lam * (np.asarray(nats, dtype=np.float64) / LN2 - tau)))


def pvalues(hmm: Hmm, stage: str, nats: np.ndarray) -> np.ndarray:
    """P-values of a stage's nat scores: ``msv`` and ``viterbi`` Gumbel,
    ``forward`` exponential."""
    if stage == "forward":
        return exp_tail_pvalue(nats, *hmm.stats["FORWARD"])
    return gumbel_pvalue(nats, *hmm.stats[stage.upper()])
