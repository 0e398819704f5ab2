"""Core-model sequence sampling (the hmmemit product).

The reference parses the 7 per-node transition rows but never uses them
(SURVEY.md quirk 10 — `data_readers/Profile_HMM.hpp:32-42` future-proofs
a full pipeline); this module is one of the consumers that gives them
meaning: a generative walk over the core profile (M/I/D states, begin at
node 0, exit past node LENG), emitting match/insert residues from the
parsed probability rows.

Host-side NumPy by design: sampling is control-flow-heavy, tiny (one
sequence at a time, ~LENG steps), and used for test corpora — not a
device workload. Profiles must be parsed with ``star_as_zero_prob=True``
so ``*`` (impossible) transitions carry probability 0, NOT the
reference's exp(-0)=1.0 quirk, which would make the last node's absent
m->d/d->d transitions certainties.
"""

from __future__ import annotations

import numpy as np

from ..io.hmmio import NUM_TRANSITIONS, ProfileHMM

# transition row layout (hmmio): m->m m->i m->d i->m i->i d->m d->d
_TMM, _TMI, _TMD, _TIM, _TII, _TDM, _TDD = range(NUM_TRANSITIONS)


def _pick(rng: np.random.Generator, probs: np.ndarray) -> int:
    total = float(probs.sum())
    if total <= 0.0:  # defensive: a dead-end row exits the model
        return 0
    return int(rng.choice(len(probs), p=probs / total))


def sample_sequence(
    hmm: ProfileHMM, rng: np.random.Generator, max_len: int = 100_000
) -> np.ndarray:
    """One core-model sample -> int32 tokens (alphabet indices 0..19).

    Walks B(=node 0, silent) -> {M,I,D} -> E; entering M_k or I_k emits
    a residue from the node's parsed emission row. Transitions out of
    node LENG lead to E (their m->d / d->d entries are '*' == prob 0
    under star_as_zero_prob=True).
    """
    last = hmm.model_length - 1  # == LENG
    trans = np.asarray(hmm.transitions, dtype=np.float64)
    match = np.asarray(hmm.match_emissions, dtype=np.float64)
    insert = np.asarray(hmm.insert_emissions, dtype=np.float64)
    out: list[int] = []
    k, state = 0, "M"  # node 0's M is the begin state (silent dummy M0)
    while len(out) < max_len:
        row = trans[k]
        if state == "M":
            c = _pick(rng, row[[_TMM, _TMI, _TMD]])
            if c == 0:  # M_k -> M_{k+1} (or E past the last node)
                if k == last:
                    break
                k += 1
                out.append(_pick(rng, match[k]))
            elif c == 1:  # M_k -> I_k
                state = "I"
                out.append(_pick(rng, insert[k]))
            else:  # M_k -> D_{k+1}
                if k == last:  # unreachable with * == 0; guard anyway
                    break
                k += 1
                state = "D"
        elif state == "I":
            c = _pick(rng, row[[_TIM, _TII]])
            if c == 0:  # I_k -> M_{k+1} (or E)
                if k == last:
                    break
                k += 1
                state = "M"
                out.append(_pick(rng, match[k]))
            else:  # I_k -> I_k
                out.append(_pick(rng, insert[k]))
        else:  # "D"
            c = _pick(rng, row[[_TDM, _TDD]])
            if c == 0:  # D_k -> M_{k+1} (or E)
                if k == last:
                    break
                k += 1
                state = "M"
                out.append(_pick(rng, match[k]))
            else:  # D_k -> D_{k+1}
                if k == last:
                    break
                k += 1
    return np.asarray(out, dtype=np.int32)


def sample_sequences(
    hmm: ProfileHMM, count: int, seed: int | None = None
) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [sample_sequence(hmm, rng) for _ in range(count)]
