"""Random profile HMMs for differential fuzzing.

The port's copy of ``random_profile`` of the JAX suite's
``tests/test_fuzz_differential.py``: spiky Dirichlet emissions with
near-zero entries (scores that approach the clamp) and transition rows with
a quarter of the nodes delete-heavy (tdd 0.95), which drive the delete
chain hard. The same generator state gives the same profile, array for
array. ``pad_overflow_profile`` is that suite's pad-overflow regression
profile: the odds of 'A' are large at every state, so a padded step that
were not the emission identity would overflow the probability-space
Forward.
"""

from __future__ import annotations

import numpy as np

from ..io.hmmio import ProfileHMM

_STATS = dict(
    stats_local_msv_mu=-5.0, stats_local_msv_lambda=0.7,
    stats_local_viterbi_mu=-6.0, stats_local_viterbi_lambda=0.7,
    stats_local_forward_theta=-2.0, stats_local_forward_lambda=0.7,
)


def random_profile(rng: np.random.Generator, leng: int) -> ProfileHMM:
    m = leng + 1
    me = rng.dirichlet(np.full(20, 0.2), size=m).astype(np.float32)
    me[0] = 0.0  # dummy M0 row
    ie = rng.dirichlet(np.full(20, 1.0), size=m).astype(np.float32)
    tr = rng.dirichlet(np.full(7, 0.5), size=m).astype(np.float32)
    heavy = rng.integers(0, m, size=max(1, m // 4))
    tr[heavy, 6] = 0.95  # delete-heavy nodes (big tdd)
    return ProfileHMM(name=f"fuzz{leng}", model_length=m, match_emissions=me,
                      insert_emissions=ie, transitions=tr, **_STATS)


def pad_overflow_profile(rng: np.random.Generator) -> ProfileHMM:
    me = np.full((41, 20), 0.01 / 19, dtype=np.float32)
    me[:, 0] = 0.99
    me[0] = 0.0
    ie = rng.dirichlet(np.full(20, 1.0), size=41).astype(np.float32)
    tr = rng.dirichlet(np.full(7, 1.0), size=41).astype(np.float32)
    return ProfileHMM(name="padfuzz", model_length=41, match_emissions=me,
                      insert_emissions=ie, transitions=tr, **_STATS)
