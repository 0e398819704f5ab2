"""Score statistics: bits, P-values, E-values.

The reference parses the STATS LOCAL calibration lines of every profile
(Profile_HMM.hpp:32-42, SURVEY.md component #1) but never uses them —
they exist for exactly this stage of the HMMER pipeline. Following
HMMER3 semantics:

* MSV and Viterbi scores are Gumbel-distributed under the null:
  ``P(S > s) = 1 - exp(-exp(-lambda * (s_bits - mu)))``;
* Forward scores have an exponential tail:
  ``P(S > s) = exp(-lambda * (s_bits - tau))``;
* raw nat-space log-odds convert to bits via ``/ ln 2``;
* E-value = P-value * database size.

These are net-new capability (nothing to match in the reference); they
make the scan output actionable the way hmmsearch's is.
"""

from __future__ import annotations

import numpy as np

LN2 = float(np.log(2.0))


def nats_to_bits(score_nats: np.ndarray) -> np.ndarray:
    """Raw log-odds (nats, what the MSV scan returns) -> bit score."""
    return np.asarray(score_nats, dtype=np.float64) / LN2


def gumbel_pvalue(score_bits: np.ndarray, mu: float, lam: float) -> np.ndarray:
    """Gumbel survival function (MSV/Viterbi calibration).

    Uses -expm1(-exp(.)) for numerical stability at small P.
    """
    x = -lam * (np.asarray(score_bits, dtype=np.float64) - mu)
    return -np.expm1(-np.exp(x))


def exp_tail_pvalue(score_bits: np.ndarray, tau: float, lam: float) -> np.ndarray:
    """Exponential-tail survival function (Forward calibration)."""
    s = np.asarray(score_bits, dtype=np.float64)
    return np.minimum(1.0, np.exp(-lam * (s - tau)))


def msv_pvalue(score_nats: np.ndarray, profile) -> np.ndarray:
    """P-value of raw MSV scores using the profile's STATS LOCAL MSV line."""
    return gumbel_pvalue(
        nats_to_bits(score_nats),
        profile.stats_local_msv_mu,
        profile.stats_local_msv_lambda,
    )


def viterbi_pvalue(score_nats: np.ndarray, profile) -> np.ndarray:
    return gumbel_pvalue(
        nats_to_bits(score_nats),
        profile.stats_local_viterbi_mu,
        profile.stats_local_viterbi_lambda,
    )


def forward_pvalue(score_nats: np.ndarray, profile) -> np.ndarray:
    return exp_tail_pvalue(
        nats_to_bits(score_nats),
        profile.stats_local_forward_theta,
        profile.stats_local_forward_lambda,
    )


def evalue(pvalues: np.ndarray, database_size: int) -> np.ndarray:
    return np.asarray(pvalues, dtype=np.float64) * float(database_size)
