"""Fuzzed profiles through the PyTorch port's plain versions, held against
the JAX package's oracles: the port's copy of the generator of
tests/test_fuzz_differential.py (models/fuzz.py) with that file's seeds
(MSV 100-102, Viterbi and Forward 200-201, the Viterbi filter 300-302, the
posterior 400-401) and its pad-overflow regression.

Tolerances are the North star's: MSV 1e-4 (equal expected), Viterbi 1e-4,
Forward 2e-3, posterior coverage and totals 2e-3 (the JAX file's), every
filter >= its exact stage. The eager Viterbi scan is held to the oracle
and the lazy one (these profiles keep e_skip_d) equal to it."""

import numpy as np
import pytest

from test_fuzz_differential import random_profile as jax_random_profile

from hmm_fasta_viterbi_tpu.models.msv import MSVProfile as JaxMSVProfile
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile as JaxP7Profile
from hmm_fasta_viterbi_tpu.ops.p7_scan import posterior_coverage_batch_xla
from hmm_fasta_viterbi_tpu.ops.reference import (
    forward_oracle_batch, msv_oracle_batch, viterbi_oracle_batch,
)
from hmm_fasta_viterbi_tpu_torch import MSVProfile, P7Profile
from hmm_fasta_viterbi_tpu_torch.models.fuzz import pad_overflow_profile, random_profile
from hmm_fasta_viterbi_tpu_torch.ops.posterior_cuda import posterior_coverage_batch
from hmm_fasta_viterbi_tpu_torch.pipeline import (
    MSVScanner, forward_scores, viterbi_filter_scores, viterbi_scores,
)

MSV_TOL, VIT_TOL, FWD_TOL, POST_TOL = 1e-4, 1e-4, 2e-3, 2e-3


def _profiles(seed: int, lo: int, hi: int):
    """(the port's profile, JAX's profile, the generator after them) for
    one seed, drawn the way tests/test_fuzz_differential.py draws them."""
    rng_port, rng_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    port = random_profile(rng_port, int(rng_port.integers(lo, hi)))
    jax = jax_random_profile(rng_jax, int(rng_jax.integers(lo, hi)))
    return port, jax, rng_port


@pytest.mark.parametrize("seed", [100, 101, 102, 200, 201, 300, 301, 302, 400, 401])
def test_generator_is_the_jax_suites(seed):
    port, jax, _ = _profiles(seed, 3, 60)
    assert (port.name, port.model_length) == (jax.name, jax.model_length)
    for field in ("match_emissions", "insert_emissions", "transitions"):
        np.testing.assert_array_equal(getattr(port, field), getattr(jax, field))


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_fuzz_msv(seed):
    hmm, jax_hmm, rng = _profiles(seed, 3, 60)
    lengths = rng.integers(0, 96, size=6).astype(np.int32)
    tokens = rng.integers(0, 20, size=(6, 96)).astype(np.int32)
    scanner = MSVScanner(device="cpu")
    staged = scanner.stage(tokens, lengths)
    profile = MSVProfile.from_profile(hmm)
    got = scanner.scan(profile, staged).numpy()
    want = msv_oracle_batch(JaxMSVProfile.from_profile(jax_hmm), tokens, lengths)
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=MSV_TOL, rtol=0)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isneginf(got[~finite]))
    assert np.all(scanner.scan_filter(profile, staged).numpy() >= got)


@pytest.mark.parametrize("seed", [200, 201])
def test_fuzz_p7(seed):
    hmm, jax_hmm, rng = _profiles(seed, 3, 40)
    lengths = np.array([48, 1, 31, 64], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 64)).astype(np.int32)
    p7, jax_p7 = P7Profile.from_profile(hmm), JaxP7Profile.from_profile(jax_hmm)

    want_v = viterbi_oracle_batch(jax_p7, tokens, lengths)
    eager = viterbi_scores(p7, tokens, lengths, device="cpu", lazy=False).numpy()
    np.testing.assert_allclose(eager, want_v, atol=VIT_TOL, rtol=0)
    lazy = viterbi_scores(p7, tokens, lengths, device="cpu").numpy()
    np.testing.assert_array_equal(lazy, eager)  # lazy when e_skip_d holds, else eager

    want_f = forward_oracle_batch(jax_p7, tokens, lengths)
    for prob_space in (True, False):
        got_f = forward_scores(p7, tokens, lengths, device="cpu", prob_space=prob_space)
        np.testing.assert_allclose(got_f.numpy(), want_f, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("seed", [300, 301, 302])
def test_fuzz_viterbi_filter_bound(seed):
    """The filter's truncated chain and tail on delete-heavy chains: an
    upper bound of the exact oracle on every sequence."""
    hmm, jax_hmm, rng = _profiles(seed, 3, 40)
    lengths = np.array([48, 1, 31, 64], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 64)).astype(np.int32)
    exact = viterbi_oracle_batch(JaxP7Profile.from_profile(jax_hmm), tokens, lengths)
    filt = viterbi_filter_scores(P7Profile.from_profile(hmm), tokens, lengths,
                                 device="cpu").numpy()
    assert np.all(filt >= exact - 1e-6), (filt - exact).min()


@pytest.mark.parametrize("seed", [400, 401])
def test_fuzz_posterior_coverage(seed):
    hmm, jax_hmm, rng = _profiles(seed, 3, 30)
    lengths = np.array([40, 3, 25], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(3, 40)).astype(np.int32)
    want_cov, want_tot = posterior_coverage_batch_xla(JaxP7Profile.from_profile(jax_hmm),
                                                      tokens, lengths)
    got_cov, got_tot = posterior_coverage_batch(P7Profile.from_profile(hmm), tokens, lengths,
                                                device="cpu")
    np.testing.assert_allclose(got_tot, want_tot, atol=POST_TOL, rtol=0)
    n = min(got_cov.shape[1], want_cov.shape[1])
    np.testing.assert_allclose(got_cov[:, :n], np.asarray(want_cov)[:, :n], atol=POST_TOL,
                               rtol=0)


def test_prob_forward_pad_overflow_regression():
    """A profile whose 'A' odds are large at every state, short rows beside
    one of 600 residues: the short rows run hundreds of padded steps, their
    'A' tails blanked to PAD_TOKEN at staging (the emission identity), and
    every Forward score stays finite and within 2e-3 of the oracle."""
    from test_fuzz_differential import ProfileHMM as JaxProfileHMM

    rng = np.random.default_rng(99)
    hmm = pad_overflow_profile(rng)
    jax_hmm = JaxProfileHMM(**hmm.__dict__)
    lengths = np.array([10, 9, 12, 15, 4, 600], dtype=np.int32)
    tokens = np.zeros((6, 600), dtype=np.int32)  # 'A' past every length
    tokens[:, :17] = rng.integers(0, 20, size=(6, 17))
    tokens[5] = rng.integers(0, 20, size=600)
    scanner = MSVScanner(device="cpu")
    got = scanner.scan_p7(P7Profile.from_profile(hmm), scanner.stage(tokens, lengths),
                          stage="forward").numpy()
    assert np.all(np.isfinite(got)), got
    want = forward_oracle_batch(JaxP7Profile.from_profile(jax_hmm), tokens, lengths)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
