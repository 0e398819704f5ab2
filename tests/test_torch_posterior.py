"""The PyTorch port's posterior decode on the CPU (the plain versions of the
forward-save and backward-coverage kernels) against the JAX package's
two-pass Pallas decode in interpret mode, its lax.scan decode and the NumPy
oracle.

Tolerances are the JAX suite's own: coverage 4e-3 (the forward rows are
kept as bf16 on both sides), totals 2e-3; the suffix-chain packer is
byte-equal; the row-saving Forward scores equal the plain Forward's bit for
bit; the mask equals host thresholding exactly; chunking changes nothing.
"""

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import parse_hmm, parse_hmm_text
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile
from hmm_fasta_viterbi_tpu.ops import pallas_posterior
from hmm_fasta_viterbi_tpu.ops.p7_scan import posterior_coverage_batch_xla
from hmm_fasta_viterbi_tpu.ops.reference import posterior_match
from hmm_fasta_viterbi_tpu_torch import convert
from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda, posterior_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner

from test_hmm_parsing import MINI_HMM

COV_TOL = 4e-3
TOT_TOL = 2e-3
LENGTHS = np.array([40, 7, 33, 40, 18, 1], dtype=np.int32)
# the 24 profiles of data/profile_HMMs
STEMS = [str(s) for s in (100, 200, 300, 400, 500, 600, 700, 800, 900, 1001, 1100, 1200, 1301,
                          1400, 1509, 1600, 1705, 1799, 1901, 2050, 2138, 2207, 2365, 2405)]


def _jax_p7(profile_dir, stem):
    if stem == "mini":
        return P7Profile.from_profile(parse_hmm_text(MINI_HMM))
    return P7Profile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))


def _tokens(seed, batch, width):
    return np.random.default_rng(seed).integers(0, 20, size=(batch, width)).astype(np.int32)


@pytest.fixture(scope="module", params=["100", "mini"])
def decoded(request, profile_dir):
    """One ragged batch decoded by the port (plain) and by both JAX decodes."""
    p7 = _jax_p7(profile_dir, request.param)
    tokens = _tokens(17, len(LENGTHS), 40)
    port = posterior_cuda.posterior_coverage_batch(
        convert.p7_profile_from_jax(p7), tokens, LENGTHS, device="cpu")
    pallas = pallas_posterior.posterior_coverage_batch_pallas(p7, tokens, LENGTHS, interpret=True)
    xla = posterior_coverage_batch_xla(p7, tokens, LENGTHS)
    return request.param, p7, tokens, port, pallas, xla


def test_all_24_profiles_listed(all_profile_paths):
    assert [p.stem for p in all_profile_paths] == STEMS


@pytest.mark.parametrize("stem", STEMS)
def test_suffix_chain_byte_equal(profile_dir, stem):
    """prepare_suffix_chain equals pallas_posterior.prepare_suffix_chain byte
    for byte; on the device it is the same numbers, one row a pass."""
    p7 = _jax_p7(profile_dir, stem)
    want = pallas_posterior.prepare_suffix_chain(p7)
    port = convert.p7_profile_from_jax(p7)
    got = posterior_cuda.prepare_suffix_chain(port)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    rows = posterior_cuda.suffix_chain_rows(port, "cpu")
    assert rows.is_contiguous() and np.array_equal(rows.numpy(), want.T)


def test_coverage_vs_jax_pallas_and_xla(decoded):
    """The port's coverage against the JAX Pallas decode (interpret mode)
    and the lax.scan decode: 4e-3; totals 2e-3; 0 past each length."""
    name, _, tokens, (cov, tot), (p_cov, p_tot), (x_cov, x_tot) = decoded
    assert cov.dtype == np.float32 and cov.shape == tokens.shape and tot.shape == (len(LENGTHS),)
    for want_cov, want_tot in ((p_cov, p_tot), (x_cov, x_tot)):
        np.testing.assert_allclose(tot, want_tot, atol=TOT_TOL, rtol=0)
        np.testing.assert_allclose(cov, want_cov[:, : cov.shape[1]], atol=COV_TOL, rtol=0)
    for b, n in enumerate(LENGTHS):
        assert np.all(cov[b, n:] == 0.0)
    assert (cov.max(axis=1) > 0).all()
    if name == "mini":  # the mini profile's coverage crosses the 0.5 threshold
        assert (cov >= 0.5).any() and ((cov > 0) & (cov < 0.5)).any()


def test_coverage_vs_oracle_posterior_match(profile_dir):
    """Coverage summed from reference.posterior_match on two sequences: 4e-3."""
    p7 = _jax_p7(profile_dir, "100")
    tokens = _tokens(23, 2, 48)
    lengths = np.array([48, 29], dtype=np.int32)
    cov, tot = posterior_cuda.posterior_coverage_batch(
        convert.p7_profile_from_jax(p7), tokens, lengths, device="cpu")
    for b, n in enumerate(lengths):
        post, total = posterior_match(p7, tokens[b, :n])
        np.testing.assert_allclose(cov[b, :n], post.sum(axis=1), atol=COV_TOL, rtol=0)
        assert abs(float(tot[b]) - float(total)) <= TOT_TOL


def test_forward_save_scores_equal_plain_forward(profile_dir):
    """The row-saving Forward returns the plain Forward's scores and carries
    bit for bit, fm rows (bf16 of the scaled M rows) and ls zero at and past
    each length, and ls constant within each rescale group."""
    p7 = convert.p7_profile_from_jax(_jax_p7(profile_dir, "100"))
    lengths = np.array([0, 1, 7, 33, 96, 8], dtype=np.int32)
    staged = MSVScanner(device="cpu").stage(_tokens(5, len(lengths), 96), lengths)
    pack = p7_cuda.forward_pack(p7, "cpu")
    args = (*pack[:4], staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
            pack.consts, *p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad))
    want = p7_cuda.forward_prob_scan(*args)
    got = posterior_cuda.forward_save_scan(*args)
    assert len(got) == 7
    for g, w in zip(got[:5], want):
        assert torch.equal(g, w)
    fm, ls = got[5:]
    assert fm.dtype == torch.bfloat16 and fm.shape == (len(lengths), 96, pack.m_pad)
    assert ls.dtype == torch.float32 and ls.shape == (len(lengths), 96)
    for b, n in enumerate(lengths):
        assert not fm[b, n:].float().any() and not ls[b, n:].any()
        if n:
            assert fm[b, :n].float().amax(dim=1).gt(0).all()
    group = p7_cuda.FWD_RESCALE_GROUP
    row = ls[4, :96].reshape(-1, group)
    assert torch.equal(row, row[:, :1].expand_as(row))  # one scale a group
    assert (row[1:, 0] != 0).all()


def test_mask_equals_host_threshold(profile_dir):
    """mask_threshold=0.5 gives uint8 (cov >= 0.5) of the f32 coverage,
    exactly, and the same totals."""
    p7 = convert.p7_profile_from_jax(_jax_p7(profile_dir, "mini"))
    tokens = _tokens(11, 4, 64)
    lengths = np.array([64, 1, 57, 30], dtype=np.int32)
    cov, tot = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    mask, tot2 = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu",
                                                         mask_threshold=0.5)
    assert mask.dtype == np.uint8
    np.testing.assert_array_equal(mask, (cov >= np.float32(0.5)).astype(np.uint8))
    np.testing.assert_array_equal(tot, tot2)
    assert mask.any()


def test_batch_chunk_equals_one_chunk(profile_dir):
    """batch_chunk=2 (three chunks, the last a single sequence) gives one
    chunk's coverage and totals bit for bit."""
    p7 = convert.p7_profile_from_jax(_jax_p7(profile_dir, "100"))
    tokens = _tokens(3, 5, 40)
    lengths = np.array([40, 0, 33, 12, 40], dtype=np.int32)
    one = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    chunked = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu",
                                                      batch_chunk=2)
    for a, b in zip(one, chunked):
        np.testing.assert_array_equal(a, b)
    assert np.isneginf(one[1][1]) and not one[0][1].any()


def test_sequence_over_the_budget_raises(profile_dir, monkeypatch):
    """One sequence whose bf16 rows exceed POST_BYTES raises ValueError
    naming the budget; nothing falls back to another decode."""
    p7 = convert.p7_profile_from_jax(_jax_p7(profile_dir, "100"))
    tokens = _tokens(4, 2, 40)
    m_pad = p7_cuda.default_m_pad(p7)
    monkeypatch.setattr(posterior_cuda, "POST_BYTES", 40 * m_pad * 2 - 1)
    with pytest.raises(ValueError, match=str(40 * m_pad * 2 - 1)):
        posterior_cuda.posterior_coverage_batch(p7, tokens, np.array([40, 3]), device="cpu")
    monkeypatch.setattr(posterior_cuda, "POST_BYTES", 40 * m_pad * 2)
    cov, _ = posterior_cuda.posterior_coverage_batch(p7, tokens, np.array([40, 3]),
                                                     device="cpu")
    assert cov.shape == (2, 40)  # one sequence a chunk at the budget


def test_backward_plain_runs_each_sequence_from_its_own_end(profile_dir):
    """The backward pass of a sequence does not depend on its neighbours:
    decoded alone or beside a longer one, its coverage is the same bit for
    bit (each sequence starts at its own last residue, and its rescale
    groups count from there)."""
    p7 = convert.p7_profile_from_jax(_jax_p7(profile_dir, "100"))
    tokens = _tokens(8, 2, 60)
    lengths = np.array([60, 21], dtype=np.int32)
    both, tot = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    alone, tot1 = posterior_cuda.posterior_coverage_batch(p7, tokens[1:, :21], lengths[1:],
                                                          device="cpu")
    np.testing.assert_array_equal(both[1, :21], alone[0])
    assert tot[1] == tot1[0]
