"""The PyTorch port's MSV scan (its plain version, which CPU tensors run)
against the NumPy oracle and the JAX package.

Every comparison is exact (np.array_equal): the port keeps the float32
operation order of ops/recurrence.py, and the JAX Pallas kernel's bf16
split reconstructs every f32 score exactly, so no tolerance is needed.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import MSVProfile, msv_oracle_batch, parse_hmm
from hmm_fasta_viterbi_tpu.ops import pallas_msv
from hmm_fasta_viterbi_tpu.ops.xla_scan import msv_xla
from hmm_fasta_viterbi_tpu_torch import convert
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner

RAGGED = np.array([0, 1, 2, 31, 32, 33, 64, 17], dtype=np.int32)


def _profile(profile_dir, stem):
    return MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))


def _tokens(seed, batch, width):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 20, size=(batch, width)).astype(np.int32)


def _port_scores(profile, tokens, lengths):
    """The port's scores of a JAX MSVProfile, through its own copy."""
    sc = MSVScanner(device="cpu")
    return sc.scan(convert.msv_profile_from_jax(profile), sc.stage(tokens, lengths)).numpy()


@pytest.mark.parametrize("stem", ["100", "1001", "1400"])
def test_plain_equals_oracle(profile_dir, stem):
    profile = _profile(profile_dir, stem)
    tokens = _tokens(0, len(RAGGED), 64)
    got = _port_scores(profile, tokens, RAGGED)
    want = msv_oracle_batch(profile, tokens, RAGGED)
    assert np.array_equal(got, want)
    assert np.isneginf(got[RAGGED == 0]).all()  # empty sequences, by design


@pytest.mark.parametrize("stem", ["100", "1001"])
def test_plain_equals_jax_xla(profile_dir, stem):
    profile = _profile(profile_dir, stem)
    tokens = _tokens(1, len(RAGGED), 64)
    got = _port_scores(profile, tokens, RAGGED)
    want = np.asarray(msv_xla(profile, tokens, RAGGED))
    assert np.array_equal(got, want)


def test_plain_equals_jax_pallas_interpret_with_carries(profile_dir):
    """msv_pallas_call (interpret mode) and the port's msv_scan from the
    same non-trivial carries, all inputs carried over by convert.py:
    scores and both carries out are equal."""
    profile = _profile(profile_dir, "100")
    mr = profile.num_states
    tokens = _tokens(2, len(RAGGED), 64)
    tokens_t, lengths_p, tr_rows, b, l_chunk = pallas_msv._prepare_batch(
        tokens, RAGGED, 64
    )
    scores_t = pallas_msv.prepare_scores_t(profile)[None]
    tr_consts = np.array(
        [[profile.tr_B_Mk, profile.tr_E_C, profile.tr_E_J]], dtype=np.float32
    )
    rng = np.random.default_rng(3)
    b_pad = tokens_t.shape[1]
    m_init = np.full((scores_t.shape[1], b_pad), -np.inf, dtype=np.float32)
    m_init[:mr] = rng.normal(-8.0, 3.0, size=(mr, b_pad)).astype(np.float32)
    s_init = rng.normal(-6.0, 2.0, size=(4, b_pad)).astype(np.float32)

    score, m_out, s_out = pallas_msv.msv_pallas_call(
        jnp.asarray(scores_t), jnp.asarray(tokens_t, dtype=jnp.int32),
        jnp.asarray(lengths_p), jnp.asarray(tr_rows), jnp.asarray(tr_consts),
        jnp.asarray(m_init), jnp.asarray(s_init),
        l_chunk=l_chunk, interpret=True,
    )

    staged = convert.staged_from_jax(tokens_t, lengths_p, tr_rows, b, "cpu")
    emit, consts = convert.device_profile_from_jax(scores_t, tr_consts, mr, "cpu")
    m, s = convert.carry_from_jax(m_init, s_init, mr, "cpu")
    got_score, got_m, got_s = msv_cuda.msv_scan(
        emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s
    )
    assert np.array_equal(got_score.numpy(), np.asarray(score)[0])
    assert np.array_equal(got_m[:, :mr].numpy(), np.asarray(m_out)[:mr].T)
    assert np.array_equal(got_s.numpy(), np.asarray(s_out))
    assert np.isneginf(got_m[:, mr:].numpy()).all()  # port pad states


@pytest.mark.parametrize("stem,split", [("100", 29), ("1001", 32)])
def test_carry_chain_equals_one_call(profile_dir, stem, split):
    """Two calls over L split at ``split`` (second call: lengths less the
    split, clipped at 0) equal one call, carries included."""
    profile = _profile(profile_dir, stem)
    tokens = _tokens(4, len(RAGGED), 64)
    staged = MSVScanner(device="cpu").stage(tokens, RAGGED)
    emit, consts = convert.device_profile(convert.msv_profile_from_jax(profile), "cpu")
    m0, s0 = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
    whole = msv_cuda.msv_scan(
        emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m0, s0
    )
    first = msv_cuda.msv_scan(
        emit, staged.tokens[:, :split].contiguous(),
        staged.lengths.clamp(max=split), staged.tr_rows, consts, m0, s0,
    )
    second = msv_cuda.msv_scan(
        emit, staged.tokens[:, split:].contiguous(),
        (staged.lengths - split).clamp(min=0), staged.tr_rows, consts,
        first[1], first[2],
    )
    for a, b in zip(second, whole):
        assert torch.equal(a, b)
    assert np.array_equal(
        whole[0].numpy(), msv_oracle_batch(profile, tokens, RAGGED)
    )


@pytest.mark.parametrize("stem,m_pad", [("100", None), ("1001", 1024)])
def test_prepare_scores_t_byte_equal(profile_dir, stem, m_pad):
    profile = _profile(profile_dir, stem)
    scores = profile.scores_real.copy()
    scores[3, 5] = -np.inf  # exercises the PAD_SCORE clamp
    profile = dataclasses.replace(profile, scores_real=scores)
    got = msv_cuda.prepare_scores_t(convert.msv_profile_from_jax(profile), m_pad)
    want = pallas_msv.prepare_scores_t(profile, m_pad)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_blank_ragged_tail_byte_equal():
    rng = np.random.default_rng(5)
    tokens_t = rng.integers(0, 20, size=(96, 128)).astype(np.int8)
    lengths = rng.integers(0, 97, size=128).astype(np.int32)
    got = msv_cuda.blank_ragged_tail(tokens_t.copy(), lengths)
    want = pallas_msv.blank_ragged_tail(tokens_t.copy(), lengths)
    assert got.tobytes() == want.tobytes()
    assert msv_cuda.PAD_TOKEN == pallas_msv.PAD_TOKEN
    assert msv_cuda.PAD_SCORE == pallas_msv.PAD_SCORE


@pytest.mark.parametrize("m_pad,per", [(104, 4), (1400, 44), (1408, 44), (2405, 76), (2432, 76),
                                       (2440, 44), (2704, 44), (4776, 76), (4864, 76),
                                       (4872, 5), (6984, 7), (30184, 30), (65544, 65)])
def test_kernel_states_per_lane(m_pad, per):
    """One warp a sequence up to 2432 states, two (64 lanes) up to 4864, the
    rows-in-memory case (1024 threads, ``per`` tiles of 1024 states) past
    it."""
    assert msv_cuda.kernel_per(m_pad) == per
    lanes = 32 if m_pad <= 2432 else 64 if m_pad <= 4864 else msv_cuda.MEM_LANES
    assert msv_cuda.kernel_case(m_pad) == (lanes, per)


def test_kernel_limit_names_itself():
    """Past 64 lanes x 76 = 4864 states the rows-in-memory case takes over;
    the MSV kernel has no cap, as the TPU kernel and the plain version have
    none."""
    assert msv_cuda.MAX_WIDE_STATES == 4864 and msv_cuda.MEM_LANES == 1024
    assert msv_cuda.kernel_per(msv_cuda.MAX_WIDE_STATES + 1) == 5
    assert msv_cuda.kernel_case(4872) == (1024, 5)
    assert msv_cuda.kernel_case(1 << 20) == (1024, 1024)
    mem = msv_cuda.launch_plan(1024, 5, 4, 16384, 1, 132)
    assert mem == msv_cuda.launch_plan(1024, 5, 2, 16384, 1, 132) == (32, 264, 0)


# -- the launch plan (ops/msv_cuda.py::launch_plan, csrc/msv_kernel.cu) ------

SMS = 132  # an H100 SXM's multiprocessors


@pytest.mark.parametrize("per", msv_cuda.KERNEL_PER)
@pytest.mark.parametrize("b_pad,num_p", [(1, 1), (64, 1), (16384, 1), (8192, 3), (8192, 200)])
def test_launch_plan_register_cases(per, b_pad, num_p):
    """One f32 table a block in both modes, so exact and filter plan alike;
    the block fits the SM's threads and, at its register cap, its registers;
    the grid is one block an SM and profile, no more than the batch needs."""
    plan = msv_cuda.launch_plan(32, per, 4, b_pad, num_p, SMS)
    assert plan == msv_cuda.launch_plan(32, per, 2, b_pad, num_p, SMS)
    warps = msv_cuda.PLAN_WARPS[per]
    assert plan.warps == warps
    assert plan.smem == 20 * 32 * per * 4 <= msv_cuda.SMEM_PER_SM == 232448
    assert warps in msv_cuda.WARP_CHOICES and warps * 32 <= 1024
    assert warps * 32 * msv_cuda.register_cap(warps) <= msv_cuda.REGS_PER_SM == 65536
    assert plan.grid == max(1, min(-(-b_pad // warps), SMS // num_p))
    assert plan.grid * num_p <= max(SMS, num_p)


@pytest.mark.parametrize("warps,cap", [(8, 255), (12, 168), (16, 128), (20, 96), (24, 80),
                                       (28, 72), (32, 64)])
def test_launch_plan_forced_warps(warps, cap):
    """Every compiled block size launches; the register cap is what
    __launch_bounds__(32 * warps, 1) leaves, in steps of 8."""
    assert msv_cuda.register_cap(warps) == cap
    plan = msv_cuda.launch_plan(32, 44, 2, 16384, 1, SMS, warps)
    assert plan == (warps, SMS, 20 * 32 * 44 * 4)
    assert msv_cuda.launch_plan(32, 44, 2, 40, 1, SMS, warps).grid == -(-40 // warps)
    for bad in (0, 4, 10, 36):
        with pytest.raises(ValueError, match="warps a block"):
            msv_cuda.launch_plan(32, 44, 4, 16384, 1, SMS, bad)


@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
@pytest.mark.parametrize("entry", [4, 2])
def test_launch_plan_wide_and_memory_cases_unchanged(per, entry):
    """The wide case (two warps a sequence, each warp's two row buffers of
    the global entries) keeps 16 warps a block where they fit, else 8, one
    pair a sequence; the rows-in-memory case one 1024-thread block a
    sequence, two an SM."""
    def row_buffers(warps):
        return warps * 2 * 32 * per * entry + (warps // 2) * 32

    warps = 16 if row_buffers(16) <= msv_cuda.SMEM_PER_SM else 8
    plan = msv_cuda.launch_plan(64, per, entry, 2048, 2, SMS)
    assert plan == (warps, -(-2048 // (warps // 2)), row_buffers(warps))
    assert plan.smem <= msv_cuda.SMEM_PER_SM
    with pytest.raises(ValueError, match="fixed"):
        msv_cuda.launch_plan(64, per, entry, 2048, 1, SMS, warps=8)
    assert msv_cuda.launch_plan(msv_cuda.MEM_LANES, 7, entry, 100, 3, SMS) == (32, 100, 0)


def test_launch_plan_matches_kernel_source():
    """The block sizes the Python plan picks from are the kernels the C
    entry compiles (csrc/msv_kernel.cu, kernel_of), each under its own
    launch bound, and the wide case's largest block is its bound's."""
    source = (pathlib.Path(msv_cuda.__file__).parent.parent / "csrc" / "msv_kernel.cu").read_text()
    cases = re.findall(r"case (\d+): return msv_kernel<PER, 32, T, (\d+)>;", source)
    assert [(int(a), int(b)) for a, b in cases] == [(w, w) for w in msv_cuda.WARP_CHOICES]
    assert "__launch_bounds__(32 * WARPS, 1) msv_kernel" in source
    assert f"constexpr int kWideWarps = {msv_cuda.WIDE_WARPS};" in source
    assert "return lanes == 32 ? sizeof(float) * 20 * 32 * per" in source
