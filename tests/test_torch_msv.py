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
                                       (4872, 52), (6984, 76), (30184, 76), (38920, 80),
                                       (65544, 65)])
def test_kernel_states_per_lane(m_pad, per):
    """One warp a sequence up to 2432 states, C of them (32 * C lanes, C =
    ceil(M_pad / 2432)) in a C-block cluster up to 16 * 2432 = 38,912, 16
    of them (per 80..128) up to 65536, the rows-in-memory case (1024
    threads, ``per`` tiles of 1024 states) past it."""
    assert msv_cuda.kernel_per(m_pad) == per
    lanes = (32 if m_pad <= 2432 else 32 * -(-m_pad // 2432) if m_pad <= 38912
             else 32 * 16 if m_pad <= 65536 else msv_cuda.MEM_LANES)
    assert msv_cuda.kernel_case(m_pad) == (lanes, per)


def test_kernel_limit_names_itself():
    """Past 16 blocks x 32 lanes x 76 = 38,912 states the 16-block
    cluster of 8-warp blocks takes over (per 80..128), past 16 x 32 x 128 =
    65536 the rows-in-memory case; the MSV kernel has no cap, as the TPU
    kernel and the plain version have none."""
    assert msv_cuda.MAX_WIDE_STATES == 4864 and msv_cuda.MEM_LANES == 1024
    assert msv_cuda.MAX_CLUSTER_STATES == 16 * 2432 == 38912
    assert msv_cuda.MAX_WIDE_CLUSTER_STATES == 16 * 32 * 128 == 65536
    assert msv_cuda.kernel_case(msv_cuda.MAX_WIDE_STATES + 1) == (96, 52)
    assert msv_cuda.kernel_case(4872) == (96, 52)
    assert msv_cuda.kernel_per(msv_cuda.MAX_CLUSTER_STATES + 1) == 80
    assert msv_cuda.kernel_case(38920) == (512, 80)
    assert msv_cuda.kernel_per(msv_cuda.MAX_WIDE_CLUSTER_STATES + 1) == 65
    assert msv_cuda.kernel_case(65544) == (1024, 65)
    assert msv_cuda.kernel_case(1 << 20) == (1024, 1024)
    mem = msv_cuda.launch_plan(1024, 5, 4, 16384, 1, 132)
    assert mem == msv_cuda.launch_plan(1024, 5, 2, 16384, 1, 132) == (32, 264, 0, 1)


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
    assert plan == (warps, SMS, 20 * 32 * 44 * 4, 1)
    assert msv_cuda.launch_plan(32, 44, 2, 40, 1, SMS, warps).grid == -(-40 // warps)
    for bad in (0, 4, 10, 36):
        with pytest.raises(ValueError, match="warps a block"):
            msv_cuda.launch_plan(32, 44, 4, 16384, 1, SMS, bad)


@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
@pytest.mark.parametrize("entry", [4, 2])
def test_launch_plan_wide_and_memory_cases_unchanged(per, entry):
    """The wide case is the cluster pair: CLUSTER_WARPS warps a block, each
    block of a 2-block cluster staging its half of the f32 table in both
    modes (20 x 32 * per entries) beside each warp's 32-byte link, an even
    grid of the clusters the card holds split among the profiles; its plan
    is fixed. The rows-in-memory case keeps one 1024-thread block a
    sequence, two an SM."""
    half_table = 4 * 20 * 32 * per
    plan = msv_cuda.launch_plan(64, per, entry, 2048, 2, SMS)
    assert plan == (16, 2 * (SMS // 2 // 2), half_table + 16 * 32, 2)
    assert plan.smem == msv_cuda.cluster_smem_bytes(per) <= msv_cuda.SMEM_PER_SM
    assert msv_cuda.launch_plan(64, per, entry, 2048, 1, SMS, clusters=60) == (
        16, 120, half_table + 512, 2)
    # no more clusters than the batch needs, at least one
    assert msv_cuda.launch_plan(64, per, entry, 40, 1, SMS).grid == 2 * 3
    assert msv_cuda.launch_plan(64, per, entry, 2048, 200, SMS).grid == 2
    with pytest.raises(ValueError, match="fixed"):
        msv_cuda.launch_plan(64, per, entry, 2048, 1, SMS, warps=8)
    assert msv_cuda.launch_plan(msv_cuda.MEM_LANES, 7, entry, 100, 3, SMS) == (32, 100, 0, 1)


@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
@pytest.mark.parametrize("b_pad,num_p,clusters", [(1, 1, 66), (16, 1, 66), (17, 1, 66),
                                                  (2048, 1, 66), (16384, 1, 64), (8192, 3, 66),
                                                  (8192, 100, 66), (100, 2, 1)])
def test_cluster_plan_fits_the_block(per, b_pad, num_p, clusters):
    """Each cluster plan fits the SM's 232,448 bytes a block and its
    registers at the block's launch bound; its blocks come in clusters of 2
    on an even grid, no more clusters a profile than the card holds for
    all the profiles (at least one) or than the batch's sequences need,
    CLUSTER_WARPS of them a cluster."""
    for entry in (4, 2):
        plan = msv_cuda.launch_plan(64, per, entry, b_pad, num_p, SMS, clusters=clusters)
        assert plan.cluster == msv_cuda.CLUSTER == 2
        assert plan.grid % 2 == 0 and plan.grid >= 2
        pairs = plan.grid // 2
        assert pairs == max(1, min(-(-b_pad // plan.warps), clusters // num_p))
        assert plan.smem == 20 * 32 * per * 4 + plan.warps * msv_cuda.link_bytes(2)
        assert plan.smem <= msv_cuda.SMEM_PER_SM == 232448
        assert plan.warps == msv_cuda.CLUSTER_WARPS == 16
        assert plan.warps * 32 * msv_cuda.register_cap(plan.warps) <= msv_cuda.REGS_PER_SM


@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
def test_pair_state_map_is_a_bijection(per):
    """State j of the wide case sits in (block, lane, slot) with j = (32 *
    block + lane) * per + slot: every state of the 64 * per once, each
    block its half."""
    seen = [msv_cuda.cluster_state(j, per) for j in range(64 * per)]
    assert len(set(seen)) == 64 * per
    assert sorted(seen) == [(b, lane, k) for b in range(2) for lane in range(32)
                            for k in range(per)]
    for j, (b, lane, k) in enumerate(seen):
        assert (32 * b + lane) * per + k == j and b == j // (32 * per)


def _pair_step_shift(m: torch.Tensor, per: int) -> torch.Tensor:
    """The j-1 shift of the wide case's step as the kernel takes it, on a
    [B, 64 * per] row: slot k > 0 of a lane reads its own slot k - 1 (the
    row is updated highest j first), slot 0 of lane l > 0 lane l - 1's last
    slot (``__shfl_up_sync``), slot 0 of block 0's lane 0 -inf, and slot 0
    of block 1's lane 0 ``bnd``: block 0's lane 31's last slot, which it
    stored into its partner's link the step before."""
    v = m.reshape(m.shape[0], 2, 32, per)
    out = torch.empty_like(v)
    out[..., 1:] = v[..., :-1]
    out[:, :, 1:, 0] = v[:, :, :-1, per - 1]
    out[:, 0, 0, 0] = float("-inf")
    bnd = v[:, 0, 31, per - 1]
    out[:, 1, 0, 0] = bnd
    return out.reshape(m.shape)


@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
def test_pair_boundary_shift_equals_the_plain_shift(per):
    """The pair's shift, the boundary state crossing the cluster included,
    equals the plain version's one-state shift (msv_scan_plain's
    ``shifted``), -inf entering at state 0."""
    rng = np.random.default_rng(per)
    m = torch.from_numpy(rng.normal(size=(3, 64 * per)).astype(np.float32))
    col0 = torch.full((3, 1), float("-inf"))
    assert torch.equal(_pair_step_shift(m, per), torch.cat([col0, m[:, :-1]], dim=1))


def test_launch_plan_matches_kernel_source():
    """The block sizes the Python plan picks from are the kernels the C
    entry compiles (csrc/msv_kernel.cu, kernel_of), each under its own
    launch bound; the cluster case is one block size, CLUSTER_WARPS,
    compiled at every WIDE_PER in both modes for every C (read from
    %cluster_nctarank, not a template argument), launched as clusters of C
    = lanes / 32 blocks (2..16, the non-portable size allowed past 8), and
    its shared memory the plan's (the table slice and a link a warp: two
    mbarriers and C - 1 8-byte slots a step parity)."""
    source = (pathlib.Path(msv_cuda.__file__).parent.parent / "csrc" / "msv_kernel.cu").read_text()
    cases = re.findall(r"case (\d+): return msv_kernel<PER, false, T, (\d+)>;", source)
    assert [(int(a), int(b)) for a, b in cases] == [(w, w) for w in msv_cuda.WARP_CHOICES]
    assert "__launch_bounds__(32 * WARPS, 1) msv_kernel" in source
    assert f"constexpr int kClusterWarps = {msv_cuda.CLUSTER_WARPS};" in source
    assert f"constexpr int kMaxCluster = {msv_cuda.MAX_CLUSTER};" in source
    assert ("return warps == kClusterWarps ? msv_kernel<PER, true, T, kClusterWarps> : nullptr;"
            in source)
    wide = re.findall(r"MSV_CASE\((\d+), true\)", source)
    assert tuple(int(p) for p in wide) == msv_cuda.WIDE_PER
    assert "return lanes == 32 ? sizeof(float) * 20 * 32 * per" in source
    assert "static_cast<size_t>(warps) * link_bytes(lanes / 32);" in source
    assert "constexpr int link_bytes(int c) { return 16 + 16 * (c - 1); }" in source
    assert all(msv_cuda.link_bytes(c) == 16 + 16 * (c - 1) for c in range(2, 17))
    assert msv_cuda.link_bytes(2) == 2 * 8 + 2 * 8  # two mbarriers and one slot a parity
    assert "mov.u32 %0, %%cluster_nctarank;" in (
        pathlib.Path(msv_cuda.__file__).parent.parent / "csrc" / "cluster.cuh").read_text()
    assert "attr->val.clusterDim.x = c;" in source and "cudaLaunchKernelEx(&cfg, fn, a)" in source
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in source and "c > 8" in source
    assert "(c != 0 && (m_pad % 8 != 0 || grid % c != 0))" in source
    assert "return lanes % 32 == 0 && lanes >= 64 && lanes <= 32 * kMaxCluster ? lanes / 32 : 0;" in (
        source)
    # the messages of a step (cluster_messages mirrors these lines)
    assert "const int dest = lane == 31 ? rank + 1 : lane;" in source
    assert ("msg = lane == 31 ? (dest < nblk ? 2 : 0) : (dest < nblk && dest != rank && "
            "dest != rank + 1);") in source
    assert "dst_slot = peer_addr(slots + (rank > dest ? rank - 1 : rank), dest);" in source
    assert "mbar_expect(bar, 4 * (nblk - 1) + (rank > 0 ? 4 : 0));" in source
    assert "const int got = lane < nblk - 1 ? in[lane].x : INT_MIN;" in source
    assert "if (lane == 0 && rank > 0) bnd = __int_as_float(in[rank - 1].y);" in source


# -- the C-block cluster (csrc/msv_kernel.cu, 32 * C lanes) -------------------

CLUSTER_SIZES = range(2, msv_cuda.MAX_CLUSTER + 1)


@pytest.mark.parametrize("c", CLUSTER_SIZES)
@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
def test_cluster_state_map_is_a_bijection(c, per):
    """State j of a C-block cluster sits in (block, lane, slot) with j =
    (32 * block + lane) * per + slot: every state of the 32 * C * per once,
    block r its r-th slice of 32 * per."""
    n = 32 * c * per
    seen = [msv_cuda.cluster_state(j, per) for j in range(n)]
    assert len(set(seen)) == n
    assert sorted(seen) == [(b, lane, k) for b in range(c) for lane in range(32)
                            for k in range(per)]
    for j, (b, lane, k) in enumerate(seen):
        assert (32 * b + lane) * per + k == j and b == j // (32 * per)


def _cluster_step_shift(m: torch.Tensor, c: int, per: int) -> torch.Tensor:
    """The j-1 shift of a C-block cluster's step as the kernel takes it, on
    a [B, 32 * C * per] row: slot k > 0 of a lane reads its own slot k - 1,
    slot 0 of lane l > 0 lane l - 1's last slot (``__shfl_up_sync``), slot 0
    of block 0's lane 0 -inf, and slot 0 of block r's lane 0 ``bnd``: the
    halo block r - 1's lane 31 stored into block r's link the step before
    (the second word of its 8-byte message)."""
    v = m.reshape(m.shape[0], c, 32, per)
    out = torch.empty_like(v)
    out[..., 1:] = v[..., :-1]
    out[:, :, 1:, 0] = v[:, :, :-1, per - 1]
    out[:, 0, 0, 0] = float("-inf")
    for r in range(1, c):
        out[:, r, 0, 0] = v[:, r - 1, 31, per - 1]
    return out.reshape(m.shape)


@pytest.mark.parametrize("c", CLUSTER_SIZES)
@pytest.mark.parametrize("per", msv_cuda.WIDE_PER)
def test_cluster_boundary_shift_equals_the_plain_shift(c, per):
    """The cluster's shift, the halo crossing between every pair of
    neighbouring blocks included, equals the plain version's one-state shift
    (msv_scan_plain's ``shifted``), -inf entering at state 0."""
    rng = np.random.default_rng(100 * c + per)
    m = torch.from_numpy(rng.normal(size=(2, 32 * c * per)).astype(np.float32))
    col0 = torch.full((2, 1), float("-inf"))
    assert torch.equal(_cluster_step_shift(m, c, per), torch.cat([col0, m[:, :-1]], dim=1))


def cluster_messages(c: int):
    """What the kernel's lanes send a step, as its lines read: {(sender rank,
    lane): (dest rank, slot in the dest's link, bytes)}."""
    out = {}
    for rank in range(c):
        for lane in range(32):
            dest = rank + 1 if lane == 31 else lane
            msg = (2 if dest < c else 0) if lane == 31 else int(
                dest < c and dest != rank and dest != rank + 1)
            if msg:
                out[(rank, lane)] = (dest, rank - 1 if rank > dest else rank, 4 * msg)
    return out


@pytest.mark.parametrize("c", CLUSTER_SIZES)
def test_cluster_messages_reach_every_block_once(c):
    """Each step every block receives one message from each of the other C -
    1 blocks, each in a slot of its own (0 .. C - 2, the senders in rank
    order), of the bytes its mbarrier expects: 4 a key, 8 from rank r - 1
    (key and halo); lane l < C - 1 reads slot l, lane 0 the halo from slot
    r - 1; the whole link fits the plan's bytes."""
    msgs = cluster_messages(c)
    for r in range(c):
        got = {(src, slot, nbytes) for (src, _), (dest, slot, nbytes) in msgs.items() if dest == r}
        assert sorted(src for src, _, _ in got) == [p for p in range(c) if p != r]
        assert sorted(slot for _, slot, _ in got) == list(range(c - 1))
        for src, slot, nbytes in got:
            assert slot == (src if src < r else src - 1)
            assert nbytes == (8 if src == r - 1 else 4)
        assert sum(nbytes for _, _, nbytes in got) == 4 * (c - 1) + (4 if r > 0 else 0)
    assert max(lane for (_, lane) in msgs) == 31 and all(
        lane < c or lane == 31 for (_, lane) in msgs)
    assert msv_cuda.link_bytes(c) == 16 + 2 * 8 * (c - 1)


@pytest.mark.parametrize("m_pad,c,per", [(2432, 1, 76), (2433, 2, 44), (4864, 2, 76),
                                         (4865, 3, 52), (7296, 3, 76), (19456, 8, 76),
                                         (19457, 9, 68), (30181, 13, 76), (38912, 16, 76),
                                         (38913, 16, 80), (65536, 16, 128), (65537, 1, 65)])
def test_cluster_case_and_plan_at_the_boundaries(m_pad, c, per):
    """At each width where the case changes: C blocks (1: one warp a
    sequence or, past 65536, the rows-in-memory case; 16 of 8 warps from
    38,913), the smallest per that covers the row, a grid that is a
    multiple of C (the clusters the card holds split among the profiles, at
    least one a profile; no more than the batch needs), and a block's shared
    memory, its table slice (past 38,912 each lane's last wide_staged(per)
    states) and its warps' links (exchange slots included), within 232,448
    bytes."""
    lanes, got_per = msv_cuda.kernel_case(m_pad)
    assert got_per == per and msv_cuda.cluster_blocks(lanes) == c
    assert lanes * per >= m_pad
    if m_pad > msv_cuda.MAX_WIDE_CLUSTER_STATES:
        assert lanes == msv_cuda.MEM_LANES
        return
    wide = msv_cuda.wide_cluster_case(lanes, per)
    assert wide == (m_pad > msv_cuda.MAX_CLUSTER_STATES)
    warps = msv_cuda.WIDE_CLUSTER_WARPS if wide else msv_cuda.CLUSTER_WARPS
    staged = msv_cuda.wide_staged(per) if wide else per
    if c > 1:
        assert lanes * (per - 8) < m_pad or per in (msv_cuda.WIDE_PER[0],
                                                   msv_cuda.WIDE_CLUSTER_PER[0])
    for b_pad, num_p, clusters in ((1, 1, 7), (2048, 1, 7), (2048, 1, None), (8192, 3, 22),
                                   (100, 20, 9)):
        plan = msv_cuda.launch_plan(lanes, per, 4, b_pad, num_p, SMS, clusters=clusters)
        assert plan.cluster == c
        assert plan.grid % c == 0 and plan.grid >= c
        assert plan.smem <= msv_cuda.SMEM_PER_SM == 232448
        if c > 1:
            held = SMS // c if clusters is None else clusters
            assert plan.grid // c == max(1, min(-(-b_pad // warps), held // num_p))
            assert plan.smem == 4 * 20 * 32 * staged + warps * (16 + 16 * (c - 1))
            assert plan.warps == warps
