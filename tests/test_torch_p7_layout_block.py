"""The wide block and the clusters of wide blocks (csrc/p7_blocked.cuh,
csrc/p7_viterbi.cuh::viterbi_block_kernel, viterbi_block_cluster_kernel),
checked on the CPU against the models of tests/p7_layout_models.py.

* The wide block (the eager and log-space kinds past 4864 states, up to
  MAX_BLOCK_STATES: one block of BLOCK_THREADS threads in the normal-width
  layout): its state map is a bijection, its shared-row index conflict
  free, its shifts equal ``p7_cuda._shift`` for every per of BLOCK_PER, its
  thread-major rows (``block_rows``) put row q's state t * per + k at (q, k,
  t), and its plan stages the transitions first, then chain rows, as many
  as fit beside its group, one group a block, a grid of at most one block
  an SM.
* The clusters of C wide blocks (the eager and log-space kinds past
  MAX_BLOCK_STATES, the lazy kind past LAZY_BLOCK_STATES: C = ceil(M_pad /
  8192), 2..8): the (C, per) cases cover every width, the plan, the state
  map, the shifts across the cluster, each block's slice of the thread-major
  rows, the rows' releases and the cases the C entries compile.
"""

import itertools
import re

import numpy as np
import pytest
import torch
from p7_layout_models import (  # noqa: F401 (one_torch_thread: the module's fixture)
    BATCHES, REGS, SMS, THREADS, _check_row_index, _check_shifts, _small, one_torch_thread,
)

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM


# -- the wide block ---------------------------------------------------------

BLOCK = p7_cuda.BLOCK_THREADS


@pytest.mark.parametrize("per", p7_cuda.BLOCK_PER)
def test_block_shifts_equal_the_plain_shift(per):
    """The wide block's shifts (BLOCK_THREADS threads of ``per`` states:
    registers and a halo below per, the row through the shift buffer at
    sidx above) equal the plain shift for every pass s = 2^p of its states
    and both fills; its shared-row index is a bijection whose warps hit 32
    banks."""
    _check_row_index(per, BLOCK)
    _check_shifts(per, BLOCK)


@pytest.mark.parametrize("per", p7_cuda.BLOCK_PER)
def test_block_state_map_is_a_bijection(per):
    """State j of the wide block sits in (thread, slot) with j = thread *
    per + slot: every one of its BLOCK_THREADS * per states once; past them
    the map raises."""
    seen = [p7_cuda.block_state(j, per) for j in range(BLOCK * per)]
    assert sorted(seen) == [(t, k) for t in range(BLOCK) for k in range(per)]
    assert all(t * per + k == j for j, (t, k) in enumerate(seen))
    with pytest.raises(ValueError, match="wide block"):
        p7_cuda.block_state(BLOCK * per, per)


@pytest.mark.parametrize("per", (p7_cuda.BLOCK_PER[0], 7, p7_cuda.BLOCK_PER[-1]))
def test_block_rows_are_thread_major(per):
    """block_rows lays the six transitions and the chain's passes out as
    [6 + passes, per, BLOCK_THREADS]: entry (q, k, t) is row q at state t *
    per + k (-inf past M_pad), so a warp's 32 threads reading slot k read
    32 contiguous floats."""
    m_pad = BLOCK * (per - 1) + 8 * (per % 5 + 1)
    passes = p7_cuda.chain_passes(m_pad)
    rng = np.random.default_rng(per)
    trans = torch.from_numpy(rng.normal(size=(8, m_pad)).astype(np.float32))
    chain = torch.from_numpy(rng.normal(size=(16, m_pad)).astype(np.float32))
    got = p7_cuda.block_rows(trans, chain, passes, per)
    assert got.shape == (6 + passes, per, BLOCK) and got.is_contiguous()
    rows = torch.cat([trans[:6], chain[:passes]])
    flat = got.reshape(6 + passes, -1)
    for q in range(6 + passes):
        for t in (0, 1, 31, 32, BLOCK - 1):
            for k in range(per):
                j = t * per + k
                want = rows[q, j] if j < m_pad else p7_cuda.NEG_INF
                assert got[q, k, t] == want and flat[q, k * BLOCK + t] == want


@pytest.mark.parametrize("kind,per", [(kind, per) for kind in p7_cuda.BLOCK_KINDS
                                      for per in p7_cuda.BLOCK_PER])
def test_block_plan_fits_the_block(kind, per):
    """Past 4864 states, up to MAX_BLOCK_STATES, the eager and log-space
    kinds plan the wide block at the narrowest and widest M_pad of each per:
    BLOCK_THREADS threads, ``cluster`` BLOCK_CLUSTER (the C entries' name of
    the case), one group a block (a forced G other than 1 raises), one
    sequence a block on a grid of what an SM's registers,
    shared memory and threads allow times the SMs (one block an SM), at
    most the batch; the transition rows staged first and chain rows only
    after all six, as many as fit the 232,448 bytes beside the group's two
    shift rows, one step's two emission rows, reduction scratch and token
    chunk (blocked_smem_bytes(..., block=True), the header's
    block_smem_floats); the rest read thread-major."""
    row = 4 * BLOCK * p7_cuda.blocked_stride(per)
    group = 4 * row + 4 * (2 * (BLOCK // 32) + 32)
    assert p7_cuda.blocked_smem_bytes(per, 0, 1, block=True) == group
    for m_pad in sorted({max(p7_cuda.MAX_WIDE_STATES + 8, BLOCK * (per - 1) + 8), BLOCK * per}):
        assert p7_cuda.kernel_case(m_pad, kind) == (BLOCK, per)
        assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, -(-m_pad // 1024))
        full = p7_cuda.chain_passes(m_pad)
        # __launch_bounds__(BLOCK_THREADS, 1): at most 64 registers a thread
        bounded = [r for r in REGS if r <= p7_cuda.REGS_PER_SM // BLOCK]
        for regs, b_pad in itertools.product(bounded, BATCHES):
            plan = p7_cuda.plan_launch(kind, m_pad, full, b_pad, regs, SMS)
            assert (plan.threads, plan.cluster, plan.groups, plan.max_groups, plan.per) == (
                BLOCK, p7_cuda.BLOCK_CLUSTER, 1, 1, per)
            assert plan.block and not plan.mem
            rows = plan.n_trans + plan.n_chain
            assert plan.smem == p7_cuda.blocked_smem_bytes(per, rows, 1, block=True)
            assert plan.smem == rows * row + group <= SMEM_PER_SM
            assert 0 <= plan.n_trans <= 6 and 0 <= plan.n_chain <= full
            assert plan.n_chain == 0 or plan.n_trans == 6
            if rows < 6 + full:
                assert plan.smem + row > SMEM_PER_SM
            warp_regs = -(-regs // 8) * 8 * 32
            per_sm = min(p7_cuda.REGS_PER_SM // (BLOCK // 32 * warp_regs),
                         SMEM_PER_SM // plan.smem, p7_cuda.THREADS_PER_SM // BLOCK)
            assert per_sm == 1 and plan.grid == min(b_pad, SMS)
        with pytest.raises(ValueError, match="wide block takes 1"):
            p7_cuda.plan_launch(kind, m_pad, full, 64, 128, SMS, groups=2)
        assert p7_cuda.plan_launch(kind, m_pad, full, 64, 128, SMS, groups=1).groups == 1
    assert p7_cuda.kernel_case(p7_cuda.MAX_BLOCK_STATES + 8, kind)[0] == p7_cuda.MEM_THREADS


def test_block_plan_at_the_joins():
    """The three-profile join (M_pad 6984, 13 passes): 7 states a thread,
    four transition rows staged (229,760 bytes), 15 rows read thread-major;
    the first wide block (4872): all six transitions and one chain row."""
    plan = p7_cuda.plan_launch("eager", 6984, 13, 64, 64, SMS)
    assert (plan.per, plan.n_trans, plan.n_chain, plan.smem, plan.grid) == (7, 4, 0, 229760, 64)
    plan = p7_cuda.plan_launch("log", 4872, 13, 256, 64, SMS)
    assert (plan.per, plan.n_trans, plan.n_chain, plan.grid) == (5, 6, 1, SMS)


def test_block_cases_match_kernel_source():
    """The wide block's cases the two C entries compile are BLOCK_PER at
    kBlockThreads = BLOCK_THREADS (with_block_case), named by ``cluster`` 0
    (BLOCK_CLUSTER); the header lays its shared memory out as
    blocked_smem_bytes(block=True) counts it, its step (block_chunk) reduces
    E over KT / 32 warps, and the 128-thread group keeps its own step
    (run_chunk, which otherwise only the filter's 256-thread cluster blocks
    run) and reduction (group_reduce, four warps)."""
    csrc = p7_cuda._build.CSRC_DIR
    blocked = (csrc / "p7_blocked.cuh").read_text()
    cases = re.findall(r"P7_BLOCK_CASE\((\d+)\)\n", blocked)
    assert tuple(int(c) for c in cases) == p7_cuda.BLOCK_PER
    assert f"constexpr int kBlockThreads = {BLOCK};" in blocked
    assert f"constexpr int kBlockPerMin = {p7_cuda.BLOCK_PER[0]};" in blocked
    assert f"constexpr int kBlockPerMax = {p7_cuda.BLOCK_PER[-1]};" in blocked
    assert ("return static_cast<size_t>(n_rows + 4) * row_floats<PER, KT>() + "
            "red_floats<KT>() +\n         kChunk / 4;") in blocked
    assert 'static_assert(KT == 128, "a group is 4 warps");' in blocked
    assert "float block_reduce(float v, float* red, int t, int bar) {" in blocked
    template = (csrc / "p7_viterbi.cuh").read_text()
    assert "block_chunk<PER, KT, LSE>(a, smem, gs, r, count, par, tr_loop, tr_move, t, bar);" in (
        template)
    assert ('static_assert(KT == 128 || (FILT && SPAN == Span::kCluster && KT == '
            'kWideClusterThreads),\n                "groups of 128, or the filter\'s 256-thread '
            'cluster blocks (the wide block "\n                "runs block_chunk)");') in template
    assert "static constexpr int NEM = KT == kBlockThreads ? 2 : 4;" in template
    assert "viterbi_body<PER, KT, false, LSE, false, Span::kGroup>(a);" in template
    assert "4 * block_smem_floats<PER, KT>(a.n_trans + a.n_chain)" in template
    assert "__ldg(global + (q * PER + k) * KT)" in template
    for name, lse in (("p7_viterbi_kernel.cu", "false"), ("p7_forward_log_kernel.cu", "true")):
        source = (csrc / name).read_text()
        assert "with_block_case<BlockCase>(per" in source
        assert f"viterbi_block_kernel<PER, kBlockThreads, {lse}>" in source
        assert "if (cluster == 0) {" in source
    assert p7_cuda.MAX_BLOCK_STATES == BLOCK * p7_cuda.BLOCK_PER[-1]
    assert p7_cuda.BLOCK_CLUSTER == 0
    assert BLOCK * (p7_cuda.BLOCK_PER[0] - 1) < p7_cuda.MAX_WIDE_STATES + 8 <= (
        BLOCK * p7_cuda.BLOCK_PER[0])


# -- the cluster of wide blocks ---------------------------------------------

# (M_pad, C, per): the first width past the wide block, the smallest
# C-block join's (LENG 11165), the all-24 join (LENG 30181), twice over
# (LENG 60362) and the chain's widest
BLOCK_CLUSTER_WIDTHS = ((9224, 2, 5), (11168, 2, 6), (30184, 4, 8), (60368, 8, 8),
                        (65536, 8, 8))
# every (C, per) the plan takes past MAX_BLOCK_STATES
BLOCK_CLUSTER_CASES = sorted({(p7_cuda.cluster_blocks(m, "eager"), p7_cuda.kernel_case(m, "eager")[1])
                              for m in range(p7_cuda.MAX_BLOCK_STATES + 8,
                                             p7_cuda.MAX_KERNEL_STATES + 1, 8)})


def test_block_cluster_cases_cover_every_width():
    """Past MAX_BLOCK_STATES up to 65536 the plan takes C = ceil(M_pad /
    8192) wide blocks and per = ceil(M_pad / (1024 * C)): 16 (C, per) pairs,
    C of 2..8 (no non-portable cluster size), per of BLOCK_CLUSTER_PER (5..8:
    the four compiled cases a kind). The lazy kind takes the eager kind's
    case at every width past LAZY_BLOCK_STATES (32,768: its chain has 16
    passes there, where no window is certified), C of 5..8, and its
    128-thread C-block cluster up to it."""
    assert p7_cuda.LAZY_BLOCK_STATES == 32768 == 1 << (p7_cuda.chain_passes(32768))
    for m in range(p7_cuda.MAX_BLOCK_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8):
        lazy = (p7_cuda.cluster_blocks(m, "lazy"), p7_cuda.kernel_case(m, "lazy"))
        if m > p7_cuda.LAZY_BLOCK_STATES:
            assert p7_cuda.block_cluster_case(m, "lazy") and p7_cuda.chain_passes(m) == 16
            assert lazy == (p7_cuda.cluster_blocks(m, "eager"), p7_cuda.kernel_case(m, "eager"))
        else:
            assert not p7_cuda.block_cluster_case(m, "lazy")
            assert lazy == (-(-m // 2432), (THREADS, -(-m // (THREADS * -(-m // 2432)))))
    assert {p7_cuda.cluster_blocks(m, "lazy") for m in range(32776, 65537, 8)} == set(range(5, 9))
    assert p7_cuda.chain_passes(32768) == 15 and p7_cuda.chain_passes(32776) == 16
    assert len(BLOCK_CLUSTER_CASES) == 16
    assert {c for c, _ in BLOCK_CLUSTER_CASES} == set(range(2, p7_cuda.MAX_BLOCK_CLUSTER + 1))
    assert {per for _, per in BLOCK_CLUSTER_CASES} == set(p7_cuda.BLOCK_CLUSTER_PER)
    assert p7_cuda.MAX_BLOCK_CLUSTER * BLOCK * p7_cuda.BLOCK_CLUSTER_PER[-1] == (
        p7_cuda.MAX_KERNEL_STATES)
    for c, per in BLOCK_CLUSTER_CASES:
        assert (c - 1) * BLOCK * per < c * BLOCK * per and per <= 8 and c <= 8


@pytest.mark.parametrize("m_pad,c,per", BLOCK_CLUSTER_WIDTHS)
def test_block_cluster_plan(m_pad, c, per):
    """The eager and log-space kinds past MAX_BLOCK_STATES, and the lazy
    kind past 32,768 (the whole chain: fewer passes raise), plan C wide
    blocks a sequence (``cluster`` C, BLOCK_THREADS threads, ``per``; the
    plan's ``block_cluster``, neither ``block`` nor ``mem`` nor ``pair``),
    one group a block (a forced G other than 1 raises), a grid of whole
    clusters (the ``clusters`` the card holds, else one block an SM over C;
    no more clusters than sequences), the transitions staged first, then
    chain rows, as many as fit the 232,448 bytes beside the wide block's
    group and the cluster's area (blocked_smem_bytes(block=True,
    cluster=True)); every other kind plans as before (Forward, the
    row-saving Forward and the backward pass past 38,912:
    test_wide_cluster_plan)."""
    full = p7_cuda.chain_passes(m_pad)
    row = 4 * BLOCK * p7_cuda.blocked_stride(per)
    base = p7_cuda.blocked_smem_bytes(per, 0, 1, block=True, cluster=True)
    assert base == p7_cuda.blocked_smem_bytes(per, 0, 1, block=True) + 2 * row + 4 * 1364
    lazy = m_pad > p7_cuda.LAZY_BLOCK_STATES
    for kind in p7_cuda.BLOCK_KINDS + (("lazy",) if lazy else ()):
        assert p7_cuda.block_cluster_case(m_pad, kind) and not p7_cuda.block_case(m_pad, kind)
        assert p7_cuda.cluster_blocks(m_pad, kind) == c == -(-m_pad // 8192)
        assert p7_cuda.kernel_case(m_pad, kind) == (BLOCK, per) == (BLOCK, -(-m_pad // (BLOCK * c)))
        for regs, b_pad in itertools.product((32, 40, 64), BATCHES):
            plan = p7_cuda.plan_launch(kind, m_pad, full, b_pad, regs, SMS)
            assert (plan.threads, plan.cluster, plan.groups, plan.max_groups, plan.per) == (
                BLOCK, c, 1, 1, per)
            assert plan.block_cluster and not (plan.block or plan.mem or plan.pair)
            rows = plan.n_trans + plan.n_chain
            assert plan.smem == p7_cuda.blocked_smem_bytes(per, rows, 1, block=True,
                                                           cluster=True)
            assert plan.smem == base + rows * row <= SMEM_PER_SM
            assert plan.n_chain == 0 or plan.n_trans == 6
            if rows < 6 + full:
                assert plan.smem + row > SMEM_PER_SM
            per_sm = 2 if regs <= 32 else 1  # THREADS_PER_SM and the registers
            per_sm = min(per_sm, SMEM_PER_SM // plan.smem)
            assert plan.grid == c * min(b_pad, max(1, SMS * per_sm // c))
        assert p7_cuda.plan_launch(kind, m_pad, full, 4096, 64, SMS, clusters=7).grid == 7 * c
        assert p7_cuda.plan_launch(kind, m_pad, full, 3, 64, SMS, clusters=7).grid == 3 * c
        with pytest.raises(ValueError, match=f"cluster of {c} wide blocks takes 1"):
            p7_cuda.plan_launch(kind, m_pad, full, 64, 64, SMS, groups=2)
        with pytest.raises(ValueError, match="runs the whole chain"):
            p7_cuda.plan_launch(kind, m_pad, full - 1, 64, 64, SMS)
    # per 8: no row staged; per 5: five transitions
    assert {8: (0, 0), 5: (5, 0)}.get(per, (1, 0)) == (
        p7_cuda.plan_launch("eager", m_pad, full, 64, 64, SMS)[6],
        p7_cuda.plan_launch("eager", m_pad, full, 64, 64, SMS).n_chain)
    for kind in p7_cuda.CLUSTER_KINDS:
        if kind == "lazy" and lazy:
            continue
        plan = p7_cuda.plan_launch(kind, m_pad, full, 64, 64, SMS)
        assert not plan.block_cluster and plan.threads in (THREADS, p7_cuda.MEM_THREADS) or (
            kind in p7_cuda.WIDE_CLUSTER_KINDS and m_pad > p7_cuda.MAX_CLUSTER_STATES
            and plan.wide_cluster)


@pytest.mark.parametrize("c,per", BLOCK_CLUSTER_CASES)
def test_block_cluster_shifts_equal_the_plain_shift(c, per):
    """The cluster of wide blocks' shifts (halos from block r - 1 below per,
    a larger shift's two source blocks, whole blocks away included, taken in
    place by wide_cluster_small and wide_cluster_big) equal the plain shift
    for every pass s = 2^p of c * 1024 * per states and both fills."""
    _check_shifts(per, BLOCK, cluster=c)


@pytest.mark.parametrize("c,per", BLOCK_CLUSTER_CASES)
def test_block_cluster_state_map_is_a_bijection(c, per):
    """State j of a cluster of wide blocks sits in (block, thread, slot)
    with j = block * 1024 * per + thread * per + slot: every state of the c
    * 1024 * per once, each block's slice in the wide block's layout; past
    the cluster it raises."""
    n = BLOCK * per
    seen = [p7_cuda.block_cluster_state(j, per, c) for j in range(c * n)]
    assert len(set(seen)) == c * n
    assert all(b * n + t * per + k == j and p7_cuda.block_state(j - b * n, per) == (t, k)
               for j, (b, t, k) in enumerate(seen))
    with pytest.raises(ValueError, match="wide blocks"):
        p7_cuda.block_cluster_state(c * n, per, c)


@pytest.mark.parametrize("m_pad,c,per", BLOCK_CLUSTER_WIDTHS)
def test_block_cluster_rows_are_thread_major_by_rank(m_pad, c, per):
    """block_rows of a cluster of c wide blocks is [c * (6 + passes), per,
    1024]: block r's slice (rows r * (6 + passes) on, where the kernel's
    block r reads) holds row q's state r * 1024 * per + t * per + k at (q,
    k, t), -inf past M_pad; at c = 1 it is the wide block's."""
    passes = p7_cuda.chain_passes(m_pad)
    rng = np.random.default_rng(m_pad)
    trans = torch.from_numpy(rng.normal(size=(8, m_pad)).astype(np.float32))
    chain = torch.from_numpy(rng.normal(size=(16, m_pad)).astype(np.float32))
    got = p7_cuda.block_rows(trans, chain, passes, per, c)
    assert got.shape == (c * (6 + passes), per, BLOCK) and got.is_contiguous()
    rows = torch.cat([trans[:6], chain[:passes]])
    for r in range(c):
        part = got[r * (6 + passes):(r + 1) * (6 + passes)]
        for q in (0, 5, 6, 5 + passes):
            for t in (0, 31, 32, BLOCK - 1):
                for k in range(per):
                    j = r * BLOCK * per + t * per + k
                    want = rows[q, j] if j < m_pad else p7_cuda.NEG_INF
                    assert part[q, k, t] == want
    first = torch.nn.functional.pad(trans[:, :BLOCK * per], (0, 0))
    assert torch.equal(got[:6 + passes],
                       p7_cuda.block_rows(first, chain[:, :BLOCK * per], passes, per))


@pytest.mark.parametrize("c,per", BLOCK_CLUSTER_CASES)
def test_block_cluster_releases_pair_up(c, per):
    """The rows' release protocol of the cluster of wide blocks
    (p7_viterbi.cuh::wide_cluster_big): at each larger shift i >= 2 a sender
    waits for one release from each block it stores into, and exactly those
    blocks send it one, at their larger shift i - 1 once its barrier has
    passed (every thread has read use i - 2's row by then), in the slot of
    its role (a: the receiver q blocks above, b: q + 1); at the last two
    larger shifts of a step none is sent. Each larger shift's releases
    complete an mbarrier of their own, the sender's halo mbarrier of that
    pass (2 + p, past every small shift's halo): the blocks that release a
    row change with q, and a release for use i + 2 may come from a block
    that never waits for the sender's use i. Every receiving block is sent
    the bytes it waits for."""
    n = BLOCK * per
    m = c * n
    full = p7_cuda.chain_passes(min(m, p7_cuda.MAX_KERNEL_STATES))
    small = sum(1 for p in range(full) if _small(1 << p, per))
    big = [1 << p for p in range(small, full)]
    sent = {}  # use -> {sender: [(role, receiver)]}
    for i in range(1, len(big)):
        if not i + 1 < len(big):
            continue
        s4 = big[i] << 1  # cluster_release is handed s << 1: use i + 1's shift
        assert s4 == big[i + 1]
        q, rest = divmod(s4, n)
        for r in range(c):
            for role, to in ((0, r - q if q >= 1 else -1), (1, r - q - 1 if rest > 0 else -1)):
                if to >= 0:
                    sent.setdefault(i + 1, {}).setdefault(to, []).append((role, r))
    for i, s in enumerate(big):
        q, rest = divmod(s, n)
        stored = [0] * c
        for b in range(c):
            want = []
            if q >= 1 and b + q < c:
                want.append((0, b + q))
                stored[b + q] += n - rest
            if rest > 0 and b + q + 1 < c:
                want.append((1, b + q + 1))
                stored[b + q + 1] += rest
            if i >= 2 and want:
                assert sorted(sent[i].get(b, [])) == sorted(want), (i, b)
            elif i >= 2:
                assert not sent.get(i, {}).get(b), (i, b)
        for r in range(c):
            from_a = q >= 1 and r - q >= 0
            from_b = rest > 0 and r - q - 1 >= 0
            assert stored[r] == (n - rest if from_a else 0) + (rest if from_b else 0)
    assert set(sent) == set(range(2, len(big)))
    ids = [2 + small + i for i in range(len(big))]  # 2 + p of each larger pass p
    assert len(set(ids)) == len(ids) and min(ids) >= 2 + small and max(ids) < 18
    # the blocks that release use i + 2 to a sender are not always among
    # those its use i waits on: a per-row mbarrier would mix the two uses
    mixed = False
    for i in range(2, len(big) - 2):
        for b in range(c):
            now = {r for _, r in sent.get(i, {}).get(b, [])}
            later = {r for _, r in sent.get(i + 2, {}).get(b, [])}
            mixed |= bool(later - now)
    assert mixed or c <= 2 or len(big) < 5


def test_block_cluster_cases_match_kernel_source():
    """The cluster of wide blocks' cases the two C entries compile are
    BLOCK_CLUSTER_PER at kBlockThreads (with_block_cluster_case), named by
    ``threads`` 1024 with ``cluster`` C of 2..kMaxBlockCluster, launched as
    clusters of C blocks of kBlockThreads threads; its shared memory is the
    wide block's and the cluster's area at 1024 threads (BLOCK_CLUSTER_FLOATS:
    two exchanges of 16 blocks' 32 warps, the 18 halos, 4 release slots, 24
    mbarriers); E combines each block's 32 warps by a lane butterfly and the
    blocks in rank order; combine_warps stays a 4- or 8-warp combine. The
    Viterbi source compiles the lazy kind's instance too (LAZY: block_chunk's
    CARRY step, pre_diag read from the D row and computed at the step's end
    in run_chunk's order, E = max_j M_j), launched on the same checks (the
    whole chain, k_run == n_passes), with shared-memory flags of its own."""
    csrc = p7_cuda._build.CSRC_DIR
    blocked = (csrc / "p7_blocked.cuh").read_text()
    cases = re.findall(r"P7_BLOCK_CLUSTER_CASE\((\d+)\)\n", blocked)
    assert tuple(int(c) for c in cases) == p7_cuda.BLOCK_CLUSTER_PER
    assert f"constexpr int kMaxBlockCluster = {p7_cuda.MAX_BLOCK_CLUSTER};" in blocked
    assert f"constexpr int kBlockClusterPerMin = {p7_cuda.BLOCK_CLUSTER_PER[0]};" in blocked
    assert f"constexpr int kBlockClusterPerMax = {p7_cuda.BLOCK_CLUSTER_PER[-1]};" in blocked
    assert ("return block_smem_floats<PER, KT>(n_rows) + cluster_floats<PER, KT>();" in blocked)
    assert p7_cuda.BLOCK_CLUSTER_FLOATS == 2 * 16 * 32 + 18 * 16 + 4 + 48 == 1364
    assert 'static_assert(KT == 128 || KT == 256, "4 or 8 warps");' in blocked
    assert "const float* x = A::xslots(c, q) + (t & 31);" in blocked
    assert "acc = b == 0 ? v : SUM ? acc + v : fmaxf(acc, v);" in blocked
    assert "cfg.blockDim = dim3(threads);" in blocked
    template = (csrc / "p7_viterbi.cuh").read_text()
    assert "viterbi_body<PER, KT, LAZY, LSE, false, Span::kCluster>(a);" in template
    assert "template <int PER, int KT, bool LSE, bool LAZY = false>" in template
    assert ("block_chunk<PER, KT, LSE, SPAN, LAZY>(a, smem, gs, r, count, par, tr_loop, tr_move, "
            "t, bar,\n") in template
    assert "v[k] = CARRY ? r.d[k]" in template
    assert "e = fmaxf(e, CARRY ? r.m[k] : fmaxf(r.m[k], v[k]));" in template
    assert ("r.d[k] = CARRY ? fmaxf(fmaxf(r.m[k] + tr(0, k), r.i[k] + tr(3, k)), v[k] + tr(5, k)) "
            ": v[k];") in template
    # the lazy step's own order (run_chunk): stay = max(M + tmm, I + tim), then D + tdm
    assert "const float stay = fmaxf(nm[k] + tr(0, k), ni[k] + tr(3, k));" in template
    assert "const float npd = fmaxf(stay, ac[k] + tr(5, k));" in template
    assert "a.k_run == a.n_passes &&" in template  # viterbi_block_plan_ok
    assert "area = smem + block_smem_floats<PER, KT>(n_rows);" in template
    assert "4 * block_cluster_smem_floats<PER, KT>(a.n_trans + a.n_chain)" in template
    assert ("slice = static_cast<size_t>(h->rank) * (kTransRows + a.n_passes) * PER * KT;"
            in template)
    assert ("if (i >= 1 && i + 1 < n) wide_cluster_release<PER, KT>(s << 1, id + 1, t, c);"
            in template)
    assert "mbar_wait(fbar, (c.hphase >> id) & 1u);" in template
    assert "n_passes - kSmall, 2 + p," in template
    for name, lse in (("p7_viterbi_kernel.cu", "false"), ("p7_forward_log_kernel.cu", "true")):
        source = (csrc / name).read_text()
        assert "with_block_cluster_case<BlockClusterCase>(" in source, name
        assert f"viterbi_block_cluster_kernel<PER, kBlockThreads, {lse}>" in source, name
        assert "if (threads == kBlockThreads && cluster >= 2) {" in source, name
        assert "stream, kBlockThreads);" in source, name
    viterbi = (csrc / "p7_viterbi_kernel.cu").read_text()
    assert "viterbi_block_cluster_kernel<PER, kBlockThreads, false, true>" in viterbi
    assert "unsigned block_cluster_smem_set[2][kBlockClusterSlots];" in viterbi
    assert "return decltype(c)::launch(lazy != 0, b, device, cluster, groups, grid, smem, st);" in (
        viterbi)
    assert "return decltype(c)::clusters(lazy != 0, device, cluster, smem, clusters);" in viterbi
