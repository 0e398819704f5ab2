"""The C-block clusters of 256-thread blocks (Forward, the row-saving
Forward, the backward pass and the Viterbi filter past 38,912 states: C =
9..14, per 17..19; csrc/p7_forward_kernel.cu::forward_wide_cluster_kernel,
csrc/p7_backward_kernel.cu::backward_wide_cluster_kernel,
csrc/p7_viterbi.cuh::viterbi_wide_cluster_kernel), checked on the
CPU against the models of tests/p7_layout_models.py: their cases, plan,
state map, shifts both ways, releases, thread-major rows, shared memory and
source.
"""

import itertools
import re

import numpy as np
import pytest
import torch
from p7_layout_models import (  # noqa: F401 (one_torch_thread: the module's fixture)
    BATCHES, REGS, SMS, _check_releases, _check_shifts, _check_shifts_up, _passes,
    one_torch_thread,
)

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM


# -- the C-block cluster of 256-thread blocks --------------------------------

WIDE = p7_cuda.WIDE_CLUSTER_THREADS
# (M_pad, C, per): the first width past 38,912, the widest and narrowest of
# C = 9 and 10, the all-24 join twice over (LENG 60362) and the chain's widest
WIDE_CLUSTER_WIDTHS = ((38920, 9, 17), (43776, 9, 19), (43784, 10, 18), (60368, 13, 19),
                       (65536, 14, 19))
# every (C, per) the plan takes past MAX_CLUSTER_STATES
WIDE_CLUSTER_CASES = sorted({(p7_cuda.cluster_blocks(m, "save"), p7_cuda.kernel_case(m, "save")[1])
                             for m in range(p7_cuda.MAX_CLUSTER_STATES + 8,
                                            p7_cuda.MAX_KERNEL_STATES + 1, 8)})


def test_wide_cluster_cases_cover_every_width():
    """Past 38,912 states up to 65536 Forward, the row-saving Forward, the
    backward pass and the Viterbi filter take C = ceil(M_pad / 4864) blocks
    of 256 threads and per = ceil(M_pad / (256 * C)): C of 9..14, per of
    WIDE_CLUSTER_PER (17..19, the three compiled cases a kind); every width
    of a C covered by its per, none by the C before; Forward, the
    row-saving Forward and the filter take one case at every width."""
    assert p7_cuda.WIDE_CLUSTER_KINDS == ("forward", "save", "backward", "filter")
    assert WIDE == 256
    assert {c for c, _ in WIDE_CLUSTER_CASES} == set(range(9, 15))
    assert {per for _, per in WIDE_CLUSTER_CASES} == set(p7_cuda.WIDE_CLUSTER_PER) == {17, 18, 19}
    for m in range(p7_cuda.MAX_CLUSTER_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8):
        c = p7_cuda.cluster_blocks(m, "backward")
        threads, per = p7_cuda.kernel_case(m, "backward")
        assert threads == WIDE and c * WIDE * per >= m > (c - 1) * WIDE * 19
        assert c * WIDE * (per - 1) < m and p7_cuda.wide_cluster_case(m, "save")
        assert p7_cuda.wide_cluster_case(m, "forward")
        for kind in ("forward", "filter"):
            assert (p7_cuda.cluster_blocks(m, kind), p7_cuda.kernel_case(m, kind)) == (
                c, (threads, per))
    for kind in p7_cuda.BLOCKED_KINDS:
        assert not p7_cuda.wide_cluster_case(p7_cuda.MAX_CLUSTER_STATES, kind)
        assert p7_cuda.wide_cluster_case(38920, kind) == (
            kind in ("forward", "save", "backward", "filter"))
    with pytest.raises(ValueError, match="65536"):
        p7_cuda.kernel_case(p7_cuda.MAX_KERNEL_STATES + 8, "save")


@pytest.mark.parametrize("m_pad,c,per", WIDE_CLUSTER_WIDTHS)
def test_wide_cluster_plan(m_pad, c, per):
    """Forward, the row-saving Forward and the backward pass past 38,912
    states (up to 65536) plan C 256-thread blocks a sequence (``threads`` 256,
    ``cluster`` C, ``per``; the plan's ``wide_cluster``, neither ``block``
    nor ``mem`` nor ``pair`` nor ``block_cluster``), one group a block (a
    forced G other than 1 raises), a grid of whole clusters (the
    ``clusters`` the card holds, else what an SM holds, one block, times the
    SMs over C; no more clusters than sequences), the transitions staged
    first and then chain rows, as many as fit the 232,448 bytes beside the
    group and the cluster's area (blocked_smem_bytes(cluster=True,
    threads=256)); a card that holds none (``clusters`` 0) plans the
    rows-in-memory case. The all-24 join twice over (60368) takes 13 blocks
    of 19 states, two transition rows staged for the row-saving Forward,
    three for Forward, whose group has no saved row, and five for the
    filter, whose four emission rows are bf16; every other kind keeps its
    case there."""
    row = 4 * WIDE * p7_cuda.blocked_stride(per)
    hrow = 4 * (WIDE * p7_cuda.bf16_stride(per) // 2)
    for kind in p7_cuda.WIDE_CLUSTER_KINDS:
        bwd, save, bf16 = kind == "backward", kind == "save", kind == "filter"
        assert p7_cuda.cluster_blocks(m_pad, kind) == c == -(-m_pad // 4864)
        assert p7_cuda.kernel_case(m_pad, kind) == (WIDE, per) == (WIDE, -(-m_pad // (WIDE * c)))
        base = p7_cuda.blocked_smem_bytes(per, 0, 1, save, bf16, bwd, cluster=True,
                                          threads=WIDE)
        group = (6 * row + 2 * hrow + 4 * (24 + 32 + 256) if bwd
                 else 2 * row + 4 * hrow + 4 * (16 + 32) if bf16
                 else (7 if save else 6) * row + 4 * (16 + 32))
        assert base == group + 2 * row + 4 * (852 if bwd else 596)
        for passes, regs, b_pad in itertools.product(_passes(kind, m_pad)[::3], REGS, BATCHES):
            plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
            assert (plan.threads, plan.cluster, plan.groups, plan.max_groups, plan.per) == (
                WIDE, c, 1, 1, per)
            assert plan.wide_cluster and not (plan.block or plan.mem or plan.pair
                                              or plan.block_cluster)
            rows = plan.n_trans + plan.n_chain
            assert plan.smem == base + rows * row <= SMEM_PER_SM
            assert plan.smem == p7_cuda.blocked_smem_bytes(per, rows, 1, save, bf16, bwd,
                                                           cluster=True, threads=WIDE)
            assert plan.n_chain == 0 or plan.n_trans == 6
            assert 0 <= plan.n_chain <= passes
            if rows < 6 + passes:
                assert plan.smem + row > SMEM_PER_SM
            warp_regs = -(-regs // 8) * 8 * 32
            per_sm = min(p7_cuda.REGS_PER_SM // (WIDE // 32 * warp_regs),
                         SMEM_PER_SM // plan.smem, p7_cuda.THREADS_PER_SM // WIDE)
            assert plan.grid == c * min(b_pad, max(1, SMS * per_sm // c))
        passes = _passes(kind, m_pad)[-1]
        assert p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS, clusters=7).grid == 7 * c
        assert p7_cuda.plan_launch(kind, m_pad, passes, 3, 128, SMS, clusters=7).grid == 3 * c
        with pytest.raises(ValueError, match=f"{c}-block cluster of 256-thread blocks takes 1"):
            p7_cuda.plan_launch(kind, m_pad, passes, 64, 128, SMS, groups=2)
        mem = p7_cuda.plan_launch(kind, m_pad, passes, 64, 64, SMS, clusters=0)
        assert mem.mem and (mem.threads, mem.per, mem.smem) == (
            p7_cuda.MEM_THREADS, -(-m_pad // 1024), 0)
    if m_pad == 60368:
        plan = p7_cuda.plan_launch("save", m_pad, 8, 64, 200, SMS)
        assert (plan.n_trans, plan.n_chain, plan.smem) == (2, 0, 216592)
        plan = p7_cuda.plan_launch("forward", m_pad, 8, 64, 200, SMS)
        assert (plan.n_trans, plan.n_chain, plan.smem) == (3, 0, 216592)
        plan = p7_cuda.plan_launch("filter", m_pad, 7, 64, 200, SMS)
        assert (plan.n_trans, plan.n_chain, plan.smem) == (5, 0, 216592)
    for kind in p7_cuda.BLOCKED_KINDS:
        if kind not in p7_cuda.WIDE_CLUSTER_KINDS:
            plan = p7_cuda.plan_launch(kind, m_pad, p7_cuda.chain_passes(m_pad), 64, 64, SMS)
            assert not plan.wide_cluster and (plan.mem or plan.block_cluster)


@pytest.mark.parametrize("c,per", WIDE_CLUSTER_CASES)
def test_wide_cluster_shifts_equal_the_plain_shift(c, per):
    """The 256-thread clusters' shifts: the Forward's toward higher j
    (cluster_shift_small / cluster_shift_big at KT = 256) and the backward
    pass's toward lower j (their mirrors) equal the plain shift and up-shift
    for every pass s = 2^p of c * 256 * per states, both fills, whole blocks
    away included, and the mirror's releases of every window."""
    _check_shifts(per, WIDE, cluster=c)
    _check_shifts_up(per, c, WIDE)


@pytest.mark.parametrize("c,per", WIDE_CLUSTER_CASES)
def test_wide_cluster_releases_land_on_their_use(c, per):
    """The release protocol at 256 threads a block, both directions, every
    window: as test_cluster_releases_land_on_their_use (the same
    primitives)."""
    for window in range(1, p7_cuda.chain_passes(min(c * WIDE * per, 1 << 16)) + 1):
        for mirror in (False, True):
            _check_releases(per, c, window, mirror, WIDE)


@pytest.mark.parametrize("c,per", WIDE_CLUSTER_CASES)
def test_wide_cluster_state_map_is_a_bijection(c, per):
    """State j of a C-block cluster of 256-thread blocks sits in (block,
    thread, slot) with j = block * 256 * per + thread * per + slot: every
    state of the c * 256 * per once; past the cluster it raises."""
    n = WIDE * per
    seen = [p7_cuda.wide_cluster_state(j, per, c) for j in range(c * n)]
    assert len(set(seen)) == c * n
    assert all(b * n + t * per + k == j and 0 <= t < WIDE and 0 <= k < per
               for j, (b, t, k) in enumerate(seen))
    with pytest.raises(ValueError, match="256-thread"):
        p7_cuda.wide_cluster_state(c * n, per, c)


def test_wide_cluster_shared_memory_matches_the_header_layout():
    """blocked_smem_bytes(cluster=True, threads=256) is the headers' layout
    at KT = 256: cluster_smem_floats (smem_floats of one row-saving group:
    two shift rows, four emission rows, 2 * 8 reduction floats, the token
    chunk and the two bf16 rows; then cluster_floats: two landing rows and
    two exchanges of 16 blocks' 8 warps, the 18 halos, 4 slots, 24
    mbarriers) and backward_smem_floats of the cluster (its group, then an
    area of two values a slot); cluster_floats stays the 128-thread
    CLUSTER_FLOATS at 128 threads. Forward's group (SAVE false) has no
    saved row: at 19 states a thread the 19,456 bytes it frees stage a third
    transition row in the same 216,592 bytes, and a fourth would not fit; at
    17 five of the six fit, against the row-saving group's four."""
    blocked = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert ("return 2 * row_floats<PER, KT>() + XV * 2 * kMaxCluster * warps<KT>() +\n"
            "         kHaloIds * kHaloSlots + 4 + 2 * kPairBars;") in blocked
    assert p7_cuda.cluster_floats(WIDE) == 2 * 16 * 8 + 18 * 16 + 4 + 48 == 596
    assert p7_cuda.cluster_floats(WIDE, backward=True) == 2 * 2 * 16 * 8 + 18 * 16 + 4 + 48 == 852
    assert p7_cuda.cluster_floats() == p7_cuda.CLUSTER_FLOATS == 468
    assert p7_cuda.cluster_floats(backward=True) - 468 == p7_cuda.CLUSTER_X2_FLOATS == 128
    row = WIDE * 19
    assert p7_cuda.blocked_smem_bytes(19, 2, 1, save=True, cluster=True, threads=WIDE) == 4 * (
        2 * row + (2 * row + 4 * row + 16 + 32 + row) + 2 * row + 596) == 216592
    hrow = WIDE * 19 // 2
    assert p7_cuda.blocked_smem_bytes(19, 2, 1, backward=True, cluster=True, threads=WIDE) == 4 * (
        2 * row + (6 * row + 2 * hrow + 24 + 32 + 256) + 2 * row + 852) == 218672
    assert p7_cuda.blocked_smem_bytes(19, 3, 1, cluster=True, threads=WIDE) == 4 * (
        3 * row + (2 * row + 4 * row + 16 + 32) + 2 * row + 596) == 216592
    assert p7_cuda.blocked_smem_bytes(19, 4, 1, cluster=True, threads=WIDE) > SMEM_PER_SM
    assert p7_cuda.blocked_smem_bytes(19, 3, 1, save=True, cluster=True, threads=WIDE) > (
        SMEM_PER_SM)
    row = WIDE * 17
    assert p7_cuda.blocked_smem_bytes(17, 4, 1, save=True, cluster=True, threads=WIDE) == 4 * (
        4 * row + 7 * row + 48 + 2 * row + 596) <= SMEM_PER_SM
    assert p7_cuda.blocked_smem_bytes(17, 5, 1, cluster=True, threads=WIDE) == 4 * (
        5 * row + 6 * row + 48 + 2 * row + 596) <= SMEM_PER_SM
    assert p7_cuda.blocked_smem_bytes(17, 6, 1, cluster=True, threads=WIDE) > SMEM_PER_SM


def test_wide_cluster_cases_match_kernel_source():
    """The 256-thread clusters' cases the two C entries compile are
    WIDE_CLUSTER_PER at kWideClusterThreads (with_wide_cluster_case), named
    by ``threads`` 256 with ``cluster`` C; forward_wide_cluster_kernel runs
    forward_body's two cases (the plain Forward's, SAVE false, and the
    row-saving one, each with shared-memory flags of its own and
    cluster_smem_floats with or without the saved row) and
    backward_wide_cluster_kernel backward_body at KT = 256 on a C-block
    cluster, bounded to one block of
    256 threads an SM, launched as clusters of C blocks of 256 threads; the
    launch checks the plan's shape (wide_cluster_ok: n_trans up to six) and
    the exact shared memory; the queries of registers and clusters take the
    case by its threads; combine_warps sums a block's eight warps."""
    csrc = p7_cuda._build.CSRC_DIR
    blocked = (csrc / "p7_blocked.cuh").read_text()
    cases = re.findall(r"P7_WIDE_CLUSTER_CASE\((\d+)\)\n", blocked)
    assert tuple(int(c) for c in cases) == p7_cuda.WIDE_CLUSTER_PER
    assert f"constexpr int kWideClusterThreads = {WIDE};" in blocked
    assert f"constexpr int kWideClusterPerMin = {p7_cuda.WIDE_CLUSTER_PER[0]};" in blocked
    assert f"constexpr int kWideClusterPerMax = {p7_cuda.WIDE_CLUSTER_PER[-1]};" in blocked
    assert "grid >= c && grid % c == 0 && n_trans >= 0 && n_trans <= kTransRows;" in blocked
    assert 'static_assert(KT == 128 || KT == 256, "4 or 8 warps");' in blocked
    forward = (csrc / "p7_forward_kernel.cu").read_text()
    assert "forward_body<PER, kWideClusterThreads, SAVE, Span::kCluster>(a);" in forward
    assert "forward_wide_cluster_kernel<PER, true>" in forward
    assert ("return save ? forward_wide_cluster_kernel<PER, true> : "
            "forward_wide_cluster_kernel<PER, false>;") in forward
    assert "4 * cluster_smem_floats<PER, KT, false>(n_rows, save)" in forward
    assert "unsigned wide_cluster_smem_set[2][kWideClusterSlots];" in forward
    assert "if (save == 0" not in forward  # the entries take both cases
    backward = (csrc / "p7_backward_kernel.cu").read_text()
    assert "backward_body<PER, kWideClusterThreads, Span::kCluster>(a);" in backward
    assert "4 * backward_smem_floats<PER, KT, Span::kCluster>(n_rows, 1)" in backward
    for source in (forward, backward):
        assert "__launch_bounds__(kWideClusterThreads, 1)" in source
        assert source.count("if (threads == kWideClusterThreads) {") == 3
        assert "with_wide_cluster_case<WideClusterCase>(per" in source
        assert "grid, smem, stream, KT);" in source and "c, smem, out, KT);" in source
        assert "wide_cluster_ok(a.m_pad, PER, c, groups, grid, a.n_trans)" in source
    assert "const int n_trans = KT == 128 ? kTransRows : a.n_trans;" in forward
    assert "const int n_trans = KT == 128 ? kTransRows : a.n_trans;" in backward
    assert "if (KT == 128 || q < n_trans) return staged[q * row_floats<PER, KT>() + k];" in blocked
    # the unstaged rows: the block's slice of their thread-major copy
    # (block_rows at 256 threads, fill 0), passed as the launchers' scratch
    assert "return __ldg(tm + (q * PER + k) * KT);" in blocked
    assert ("tm = a.tm + static_cast<size_t>(h.rank) * (kTransRows + window) * PER * KT + t;"
            in forward)
    assert ("tm = a.scratch + static_cast<size_t>(h.rank) * (kTransRows + a.window) * PER * KT"
            " + t;") in backward
    for source in (forward, backward):
        assert "const float* c = tm + (kTransRows + p) * PER * KT;" in source
        assert "ac[k] = ac[k] + sh[k] * __ldg(c + k * KT);" in source


@pytest.mark.parametrize("m_pad,c,per", WIDE_CLUSTER_WIDTHS)
def test_wide_cluster_rows_are_thread_major_by_rank(m_pad, c, per):
    """The 256-thread clusters' constant rows as the kernels read the ones
    a block does not stage (p7_cuda.case_rows: block_rows at 256 threads,
    fill 0): [c * (6 + window), per, 256], block r's slice (rows r * (6 +
    window) on) holding row q's state r * 256 * per + t * per + k at (q, k,
    t), 0 past M_pad, where TransRows reads (q * per + k) * 256 + t of it."""
    window = 8
    rng = np.random.default_rng(m_pad + 1)
    trans = torch.from_numpy(rng.random(size=(8, m_pad)).astype(np.float32))
    chain = torch.from_numpy(rng.random(size=(window, m_pad)).astype(np.float32))
    plan = p7_cuda.plan_launch("save", m_pad, window, 64, 128, SMS)
    got = p7_cuda.case_rows(plan, trans, chain, window, "cpu")
    assert got.shape == (c * (6 + window), per, WIDE) and got.is_contiguous()
    flat = got.reshape(-1)
    rows = torch.cat([trans[:6], chain])
    for r in (0, 1, c - 1):
        base = r * (6 + window) * per * WIDE
        for q in (0, 2, 5, 6, 5 + window):
            for t in (0, 31, 32, WIDE - 1):
                for k in (0, per - 1):
                    j = r * WIDE * per + t * per + k
                    want = rows[q, j] if j < m_pad else 0.0
                    assert flat[base + (q * per + k) * WIDE + t] == want


@pytest.mark.parametrize("held", (None, 0), ids=("clusters-held", "no-cluster-held"))
def test_device_plans_past_32768(monkeypatch, held):
    """device_plan's route for the lazy Viterbi and Forward at every width
    the cover tests walk (M_pad 9224..65536 for the lazy kind, 38,920..65536
    for Forward) and at LENG 60362 (M_pad 60368), with the card's answers
    stubbed (registers, SMs, the occupancy query): past 32,768 the lazy kind
    plans the eager kind's cluster of wide blocks (C 5..8, the whole chain),
    past 38,912 Forward the row-saving Forward's cluster of 256-thread
    blocks (C 9..14), each the case kernel_case and cluster_blocks name; a
    card that holds none of those clusters (the query answering 0) plans
    their rows-in-memory case; up to 32,768 the lazy kind keeps its
    128-thread C-block cluster."""
    monkeypatch.setattr(p7_cuda, "kernel_regs", lambda kind, per, threads=128, cluster=1: (
        64 if threads == p7_cuda.BLOCK_THREADS else 200 if threads == WIDE else 128))
    monkeypatch.setattr(p7_cuda, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(p7_cuda, "max_clusters", lambda *args: 7)

    def occupancy(kind, per, smem, index, cluster, threads=p7_cuda.KERNEL_THREADS):
        return 7 if held is None or threads == p7_cuda.KERNEL_THREADS else held

    monkeypatch.setattr(p7_cuda, "_cluster_held", occupancy)
    for m_pad in range(p7_cuda.MAX_BLOCK_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8):
        full = p7_cuda.chain_passes(m_pad)
        passes = full if m_pad > 32768 else 5
        plan = p7_cuda.device_plan("lazy", m_pad, passes, 64, "cpu")
        c, (threads, per) = p7_cuda.cluster_blocks(m_pad, "lazy"), p7_cuda.kernel_case(m_pad,
                                                                                      "lazy")
        if m_pad <= p7_cuda.LAZY_BLOCK_STATES:
            assert c >= 3 and (plan.cluster, plan.threads, plan.per) == (
                c, p7_cuda.KERNEL_THREADS, per)
            continue
        assert (c, threads, per) == (p7_cuda.cluster_blocks(m_pad, "eager"),
                                     *p7_cuda.kernel_case(m_pad, "eager"))
        if held == 0:
            assert plan.mem and plan.per == -(-m_pad // 1024)
        else:
            assert plan.block_cluster and (plan.cluster, plan.per, plan.grid) == (c, per, 7 * c)
        if m_pad <= p7_cuda.MAX_CLUSTER_STATES:
            continue
        plan = p7_cuda.device_plan("forward", m_pad, 6, 64, "cpu")
        c, (threads, per) = p7_cuda.cluster_blocks(m_pad, "forward"), p7_cuda.kernel_case(
            m_pad, "forward")
        assert (c, threads, per) == (p7_cuda.cluster_blocks(m_pad, "save"),
                                     *p7_cuda.kernel_case(m_pad, "save"))
        if held == 0:
            assert plan.mem and plan.per == -(-m_pad // 1024)
        else:
            assert plan.wide_cluster and (plan.cluster, plan.per, plan.grid) == (c, per, 7 * c)
            assert plan.smem == p7_cuda.blocked_smem_bytes(
                per, plan.n_trans + plan.n_chain, 1, cluster=True, threads=WIDE)
    # LENG 60362: the lazy kind on 8 wide blocks of 8, Forward on 13 256-thread blocks of 19
    lazy = p7_cuda.device_plan("lazy", 60368, 16, 64, "cpu")
    fwd = p7_cuda.device_plan("forward", 60368, 6, 64, "cpu")
    if held == 0:
        assert lazy.mem and fwd.mem
    else:
        assert (lazy.threads, lazy.cluster, lazy.per) == (p7_cuda.BLOCK_THREADS, 8, 8)
        assert (fwd.threads, fwd.cluster, fwd.per, fwd.n_trans) == (WIDE, 13, 19, 3)
