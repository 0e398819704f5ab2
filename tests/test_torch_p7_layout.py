"""The blocked layout and launch plan of the redesigned p7 kernels
(csrc/p7_blocked.cuh, csrc/p7_viterbi.cuh, csrc/p7_forward_kernel.cu) at
normal width and on the cluster pair, checked on the CPU: the kernels
themselves run only on the card. The models are tests/p7_layout_models.py;
the C-block clusters, the wide block and its clusters and the 256-thread
clusters have files of their own (tests/test_torch_p7_layout_*.py).

* The shared-row index the kernels use (thread t's slot k of state
  j = t * per + k at t * stride + k, stride = per rounded up to odd) is a
  bijection whose 32 neighbouring threads hit 32 banks.
* The shifts as the kernels do them (``shift_small``: register moves plus
  the previous thread's last s slots; ``shift_big``: the row read at
  j - s) equal ``p7_cuda._shift`` for every per 1..19 and s = 2^p, and the
  Viterbi filter's bf16 emission rows (``hstride``) read without conflicts.
* The cluster pair (every kind's wide case: two blocks of 128 threads,
  block r owning states r * 128 * per ..): its state map is a bijection,
  its shifts (``pair_shift_small``, ``pair_shift_big``: block 1's first
  states read from block 0's shift buffer) and its mirrors toward lower j
  (``pair_shift_up``) equal ``p7_cuda._shift`` / ``posterior_cuda._up`` for
  every per 10..19 and s = 2^p, its rows' releases cannot mix uses, and its
  plan stages every row that fits in a block, one group a block, an even
  grid.
* ``plan_launch`` keeps every case within the block's shared memory and the
  SM's registers, picks G = 1 up to one sequence an SM, leaves chain rows
  in global memory when a group would not fit, runs the rows-in-memory case
  (1024 threads, one sequence a block, nothing staged) where no register
  case or cluster holds the width, and raises past 65536.
* The backward coverage pass's suffix shifts (``shift_up_small``,
  ``shift_up_big``) equal ``posterior_cuda._up``, and its group layout
  (``backward_group_floats``) is what ``blocked_smem_bytes`` counts.
"""

import itertools
import re

import numpy as np
import pytest
import torch
from p7_layout_models import (  # noqa: F401 (one_torch_thread: the module's fixture)
    BATCHES, CASES, PERS, REGS, SMS, THREADS, _check_releases, _check_row_index,
    _check_shifts, _check_shifts_up, _hidx, _kernel_shift_up, _larger_shifts, _passes,
    _row_mbarrier_mixes, one_torch_thread,
)

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda, posterior_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM


@pytest.mark.parametrize("per", PERS)
def test_shared_row_index_is_a_conflict_free_bijection(per):
    _check_row_index(per, THREADS)


@pytest.mark.parametrize("threads,per", CASES)
def test_kernel_suffix_shifts_equal_the_plain_up_shift(threads, per):
    """The backward pass's shifts toward lower j, as the kernel does them,
    equal posterior_cuda._up (0 past the row) for every case and s = 2^p."""
    rng = np.random.default_rng(100 + per)
    m = threads * per
    x = torch.from_numpy(rng.normal(size=(2, m)).astype(np.float32))
    for p in range(p7_cuda.chain_passes(m) + 1):
        s = 1 << p
        assert torch.equal(_kernel_shift_up(x, s, per, threads), posterior_cuda._up(x, s)), s


@pytest.mark.parametrize("per", PERS)
def test_kernel_shifts_equal_the_plain_shift(per):
    _check_shifts(per, THREADS)


@pytest.mark.parametrize("per", p7_cuda.PAIR_PER)
def test_pair_shifts_equal_the_plain_shift(per):
    """The cluster pair's shifts, across the cluster included, for every
    Hillis-Steele pass s = 2^p of 2 * 128 * per states."""
    _check_shifts(per, THREADS, cluster=2)


@pytest.mark.parametrize("per", p7_cuda.PAIR_PER)
def test_pair_state_map_is_a_bijection(per):
    """State j of the cluster pair sits in (block, thread, slot) with j =
    block * 128 * per + thread * per + slot: every state of the 2 * 128 *
    per once, each block its half in the normal-width layout."""
    seen = [p7_cuda.pair_state(j, per) for j in range(2 * THREADS * per)]
    assert sorted(seen) == [(b, t, k) for b in range(2) for t in range(THREADS)
                            for k in range(per)]
    for j, (b, t, k) in enumerate(seen):
        assert b * THREADS * per + t * per + k == j


@pytest.mark.parametrize("per", p7_cuda.PAIR_PER)
def test_pair_mirror_shifts_equal_the_plain_up_shift(per):
    """The cluster pair's shifts toward lower j (the backward pass's wide
    case), across the pair included, for every pass s = 2^p of 2 * 128 *
    per states."""
    _check_shifts_up(per, 2)


@pytest.mark.parametrize("per", p7_cuda.PAIR_PER)
def test_pair_releases_cannot_mix(per):
    """The cluster pair keeps each row's releases on the row's own mbarrier
    (pair_shift_big, pair_shift_up_big): with two blocks, whatever s is,
    block 0 is the one sender and block 1 the one reader of every larger
    shift (the mirror: the other way round), so the release of a row's use
    i + 2 always comes from the block that waited on its use i. The C-block
    clusters' release model at C = 2 says the same for every window: every
    release goes from the reader to the sender, and no use mixes."""
    n = THREADS * per
    for window in range(1, p7_cuda.chain_passes(2 * n) + 1):
        big, _ = _larger_shifts(per, window)
        for mirror in (False, True):
            sender, reader = (1, 0) if mirror else (0, 1)
            sent = _check_releases(per, 2, window, mirror)
            for i, by_sender in sent.items():
                assert set(by_sender) <= {sender}
                assert {r for _, r in by_sender.get(sender, [])} <= {reader}
            assert not _row_mbarrier_mixes(sent, 2)
    blocked = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert "if (pr.rank == 1 && i + 2 < n) {" in blocked  # block 1 releases block 0's stores
    assert "if (pr.rank == 0 && i + 2 < n) {" in blocked  # the mirror's block 0 releases block 1's
    assert "the two\n// blocks never change roles" in blocked


@pytest.mark.parametrize("per", PERS)
def test_bf16_rows_read_without_conflicts(per):
    """The filter's bf16 emission rows: a bijection into threads *
    bf16_stride halfwords, each thread's slots contiguous; a warp's reads of
    one slot (16-bit at odd per, the global row's contiguous copy) hit at
    most two words a bank; of one slot pair (32-bit at even per) 32 banks.
    The row is a whole number of 16-byte chunks, and so is the copy of a
    multiple-of-8 M_pad."""
    hs = p7_cuda.bf16_stride(per)
    idx = [_hidx(j, per) for j in range(THREADS * per)]
    assert len(set(idx)) == len(idx) and max(idx) < THREADS * hs
    assert (THREADS * hs * 2) % 16 == 0
    if per % 2:
        assert hs == per and idx == list(range(THREADS * per))
        for k in range(per):
            words = [(t * hs + k) // 2 for t in range(32)]
            by_bank = {}
            for w in words:
                by_bank.setdefault(w % 32, set()).add(w)
            assert max(len(v) for v in by_bank.values()) <= 2
    else:
        assert (hs // 2) % 2 == 1
        for k in range(0, per, 2):
            assert len({(t * hs + k) // 2 % 32 for t in range(32)}) == 32
            assert all(_hidx(t * per + k, per) % 2 == 0 for t in range(32))


@pytest.mark.parametrize("kind", p7_cuda.BLOCKED_KINDS)
def test_plan_fits_the_block_for_every_case(kind):
    """Every (threads, per) group case, at its narrowest and widest M_pad;
    every kind takes the wider widths on the cluster pair
    (test_pair_plan_fits_the_block)."""
    for threads, per in CASES:
        for m_pad in sorted({max(8, threads * (per - 1) + 8), threads * per}):
            assert p7_cuda.kernel_case(m_pad) == (threads, per)
            for passes, regs, b_pad in itertools.product(_passes(kind, m_pad), REGS, BATCHES):
                plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
                assert plan.smem <= SMEM_PER_SM == 232448
                assert plan.threads == threads and plan.cluster == 1
                assert 0 <= plan.n_chain <= passes
                assert plan.n_trans == 6
                assert 1 <= plan.groups <= plan.max_groups <= p7_cuda.MAX_BLOCK_THREADS // threads
                warp_regs = -(-regs // 8) * 8 * 32
                assert plan.groups * (threads // 32) * warp_regs <= p7_cuda.REGS_PER_SM
                assert 1 <= plan.grid <= -(-b_pad // plan.groups)
                if b_pad <= SMS:
                    assert plan.groups == 1 and plan.grid == b_pad
                extra = 1 if kind == "lazy" and passes < p7_cuda.chain_passes(m_pad) else 0
                args = (kind == "save", kind == "filter", kind == "backward")
                rows = plan.n_trans + plan.n_chain + extra
                assert plan.smem == p7_cuda.blocked_smem_bytes(per, rows, plan.groups, *args)
                # nothing more would fit: every row staged, or one more row
                # would not leave room for one group
                if plan.n_chain < passes:
                    assert p7_cuda.blocked_smem_bytes(per, rows + 1, 1, *args) > SMEM_PER_SM


def test_plan_stages_every_row_at_the_timed_shapes():
    """1400.hmm (M_pad 1400, 11 slots) at the registers the kernels compile
    to there: every chain row in shared memory, G = 4 at 4096 rows (the
    registers' limit at 128 a thread), 1 at 64."""
    for kind, passes, regs, g in (("eager", 11, 127, 4), ("log", 11, 128, 4), ("lazy", 5, 128, 4),
                                  ("forward", 6, 118, 4), ("save", 6, 128, 4)):
        plan = p7_cuda.plan_launch(kind, 1400, passes, 4096, regs, SMS)
        assert (plan.groups, plan.grid, plan.n_chain) == (g, SMS, passes), kind
        few = p7_cuda.plan_launch(kind, 1400, passes, 64, regs, SMS)
        assert (few.groups, few.grid, few.n_chain) == (1, 64, passes), kind


def test_wide_profiles_read_the_last_chain_rows_from_global_memory():
    """At 19 slots the eager chain's 12 rows and the six transitions leave
    no room for a group: the last row stays in global memory."""
    plan = p7_cuda.plan_launch("eager", 2432, 12, 4096, 200, SMS)
    assert (plan.n_chain, plan.groups) == (11, 1)


def test_plan_takes_a_forced_group_count():
    plan = p7_cuda.plan_launch("lazy", 1400, 5, 64, 128, SMS, groups=4)
    assert (plan.groups, plan.grid) == (4, 16)
    with pytest.raises(ValueError, match="1..4"):
        p7_cuda.plan_launch("lazy", 1400, 5, 64, 128, SMS, groups=5)
    with pytest.raises(ValueError, match="groups"):
        p7_cuda.plan_launch("eager", 1400, 11, 64, 128, SMS, groups=0)


def test_plan_limits_raise():
    with pytest.raises(ValueError, match="65536"):
        p7_cuda.plan_launch("eager", p7_cuda.MAX_KERNEL_STATES + 8, 13, 64, 128, SMS)
    with pytest.raises(ValueError, match="chain passes"):
        p7_cuda.plan_launch("forward", 1400, 12, 64, 128, SMS)
    with pytest.raises(ValueError, match="case"):
        p7_cuda.plan_launch("bogus", 1400, 4, 64, 128, SMS)


def test_pair_plan_stages_the_rows_that_fit():
    """On the cluster pair a block's row is 128 threads long: the backward
    pass at 19 slots stages all six transitions and every row of a 7-pass
    suffix window beside its group and the pair's area (two rows and 356 +
    16 floats: its exchanges carry two values a warp); the eager case at 19
    slots stages 9 of its 13 chain rows, the lazy window at 10 slots every
    row, and the Forward and row-saving Forward at 19 slots every row of a
    7-pass window."""
    row = 4 * THREADS * 19
    plan = p7_cuda.plan_launch("backward", 4864, 7, 4096, 128, SMS)
    assert (plan.threads, plan.cluster, plan.n_trans, plan.n_chain, plan.groups) == (
        THREADS, 2, 6, 7, 1)
    group = 6 * row + 2 * (row // 2) + 4 * (12 + 32 + 256)
    assert plan.smem == 13 * row + group + 2 * row + 4 * (356 + 16) <= SMEM_PER_SM
    for kind in ("forward", "save"):
        plan = p7_cuda.plan_launch(kind, 4864, 7, 4096, 128, SMS)
        assert (plan.threads, plan.cluster, plan.n_trans, plan.n_chain) == (THREADS, 2, 6, 7)
    plan = p7_cuda.plan_launch("eager", 4864, 13, 4096, 128, SMS)
    assert (plan.threads, plan.cluster, plan.n_trans, plan.n_chain, plan.groups) == (
        THREADS, 2, 6, 9, 1)
    assert plan.smem == (15 + 6 + 2) * row + 4 * (8 + 32 + 356) <= SMEM_PER_SM
    assert plan.smem + row > SMEM_PER_SM
    plan = p7_cuda.plan_launch("lazy", 2440, 4, 4096, 128, SMS)
    assert (plan.threads, plan.cluster, plan.n_trans, plan.n_chain) == (THREADS, 2, 6, 4)


@pytest.mark.parametrize("kind", p7_cuda.PAIR_KINDS)
def test_pair_plan_fits_the_block(kind):
    """Every wide case (2432 < M_pad <= 4864) plans the cluster pair (the
    row-saving Forward's group with its bf16 rows, the backward pass's with
    its two-value exchanges): 128 threads and one group a block (a forced G
    other than 1 raises), an even grid of clusters of 2 (the ``clusters``
    the card holds, else what an SM's registers, shared memory and threads
    allow, two SMs a cluster; no more than the batch's sequences), every
    transition row staged and as many chain rows as fit the 232,448 bytes
    of a block."""
    for per in p7_cuda.PAIR_PER:
        for m_pad in sorted({max(THREADS * 19 + 8, 2 * THREADS * (per - 1) + 8),
                             2 * THREADS * per}):
            assert p7_cuda.kernel_case(m_pad) == p7_cuda.kernel_case(m_pad, kind) == (
                THREADS, per)
            assert p7_cuda.cluster_blocks(m_pad, kind) == p7_cuda.CLUSTER
            for passes, regs, b_pad in itertools.product(_passes(kind, m_pad), REGS, BATCHES):
                plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
                assert (plan.threads, plan.cluster, plan.groups, plan.max_groups) == (
                    THREADS, p7_cuda.CLUSTER, 1, 1)
                assert plan.grid % 2 == 0 and 1 <= plan.grid // 2 <= b_pad
                extra = 1 if kind == "lazy" and passes < p7_cuda.chain_passes(m_pad) else 0
                rows = plan.n_trans + plan.n_chain + extra
                bf16, save, bwd = kind == "filter", kind == "save", kind == "backward"
                assert plan.n_trans == 6 and 0 <= plan.n_chain <= passes
                assert plan.smem == p7_cuda.blocked_smem_bytes(
                    per, rows, 1, save, bf16=bf16, backward=bwd, pair=True) <= SMEM_PER_SM
                if plan.n_chain < passes:
                    assert p7_cuda.blocked_smem_bytes(per, rows + 1, 1, save, bf16=bf16,
                                                      backward=bwd, pair=True) > SMEM_PER_SM
                warp_regs = -(-regs // 8) * 8 * 32
                per_sm = min(p7_cuda.REGS_PER_SM // (4 * warp_regs), SMEM_PER_SM // plan.smem,
                             p7_cuda.THREADS_PER_SM // THREADS)
                assert plan.grid // 2 == min(b_pad, SMS * per_sm // 2)
            assert p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS,
                                       clusters=50).grid == 100
            assert p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS, groups=1).groups == 1
            with pytest.raises(ValueError, match="cluster pair takes 1"):
                p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS, groups=2)


def test_pair_cases_match_kernel_source():
    """The pair's cases the C entries compile are PAIR_PER (with_pair_case,
    csrc/p7_blocked.cuh); no source instantiates a 256-thread group case any more
    (with_group_case: 128 threads a group); every source launches the pair
    as clusters of 2 through the clusters' launch (p7_blocked.cuh, c = 2),
    the Forward with its row-saving group before the exchange area, the
    backward pass with its own group and an area of two values a slot; a
    pair block's exchange area (two rows of the partner's states, two
    exchanges of a value a warp of both blocks, XV of them for the backward
    pass's, 18 halos of 16 slots, 4 release slots, 24 mbarriers) is what the
    plan counts after its group; an exchange puts each warp's value at slot
    rank * 4 + warp of both blocks and combines the eight in the 256-thread
    order (block 0's four warps, then block 1's); a halo is a shift by at
    most 16, its id 2 + p for pass p."""
    csrc = p7_cuda._build.CSRC_DIR
    blocked = (csrc / "p7_blocked.cuh").read_text()
    cases = re.findall(r"P7_PAIR_CASE\((\d+)\)\n", blocked)
    assert tuple(int(c) for c in cases) == p7_cuda.PAIR_PER
    assert "constexpr int kHaloIds = 2 + 16;" in blocked and "constexpr int kHaloSlots = 16;" in blocked
    assert ("return 2 * row_floats<PER, KT>() + XV * 2 * 2 * warps<KT>() + kHaloIds * kHaloSlots + 4 +"
            "\n         2 * kPairBars;" in blocked)
    assert "P7_CASE(19, 128)" in blocked and ", 256)" not in blocked and "with_case(" not in blocked
    assert "constexpr int kPairBars = kHaloIds + 2 + 2 + 2;" in blocked
    assert p7_cuda.PAIR_FLOATS == 16 + 18 * 16 + 4 + 48 == 356
    assert p7_cuda.blocked_smem_bytes(11, 3, 1, pair=True) == (
        p7_cuda.blocked_smem_bytes(11, 3, 1) + 4 * (2 * THREADS * 11 + 356))
    for per in p7_cuda.PAIR_PER:  # the passes whose shift is a halo
        assert sum(1 for p in range(16) if (1 << p) < per and (1 << p) <= 16) == (
            5 if per > 16 else 4)
    assert "return PER > 16 ? 5 : PER > 8 ? 4 : PER > 4 ? 3 : PER > 2 ? 2 : PER > 1 ? 1 : 0;" in blocked
    assert "4 * (q * X + pr.rank * warps<KT>() + (t >> 5))" in blocked
    assert "return combine_warps<SUM, 2 * KT>(pair_collect<KT>(q, pr));" in blocked
    assert p7_cuda.chain_passes(4864) + 2 <= 18
    sources = ("p7_viterbi_kernel.cu", "p7_forward_log_kernel.cu", "p7_viterbi_filter_kernel.cu",
               "p7_forward_kernel.cu", "p7_backward_kernel.cu")
    for name in sources:
        source = (csrc / name).read_text()
        assert "with_case<" not in source and "with_group_case<Case>" in source, name
        assert "with_pair_case<PairCase>" in source, name
    assert "attr->val.clusterDim.x = c;" in blocked and "cudaLaunchKernelEx(&cfg, kernel, a)" in blocked
    for name in sources:
        source = (csrc / name).read_text()
        assert re.search(r"launch_cluster\([^;]*pair_smem_set(\[[^\]]*\])+, 2, grid,\s+smem", source), name
    template = (csrc / "p7_viterbi.cuh").read_text()
    assert "viterbi_body<PER, 128, LAZY, LSE, FILT, Span::kPair>(a);" in template
    forward = (csrc / "p7_forward_kernel.cu").read_text()
    assert "forward_body<PER, 128, SAVE, Span::kPair>(a);" in forward
    assert "float* area = smem + n_rows * ROW + group_floats<PER, KT, false>(SAVE);" in forward
    assert "pair_setup<PER, KT>(h, area, t);" in forward
    assert "4 * pair_smem_floats<PER, 128, false>(n_rows, save)" in forward
    assert ("return smem_floats<PER, KT, BF16>(n_rows, 1, save) + pair_floats<PER, KT>();"
            in blocked)
    assert p7_cuda.blocked_smem_bytes(11, 3, 1, save=True, pair=True) == (
        p7_cuda.blocked_smem_bytes(11, 3, 1, save=True) + 4 * (2 * THREADS * 11 + 356))
    backward = (csrc / "p7_backward_kernel.cu").read_text()
    assert "backward_body<PER, 128, Span::kPair>(a);" in backward
    assert "float* area = smem + n_rows * ROW + backward_group_floats<PER, KT>();" in backward
    assert "pair_setup_up<PER, KT>(h, area, t);" in backward
    assert "pair_setup<PER, KT, 2>(pr, area, t);" in blocked  # pair_setup_up's area
    assert "4 * backward_smem_floats<PER, 128, Span::kPair>(n_rows, 1)" in backward
    assert "S == Span::kPair      ? pair_floats<PER, KT, 2>()" in backward
    assert p7_cuda.PAIR_X2_FLOATS == 16
    assert p7_cuda.blocked_smem_bytes(11, 3, 1, backward=True, pair=True) == (
        p7_cuda.blocked_smem_bytes(11, 3, 1, backward=True) + 4 * (2 * THREADS * 11 + 356 + 16))
    # the two-value exchange: a's then b's, 8 bytes a warp of both blocks
    assert "const unsigned off = 4 * (2 * q * X + pr.rank * warps<KT>() + (t >> 5));" in blocked
    assert "if (t == 0) mbar_expect(pr.xbar + 8 * q, 8 * X);" in blocked


def test_filter_plan_takes_bf16_emission_rows():
    """The filter's group holds its four emission rows as bf16: at 1400.hmm
    (11 slots) 704 floats each instead of 1,408, so its window's rows and
    four groups fit in 147,072 bytes where the eager case needs 231,552."""
    assert p7_cuda.bf16_stride(11) == 11 and p7_cuda.bf16_stride(12) == 14
    assert p7_cuda.bf16_stride(10) == 10 and p7_cuda.bf16_stride(16) == 18
    row, erow = THREADS * 11, THREADS * 11 // 2
    want = 4 * (10 * row + 4 * (2 * row + 4 * erow + 8 + 32))
    assert p7_cuda.blocked_smem_bytes(11, 10, 4, bf16=True) == want == 147072
    plan = p7_cuda.plan_launch("filter", 1400, 4, 4096, 128, SMS)
    assert (plan.groups, plan.n_chain, plan.n_trans, plan.smem) == (4, 4, 6, 147072)
    few = p7_cuda.plan_launch("filter", 1400, 4, 64, 128, SMS)
    assert (few.groups, few.grid) == (1, 64)


def test_shared_memory_matches_the_header_layout():
    """blocked_smem_bytes is csrc/p7_blocked.cuh::smem_floats * 4: the
    staged rows, then per group 2 shift rows, 4 emission rows (f32 or
    bf16), the reduction scratch (two floats a warp), the token chunk (int8)
    and, for the row-saving case, one more row."""
    source = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert ("2 * row_floats<PER, KT>() + 4 * erow_floats<PER, KT, BF16>() + red_floats<KT>() +\n"
            "         kChunk / 4 + (save ? row_floats<PER, KT>() : 0)") in source
    assert f"kMaxThreads = {p7_cuda.MAX_BLOCK_THREADS};" in source
    assert f"kMaxSmem = {SMEM_PER_SM};" in source
    assert "return 2 * warps<KT>();" in source
    row = 4 * THREADS * 11
    assert p7_cuda.blocked_smem_bytes(11, 12, 4) == 12 * row + 4 * (6 * row + 4 * 8 + 128)
    assert p7_cuda.blocked_smem_bytes(12, 1, 1, save=True) == 4 * THREADS * 13 * 8 + 4 * 8 + 128
    row = 4 * THREADS * 19
    assert p7_cuda.blocked_smem_bytes(19, 5, 1) == 5 * row + 6 * row + 4 * 8 + 128


@pytest.mark.parametrize("kind", p7_cuda.BLOCKED_KINDS)
def test_rows_in_memory_plan(kind):
    """Forward, the row-saving Forward, the backward pass and the Viterbi
    filter plan the rows-in-memory case past 38,912 where the card holds no
    cluster of their 256-thread blocks (``clusters`` 0;
    else test_wide_cluster_plan), the lazy kind past 32,768 and the eager
    and log-space kinds past MAX_BLOCK_STATES where the card holds no
    cluster of their wide blocks (``clusters`` 0; else they plan the cluster
    of wide blocks: test_block_cluster_plan): one
    group of 1024 threads a block, nothing staged, no dynamic shared memory,
    a persistent grid of at most two blocks an SM (fewer when the registers
    do not allow two) and no more blocks than sequences; a forced G > 1
    raises. The first width past the wide block, the 24-profile join (LENG
    30181) and the widest M_pad, 65536 (16 chain passes), are such cases for
    the eager and log-space kinds (the three-profile join, LENG 6977, takes
    the wide block: test_block_plan_fits_the_block); 38,920 and 65536 for
    the lazy, filter, Forward and backward kinds, which also plan it where
    the card holds no cluster (``clusters`` 0)."""
    assert p7_cuda.BLOCK_KINDS == tuple(k for k in p7_cuda.BLOCKED_KINDS
                                        if k not in p7_cuda.CLUSTER_KINDS)
    block = kind in p7_cuda.BLOCK_KINDS or kind == "lazy"  # clusters of wide blocks
    wide = kind in p7_cuda.WIDE_CLUSTER_KINDS
    widths = ((p7_cuda.MAX_BLOCK_STATES + 8, 30184, 65536) if kind in p7_cuda.BLOCK_KINDS
              else (38920, 65536))
    held = 0 if block or wide else None  # no cluster of wider blocks held
    for m_pad in widths:
        full = p7_cuda.chain_passes(m_pad)
        assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, -(-m_pad // 1024))
        assert p7_cuda.kernel_case(m_pad, kind) == (
            (p7_cuda.BLOCK_THREADS, -(-m_pad // (1024 * -(-m_pad // 8192)))) if block
            else (256, -(-m_pad // (256 * -(-m_pad // 4864)))) if wide
            else (p7_cuda.MEM_THREADS, -(-m_pad // 1024)))
        for regs, b_pad in itertools.product((32, 40, 64), (1, 8, 64, 300, 2048)):
            plan = p7_cuda.plan_launch(kind, m_pad, full, b_pad, regs, SMS, clusters=held)
            per_sm = 2 if regs <= 32 else 1
            assert plan == p7_cuda.LaunchPlan(1, min(b_pad, per_sm * SMS), 0, 0, 1,
                                              p7_cuda.MEM_THREADS, 0, 1, -(-m_pad // 1024))
            assert plan.mem and not plan.block_cluster and not plan.block
        with pytest.raises(ValueError, match="takes 1"):
            p7_cuda.plan_launch(kind, m_pad, full, 64, 40, SMS, groups=2, clusters=held)
    if kind in p7_cuda.CLUSTER_KINDS:
        plan = p7_cuda.plan_launch(kind, 6984, 5, 64, 40, SMS, clusters=0)
        assert (plan.threads, plan.cluster, plan.per, plan.grid) == (p7_cuda.MEM_THREADS, 1, 7, 64)
    assert p7_cuda.chain_passes(65536) == 16 and p7_cuda.chain_passes(30184) == 15


def test_backward_plan_and_shared_memory():
    """The backward case's group at 1400.hmm (11 slots, 128 threads): 6 f32
    rows, 2 bf16 rows of 704 floats, 12 reduction floats, the token chunk
    and the chunk's 256 log scales and coverage; with its W = 6 suffix rows
    and 6 transitions, 3 groups at 142 registers (the kernel's free choice)
    and 4 at 128 (its register bound at 9 to 12 slots). At 4864 states the
    cluster pair, 19 slots a thread, six transitions and the 7-pass window
    staged. Never over 232,448 bytes."""
    row = THREADS * 11
    group = 6 * row + 2 * (THREADS * 11 // 2) + 12 + 32 + 256
    assert p7_cuda.blocked_smem_bytes(11, 12, 3, backward=True) == 4 * (12 * row + 3 * group)
    plan = p7_cuda.plan_launch("backward", 1408, 6, 1024, 142, SMS)
    assert (plan.groups, plan.n_chain, plan.n_trans, plan.grid) == (3, 6, 6, SMS)
    assert plan.smem == 4 * (12 * row + 3 * group) <= SMEM_PER_SM
    assert p7_cuda.plan_launch("backward", 1408, 6, 1024, 128, SMS).groups == 4
    # the bounded cases launch at most 512 threads a block, whatever the
    # registers; below 9 slots the plan takes up to 8 groups
    assert p7_cuda.plan_launch("backward", 1408, 6, 4096, 64, SMS).max_groups == 4
    assert p7_cuda.plan_launch("backward", 104, 3, 4096, 64, SMS).max_groups == 8
    few = p7_cuda.plan_launch("backward", 1408, 6, 64, 142, SMS)
    assert (few.groups, few.grid) == (1, 64)
    wide = p7_cuda.plan_launch("backward", 4864, 7, 64, 206, SMS)
    wrow = THREADS * 19
    wgroup = 6 * wrow + 2 * (THREADS * 19 // 2) + 12 + 32 + 256
    assert (wide.threads, wide.cluster, wide.groups, wide.n_trans, wide.n_chain) == (
        THREADS, 2, 1, 6, 7)
    assert wide.smem == 4 * (13 * wrow + wgroup + 2 * wrow + 356 + 16) <= SMEM_PER_SM
    source = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert ("return 6 * row_floats<PER, KT>() + 2 * erow_floats<PER, KT, true>() + "
            "3 * warps<KT>() +\n         kChunk / 4 + 2 * kChunk;") in source
