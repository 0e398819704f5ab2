"""The C-block clusters of 128-thread blocks (the lazy, filter, Forward,
row-saving Forward and backward kinds past 4864 states: C blocks of 128
threads, C = 3..16; csrc/p7_blocked.cuh), checked on the CPU against the
models of tests/p7_layout_models.py.

* Its state map is a bijection, each block's slice in the normal-width
  layout, and its shifts (``cluster_shift_small``: halos from block r - 1;
  ``cluster_shift_big``: a block's states from the blocks q and q + 1 below
  it, q = s div (128 * per)) equal ``p7_cuda._shift`` for every pass of its
  chain and both fills; its plan takes C = ceil(M_pad / 2432) blocks, one
  group each.
* The mirrors toward lower j (the backward pass's ``cluster_shift_up``:
  halos and rows from block r + 1, the blocks q and q + 1 above) equal
  ``posterior_cuda._up`` for every per of CLUSTER_PER, every C of 3..16 and
  every pass of the chain, q >= 1 included; every receiving block is sent
  the bytes it waits for, and every release a sender waits for is sent.
* The release protocol (``cluster_shift_big`` and its mirror, every C of
  3..16, every window, both directions): each larger shift's releases come
  from exactly the blocks its sender stores into and complete the sender's
  halo mbarrier of that use; a per-row mbarrier would mix uses.
* The cases the C entries compile and the shared memory they take.
"""

import itertools
import re

import pytest
from p7_layout_models import (  # noqa: F401 (one_torch_thread: the module's fixture)
    BATCHES, REGS, SMS, THREADS, _check_releases, _check_shifts, _check_shifts_up, _passes,
    _row_mbarrier_mixes, one_torch_thread,
)

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM


@pytest.mark.parametrize("c,per", [(3, 13), (3, 16), (3, 19), (4, 15), (5, 17), (8, 18),
                                   (9, 16), (13, 19), (16, 19)])
def test_cluster_shifts_equal_the_plain_shift(c, per):
    """The C-block cluster's shifts, across the cluster included (halos,
    and the larger shifts' two source blocks, whole blocks away included),
    for every Hillis-Steele pass s = 2^p of c * 128 * per states and both
    fills."""
    _check_shifts(per, THREADS, cluster=c)


@pytest.mark.parametrize("c", range(3, p7_cuda.MAX_CLUSTER + 1))
def test_cluster_state_map_is_a_bijection(c):
    """State j of a C-block cluster sits in (block, thread, slot) with j =
    block * 128 * per + thread * per + slot: every state of the c * 128 *
    per once, each block's slice in the normal-width layout (the same map as
    the normal-width case's on the slice); past the cluster it raises."""
    for per in p7_cuda.CLUSTER_PER:
        n = THREADS * per
        seen = [p7_cuda.cluster_state(j, per, c) for j in range(c * n)]
        assert sorted(seen) == [(b, t, k) for b in range(c) for t in range(THREADS)
                                for k in range(per)]
        for j, (b, t, k) in enumerate(seen):
            assert b * n + t * per + k == j and divmod(j - b * n, per) == (t, k)
        with pytest.raises(ValueError):
            p7_cuda.cluster_state(c * n, per, c)


@pytest.mark.parametrize("c,per", [(c, per) for c in range(3, p7_cuda.MAX_CLUSTER + 1)
                                   for per in p7_cuda.CLUSTER_PER])
def test_cluster_mirror_shifts_equal_the_plain_up_shift(c, per):
    """The C-block cluster's shifts toward lower j (the backward pass past
    4864 states), across the cluster included (halos from block r + 1, a
    larger shift's two source blocks above, whole blocks away included),
    for every pass s = 2^p of c * 128 * per states, and the rows' releases
    of every window."""
    _check_shifts_up(per, c)


@pytest.mark.parametrize("c,mirror", [(c, m) for c in range(3, p7_cuda.MAX_CLUSTER + 1)
                                      for m in (False, True)])
def test_cluster_releases_land_on_their_use(c, mirror):
    """The release protocol of the C-block clusters of 128-thread blocks
    (cluster_shift_big, and the backward pass's mirror cluster_shift_up_big)
    at every per of CLUSTER_PER and every window of its chain: each larger
    shift's releases, sent once the barrier of the shift before has passed,
    come from exactly the blocks the sender stores into and complete the
    sender's halo mbarrier of that use (_check_releases). A per-row
    mbarrier would mix uses: at every per and the full chain some block
    releases a sender's use i + 2 but never its use i (q grows with s, so
    the blocks that store into a row change), so nothing orders its release
    after the sender's wait on use i and it may land in that use's phase;
    the model finds such a block at every C of 3..16, which from C = 4 on
    may be one that depends on no store of the sender's in the step."""
    mixed = {}
    for per in p7_cuda.CLUSTER_PER:
        full = p7_cuda.chain_passes(c * THREADS * per)
        for window in range(1, full + 1):
            sent = _check_releases(per, c, window, mirror)
            if window == full:
                mixed[per] = _row_mbarrier_mixes(sent, c)
    assert all(mixed.values())


def test_cluster_release_source_uses_an_mbarrier_a_use():
    """csrc/p7_blocked.cuh: cluster_shift_big and cluster_shift_up_big wait
    on the halo mbarrier of their own id (2 + p) before a larger shift i >=
    2 and send use i + 1's releases (a shift by 2s, id + 1) after use i's
    barrier, into the receivers' halo slots of that id; the C-block cluster
    keeps no release mbarrier of its rows."""
    blocked = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert blocked.count("if (i >= 2) cluster_release_wait(int(to_a) + int(to_b), id, t, c);") == 2
    assert "if (i >= 1 && i + 1 < n) cluster_release<PER, KT>(s << 1, id + 1, t, c);" in blocked
    assert "if (i >= 1 && i + 1 < n) cluster_release_up<PER, KT>(s << 1, id + 1, t, c);" in blocked
    assert blocked.count("st_async(peer_addr(c.halo + id * kHaloSlots + t, to), 0.0f, "
                         "peer_addr(c.bars + id, to));") == 2
    assert "mbar_wait(fbar, (c.hphase >> id) & 1u);" in blocked
    assert "c.fbar" not in blocked and "c.fslots" not in blocked and "c.fphase" not in blocked
    assert "cluster_shift_big<PER, KT>(v, out, s, fill, buf, t, bar, c, i, n, id);" in blocked


def test_cluster_cases_match_kernel_source():
    """The C-block cluster's cases the C entries compile are CLUSTER_PER
    (with_cluster_case, csrc/p7_blocked.cuh), instantiated by the lazy
    Viterbi's, the filter's, the Forward template's and the backward pass's
    sources (the kinds of CLUSTER_KINDS) and launched as clusters of C
    blocks, past 8 with the non-portable size allowed; a block's area (two
    rows, two exchanges of a value a warp of up to 16 blocks, XV of them for
    the backward pass's, the pair's 18 halos of 16 slots, 4 release slots
    and 24 mbarriers) is what the plan counts after its group; an exchange
    puts each warp's value at slot rank * 4 + warp of every block, lane p
    into block p, and combines each block's four as the group does, the
    blocks in rank order; C is read from %cluster_nctarank."""
    csrc = p7_cuda._build.CSRC_DIR
    blocked = (csrc / "p7_blocked.cuh").read_text()
    cases = re.findall(r"P7_CLUSTER_CASE\((\d+)\)\n", blocked)
    assert tuple(int(c) for c in cases) == p7_cuda.CLUSTER_PER
    assert f"constexpr int kMaxCluster = {p7_cuda.MAX_CLUSTER};" in blocked
    assert ("return 2 * row_floats<PER, KT>() + XV * 2 * kMaxCluster * warps<KT>() +\n"
            "         kHaloIds * kHaloSlots + 4 + 2 * kPairBars;") in blocked
    assert p7_cuda.CLUSTER_FLOATS == 2 * 16 * 4 + 18 * 16 + 4 + 48 == 468
    assert ("return smem_floats<PER, KT, BF16>(n_rows, 1, save) + cluster_floats<PER, KT>();"
            in blocked)
    assert "const unsigned off = 4 * (q * X + c.rank * warps<KT>() + (t >> 5));" in blocked
    assert "if ((t & 31) < c.nblk) {" in blocked
    assert "const int q = s / N;" in blocked and "const int rest = s - q * N;" in blocked
    assert "attr->val.clusterDim.x = c;" in blocked
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed, 1" in blocked
    assert p7_cuda.chain_passes(p7_cuda.MAX_CLUSTER_STATES) + 2 <= 18  # a halo id a pass
    kinds = {"p7_viterbi_kernel.cu": "viterbi_cluster_kernel<PER, true, false, false>",
             "p7_viterbi_filter_kernel.cu": "viterbi_cluster_kernel<PER, false, false, true>",
             "p7_forward_kernel.cu": "forward_cluster_kernel<PER, true>",
             "p7_backward_kernel.cu": "backward_cluster_kernel<PER>"}
    for name, kernel in kinds.items():
        source = (csrc / name).read_text()
        assert "with_cluster_case<ClusterCase>(per" in source and kernel in source, name
    assert "with_cluster_case" not in (csrc / "p7_forward_log_kernel.cu").read_text()
    template = (csrc / "p7_viterbi.cuh").read_text()
    assert "viterbi_body<PER, 128, LAZY, LSE, FILT, Span::kCluster>(a);" in template
    assert "h.nblk = static_cast<int>(cluster_size());" in template
    forward = (csrc / "p7_forward_kernel.cu").read_text()
    assert "forward_body<PER, 128, SAVE, Span::kCluster>(a);" in forward
    assert "4 * cluster_smem_floats<PER, 128, false>(n_rows, save)" in forward
    assert "nblk = static_cast<int>(cluster_size());" in forward
    assert p7_cuda.blocked_smem_bytes(19, 12, 1, cluster=True) == (
        p7_cuda.blocked_smem_bytes(19, 12, 1) + 4 * (2 * THREADS * 19 + 468))
    backward = (csrc / "p7_backward_kernel.cu").read_text()
    assert "backward_body<PER, 128, Span::kCluster>(a);" in backward
    assert "cluster_setup<PER, KT, 2>(h, area, t);" in backward
    assert "4 * backward_smem_floats<PER, 128, Span::kCluster>(n_rows, 1)" in backward
    assert "h.nblk = static_cast<int>(cluster_size());" in backward
    assert p7_cuda.CLUSTER_X2_FLOATS == 2 * 16 * 4
    assert p7_cuda.blocked_smem_bytes(19, 12, 1, backward=True, cluster=True) == (
        p7_cuda.blocked_smem_bytes(19, 12, 1, backward=True) + 4 * (2 * THREADS * 19 + 468 + 128))
    # the mirror's larger shift: block b's states from s' on into block b -
    # q's row at l - s', the others into block b - q - 1's at l + N - s'
    assert "st_async(row_a + 4 * sidx<PER>(j - rest), v[k], bar_a);" in blocked
    assert "st_async(row_b + 4 * sidx<PER>(j + N - rest), v[k], bar_b);" in blocked
    assert "if (t == 0) mbar_expect(c.xbar + 8 * q, 8 * c.nblk * warps<KT>());" in blocked


@pytest.mark.parametrize("kind", p7_cuda.BLOCKED_KINDS)
def test_cluster_plan_fits_the_block(kind):
    """Past 4864 states, up to 38,912, the lazy, filter, Forward,
    row-saving Forward and backward kinds plan a C-block cluster, C =
    ceil(M_pad / 2432) (3 at 4872 and 6984, 13 at 30184, 16 at 38,912), per
    the smallest that covers M_pad: 128 threads and one group a block (a
    forced G other than 1 raises), a grid of whole clusters (the
    ``clusters`` the card holds, else what an SM's registers, shared memory
    and threads allow, C SMs a cluster; no more than the batch's sequences),
    every transition row staged and as many chain rows as fit the 232,448
    bytes of a block beside its group and the cluster's area (two rows and
    468 floats, whatever C; 128 more for the backward pass's two-value
    exchanges), every window up to 8 passes staged whole; the eager and
    log-space kinds take no 128-thread cluster: the wide block up to
    MAX_BLOCK_STATES (4872 and 6984), a cluster of ceil(M_pad / 8192) wide
    blocks past it (30184: 4, 38912: 5), as the lazy kind does past 32,768
    (38912: 5)."""
    for m_pad, c in ((4872, 3), (6984, 3), (30184, 13), (38912, 16)):
        block = m_pad <= p7_cuda.MAX_BLOCK_STATES
        wide_c = 1 if block else -(-m_pad // 8192)
        wide = kind not in p7_cuda.CLUSTER_KINDS or (
            kind == "lazy" and m_pad > p7_cuda.LAZY_BLOCK_STATES)
        assert p7_cuda.cluster_blocks(m_pad, kind) == (wide_c if wide else c)
        assert c == -(-m_pad // 2432)
        full = p7_cuda.chain_passes(m_pad)
        if wide:
            plan = p7_cuda.plan_launch(kind, m_pad, full, 64, 40, SMS)
            assert (plan.threads, plan.cluster, plan.block, plan.mem, plan.block_cluster) == (
                p7_cuda.BLOCK_THREADS, p7_cuda.BLOCK_CLUSTER if block else wide_c, block,
                False, not block)
            continue
        per = -(-m_pad // (THREADS * c))
        assert per in p7_cuda.CLUSTER_PER and p7_cuda.kernel_case(m_pad, kind) == (THREADS, per)
        for passes, regs, b_pad in itertools.product(_passes(kind, m_pad), REGS, BATCHES):
            plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
            assert (plan.threads, plan.cluster, plan.groups, plan.max_groups, plan.per) == (
                THREADS, c, 1, 1, per)
            assert plan.grid % c == 0 and 1 <= plan.grid // c <= b_pad
            extra = 1 if kind == "lazy" and passes < full else 0
            rows = plan.n_trans + plan.n_chain + extra
            bf16, save, bwd = kind == "filter", kind == "save", kind == "backward"
            assert plan.n_trans == 6 and 0 <= plan.n_chain <= passes
            assert plan.smem == p7_cuda.blocked_smem_bytes(
                per, rows, 1, save, bf16=bf16, backward=bwd, cluster=True) <= SMEM_PER_SM
            assert plan.smem == p7_cuda.blocked_smem_bytes(
                per, rows, 1, save, bf16=bf16, backward=bwd) + 4 * (
                2 * THREADS * p7_cuda.blocked_stride(per) + 468 + (128 if bwd else 0))
            if plan.n_chain < passes:
                assert p7_cuda.blocked_smem_bytes(per, rows + 1, 1, save, bf16=bf16,
                                                  backward=bwd, cluster=True) > SMEM_PER_SM
            assert plan.n_chain == passes or passes > 8
            warp_regs = -(-regs // 8) * 8 * 32
            per_sm = min(p7_cuda.REGS_PER_SM // (4 * warp_regs), SMEM_PER_SM // plan.smem,
                         p7_cuda.THREADS_PER_SM // THREADS)
            assert plan.grid // c == min(b_pad, max(1, SMS * per_sm // c))
        assert p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS, clusters=7).grid == 7 * c
        assert p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS, groups=1).groups == 1
        with pytest.raises(ValueError, match=f"{c}-block cluster takes 1"):
            p7_cuda.plan_launch(kind, m_pad, passes, 4096, 128, SMS, groups=2)
