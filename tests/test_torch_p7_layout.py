"""The blocked layout and launch plan of the redesigned p7 kernels
(csrc/p7_blocked.cuh, csrc/p7_viterbi.cuh, csrc/p7_forward_kernel.cu),
checked on the CPU: the kernels themselves run only on the card.

* The shared-row index the kernels use (thread t's slot k of state
  j = t * per + k at t * stride + k, stride = per rounded up to odd) is a
  bijection whose 32 neighbouring threads hit 32 banks.
* The shifts as the kernels do them (``shift_small``: register moves plus
  the previous thread's last s slots; ``shift_big``: the row read at
  j - s) equal ``p7_cuda._shift`` for every per 1..19 and s = 2^p.
* The same at the wide case's 256 threads a group (per 10..19, M_pad up to
  4864), and the Viterbi filter's bf16 emission rows (``hstride``).
* ``plan_launch`` keeps every case within the block's shared memory and the
  SM's registers, picks G = 1 up to one sequence an SM, leaves chain rows
  and then (at 256 threads) transition rows in global memory when a group
  would not fit, runs the rows-in-memory case (1024 threads, one sequence
  a block, nothing staged) past M_pad 4864 and raises past 65536.
* The backward coverage pass's suffix shifts (``shift_up_small``,
  ``shift_up_big``) equal ``posterior_cuda._up``, and its group layout
  (``backward_group_floats``) is what ``blocked_smem_bytes`` counts.
"""

import itertools

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda, posterior_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM

PERS = p7_cuda.KERNEL_PER
THREADS = p7_cuda.KERNEL_THREADS
WIDE = p7_cuda.WIDE_THREADS
# every kernel case: (threads, per)
CASES = [(THREADS, per) for per in PERS] + [(WIDE, per) for per in p7_cuda.WIDE_PER]
SMS = 132  # the H100 SXM's multiprocessors
REGS = (32, 64, 96, 118, 128, 155, 188, 255)
BATCHES = (1, 33, 64, 132, 133, 1024, 4096, 16384)


def _sidx(j: int, per: int) -> int:
    """csrc/p7_blocked.cuh::sidx."""
    return j if per % 2 else j + j // per


def _blocked(x: torch.Tensor, per: int, threads: int) -> torch.Tensor:
    """A [B, threads * per] row as the kernels hold it: [B, thread, slot]."""
    return x.reshape(x.shape[0], threads, per)


def _kernel_shift(x: torch.Tensor, s: int, per: int, fill: float,
                  threads: int = THREADS) -> torch.Tensor:
    """csrc/p7_blocked.cuh::shift on a [B, threads * per] row: for s < per
    (the shifts by 1, 2, 4, 8, 16 below per) slots k >= s move within the
    thread and the first s come from the previous thread's last s slots
    (fill in thread 0); otherwise the row goes through shared memory at
    sidx and each slot reads state t * per + k - s."""
    v = _blocked(x, per, threads)
    out = torch.empty_like(v)
    if s < per and s in (1, 2, 4, 8, 16):
        out[:, :, s:] = v[:, :, : per - s]
        prev = torch.full_like(v[:, :, :s], fill)
        prev[:, 1:] = v[:, :-1, per - s:]
        out[:, :, :s] = prev
    else:
        stride = p7_cuda.blocked_stride(per)
        buf = torch.full((x.shape[0], threads * stride), fill, dtype=x.dtype)
        t, k = np.meshgrid(np.arange(threads), np.arange(per), indexing="ij")
        buf[:, torch.from_numpy(t * stride + k).reshape(-1)] = v.reshape(x.shape[0], -1)
        j = (t * per + k - s).reshape(-1)
        src = torch.from_numpy(np.array([_sidx(max(int(i), 0), per) for i in j]))
        got = buf[:, src]
        got[:, torch.from_numpy(j < 0)] = fill
        out = got.reshape(v.shape)
    return out.reshape(x.shape)


def _check_row_index(per: int, threads: int) -> None:
    stride = p7_cuda.blocked_stride(per)
    assert stride % 2 == 1 and per <= stride <= per + 1
    idx = [_sidx(j, per) for j in range(threads * per)]
    want = [t * stride + k for t in range(threads) for k in range(per)]
    assert idx == want and len(set(idx)) == len(idx)
    assert max(idx) < threads * stride
    for k in range(per):  # a warp reading its slot k, and writing it
        for w in range(threads // 32):
            banks = {(t * stride + k) % 32 for t in range(32 * w, 32 * w + 32)}
            assert len(banks) == 32


@pytest.mark.parametrize("per", PERS)
def test_shared_row_index_is_a_conflict_free_bijection(per):
    _check_row_index(per, THREADS)


@pytest.mark.parametrize("per", p7_cuda.WIDE_PER)
def test_wide_shared_row_index_is_a_conflict_free_bijection(per):
    _check_row_index(per, WIDE)


def _check_shifts(per: int, threads: int) -> None:
    rng = np.random.default_rng(per)
    m = threads * per
    x = torch.from_numpy(rng.normal(size=(2, m)).astype(np.float32))
    for p in range(p7_cuda.chain_passes(m) + 1):
        s = 1 << p
        for fill in (p7_cuda.NEG_INF, 0.0):
            got = _kernel_shift(x, s, per, fill, threads)
            assert torch.equal(got, p7_cuda._shift(x, s, fill)), (s, fill)


def _kernel_shift_up(x: torch.Tensor, s: int, per: int, threads: int) -> torch.Tensor:
    """csrc/p7_blocked.cuh::shift_up on a [B, threads * per] row, fill 0:
    for s < per (by 1, 2, 4, 8, 16) slots k < per - s move within the
    thread and the last s come from the next thread's first s slots (0 in
    the last thread); otherwise each slot reads state t * per + k + s of the
    row through shared memory at sidx."""
    v = _blocked(x, per, threads)
    if s < per and s in (1, 2, 4, 8, 16):
        out = torch.zeros_like(v)
        out[:, :, : per - s] = v[:, :, s:]
        out[:, :-1, per - s:] = v[:, 1:, :s]
        return out.reshape(x.shape)
    stride = p7_cuda.blocked_stride(per)
    buf = torch.zeros((x.shape[0], threads * stride), dtype=x.dtype)
    t, k = np.meshgrid(np.arange(threads), np.arange(per), indexing="ij")
    buf[:, torch.from_numpy(t * stride + k).reshape(-1)] = v.reshape(x.shape[0], -1)
    j = (t * per + k + s).reshape(-1)
    n = threads * per
    got = buf[:, torch.from_numpy(np.array([_sidx(int(i) if i < n else 0, per) for i in j]))]
    got[:, torch.from_numpy(j >= n)] = 0.0
    return got.reshape(x.shape)


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


@pytest.mark.parametrize("per", p7_cuda.WIDE_PER)
def test_wide_kernel_shifts_equal_the_plain_shift(per):
    _check_shifts(per, WIDE)


def _hidx(j: int, per: int) -> int:
    """csrc/p7_blocked.cuh::hidx: halfword of state j in a bf16 row."""
    return (j // per) * p7_cuda.bf16_stride(per) + j % per


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


def _passes(kind: str, m_pad: int):
    """The pass counts a case can run at ``m_pad``: every window for the
    lazy, Forward and filter cases, the full chain for the eager and
    log-space ones."""
    full = p7_cuda.chain_passes(m_pad)
    windowed = ("lazy", "forward", "save", "filter", "backward")
    return range(1, full + 1) if kind in windowed else (full,)


@pytest.mark.parametrize("kind", p7_cuda.BLOCKED_KINDS)
def test_plan_fits_the_block_for_every_case(kind):
    """Every (threads, per) case, at its narrowest and widest M_pad."""
    for threads, per in CASES:
        low = THREADS * 19 + 8 if threads == WIDE else 8
        for m_pad in sorted({max(low, threads * (per - 1) + 8), threads * per}):
            assert p7_cuda.kernel_case(m_pad) == (threads, per)
            for passes, regs, b_pad in itertools.product(_passes(kind, m_pad), REGS, BATCHES):
                plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
                assert plan.smem <= SMEM_PER_SM == 232448
                assert plan.threads == threads
                assert 0 <= plan.n_chain <= passes
                assert 0 <= plan.n_trans <= 6 and (plan.n_trans == 6 or threads == WIDE)
                assert 1 <= plan.groups <= plan.max_groups <= p7_cuda.MAX_BLOCK_THREADS // threads
                warp_regs = -(-regs // 8) * 8 * 32
                assert plan.groups * (threads // 32) * warp_regs <= p7_cuda.REGS_PER_SM
                assert 1 <= plan.grid <= -(-b_pad // plan.groups)
                if b_pad <= SMS:
                    assert plan.groups == 1 and plan.grid == b_pad
                extra = 1 if kind == "lazy" and passes < p7_cuda.chain_passes(m_pad) else 0
                args = (kind == "save", threads, kind == "filter", kind == "backward")
                rows = plan.n_trans + plan.n_chain + extra
                assert plan.smem == p7_cuda.blocked_smem_bytes(per, rows, plan.groups, *args)
                # nothing more would fit: every row staged, or one more row
                # would not leave room for one group; chain rows go first
                if plan.n_chain < passes or plan.n_trans < 6:
                    assert p7_cuda.blocked_smem_bytes(per, rows + 1, 1, *args) > SMEM_PER_SM
                if plan.n_trans < 6:
                    assert plan.n_chain == 0


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


def test_wide_plan_leaves_transition_rows_in_global_memory():
    """At 256 threads and 19 slots a row is 19,456 bytes: one group's six
    rows and six staged transitions come to 233,472 bytes, 1,024 over the
    block's 232,448, so the eager plan stages five transitions and no chain
    row; at 10 slots every row the lazy window runs fits."""
    row = 4 * WIDE * 19
    assert row == 19456
    assert 12 * row == SMEM_PER_SM + 1024
    plan = p7_cuda.plan_launch("eager", 4864, 13, 4096, 128, SMS)
    assert (plan.threads, plan.n_trans, plan.n_chain, plan.groups) == (WIDE, 5, 0, 1)
    plan = p7_cuda.plan_launch("lazy", 2440, 4, 4096, 128, SMS)
    assert (plan.threads, plan.n_trans, plan.n_chain) == (WIDE, 6, 4)


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
    wide = 4 * WIDE * 19
    assert (p7_cuda.blocked_smem_bytes(19, 5, 1, threads=WIDE)
            == 5 * wide + 6 * wide + 4 * 16 + 128)


@pytest.mark.parametrize("kind", p7_cuda.BLOCKED_KINDS)
def test_rows_in_memory_plan(kind):
    """Past M_pad 4864 every kind plans the rows-in-memory case: one group
    of 1024 threads a block, nothing staged, no dynamic shared memory, a
    persistent grid of at most two blocks an SM (fewer when the registers
    do not allow two) and no more blocks than sequences; a forced G > 1
    raises. The three-profile and the 24-profile joins (LENG 6977, 30181)
    and the widest M_pad, 65536 (16 chain passes), are such cases."""
    for m_pad in (4872, 6984, 30184, 65536):
        full = p7_cuda.chain_passes(m_pad)
        assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, -(-m_pad // 1024))
        for regs, b_pad in itertools.product((32, 40, 64), (1, 8, 64, 300, 2048)):
            plan = p7_cuda.plan_launch(kind, m_pad, full, b_pad, regs, SMS)
            per_sm = 2 if regs <= 32 else 1
            assert plan == p7_cuda.LaunchPlan(1, min(b_pad, per_sm * SMS), 0, 0, 1,
                                              p7_cuda.MEM_THREADS, 0)
        with pytest.raises(ValueError, match="takes 1"):
            p7_cuda.plan_launch(kind, m_pad, full, 64, 40, SMS, groups=2)
    assert p7_cuda.chain_passes(65536) == 16 and p7_cuda.chain_passes(30184) == 15


def test_backward_plan_and_shared_memory():
    """The backward case's group at 1400.hmm (11 slots, 128 threads): 6 f32
    rows, 2 bf16 rows of 704 floats, 12 reduction floats, the token chunk
    and the chunk's 256 log scales and coverage; with its W = 6 suffix rows
    and 6 transitions, 3 groups at 142 registers (the kernel's free choice)
    and 4 at 128 (its register bound at 9 to 12 slots). At 256 threads and 19
    slots one group and 4 staged transition rows, no chain row. Never over
    232,448 bytes."""
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
    wrow = WIDE * 19
    wgroup = 6 * wrow + 2 * (WIDE * 19 // 2) + 24 + 32 + 256
    assert (wide.threads, wide.groups, wide.n_trans, wide.n_chain) == (WIDE, 1, 4, 0)
    assert wide.smem == 4 * (4 * wrow + wgroup) <= SMEM_PER_SM < 4 * (5 * wrow + wgroup)
    source = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert ("return 6 * row_floats<PER, KT>() + 2 * erow_floats<PER, KT, true>() + "
            "3 * warps<KT>() +\n         kChunk / 4 + 2 * kChunk;") in source
