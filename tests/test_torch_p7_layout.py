"""The blocked layout and launch plan of the redesigned p7 kernels
(csrc/p7_blocked.cuh, csrc/p7_viterbi.cuh, csrc/p7_forward_kernel.cu),
checked on the CPU: the kernels themselves run only on the card.

* The shared-row index the kernels use (thread t's slot k of state
  j = t * per + k at t * stride + k, stride = per rounded up to odd) is a
  bijection whose 32 neighbouring threads hit 32 banks.
* The shifts as the kernels do them (``shift_small``: register moves plus
  the previous thread's last s slots; ``shift_big``: the row read at
  j - s) equal ``p7_cuda._shift`` for every per 1..19 and s = 2^p.
* ``plan_launch`` keeps every case within the block's shared memory and the
  SM's registers, picks G = 1 up to one sequence an SM, and raises past
  M_pad 2432.
"""

import itertools

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM

PERS = p7_cuda.KERNEL_PER
THREADS = p7_cuda.KERNEL_THREADS
SMS = 132  # the H100 SXM's multiprocessors
REGS = (32, 64, 96, 118, 128, 155, 188, 255)
BATCHES = (1, 33, 64, 132, 133, 1024, 4096, 16384)


def _sidx(j: int, per: int) -> int:
    """csrc/p7_blocked.cuh::sidx."""
    return j if per % 2 else j + j // per


def _blocked(x: torch.Tensor, per: int) -> torch.Tensor:
    """A [B, 128 * per] row as the kernels hold it: [B, thread, slot]."""
    return x.reshape(x.shape[0], THREADS, per)


def _kernel_shift(x: torch.Tensor, s: int, per: int, fill: float) -> torch.Tensor:
    """csrc/p7_blocked.cuh::shift on a [B, 128 * per] row: for s < per
    (the shifts by 1, 2, 4, 8, 16 below per) slots k >= s move within the
    thread and the first s come from the previous thread's last s slots
    (fill in thread 0); otherwise the row goes through shared memory at
    sidx and each slot reads state t * per + k - s."""
    v = _blocked(x, per)
    out = torch.empty_like(v)
    if s < per and s in (1, 2, 4, 8, 16):
        out[:, :, s:] = v[:, :, : per - s]
        prev = torch.full_like(v[:, :, :s], fill)
        prev[:, 1:] = v[:, :-1, per - s:]
        out[:, :, :s] = prev
    else:
        stride = p7_cuda.blocked_stride(per)
        buf = torch.full((x.shape[0], THREADS * stride), fill, dtype=x.dtype)
        for t, k in itertools.product(range(THREADS), range(per)):
            buf[:, t * stride + k] = v[:, t, k]
        for t, k in itertools.product(range(THREADS), range(per)):
            j = t * per + k - s
            out[:, t, k] = buf[:, _sidx(j, per)] if j >= 0 else fill
    return out.reshape(x.shape)


@pytest.mark.parametrize("per", PERS)
def test_shared_row_index_is_a_conflict_free_bijection(per):
    stride = p7_cuda.blocked_stride(per)
    assert stride % 2 == 1 and per <= stride <= per + 1
    idx = [_sidx(j, per) for j in range(THREADS * per)]
    want = [t * stride + k for t in range(THREADS) for k in range(per)]
    assert idx == want and len(set(idx)) == len(idx)
    assert max(idx) < THREADS * stride
    for k in range(per):  # a warp reading its slot k, and writing it
        for w in range(THREADS // 32):
            banks = {(t * stride + k) % 32 for t in range(32 * w, 32 * w + 32)}
            assert len(banks) == 32


@pytest.mark.parametrize("per", PERS)
def test_kernel_shifts_equal_the_plain_shift(per):
    rng = np.random.default_rng(per)
    m = THREADS * per
    x = torch.from_numpy(rng.normal(size=(2, m)).astype(np.float32))
    for p in range(p7_cuda.chain_passes(m) + 1):
        s = 1 << p
        for fill in (p7_cuda.NEG_INF, 0.0):
            assert torch.equal(_kernel_shift(x, s, per, fill), p7_cuda._shift(x, s, fill)), (s, fill)


def _passes(kind: str, m_pad: int):
    """The pass counts a case can run at ``m_pad``: every window for the
    lazy and Forward cases, the full chain for the eager and log-space
    ones."""
    full = p7_cuda.chain_passes(m_pad)
    return range(1, full + 1) if kind in ("lazy", "forward", "save") else (full,)


@pytest.mark.parametrize("kind", p7_cuda.BLOCKED_KINDS)
def test_plan_fits_the_block_for_every_case(kind):
    for per in PERS:
        for m_pad in sorted({max(8, THREADS * (per - 1) + 8), THREADS * per}):
            for passes, regs, b_pad in itertools.product(_passes(kind, m_pad), REGS, BATCHES):
                plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
                assert plan.smem <= SMEM_PER_SM == 232448
                assert 0 <= plan.n_chain <= passes
                assert 1 <= plan.groups <= plan.max_groups <= p7_cuda.MAX_GROUPS
                warp_regs = -(-regs // 8) * 8 * 32
                assert plan.groups * (THREADS // 32) * warp_regs <= p7_cuda.REGS_PER_SM
                assert 1 <= plan.grid <= -(-b_pad // plan.groups)
                if b_pad <= SMS:
                    assert plan.groups == 1 and plan.grid == b_pad
                extra = 1 if kind == "lazy" and passes < p7_cuda.chain_passes(m_pad) else 0
                assert plan.smem == p7_cuda.blocked_smem_bytes(
                    per, 6 + plan.n_chain + extra, plan.groups, kind == "save")
                # nothing more would fit: every row staged, or one more row
                # would not leave room for one group
                if plan.n_chain < passes:
                    assert p7_cuda.blocked_smem_bytes(
                        per, 7 + plan.n_chain + extra, 1, kind == "save") > SMEM_PER_SM


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
    with pytest.raises(ValueError, match="2432"):
        p7_cuda.plan_launch("eager", p7_cuda.MAX_KERNEL_STATES + 8, 12, 64, 128, SMS)
    with pytest.raises(ValueError, match="chain passes"):
        p7_cuda.plan_launch("forward", 1400, 12, 64, 128, SMS)
    with pytest.raises(ValueError, match="case"):
        p7_cuda.plan_launch("filter", 1400, 4, 64, 128, SMS)


def test_shared_memory_matches_the_header_layout():
    """blocked_smem_bytes is csrc/p7_blocked.cuh::smem_floats * 4: the
    staged rows, then per group 6 rows, the reduction scratch, the token
    chunk (int8) and, for the row-saving case, one more row."""
    source = (p7_cuda._build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert "(6 * row_floats<PER>() + kRed + kChunk / 4 + (save ? row_floats<PER>() : 0))" in source
    assert f"kMaxGroups = {p7_cuda.MAX_GROUPS};" in source
    assert f"kMaxSmem = {SMEM_PER_SM};" in source
    row = 4 * THREADS * 11
    assert p7_cuda.blocked_smem_bytes(11, 12, 4) == 12 * row + 4 * (6 * row + 4 * 8 + 128)
    assert p7_cuda.blocked_smem_bytes(12, 1, 1, save=True) == 4 * THREADS * 13 * 8 + 4 * 8 + 128
