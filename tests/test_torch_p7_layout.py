"""The blocked layout and launch plan of the redesigned p7 kernels
(csrc/p7_blocked.cuh, csrc/p7_viterbi.cuh, csrc/p7_forward_kernel.cu),
checked on the CPU: the kernels themselves run only on the card.

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
  states read from block 0's shift buffer) equal ``p7_cuda._shift`` for
  every per 10..19 and s = 2^p, and its plan stages every row that fits in
  a block, one group a block, an even grid.
* The C-block cluster (the lazy, filter, Forward and backward kinds past
  4864 states: C blocks of 128 threads, C = 3..16): its state map is a
  bijection, each block's slice in the normal-width layout, and its shifts
  (``cluster_shift_small``: halos from block r - 1; ``cluster_shift_big``:
  a block's states from the blocks q and q + 1 below it, q = s div (128 *
  per)) equal ``p7_cuda._shift`` for every pass of its chain and both
  fills; its plan takes C = ceil(M_pad / 2432) blocks, one group each.
* The mirrors toward lower j (the backward pass's, ``pair_shift_up``,
  ``cluster_shift_up``: halos and rows from block r + 1, the blocks q and q
  + 1 above) equal ``posterior_cuda._up`` for every per of the pair
  (10..19) and the C-block cluster (13..19), every C of 2..16 and every
  pass of the chain, q >= 1 included; every receiving block is sent the
  bytes it waits for, and every release a sender waits for is sent.
* The wide block (the eager and log-space kinds past 4864 states, up to
  MAX_BLOCK_STATES: one block of BLOCK_THREADS threads in the normal-width
  layout): its state map is a bijection, its shared-row index conflict
  free, its shifts equal ``p7_cuda._shift`` for every per of BLOCK_PER, its
  thread-major rows (``block_rows``) put row q's state t * per + k at (q, k,
  t), and its plan stages the transitions first, then chain rows, as many
  as fit beside its group, one group a block, a grid of at most one block
  an SM.
* ``plan_launch`` keeps every case within the block's shared memory and the
  SM's registers, picks G = 1 up to one sequence an SM, leaves chain rows
  in global memory when a group would not fit, runs the rows-in-memory case
  (1024 threads, one sequence a block, nothing staged) past
  MAX_BLOCK_STATES for the eager and log-space kinds and past 38,912 for
  every kind, and raises past 65536.
* The backward coverage pass's suffix shifts (``shift_up_small``,
  ``shift_up_big``) equal ``posterior_cuda._up``, and its group layout
  (``backward_group_floats``) is what ``blocked_smem_bytes`` counts.
* The C-block clusters' release protocol (``cluster_shift_big`` and its
  mirror, every C of 3..16, every window, both directions; the 256-thread
  clusters too): each larger shift's releases come from exactly the blocks
  its sender stores into and complete the sender's halo mbarrier of that
  use; a per-row mbarrier would mix uses; the pair's two blocks cannot.
* The C-block cluster of 256-thread blocks (the row-saving Forward and the
  backward pass past 38,912 states: C = 9..14, per 17..19): its cases, plan,
  state map, shifts both ways, thread-major rows, shared memory and source.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda, posterior_cuda
from hmm_fasta_viterbi_tpu_torch.ops.msv_cuda import SMEM_PER_SM

PERS = p7_cuda.KERNEL_PER
THREADS = p7_cuda.KERNEL_THREADS
# every group case: (threads, per)
CASES = [(THREADS, per) for per in PERS]
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


def _kernel_pair_shift(x: torch.Tensor, s: int, per: int, fill: float) -> torch.Tensor:
    """csrc/p7_blocked.cuh::pair_shift on a [B, 2 * 128 * per] row, block r
    holding the half r * 128 * per ..: each block writes its half into its
    shift buffer at t * stride + k (a small shift only its last s slots);
    for s < per (by 1, 2, 4, 8, 16) slots k >= s move within the thread and
    the first s come from thread t - 1's last s, in block 1's thread 0 from
    the halo block 0's thread 127 stores its last s registers into (fill in
    block 0's thread 0); otherwise slot k reads state t * per + k - s of its
    own buffer at sidx, below 0 in block 1 state j + 128 * per of block 0's
    buffer, else fill."""
    n = THREADS * per
    stride = p7_cuda.blocked_stride(per)
    small = s < per and s in (1, 2, 4, 8, 16)
    v = [_blocked(x[:, r * n:(r + 1) * n], per, THREADS) for r in (0, 1)]
    bufs = []
    for r in (0, 1):
        buf = torch.full((x.shape[0], THREADS * stride), float("nan"), dtype=x.dtype)
        for t in range(THREADS):
            for k in range(per - s if small else 0, per):
                buf[:, t * stride + k] = v[r][:, t, k]
        bufs.append(buf)
    out = []
    for r in (0, 1):
        o = torch.empty_like(v[r])
        for t in range(THREADS):
            for k in range(per):
                if small and k >= s:
                    o[:, t, k] = v[r][:, t, k - s]
                elif small and t > 0:
                    o[:, t, k] = bufs[r][:, (t - 1) * stride + per - s + k]
                elif small:
                    halo = v[0][:, THREADS - 1, per - s:]
                    o[:, t, k] = halo[:, k] if r else fill
                else:
                    j = t * per + k - s
                    if j >= 0:
                        o[:, t, k] = bufs[r][:, _sidx(j, per)]
                    elif r == 1 and j + n >= 0:
                        o[:, t, k] = bufs[0][:, _sidx(j + n, per)]
                    else:
                        o[:, t, k] = fill
        out.append(o.reshape(x.shape[0], n))
    return torch.cat(out, dim=1)


def _kernel_cluster_shift(x: torch.Tensor, s: int, per: int, fill: float,
                          c: int, threads: int = THREADS) -> torch.Tensor:
    """csrc/p7_blocked.cuh::cluster_shift on a [B, c * threads * per] row
    (threads 128; a cluster of wide blocks' BLOCK_THREADS, whose
    p7_viterbi.cuh::wide_cluster_small and wide_cluster_big take the same
    values in place), block r holding the slice r * threads * per ..: for s
    < per (by 1, 2, 4, 8, 16) slots k >= s move within the thread and the
    first s come from thread t - 1's last s through the block's shift
    buffer, in block r's thread 0 from the halo block r - 1's last thread
    stores its last s registers into (fill in block 0). Otherwise, with q =
    s div (threads * per) and s' its rest, block b stores its states l <
    threads * per - s' into block b + q's row at l + s' (for q = 0 they stay
    in its own shift buffer, read at l - s'), and the others into block b +
    q + 1's row at l + s' - threads * per; each receiving block reads its
    row (or buffer), fill where no block sent."""
    n = threads * per
    width = threads * p7_cuda.blocked_stride(per)
    v = [x[:, r * n:(r + 1) * n] for r in range(c)]  # a block's states, l = t * per + k
    out = []
    if s < per and s in (1, 2, 4, 8, 16):
        for r in range(c):
            o = _blocked(v[r], per, threads).clone()
            o[:, :, s:] = _blocked(v[r], per, threads)[:, :, : per - s]
            # thread t - 1's last s slots through the buffer, thread 0's from
            # the halo of block r - 1's last thread
            o[:, 1:, :s] = _blocked(v[r], per, threads)[:, :-1, per - s:]
            o[:, 0, :s] = v[r - 1][:, n - s:] if r else fill
            out.append(o.reshape(x.shape[0], n))
        return torch.cat(out, dim=1)
    sidx = torch.tensor([_sidx(j, per) for j in range(n)])
    q, rest = divmod(s, n)
    lo, hi = torch.arange(n - rest), torch.arange(n - rest, n)
    bufs, rows = [], [torch.full((x.shape[0], width), float("nan")) for _ in range(c)]
    for b in range(c):
        buf = torch.full((x.shape[0], width), float("nan"))
        if q == 0:
            buf[:, sidx] = v[b]
        bufs.append(buf)
        if q >= 1 and b + q < c:
            rows[b + q][:, sidx[lo + rest]] = v[b][:, lo]
        if rest > 0 and b + q + 1 < c:
            rows[b + q + 1][:, sidx[hi + rest - n]] = v[b][:, hi]
    for r in range(c):
        o = torch.full((x.shape[0], n), fill)
        if q == 0:
            o[:, rest:] = bufs[r][:, sidx[torch.arange(n - rest)]]
        elif r - q >= 0:
            o[:, rest:] = rows[r][:, sidx[rest:]]
        if rest > 0 and r - q - 1 >= 0:
            o[:, :rest] = rows[r][:, sidx[:rest]]
        out.append(o)
    return torch.cat(out, dim=1)


def _check_shifts(per: int, threads: int, cluster: int = 1) -> None:
    """The kernels' shifts on a row of ``cluster`` blocks of ``threads``
    threads (cluster 2 at 128 threads: the pair; 3..16: a C-block cluster;
    2..8 at BLOCK_THREADS: a cluster of wide blocks) against the plain
    shift, for every s = 2^p of the row's chain and both fills."""
    rng = np.random.default_rng(per)
    m = cluster * threads * per
    x = torch.from_numpy(rng.normal(size=(2, m)).astype(np.float32))
    for p in range(p7_cuda.chain_passes(m) + 1):
        s = 1 << p
        for fill in (p7_cuda.NEG_INF, 0.0):
            if cluster == 1:
                got = _kernel_shift(x, s, per, fill, threads)
            elif cluster == 2 and threads == THREADS:
                got = _kernel_pair_shift(x, s, per, fill)
            else:
                got = _kernel_cluster_shift(x, s, per, fill, cluster, threads)
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


def _small(s: int, per: int) -> bool:
    """A shift by s moves registers and a halo (by 1, 2, 4, 8, 16 below per)."""
    return s < per and s in (1, 2, 4, 8, 16)


def _kernel_pair_shift_up(x: torch.Tensor, s: int, per: int, fill: float) -> torch.Tensor:
    """csrc/p7_blocked.cuh::pair_shift_up on a [B, 2 * 128 * per] row: for s
    < per (by 1, 2, 4, 8, 16) slots k < per - s move within the thread and
    the last s come from thread t + 1's first s through the block's shift
    buffer, in block 0's thread 127 from the halo block 1's thread 0 stores
    its first s registers into (fill in block 1's thread 127); otherwise
    each block writes its half into its shift buffer, block 1 stores its
    first min(s, 128 * per) states into block 0's row at their own index
    (block 0 waits for exactly those bytes), and slot k reads state t * per
    + k + s of its own buffer, past the block in block 0 state j - 128 * per
    of the row, else fill. Buffers and rows start as NaN, so a read of a
    slot nobody stored shows."""
    n = THREADS * per
    width = THREADS * p7_cuda.blocked_stride(per)
    v = [x[:, r * n:(r + 1) * n] for r in (0, 1)]
    out = []
    if _small(s, per):
        for r in (0, 1):
            b = _blocked(v[r], per, THREADS)
            o = torch.full_like(b, float("nan"))
            o[:, :, : per - s] = b[:, :, s:]
            o[:, :-1, per - s:] = b[:, 1:, :s]
            o[:, -1, per - s:] = v[1][:, :s] if r == 0 else fill
            out.append(o.reshape(x.shape[0], n))
        return torch.cat(out, dim=1)
    sidx = torch.tensor([_sidx(j, per) for j in range(n)])
    count = min(s, n)
    row = torch.full((x.shape[0], width), float("nan"))
    row[:, sidx[:count]] = v[1][:, :count]
    stored = count  # the bytes block 0's row mbarrier expects, in states
    assert stored == min(s, n)
    for r in (0, 1):
        buf = torch.full((x.shape[0], width), float("nan"))
        buf[:, sidx] = v[r]
        o = torch.full((x.shape[0], n), fill)
        j = torch.arange(n) + s
        own = j < n
        o[:, own] = buf[:, sidx[j[own]]]
        if r == 0:
            far = (j >= n) & (j - n < n)
            o[:, far] = row[:, sidx[j[far] - n]]
        out.append(o)
    return torch.cat(out, dim=1)


def _mirror_targets(s: int, n: int, b: int, c: int):
    """cluster_shift_up_big's stores of block b for a shift by s (n states a
    block): [(receiver, first sender state, last + 1, receiver's first
    index)] for the receivers that exist."""
    q, rest = divmod(s, n)
    out = []
    if q >= 1 and b - q >= 0:
        out.append((b - q, rest, n, 0))
    if rest > 0 and b - q - 1 >= 0:
        out.append((b - q - 1, 0, rest, n - rest))
    return out


def _kernel_cluster_shift_up(x: torch.Tensor, s: int, per: int, fill: float,
                             c: int, threads: int = THREADS) -> torch.Tensor:
    """csrc/p7_blocked.cuh::cluster_shift_up on a [B, c * threads * per]
    row (threads 128; the posterior pair's clusters of 256-thread blocks
    past 38,912 states), block r holding the slice r * threads * per ..: for
    s < per (by 1, 2, 4, 8, 16) slots k < per - s move within the thread and
    the last s come from thread t + 1's first s through the block's shift
    buffer, in block r's last thread from the halo block r + 1's thread 0
    stores its first s registers into (fill in block c - 1). Otherwise, with
    q = s div (threads * per) and s' its rest, block b stores its states l
    >= s' into block b - q's row at l - s' (for q = 0 they stay in its own
    shift buffer, read at l + s') and the others into block b - q - 1's row
    at l + threads * per - s'; each receiving block waits for the bytes of
    the blocks that exist above it (held equal to what they store) and reads
    its row (or buffer), fill where no block sent. Rows start as NaN."""
    n = threads * per
    width = threads * p7_cuda.blocked_stride(per)
    v = [x[:, r * n:(r + 1) * n] for r in range(c)]
    out = []
    if _small(s, per):
        for r in range(c):
            b = _blocked(v[r], per, threads)
            o = torch.full_like(b, float("nan"))
            o[:, :, : per - s] = b[:, :, s:]
            o[:, :-1, per - s:] = b[:, 1:, :s]
            o[:, -1, per - s:] = v[r + 1][:, :s] if r + 1 < c else fill
            out.append(o.reshape(x.shape[0], n))
        return torch.cat(out, dim=1)
    sidx = torch.tensor([_sidx(j, per) for j in range(n)])
    q, rest = divmod(s, n)
    rows = [torch.full((x.shape[0], width), float("nan")) for _ in range(c)]
    written = [torch.zeros(width, dtype=torch.bool) for _ in range(c)]
    stored = [0] * c
    for b in range(c):
        for dst, lo, hi, at in _mirror_targets(s, n, b, c):
            slots = sidx[torch.arange(lo, hi) - lo + at]
            assert not written[dst][slots].any()  # the two senders' ranges are disjoint
            written[dst][slots] = True
            rows[dst][:, slots] = v[b][:, lo:hi]
            stored[dst] += hi - lo
    for r in range(c):
        from_a = q >= 1 and r + q < c
        from_b = rest > 0 and r + q + 1 < c
        assert stored[r] == (n - rest if from_a else 0) + (rest if from_b else 0)
        o = torch.full((x.shape[0], n), fill)
        lo = torch.arange(n - rest)  # l + s' < n
        if q == 0:
            o[:, lo] = v[r][:, lo + rest]  # its own shift buffer at sidx(l + s')
        elif from_a:
            o[:, lo] = rows[r][:, sidx[lo]]
        if from_b:
            hi = torch.arange(n - rest, n)
            o[:, hi] = rows[r][:, sidx[hi]]
        out.append(o)
    return torch.cat(out, dim=1)


def _larger_shifts(per: int, window: int) -> tuple[list[int], int]:
    """The larger shifts of a chain of ``window`` passes at ``per`` states
    a thread (the passes past the small ones), and the small passes."""
    small = sum(1 for p in range(window) if _small(1 << p, per))
    return [1 << p for p in range(small, window)], small


def _receivers(s: int, n: int, b: int, c: int, mirror: bool) -> list[tuple[int, int]]:
    """[(role, receiver)] of block b's stores at a larger shift by s (n
    states a block): role 0 the block q away (q >= 1), role 1 the block q +
    1 away (s' > 0), above it (cluster_shift_big) or, for the mirror,
    below it (cluster_shift_up_big), where they exist."""
    q, rest = divmod(s, n)
    way = -1 if mirror else 1
    out = []
    if q >= 1 and 0 <= b + way * q < c:
        out.append((0, b + way * q))
    if rest > 0 and 0 <= b + way * (q + 1) < c:
        out.append((1, b + way * (q + 1)))
    return out


def _releases(n: int, c: int, big: list[int], mirror: bool) -> dict:
    """{use i: {sender: [(role, releaser)]}}: the releases of the step's
    larger shifts ``big`` as cluster_release (cluster_release_up) sends
    them: block r, once the barrier of its larger shift i - 1 >= 1 has
    passed, hands use i's shift (s_{i-1} << 1) to the blocks that store into
    its row there (r - q, r - q - 1; the mirror's r + q, r + q + 1), thread
    0 for role 0 and thread 1 for role 1."""
    sent = {}
    for i in range(1, len(big)):
        if not i + 1 < len(big):
            continue
        s = big[i] << 1  # use i + 1's shift
        assert s == big[i + 1]
        q, rest = divmod(s, n)
        way = 1 if mirror else -1
        for r in range(c):
            for role, to in ((0, r + way * q if q >= 1 else -1),
                             (1, r + way * (q + 1) if rest > 0 else -1)):
                if 0 <= to < c:
                    sent.setdefault(i + 1, {}).setdefault(to, []).append((role, r))
    return sent


def _check_releases(per: int, c: int, window: int, mirror: bool,
                    threads: int = THREADS) -> dict:
    """The release protocol of the C-block clusters' larger shifts over a
    chain of ``window`` passes: at each larger shift i >= 2 a sender waits
    for one release from each block it stores into, and exactly those blocks
    send it one (_releases), in the slot of its role; no release is sent
    for uses 0 and 1. Each use's releases complete an mbarrier of that use
    (the sender's halo mbarrier 2 + p of its pass p: distinct ids, past
    every small shift's halo, within the 18 halos). Returns the releases."""
    n = threads * per
    big, small = _larger_shifts(per, window)
    sent = _releases(n, c, big, mirror)
    for i, s in enumerate(big):
        for b in range(c):
            want = sorted(_receivers(s, n, b, c, mirror))
            got = sorted(sent.get(i, {}).get(b, []))
            assert got == (want if i >= 2 else []), (i, b, s)
    ids = [2 + small + i for i in range(len(big))]
    assert len(set(ids)) == len(ids) and all(2 + small <= x < 18 for x in ids)
    return sent


def _row_mbarrier_mixes(sent: dict, c: int) -> bool:
    """Whether a per-row release mbarrier (one for uses i, i + 2, ... of
    a row) would mix uses: some block releases a sender's use i + 2 but
    not its use i, so its release may land in use i's phase."""
    for i in sent:
        for b in range(c):
            now = {r for _, r in sent[i].get(b, [])}
            later = {r for _, r in sent.get(i + 2, {}).get(b, [])}
            if later - now:
                return True
    return False


def _check_mirror_releases(per: int, c: int, window: int, threads: int = THREADS) -> None:
    """The rows' release protocol of cluster_shift_up_big over a chain of
    ``window`` passes (_check_releases of the mirror), each receiving
    block's stores as _mirror_targets counts them."""
    n = threads * per
    sent = _check_releases(per, c, window, True, threads)
    big, _ = _larger_shifts(per, window)
    for i in range(2, len(big)):
        for b in range(c):
            want = sorted((0 if at == 0 else 1, dst) for dst, _, _, at in
                          _mirror_targets(big[i], n, b, c))
            assert sorted(sent[i].get(b, []) if i in sent else []) == want, (b, i)


def _check_shifts_up(per: int, cluster: int, threads: int = THREADS) -> None:
    """The mirror shifts of ``cluster`` blocks (2: the pair) of ``threads``
    threads against the plain up-shift for every s = 2^p of the row's chain
    (and one past it), a shift of a whole block or more (q >= 1) among
    them, and the release protocol of every window."""
    rng = np.random.default_rng(300 + 17 * cluster + per)
    m = cluster * threads * per
    x = torch.from_numpy(rng.normal(size=(2, m)).astype(np.float32))
    whole = 0
    for p in range(p7_cuda.chain_passes(m) + 1):
        s = 1 << p
        whole += s >= threads * per
        if cluster == 2:
            got = _kernel_pair_shift_up(x, s, per, 0.0)
        else:
            got = _kernel_cluster_shift_up(x, s, per, 0.0, cluster, threads)
        assert torch.equal(got, posterior_cuda._up(x, s)), s
    assert whole >= 1
    if cluster > 2:  # the windows of the kernels' chain (at most 16 passes)
        for window in range(1, p7_cuda.chain_passes(min(m, p7_cuda.MAX_KERNEL_STATES)) + 1):
            _check_mirror_releases(per, cluster, window, threads)


@pytest.mark.parametrize("per", p7_cuda.PAIR_PER)
def test_pair_mirror_shifts_equal_the_plain_up_shift(per):
    """The cluster pair's shifts toward lower j (the backward pass's wide
    case), across the pair included, for every pass s = 2^p of 2 * 128 *
    per states."""
    _check_shifts_up(per, 2)


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
    """Past 38,912 every kind but the eager and log-space ones, the
    row-saving Forward and the backward pass plans the rows-in-memory case;
    those two plan it past 38,912 where the card holds no cluster of their
    256-thread blocks (``clusters`` 0; else test_wide_cluster_plan), and the
    eager and log-space kinds past MAX_BLOCK_STATES where the card holds no
    cluster of their wide blocks (``clusters`` 0; else they plan the cluster
    of wide blocks: test_block_cluster_plan): one
    group of 1024 threads a block, nothing staged, no dynamic shared memory,
    a persistent grid of at most two blocks an SM (fewer when the registers
    do not allow two) and no more blocks than sequences; a forced G > 1
    raises. The first width past the wide block, the 24-profile join (LENG
    30181) and the widest M_pad, 65536 (16 chain passes), are such cases for
    the first two (the three-profile join, LENG 6977, takes the wide block:
    test_block_plan_fits_the_block); 38,920 and 65536 for the lazy, filter,
    Forward and backward kinds, which also plan it where the card holds no
    cluster (``clusters`` 0)."""
    assert p7_cuda.BLOCK_KINDS == tuple(k for k in p7_cuda.BLOCKED_KINDS
                                        if k not in p7_cuda.CLUSTER_KINDS)
    block = kind in p7_cuda.BLOCK_KINDS
    wide = kind in p7_cuda.WIDE_CLUSTER_KINDS
    widths = (p7_cuda.MAX_BLOCK_STATES + 8, 30184, 65536) if block else (38920, 65536)
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
    blocks past it (30184: 4, 38912: 5)."""
    for m_pad, c in ((4872, 3), (6984, 3), (30184, 13), (38912, 16)):
        block = m_pad <= p7_cuda.MAX_BLOCK_STATES
        wide_c = 1 if block else -(-m_pad // 8192)
        assert p7_cuda.cluster_blocks(m_pad, kind) == (
            c if kind in p7_cuda.CLUSTER_KINDS else wide_c) and c == -(-m_pad // 2432)
        full = p7_cuda.chain_passes(m_pad)
        if kind not in p7_cuda.CLUSTER_KINDS:
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
    (run_chunk) and reduction (group_reduce, four warps)."""
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
    assert 'static_assert(KT == 128, "groups of 128 (the wide block runs block_chunk)");' in (
        template)
    assert "static constexpr int NEM = KT == 128 ? 4 : 2;" in template
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
    the four compiled cases a kind)."""
    assert len(BLOCK_CLUSTER_CASES) == 16
    assert {c for c, _ in BLOCK_CLUSTER_CASES} == set(range(2, p7_cuda.MAX_BLOCK_CLUSTER + 1))
    assert {per for _, per in BLOCK_CLUSTER_CASES} == set(p7_cuda.BLOCK_CLUSTER_PER)
    assert p7_cuda.MAX_BLOCK_CLUSTER * BLOCK * p7_cuda.BLOCK_CLUSTER_PER[-1] == (
        p7_cuda.MAX_KERNEL_STATES)
    for c, per in BLOCK_CLUSTER_CASES:
        assert (c - 1) * BLOCK * per < c * BLOCK * per and per <= 8 and c <= 8


@pytest.mark.parametrize("m_pad,c,per", BLOCK_CLUSTER_WIDTHS)
def test_block_cluster_plan(m_pad, c, per):
    """The eager and log-space kinds past MAX_BLOCK_STATES plan C wide
    blocks a sequence (``cluster`` C, BLOCK_THREADS threads, ``per``; the
    plan's ``block_cluster``, neither ``block`` nor ``mem`` nor ``pair``),
    one group a block (a forced G other than 1 raises), a grid of whole
    clusters (the ``clusters`` the card holds, else one block an SM over C;
    no more clusters than sequences), the transitions staged first, then
    chain rows, as many as fit the 232,448 bytes beside the wide block's
    group and the cluster's area (blocked_smem_bytes(block=True,
    cluster=True)); every other kind plans as before (the row-saving
    Forward and the backward pass past 38,912: test_wide_cluster_plan)."""
    full = p7_cuda.chain_passes(m_pad)
    row = 4 * BLOCK * p7_cuda.blocked_stride(per)
    base = p7_cuda.blocked_smem_bytes(per, 0, 1, block=True, cluster=True)
    assert base == p7_cuda.blocked_smem_bytes(per, 0, 1, block=True) + 2 * row + 4 * 1364
    for kind in p7_cuda.BLOCK_KINDS:
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
    # per 8: no row staged; per 5: five transitions
    assert {8: (0, 0), 5: (5, 0)}.get(per, (1, 0)) == (
        p7_cuda.plan_launch("eager", m_pad, full, 64, 64, SMS)[6],
        p7_cuda.plan_launch("eager", m_pad, full, 64, 64, SMS).n_chain)
    for kind in p7_cuda.CLUSTER_KINDS:
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
    blocks in rank order; combine_warps stays a 4- or 8-warp combine."""
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
    assert "viterbi_body<PER, KT, false, LSE, false, Span::kCluster>(a);" in template
    assert ("block_chunk<PER, KT, LSE, SPAN>(a, smem, gs, r, count, par, tr_loop, tr_move, t, "
            "bar, &h);") in template
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
        assert "c, grid, smem, stream, kBlockThreads);" in source, name


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
    """Past 38,912 states up to 65536 the row-saving Forward and the
    backward pass take C = ceil(M_pad / 4864) blocks of 256 threads and per
    = ceil(M_pad / (256 * C)): C of 9..14, per of WIDE_CLUSTER_PER (17..19,
    the three compiled cases a kind); every width of a C covered by its per,
    none by the C before."""
    assert p7_cuda.WIDE_CLUSTER_KINDS == ("save", "backward") and WIDE == 256
    assert {c for c, _ in WIDE_CLUSTER_CASES} == set(range(9, 15))
    assert {per for _, per in WIDE_CLUSTER_CASES} == set(p7_cuda.WIDE_CLUSTER_PER) == {17, 18, 19}
    for m in range(p7_cuda.MAX_CLUSTER_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8):
        c = p7_cuda.cluster_blocks(m, "backward")
        threads, per = p7_cuda.kernel_case(m, "backward")
        assert threads == WIDE and c * WIDE * per >= m > (c - 1) * WIDE * 19
        assert c * WIDE * (per - 1) < m and p7_cuda.wide_cluster_case(m, "save")
    for kind in p7_cuda.BLOCKED_KINDS:
        assert not p7_cuda.wide_cluster_case(p7_cuda.MAX_CLUSTER_STATES, kind)
        assert p7_cuda.wide_cluster_case(38920, kind) == (kind in ("save", "backward"))
    with pytest.raises(ValueError, match="65536"):
        p7_cuda.kernel_case(p7_cuda.MAX_KERNEL_STATES + 8, "save")


@pytest.mark.parametrize("m_pad,c,per", WIDE_CLUSTER_WIDTHS)
def test_wide_cluster_plan(m_pad, c, per):
    """The row-saving Forward and the backward pass past 38,912 states (up
    to 65536) plan C 256-thread blocks a sequence (``threads`` 256,
    ``cluster`` C, ``per``; the plan's ``wide_cluster``, neither ``block``
    nor ``mem`` nor ``pair`` nor ``block_cluster``), one group a block (a
    forced G other than 1 raises), a grid of whole clusters (the
    ``clusters`` the card holds, else what an SM holds, one block, times the
    SMs over C; no more clusters than sequences), the transitions staged
    first and then chain rows, as many as fit the 232,448 bytes beside the
    group and the cluster's area (blocked_smem_bytes(cluster=True,
    threads=256)); a card that holds none (``clusters`` 0) plans the
    rows-in-memory case. The all-24 join twice over (60368) takes 13 blocks
    of 19 states, two transition rows staged; every other kind keeps its
    case there."""
    row = 4 * WIDE * p7_cuda.blocked_stride(per)
    for kind in p7_cuda.WIDE_CLUSTER_KINDS:
        bwd, save = kind == "backward", kind == "save"
        assert p7_cuda.cluster_blocks(m_pad, kind) == c == -(-m_pad // 4864)
        assert p7_cuda.kernel_case(m_pad, kind) == (WIDE, per) == (WIDE, -(-m_pad // (WIDE * c)))
        base = p7_cuda.blocked_smem_bytes(per, 0, 1, save, backward=bwd, cluster=True,
                                          threads=WIDE)
        group = (6 * row + 2 * (WIDE * p7_cuda.bf16_stride(per) // 2) * 4 + 4 * (24 + 32 + 256)
                 if bwd else 7 * row + 4 * (16 + 32))
        assert base == group + 2 * row + 4 * (852 if bwd else 596)
        for passes, regs, b_pad in itertools.product(_passes(kind, m_pad)[::3], REGS, BATCHES):
            plan = p7_cuda.plan_launch(kind, m_pad, passes, b_pad, regs, SMS)
            assert (plan.threads, plan.cluster, plan.groups, plan.max_groups, plan.per) == (
                WIDE, c, 1, 1, per)
            assert plan.wide_cluster and not (plan.block or plan.mem or plan.pair
                                              or plan.block_cluster)
            rows = plan.n_trans + plan.n_chain
            assert plan.smem == base + rows * row <= SMEM_PER_SM
            assert plan.smem == p7_cuda.blocked_smem_bytes(per, rows, 1, save, backward=bwd,
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
    CLUSTER_FLOATS at 128 threads."""
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
    row = WIDE * 17
    assert p7_cuda.blocked_smem_bytes(17, 4, 1, save=True, cluster=True, threads=WIDE) == 4 * (
        4 * row + 7 * row + 48 + 2 * row + 596) <= SMEM_PER_SM


def test_wide_cluster_cases_match_kernel_source():
    """The 256-thread clusters' cases the two C entries compile are
    WIDE_CLUSTER_PER at kWideClusterThreads (with_wide_cluster_case), named
    by ``threads`` 256 with ``cluster`` C; forward_wide_cluster_kernel runs
    forward_body's row-saving case and backward_wide_cluster_kernel
    backward_body at KT = 256 on a C-block cluster, bounded to one block of
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
    assert "forward_wide_cluster_kernel<PER, false>" not in forward
    assert "4 * cluster_smem_floats<PER, KT, false>(n_rows, true)" in forward
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
