"""The CPU models of the blocked p7 kernels' layout that the
tests/test_torch_p7_layout*.py files hold csrc/p7_blocked.cuh,
csrc/p7_viterbi.cuh and the launch plan to: the shared-row index, the
shifts toward higher j (a group, the cluster pair, the C-block clusters,
the wide block and its clusters) and toward lower j (the backward pass's
mirrors), the C-block clusters' release protocol, the bf16 row index and
the chain passes a case can run; and the fixture that runs a test module's
torch ops on one thread (the workers of a parallel test run share the
machine's cores, and many threads a worker on these small ops mostly wait
on each other)."""

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda, posterior_cuda

PERS = p7_cuda.KERNEL_PER
THREADS = p7_cuda.KERNEL_THREADS
# every group case: (threads, per)
CASES = [(THREADS, per) for per in PERS]
SMS = 132  # the H100 SXM's multiprocessors
REGS = (32, 64, 96, 118, 128, 155, 188, 255)
BATCHES = (1, 33, 64, 132, 133, 1024, 4096, 16384)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A test module's torch ops on one thread, as tests/test_torch_bucketed.py
    runs its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sidx(j: int, per: int) -> int:
    """csrc/p7_blocked.cuh::sidx."""
    return j if per % 2 else j + j // per


def _sidx_row(n: int, per: int) -> torch.Tensor:
    """_sidx of the states 0..n - 1, as an index tensor."""
    j = torch.arange(n)
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


def _kernel_pair_shift(x: torch.Tensor, s: int, per: int, fill: float) -> torch.Tensor:
    """csrc/p7_blocked.cuh::pair_shift on a [B, 2 * 128 * per] row, block r
    holding the half r * 128 * per ..: each block writes its half into its
    shift buffer at t * stride + k (a small shift only its last s slots);
    for s < per (by 1, 2, 4, 8, 16) slots k >= s move within the thread and
    the first s come from thread t - 1's last s, in block 1's thread 0 from
    the halo block 0's thread 127 stores its last s registers into (fill in
    block 0's thread 0); otherwise slot k reads state t * per + k - s of its
    own buffer at sidx, below 0 in block 1 state j + 128 * per of block 0's
    buffer, else fill. Buffers start as NaN, so a read of a slot nobody
    stored shows; every thread and slot at once."""
    n = THREADS * per
    stride = p7_cuda.blocked_stride(per)
    small = s < per and s in (1, 2, 4, 8, 16)
    v = x.reshape(x.shape[0], 2, THREADS, per)
    t, k = torch.meshgrid(torch.arange(THREADS), torch.arange(per), indexing="ij")
    stored = k >= (per - s if small else 0)
    slot = (t * stride + k)[stored]
    bufs = torch.full((x.shape[0], 2, THREADS * stride), float("nan"), dtype=x.dtype)
    bufs[:, :, slot] = v[:, :, stored]
    out = torch.empty_like(v)
    if small:
        out[:, :, :, s:] = v[:, :, :, : per - s]
        prev = ((t[1:, :s] - 1) * stride + per - s + k[1:, :s]).reshape(-1)
        out[:, :, 1:, :s] = bufs[:, :, prev].reshape(x.shape[0], 2, THREADS - 1, s)
        out[:, 0, 0, :s] = fill
        out[:, 1, 0, :s] = v[:, 0, THREADS - 1, per - s:]  # the halo
        return out.reshape(x.shape)
    j = (t * per + k - s).reshape(-1)
    own = j >= 0
    far = ~own & (j + n >= 0)
    sidx = _sidx_row(n, per)
    flat = torch.full((x.shape[0], 2, n), fill, dtype=x.dtype)
    flat[:, :, own] = bufs[:, :, sidx[j[own]]]
    flat[:, 1, far] = bufs[:, 0, sidx[j[far] + n]]
    return flat.reshape(x.shape)


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
    row (or buffer), fill where no block sent. Rows start as NaN; every
    block at once (the cluster's blocks on one axis)."""
    n = threads * per
    width = threads * p7_cuda.blocked_stride(per)
    b = x.shape[0]
    v = x.reshape(b, c, n)  # a block's states, l = t * per + k
    if s < per and s in (1, 2, 4, 8, 16):
        blk = v.reshape(b, c, threads, per)
        o = blk.clone()
        o[:, :, :, s:] = blk[:, :, :, : per - s]
        # thread t - 1's last s slots through the buffer, thread 0's from
        # the halo of block r - 1's last thread
        o[:, :, 1:, :s] = blk[:, :, :-1, per - s:]
        o[:, 0, 0, :s] = fill
        o[:, 1:, 0, :s] = v[:, :-1, n - s:]
        return o.reshape(x.shape)
    sidx = _sidx_row(n, per)
    q, rest = divmod(s, n)
    lo, hi = torch.arange(n - rest), torch.arange(n - rest, n)
    bufs = torch.full((b, c, width), float("nan"))
    rows = torch.full((b, c, width), float("nan"))
    if q == 0:
        bufs[:, :, sidx] = v  # each block's own shift buffer
    elif q < c:
        rows[:, q:, sidx[lo + rest]] = v[:, : c - q, lo]
    if rest > 0 and q + 1 < c:
        rows[:, q + 1:, sidx[hi + rest - n]] = v[:, : c - q - 1, hi]
    o = torch.full((b, c, n), fill)
    if q == 0:
        o[:, :, rest:] = bufs[:, :, sidx[torch.arange(n - rest)]]
    elif q < c:
        o[:, q:, rest:] = rows[:, q:, sidx[rest:]]
    if rest > 0 and q + 1 < c:
        o[:, q + 1:, :rest] = rows[:, q + 1:, sidx[:rest]]
    return o.reshape(x.shape)


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
    at l + threads * per - s' (_mirror_targets); each receiving block waits
    for the bytes of the blocks that exist above it (held equal to what they
    store) and reads its row (or buffer), fill where no block sent. Rows
    start as NaN; every block at once (the cluster's blocks on one axis)."""
    n = threads * per
    width = threads * p7_cuda.blocked_stride(per)
    b = x.shape[0]
    v = x.reshape(b, c, n)
    if _small(s, per):
        blk = v.reshape(b, c, threads, per)
        o = torch.full_like(blk, float("nan"))
        o[:, :, :, : per - s] = blk[:, :, :, s:]
        o[:, :, :-1, per - s:] = blk[:, :, 1:, :s]
        o[:, :-1, -1, per - s:] = v[:, 1:, :s]
        o[:, -1, -1, per - s:] = fill
        return o.reshape(x.shape)
    sidx = _sidx_row(n, per)
    q, rest = divmod(s, n)
    rows = torch.full((b, c, width), float("nan"))
    written = torch.zeros((c, width), dtype=torch.int64)
    stored = torch.zeros(c, dtype=torch.int64)
    senders = torch.arange(c)
    for role in (0, 1):  # the stores of role a, then b, of every sender at once
        targets = [_mirror_targets(s, n, int(sb), c) for sb in senders]
        picks = [(sb, t) for sb, ts in zip(senders.tolist(), targets) for t in ts
                 if (t[3] == 0) == (role == 0)]
        if not picks:
            continue
        src = torch.tensor([sb for sb, _ in picks])
        dst, lo, hi, at = (torch.tensor([t[i] for _, t in picks]) for i in range(4))
        assert (lo == lo[0]).all() and (hi == hi[0]).all() and (at == at[0]).all()
        slots = sidx[torch.arange(int(lo[0]), int(hi[0])) - int(lo[0]) + int(at[0])]
        rows[:, dst[:, None], slots[None, :]] = v[:, src, int(lo[0]):int(hi[0])]
        written.index_put_((dst[:, None], slots[None, :]), torch.ones((), dtype=torch.int64),
                           accumulate=True)
        stored[dst] += int(hi[0]) - int(lo[0])
    assert int(written.max()) <= 1  # the two senders' ranges are disjoint
    r = torch.arange(c)
    from_a = (q >= 1) & (r + q < c)
    from_b = (rest > 0) & (r + q + 1 < c)
    assert torch.equal(stored, torch.where(from_a, n - rest, 0) + torch.where(from_b, rest, 0))
    o = torch.full((b, c, n), fill)
    lo = torch.arange(n - rest)  # l + s' < n
    if q == 0:
        o[:, :, lo] = v[:, :, lo + rest]  # its own shift buffer at sidx(l + s')
    else:
        ra = r[from_a][:, None]
        o[:, ra, lo[None, :]] = rows[:, ra, sidx[lo][None, :]]
    rb, hi = r[from_b][:, None], torch.arange(n - rest, n)
    o[:, rb, hi[None, :]] = rows[:, rb, sidx[hi][None, :]]
    return o.reshape(x.shape)


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


def _hidx(j: int, per: int) -> int:
    """csrc/p7_blocked.cuh::hidx: halfword of state j in a bf16 row."""
    return (j // per) * p7_cuda.bf16_stride(per) + j % per


def _passes(kind: str, m_pad: int):
    """The pass counts a case can run at ``m_pad``: every window for the
    lazy, Forward and filter cases, the full chain for the eager and
    log-space ones."""
    full = p7_cuda.chain_passes(m_pad)
    windowed = ("lazy", "forward", "save", "filter", "backward")
    return range(1, full + 1) if kind in windowed else (full,)
