"""Full-profile Viterbi and Forward scans: the host packers, the plain
PyTorch versions and the wrappers of the CUDA kernels.

The counterparts of ``hmm_fasta_viterbi_tpu/ops/pallas_p7.py``:

* ``_p7_kernel`` (Viterbi): :func:`viterbi_scan`, eager, the whole delete
  chain every residue;
* ``_p7_kernel`` (Forward, ``forward=True``): :func:`forward_log_scan`, the
  same scan in the (logsumexp, +) semiring, with Viterbi's operands;
* ``_p7_lazy_kernel``: :func:`viterbi_lazy_scan`, the truncated chain with
  the per-row certificate and a full-chain replay of a chunk that fires;
* ``_fwd_prob_kernel``: :func:`forward_prob_scan`, Forward in scaled
  probability space;
* ``_p7_filter_kernel``: :func:`viterbi_filter_scan`, the upper-bound
  Viterbi filter of the fast cascade: bf16 round-up emissions, a chain of
  ``window`` passes and a tail term bounding the longer delete runs.

The kernels take M_pad up to MAX_KERNEL_STATES = 65536 (the 16-row delete
chain, as the TPU kernels): groups of KERNEL_THREADS threads a sequence up
to 2432 states and of WIDE_THREADS up to 4864, with the rows in registers,
and past that the rows-in-memory case, MEM_THREADS threads a sequence with
its rows in global memory (:func:`kernel_case`); the plain versions have no
cap.

The host packers are numpy copies of the JAX ones (that module imports
jax) and return the same arrays byte for byte, in the TPU's ``[M_pad, …]``
layout with ``M_pad = round_up(max(Mr, 8), 8)``. :func:`device_pack`
transposes them into the port's layout, one row per constant:

* ``emit_m`` / ``emit_i`` f32 ``[20, M_pad]``: match and insert scores
  (Viterbi and log-space Forward, pad states PAD_SCORE) or odds ratios
  (probability-space Forward, pad states 0);
* ``trans`` f32 ``[8, M_pad]``: tmm tmi tmd tim tii tdm tdd_s pad, as log
  scores (pad -inf) or probabilities (probability-space Forward, pad 0);
* ``chain`` f32 ``[16, M_pad]`` (Viterbi and log-space Forward: the
  Hillis-Steele pass constants, row 15 the lazy certificate's Cmax) or
  ``[W, M_pad]`` (probability-space Forward: the window products of the
  ``W`` passes kept);
* ``consts`` f32 ``[3]`` (tr_B_Mk, tr_E_C, tr_E_J; probabilities for
  Forward) or ``[5]`` for the lazy kernel (… aux, tmd_max).

The filter's pack (:class:`P7FilterPack`) holds the emissions as bf16
``[20, M_pad]`` (torch.bfloat16; the packer returns their bits as uint16),
the chain's rounded-up window sums, ``consts`` ``[4]`` (… aux) and the
window; its carries are the eager kernel's.

Tokens are int8 ``[B_pad, L_pad]`` and ``lengths`` int32 ``[B_pad]``, as in
``msv_cuda``. The DP carries go in and come out as ``p7_pallas_call`` /
``fwd_prob_pallas_call`` return them, transposed: ``m``, ``i``, ``d`` f32
``[B_pad, M_pad]`` and ``s`` f32 ``[4, B_pad]`` (J, C, N, B; log space for
Viterbi and the log-space Forward) or, for the probability-space Forward,
``[8, B_pad]`` (J, C, N, B, log_scale, Kahan compensation, 0, 0).
The lazy kernel's ``d`` slot carries ``pre_diag = max(M + tmm, I + tim,
D + tdm)``, as in the JAX kernel. Steps at or past a sequence's length
leave every carry unchanged, so a second call with the residues from a
split on and the lengths less the split (clipped at 0) continues the
first; for Forward the split must be a multiple of
:data:`FWD_RESCALE_GROUP` to give the one call's scores bit for bit.

Each scan runs its plain version on CPU tensors and its kernel on CUDA
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.p7 import P7Profile

from . import _build
from .msv_cuda import (
    NEG_INF, NUM_AA, PAD_SCORE, SMEM_PER_SM, _check, _sm_count, bf16_round_up, bf16_tensor,
    count_launch, f32_round_up, round_up,
)

# residues per lazy-certificate chunk: a fire replays this many steps of
# one sequence with the full chain (the JAX kernel replays an L-chunk of
# 128 residues of a whole lane block)
LAZY_CHUNK = 128
# Forward renormalises after every this many residues of a call; one
# group of steps grows the scaled values by at most the largest odds
# ratio to the power 8, far inside float32's range
FWD_RESCALE_GROUP = 8
# threads that follow one sequence in the kernels: KERNEL_THREADS up to
# KERNEL_THREADS * 19 = 2432 states, WIDE_THREADS up to 4864, each thread
# owning states t * per .. t * per + per - 1 in registers
# (csrc/p7_blocked.cuh); past that MEM_THREADS threads a sequence in the
# rows-in-memory case, thread t handling states t, t + MEM_THREADS, ... of
# rows kept in MEM_ROWS scratch rows of global memory a block
KERNEL_THREADS = 128
WIDE_THREADS = 256
MEM_THREADS = 1024
MEM_ROWS = 8
# states per thread: one template case each in csrc/p7_*_kernel.cu, at
# KERNEL_THREADS (KERNEL_PER) and at WIDE_THREADS (WIDE_PER)
KERNEL_PER = tuple(range(1, 20))
WIDE_PER = tuple(range(10, 20))
MAX_GROUP_STATES = KERNEL_THREADS * KERNEL_PER[-1]  # 2432 >= 2405, the largest of the 24
MAX_WIDE_STATES = WIDE_THREADS * WIDE_PER[-1]  # 4864
MAX_KERNEL_STATES = 1 << 16  # 65536: the 16 rows of the delete chain

# the blocked kernels' launch plan (csrc/p7_blocked.cuh): at most
# MAX_BLOCK_THREADS threads a block (MAX_GROUPS groups of KERNEL_THREADS, 4
# of WIDE_THREADS), one sequence a group, on named barriers 1..8; an SM's
# registers and threads
MAX_BLOCK_THREADS = 1024
MAX_GROUPS = MAX_BLOCK_THREADS // KERNEL_THREADS
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
# transition rows a blocked kernel reads every step (tmm tmi tmd tim tii
# tdm); the plan stages all of them at KERNEL_THREADS
TRANS_ROWS = 6
# the backward pass's cases held to 128 registers (__launch_bounds__ of
# BOUNDED_THREADS, csrc/p7_backward_kernel.cu::backward_case): these slots
# a thread at KERNEL_THREADS
BACKWARD_BOUNDED_PER = range(9, 13)
BOUNDED_THREADS = 512
# the blocked kernels' cases: each stages its transition rows, its chain
# rows and, for the lazy kernel's certificate, Cmax; the filter keeps its
# emission rows as bf16; the posterior backward pass its suffix chain, its
# saved bf16 rows and its chunk's log scales and coverage
BLOCKED_KINDS = ("eager", "lazy", "log", "forward", "save", "filter", "backward")

# auto-picked lazy window and truncated prob-space chain: the constants of
# pallas_p7 (LAZY_TAIL_DAMP_NATS, PROB_CHAIN_L_MAX, PROB_CHAIN_REL_ERR)
LAZY_TAIL_DAMP_NATS = 12.0
PROB_CHAIN_L_MAX = 1.0e6
PROB_CHAIN_REL_ERR = 1e-9
# the Viterbi filter's auto-picked window: the smallest whose tail penalty
# 2^K * |max(tdd)| reaches this many nats (pallas_p7.FILTER_TAIL_DAMP_NATS)
FILTER_TAIL_DAMP_NATS = 5.75


# -- host packers (numpy copies of pallas_p7's, byte for byte) -------------

def chain_passes(m_pad: int) -> int:
    """Hillis-Steele passes of the full delete chain over ``m_pad`` states."""
    return max(1, int(np.ceil(np.log2(max(m_pad, 2)))))


def default_m_pad(p7: P7Profile) -> int:
    return round_up(max(p7.num_states, 8), 8)


def prepare_p7_device(p7: P7Profile, m_pad: int | None = None):
    """``(msc_t, isc_t, trans_t, chain_t, tr_consts)`` of
    ``pallas_p7.prepare_p7_device``: emissions clamped and padded with
    PAD_SCORE, transitions -inf padded, ``chain_t[:, k]`` the pass-k tdd
    window sums with rows j < 2^k at -inf."""
    mr = p7.num_states
    m_pad = m_pad or default_m_pad(p7)
    msc_t = np.full((m_pad, 20), PAD_SCORE, dtype=np.float32)
    msc_t[:mr] = np.maximum(p7.msc.T, PAD_SCORE)
    isc_t = np.full((m_pad, 20), PAD_SCORE, dtype=np.float32)
    isc_t[:mr] = np.maximum(p7.isc.T, PAD_SCORE)
    trans_t = np.full((m_pad, 8), NEG_INF, dtype=np.float32)
    tdd_s = np.concatenate(([np.float32(NEG_INF)], p7.tdd[:-1]))
    for col, vec in enumerate(
        (p7.tmm, p7.tmi, p7.tmd, p7.tim, p7.tii, p7.tdm, tdd_s)
    ):
        trans_t[:mr, col] = vec

    chain_t = np.full((m_pad, 16), NEG_INF, dtype=np.float32)
    n_passes = chain_passes(m_pad)
    if n_passes > 16:
        raise ValueError(f"chain_t supports m_pad <= 65536, got {m_pad}")
    rows = np.arange(m_pad)
    c_cur = np.full(m_pad, NEG_INF, dtype=np.float32)
    c_cur[:mr] = tdd_s
    for k in range(n_passes):
        s = 1 << k
        chain_t[:, k] = np.where(rows < s, np.float32(NEG_INF), c_cur)
        rolled = np.roll(c_cur, s)
        with np.errstate(invalid="ignore"):
            c_cur = (c_cur + np.where(rows < s, np.float32(0.0), rolled)).astype(
                np.float32
            )

    tr_consts = np.array([[p7.tr_B_Mk, p7.tr_E_C, p7.tr_E_J]], dtype=np.float32)
    return msc_t, isc_t, trans_t, chain_t, tr_consts


def pick_lazy_window(chain_t: np.ndarray, trans_t: np.ndarray, n_passes: int) -> int:
    """Smallest window K whose certificate constant ``max_j (Cmax_j(K) +
    tdm_j)`` is at least LAZY_TAIL_DAMP_NATS below 0; the full chain when
    none is (``pallas_p7.pick_lazy_window``)."""
    tdm = trans_t[:, 5]
    for k in range(1, n_passes):
        cmax = chain_t[:, k:n_passes].max(axis=1)
        if float((cmax + tdm).max()) <= -LAZY_TAIL_DAMP_NATS:
            return k
    return n_passes


def prepare_p7_device_lazy(
    p7: P7Profile, m_pad: int | None = None, lazy_k: int | None = None
):
    """``(msc_t, isc_t, trans_t, chain_t, consts5, lazy_k)`` of
    ``pallas_p7.prepare_p7_device_lazy``: column 15 of ``chain_t`` holds the
    per-row max of the dropped passes' constants (Cmax), ``consts5`` is
    ``[tr_B_Mk, tr_E_C, tr_E_J, aux, tmd_max]``."""
    m_pad = m_pad or default_m_pad(p7)
    msc_t, isc_t, trans_t, chain_t, _ = prepare_p7_device(p7, m_pad)
    n_passes = chain_passes(m_pad)
    if n_passes > 15:
        lazy_k = n_passes  # column 15 is chain data: no truncated window
    elif lazy_k is None:
        lazy_k = pick_lazy_window(chain_t, trans_t, n_passes)
    lazy_k = min(max(lazy_k, 1), n_passes)

    chain_t = np.array(chain_t, copy=True)
    if lazy_k < n_passes:
        chain_t[:, 15] = chain_t[:, lazy_k:n_passes].max(axis=1)
    elif n_passes <= 15:
        chain_t[:, 15] = NEG_INF
    dropped = chain_t[:, lazy_k:n_passes]
    finite = dropped[np.isfinite(dropped)]
    finite = finite[finite > NEG_INF / 2]
    aux = np.float32(finite.max()) if finite.size else np.float32(NEG_INF)
    tmd_fin = p7.tmd[np.isfinite(p7.tmd)]
    tmd_max = np.float32(tmd_fin.max()) if tmd_fin.size else np.float32(NEG_INF)
    consts5 = np.array(
        [[p7.tr_B_Mk, p7.tr_E_C, p7.tr_E_J, aux, tmd_max]], dtype=np.float32
    )
    return msc_t, isc_t, trans_t, chain_t, consts5, lazy_k


def e_skip_d_ok(p7: P7Profile) -> bool:
    """True when every finite tmd and tdd is <= 0: then no D state can win
    the E max, which the lazy kernel's certificate needs
    (``pallas_p7.e_skip_d_ok``)."""
    return bool(
        np.all(p7.tmd[np.isfinite(p7.tmd)] <= 0.0)
        and np.all(p7.tdd[np.isfinite(p7.tdd)] <= 0.0)
    )


def pick_prob_chain_window(p7: P7Profile, m_pad: int | None = None) -> int:
    """Smallest window K whose dropped delete-chain mass is below a relative
    PROB_CHAIN_REL_ERR over PROB_CHAIN_L_MAX residues
    (``pallas_p7.pick_prob_chain_window``)."""
    mr = p7.num_states
    m_pad = m_pad or default_m_pad(p7)
    n_passes = chain_passes(m_pad)
    tdd_s = np.concatenate(([np.float64(-np.inf)], p7.tdd[:-1].astype(np.float64)))
    rows = np.arange(m_pad)
    c_cur = np.full(m_pad, -np.inf)
    c_cur[:mr] = tdd_s
    chain_log = np.full((m_pad, n_passes), -np.inf)
    for k in range(n_passes):
        s = 1 << k
        chain_log[:, k] = np.where(rows < s, -np.inf, c_cur)
        with np.errstate(invalid="ignore"):
            c_cur = c_cur + np.where(rows < s, 0.0, np.roll(c_cur, s))
    fin = tdd_s[np.isfinite(tdd_s)]
    if fin.size == 0:
        return 1
    tdd_max_p = float(np.exp(fin.max()))
    if tdd_max_p >= 1.0:
        return n_passes
    need = np.log(PROB_CHAIN_L_MAX / PROB_CHAIN_REL_ERR) - np.log1p(-tdd_max_p)
    for k in range(1, n_passes):
        if -chain_log[:, k:n_passes].max() >= need:
            return k
    return n_passes


def prepare_p7_device_prob(p7: P7Profile, m_pad: int | None = None):
    """``(modds_t, iodds_t, trans_probs_t, chain_prod_t, tr_consts_prob)`` of
    ``pallas_p7.prepare_p7_device_prob``: odds ratios and probabilities, 0
    padded; the chain array has ``pick_prob_chain_window`` columns."""
    mr = p7.num_states
    m_pad = m_pad or default_m_pad(p7)
    with np.errstate(over="ignore"):
        modds = np.exp(p7.msc.T.astype(np.float64)).astype(np.float32)
        iodds = np.exp(p7.isc.T.astype(np.float64)).astype(np.float32)
        tprob = [
            np.exp(v.astype(np.float64)).astype(np.float32)
            for v in (p7.tmm, p7.tmi, p7.tmd, p7.tim, p7.tii, p7.tdm)
        ]
        tdd_p = np.exp(p7.tdd.astype(np.float64)).astype(np.float32)

    modds_t = np.zeros((m_pad, 20), dtype=np.float32)
    modds_t[:mr] = modds
    iodds_t = np.zeros((m_pad, 20), dtype=np.float32)
    iodds_t[:mr] = iodds
    trans_t = np.zeros((m_pad, 8), dtype=np.float32)
    for col, vec in enumerate(tprob):
        trans_t[:mr, col] = vec

    window = pick_prob_chain_window(p7, m_pad)
    chain_t = np.zeros((m_pad, window), dtype=np.float32)
    rows = np.arange(m_pad)
    c_cur = np.zeros(m_pad, dtype=np.float32)
    c_cur[1:mr] = tdd_p[: mr - 1]
    for k in range(window):
        s = 1 << k
        chain_t[:, k] = np.where(rows < s, np.float32(0.0), c_cur)
        c_cur = (c_cur * np.where(rows < s, np.float32(1.0), np.roll(c_cur, s))).astype(
            np.float32
        )

    tr_consts = np.exp(
        np.array([[p7.tr_B_Mk, p7.tr_E_C, p7.tr_E_J]], dtype=np.float64)
    ).astype(np.float32)
    return modds_t, iodds_t, trans_t, chain_t, tr_consts


def _f32_up(x64: np.ndarray) -> np.ndarray:
    """Round f64 values to f32 toward +inf; -inf stays (``pallas_p7._f32_up``)."""
    y = x64.astype(np.float32)
    below = y.astype(np.float64) < x64
    bumped = np.nextafter(y, np.float32(np.inf), dtype=np.float32)
    return np.where(below, bumped, y).astype(np.float32)


def pick_filter_window(p7: P7Profile, m_pad: int) -> int:
    """Smallest chain window K whose tail penalty 2^K * |max(tdd)| reaches
    FILTER_TAIL_DAMP_NATS (``pallas_p7.pick_filter_window``)."""
    full_passes = chain_passes(m_pad)
    finite = p7.tdd[np.isfinite(p7.tdd)]
    tdd_max = float(finite.max()) if finite.size else float(NEG_INF)
    if tdd_max >= 0.0 or not np.isfinite(tdd_max):
        return full_passes
    need = FILTER_TAIL_DAMP_NATS / -tdd_max
    return int(np.clip(np.ceil(np.log2(max(need, 1.0))), 1, full_passes))


def prepare_p7_device_filter(
    p7: P7Profile, m_pad: int | None = None, window_log2: int | None = None
):
    """``(msc_bf, isc_bf, trans_t, chain_t, tr_consts4, window, e_skip_d)``
    of ``pallas_p7.prepare_p7_device_filter``, the emissions as bf16 bits
    (uint16): emissions rounded up to bf16, chain constants from one-ulp
    bumped tdd links with f64 window sums rounded up to f32 (only
    ``window`` columns live), and ``aux = 2^window * max(tdd)`` rounded up
    in ``tr_consts4[0, 3]`` when the window truncates the chain (else
    -inf). Every score of the filter is then >= the exact Viterbi score."""
    mr = p7.num_states
    m_pad = m_pad or default_m_pad(p7)
    msc_t, isc_t, trans_t, _, _ = prepare_p7_device(p7, m_pad)
    msc_bf = bf16_round_up(msc_t)
    isc_bf = bf16_round_up(isc_t)

    tdd_s = np.concatenate(([np.float32(NEG_INF)], p7.tdd[:-1]))
    tdd_up = f32_round_up(tdd_s)
    finite = tdd_up[np.isfinite(tdd_up)]
    tdd_max = float(finite.max()) if finite.size else float(NEG_INF)

    full_passes = chain_passes(m_pad)
    if window_log2 is None:
        window_log2 = pick_filter_window(p7, m_pad)
    window = min(max(window_log2, 1), full_passes)
    if tdd_max > 0.0:
        # a tdd > 0 breaks the geometric tail bound: the full chain
        window = full_passes
    aux = (
        _f32_up(np.float64(tdd_max) * (1 << window))
        if window < full_passes
        else np.float32(NEG_INF)
    )

    chain_t = np.full((m_pad, 16), NEG_INF, dtype=np.float32)
    rows = np.arange(m_pad)
    c_cur = np.full(m_pad, -np.inf, dtype=np.float64)
    c_cur[:mr] = tdd_up[:mr].astype(np.float64)
    with np.errstate(invalid="ignore"):
        for k in range(window):
            s = 1 << k
            chain_t[:, k] = np.where(rows < s, np.float32(NEG_INF), _f32_up(c_cur))
            rolled = np.roll(c_cur, s)
            c_cur = c_cur + np.where(rows < s, 0.0, rolled)

    tr_consts = np.array([[p7.tr_B_Mk, p7.tr_E_C, p7.tr_E_J, aux]], dtype=np.float32)
    return msc_bf, isc_bf, trans_t, chain_t, tr_consts, window, e_skip_d_ok(p7)


def length_transition_probs(lengths: np.ndarray) -> np.ndarray:
    """``[2, B]`` p_loop = L/(L+3), p_move = 3/(L+3), each the correctly
    rounded float32 of the f64 quotient (no log/exp round trip)."""
    lengths = np.asarray(lengths, dtype=np.float64)
    p_loop = lengths / (lengths + 3.0)
    p_move = 3.0 / (lengths + 3.0)
    return np.stack([p_loop, p_move]).astype(np.float32)


# -- the port's packs and carries ------------------------------------------

class P7Pack(NamedTuple):
    """One profile's constants on a device, in the port's layout."""

    emit_m: torch.Tensor  # [20, M_pad]
    emit_i: torch.Tensor  # [20, M_pad]
    trans: torch.Tensor  # [8, M_pad]
    chain: torch.Tensor  # [16 | W, M_pad]
    consts: torch.Tensor  # [3] | [5]
    lazy_k: int  # the lazy kernel's window; 0 for the eager and Forward packs

    @property
    def m_pad(self) -> int:
        return self.emit_m.shape[1]


def _rows(x, device) -> torch.Tensor:
    """A host packer's ``[M_pad, k]`` f32 array as ``[k, M_pad]`` on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)).to(device)


def _flat(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32).reshape(-1).copy()).to(device)


def device_pack(msc_t, isc_t, trans_t, chain_t, consts, device, lazy_k: int = 0) -> P7Pack:
    """The port's pack from a host packer's ``[M_pad, …]`` arrays."""
    return P7Pack(
        _rows(msc_t, device), _rows(isc_t, device), _rows(trans_t, device),
        _rows(chain_t, device), _flat(consts, device), int(lazy_k),
    )


def viterbi_pack(p7: P7Profile, device, lazy: bool, lazy_k: int | None = None) -> P7Pack:
    """The lazy kernel's pack (window ``lazy_k``, auto-picked when None) or
    the eager kernel's."""
    if lazy:
        *arrays, k = prepare_p7_device_lazy(p7, lazy_k=lazy_k)
        return device_pack(*arrays, device=device, lazy_k=k)
    return device_pack(*prepare_p7_device(p7), device=device)


def forward_pack(p7: P7Profile, device) -> P7Pack:
    return device_pack(*prepare_p7_device_prob(p7), device=device)


class P7FilterPack(NamedTuple):
    """The Viterbi filter's constants on a device, in the port's layout."""

    emit_m: torch.Tensor  # [20, M_pad] bf16, rounded up
    emit_i: torch.Tensor  # [20, M_pad] bf16, rounded up
    trans: torch.Tensor  # [8, M_pad] f32
    chain: torch.Tensor  # [16, M_pad] f32, rows >= window unused
    consts: torch.Tensor  # [4]: tr_B_Mk, tr_E_C, tr_E_J, aux
    window: int  # chain passes run
    e_skip_d: bool  # E = max(M) (every finite tmd, tdd <= 0)

    @property
    def m_pad(self) -> int:
        return self.emit_m.shape[1]


def filter_device_pack(msc_bf, isc_bf, trans_t, chain_t, consts, window, e_skip_d,
                       device) -> P7FilterPack:
    """The port's filter pack from :func:`prepare_p7_device_filter`'s (or
    the JAX packer's) ``[M_pad, …]`` arrays."""

    def bf16_rows(x):
        return bf16_tensor(np.asarray(x).view(np.uint16).T, device)

    return P7FilterPack(bf16_rows(msc_bf), bf16_rows(isc_bf), _rows(trans_t, device),
                        _rows(chain_t, device), _flat(consts, device), int(window),
                        bool(e_skip_d))


def filter_pack(p7: P7Profile, device, window_log2: int | None = None) -> P7FilterPack:
    """The Viterbi filter's pack; ``window_log2`` None auto-picks the window
    (:func:`pick_filter_window`)."""
    return filter_device_pack(*prepare_p7_device_filter(p7, window_log2=window_log2),
                              device=device)


def viterbi_init_carry(tr_rows: torch.Tensor, m_pad: int):
    """Row-0 carry: M = I = D = J = C = -inf, N = 0, B = tr_move."""
    b_pad = tr_rows.shape[1]
    core = torch.full((b_pad, m_pad), NEG_INF, dtype=torch.float32, device=tr_rows.device)
    s = torch.stack([
        torch.full_like(tr_rows[1], NEG_INF),
        torch.full_like(tr_rows[1], NEG_INF),
        torch.zeros_like(tr_rows[1]),
        tr_rows[1],
    ])
    return core, core.clone(), core.clone(), s


def forward_init_carry(tr_probs: torch.Tensor, m_pad: int):
    """Row-0 carry in probability space: M = I = D = J = C = 0, N = 1,
    B = p_move, log scale and its compensation 0."""
    b_pad = tr_probs.shape[1]
    core = torch.zeros((b_pad, m_pad), dtype=torch.float32, device=tr_probs.device)
    s = torch.zeros((8, b_pad), dtype=torch.float32, device=tr_probs.device)
    s[2] = 1.0
    s[3] = tr_probs[1]
    return core, core.clone(), core.clone(), s


# -- the plain versions ----------------------------------------------------

def _shift(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """``out[:, j] = x[:, j - s]``, ``fill`` where j < s."""
    b, m = x.shape
    if s >= m:
        return torch.full_like(x, fill)
    return torch.cat([torch.full((b, s), fill, dtype=x.dtype, device=x.device), x[:, :-s]], dim=1)


def _max_chain(a: torch.Tensor, chain: torch.Tensor, passes: int,
               combine=torch.maximum) -> torch.Tensor:
    """Hillis-Steele delete chain, ``passes`` passes in the order of
    ``_p7_kernel``, in the max-plus semiring (or ``combine``'s): rows
    j < 2^k hold -inf constants, so a shifted-in -inf leaves them as they
    are, as the TPU's wrapped roll does."""
    for k in range(passes):
        a = combine(a, _shift(a, 1 << k, NEG_INF) + chain[k])
    return a


def _emissions(emit: torch.Tensor, tokens: torch.Tensor, t: int) -> torch.Tensor:
    # clamp: PAD_TOKEN must not index a row (its steps are frozen)
    return emit[tokens[:, t].long().clamp(0, NUM_AA - 1)]


def _specials(e, st_j, st_c, st_n, tr_loop, tr_move, tr_e_c, tr_e_j, combine=torch.maximum):
    new_j = combine(st_j + tr_loop, e + tr_e_j)
    new_c = combine(st_c + tr_loop, e + tr_e_c)
    new_n = st_n + tr_loop
    new_b = combine(new_n + tr_move, new_j + tr_move)
    return new_j, new_c, new_n, new_b


def _lse2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """logaddexp as ``pallas_p7._lse2``: mx + log1p(exp(min - mx)), with
    (-inf, -inf) giving -inf, never NaN."""
    mx = torch.maximum(x, y)
    d = torch.minimum(x, y) - mx
    return torch.where(torch.isnan(d), mx, mx + torch.log1p(torch.exp(d)))


def _lse_reduce(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the states (dim 1) as ``pallas_p7._lse_reduce0``: a
    max, then exp(x - max) summed, where x == max contributes exp(0) (an
    all -inf row stays -inf)."""
    mx = x.amax(dim=1, keepdim=True)
    sub = torch.where(x == mx, torch.zeros_like(x), x - mx)
    return (mx + torch.log(torch.exp(sub).sum(dim=1, keepdim=True)))[:, 0]


def _freeze(valid, new, old):
    return tuple(
        torch.where(valid[:, None] if n.dim() == 2 else valid, n, o)
        for n, o in zip(new, old)
    )


def _num_steps(tokens: torch.Tensor, lengths: torch.Tensor) -> int:
    return min(tokens.shape[1], int(lengths.max())) if tokens.shape[0] else 0


def _semiring_scan(combine, reduce, msc, isc, trans, chain, tokens, lengths, tr_rows, consts,
                   m, i, d, s):
    """``_p7_kernel``'s scan in the semiring of ``combine`` (max or
    logaddexp) with E = ``reduce(combine(M, D))`` over the states."""
    n_passes = chain_passes(msc.shape[1])
    tmm, tmi, tmd, tim, tii, tdm = trans[:6]
    tr_loop, tr_move = tr_rows[0], tr_rows[1]
    tr_b_mk, tr_e_c, tr_e_j = consts[0], consts[1], consts[2]
    st = tuple(s)
    lengths = lengths.long()
    for t in range(_num_steps(tokens, lengths)):
        st_j, st_c, st_n, st_b = st
        diag = _shift(combine(combine(m + tmm, i + tim), d + tdm), 1, NEG_INF)
        new_m = _emissions(msc, tokens, t) + combine(diag, (st_b + tr_b_mk)[:, None])
        new_i = _emissions(isc, tokens, t) + combine(m + tmi, i + tii)
        new_d = _max_chain(_shift(new_m + tmd, 1, NEG_INF), chain, n_passes, combine)
        e = reduce(combine(new_m, new_d))
        new_s = _specials(e, st_j, st_c, st_n, tr_loop, tr_move, tr_e_c, tr_e_j, combine)
        m, i, d, *st = _freeze(t < lengths, (new_m, new_i, new_d, *new_s), (m, i, d, *st))
    return st[1] + tr_move, m.clone(), i.clone(), d.clone(), torch.stack(list(st))


def viterbi_scan_plain(msc, isc, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s):
    """The eager Viterbi scan in plain PyTorch; same arguments and results
    as :func:`viterbi_scan`. Every float32 operation is a max or one add
    with the operands of ``_p7_kernel``'s Viterbi mode, so the scores equal
    the JAX kernel's bit for bit. E takes the max over M and D; when
    ``e_skip_d_ok`` holds that is max(M) exactly, as ``e_skip_d`` assumes."""
    return _semiring_scan(torch.maximum, lambda x: x.amax(dim=1), msc, isc, trans, chain,
                          tokens, lengths, tr_rows, consts, m, i, d, s)


def forward_log_scan_plain(msc, isc, trans, chain, tokens, lengths, tr_rows, consts,
                           m, i, d, s):
    """The log-space Forward scan in plain PyTorch; same arguments and
    results as :func:`forward_log_scan`. It is :func:`viterbi_scan_plain`
    in the (logsumexp, +) semiring of ``_p7_kernel(forward=True)``: every
    max becomes :func:`_lse2` and E is :func:`_lse_reduce` over
    ``_lse2(M, D)``."""
    return _semiring_scan(_lse2, _lse_reduce, msc, isc, trans, chain, tokens, lengths, tr_rows,
                          consts, m, i, d, s)


def viterbi_filter_scan_plain(msc, isc, trans, chain, tokens, lengths, tr_rows, consts,
                              m, i, d, s, window, e_skip_d):
    """The Viterbi filter in plain PyTorch; same arguments and results as
    :func:`viterbi_filter_scan`. It follows ``_p7_filter_kernel``: the bf16
    emissions widened to f32 (exact), ``window`` chain passes and, when
    they truncate the chain, ``D = max(D, max_j(a0_j) + aux)`` on every row
    (a0 the row entering the chain; its max over all rows is the max of
    ``M + tmd``, as the TPU's roll only permutes it). E is max(M) with
    ``e_skip_d``, else max over M and D."""
    m_pad = msc.shape[1]
    full = chain_passes(m_pad)
    passes = min(max(int(window), 1), full)
    msc, isc = msc.float(), isc.float()
    tmm, tmi, tmd, tim, tii, tdm = trans[:6]
    tr_loop, tr_move = tr_rows[0], tr_rows[1]
    tr_b_mk, tr_e_c, tr_e_j, aux = consts[0], consts[1], consts[2], consts[3]
    st = tuple(s)
    lengths = lengths.long()
    for t in range(_num_steps(tokens, lengths)):
        st_j, st_c, st_n, st_b = st
        diag = _shift(torch.maximum(torch.maximum(m + tmm, i + tim), d + tdm), 1, NEG_INF)
        new_m = _emissions(msc, tokens, t) + torch.maximum(diag, (st_b + tr_b_mk)[:, None])
        new_i = _emissions(isc, tokens, t) + torch.maximum(m + tmi, i + tii)
        to_d = new_m + tmd
        new_d = _max_chain(_shift(to_d, 1, NEG_INF), chain, passes)
        if passes < full:
            new_d = torch.maximum(new_d, (to_d.amax(dim=1) + aux)[:, None])
        e = (new_m if e_skip_d else torch.maximum(new_m, new_d)).amax(dim=1)
        new_s = _specials(e, st_j, st_c, st_n, tr_loop, tr_move, tr_e_c, tr_e_j)
        m, i, d, *st = _freeze(t < lengths, (new_m, new_i, new_d, *new_s), (m, i, d, *st))
    return st[1] + tr_move, m.clone(), i.clone(), d.clone(), torch.stack(list(st))


def _lazy_chunk(msc, isc, trans, chain, tokens, lengths, tr_rows, consts, carry,
                t0, t1, passes, certify):
    """Steps ``t0..t1-1`` of the lazy schedule from ``carry`` = (m, i, pd,
    J, C, N, B); with ``certify``, also each sequence's certificate fire
    over its valid steps."""
    tmm, tmi, tmd, tim, tii, tdm = trans[:6]
    tr_loop, tr_move = tr_rows[0], tr_rows[1]
    tr_b_mk, tr_e_c, tr_e_j, tmd_max = consts[0], consts[1], consts[2], consts[4]
    cmax = chain[15]
    m, i, pd, *st = carry
    fired = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    for t in range(t0, t1):
        st_j, st_c, st_n, st_b = st
        new_m = _emissions(msc, tokens, t) + torch.maximum(
            _shift(pd, 1, NEG_INF), (st_b + tr_b_mk)[:, None]
        )
        new_i = _emissions(isc, tokens, t) + torch.maximum(m + tmi, i + tii)
        a = _max_chain(_shift(new_m + tmd, 1, NEG_INF), chain, passes)
        e = new_m.amax(dim=1)  # exact under e_skip_d_ok
        new_pd = torch.maximum(torch.maximum(new_m + tmm, new_i + tim), a + tdm)
        valid = t < lengths
        if certify:
            # the bound's own rounding path: ((e + tmd_max) + Cmax) + tdm
            t_row = ((e + tmd_max)[:, None] + cmax) + tdm
            fired |= (t_row > new_pd).any(dim=1) & valid
        new_s = _specials(e, st_j, st_c, st_n, tr_loop, tr_move, tr_e_c, tr_e_j)
        m, i, pd, *st = _freeze(valid, (new_m, new_i, new_pd, *new_s), (m, i, pd, *st))
    return (m, i, pd, *st), fired


def viterbi_lazy_scan_plain(msc, isc, trans, chain, tokens, lengths, tr_rows, consts,
                            m, i, d, s, lazy_k):
    """The lazy Viterbi scan in plain PyTorch; same arguments and results
    as :func:`viterbi_lazy_scan`. Each LAZY_CHUNK of residues runs
    ``lazy_k`` chain passes and checks, per row and step, ``t_row > new_pd``
    with ``t_row = ((E + tmd_max) + Cmax) + tdm``; a sequence whose
    certificate fired anywhere in the chunk replays the chunk from its entry
    state with the full chain. Equals :func:`viterbi_scan_plain` bit for
    bit (the ``d`` slot then holds its ``pre_diag``)."""
    n_passes = chain_passes(msc.shape[1])
    k_run = min(max(int(lazy_k), 1), n_passes)
    args = (msc, isc, trans, chain, tokens, lengths.long(), tr_rows, consts)
    carry = (m, i, d, *s)
    replays = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    steps = _num_steps(tokens, lengths)
    for t0 in range(0, steps, LAZY_CHUNK):
        t1 = min(t0 + LAZY_CHUNK, steps)
        if k_run >= n_passes:
            carry, _ = _lazy_chunk(*args, carry, t0, t1, n_passes, False)
            continue
        lazy, fired = _lazy_chunk(*args, carry, t0, t1, k_run, True)
        if bool(fired.any()):
            full, _ = _lazy_chunk(*args, carry, t0, t1, n_passes, False)
            lazy = _freeze(fired, full, lazy)
            replays += fired.int()
        carry = lazy
    m, i, d, *st = carry
    return st[1] + tr_rows[1], m.clone(), i.clone(), d.clone(), torch.stack(list(st)), replays


def forward_prob_scan_plain(modds, iodds, trans, chain, tokens, lengths, tr_rows,
                            tr_probs, consts, m, i, d, s):
    """The probability-space Forward scan in plain PyTorch; same arguments
    and results as :func:`forward_prob_scan`. It follows
    ``_fwd_prob_kernel``: odds ratios and transition probabilities, the
    ``W``-pass window of ``chain`` products, the host-exact p_loop/p_move of
    ``tr_probs``, and after every FWD_RESCALE_GROUP residues of a sequence a
    rescale by ``max(max(M), C, N, 1e-30)`` with the Kahan-compensated log
    scale. The score is ``log C + log_scale + tr_move``."""
    return forward_rows_plain(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                              consts, m, i, d, s, save=False)


def forward_rows_plain(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                       consts, m, i, d, s, save: bool):
    """:func:`forward_prob_scan_plain`; with ``save``, its results and
    ``fm`` bf16 ``[B_pad, L_pad, M_pad]`` (each step's scaled M row, round to
    nearest, 0 at and past the length) and ``ls`` f32 ``[B_pad, L_pad]``
    (the log scale in effect for that row, 0 past the length)."""
    b_pad, l_pad = tokens.shape
    if save:
        fm = torch.zeros((b_pad, l_pad, modds.shape[1]), dtype=torch.bfloat16,
                         device=tokens.device)
        ls = torch.zeros((b_pad, l_pad), dtype=torch.float32, device=tokens.device)
    tmm, tmi, tmd, tim, tii, tdm = trans[:6]
    p_loop, p_move = tr_probs[0], tr_probs[1]
    p_b_mk, p_e_c, p_e_j = consts[0], consts[1], consts[2]
    st = tuple(s[:6])
    lengths = lengths.long()
    for t in range(_num_steps(tokens, lengths)):
        st_j, st_c, st_n, st_b, log_scale, comp = st
        diag = _shift(m * tmm + i * tim + d * tdm, 1, 0.0)
        new_m = _emissions(modds, tokens, t) * (diag + (st_b * p_b_mk)[:, None])
        new_i = _emissions(iodds, tokens, t) * (m * tmi + i * tii)
        a = _shift(new_m * tmd, 1, 0.0)
        for k in range(chain.shape[0]):
            a = a + _shift(a, 1 << k, 0.0) * chain[k]
        valid = t < lengths
        if save:
            fm[:, t] = torch.where(valid[:, None], new_m, 0.0).to(torch.bfloat16)
            ls[:, t] = torch.where(valid, log_scale, 0.0)
        e = (new_m + a).sum(dim=1)
        new_j = st_j * p_loop + e * p_e_j
        new_c = st_c * p_loop + e * p_e_c
        new_n = st_n * p_loop
        new_b = new_n * p_move + new_j * p_move
        m, i, d, st_j, st_c, st_n, st_b = _freeze(
            valid, (new_m, new_i, a, new_j, new_c, new_n, new_b),
            (m, i, d, st_j, st_c, st_n, st_b),
        )
        if (t + 1) % FWD_RESCALE_GROUP == 0:
            scale = torch.maximum(
                torch.maximum(m.amax(dim=1), st_c), torch.clamp(st_n, min=1e-30)
            )
            inv = 1.0 / scale
            y = torch.log(scale) - comp
            t_sum = log_scale + y
            new = (m * inv[:, None], i * inv[:, None], d * inv[:, None], st_j * inv,
                   st_c * inv, st_n * inv, st_b * inv, t_sum, (t_sum - log_scale) - y)
            m, i, d, st_j, st_c, st_n, st_b, log_scale, comp = _freeze(
                valid, new, (m, i, d, st_j, st_c, st_n, st_b, log_scale, comp)
            )
        st = (st_j, st_c, st_n, st_b, log_scale, comp)
    score = torch.log(st[1]) + st[4] + tr_rows[1]
    out = (score, m.clone(), i.clone(), d.clone(), torch.cat([torch.stack(list(st)), s[6:]]))
    return (*out, fm, ls) if save else out


# -- the kernels -----------------------------------------------------------

@functools.cache
def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library()
    p = ctypes.c_void_p
    c = ctypes.c_int
    # each launcher ends with: scratch, b_pad, groups, grid, smem, stream
    tail = [p, c, c, c, c, p]
    lib.p7_viterbi_launch.argtypes = [
        c, c, c, c, p, p, p, p, c, c, c, c, c, p, c, p, p, p, p, p, p, p, p, p, p, p, p, p,
        *tail,
    ]
    lib.p7_forward_launch.argtypes = [
        c, c, c, p, p, p, p, c, c, c, c, c, p, c, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
        p, *tail,
    ]
    lib.p7_forward_log_launch.argtypes = [
        c, c, c, p, p, p, p, c, c, c, c, p, c, p, p, p, p, p, p, p, p, p, p, p, p, *tail,
    ]
    lib.p7_filter_launch.argtypes = [
        c, c, c, p, p, p, p, c, c, c, c, c, c, p, c, p, p, p, p, p, p, p, p, p, p, p, p,
        *tail,
    ]
    lib.p7_backward_launch.argtypes = [
        c, c, c, p, p, p, p, c, c, c, c, c, p, c, p, p, p, p, p, p, p, *tail,
    ]
    regs = ctypes.POINTER(c)
    lib.p7_viterbi_regs.argtypes = [c, c, c, regs]
    lib.p7_forward_log_regs.argtypes = [c, c, regs]
    lib.p7_forward_regs.argtypes = [c, c, c, regs]
    lib.p7_filter_regs.argtypes = [c, c, regs]
    lib.p7_backward_regs.argtypes = [c, c, regs]
    for fn in (lib.p7_viterbi_launch, lib.p7_forward_launch, lib.p7_forward_log_launch,
               lib.p7_filter_launch, lib.p7_backward_launch, lib.p7_viterbi_regs,
               lib.p7_forward_log_regs, lib.p7_forward_regs, lib.p7_filter_regs,
               lib.p7_backward_regs):
        fn.restype = c
    lib.msv_error_string.argtypes = [c]
    lib.msv_error_string.restype = ctypes.c_char_p
    return lib


def kernel_case(m_pad: int) -> tuple[int, int]:
    """``(threads, per)``: the kernel case of ``m_pad`` states, KERNEL_THREADS
    threads a sequence up to MAX_GROUP_STATES and WIDE_THREADS up to
    MAX_WIDE_STATES, each thread holding ``per`` states in registers; past
    that the rows-in-memory case, MEM_THREADS threads walking ``per`` tiles
    of MEM_THREADS states. Raises ``ValueError`` past MAX_KERNEL_STATES."""
    if m_pad <= MAX_GROUP_STATES:
        return KERNEL_THREADS, max(-(-m_pad // KERNEL_THREADS), 1)
    if m_pad <= MAX_WIDE_STATES:
        return WIDE_THREADS, -(-m_pad // WIDE_THREADS)
    if m_pad <= MAX_KERNEL_STATES:
        return MEM_THREADS, -(-m_pad // MEM_THREADS)
    raise ValueError(
        f"M_pad = {m_pad} exceeds the p7 kernels' limit of {MAX_KERNEL_STATES} "
        f"states (the delete chain's 16 rows)"
    )


def kernel_per(m_pad: int) -> int:
    """States per thread for ``m_pad`` states (:func:`kernel_case`)."""
    return kernel_case(m_pad)[1]


def blocked_stride(per: int) -> int:
    """Floats between two threads' slots in a shared row of the blocked
    kernels: ``per`` rounded up to odd, so a warp's 32 reads of one slot hit
    32 banks."""
    return per | 1


def bf16_stride(per: int) -> int:
    """Halfwords between two threads' slots in a bf16 shared row (the
    Viterbi filter's emissions, ``csrc/p7_blocked.cuh::hstride``): ``per``
    when odd (the global row's contiguous copy), else twice an odd number of
    32-bit words."""
    return per if per % 2 else 2 * ((per // 2) | 1)


def blocked_smem_bytes(per: int, n_rows: int, groups: int, save: bool = False,
                       threads: int = KERNEL_THREADS, bf16: bool = False,
                       backward: bool = False) -> int:
    """Dynamic shared memory of a blocked kernel's block
    (``csrc/p7_blocked.cuh::smem_floats``): ``n_rows`` staged rows, then
    per group two shift rows, four emission rows (f32, or with ``bf16`` the
    filter's bf16 rows), the reduction scratch (two floats a warp), the
    token chunk (int8) and, for the row-saving Forward, two bf16 rows. With
    ``backward``, the backward pass's group (``backward_group_floats``): two
    shift rows, four f32 odds rows, two bf16 saved rows, three floats a
    warp, the token chunk and the chunk's log scales and coverage."""
    row = threads * blocked_stride(per)
    hrow = threads * bf16_stride(per) // 2
    if backward:
        group = 6 * row + 2 * hrow + 3 * (threads // 32) + LAZY_CHUNK // 4 + 2 * LAZY_CHUNK
    else:
        erow = hrow if bf16 else row
        group = 2 * row + 4 * erow + 2 * (threads // 32) + LAZY_CHUNK // 4 + (row if save else 0)
    return 4 * (n_rows * row + groups * group)


class LaunchPlan(NamedTuple):
    """How a blocked kernel launches: ``groups`` sequences a block (groups
    of ``threads`` threads), ``grid`` blocks walking the batch with a
    stride, ``n_chain`` chain rows and ``n_trans`` transition rows staged in
    shared memory (the rest read from global memory) and ``smem`` bytes of
    dynamic shared memory; ``max_groups`` is the most that fit. The
    rows-in-memory case (``threads`` MEM_THREADS) stages nothing: one group
    a block, no dynamic shared memory, MEM_ROWS scratch rows a block."""

    groups: int
    grid: int
    n_chain: int
    smem: int
    max_groups: int
    threads: int = KERNEL_THREADS
    n_trans: int = TRANS_ROWS


def plan_launch(kind: str, m_pad: int, passes: int, b_pad: int, regs: int, sms: int,
                groups: int | None = None) -> LaunchPlan:
    """The launch plan of a blocked kernel case (``kind`` one of
    BLOCKED_KINDS) that runs ``passes`` chain passes a step (the eager and
    log-space kernels all of ``chain_passes(m_pad)``, the lazy one and the
    filter their window, Forward its W) over ``b_pad`` sequences, with
    ``regs`` registers a thread on a card of ``sms`` multiprocessors.

    Every transition row and every chain row the case runs is staged unless
    that leaves no room for one group: then the last chain rows, and after
    them (only at WIDE_THREADS) the last transition rows, stay in global
    memory. ``groups`` None picks 1 for a batch no larger than ``sms`` (a
    survivor batch runs one sequence an SM, at one step's latency), else
    as many as registers, shared memory (at most SMEM_PER_SM bytes a block)
    and MAX_BLOCK_THREADS allow, but no more than ``ceil(b_pad / sms)``; a
    given ``groups`` must fit. Past MAX_WIDE_STATES the rows-in-memory case
    runs one sequence a block, as many blocks as registers and
    THREADS_PER_SM let an SM hold. Raises ``ValueError`` past M_pad
    65536."""
    if kind not in BLOCKED_KINDS:
        raise ValueError(f"unknown blocked kernel case {kind!r}")
    kt, per = kernel_case(m_pad)
    if not 1 <= passes <= chain_passes(m_pad):
        raise ValueError(f"{passes} chain passes outside 1..{chain_passes(m_pad)}")
    warp_regs = round_up(max(int(regs), 1), 8) * 32  # allocated by the warp, 8 at a time
    if kt == MEM_THREADS:
        if groups not in (None, 1):
            raise ValueError(f"{groups} groups a block: the rows-in-memory case takes 1")
        per_sm = max(1, min(REGS_PER_SM // (warp_regs * MEM_THREADS // 32),
                            THREADS_PER_SM // MEM_THREADS))
        return LaunchPlan(1, max(1, min(b_pad, sms * per_sm)), 0, 0, 1, MEM_THREADS, 0)
    extra = 1 if kind == "lazy" and passes < chain_passes(m_pad) else 0
    save = kind == "save"
    bf16 = kind == "filter"
    backward = kind == "backward"

    def smem(n_trans, n_chain, g):
        return blocked_smem_bytes(per, n_trans + n_chain + extra, g, save, kt, bf16, backward)

    n_trans, n_chain = TRANS_ROWS, passes
    while n_chain > 0 and smem(n_trans, n_chain, 1) > SMEM_PER_SM:
        n_chain -= 1
    while n_trans > 0 and smem(n_trans, n_chain, 1) > SMEM_PER_SM:
        n_trans -= 1
    bounded = backward and kt == KERNEL_THREADS and per in BACKWARD_BOUNDED_PER
    block_threads = BOUNDED_THREADS if bounded else MAX_BLOCK_THREADS
    by_regs = REGS_PER_SM // (warp_regs * (kt // 32))
    by_smem = 0
    while (by_smem + 1) * kt <= block_threads and smem(n_trans, n_chain, by_smem + 1) <= SMEM_PER_SM:
        by_smem += 1
    most = min(block_threads // kt, by_regs, by_smem)
    if most < 1:
        raise ValueError(
            f"the {kind} kernel at M_pad = {m_pad} does not fit one group in a block "
            f"({regs} registers a thread, {smem(n_trans, n_chain, 1)} bytes of shared memory)"
        )
    if groups is None:
        groups = 1 if b_pad <= sms else min(most, -(-b_pad // sms))
    elif not 1 <= groups <= most:
        raise ValueError(f"{groups} groups a block: the {kind} kernel takes 1..{most} here")
    nbytes = smem(n_trans, n_chain, groups)
    threads = groups * kt
    per_sm = max(1, min(REGS_PER_SM // (warp_regs * threads // 32),
                        SMEM_PER_SM // nbytes, THREADS_PER_SM // threads))
    grid = max(1, min(-(-b_pad // groups), sms * per_sm))
    return LaunchPlan(groups, grid, n_chain, nbytes, most, kt, n_trans)


@functools.cache
def kernel_regs(kind: str, per: int, threads: int = KERNEL_THREADS) -> int:
    """Registers a thread of the blocked kernel case uses, as compiled."""
    lib = _kernel_library()
    out = ctypes.c_int(0)
    if kind in ("eager", "lazy"):
        rc = lib.p7_viterbi_regs(threads, per, int(kind == "lazy"), ctypes.byref(out))
    elif kind == "log":
        rc = lib.p7_forward_log_regs(threads, per, ctypes.byref(out))
    elif kind == "filter":
        rc = lib.p7_filter_regs(threads, per, ctypes.byref(out))
    elif kind == "backward":
        rc = lib.p7_backward_regs(threads, per, ctypes.byref(out))
    else:
        rc = lib.p7_forward_regs(threads, per, int(kind == "save"), ctypes.byref(out))
    if rc != 0:
        msg = lib.msv_error_string(rc).decode()
        raise RuntimeError(
            f"{kind} kernel ({threads} threads, per {per}) attribute query failed: {msg} ({rc})")
    return out.value


def device_plan(kind: str, m_pad: int, passes: int, b_pad: int, device,
                groups: int | None = None) -> LaunchPlan:
    """:func:`plan_launch` with the compiled case's registers and the
    card's multiprocessors."""
    index = torch.device(device).index or 0
    threads, per = kernel_case(m_pad)
    return plan_launch(kind, m_pad, passes, b_pad, kernel_regs(kind, per, threads),
                       _sm_count(index), groups)


def mem_scratch(plan: LaunchPlan, m_pad: int, device) -> torch.Tensor | None:
    """The rows-in-memory case's scratch rows, ``[grid, MEM_ROWS, M_pad]``
    f32 (uninitialised: the kernel writes each row before it reads it), or
    None for a register case."""
    if plan.threads != MEM_THREADS:
        return None
    return torch.empty((plan.grid, MEM_ROWS, m_pad), dtype=torch.float32, device=device)


def launched(wrapper, plan: LaunchPlan) -> None:
    """Count a launch of ``wrapper``'s kernel on ``plan``: apart for the
    WIDE_THREADS and the rows-in-memory cases."""
    count_launch(wrapper, plan.threads == WIDE_THREADS, plan.threads == MEM_THREADS)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_blocked(emit_m, emit_i, m_pad: int) -> None:
    """What the blocked kernels add to :func:`_check_scan`: M_pad a multiple
    of 8 and 16-byte aligned emission tables (they are copied 16 bytes at a
    time)."""
    if m_pad % 8:
        raise ValueError(f"M_pad = {m_pad} is not a multiple of 8")
    for name, t in (("emit_m", emit_m), ("emit_i", emit_i)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _check_scan(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts,
                n_consts, m, i, d, s, n_specials, emit_dtype=torch.float32):
    device = tokens.device
    if device.type != "cuda":
        raise ValueError(f"the p7 kernels need CUDA tensors, got {device}")
    b_pad, l_pad = tokens.shape
    m_pad = emit_m.shape[1]
    kernel_case(m_pad)
    _check("emit_m", emit_m, emit_dtype, (NUM_AA, m_pad), device)
    _check("emit_i", emit_i, emit_dtype, (NUM_AA, m_pad), device)
    _check("trans", trans, torch.float32, (8, m_pad), device)
    _check("chain", chain, torch.float32, (chain.shape[0], m_pad), device)
    _check("tokens", tokens, torch.int8, (b_pad, l_pad), device)
    _check("lengths", lengths, torch.int32, (b_pad,), device)
    _check("tr_rows", tr_rows, torch.float32, (2, b_pad), device)
    _check("consts", consts, torch.float32, (n_consts,), device)
    for name, t in (("m", m), ("i", i), ("d", d)):
        _check(name, t, torch.float32, (b_pad, m_pad), device)
    _check("s", s, torch.float32, (n_specials, b_pad), device)
    return device, b_pad, l_pad, m_pad


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernel_library().msv_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _viterbi_cuda(lazy, emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts,
                  m, i, d, s, lazy_k, groups):
    device, b_pad, l_pad, m_pad = _check_scan(
        emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts,
        5 if lazy else 3, m, i, d, s, 4,
    )
    if chain.shape[0] != 16:
        raise ValueError(f"chain has {chain.shape[0]} rows, expected 16")
    _check_blocked(emit_m, emit_i, m_pad)
    n_passes = chain_passes(m_pad)
    k_run = min(max(int(lazy_k), 1), n_passes) if lazy else n_passes
    scores = torch.empty(b_pad, dtype=torch.float32, device=device)
    out = (torch.empty_like(m), torch.empty_like(i), torch.empty_like(d), torch.empty_like(s))
    replays = torch.zeros(b_pad, dtype=torch.int32, device=device) if lazy else None
    if b_pad:
        plan = device_plan("lazy" if lazy else "eager", m_pad, k_run, b_pad, device, groups)
        scratch = mem_scratch(plan, m_pad, device)
        rc = _kernel_library().p7_viterbi_launch(
            device.index, plan.threads, kernel_per(m_pad), int(lazy),
            emit_m.data_ptr(), emit_i.data_ptr(), trans.data_ptr(), chain.data_ptr(),
            m_pad, n_passes, k_run, plan.n_chain, plan.n_trans, tokens.data_ptr(), l_pad,
            lengths.data_ptr(),
            tr_rows.data_ptr(), consts.data_ptr(), m.data_ptr(), i.data_ptr(),
            d.data_ptr(), s.data_ptr(), scores.data_ptr(), *(o.data_ptr() for o in out),
            replays.data_ptr() if lazy else None, _ptr(scratch), b_pad, plan.groups, plan.grid,
            plan.smem, torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on(rc, "lazy Viterbi" if lazy else "Viterbi")
        launched(viterbi_lazy_scan_cuda if lazy else viterbi_scan_cuda, plan)
    return (scores, *out, replays) if lazy else (scores, *out)


def viterbi_scan_cuda(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s,
                      groups: int | None = None):
    """Launch the eager kernel of ``csrc/p7_viterbi_kernel.cu``; same
    arguments and results as :func:`viterbi_scan`. ``groups`` sequences a
    block, None for :func:`plan_launch`'s pick. Raises on what the kernel
    does not take and on a refused launch; never falls back."""
    return _viterbi_cuda(False, emit_m, emit_i, trans, chain, tokens, lengths, tr_rows,
                         consts, m, i, d, s, 0, groups)


def viterbi_lazy_scan_cuda(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts,
                           m, i, d, s, lazy_k, groups: int | None = None):
    """Launch the lazy kernel of ``csrc/p7_viterbi_kernel.cu``; same
    arguments and results as :func:`viterbi_lazy_scan`; ``groups`` as for
    :func:`viterbi_scan_cuda`."""
    return _viterbi_cuda(True, emit_m, emit_i, trans, chain, tokens, lengths, tr_rows,
                         consts, m, i, d, s, lazy_k, groups)


def forward_launch(wrapper, modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                   consts, m, i, d, s, save: bool, groups: int | None = None):
    """Check the operands and launch ``csrc/p7_forward_kernel.cu`` (with
    ``save``, its row-saving case, and ``(fm, ls)`` allocated and returned
    after the results) with ``groups`` sequences a block (None: the
    plan's pick); counts the launch on ``wrapper``."""
    device, b_pad, l_pad, m_pad = _check_scan(
        modds, iodds, trans, chain, tokens, lengths, tr_rows, consts, 3, m, i, d, s, 8,
    )
    _check("tr_probs", tr_probs, torch.float32, (2, b_pad), device)
    _check_blocked(modds, iodds, m_pad)
    window = chain.shape[0]
    if not 1 <= window <= chain_passes(m_pad):
        raise ValueError(f"chain window {window} outside 1..{chain_passes(m_pad)}")
    scores = torch.empty(b_pad, dtype=torch.float32, device=device)
    out = (torch.empty_like(m), torch.empty_like(i), torch.empty_like(d), torch.empty_like(s))
    saved = ()
    if save:
        saved = (torch.empty((b_pad, l_pad, m_pad), dtype=torch.bfloat16, device=device),
                 torch.empty((b_pad, l_pad), dtype=torch.float32, device=device))
    saved_ptrs = [x.data_ptr() for x in saved] if save else [None, None]
    if b_pad:
        plan = device_plan("save" if save else "forward", m_pad, window, b_pad, device, groups)
        scratch = mem_scratch(plan, m_pad, device)
        rc = _kernel_library().p7_forward_launch(
            device.index, plan.threads, kernel_per(m_pad), modds.data_ptr(), iodds.data_ptr(),
            trans.data_ptr(), chain.data_ptr(), m_pad, window, plan.n_chain, plan.n_trans,
            FWD_RESCALE_GROUP, tokens.data_ptr(),
            l_pad, lengths.data_ptr(), tr_rows.data_ptr(), tr_probs.data_ptr(),
            consts.data_ptr(), m.data_ptr(), i.data_ptr(), d.data_ptr(), s.data_ptr(),
            scores.data_ptr(), *(o.data_ptr() for o in out), *saved_ptrs, _ptr(scratch), b_pad,
            plan.groups, plan.grid, plan.smem, torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on(rc, "Forward (row-saving)" if save else "Forward")
        launched(wrapper, plan)
    return (scores, *out, *saved)


def forward_prob_scan_cuda(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                           consts, m, i, d, s, groups: int | None = None):
    """Launch ``csrc/p7_forward_kernel.cu``; same arguments and results as
    :func:`forward_prob_scan`; ``groups`` as for :func:`viterbi_scan_cuda`."""
    return forward_launch(forward_prob_scan_cuda, modds, iodds, trans, chain, tokens, lengths,
                          tr_rows, tr_probs, consts, m, i, d, s, save=False, groups=groups)


def forward_log_scan_cuda(msc, isc, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s,
                          groups: int | None = None):
    """Launch ``csrc/p7_forward_log_kernel.cu``; same arguments and results
    as :func:`forward_log_scan`; ``groups`` as for :func:`viterbi_scan_cuda`.
    Raises on what the kernel does not take and on a refused launch; never
    falls back."""
    device, b_pad, l_pad, m_pad = _check_scan(
        msc, isc, trans, chain, tokens, lengths, tr_rows, consts, 3, m, i, d, s, 4,
    )
    if chain.shape[0] != 16:
        raise ValueError(f"chain has {chain.shape[0]} rows, expected 16")
    _check_blocked(msc, isc, m_pad)
    n_passes = chain_passes(m_pad)
    scores = torch.empty(b_pad, dtype=torch.float32, device=device)
    out = (torch.empty_like(m), torch.empty_like(i), torch.empty_like(d), torch.empty_like(s))
    if b_pad:
        plan = device_plan("log", m_pad, n_passes, b_pad, device, groups)
        scratch = mem_scratch(plan, m_pad, device)
        rc = _kernel_library().p7_forward_log_launch(
            device.index, plan.threads, kernel_per(m_pad), msc.data_ptr(), isc.data_ptr(),
            trans.data_ptr(), chain.data_ptr(), m_pad, n_passes, plan.n_chain, plan.n_trans,
            tokens.data_ptr(), l_pad,
            lengths.data_ptr(), tr_rows.data_ptr(), consts.data_ptr(), m.data_ptr(),
            i.data_ptr(), d.data_ptr(), s.data_ptr(), scores.data_ptr(),
            *(o.data_ptr() for o in out), _ptr(scratch), b_pad, plan.groups, plan.grid,
            plan.smem, torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on(rc, "log-space Forward")
        launched(forward_log_scan_cuda, plan)
    return (scores, *out)


def viterbi_filter_scan_cuda(msc, isc, trans, chain, tokens, lengths, tr_rows, consts,
                             m, i, d, s, window, e_skip_d, groups: int | None = None):
    """Launch the filter case of ``csrc/p7_viterbi.cuh`` (built from
    ``csrc/p7_viterbi_filter_kernel.cu``); same arguments and results as
    :func:`viterbi_filter_scan`; ``groups`` as for :func:`viterbi_scan_cuda`.
    Raises on what the kernel does not take and on a refused launch; never
    falls back."""
    device, b_pad, l_pad, m_pad = _check_scan(
        msc, isc, trans, chain, tokens, lengths, tr_rows, consts, 4, m, i, d, s, 4,
        emit_dtype=torch.bfloat16,
    )
    if chain.shape[0] != 16:
        raise ValueError(f"chain has {chain.shape[0]} rows, expected 16")
    _check_blocked(msc, isc, m_pad)
    full = chain_passes(m_pad)
    passes = min(max(int(window), 1), full)
    scores = torch.empty(b_pad, dtype=torch.float32, device=device)
    out = (torch.empty_like(m), torch.empty_like(i), torch.empty_like(d), torch.empty_like(s))
    if b_pad:
        plan = device_plan("filter", m_pad, passes, b_pad, device, groups)
        scratch = mem_scratch(plan, m_pad, device)
        rc = _kernel_library().p7_filter_launch(
            device.index, plan.threads, kernel_per(m_pad), msc.data_ptr(), isc.data_ptr(),
            trans.data_ptr(), chain.data_ptr(), m_pad, full, passes, plan.n_chain, plan.n_trans,
            int(bool(e_skip_d)), tokens.data_ptr(), l_pad, lengths.data_ptr(),
            tr_rows.data_ptr(), consts.data_ptr(), m.data_ptr(), i.data_ptr(), d.data_ptr(),
            s.data_ptr(), scores.data_ptr(), *(o.data_ptr() for o in out), _ptr(scratch), b_pad,
            plan.groups, plan.grid, plan.smem, torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on(rc, "Viterbi filter")
        launched(viterbi_filter_scan_cuda, plan)
    return (scores, *out)


# kernel launches in this process, those of them at WIDE_THREADS and those
# of the rows-in-memory case
for _fn in (viterbi_scan_cuda, viterbi_lazy_scan_cuda, forward_prob_scan_cuda,
            forward_log_scan_cuda, viterbi_filter_scan_cuda):
    _fn.launches = _fn.wide_launches = _fn.mem_launches = 0


def viterbi_scan(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s):
    """Eager Viterbi over a staged batch, threading the DP carry.

    Returns ``(scores [B_pad], m, i, d [B_pad, M_pad], s [4, B_pad])``. CPU
    tensors run :func:`viterbi_scan_plain`; any other device runs the kernel
    (:func:`viterbi_scan_cuda`) or raises."""
    fn = viterbi_scan_plain if tokens.device.type == "cpu" else viterbi_scan_cuda
    return fn(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s)


def viterbi_lazy_scan(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts,
                      m, i, d, s, lazy_k):
    """Lazy exact Viterbi (``consts`` [5], ``chain`` row 15 = Cmax from
    :func:`prepare_p7_device_lazy`); valid only when ``e_skip_d_ok``.

    Returns ``(scores, m, i, pre_diag, s, replays)``: ``replays`` int32
    ``[B_pad]`` counts each sequence's chunks replayed with the full chain.
    CPU tensors run :func:`viterbi_lazy_scan_plain`; any other device the
    kernel (:func:`viterbi_lazy_scan_cuda`) or raises."""
    fn = viterbi_lazy_scan_plain if tokens.device.type == "cpu" else viterbi_lazy_scan_cuda
    return fn(emit_m, emit_i, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s,
              lazy_k)


def forward_prob_scan(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                      consts, m, i, d, s):
    """Probability-space Forward over a staged batch, threading the carry.

    Returns ``(scores [B_pad] in nats, m, i, d [B_pad, M_pad], s [8,
    B_pad])``. CPU tensors run :func:`forward_prob_scan_plain`; any other
    device the kernel (:func:`forward_prob_scan_cuda`) or raises."""
    fn = forward_prob_scan_plain if tokens.device.type == "cpu" else forward_prob_scan_cuda
    return fn(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs, consts,
              m, i, d, s)


def forward_log_scan(msc, isc, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s):
    """Log-space Forward over a staged batch, threading the carry: the
    eager Viterbi pack and carries (:func:`viterbi_pack` with
    ``lazy=False``, :func:`viterbi_init_carry`) in the (logsumexp, +)
    semiring, the full chain of ``chain_passes(M_pad)`` passes.

    Returns ``(scores [B_pad] in nats, m, i, d [B_pad, M_pad], s [4,
    B_pad])``. CPU tensors run :func:`forward_log_scan_plain`; any other
    device the kernel (:func:`forward_log_scan_cuda`) or raises."""
    fn = forward_log_scan_plain if tokens.device.type == "cpu" else forward_log_scan_cuda
    return fn(msc, isc, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s)


def viterbi_filter_scan(msc, isc, trans, chain, tokens, lengths, tr_rows, consts,
                        m, i, d, s, window, e_skip_d):
    """The upper-bound Viterbi filter over a staged batch, threading the
    carry: a :class:`P7FilterPack`'s bf16 ``msc``/``isc``, ``trans``,
    ``chain`` and ``consts`` [4], its ``window`` and ``e_skip_d``. Every
    score is >= the exact Viterbi score of the sequence.

    Returns ``(scores [B_pad], m, i, d [B_pad, M_pad], s [4, B_pad])``. CPU
    tensors run :func:`viterbi_filter_scan_plain`; any other device the
    kernel (:func:`viterbi_filter_scan_cuda`) or raises."""
    fn = viterbi_filter_scan_plain if tokens.device.type == "cpu" else viterbi_filter_scan_cuda
    return fn(msc, isc, trans, chain, tokens, lengths, tr_rows, consts, m, i, d, s, window,
              e_skip_d)
