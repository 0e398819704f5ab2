"""MSV max-plus DP scan: the CUDA kernel's wrappers, their plain PyTorch
versions, and the host packers.

The counterpart of ``hmm_fasta_viterbi_tpu/ops/pallas_msv.py`` (the Pallas
TPU kernel) and of ``ops/xla_scan.py`` with the recurrence of
``ops/recurrence.py``, in the TPU kernel's three modes:

* :func:`msv_scan`: exact, one profile, f32 table;
* :func:`msv_filter_scan`: the filter, one profile, the host's bf16
  round-up of the table (:func:`prepare_scores_t_filter`), every score an
  upper bound on the exact one;
* :func:`msv_stacked_scan`: P profiles of one padded width in one launch,
  f32 (exact) or bf16 (filter) tables, scores only.

The TPU layout is not carried over; the contract is the scores and the DP
carry:

* ``emit`` f32 ``[20, M_pad]``: row ``aa`` holds the emission scores of the
  ``Mr`` real match states (``MSVProfile.scores_real``, not clamped), and
  -inf in the pad columns ``Mr..M_pad-1``, so that a pad state is -inf after
  every step and never wins the E max;
* ``tokens`` int8 ``[B_pad, L_pad]``: one sequence's residues are contiguous;
  steps at or beyond a sequence's length leave its carry unchanged;
* ``lengths`` int32 ``[B_pad]``; ``tr_rows`` f32 ``[2, B_pad]`` (tr_loop,
  tr_move); ``tr_consts`` f32 ``[3]`` (tr_B_Mk, tr_E_C, tr_E_J);
* carries ``m`` f32 ``[B_pad, M_pad]`` and ``s`` f32 ``[4, B_pad]`` (J, C,
  N, B) in, and ``(scores [B_pad], m, s)`` out, as ``msv_pallas_call``
  returns them, so a sequence can be scanned in blocks: the second call
  takes the first's carries, the residues from the split on and the
  lengths less the split, clipped at 0.

The filter's ``emit`` is bf16 ``[20, M_pad]`` (torch.bfloat16) with -inf
pad columns; its carries are the exact scan's. The stacked scan takes
``emit [P, 20, M_pad]`` and ``tr_consts [P, 3]`` and returns ``scores [P,
B_pad]`` from the row-0 carry.

Each scan runs its plain version on CPU tensors and its kernel on CUDA
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.msv import MSVProfile

from . import _build

NEG_INF = float("-inf")
# finite stand-in for -inf in the TPU kernel's padded score rows
# (pallas_msv.PAD_SCORE); the port's own pack keeps -inf
PAD_SCORE = -1.0e30
# padding token outside the 20-letter alphabet (pallas_msv.PAD_TOKEN); it
# fits int8, and no valid step ever uses it
PAD_TOKEN = 127
NUM_AA = 20

# M states per lane of the kernel's register row, one case each in the
# switch of csrc/msv_kernel.cu: a warp holds 32 * PER states. Each is
# 8q + 4 so that a quarter-warp's float4 reads of the table miss each
# other's banks. Past 32 * 76 = 2432 states two warps (64 lanes) follow one
# sequence, at the WIDE_PER cases, up to 64 * 76 = 4864. Past that the
# rows-in-memory case (MEM_LANES threads a sequence, its M rows in global
# memory) takes any width: the kernel has no cap, as the TPU kernel has none.
KERNEL_PER = (4, 12, 20, 28, 36, 44, 52, 60, 68, 76)
WIDE_PER = (44, 52, 60, 68, 76)
MAX_WARP_STATES = 32 * KERNEL_PER[-1]  # 2432 >= 2405, the largest of the 24 profiles
MAX_WIDE_STATES = 64 * WIDE_PER[-1]  # 4864
MEM_LANES = 1024
# blocks of the rows-in-memory case an SM runs at once (2048 threads)
MEM_BLOCKS_PER_SM = 2


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# -- host packers (numpy) --------------------------------------------------

def blank_ragged_tail(tokens_t: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """In place: overwrite each lane's positions >= lengths[lane] of a
    TPU-layout ``[L_pad, B_pad]`` token block with PAD_TOKEN; returns it.

    The numpy counterpart of ``pallas_msv.blank_ragged_tail``, byte for
    byte; ``convert.staged_from_jax`` applies it to a JAX staged database."""
    l_pad = tokens_t.shape[0]
    lengths = np.asarray(lengths, dtype=np.int32)
    tokens_t[np.arange(l_pad, dtype=np.int32)[:, None] >= lengths[None, :]] = (
        PAD_TOKEN
    )
    return tokens_t


def prepare_scores_t(profile: MSVProfile, m_pad: int | None = None) -> np.ndarray:
    """The TPU kernel's score pack, byte for byte (``pallas_msv.
    prepare_scores_t``): ``[M_pad, 20]`` real-state scores, -inf clamped to
    PAD_SCORE and pad rows PAD_SCORE. The port's kernel reads
    :func:`prepare_emit` instead; this is the pack a JAX scanner hands to
    ``convert.device_profile_from_jax``, and the base of the filter's bf16
    round-up (:func:`prepare_scores_t_filter`)."""
    mr = profile.num_states
    m_pad = m_pad or round_up(mr, 8)
    out = np.full((m_pad, NUM_AA), PAD_SCORE, dtype=np.float32)
    # clamp: -inf must not reach the bf16 round-up (PAD_SCORE loses every
    # max as -inf does)
    out[:mr, :] = np.maximum(profile.scores_real.T, PAD_SCORE)
    return out


BF16_NEG_INF = 0xFF80  # the bits of bf16 -inf


def bf16_round_up(f32: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16 toward +inf (every output >= its input), as
    the bits of the bf16 values (uint16), byte for byte those of
    ``pallas_msv.bf16_round_up(...).view(np.uint16)``.

    Round to nearest even on the uint32 view (JAX's cast), then one bf16
    ulp up where that fell below: raw + 1 for a positive value (and +0,
    whose next value up is the smallest subnormal), raw - 1 for a negative
    one. ±inf and -0 are exact and stay; NaN becomes a quiet NaN."""
    f32 = np.ascontiguousarray(f32, dtype=np.float32)
    u = f32.view(np.uint32).astype(np.uint64)
    nearest = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nearest = np.where(np.isnan(f32), (u >> 16).astype(np.uint16) | np.uint16(0x40), nearest)
    widened = (nearest.astype(np.uint32) << 16).view(np.float32)
    bumped = np.where(nearest & 0x8000, nearest - np.uint16(1), nearest + np.uint16(1))
    return np.where(widened < f32, bumped, nearest).astype(np.uint16)


def f32_round_up(x: np.ndarray) -> np.ndarray:
    """Bump finite f32 entries one ulp toward +inf; ±inf stay
    (``pallas_msv.f32_round_up``)."""
    x = np.asarray(x, dtype=np.float32)
    out = np.nextafter(x, np.float32(np.inf), dtype=np.float32)
    return np.where(np.isfinite(x), out, x)


def prepare_scores_t_filter(profile: MSVProfile, m_pad: int | None = None) -> np.ndarray:
    """The TPU filter's ``[M_pad, 20]`` table: :func:`prepare_scores_t`
    rounded up to bf16, as uint16 bits (``pallas_msv.
    prepare_scores_t_filter``). Max-plus DP is monotone in every score, so
    the filter's score bounds the exact one from above."""
    return bf16_round_up(prepare_scores_t(profile, m_pad))


def prepare_emit(scores_real: np.ndarray, m_pad: int) -> np.ndarray:
    """The port's emission pack: ``[20, M_pad]`` f32, ``scores_real`` as the
    oracle has it, -inf in the pad columns."""
    num_aa, mr = scores_real.shape
    if num_aa != NUM_AA or m_pad < mr:
        raise ValueError(f"scores [{num_aa}, {mr}] do not fit [20, {m_pad}]")
    out = np.full((NUM_AA, m_pad), NEG_INF, dtype=np.float32)
    out[:, :mr] = scores_real
    return out


def prepare_emit_filter(scores_t_bits: np.ndarray, num_states: int, m_pad: int) -> np.ndarray:
    """The port's filter pack, ``[20, M_pad]`` bf16 bits: the real rows of
    a TPU filter table (:func:`prepare_scores_t_filter`) transposed, -inf
    in the pad columns."""
    bits = np.asarray(scores_t_bits).view(np.uint16).reshape(-1, NUM_AA)
    if m_pad < num_states or bits.shape[0] < num_states:
        raise ValueError(f"{bits.shape[0]} table rows, {num_states} states, M_pad {m_pad}")
    out = np.full((NUM_AA, m_pad), BF16_NEG_INF, dtype=np.uint16)
    out[:, :num_states] = bits[:num_states].T
    return out


def bf16_tensor(bits: np.ndarray, device) -> torch.Tensor:
    """A torch.bfloat16 tensor on ``device`` holding these bf16 bits."""
    return torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint16).view(np.int16)).view(
        torch.bfloat16).to(device)


def _tr_consts(profile: MSVProfile) -> np.ndarray:
    return np.array([profile.tr_B_Mk, profile.tr_E_C, profile.tr_E_J], dtype=np.float32)


def pack_profile(profile: MSVProfile, m_pad: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(emit [20, M_pad], tr_consts [3])`` of one profile on ``device``."""
    emit = torch.from_numpy(prepare_emit(profile.scores_real, m_pad)).to(device)
    return emit, torch.from_numpy(_tr_consts(profile)).to(device)


def pack_profile_filter(profile: MSVProfile, m_pad: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(emit bf16 [20, M_pad], tr_consts [3])``: the filter's pack of one
    profile on ``device``."""
    bits = prepare_emit_filter(prepare_scores_t_filter(profile), profile.num_states, m_pad)
    return bf16_tensor(bits, device), torch.from_numpy(_tr_consts(profile)).to(device)


def pack_stacked(profiles, m_pad: int, device, filter_mode: bool):
    """``(emit [P, 20, M_pad], tr_consts [P, 3])`` of a profile stack: f32
    tables, or with ``filter_mode`` the filter's bf16 ones."""
    if filter_mode:
        bits = np.stack([
            prepare_emit_filter(prepare_scores_t_filter(p), p.num_states, m_pad)
            for p in profiles
        ])
        emit = bf16_tensor(bits, device)
    else:
        emit = torch.from_numpy(
            np.stack([prepare_emit(p.scores_real, m_pad) for p in profiles])).to(device)
    consts = torch.from_numpy(np.stack([_tr_consts(p) for p in profiles])).to(device)
    return emit, consts


def init_carry(tr_rows: torch.Tensor, m_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-0 carry (MSV_HMM.cpp:96-97): M = J = C = -inf, N = 0, B = tr_move."""
    b_pad = tr_rows.shape[1]
    m = torch.full((b_pad, m_pad), NEG_INF, dtype=torch.float32, device=tr_rows.device)
    s = torch.stack([
        torch.full_like(tr_rows[1], NEG_INF),
        torch.full_like(tr_rows[1], NEG_INF),
        torch.zeros_like(tr_rows[1]),
        tr_rows[1],
    ])
    return m, s


# -- the plain version -----------------------------------------------------

def msv_scan_plain(emit, tokens, lengths, tr_rows, tr_consts, m, s):
    """The scan in plain PyTorch; same arguments and results as
    :func:`msv_scan`. Float32 operations run in the order of
    ``ops/recurrence.py::msv_step``, so it equals ``msv_oracle_batch`` bit
    for bit."""
    b_pad, l_pad = tokens.shape
    tr_loop, tr_move = tr_rows[0], tr_rows[1]
    tr_b_mk, tr_e_c, tr_e_j = tr_consts[0], tr_consts[1], tr_consts[2]
    st_j, st_c, st_n, st_b = s[0], s[1], s[2], s[3]
    lengths = lengths.long()
    steps = min(l_pad, int(lengths.max())) if b_pad else 0
    col0 = torch.full((b_pad, 1), NEG_INF, dtype=torch.float32, device=m.device)
    for t in range(steps):
        # clamp: PAD_TOKEN must not index a score row (the step is masked)
        emit_t = emit[tokens[:, t].long().clamp(0, NUM_AA - 1)]  # [B, M_pad]
        shifted = torch.cat([col0, m[:, :-1]], dim=1)
        new_m = emit_t + torch.maximum(shifted, (st_b + tr_b_mk)[:, None])
        e_st = new_m.amax(dim=1)
        new_j = torch.maximum(st_j + tr_loop, e_st + tr_e_j)
        new_c = torch.maximum(st_c + tr_loop, e_st + tr_e_c)
        new_n = st_n + tr_loop
        new_b = torch.maximum(new_n + tr_move, new_j + tr_move)
        valid = t < lengths
        m = torch.where(valid[:, None], new_m, m)
        st_j = torch.where(valid, new_j, st_j)
        st_c = torch.where(valid, new_c, st_c)
        st_n = torch.where(valid, new_n, st_n)
        st_b = torch.where(valid, new_b, st_b)
    # a fresh M tensor, as the kernel returns, even when no step ran
    return st_c + tr_move, m.clone(), torch.stack([st_j, st_c, st_n, st_b])


def msv_filter_scan_plain(emit, tokens, lengths, tr_rows, tr_consts, m, s):
    """The filter in plain PyTorch; same arguments and results as
    :func:`msv_filter_scan`: the exact scan over the bf16 table widened to
    f32 (exact), which is what the TPU kernel's one-hot select of a single
    bf16 term computes."""
    return msv_scan_plain(emit.float(), tokens, lengths, tr_rows, tr_consts, m, s)


def msv_stacked_scan_plain(emit, tokens, lengths, tr_rows, tr_consts):
    """The stacked scan in plain PyTorch, one profile after the other from
    the row-0 carry; same arguments and results as :func:`msv_stacked_scan`."""
    out = []
    for p in range(emit.shape[0]):
        m, s = init_carry(tr_rows, emit.shape[2])
        out.append(msv_scan_plain(emit[p].float(), tokens, lengths, tr_rows, tr_consts[p], m, s)[0])
    return torch.stack(out) if out else torch.empty((0, tokens.shape[0]), device=tokens.device)


# -- the kernel ------------------------------------------------------------

@functools.cache
def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library()
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.msv_scan_launch.argtypes = [
        i, i, i, i, i, i, p, i, p, i, p, p, p, p, p, p, p, p, i, i, p, p,
    ]
    lib.msv_scan_launch.restype = i
    lib.msv_kernel_attrs.argtypes = [i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.msv_kernel_attrs.restype = i
    lib.msv_error_string.argtypes = [i]
    lib.msv_error_string.restype = ctypes.c_char_p
    return lib


def kernel_case(m_pad: int) -> tuple[int, int]:
    """``(lanes, per)``: the kernel case of an M row of ``m_pad`` states,
    one warp a sequence (32 lanes) up to MAX_WARP_STATES, two warps (64) up
    to MAX_WIDE_STATES, each lane holding ``per`` states in registers; past
    that the rows-in-memory case, MEM_LANES threads walking ``per`` tiles of
    MEM_LANES states. Any width has a case."""
    for lanes, pers in ((32, KERNEL_PER), (64, WIDE_PER)):
        for per in pers:
            if lanes * per >= m_pad:
                return lanes, per
    return MEM_LANES, -(-m_pad // MEM_LANES)


def kernel_per(m_pad: int) -> int:
    """States per lane for an M row of ``m_pad`` states (:func:`kernel_case`)."""
    return kernel_case(m_pad)[1]


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the SM's shared memory a block may take (227 KB) and its registers
SMEM_PER_SM = 232448
REGS_PER_SM = 65536
# warps a block of a register case (32 lanes): each is a kernel of its own,
# compiled under __launch_bounds__(32 * warps, 1) (csrc/msv_kernel.cu,
# kernel_of), so that ptxas holds its registers to register_cap(warps)
WARP_CHOICES = (8, 12, 16, 20, 24, 28, 32)
# the wide case's largest block: 16 warps, 8 sequences (its kernels'
# __launch_bounds__(512, 1))
WIDE_WARPS = 16
# warps a block of each register case, keyed by PER: the fastest of
# tools/torch_msv_timing.py --warps on an NVIDIA H100 (PERF.md, section 6).
# The grid is persistent: one block an SM and profile (sms // P blocks a
# profile), whose warps walk the batch with a stride.
PLAN_WARPS = {4: 32, 12: 32, 20: 24, 28: 16, 36: 16, 44: 16, 52: 16, 60: 16, 68: 16, 76: 16}


class MsvPlan(NamedTuple):
    """How the MSV kernel launches: ``warps`` warps a block, ``grid`` blocks
    a profile (grid.x; grid.y is the profile) and ``smem`` bytes of dynamic
    shared memory a block. A grid smaller than the batch needs makes the
    warps walk it with a stride."""

    warps: int
    grid: int
    smem: int


def register_cap(warps: int) -> int:
    """Registers a thread that ``__launch_bounds__(32 * warps, 1)`` leaves:
    the SM's REGS_PER_SM over the block's threads, in the steps of 8 they
    are allocated in, at most 255."""
    return min(255, REGS_PER_SM // (32 * warps) // 8 * 8)


def launch_plan(lanes: int, per: int, entry_bytes: int, b_pad: int, num_p: int, sms: int,
                warps: int | None = None) -> MsvPlan:
    """The launch plan of the kernel case ``(lanes, per)`` over ``b_pad``
    sequences and ``num_p`` stacked profiles on a card of ``sms``
    multiprocessors (``csrc/msv_kernel.cu``, ``msv_scan_launch``).

    At 32 lanes ``warps`` (default PLAN_WARPS[per], else one of
    WARP_CHOICES) warps a block stage one f32 table of 20 x 32 * per
    entries whatever ``entry_bytes`` is (the filter's bf16 table is widened
    while it is staged), on a persistent grid: one block an SM and table,
    sms // num_p blocks a profile (at least 1, at most the batch needs). At
    64 lanes 16 warps a block when their two row buffers of ``entry_bytes``
    entries (and each pair's 32-byte exchange slots) fit, else 8, one pair
    a sequence. The rows-in-memory case (MEM_LANES) runs one 1024-thread
    block a sequence, MEM_BLOCKS_PER_SM blocks an SM, a persistent grid."""
    if lanes == MEM_LANES:
        return MsvPlan(MEM_LANES // 32, max(1, min(b_pad, MEM_BLOCKS_PER_SM * sms)), 0)
    if lanes == 64:
        if warps is not None:
            raise ValueError("the wide case's plan is fixed")
        def wide_smem(w):
            return w * 2 * 32 * per * entry_bytes + (w // 2) * 2 * 4 * 4
        w = WIDE_WARPS if wide_smem(WIDE_WARPS) <= SMEM_PER_SM else WIDE_WARPS // 2
        return MsvPlan(w, max(1, -(-b_pad // (w // 2))), wide_smem(w))
    warps = PLAN_WARPS[per] if warps is None else warps
    if warps not in WARP_CHOICES:
        raise ValueError(f"{warps} warps a block: the MSV kernel takes one of {WARP_CHOICES}")
    grid = max(1, min(-(-b_pad // warps), sms // num_p))
    return MsvPlan(warps, grid, 4 * NUM_AA * 32 * per)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(m_pad: int, entry_bytes: int, b_pad: int, num_p: int, device,
                warps: int | None = None) -> MsvPlan:
    """:func:`launch_plan` of the kernel case of ``m_pad`` states on the
    card ``device``."""
    lanes, per = kernel_case(m_pad)
    return launch_plan(lanes, per, entry_bytes, b_pad, num_p,
                       _sm_count(torch.device(device).index or 0), warps)


@functools.cache
def kernel_attrs(lanes: int, per: int, warps: int, bf16: bool) -> tuple[int, int]:
    """``(registers, local-memory bytes)`` a thread of a register case's
    kernel uses, as compiled (local memory: the registers ptxas spilled)."""
    lib = _kernel_library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.msv_kernel_attrs(lanes, per, warps, int(bf16), ctypes.byref(regs),
                              ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"MSV kernel ({lanes} lanes, per {per}, {warps} warps) attribute "
                           f"query failed: {lib.msv_error_string(rc).decode()} ({rc})")
    return regs.value, local.value


def count_launch(wrapper, wide: bool, mem: bool = False) -> None:
    """One more launch of ``wrapper``'s kernel; ``wide`` counts it also in
    ``wrapper.wide_launches`` (a register case past 2432 states), ``mem`` in
    ``wrapper.mem_launches`` (the rows-in-memory case, past 4864)."""
    wrapper.launches += 1
    wrapper.wide_launches += int(wide)
    wrapper.mem_launches += int(mem)


def _count(wrapper, m_pad: int) -> None:
    """Count a launch of ``wrapper``'s kernel at ``m_pad`` states, apart for
    the 64-lane and the rows-in-memory cases."""
    lanes = kernel_case(m_pad)[0]
    count_launch(wrapper, lanes == 64, lanes == MEM_LANES)


def _launch(what, emit, tokens, lengths, tr_rows, tr_consts, carry, warps=None):
    """Check the operands and launch the kernel on the current stream.
    ``emit`` is ``[P, 20, M_pad]`` f32 or bf16 and ``tr_consts`` ``[P, 3]``;
    ``carry`` is ``(m, s)`` (P = 1: the carries come back) or None (the
    row-0 carry, scores only); ``warps`` forces the register case's block
    size (:func:`launch_plan`). Returns ``(scores [P, B_pad], m_out,
    s_out)``."""
    device = tokens.device
    if device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {device}")
    num_p, _, m_pad = emit.shape
    b_pad, l_pad = tokens.shape
    lanes, per = kernel_case(m_pad)
    if lanes == 64 and m_pad % 8:
        raise ValueError(f"M_pad = {m_pad} is not a multiple of 8")
    if emit.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"emit is {emit.dtype}, expected float32 or bfloat16")
    if num_p < 1:
        raise ValueError("no profile to scan")
    _check("emit", emit, emit.dtype, (num_p, NUM_AA, m_pad), device)
    _check("tokens", tokens, torch.int8, (b_pad, l_pad), device)
    _check("lengths", lengths, torch.int32, (b_pad,), device)
    _check("tr_rows", tr_rows, torch.float32, (2, b_pad), device)
    _check("tr_consts", tr_consts, torch.float32, (num_p, 3), device)
    scores = torch.empty((num_p, b_pad), dtype=torch.float32, device=device)
    m_in = s_in = m_out = s_out = None
    if carry is not None:
        m_in, s_in = carry
        _check("m", m_in, torch.float32, (b_pad, m_pad), device)
        _check("s", s_in, torch.float32, (4, b_pad), device)
        m_out, s_out = torch.empty_like(m_in), torch.empty_like(s_in)
    if b_pad == 0:
        return scores, m_out, s_out
    plan = device_plan(m_pad, emit.element_size(), b_pad, num_p, device, warps)
    scratch = None
    if lanes == MEM_LANES:
        # two scratch rows a block and profile
        scratch = torch.empty((num_p, plan.grid, 2, m_pad), dtype=torch.float32, device=device)
    lib = _kernel_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.msv_scan_launch(
        device.index, lanes, per, plan.warps, int(emit.dtype == torch.bfloat16), num_p,
        emit.data_ptr(), m_pad, tokens.data_ptr(), l_pad, lengths.data_ptr(),
        tr_rows.data_ptr(), tr_consts.data_ptr(), ptr(m_in), ptr(s_in),
        scores.data_ptr(), ptr(m_out), ptr(s_out), b_pad, plan.grid, ptr(scratch),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {lib.msv_error_string(rc).decode()} ({rc})"
        )
    return scores, m_out, s_out


def _single(what, dtype, emit, tokens, lengths, tr_rows, tr_consts, m, s, warps):
    if emit.dtype != dtype:
        raise ValueError(f"emit is {emit.dtype}, expected {dtype}")
    scores, m_out, s_out = _launch(what, emit.unsqueeze(0), tokens, lengths, tr_rows,
                                   tr_consts.unsqueeze(0), (m, s), warps)
    return scores[0], m_out, s_out


def msv_scan_cuda(emit, tokens, lengths, tr_rows, tr_consts, m, s, warps=None):
    """Launch ``csrc/msv_kernel.cu`` (f32 table) on the current stream; same
    arguments and results as :func:`msv_scan`; ``warps`` forces the block
    size (:func:`launch_plan`). Raises on anything the kernel does not take
    and on a refused launch; never falls back."""
    out = _single("MSV", torch.float32, emit, tokens, lengths, tr_rows, tr_consts, m, s, warps)
    if tokens.shape[0]:
        _count(msv_scan_cuda, emit.shape[1])
    return out


def msv_filter_scan_cuda(emit, tokens, lengths, tr_rows, tr_consts, m, s, warps=None):
    """Launch ``csrc/msv_kernel.cu`` with the filter's bf16 table (staged
    as f32); same arguments and results as :func:`msv_filter_scan`."""
    out = _single("MSV filter", torch.bfloat16, emit, tokens, lengths, tr_rows, tr_consts,
                  m, s, warps)
    if tokens.shape[0]:
        _count(msv_filter_scan_cuda, emit.shape[1])
    return out


def msv_stacked_scan_cuda(emit, tokens, lengths, tr_rows, tr_consts, warps=None):
    """Launch ``csrc/msv_kernel.cu`` over a profile stack (one grid row a
    profile); same arguments and results as :func:`msv_stacked_scan`."""
    scores, _, _ = _launch("stacked MSV", emit, tokens, lengths, tr_rows, tr_consts, None,
                           warps)
    if tokens.shape[0]:
        _count(msv_stacked_scan_cuda, emit.shape[2])
    return scores


# kernel launches in this process, those of them at 64 lanes and those of
# the rows-in-memory case
for _fn in (msv_scan_cuda, msv_filter_scan_cuda, msv_stacked_scan_cuda):
    _fn.launches = _fn.wide_launches = _fn.mem_launches = 0


def msv_scan(emit, tokens, lengths, tr_rows, tr_consts, m, s):
    """Score every sequence of a staged batch, threading the DP carry.

    Returns ``(scores [B_pad], m [B_pad, M_pad], s [4, B_pad])``. CPU
    tensors run :func:`msv_scan_plain`; any other device runs the kernel
    (:func:`msv_scan_cuda`) or raises."""
    fn = msv_scan_plain if tokens.device.type == "cpu" else msv_scan_cuda
    return fn(emit, tokens, lengths, tr_rows, tr_consts, m, s)


def msv_filter_scan(emit, tokens, lengths, tr_rows, tr_consts, m, s):
    """The MSV filter over a staged batch: ``emit`` is the bf16 round-up
    table, so every score is >= the exact scan's. Carries and results as
    :func:`msv_scan`. CPU tensors run :func:`msv_filter_scan_plain`; any
    other device the kernel (:func:`msv_filter_scan_cuda`) or raises."""
    fn = msv_filter_scan_plain if tokens.device.type == "cpu" else msv_filter_scan_cuda
    return fn(emit, tokens, lengths, tr_rows, tr_consts, m, s)


def msv_stacked_scan(emit, tokens, lengths, tr_rows, tr_consts):
    """Score a staged batch against a stack of profiles from the row-0
    carry: ``emit [P, 20, M_pad]`` (f32: exact; bf16: the filter),
    ``tr_consts [P, 3]`` -> ``scores [P, B_pad]``, row p equal to the
    single-profile scan of profile p. CPU tensors run
    :func:`msv_stacked_scan_plain`; any other device the kernel
    (:func:`msv_stacked_scan_cuda`) or raises."""
    fn = msv_stacked_scan_plain if tokens.device.type == "cpu" else msv_stacked_scan_cuda
    return fn(emit, tokens, lengths, tr_rows, tr_consts)
