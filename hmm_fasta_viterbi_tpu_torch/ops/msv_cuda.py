"""MSV max-plus DP scan: the CUDA kernel's wrapper, its plain PyTorch
version, and the host packers.

The counterpart of ``hmm_fasta_viterbi_tpu/ops/pallas_msv.py`` (the Pallas
TPU kernel, exact mode, one profile) and of ``ops/xla_scan.py`` with the
recurrence of ``ops/recurrence.py``. The TPU layout is not carried over;
the contract is the scores and the DP carry:

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

``msv_scan`` runs the plain version on CPU tensors and the kernel on CUDA
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hmm_fasta_viterbi_tpu.models.msv import MSVProfile

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
# other's banks.
KERNEL_PER = (4, 12, 20, 28, 36, 44, 52, 60, 68, 76)
MAX_KERNEL_STATES = 32 * KERNEL_PER[-1]  # 2432 >= 2405, the largest profile


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
    ``convert.device_profile_from_jax``, and the base of the MSV filter
    mode's bf16 round-up, which is still to be ported."""
    mr = profile.num_states
    m_pad = m_pad or round_up(mr, 8)
    out = np.full((m_pad, NUM_AA), PAD_SCORE, dtype=np.float32)
    out[:mr, :] = np.maximum(profile.scores_real.T, PAD_SCORE)
    return out


def prepare_emit(scores_real: np.ndarray, m_pad: int) -> np.ndarray:
    """The port's emission pack: ``[20, M_pad]`` f32, ``scores_real`` as the
    oracle has it, -inf in the pad columns."""
    num_aa, mr = scores_real.shape
    if num_aa != NUM_AA or m_pad < mr:
        raise ValueError(f"scores [{num_aa}, {mr}] do not fit [20, {m_pad}]")
    out = np.full((NUM_AA, m_pad), NEG_INF, dtype=np.float32)
    out[:, :mr] = scores_real
    return out


def pack_profile(profile: MSVProfile, m_pad: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(emit [20, M_pad], tr_consts [3])`` of one profile on ``device``."""
    emit = torch.from_numpy(prepare_emit(profile.scores_real, m_pad)).to(device)
    tr_consts = torch.tensor(
        [profile.tr_B_Mk, profile.tr_E_C, profile.tr_E_J],
        dtype=torch.float32, device=device,
    )
    return emit, tr_consts


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


# -- the kernel ------------------------------------------------------------

@functools.cache
def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library()
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.msv_scan_launch.argtypes = [
        i, i, i, p, i, p, i, p, p, p, p, p, p, p, p, i, p,
    ]
    lib.msv_scan_launch.restype = i
    lib.msv_error_string.argtypes = [i]
    lib.msv_error_string.restype = ctypes.c_char_p
    return lib


def kernel_per(m_pad: int) -> int:
    """States per lane for an M row of ``m_pad`` states."""
    for per in KERNEL_PER:
        if 32 * per >= m_pad:
            return per
    raise ValueError(
        f"M_pad = {m_pad} exceeds the MSV kernel's limit of "
        f"{MAX_KERNEL_STATES} states (32 lanes x {KERNEL_PER[-1]})"
    )


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def msv_scan_cuda(emit, tokens, lengths, tr_rows, tr_consts, m, s):
    """Launch ``csrc/msv_kernel.cu`` on the current stream; same arguments
    and results as :func:`msv_scan`. Raises on anything the kernel does not
    take and on a refused launch; never falls back."""
    device = tokens.device
    if device.type != "cuda":
        raise ValueError(f"msv_scan_cuda needs CUDA tensors, got {device}")
    b_pad, l_pad = tokens.shape
    m_pad = emit.shape[1]
    per = kernel_per(m_pad)
    _check("emit", emit, torch.float32, (NUM_AA, m_pad), device)
    _check("tokens", tokens, torch.int8, (b_pad, l_pad), device)
    _check("lengths", lengths, torch.int32, (b_pad,), device)
    _check("tr_rows", tr_rows, torch.float32, (2, b_pad), device)
    _check("tr_consts", tr_consts, torch.float32, (3,), device)
    _check("m", m, torch.float32, (b_pad, m_pad), device)
    _check("s", s, torch.float32, (4, b_pad), device)
    scores = torch.empty(b_pad, dtype=torch.float32, device=device)
    m_out = torch.empty_like(m)
    s_out = torch.empty_like(s)
    if b_pad == 0:
        return scores, m_out, s_out
    # one block holds the table once per SM when it is over half of the
    # SM's shared memory; give it 16 warps then, else 8 per block
    warps = 16 if per >= 52 else 8
    lib = _kernel_library()
    rc = lib.msv_scan_launch(
        device.index, per, warps,
        emit.data_ptr(), m_pad, tokens.data_ptr(), l_pad, lengths.data_ptr(),
        tr_rows.data_ptr(), tr_consts.data_ptr(), m.data_ptr(), s.data_ptr(),
        scores.data_ptr(), m_out.data_ptr(), s_out.data_ptr(), b_pad,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"MSV kernel launch failed: {lib.msv_error_string(rc).decode()} ({rc})"
        )
    msv_scan_cuda.launches += 1
    return scores, m_out, s_out


msv_scan_cuda.launches = 0  # kernel launches in this process


def msv_scan(emit, tokens, lengths, tr_rows, tr_consts, m, s):
    """Score every sequence of a staged batch, threading the DP carry.

    Returns ``(scores [B_pad], m [B_pad, M_pad], s [4, B_pad])``. CPU
    tensors run :func:`msv_scan_plain`; any other device runs the kernel
    (:func:`msv_scan_cuda`) or raises."""
    if tokens.device.type == "cpu":
        return msv_scan_plain(emit, tokens, lengths, tr_rows, tr_consts, m, s)
    return msv_scan_cuda(emit, tokens, lengths, tr_rows, tr_consts, m, s)
