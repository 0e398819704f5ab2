"""Carry the JAX package's parameters and DP state into the port.

``profile_hmm_from_jax``, ``msv_profile_from_jax`` and
``p7_profile_from_jax`` build the port's own ``ProfileHMM``, ``MSVProfile``
and ``P7Profile`` from the JAX package's objects (copying their numpy
fields); the port never imports those classes. Every other function takes
numpy arrays (``np.asarray`` of the JAX arrays) in the JAX package's
layouts and returns the port's device tensors, so that both packages can
score the same inputs:

* a profile: an ``MSVProfile``, or the JAX scanner's device pack
  ``(scores_t [1, M_pad, 20], tr_consts [1, 3])``;
* the MSV filter's pack ``(prepare_scores_t_filter [1, M_pad, 20] bf16,
  tr_consts [1, 3])`` and a stacked sweep pack ``(scores_t [P, M_pad, 20]
  f32 or bf16, tr_consts [P, 3])``;
* a staged database: ``tokens_i8_t [L_pad, B_pad]``, ``lengths [B_pad]``,
  ``tr_rows [2, B_pad]`` and ``tr_probs [2, B_pad]`` of a JAX
  ``StagedDatabase``;
* the DP carry of ``msv_pallas_call``: ``m [M_pad, B_pad]`` and
  ``s [4, B_pad]``;
* a Viterbi/Forward pack: the outputs of ``pallas_p7.prepare_p7_device``,
  ``prepare_p7_device_lazy`` or ``prepare_p7_device_prob`` (``[M_pad, …]``),
  and the Viterbi filter's ``prepare_p7_device_filter`` tuple;
* the DP carry of ``p7_pallas_call`` / ``fwd_prob_pallas_call``:
  ``m, i, d [M_pad, B_pad]`` and ``s [4 | 8, B_pad]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .io.hmmio import ProfileHMM
from .models.msv import MSVProfile
from .models.p7 import P7Profile
from .ops import msv_cuda, p7_cuda
from .pipeline import M_BUCKET, StagedDatabase


def _port_dataclass(cls, obj):
    """A ``cls`` instance holding the fields of ``obj`` (the JAX package's
    dataclass of the same name and fields); arrays are copied."""
    return cls(**{
        f.name: np.array(v, copy=True) if isinstance(v := getattr(obj, f.name), np.ndarray)
        else v
        for f in dataclasses.fields(cls)
    })


def profile_hmm_from_jax(hmm) -> ProfileHMM:
    """The port's ``ProfileHMM`` from a JAX ``ProfileHMM``."""
    return _port_dataclass(ProfileHMM, hmm)


def msv_profile_from_jax(profile) -> MSVProfile:
    """The port's ``MSVProfile`` from a JAX ``MSVProfile``."""
    return _port_dataclass(MSVProfile, profile)


def p7_profile_from_jax(p7) -> P7Profile:
    """The port's ``P7Profile`` from a JAX ``P7Profile``."""
    return _port_dataclass(P7Profile, p7)


def device_profile(profile: MSVProfile, device):
    """``(emit [20, M_pad], tr_consts [3])`` of an ``MSVProfile``."""
    m_pad = msv_cuda.round_up(profile.num_states, M_BUCKET)
    return msv_cuda.pack_profile(profile, m_pad, device)


def device_profile_from_jax(
    scores_t: np.ndarray, tr_consts: np.ndarray, num_states: int, device
):
    """The port's pack from a JAX scanner's ``(scores_t [1, M_pad, 20],
    tr_consts [1, 3])``; ``num_states`` is the profile's Mr (rows beyond it
    are the TPU pack's padding)."""
    scores_t = np.asarray(scores_t, dtype=np.float32).reshape(-1, msv_cuda.NUM_AA)
    emit = msv_cuda.prepare_emit(
        np.ascontiguousarray(scores_t[:num_states].T),
        msv_cuda.round_up(num_states, M_BUCKET),
    )
    consts = np.asarray(tr_consts, dtype=np.float32).reshape(3)
    return torch.from_numpy(emit).to(device), torch.from_numpy(consts.copy()).to(device)


def filter_profile_from_jax(
    scores_t_bf16: np.ndarray, tr_consts: np.ndarray, num_states: int, device
):
    """The port's filter pack ``(emit bf16 [20, M_pad], tr_consts [3])``
    from the JAX scanner's ``(prepare_scores_t_filter(...)[None] [1, M_pad,
    20] bf16, tr_consts [1, 3])``: the same bf16 numbers on the real
    states, -inf on the port's pad states."""
    bits = msv_cuda.prepare_emit_filter(
        scores_t_bf16, num_states, msv_cuda.round_up(num_states, M_BUCKET)
    )
    consts = np.asarray(tr_consts, dtype=np.float32).reshape(3)
    return msv_cuda.bf16_tensor(bits, device), torch.from_numpy(consts.copy()).to(device)


def stacked_profiles_from_jax(
    scores_t: np.ndarray, tr_consts: np.ndarray, num_states, device
):
    """The port's stacked pack ``(emit [P, 20, M_pad], tr_consts [P, 3])``
    from a JAX stacked sweep pack ``(scores_t [P, M_pad, 20], tr_consts [P,
    3])``: f32 tables (``prepare_scores_t``, the exact sweep) stay f32,
    bf16 ones (``prepare_scores_t_filter``, the filter sweep) stay bf16.
    ``num_states`` lists each profile's Mr."""
    scores_t = np.asarray(scores_t)
    m_pad = msv_cuda.round_up(max(num_states), M_BUCKET)
    if scores_t.dtype.itemsize == 2:
        emit = msv_cuda.bf16_tensor(np.stack([
            msv_cuda.prepare_emit_filter(x, n, m_pad) for x, n in zip(scores_t, num_states)
        ]), device)
    else:
        emit = torch.from_numpy(np.stack([
            msv_cuda.prepare_emit(np.ascontiguousarray(np.asarray(x, np.float32)[:n].T), m_pad)
            for x, n in zip(scores_t, num_states)
        ])).to(device)
    consts = np.asarray(tr_consts, dtype=np.float32).reshape(-1, 3)
    return emit, torch.from_numpy(consts.copy()).to(device)


def staged_from_jax(
    tokens_i8_t: np.ndarray, lengths: np.ndarray, tr_rows: np.ndarray,
    num_sequences: int, device, tr_probs: np.ndarray | None = None,
) -> StagedDatabase:
    """A port ``StagedDatabase`` from a JAX one's arrays, its tr_rows (and
    tr_probs, built from the lengths when not given) kept as they are.
    Ragged tails are blanked again (a JAX ``stage_device`` caller may have
    broken that contract)."""
    tokens_t = np.array(tokens_i8_t, dtype=np.int8)  # a copy: blanked in place
    lengths = np.asarray(lengths, dtype=np.int32)
    msv_cuda.blank_ragged_tail(tokens_t, lengths)
    if tr_probs is None:
        tr_probs = p7_cuda.length_transition_probs(lengths)
    return StagedDatabase(
        tokens=torch.from_numpy(np.ascontiguousarray(tokens_t.T)).to(device),
        lengths=torch.from_numpy(lengths.copy()).to(device),
        tr_rows=torch.from_numpy(np.asarray(tr_rows, dtype=np.float32).copy()).to(device),
        tr_probs=torch.from_numpy(np.asarray(tr_probs, dtype=np.float32).copy()).to(device),
        num_sequences=num_sequences,
    )


def carry_from_jax(m: np.ndarray, s: np.ndarray, num_states: int, device):
    """``(m [B_pad, M_pad], s [4, B_pad])`` from a ``msv_pallas_call`` carry
    ``(m [M_pad_tpu, B_pad], s [4, B_pad])``: the real states are
    transposed, the port's pad states are -inf."""
    m = np.asarray(m, dtype=np.float32)
    out = np.full(
        (m.shape[1], msv_cuda.round_up(num_states, M_BUCKET)), msv_cuda.NEG_INF,
        dtype=np.float32,
    )
    out[:, :num_states] = m[:num_states].T
    return (
        torch.from_numpy(out).to(device),
        torch.from_numpy(np.asarray(s, dtype=np.float32).copy()).to(device),
    )


def p7_pack_from_jax(msc_t, isc_t, trans_t, chain_t, tr_consts, device, lazy_k: int = 0):
    """The port's ``P7Pack`` from a JAX p7 pack (``prepare_p7_device*``
    output, ``[M_pad, …]`` arrays); ``lazy_k`` is the lazy packer's window,
    0 for the eager and Forward packs."""
    return p7_cuda.device_pack(msc_t, isc_t, trans_t, chain_t, tr_consts, device, lazy_k)


def p7_filter_pack_from_jax(msc_bf, isc_bf, trans_t, chain_t, tr_consts, window, e_skip_d,
                            device) -> p7_cuda.P7FilterPack:
    """The port's ``P7FilterPack`` from ``pallas_p7.prepare_p7_device_filter``'s
    tuple ``(msc_bf, isc_bf [M_pad, 20] bf16, trans_t, chain_t, tr_consts
    [1, 4], window, e_skip_d)``: the same numbers, transposed."""
    return p7_cuda.filter_device_pack(msc_bf, isc_bf, trans_t, chain_t, tr_consts, window,
                                      e_skip_d, device)


def p7_carry_from_jax(m, i, d, s, device):
    """``(m, i, d [B_pad, M_pad], s)`` from a ``p7_pallas_call`` or
    ``fwd_prob_pallas_call`` carry ``(m, i, d [M_pad, B_pad], s [4 | 8,
    B_pad])``; the M_pad of both packages' p7 packs is the same."""

    def rows(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)).to(device)

    return rows(m), rows(i), rows(d), torch.from_numpy(np.array(s, dtype=np.float32)).to(device)
