"""Posterior coverage of the match states: the two passes of the
``--domains`` decode, their plain PyTorch versions and the wrappers of the
CUDA kernels.

The counterparts of ``hmm_fasta_viterbi_tpu/ops/pallas_posterior.py``:

* ``_fwd_save_kernel``: :func:`forward_save_scan`, the probability-space
  Forward of ``p7_cuda.forward_prob_scan`` (the same arguments, the same
  scores bit for bit) that also returns each step's scaled M row as bf16
  ``fm [B_pad, L_pad, M_pad]`` (round to nearest, 0 at and past the
  length) and the log scale in effect for it, ``ls [B_pad, L_pad]``;
* ``_bwd_cov_kernel``: :func:`backward_coverage_scan`, the scaled backward
  pass from each sequence's last residue down to its first, emitting
  ``cov[t] = sum_j fm[t, j] * beta_M[t, j] * exp(ls[t] + lsb - total)``, the
  summed match posterior of position t, without storing the posterior
  matrix;
* :func:`posterior_coverage_batch`, ``posterior_coverage_batch_pallas``'s
  contract on a host batch: coverage ``[B, L_pad]`` f32 zero past each
  length (uint8 ``cov >= mask_threshold`` when that is given) and the
  totals ``[B]`` in nats.

The suffix delete chain :func:`prepare_suffix_chain` is the numpy copy of
the JAX packer, byte for byte; on the device it is ``[W, M_pad]``, one row
a pass. The backward pass takes the probability-space Forward pack
(``p7_cuda.forward_pack``): odds ratios, transition probabilities and
``consts`` = (p_B_Mk, p_E_C, p_E_J).

Each scan runs its plain version on CPU tensors and its kernel on CUDA
tensors; it never falls back from one to the other. There is no lax.scan
decode to fall back to either: a batch whose bf16 rows exceed
:data:`POST_BYTES` runs in chunks, and one sequence over it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.p7 import P7Profile
from ..pipeline import MSVScanner
from . import p7_cuda
from .msv_cuda import NUM_AA, _check

# device bytes of the bf16 forward rows of one call (JAX's POST_HBM_BYTES);
# a larger hit batch runs in chunks of sequences under it
POST_BYTES = 3 << 30


def prepare_suffix_chain(p7: P7Profile, m_pad: int | None = None) -> np.ndarray:
    """``[M_pad, W]`` suffix-chain pass constants of
    ``pallas_posterior.prepare_suffix_chain``: window products of the links
    c_j = tdd_j accumulated toward lower j; pass k adds ``a[j + 2^k] *
    C_k[j]``, with rows j >= M_pad - 2^k zero. W is ``pick_prob_chain_window``,
    the forward chain's window."""
    mr = p7.num_states
    m_pad = m_pad or p7_cuda.default_m_pad(p7)
    with np.errstate(over="ignore"):
        tdd_p = np.exp(p7.tdd.astype(np.float64)).astype(np.float32)
    window = p7_cuda.pick_prob_chain_window(p7, m_pad)
    chain = np.zeros((m_pad, window), dtype=np.float32)
    rows = np.arange(m_pad)
    c_cur = np.zeros(m_pad, dtype=np.float32)
    c_cur[:mr] = tdd_p[:mr]  # the profile's last link is already 0
    for k in range(window):
        s = 1 << k
        dead = rows >= m_pad - s
        chain[:, k] = np.where(dead, np.float32(0.0), c_cur)
        c_cur = (c_cur * np.where(dead, np.float32(1.0), np.roll(c_cur, -s))).astype(np.float32)
    return chain


def suffix_chain_rows(p7: P7Profile, device) -> torch.Tensor:
    """:func:`prepare_suffix_chain` as the kernel reads it: ``[W, M_pad]``."""
    return torch.from_numpy(np.ascontiguousarray(prepare_suffix_chain(p7).T)).to(device)


# -- the plain versions ----------------------------------------------------

def forward_save_scan_plain(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                            consts, m, i, d, s):
    """The row-saving Forward in plain PyTorch; same arguments and results
    as :func:`forward_save_scan`: ``p7_cuda.forward_prob_scan_plain``'s
    arithmetic, its scores bit for bit."""
    return p7_cuda.forward_rows_plain(modds, iodds, trans, chain, tokens, lengths, tr_rows,
                                      tr_probs, consts, m, i, d, s, save=True)


def _up(x: torch.Tensor, s: int) -> torch.Tensor:
    """``out[:, j] = x[:, j + s]``, 0 past the row."""
    b, m = x.shape
    if s >= m:
        return torch.zeros_like(x)
    return torch.cat([x[:, s:], torch.zeros((b, s), dtype=x.dtype, device=x.device)], dim=1)


def _suffix_chain(a: torch.Tensor, schain: torch.Tensor) -> torch.Tensor:
    for k in range(schain.shape[0]):
        a = a + _up(a, 1 << k) * schain[k]
    return a


def backward_coverage_scan_plain(modds, iodds, trans, schain, tokens, lengths, tr_probs,
                                 consts, total, fm, ls):
    """The backward coverage pass in plain PyTorch; same arguments and
    result as :func:`backward_coverage_scan`. It follows
    ``csrc/p7_backward_kernel.cu`` step for step (each sequence from its own
    last residue, rescaled after every FWD_RESCALE_GROUP of its steps); the
    sums run in another order, so the two agree to rounding."""
    b_pad, l_pad = tokens.shape
    tmm, tmi, tmd, tim, tii, tdm = trans[:6]
    p_loop, p_move = tr_probs[0], tr_probs[1]
    p_b_mk, p_e_c, p_e_j = consts[0], consts[1], consts[2]
    lengths = lengths.long().clamp(0, l_pad)
    cov = torch.zeros((b_pad, l_pad), dtype=torch.float32, device=tokens.device)
    be = p_e_c * p_move
    bm = tmd * _up(_suffix_chain(be[:, None].expand(b_pad, modds.shape[1]), schain), 1)
    bm = bm + be[:, None]
    bi = torch.zeros_like(bm)
    bj, bc, bn = torch.zeros_like(be), p_move.clone(), torch.zeros_like(be)
    lsb, comp = torch.zeros_like(be), torch.zeros_like(be)
    steps = torch.zeros(b_pad, dtype=torch.long, device=tokens.device)
    for pos in range(p7_cuda._num_steps(tokens, lengths) - 1, -1, -1):
        valid = pos < lengths
        cv = (fm[:, pos].float() * bm).sum(dim=1) * torch.exp(ls[:, pos] + lsb - total)
        cov[:, pos] = torch.where(valid, cv, 0.0)
        if pos == 0:
            break
        memit = p7_cuda._emissions(modds, tokens, pos) * bm
        iemit = p7_cuda._emissions(iodds, tokens, pos) * bi
        m_next = _up(memit, 1)
        bspec = p_b_mk * memit.sum(dim=1)
        new_j = p_loop * bj + p_move * bspec
        new_n = p_loop * bn + p_move * bspec
        new_c = p_loop * bc
        e = (p_e_c * new_c + p_e_j * new_j)[:, None]
        new_i = tim * m_next + tii * iemit
        new_d = _suffix_chain(tdm * m_next + e, schain)
        new_m = tmm * m_next + tmi * iemit + tmd * _up(new_d, 1) + e
        bm, bi, bj, bc, bn = p7_cuda._freeze(valid, (new_m, new_i, new_j, new_c, new_n),
                                             (bm, bi, bj, bc, bn))
        steps += valid.long()
        rescale = valid & (steps % p7_cuda.FWD_RESCALE_GROUP == 0)
        if bool(rescale.any()):
            scale = torch.maximum(torch.maximum(bm.amax(dim=1), bc), torch.clamp(bn, min=1e-30))
            inv = 1.0 / scale
            y = torch.log(scale) - comp
            t_sum = lsb + y
            new = (bm * inv[:, None], bi * inv[:, None], bj * inv, bc * inv, bn * inv, t_sum,
                   (t_sum - lsb) - y)
            bm, bi, bj, bc, bn, lsb, comp = p7_cuda._freeze(
                rescale, new, (bm, bi, bj, bc, bn, lsb, comp))
    return cov


# -- the kernels -----------------------------------------------------------

def forward_save_scan_cuda(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs,
                           consts, m, i, d, s, groups: int | None = None):
    """Launch the row-saving case of ``csrc/p7_forward_kernel.cu``; same
    arguments and results as :func:`forward_save_scan`; ``groups`` sequences
    a block, None for ``p7_cuda.plan_launch``'s pick. Raises on what the
    kernel does not take and on a refused launch; never falls back."""
    return p7_cuda.forward_launch(forward_save_scan_cuda, modds, iodds, trans, chain, tokens,
                                  lengths, tr_rows, tr_probs, consts, m, i, d, s, save=True,
                                  groups=groups)


def backward_coverage_scan_cuda(modds, iodds, trans, schain, tokens, lengths, tr_probs,
                                consts, total, fm, ls, groups: int | None = None):
    """Launch ``csrc/p7_backward_kernel.cu`` (the backward case of the
    blocked p7 layout); same arguments and result as
    :func:`backward_coverage_scan`; ``groups`` sequences a block, None for
    ``p7_cuda.plan_launch``'s pick. Raises on what the kernel does not take
    and on a refused launch; never falls back."""
    device = tokens.device
    b_pad, l_pad = tokens.shape
    m_pad = modds.shape[1]
    p7_cuda.kernel_case(m_pad)  # raises past MAX_KERNEL_STATES
    if device.type != "cuda":
        raise ValueError(f"the posterior kernels need CUDA tensors, got {device}")
    window = schain.shape[0]
    if not 1 <= window <= p7_cuda.chain_passes(m_pad):
        raise ValueError(f"suffix chain window {window} outside 1..{p7_cuda.chain_passes(m_pad)}")
    _check("modds", modds, torch.float32, (NUM_AA, m_pad), device)
    _check("iodds", iodds, torch.float32, (NUM_AA, m_pad), device)
    _check("trans", trans, torch.float32, (8, m_pad), device)
    _check("schain", schain, torch.float32, (window, m_pad), device)
    _check("tokens", tokens, torch.int8, (b_pad, l_pad), device)
    _check("lengths", lengths, torch.int32, (b_pad,), device)
    _check("tr_probs", tr_probs, torch.float32, (2, b_pad), device)
    _check("consts", consts, torch.float32, (3,), device)
    _check("total", total, torch.float32, (b_pad,), device)
    _check("fm", fm, torch.bfloat16, (b_pad, l_pad, m_pad), device)
    _check("ls", ls, torch.float32, (b_pad, l_pad), device)
    p7_cuda._check_blocked(modds, iodds, m_pad)
    if fm.data_ptr() % 16:
        raise ValueError("fm is not 16-byte aligned")
    cov = torch.empty((b_pad, l_pad), dtype=torch.float32, device=device)
    if b_pad:
        plan = p7_cuda.device_plan("backward", m_pad, window, b_pad, device, groups)
        scratch = p7_cuda.mem_scratch(plan, m_pad, device)
        rc = p7_cuda._kernel_library().p7_backward_launch(
            device.index, plan.threads, p7_cuda.kernel_per(m_pad), modds.data_ptr(),
            iodds.data_ptr(), trans.data_ptr(), schain.data_ptr(), m_pad, window, plan.n_chain,
            plan.n_trans, p7_cuda.FWD_RESCALE_GROUP, tokens.data_ptr(), l_pad,
            lengths.data_ptr(), tr_probs.data_ptr(), consts.data_ptr(), total.data_ptr(),
            fm.data_ptr(), ls.data_ptr(), cov.data_ptr(), p7_cuda._ptr(scratch), b_pad,
            plan.groups, plan.grid, plan.smem, torch.cuda.current_stream(device).cuda_stream,
        )
        p7_cuda._raise_on(rc, "posterior backward")
        p7_cuda.launched(backward_coverage_scan_cuda, plan)
    return cov


# kernel launches in this process, those of them at WIDE_THREADS and those
# of the rows-in-memory case
for _fn in (forward_save_scan_cuda, backward_coverage_scan_cuda):
    _fn.launches = _fn.wide_launches = _fn.mem_launches = 0


def forward_save_scan(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs, consts,
                      m, i, d, s):
    """Probability-space Forward over a staged batch that keeps its rows for
    the backward pass: ``forward_prob_scan``'s arguments and results, then
    ``fm`` bf16 ``[B_pad, L_pad, M_pad]`` and ``ls`` f32 ``[B_pad, L_pad]``.
    CPU tensors run :func:`forward_save_scan_plain`; any other device the
    kernel (:func:`forward_save_scan_cuda`) or raises."""
    fn = forward_save_scan_plain if tokens.device.type == "cpu" else forward_save_scan_cuda
    return fn(modds, iodds, trans, chain, tokens, lengths, tr_rows, tr_probs, consts, m, i, d, s)


def backward_coverage_scan(modds, iodds, trans, schain, tokens, lengths, tr_probs, consts,
                           total, fm, ls):
    """The backward pass of the posterior decode over a staged batch:
    the Forward pack's ``modds``, ``iodds``, ``trans`` and ``consts``, the
    suffix chain ``schain [W, M_pad]``, the totals (the Forward scores,
    nats) and :func:`forward_save_scan`'s ``fm`` and ``ls``. Returns the
    coverage ``[B_pad, L_pad]`` f32, 0 at and past each length. CPU tensors
    run :func:`backward_coverage_scan_plain`; any other device the kernel
    (:func:`backward_coverage_scan_cuda`) or raises."""
    fn = (backward_coverage_scan_plain if tokens.device.type == "cpu"
          else backward_coverage_scan_cuda)
    return fn(modds, iodds, trans, schain, tokens, lengths, tr_probs, consts, total, fm, ls)


# -- the batched decode ----------------------------------------------------

def posterior_coverage_batch(p7: P7Profile, tokens, lengths, device="cuda",
                             batch_chunk: int | None = None,
                             mask_threshold: float | None = None):
    """Summed match-state posterior of every position of a host batch:
    ``(coverage [B, L_pad], totals [B])`` host arrays, L_pad the tokens'
    width (at least 1). Coverage is f32 and 0 past each length or, with
    ``mask_threshold``, uint8 ``coverage >= mask_threshold`` (thresholded on
    the device); totals are the Forward scores in nats.

    The batch runs in chunks of ``batch_chunk`` sequences, by default as
    many as keep the bf16 rows (``L_pad * M_pad * 2`` bytes a sequence)
    under :data:`POST_BYTES`; one sequence over it raises ``ValueError``."""
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths, dtype=np.int32)
    b, seq_len = tokens.shape
    l_pad = max(seq_len, 1)
    m_pad = p7_cuda.default_m_pad(p7)
    per_seq = l_pad * m_pad * 2
    if per_seq > POST_BYTES:
        raise ValueError(
            f"one sequence of {l_pad} residues against M_pad = {m_pad} needs {per_seq} bytes "
            f"of bf16 forward rows, over the posterior budget of {POST_BYTES} bytes"
        )
    chunk = batch_chunk or POST_BYTES // per_seq
    scanner = MSVScanner(device=device)
    pack = p7_cuda.forward_pack(p7, scanner.device)
    schain = suffix_chain_rows(p7, scanner.device)
    cov_out = np.zeros((b, l_pad), dtype=np.float32 if mask_threshold is None else np.uint8)
    tot_out = np.zeros(b, dtype=np.float32)
    for lo in range(0, b, chunk):
        hi = min(lo + chunk, b)
        staged = scanner.stage(tokens[lo:hi], lengths[lo:hi])
        carry = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)
        total, *_, fm, ls = forward_save_scan(
            *pack[:4], staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
            pack.consts, *carry)
        cov = backward_coverage_scan(pack.emit_m, pack.emit_i, pack.trans, schain,
                                     staged.tokens, staged.lengths, staged.tr_probs,
                                     pack.consts, total, fm, ls)
        del fm
        if mask_threshold is not None:
            cov = (cov >= float(np.float32(mask_threshold))).to(torch.uint8)
        cov_out[lo:hi] = cov.cpu().numpy()
        tot_out[lo:hi] = total.cpu().numpy()
    return cov_out, tot_out
