"""MSV scan pipeline of the PyTorch port: stage a sequence database on a
device once, then scan profiles against it.

The counterpart of the MSV path of ``hmm_fasta_viterbi_tpu/pipeline.py``
(``StagedDatabase``, ``MSVScanner.stage / stage_fasta / stage_device /
scan``). Differences that follow from the device:

* the device is named by the caller (``"cuda"``, ``"cuda:1"``, ``"cpu"``);
  nothing picks the CPU when CUDA is missing, and a CUDA scanner without
  CUDA raises;
* tokens stay int8 ``[B, L_pad]``, one sequence's residues contiguous for
  the kernel's warp; the TPU's ``[L_pad, B_pad]`` lane layout and its
  device transpose are not needed, and B is not padded;
* ``m_bucket`` pads the M row to a multiple of it (default ``M_BUCKET``).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from hmm_fasta_viterbi_tpu.io.fastaio import FastaDatabase
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile, length_transitions

from .ops import msv_cuda

# M row padding of the port's profile packs and carries (as the JAX XLA
# path's); the kernel pads further to its lane tile internally
M_BUCKET = 8


def _blank_tail(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` int8 tokens with every position >= lengths[b] set to
    PAD_TOKEN: the ``blank_ragged_tail`` contract, as one device op."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    blanked = tokens.masked_fill(pos[None, :] >= lengths[:, None], msv_cuda.PAD_TOKEN)
    return blanked.contiguous()


@dataclasses.dataclass
class StagedDatabase:
    """Device-resident encoded sequence database."""

    tokens: torch.Tensor  # [B_pad, L_pad] int8, tails PAD_TOKEN
    lengths: torch.Tensor  # [B_pad] int32
    tr_rows: torch.Tensor  # [2, B_pad] f32 (tr_loop; tr_move)
    num_sequences: int  # true B before padding

    @property
    def total_residues(self) -> int:
        return int(self.lengths.sum())


class MSVScanner:
    """Profile-HMM MSV scan engine on one torch device.

    >>> scanner = MSVScanner(device="cuda")
    >>> staged = scanner.stage(tokens, lengths)
    >>> scores = scanner.scan(profile, staged)
    """

    #: max cached profile packs; covers the 24-profile sweep while
    #: bounding Pfam-scale runs
    _CACHE_MAX = 64

    def __init__(self, device: str | torch.device = "cuda", m_bucket: int = M_BUCKET):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but torch.cuda.is_available() "
                "is false"
            )
        if self.device.type == "cuda" and self.device.index is None:
            # tensors report cuda:N; name the device the same way
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.m_bucket = m_bucket
        # entries are (profile_object, payload): the stored reference pins
        # the object so its id() can never be recycled to another profile
        # (an id-keyed cache without the pin returns a stale pack); LRU so
        # a long sweep does not keep every pack on the device
        self._profile_cache: collections.OrderedDict = collections.OrderedDict()

    def _cache_get(self, key, obj):
        hit = self._profile_cache.get(key)
        if hit is not None and hit[0] is obj:
            self._profile_cache.move_to_end(key)
            return hit[1]
        return None

    def _cache_put(self, key, obj, payload):
        self._profile_cache[key] = (obj, payload)
        self._profile_cache.move_to_end(key)
        while len(self._profile_cache) > self._CACHE_MAX:
            self._profile_cache.popitem(last=False)
        return payload

    # -- staging ---------------------------------------------------------
    def stage(self, tokens: np.ndarray, lengths: np.ndarray) -> StagedDatabase:
        """Pad and upload a token batch once; reusable across profiles."""
        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths, dtype=np.int32)
        b, seq_len = tokens.shape
        tok = np.full((b, max(seq_len, 1)), msv_cuda.PAD_TOKEN, dtype=np.int8)
        tok[:, :seq_len] = tokens  # contiguous cast-store
        return self.stage_device(
            torch.from_numpy(tok).to(self.device), lengths, num_sequences=b
        )

    def stage_fasta(self, db: FastaDatabase) -> StagedDatabase:
        tokens, lengths = db.encode()
        return self.stage(tokens, lengths)

    def stage_device(
        self,
        tokens: torch.Tensor,
        lengths: np.ndarray,
        num_sequences: int | None = None,
    ) -> StagedDatabase:
        """Stage a token block already on this scanner's device.

        ``tokens`` is int8 ``[B_pad, L_pad]``; ``lengths`` the host-side
        ``[B_pad]`` array. Ragged tails are blanked here."""
        lengths_p = np.asarray(lengths, dtype=np.int32)
        if tokens.dtype != torch.int8 or tokens.dim() != 2:
            raise ValueError(f"tokens must be int8 [B, L], got {tokens.dtype} {tuple(tokens.shape)}")
        if tokens.device != self.device:
            raise ValueError(f"tokens are on {tokens.device}, scanner on {self.device}")
        if lengths_p.shape != (tokens.shape[0],):
            raise ValueError(f"lengths {lengths_p.shape} do not match tokens {tuple(tokens.shape)}")
        tr_loop, tr_move = length_transitions(lengths_p)
        lengths_dev = torch.from_numpy(lengths_p).to(self.device)
        return StagedDatabase(
            tokens=_blank_tail(tokens, lengths_dev),
            lengths=lengths_dev,
            tr_rows=torch.from_numpy(np.stack([tr_loop, tr_move])).to(self.device),
            num_sequences=(
                num_sequences if num_sequences is not None else tokens.shape[0]
            ),
        )

    # -- profile upload (cached) ----------------------------------------
    def _device_profile(self, profile: MSVProfile):
        key = id(profile)
        hit = self._cache_get(key, profile)
        if hit is not None:
            return hit
        m_pad = msv_cuda.round_up(profile.num_states, self.m_bucket)
        return self._cache_put(
            key, profile, msv_cuda.pack_profile(profile, m_pad, self.device)
        )

    # -- scan ------------------------------------------------------------
    def scan(self, profile: MSVProfile, staged: StagedDatabase) -> torch.Tensor:
        """Score every staged sequence against one profile -> f32 [B] on
        the scanner's device."""
        emit, tr_consts = self._device_profile(profile)
        m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
        scores, _, _ = msv_cuda.msv_scan(
            emit, staged.tokens, staged.lengths, staged.tr_rows, tr_consts, m, s
        )
        return scores[: staged.num_sequences]
