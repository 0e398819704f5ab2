"""Scan pipeline of the PyTorch port: stage a sequence database on a device
once, then scan profiles against it, one stage or the whole cascade.

The counterpart of ``hmm_fasta_viterbi_tpu/pipeline.py``: ``StagedDatabase``,
``MSVScanner.stage / stage_fasta / stage_device / scan / scan_filter /
scan_p7 / scan_p7_filter / scan_many``, the length-bucketed staging
(``BucketedDatabase``, ``stage_bucketed``, ``scan_bucketed``,
``scan_many_bucketed``, ``SearchPipeline.search_bucketed``), the
host-staged single-stage entry (``msv_scores``, ``select_p7_fns``,
``viterbi_scores``, ``forward_scores``, ``viterbi_filter_scores``) and the hmmsearch-style
``SearchPipeline`` (MSV -> Viterbi -> Forward, each stage rescoring the
survivors of the one before, optionally behind the upper-bound MSV and
Viterbi prefilters, or with ``fused=True`` the whole cascade enqueued on
the device: ``fused_cascade``, ``compact_rows``, ``fused_caps``); and the
streamed producer's stager, ``SideStreamStager``. Differences that follow
from the device:

* the device is named by the caller (``"cuda"``, ``"cuda:1"``, ``"cpu"``);
  nothing picks the CPU when CUDA is missing, and a CUDA scanner without
  CUDA raises;
* tokens stay int8 ``[B, L_pad]``, one sequence's residues contiguous for
  the kernel's warp; the TPU's ``[L_pad, B_pad]`` lane layout and its
  device transpose are not needed, and B is not padded;
* ``m_bucket`` pads the MSV M row to a multiple of it (default
  ``M_BUCKET``); the Viterbi/Forward packs keep the JAX packers' M_pad;
* the TPU's compile fallback from the lazy Viterbi kernel to the eager one
  is not carried over: a kernel that fails to build or launch raises;
* ``forward_scores(prob_space=False)`` runs the log-space Forward kernel,
  as ``forward_pallas(prob_space=False)`` does;
* the prefilters (``scan_filter``, ``scan_p7_filter``, ``scan_many(mode=
  "filter")``, ``SearchPipeline(fast_msv=, fast_viterbi=)``) run on every
  device, their plain versions on the CPU; the JAX package runs them on its
  Pallas backend only;
* ``scan_many`` groups profiles by the MSV kernel's register case on the
  card (``msv_cuda.kernel_case``) and by padded width past it (the
  rows-in-memory case) and on the CPU, not by an M bucket, and caches each
  group's stacked pack;
* ``stage_bucketed`` rounds each bucket's length cap to ``L_CHUNK`` (the
  JAX package's default ``l_chunk``), so its bucket partition is the JAX
  package's; a bucket is staged at its longest sequence, not rounded. The
  kernels stop at each sequence's length, so buckets save staged bytes,
  not DP cells: on the card ``scan_bucketed`` scores every bucket in one
  MSV launch over a row table of them all, longest rows first
  (``msv_cuda.RowTable``), where the JAX package, and the plain versions
  on the CPU, scan a bucket at a time;
* a batch staged by ``SideStreamStager`` (the streamed producer's
  ``stage_fn`` on a CUDA device) was uploaded on a side stream from a
  pinned ring; every scan entry makes the caller's current stream wait on
  the batch's event before its first kernel, and refuses such a batch
  without one;
* ``MSVScanner(mesh=)`` (or ``from_config`` with ``use_mesh``) builds a
  ``parallel.database.ShardedScanner``: one single-device scanner a
  device of a ``parallel.mesh.ScanMesh``, each batch staged as one row
  slice a db shard and the scores gathered in row order; a score depends
  only on its own row, so every stage equals this scanner's bit for bit;
* the fused cascade compacts survivors with a cumsum, a scatter and
  gathers (the TPU's one-hot matmuls are not needed), returns each
  compaction's batch rows rather than replaying its threshold compares on
  the host, and runs every stage at the batch's own width: the kernels
  stop at each sequence's length, so its Forward equals the staged one's
  bit for bit.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import math

import numpy as np
import torch

from .io.fastaio import FastaDatabase
from .models import stats
from .models.msv import MSVProfile, length_transitions
from .models.p7 import P7Profile

from .ops import msv_cuda, p7_cuda
from .runtime.profiling import SectionTimer, scope, span

logger = logging.getLogger(__name__)

# M row padding of the port's profile packs and carries (as the JAX XLA
# path's); the kernel pads further to its lane tile internally
M_BUCKET = 8
# the granule of stage_bucketed's length caps: the JAX package's default
# l_chunk (ops/pallas_msv.py DEFAULT_L_CHUNK), so the partitions agree
L_CHUNK = 256


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
    tr_probs: torch.Tensor  # [2, B_pad] f32 (host-exact p_loop; p_move)
    num_sequences: int  # true B before padding
    # the side stream the batch was uploaded on (SideStreamStager), None
    # for the caller's own stream, and the event its uploads end with
    stream: torch.cuda.Stream | None = None
    ready: torch.cuda.Event | None = None

    @property
    def total_residues(self) -> int:
        return int(self.lengths.sum())

    @property
    def width(self) -> int:
        return self.tokens.shape[1]


def _wait_ready(staged) -> None:
    """Make the current stream wait for a batch staged on a side stream
    (its uploads and blanking ran there); a no-op for a batch staged on
    the caller's stream."""
    if staged.stream is None:
        return
    if staged.ready is None:
        raise RuntimeError(
            "a batch staged on a side stream reached a scan without its event"
        )
    torch.cuda.current_stream(staged.tokens.device).wait_event(staged.ready)


@dataclasses.dataclass
class BucketedDatabase:
    """A ragged database staged as length-sorted buckets.

    Sequences are sorted by length and grouped so that no bucket pads a
    sequence by more than ``waste_factor`` of its rounded length. A
    single-device scanner stages every bucket as a view of one token
    buffer and lists all their rows, longest first, in ``table``, which
    :meth:`BatchScans.scan_bucketed` scans in one launch on the card; the
    CPU, a sharded staging (``table`` None) and the stacked sweeps scan a
    bucket at a time and scatter the scores back to the original order."""

    buckets: list  # StagedDatabase, or ShardedDatabase on a mesh
    order: list[np.ndarray]  # original indices per bucket
    num_sequences: int
    # on the scanner's device: the position of each original row in the
    # buckets' scores, concatenated
    inverse: torch.Tensor
    table: msv_cuda.RowTable | None = None

    @property
    def padded_cells_saved(self) -> float:
        """Fraction of staged residues avoided against one staging padded
        to the longest bucket's width."""
        if not self.buckets:
            return 0.0
        per_bucket = sum(s.width * s.num_sequences for s in self.buckets)
        single = max(s.width for s in self.buckets) * self.num_sequences
        return 1.0 - per_bucket / single if single else 0.0

    def in_order(self, scores: list[torch.Tensor]) -> torch.Tensor:
        """Each bucket's scores (rows along the last dimension) joined in
        the original row order, on the device."""
        return torch.cat(scores, dim=-1)[..., self.inverse]


def _width(lengths: np.ndarray, idx: np.ndarray) -> int:
    """The staged width of the rows ``idx``: their longest row, at least 1."""
    return max(int(lengths[idx].max()), 1)


class BatchScans:
    """What a scanner builds on its own ``stage``, ``scan``, ``scan_filter``
    and ``_many`` (the stacked launches of a sweep): the FASTA staging, the
    length-bucketed staging and scans, and the name-keyed sweeps. Shared
    by :class:`MSVScanner` and ``parallel.database.ShardedScanner``."""

    device: torch.device
    # scan_bucketed's calls, and the MSV launches they made
    bucketed_scans: int
    bucketed_launches: int

    def stage_fasta(self, db: FastaDatabase):
        tokens, lengths = db.encode()
        return self.stage(tokens, lengths)

    def stage_bucketed(
        self,
        tokens: np.ndarray,
        lengths: np.ndarray,
        waste_factor: float = 0.25,
    ) -> BucketedDatabase:
        """Stage a ragged batch as length-sorted buckets (see
        :class:`BucketedDatabase`). ``waste_factor`` caps per-sequence
        padding: a bucket closes when the next (longer) sequence's length
        exceeds the bucket's shortest, times ``1 + waste_factor`` and
        rounded up to ``L_CHUNK``."""
        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths, dtype=np.int32)
        b = tokens.shape[0]
        order = np.argsort(lengths, kind="stable")

        bucket_order: list[np.ndarray] = []
        start = 0
        while start < b:
            lo = max(int(lengths[order[start]]), 1)
            cap = msv_cuda.round_up(max(int(lo * (1.0 + waste_factor)), 1), L_CHUNK)
            end = start
            while end < b and lengths[order[end]] <= cap:
                end += 1
            bucket_order.append(order[start:end])
            start = end
        buckets, table = self._stage_buckets(tokens, lengths, bucket_order)
        inverse = np.empty(b, dtype=np.int64)
        inverse[order] = np.arange(b)  # the buckets hold the rows in `order`
        return BucketedDatabase(buckets=buckets, order=bucket_order, num_sequences=b,
                                inverse=torch.from_numpy(inverse).to(self.device), table=table)

    def _stage_buckets(self, tokens: np.ndarray, lengths: np.ndarray, parts: list):
        """``(buckets, table)``: each bucket's rows staged on their own at
        their longest row's width; no row table (a sharded staging scans a
        bucket at a time)."""
        return [self.stage(tokens[idx, :_width(lengths, idx)], lengths[idx]) for idx in parts], None

    def scan_bucketed(
        self, profile: MSVProfile, bucketed: BucketedDatabase, mode: str = "exact"
    ) -> np.ndarray:
        """Score every sequence of a bucketed database -> f32 [B] host
        array in the original order, as :meth:`scan` (or with
        ``mode="filter"`` :meth:`scan_filter`) scores it: on a CUDA device
        one launch over the staging's row table; without a table (sharded),
        or on the CPU, whose plain versions step a whole bucket at a time
        and have no warps to balance, a scan a bucket. ``bucketed_scans``
        counts the calls, ``bucketed_launches`` the MSV scans they made."""
        if mode not in ("exact", "filter"):
            raise ValueError(f"mode must be 'exact' or 'filter', got {mode!r}")
        if not bucketed.buckets:
            return np.empty(0, dtype=np.float32)
        self.bucketed_scans += 1
        if bucketed.table is not None and self.device.type == "cuda":
            self.bucketed_launches += 1
            return self._scan_table(profile, bucketed.table, mode).cpu().numpy()
        self.bucketed_launches += len(bucketed.buckets)
        scan = self.scan if mode == "exact" else self.scan_filter
        scores = [scan(profile, staged) for staged in bucketed.buckets]
        return bucketed.in_order(scores).cpu().numpy()

    def scan_many(
        self, profiles: list[MSVProfile], staged: StagedDatabase, mode: str = "exact"
    ) -> dict[str, np.ndarray]:
        """Sweep: score the staged database against many profiles -> {name:
        f32 [B] host array}.

        On the card, profiles that fall in one register case of the MSV
        kernel (``msv_cuda.kernel_case``) run as one stacked launch, one
        grid row a profile, and those past it (the rows-in-memory case) one
        launch a padded width; on the CPU the plain version groups them by
        padded width, which has no cap. Each group's stacked pack is
        cached. ``mode="filter"``
        scans the bf16 round-up tables instead (:meth:`scan_filter`'s
        upper bounds). Each profile's scores equal its single-profile
        scan's bit for bit."""
        if mode not in ("exact", "filter"):
            raise ValueError(f"mode must be 'exact' or 'filter', got {mode!r}")
        return _by_name(self._many(profiles, staged, mode))

    def scan_many_bucketed(
        self, profiles: list[MSVProfile], bucketed: BucketedDatabase, mode: str = "exact"
    ) -> dict[str, np.ndarray]:
        """:meth:`scan_many` over a length-bucketed database: the stacked
        launches a bucket, scores put back in the original order."""
        if not bucketed.buckets:
            return {p.name: np.empty(0, dtype=np.float32) for p in profiles}
        per_bucket = [self._many(profiles, staged, mode) for staged in bucketed.buckets]
        return _by_name([
            (group, bucketed.in_order([launched[k][1] for launched in per_bucket]))
            for k, (group, _) in enumerate(per_bucket[0])
        ])


class MSVScanner(BatchScans):
    """Profile-HMM MSV scan engine on one torch device.

    >>> scanner = MSVScanner(device="cuda")
    >>> staged = scanner.stage(tokens, lengths)
    >>> scores = scanner.scan(profile, staged)

    ``MSVScanner(mesh=m)`` (``parallel.mesh.make_scan_mesh``) returns a
    ``parallel.database.ShardedScanner`` over the db axis of ``m``: the same
    entry points, every batch split into one row slice a db shard.
    """

    mesh = None  # the db sharding: see ``parallel.database.ShardedScanner``

    #: max cached profile packs; covers the 24-profile sweep while
    #: bounding Pfam-scale runs
    _CACHE_MAX = 64

    @classmethod
    def from_config(cls, config, device: str | torch.device = "cuda", devices=None
                    ) -> "MSVScanner":
        """Build from a ``runtime.config.EngineConfig``: its ``m_bucket``,
        and with ``use_mesh`` a (mesh_db x mesh_sp) mesh over ``devices``
        (default: the visible CUDA devices), every scan sharded over its db
        axis."""
        if not config.use_mesh:
            return cls(device=device, m_bucket=config.m_bucket)
        from .parallel.mesh import make_scan_mesh

        mesh = make_scan_mesh(db=config.mesh_db, sp=config.mesh_sp, devices=devices)
        return cls(m_bucket=config.m_bucket, mesh=mesh)

    def __new__(cls, device: str | torch.device = "cuda", m_bucket: int = M_BUCKET,
                mesh=None):
        if mesh is None:
            return super().__new__(cls)
        from .parallel.database import ShardedScanner

        return ShardedScanner(mesh, m_bucket=m_bucket)

    def __init__(self, device: str | torch.device = "cuda", m_bucket: int = M_BUCKET,
                 mesh=None):
        # a ``mesh`` never reaches here: __new__ returned a ShardedScanner
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
        # the pack cache's lookups and the packs built on a miss: builds
        # over lookups is the cache's waste
        self.pack_lookups = 0
        self.pack_builds = 0
        self.bucketed_scans = 0
        self.bucketed_launches = 0

    def _cache_get(self, key, obj):
        """The payload cached under ``key`` for ``obj`` (a profile, or a
        tuple of profiles for a stacked pack: each element must be the one
        pinned), else None."""
        hit = self._profile_cache.get(key)
        if hit is not None and _same(hit[0], obj):
            self._profile_cache.move_to_end(key)
            return hit[1]
        return None

    def _cache_put(self, key, obj, payload):
        self._profile_cache[key] = (obj, payload)
        self._profile_cache.move_to_end(key)
        while len(self._profile_cache) > self._CACHE_MAX:
            self._profile_cache.popitem(last=False)
        return payload

    def _cached(self, key, obj, build):
        """The payload cached under ``key`` for ``obj`` (:meth:`_cache_get`),
        else ``build()``'s, timed as a ``pack`` span and cached."""
        self.pack_lookups += 1
        hit = self._cache_get(key, obj)
        if hit is not None:
            return hit
        self.pack_builds += 1
        with span("pack"):
            payload = build()
        return self._cache_put(key, obj, payload)

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
        lengths_dev = torch.from_numpy(lengths_p).to(self.device)
        return self._staged(_blank_tail(tokens, lengths_dev), lengths_p, lengths_dev,
                            num_sequences if num_sequences is not None else tokens.shape[0])

    def _staged(self, tokens: torch.Tensor, lengths_p: np.ndarray, lengths_dev: torch.Tensor,
                num_sequences: int) -> StagedDatabase:
        """A staging of blanked device tokens and their lengths (host and
        device), with the rows' length transitions."""
        tr_loop, tr_move = length_transitions(lengths_p)
        return StagedDatabase(
            tokens=tokens,
            lengths=lengths_dev,
            tr_rows=torch.from_numpy(np.stack([tr_loop, tr_move])).to(self.device),
            tr_probs=torch.from_numpy(
                p7_cuda.length_transition_probs(lengths_p)
            ).to(self.device),
            num_sequences=num_sequences,
        )

    def _stage_buckets(self, tokens: np.ndarray, lengths: np.ndarray, parts: list):
        """``(buckets, table)``: every bucket staged at its longest row's
        width as a view of one device token buffer, one after the other,
        uploaded into it and blanked in place, and the row table of all
        their rows, longest first. The buckets hold the rows in ascending
        length order, so the table lists them backwards; its lengths and
        transitions are the buckets' own."""
        if not parts:
            return [], None
        widths = [_width(lengths, idx) for idx in parts]
        sizes = [idx.size * w for idx, w in zip(parts, widths)]
        starts = np.cumsum([0] + sizes)
        buffer = torch.empty(int(starts[-1]), dtype=torch.int8, device=self.device)
        buckets = []
        for idx, w, at, n in zip(parts, widths, starts, sizes):
            view = buffer[at:at + n].view(idx.size, w)
            src = np.ascontiguousarray(tokens[idx, :w], dtype=np.int8)
            # columns past the host array's (none but at width 1) are
            # blanked below with every position past a row's length
            view[:, :src.shape[1]].copy_(torch.from_numpy(src))
            lengths_dev = torch.from_numpy(lengths[idx]).to(self.device)
            pos = torch.arange(w, device=self.device)
            view.masked_fill_(pos[None, :] >= lengths_dev[:, None], msv_cuda.PAD_TOKEN)
            buckets.append(self._staged(view, lengths[idx], lengths_dev, idx.size))
        row_at = np.concatenate([at + w * np.arange(idx.size, dtype=np.int64)
                                 for idx, w, at in zip(parts, widths, starts)])
        table = msv_cuda.RowTable(
            tokens=buffer,
            row_at=torch.from_numpy(row_at[::-1].copy()).to(self.device),
            lengths=torch.cat([s.lengths for s in buckets]).flip(0),
            tr_rows=torch.cat([s.tr_rows for s in buckets], dim=1).flip(1).contiguous(),
            dest=torch.from_numpy(np.concatenate(parts)[::-1].astype(np.int32)).to(self.device),
            width=max(widths),
        )
        return buckets, table

    # -- profile upload (cached) ----------------------------------------
    def _device_profile(self, profile: MSVProfile):
        m_pad = msv_cuda.round_up(profile.num_states, self.m_bucket)
        return self._cached(id(profile), profile,
                            lambda: msv_cuda.pack_profile(profile, m_pad, self.device))

    def _device_profile_filter(self, profile: MSVProfile):
        m_pad = msv_cuda.round_up(profile.num_states, self.m_bucket)
        return self._cached((id(profile), "filter"), profile,
                            lambda: msv_cuda.pack_profile_filter(profile, m_pad, self.device))

    # -- scan ------------------------------------------------------------
    def scan(self, profile: MSVProfile, staged: StagedDatabase) -> torch.Tensor:
        """Score every staged sequence against one profile -> f32 [B] on
        the scanner's device."""
        _wait_ready(staged)
        emit, tr_consts = self._device_profile(profile)
        m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
        scores, _, _ = msv_cuda.msv_scan(
            emit, staged.tokens, staged.lengths, staged.tr_rows, tr_consts, m, s
        )
        return scores[: staged.num_sequences]

    def _scan_table(self, profile: MSVProfile, table: msv_cuda.RowTable, mode: str
                    ) -> torch.Tensor:
        """Every row of a row table against one profile in one launch -> f32
        [B] on the scanner's device in the rows' original order: the exact
        table, or with ``mode="filter"`` the filter's bf16 one."""
        pack = self._device_profile if mode == "exact" else self._device_profile_filter
        emit, tr_consts = pack(profile)
        return msv_cuda.msv_table_scan(emit, table, tr_consts)

    def scan_filter(self, profile: MSVProfile, staged: StagedDatabase) -> torch.Tensor:
        """The MSV prefilter -> f32 [B] on the scanner's device: the scan
        over the bf16 round-up of the emission table, so every score is an
        upper bound on :meth:`scan`'s (max-plus DP is monotone). Thresholding
        on it drops no sequence the exact scan would keep. The pack is
        cached under ``(id(profile), "filter")``."""
        _wait_ready(staged)
        emit, tr_consts = self._device_profile_filter(profile)
        m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
        scores, _, _ = msv_cuda.msv_filter_scan(
            emit, staged.tokens, staged.lengths, staged.tr_rows, tr_consts, m, s
        )
        return scores[: staged.num_sequences]

    def _stacked_pack(self, group: tuple, mode: str):
        """The stacked ``(emit [P, 20, M_pad], tr_consts [P, 3])`` of a group
        of profiles, cached and pinned on the group (the profiles' ids in
        order, each profile object held)."""
        m_pad = msv_cuda.round_up(max(p.num_states for p in group), self.m_bucket)
        return self._cached(
            ("stacked", mode, tuple(id(p) for p in group)), group,
            lambda: msv_cuda.pack_stacked(group, m_pad, self.device, filter_mode=mode == "filter"),
        )

    def _many(self, profiles: list[MSVProfile], staged, mode: str) -> list:
        """:meth:`scan_many`'s stacked launches: ``[(group, scores [P, B]
        on the device)]``, one a group of profiles, nothing synchronized."""
        _wait_ready(staged)

        def case(m_pad):
            if self.device.type == "cuda":
                lanes, per = msv_cuda.kernel_case(m_pad)
                if lanes != msv_cuda.MEM_LANES:
                    return lanes, per
            return 0, m_pad

        groups: dict[tuple, list[MSVProfile]] = {}
        for p in profiles:
            m_pad = msv_cuda.round_up(p.num_states, self.m_bucket)
            groups.setdefault(case(m_pad), []).append(p)
        launched = []
        for _, group in sorted(groups.items()):
            emit, tr_consts = self._stacked_pack(tuple(group), mode)
            scores = msv_cuda.msv_stacked_scan(
                emit, staged.tokens, staged.lengths, staged.tr_rows, tr_consts
            )
            launched.append((group, scores[:, : staged.num_sequences]))
        return launched

    # -- full-profile stages -------------------------------------------
    def _p7_pack(self, p7: P7Profile, stage: str) -> p7_cuda.P7Pack:
        """The stage's pack of ``p7`` (cached, keyed ``(id(p7), "p7",
        stage)`` and pinned like the MSV packs): Forward's probability pack,
        or for Viterbi the lazy kernel's when ``e_skip_d_ok(p7)`` holds and
        the eager kernel's otherwise."""
        def build():
            if stage == "forward":
                return p7_cuda.forward_pack(p7, self.device)
            return p7_cuda.viterbi_pack(p7, self.device, lazy=p7_cuda.e_skip_d_ok(p7))

        return self._cached((id(p7), "p7", stage), p7, build)

    def _p7_filter_pack(self, p7: P7Profile, window_log2: int | None) -> p7_cuda.P7FilterPack:
        return self._cached((id(p7), "p7_filter", window_log2), p7,
                            lambda: p7_cuda.filter_pack(p7, self.device, window_log2=window_log2))

    def scan_p7_filter(
        self, p7: P7Profile, staged: StagedDatabase, window_log2: int | None = None
    ) -> torch.Tensor:
        """The upper-bound Viterbi prefilter -> f32 [B] on the scanner's
        device: every score >= :meth:`scan_p7`'s Viterbi score, so
        thresholding on it drops no sequence the exact stage would keep.
        ``window_log2`` None auto-picks the chain window per profile
        (``p7_cuda.pick_filter_window``)."""
        _wait_ready(staged)
        pack = self._p7_filter_pack(p7, window_log2)
        return _viterbi_filter(pack, staged)[: staged.num_sequences]

    def scan_p7(self, p7: P7Profile, staged: StagedDatabase, stage: str = "viterbi") -> torch.Tensor:
        """Viterbi or Forward scores of every staged sequence -> f32 [B] on
        the scanner's device."""
        if stage not in ("viterbi", "forward"):
            raise ValueError(f"stage must be 'viterbi' or 'forward', got {stage!r}")
        _wait_ready(staged)
        pack = self._p7_pack(p7, stage)
        if stage == "forward":
            scores = _forward(pack, staged)
        else:
            scores = _viterbi(pack, staged)
        return scores[: staged.num_sequences]


# batches the streamed producer may stage ahead of the consumer: the
# ``depth`` the CLI gives ``io.loader.stream_fasta_prefetch``, and one less
# than SideStreamStager's pinned buffers
PREFETCH_DEPTH = 2


class SideStreamStager:
    """The streamed producer's ``stage_fn`` (``io.loader.
    stream_fasta_prefetch`` with ``depth=PREFETCH_DEPTH``): stages each
    batch for ``scanner`` on the producer thread while the consumer scans
    the one before.

    On a CUDA device each batch is copied into a pinned host buffer, one of
    a ring of ``PREFETCH_DEPTH + 1``, and
    uploaded with a non-blocking copy on one side stream, made current
    inside the producer thread (PyTorch's current stream is per thread):
    on the consumer's stream the upload would queue behind its kernels.
    ``stage_device``'s blanking and its length and transition uploads run
    on the same stream, and the event recorded after them travels with the
    batch (``StagedDatabase.ready``): each scan entry makes the consumer's
    stream wait on it. Every staged tensor is marked used by the consumer's
    stream (``record_stream``), so the caching allocator does not hand its
    block back to the side stream while the consumer's kernels read it, and
    a ring slot is rewritten only after the event of its last copy. Making
    the stream or pinning a buffer raises on failure. On the CPU it is
    ``scanner.stage``. A ``parallel.database.ShardedScanner``'s stager is
    ``parallel.database.ShardedStager``.
    """

    def __init__(self, scanner: MSVScanner):
        self.scanner = scanner
        self.batches = 0  # batches staged on the side stream
        self.stream: torch.cuda.Stream | None = None
        self.consumer: torch.cuda.Stream | None = None
        if scanner.device.type == "cuda":
            # made on the consumer's thread: its stream is the current one
            self.consumer = torch.cuda.current_stream(scanner.device)
            self.stream = torch.cuda.Stream(device=scanner.device)
            self._ring: list[torch.Tensor | None] = [None] * (PREFETCH_DEPTH + 1)
            self._done: list[torch.cuda.Event | None] = [None] * (PREFETCH_DEPTH + 1)
            self._slot = 0

    def __call__(self, tokens: np.ndarray, lengths: np.ndarray) -> StagedDatabase:
        if self.stream is None:
            return self.scanner.stage(tokens, lengths)
        tokens = np.asarray(tokens)
        b, seq_len = tokens.shape
        width = max(seq_len, 1)
        slot = self._slot
        self._slot = (slot + 1) % len(self._ring)
        if self._done[slot] is not None:
            self._done[slot].synchronize()  # the slot's last upload has read it
        buf = self._ring[slot]
        if buf is None or buf.numel() < b * width:
            buf = self._ring[slot] = torch.empty(b * width, dtype=torch.int8, pin_memory=True)
        host = buf[: b * width].view(b, width)
        rows = host.numpy()
        rows[:, seq_len:] = msv_cuda.PAD_TOKEN
        rows[:, :seq_len] = tokens  # contiguous cast-store, as stage()
        with torch.cuda.stream(self.stream):
            dev = torch.empty((b, width), dtype=torch.int8, device=self.scanner.device)
            dev.copy_(host, non_blocking=True)
            staged = self.scanner.stage_device(dev, lengths, num_sequences=b)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self._done[slot] = ready
        for t in (staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs):
            t.record_stream(self.consumer)
        staged.stream, staged.ready = self.stream, ready
        self.batches += 1
        return staged


def _viterbi(pack: p7_cuda.P7Pack, staged: StagedDatabase) -> torch.Tensor:
    """Viterbi scores [B_pad] from a fresh carry: the lazy kernel for a pack
    with a window, the eager one otherwise."""
    m, i, d, s = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)
    args = (*pack[:4], staged.tokens, staged.lengths, staged.tr_rows, pack.consts, m, i, d, s)
    if pack.lazy_k:
        return p7_cuda.viterbi_lazy_scan(*args, pack.lazy_k)[0]
    return p7_cuda.viterbi_scan(*args)[0]


def _viterbi_filter(pack: p7_cuda.P7FilterPack, staged: StagedDatabase) -> torch.Tensor:
    m, i, d, s = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)
    return p7_cuda.viterbi_filter_scan(
        *pack[:4], staged.tokens, staged.lengths, staged.tr_rows, pack.consts, m, i, d, s,
        pack.window, pack.e_skip_d,
    )[0]


def _by_name(launched: list) -> dict[str, np.ndarray]:
    """{profile name: f32 [B] host array} of a scanner's ``_many``
    launches."""
    results: dict[str, np.ndarray] = {}
    for group, scores in launched:
        for p, row in zip(group, scores.cpu().numpy()):
            results[p.name] = row
    return results


def _same(held, obj) -> bool:
    """``held`` is ``obj``, or both are tuples of the same objects."""
    if isinstance(obj, tuple):
        return (isinstance(held, tuple) and len(held) == len(obj)
                and all(a is b for a, b in zip(held, obj)))
    return held is obj


def _forward(pack: p7_cuda.P7Pack, staged: StagedDatabase) -> torch.Tensor:
    m, i, d, s = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)
    return p7_cuda.forward_prob_scan(
        *pack[:4], staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
        pack.consts, m, i, d, s,
    )[0]


# -- host-staged single-stage entry (msv_pallas / msv_xla / select_p7_fns /
# viterbi_pallas / forward_pallas of the JAX package) ------------------------

def msv_scores(profile: MSVProfile, tokens, lengths, device="cuda") -> torch.Tensor:
    """Exact MSV scores of a host token batch -> f32 [B]: staged, packed
    and scanned in one call (``msv_pallas`` / ``msv_xla`` of the JAX
    package), the kernel on a CUDA device, its plain version on the CPU."""
    scanner = MSVScanner(device=device)
    return scanner.scan(profile, scanner.stage(tokens, lengths))


def viterbi_scores(
    p7: P7Profile, tokens, lengths, device="cuda", lazy: bool = True,
    lazy_k: int | None = None,
) -> torch.Tensor:
    """Full local Viterbi scores of a host token batch -> f32 [B].

    The lazy kernel when ``lazy`` and ``e_skip_d_ok(p7)`` (window ``lazy_k``,
    auto-picked when None), the eager one otherwise; both give the same
    scores."""
    scanner = MSVScanner(device=device)
    staged = scanner.stage(tokens, lengths)
    lazy = lazy and p7_cuda.e_skip_d_ok(p7)
    pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=lazy, lazy_k=lazy_k)
    return _viterbi(pack, staged)[: staged.num_sequences]


def forward_scores(
    p7: P7Profile, tokens, lengths, device="cuda", prob_space: bool = True,
) -> torch.Tensor:
    """Forward scores (nats) of a host token batch -> f32 [B], through the
    probability-space scan, or with ``prob_space=False`` the log-space
    semiring scan (``forward_pallas(prob_space=False)``), the careful
    referee of the first on long sequences."""
    scanner = MSVScanner(device=device)
    staged = scanner.stage(tokens, lengths)
    if prob_space:
        scores = _forward(p7_cuda.forward_pack(p7, scanner.device), staged)
    else:
        pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
        scores = p7_cuda.forward_log_scan(
            *pack[:4], staged.tokens, staged.lengths, staged.tr_rows, pack.consts,
            *p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad),
        )[0]
    return scores[: staged.num_sequences]


def viterbi_filter_scores(
    p7: P7Profile, tokens, lengths, device="cuda", window_log2: int | None = None,
) -> torch.Tensor:
    """Upper-bound Viterbi filter scores of a host token batch -> f32 [B],
    each >= the exact Viterbi score (``viterbi_filter_pallas`` of the JAX
    package). ``window_log2`` None auto-picks the chain window."""
    scanner = MSVScanner(device=device)
    staged = scanner.stage(tokens, lengths)
    pack = p7_cuda.filter_pack(p7, scanner.device, window_log2=window_log2)
    return _viterbi_filter(pack, staged)[: staged.num_sequences]


def select_p7_fns(device="cuda"):
    """``(viterbi_fn, forward_fn)``, each ``fn(p7, tokens, lengths)`` -> f32
    [B] on ``device``: the kernels on a CUDA device, their plain versions on
    the CPU."""
    return (
        functools.partial(viterbi_scores, device=device),
        functools.partial(forward_scores, device=device),
    )


# -- the fused cascade (``_fused_cascade`` of the JAX package) ---------------

# the JAX package's lane tile (pallas_msv.LANES): its batch padding, which
# its survivor capacities are computed on, and the Viterbi stage's cap
FUSED_LANES = 128


def gumbel_score_threshold(p: float, mu: float, lam: float) -> float:
    """Smallest nat score with Gumbel P-value <= p (exact f64 inverse):
    pv(b) <= p  <=>  b_bits >= mu - ln(-ln(1-p)) / lambda."""
    bits = mu - math.log(-math.log1p(-p)) / lam
    return bits * math.log(2.0)


def _conservative_f32(x: float) -> np.float32:
    """One-ulp-down f32 threshold: device pruning with it passes a superset
    of what the host's exact f64 decision passes (the extras are rescored
    and decided again on the host: never a lost hit)."""
    return np.nextafter(np.float32(x), np.float32(-np.inf), dtype=np.float32)


def fused_caps(num_sequences: int, msv_p: float) -> tuple[int, int, int]:
    """The survivor capacities ``(cap1, cap2, cap3)`` of the fused cascade
    after the MSV filter, the exact MSV and the Viterbi filter: the JAX
    package's formula on its batch padding, so that the port overflows
    where it does."""
    b_pad = msv_cuda.round_up(max(num_sequences, 1), FUSED_LANES)
    cap1 = int(np.clip(msv_cuda.round_up(int(b_pad * msv_p * 6) + 64, FUSED_LANES),
                       FUSED_LANES, b_pad))
    cap2 = int(np.clip(msv_cuda.round_up(int(b_pad * msv_p * 2) + 64, FUSED_LANES),
                       FUSED_LANES, cap1))
    return cap1, cap2, min(cap2, FUSED_LANES)


def compact_rows(alive: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``alive [B]`` bool -> ``(index [cap] int64, n)``: the rows of the
    first ``cap`` survivors in their order, -1 in the slots left empty, and
    the survivor count ``n`` (a 0-dim tensor, which may exceed ``cap``).
    Torch ops on ``alive``'s device that never wait for it: a survivor
    goes to slot ``cumsum - 1``, and one past ``cap`` to a trash slot."""
    pos = torch.cumsum(alive, dim=0) - 1
    slot = torch.where(alive & (pos < cap), pos, cap)
    index = torch.full((cap + 1,), -1, dtype=torch.int64, device=alive.device)
    index.scatter_(0, slot, torch.arange(alive.shape[0], device=alive.device))
    return index[:cap], alive.sum()


def _gather_rows(staged: StagedDatabase, index: torch.Tensor) -> StagedDatabase:
    """The rows ``index`` of a staged batch (:func:`compact_rows`) staged as
    a batch of their own at the same width; an empty slot (-1) becomes a
    sequence of length 0 (tr_loop -inf, p_move 1), which every kernel
    leaves at its row-0 carry."""
    valid = index >= 0
    rows = index.clamp(min=0)
    lengths = torch.where(valid, staged.lengths.index_select(0, rows), 0)
    tr = staged.tr_rows.index_select(1, rows)
    probs = staged.tr_probs.index_select(1, rows)
    return StagedDatabase(
        tokens=_blank_tail(staged.tokens.index_select(0, rows), lengths),
        lengths=lengths,
        tr_rows=torch.stack([torch.where(valid, tr[0], msv_cuda.NEG_INF),
                             torch.where(valid, tr[1], 0.0)]),
        tr_probs=torch.stack([torch.where(valid, probs[0], 0.0),
                              torch.where(valid, probs[1], 1.0)]),
        num_sequences=index.shape[0],
    )


def _through(index: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The batch rows of a compaction's slots, given the batch rows
    ``rows`` of the slots it compacted; -1 stays -1."""
    return torch.where(index >= 0, rows.index_select(0, index.clamp(min=0)), -1)


def fused_cascade(
    scanner: MSVScanner, msv_profile: MSVProfile, p7: P7Profile, staged: StagedDatabase,
    thresholds: torch.Tensor, caps: tuple[int, int, int],
) -> dict[str, torch.Tensor]:
    """The whole cascade enqueued on the scanner's device, nothing read
    back: the MSV filter over the batch, then each stage on the survivors
    of the one before, compacted on the device (:func:`compact_rows`) and
    rescored through the scanner's own launch paths: the exact MSV, the
    Viterbi filter, then the Viterbi (lazy or eager, as
    ``MSVScanner._p7_pack`` picks) and the Forward, both on every row that
    passes the Viterbi filter.

    ``thresholds`` is the device f32 ``[msv, viterbi]`` one-ulp-low nat
    thresholds (:func:`_conservative_f32`); ``caps`` the slots after each
    of the three prunings (:func:`fused_caps`). A compaction holds at most
    as many slots as rows reach it, and one that overflows its cap keeps
    the first survivors. Returns device tensors: ``filt [B]``, and for
    each pruning k = 1, 2, 3 the survivor count ``n<k>`` and the batch row
    of each slot, ``rows<k>`` (-1 empty), with the scores on those slots:
    ``exact1``, ``vfilt``, ``vit``, ``fwd``. CPU tensors run the plain
    versions."""
    _wait_ready(staged)
    cap1, cap2, cap3 = caps
    filt = scanner.scan_filter(msv_profile, staged)
    alive = (filt >= thresholds[0]) & (staged.lengths[: staged.num_sequences] > 0)
    index1, n1 = compact_rows(alive, min(cap1, alive.shape[0]))
    sub1 = _gather_rows(staged, index1)
    exact1 = scanner.scan(msv_profile, sub1)
    index2, n2 = compact_rows((exact1 >= thresholds[0]) & (index1 >= 0),
                              min(cap2, index1.shape[0]))
    sub2 = _gather_rows(sub1, index2)
    vfilt = scanner.scan_p7_filter(p7, sub2)
    index3, n3 = compact_rows((vfilt >= thresholds[1]) & (index2 >= 0),
                              min(cap3, index2.shape[0]))
    sub3 = _gather_rows(sub2, index3)
    rows2 = _through(index2, index1)
    return {
        "filt": filt, "n1": n1, "rows1": index1, "exact1": exact1,
        "n2": n2, "rows2": rows2, "vfilt": vfilt,
        "n3": n3, "rows3": _through(index3, rows2),
        "vit": scanner.scan_p7(p7, sub3, stage="viterbi"),
        "fwd": scanner.scan_p7(p7, sub3, stage="forward"),
    }


def _read_back(tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Every tensor of ``tensors`` on the host in one copy: joined as f64
    on the device (exact for f32 scores, and for int64 rows and counts
    below 2^53), then split and cast back."""
    flat = torch.cat([t.reshape(-1).double() for t in tensors.values()]).cpu().numpy()
    out, at = {}, 0
    for name, t in tensors.items():
        dtype = np.float32 if t.is_floating_point() else np.int64
        out[name] = flat[at: at + t.numel()].reshape(t.shape).astype(dtype)
        at += t.numel()
    return out


# -- the search cascade ----------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    """Outcome of the cascade for one profile (host arrays)."""

    msv_scores: np.ndarray  # [B] f32 (all sequences)
    msv_pvalues: np.ndarray
    viterbi_scores: np.ndarray  # [B] f32, NaN where not computed
    viterbi_pvalues: np.ndarray
    forward_scores: np.ndarray  # [B] f32, NaN where not computed
    forward_pvalues: np.ndarray
    passed_msv: np.ndarray  # [B] bool
    passed_viterbi: np.ndarray
    passed_forward: np.ndarray

    @property
    def hits(self) -> np.ndarray:
        return np.flatnonzero(self.passed_forward)


# the spans of a search, each a key of SearchPipeline.phase_seconds and
# phase_totals: the three stages, the host's P-values and pass decisions,
# the survivors' restaging and the pack builds on a cache miss
SEARCH_SPANS = ("msv", "viterbi", "forward", "pvalues", "restage", "pack")


class SearchPipeline:
    """hmmsearch-style cascade: MSV -> Viterbi -> Forward, with HMMER3's
    stage thresholds; each stage rescores only the previous stage's
    survivors, restaged compactly.

    A search is a :func:`~.runtime.profiling.scope` of the port's spans
    (and, while a trace records, a range ``search#<n>`` around them).
    ``phase_seconds`` holds the last search's host-clock seconds of each of
    ``SEARCH_SPANS``, ``phase_totals`` their sums over every search of this
    pipeline (``timer.seconds``; ``timer.calls`` counts the spans); both
    hold every key from the start and are updated in place. The stages
    ``msv``, ``viterbi`` and ``forward`` each end by copying their scores
    to the host, so the device work is inside; a prefilter counts into its
    stage, a survivor restaging (``restage``) into the stage it feeds.
    ``pvalues`` is every P-value and pass decision; in the plain cascade
    it lies between the stages. ``pack`` is a profile pack or derived
    profile built on a cache miss, inside whatever asked for it.

    ``fast_msv`` runs the upper-bound MSV filter over the whole database
    and rescores only its candidates exactly; ``fast_viterbi`` does the same
    with the Viterbi filter over the MSV survivors. A filter's score bounds
    the exact one from above, so its p-value bounds the exact one from
    below: a sequence the filter rejects is rejected by the exact stage
    too, and the hits are the plain cascade's. A sequence the filter
    rejects keeps the filter's score and p-value in the result.

    ``fused`` enqueues the whole cascade on the scanner's device
    (:func:`fused_cascade`: both prefilters always, survivors compacted on
    the device, pruned with one-ulp-low f32 thresholds) and reads it back
    once; the host then decides every stage in f64 as the staged cascade
    does, so the hits and stage decisions are the staged cascade's, and
    the result is ``fast_msv=fast_viterbi=True``'s but for a row whose
    filter score lies within an ulp of a threshold (rescored exactly here,
    kept at the filter's score there). A batch with more survivors than
    :func:`fused_caps` allows runs the staged cascade, as does a scanner
    sharded over a mesh; both are logged. ``fused_runs`` counts the
    searches the fused cascade answered; ``phase_seconds`` puts such a
    search under ``msv``, its host decisions under ``pvalues`` inside it."""

    def __init__(
        self,
        scanner: MSVScanner | None = None,
        msv_p: float = 0.02,
        viterbi_p: float = 1e-3,
        forward_p: float = 1e-5,
        fast_msv: bool = False,
        fast_viterbi: bool = False,
        fused: bool = False,
    ):
        self.scanner = scanner or MSVScanner()
        self.msv_p = msv_p
        self.viterbi_p = viterbi_p
        self.forward_p = forward_p
        self.fast_msv = fast_msv
        self.fast_viterbi = fast_viterbi
        self.fused = fused
        self.fused_runs = 0
        self.timer = SectionTimer(SEARCH_SPANS)
        self.phase_totals = self.timer.seconds
        self.phase_seconds = dict.fromkeys(SEARCH_SPANS, 0.0)
        # derived MSVProfile/P7Profile per hmm object, pinned and LRU-bounded
        # like MSVScanner._profile_cache: repeated searches with one hmm must
        # hand the scanner the same derived objects, or its id-keyed pack
        # cache would grow by one entry a call
        self._derived_cache: collections.OrderedDict = collections.OrderedDict()

    _DERIVED_MAX = 32

    @contextlib.contextmanager
    def _search_scope(self):
        """One search: its spans into ``timer`` and into ``phase_seconds``."""
        last = SectionTimer(SEARCH_SPANS)
        try:
            with scope(self.timer, "search"), scope(last):
                yield
        finally:
            self.phase_seconds.update(last.seconds)

    def _derived(self, hmm):
        hit = self._derived_cache.get(id(hmm))
        if hit is not None and hit[0] is hmm:
            self._derived_cache.move_to_end(id(hmm))
            return hit[1], hit[2]
        with span("pack"):
            msvp = MSVProfile.from_profile(hmm)
            p7 = P7Profile.from_profile(hmm)
        self._derived_cache[id(hmm)] = (hmm, msvp, p7)
        while len(self._derived_cache) > self._DERIVED_MAX:
            self._derived_cache.popitem(last=False)
        return msvp, p7

    def search(self, hmm, staged: StagedDatabase, tokens: np.ndarray, lengths: np.ndarray) -> SearchResult:
        """Run the cascade. ``hmm`` is a ProfileHMM; ``tokens``/``lengths``
        are the host arrays the survivor subsets are restaged from."""
        with self._search_scope():
            if self.fused:
                result = self._search_fused(hmm, staged)
                if result is not None:
                    return result
            msv_profile, p7 = self._derived(hmm)
            with span("msv"):
                if self.fast_msv:
                    # a copy: the candidates' exact scores are written into it
                    msv_scores = self.scanner.scan_filter(msv_profile, staged).cpu().numpy().copy()
                    self._rescore_candidates(hmm, msv_profile, msv_scores, tokens, lengths)
                else:
                    msv_scores = self.scanner.scan(msv_profile, staged).cpu().numpy()
            return self._finish_cascade(hmm, p7, msv_scores, tokens, lengths)

    def search_bucketed(
        self, hmm, bucketed: BucketedDatabase, tokens: np.ndarray, lengths: np.ndarray
    ) -> SearchResult:
        """The cascade over a length-bucketed staging
        (:meth:`MSVScanner.stage_bucketed`): the MSV stage (with
        ``fast_msv`` its filter) is :meth:`BatchScans.scan_bucketed`, on
        the card one launch over every bucket; the later stages restage survivors as
        :meth:`search` does."""
        with self._search_scope():
            msv_profile, p7 = self._derived(hmm)
            with span("msv"):
                msv_scores = self.scanner.scan_bucketed(
                    msv_profile, bucketed, mode="filter" if self.fast_msv else "exact"
                )
                if self.fast_msv:
                    self._rescore_candidates(hmm, msv_profile, msv_scores, tokens, lengths)
            return self._finish_cascade(hmm, p7, msv_scores, tokens, lengths)

    def _fused_thresholds(self, hmm) -> torch.Tensor:
        """The device f32 ``[msv, viterbi]`` one-ulp-low nat thresholds of
        ``hmm`` (JAX's ``_fused_packs``; the packs are the scanner's own),
        cached on the scanner under a key that holds this pipeline's
        p-value cutoffs, so a pipeline sharing the scanner with other
        cutoffs gets its own."""
        def build():
            thr = np.array([
                _conservative_f32(gumbel_score_threshold(
                    self.msv_p, hmm.stats_local_msv_mu, hmm.stats_local_msv_lambda)),
                _conservative_f32(gumbel_score_threshold(
                    self.viterbi_p, hmm.stats_local_viterbi_mu,
                    hmm.stats_local_viterbi_lambda)),
            ], dtype=np.float32)
            return torch.from_numpy(thr).to(self.scanner.device)

        return self.scanner._cached((id(hmm), "fused", self.msv_p, self.viterbi_p), hmm, build)

    def _search_fused(self, hmm, staged: StagedDatabase) -> SearchResult | None:
        """The cascade through :func:`fused_cascade` and one read-back; None
        (logged) on a scanner sharded over a mesh or when survivors
        overflow a cap, for the staged cascade to answer."""
        if not isinstance(self.scanner, MSVScanner):
            logger.info("fused cascade: the scanner is sharded over a mesh, running the "
                        "staged pipeline")
            return None
        msv_profile, p7 = self._derived(hmm)
        b = staged.num_sequences
        caps = fused_caps(b, self.msv_p)
        with span("msv"):
            got = _read_back(fused_cascade(self.scanner, msv_profile, p7, staged,
                                           self._fused_thresholds(hmm), caps))
            n1, n2, n3 = int(got["n1"]), int(got["n2"]), int(got["n3"])
            if n1 > caps[0] or n2 > caps[1] or n3 > caps[2]:
                logger.info("fused cascade capacity overflow (n1=%d n2=%d n3=%d) — falling "
                            "back to the staged pipeline", n1, n2, n3)
                return None

            # the host's f64 decisions on the returned scores, as the staged
            # cascade makes them; the device pruned with one-ulp-low
            # thresholds, a superset. The MSV filter's survivors carry their
            # exact scores
            with span("pvalues"):
                rows1, rows2, rows3 = got["rows1"][:n1], got["rows2"][:n2], got["rows3"][:n3]
                msv_scores = got["filt"]
                msv_scores[rows1] = got["exact1"][:n1]
                msv_pv = stats.msv_pvalue(msv_scores, hmm)
                passed_msv = msv_pv <= self.msv_p

                # an MSV survivor records its Viterbi filter score, and one
                # past the filter its exact Viterbi score
                vit_scores = np.full(b, np.nan, dtype=np.float32)
                keep2 = passed_msv[rows2]
                vit_scores[rows2[keep2]] = got["vfilt"][:n2][keep2]
                keep3 = passed_msv[rows3]
                vit_scores[rows3[keep3]] = got["vit"][:n3][keep3]
                vit_pv = np.full(b, np.nan)
                has_vit = np.isfinite(vit_scores)
                vit_pv[has_vit] = stats.viterbi_pvalue(vit_scores[has_vit], hmm)
                passed_vit = vit_pv <= self.viterbi_p

                fwd_scores = np.full(b, np.nan, dtype=np.float32)
                keep4 = keep3 & passed_vit[rows3]
                fwd_scores[rows3[keep4]] = got["fwd"][:n3][keep4]
                fwd_pv = np.full(b, np.nan)
                has_fwd = np.isfinite(fwd_scores)
                fwd_pv[has_fwd] = stats.forward_pvalue(fwd_scores[has_fwd], hmm)

        self.fused_runs += 1
        return SearchResult(
            msv_scores=msv_scores,
            msv_pvalues=msv_pv,
            viterbi_scores=vit_scores,
            viterbi_pvalues=vit_pv,
            forward_scores=fwd_scores,
            forward_pvalues=fwd_pv,
            passed_msv=passed_msv,
            passed_viterbi=passed_vit,
            passed_forward=fwd_pv <= self.forward_p,
        )

    def _restage(self, sel: np.ndarray, tokens: np.ndarray, lengths: np.ndarray):
        """The rows ``sel`` of the host arrays staged compactly, at their
        longest row's width: a ``restage`` span."""
        with span("restage"):
            l_max = max(int(lengths[sel].max()), 1)
            return self.scanner.stage(tokens[sel, :l_max], lengths[sel])

    def _rescore_candidates(self, hmm, msv_profile: MSVProfile, msv_scores: np.ndarray,
                            tokens: np.ndarray, lengths: np.ndarray) -> None:
        """Overwrite the MSV filter's scores of its candidates (p <=
        ``msv_p``) with their exact scores, restaged compactly."""
        with span("pvalues"):
            cand = np.flatnonzero(stats.msv_pvalue(msv_scores, hmm) <= self.msv_p)
        if cand.size:
            sub = self._restage(cand, tokens, lengths)
            msv_scores[cand] = self.scanner.scan(msv_profile, sub).cpu().numpy()

    def _finish_cascade(
        self, hmm, p7: P7Profile, msv_scores: np.ndarray,
        tokens: np.ndarray, lengths: np.ndarray,
    ) -> SearchResult:
        """Viterbi and Forward rescoring of the MSV survivors."""
        b = len(msv_scores)
        with span("pvalues"):
            msv_pv = stats.msv_pvalue(msv_scores, hmm)
            passed_msv = msv_pv <= self.msv_p
            idx = np.flatnonzero(passed_msv)
            vit_scores = np.full(b, np.nan, dtype=np.float32)
            vit_pv = np.full(b, np.nan)
            fwd_scores = np.full(b, np.nan, dtype=np.float32)
            fwd_pv = np.full(b, np.nan)
            passed_vit = np.zeros(b, dtype=bool)
            passed_fwd = np.zeros(b, dtype=bool)

        def _p7_stage(sel: np.ndarray, stage: str) -> np.ndarray:
            with span(stage):
                sub = self._restage(sel, tokens, lengths)
                return self.scanner.scan_p7(p7, sub, stage=stage).cpu().numpy()

        if idx.size:
            if self.fast_viterbi:
                # the filter's p-values bound the exact ones from below: a
                # filter rejection is an exact rejection
                with span("viterbi"):
                    sub = self._restage(idx, tokens, lengths)
                    vf = self.scanner.scan_p7_filter(p7, sub).cpu().numpy()
                with span("pvalues"):
                    vit_scores[idx] = vf
                    vit_pv[idx] = stats.viterbi_pvalue(vf, hmm)
                    idx = idx[vit_pv[idx] <= self.viterbi_p]
            if idx.size:
                vs = _p7_stage(idx, "viterbi")
                with span("pvalues"):
                    vit_scores[idx] = vs
                    vit_pv[idx] = stats.viterbi_pvalue(vs, hmm)
                    passed_vit[idx] = vit_pv[idx] <= self.viterbi_p
                    idx2 = np.flatnonzero(passed_vit)
                if idx2.size:
                    fs = _p7_stage(idx2, "forward")
                    with span("pvalues"):
                        fwd_scores[idx2] = fs
                        fwd_pv[idx2] = stats.forward_pvalue(fs, hmm)
                        passed_fwd[idx2] = fwd_pv[idx2] <= self.forward_p

        return SearchResult(
            msv_scores=msv_scores,
            msv_pvalues=msv_pv,
            viterbi_scores=vit_scores,
            viterbi_pvalues=vit_pv,
            forward_scores=fwd_scores,
            forward_pvalues=fwd_pv,
            passed_msv=passed_msv,
            passed_viterbi=passed_vit,
            passed_forward=passed_fwd,
        )
