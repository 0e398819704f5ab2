"""Database-sharded scans: the port's primary multi-device axis.

The counterpart of ``hmm_fasta_viterbi_tpu/parallel/database.py``.
Sequences are independent, so a batch is split into contiguous row slices,
one a db shard of the mesh; each shard is staged on its own device and
scanned there by the kernels of the single-device path (their plain
versions on the CPU), every shard launched before any is synchronized, and
the scores are gathered in row order onto the mesh's first device.

JAX's ``make_db_scanner``, ``make_db_p7_scanner``,
``make_db_p7_filter_scanner`` and ``make_db_posterior_scanner`` wrap one
Pallas kernel each in a ``shard_map``; here :class:`ShardedScanner` (what
``MSVScanner(mesh=)`` builds) holds one single-device ``MSVScanner`` a
distinct device and runs each of its stages a shard (:func:`run_shards`,
:func:`gather_shards`), as ``ops.posterior_cuda`` runs the decode. A shard
is a row slice of the port's ``[B, L]`` staging, not a 128-lane tile, so B
is padded only by :func:`pad_batch_to_mesh`, which keeps JAX's contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..pipeline import M_BUCKET, BatchScans, MSVScanner, SideStreamStager
from .mesh import DB_AXIS, ScanMesh, device_scope, gather_rows, shard_rows


@dataclasses.dataclass
class ShardedDatabase:
    """A batch staged over a mesh's db axis: this process's shards, each a
    ``StagedDatabase`` on its shard's device, and every shard's rows of the
    batch."""

    shards: dict  # db shard -> its staged block (this process's shards)
    rows: list[slice]  # each db shard's rows, in order
    num_sequences: int
    width: int  # the staged residue columns of every shard


def pad_batch_to_mesh(tokens: np.ndarray, lengths: np.ndarray, num_shards: int):
    """Pad the batch so it divides the db axis; pad rows have length 0
    (scored -inf, dropped by the caller via the returned true size)."""
    b = tokens.shape[0]
    padded = -(-b // num_shards) * num_shards
    if padded != b:
        tokens = np.concatenate(
            [tokens, np.zeros((padded - b, tokens.shape[1]), dtype=tokens.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(padded - b, dtype=lengths.dtype)])
    return tokens, lengths, b


def run_shards(mesh: ScanMesh, fn, shards: dict) -> dict:
    """``fn(d, shard)`` on each of this process's shards, under the shard's
    device. ``fn`` only launches (it returns device tensors), so every shard
    is launched before any is synchronized."""
    out = {}
    for d, shard in shards.items():
        with device_scope(mesh.device(d)):
            out[d] = fn(d, shard)
    return out


def gather_shards(mesh: ScanMesh, parts: dict, rows: list[slice], dim: int = -1) -> torch.Tensor:
    """:func:`mesh.gather_rows` of this process's ``parts``; across
    processes the shards owned elsewhere get zero stand-ins of their row
    count (``rows``)."""
    if mesh.process_count > 1:
        if not parts:
            raise ValueError(f"process {mesh.process_index} owns no db shard of {mesh}")
        like = next(iter(parts.values()))
        for d, r in enumerate(rows):
            if d not in parts:
                shape = list(like.shape)
                shape[dim] = r.stop - r.start
                parts[d] = torch.zeros(shape, dtype=like.dtype, device=like.device)
    return gather_rows(parts, mesh, dim=dim)


class ShardedScanner(BatchScans):
    """``MSVScanner``'s entry points sharded over the db axis of ``mesh``:
    every staging splits the batch into one row slice a db shard, staged on
    the shard's device by that device's ``MSVScanner`` (shards on one
    device share its packs), and every scan runs each of this process's
    shards there, all launched before any is synchronized, and returns the
    scores gathered in row order on ``self.device`` (the mesh's first
    device)."""

    def __init__(self, mesh: ScanMesh, m_bucket: int = M_BUCKET):
        self.mesh = mesh
        self.m_bucket = m_bucket
        self.device = mesh.first_device
        devices = dict.fromkeys(mesh.device(d) for d in mesh.local_shards())
        self.scanners = {x: MSVScanner(device=x, m_bucket=m_bucket) for x in devices}
        # a sharded staging has no row table: scan_bucketed scans a bucket
        # at a time
        self.bucketed_scans = 0
        self.bucketed_launches = 0

    def scanner(self, d: int) -> MSVScanner:
        """The scanner of db shard ``d``'s device."""
        return self.scanners[self.mesh.device(d)]

    @property
    def pack_lookups(self) -> int:
        """``MSVScanner.pack_lookups`` summed over the devices' scanners."""
        return sum(sc.pack_lookups for sc in self.scanners.values())

    @property
    def pack_builds(self) -> int:
        return sum(sc.pack_builds for sc in self.scanners.values())

    def stage_shards(self, stage, tokens, lengths, num_sequences: int | None = None,
                     width: int = 0) -> ShardedDatabase:
        """``stage(scanner, tokens[rows], lengths[rows])`` for each of this
        process's db shards, under the shard's device; ``width`` the staged
        columns."""
        rows = shard_rows(len(lengths), self.mesh.shape[DB_AXIS])
        shards = {}
        for d in self.mesh.local_shards():
            with device_scope(self.mesh.device(d)):
                shards[d] = stage(self.scanner(d), tokens[rows[d]], lengths[rows[d]])
        n = len(lengths) if num_sequences is None else num_sequences
        return ShardedDatabase(shards, rows, n, width)

    def stage(self, tokens: np.ndarray, lengths: np.ndarray) -> ShardedDatabase:
        tokens = np.asarray(tokens)
        return self.stage_shards(lambda sc, t, n: sc.stage(t, n), tokens,
                                 np.asarray(lengths, dtype=np.int32),
                                 width=max(tokens.shape[1], 1))

    def stage_device(self, tokens: torch.Tensor, lengths: np.ndarray,
                     num_sequences: int | None = None) -> ShardedDatabase:
        """Each db shard's rows of a device token block copied to the
        shard's device and staged there."""
        return self.stage_shards(lambda sc, t, n: sc.stage_device(t.to(sc.device), n), tokens,
                                 np.asarray(lengths, dtype=np.int32), num_sequences,
                                 width=tokens.shape[1])

    def _run(self, staged: ShardedDatabase, scan) -> torch.Tensor:
        """``scan(scanner, shard)`` on every shard, gathered and trimmed."""
        parts = run_shards(self.mesh, lambda d, shard: scan(self.scanner(d), shard),
                           staged.shards)
        return gather_shards(self.mesh, parts, staged.rows)[: staged.num_sequences]

    def scan(self, profile, staged: ShardedDatabase) -> torch.Tensor:
        return self._run(staged, lambda sc, shard: sc.scan(profile, shard))

    def scan_filter(self, profile, staged: ShardedDatabase) -> torch.Tensor:
        return self._run(staged, lambda sc, shard: sc.scan_filter(profile, shard))

    def scan_p7(self, p7, staged: ShardedDatabase, stage: str = "viterbi") -> torch.Tensor:
        return self._run(staged, lambda sc, shard: sc.scan_p7(p7, shard, stage))

    def scan_p7_filter(self, p7, staged: ShardedDatabase, window_log2: int | None = None
                       ) -> torch.Tensor:
        return self._run(staged, lambda sc, shard: sc.scan_p7_filter(p7, shard, window_log2))

    def _many(self, profiles, staged: ShardedDatabase, mode: str) -> list:
        """``MSVScanner._many`` on every shard: ``[(group, scores [P, B])]``
        gathered a group."""
        parts = run_shards(self.mesh, lambda d, shard: self.scanner(d)._many(profiles, shard, mode),
                           staged.shards)
        groups = [group for group, _ in next(iter(parts.values()), [])]
        return [
            (group, gather_shards(self.mesh, {d: part[k][1] for d, part in parts.items()},
                                  staged.rows).narrow(-1, 0, staged.num_sequences))
            for k, group in enumerate(groups)
        ]


class ShardedStager:
    """The streamed producer's ``stage_fn`` for a :class:`ShardedScanner`:
    each db shard's rows staged by the ``pipeline.SideStreamStager`` of its
    device (a side stream and a pinned ring each), every shard with its own
    event, so each shard's scan waits on its own. ``stream`` and
    ``consumer`` are the first device's."""

    def __init__(self, scanner: ShardedScanner):
        self.scanner = scanner
        self.stagers = {x: SideStreamStager(sc) for x, sc in scanner.scanners.items()}
        first = next(iter(self.stagers.values()))
        self.stream, self.consumer = first.stream, first.consumer
        self.batches = 0  # batches staged on the side streams

    def __call__(self, tokens: np.ndarray, lengths: np.ndarray) -> ShardedDatabase:
        tokens = np.asarray(tokens)
        staged = self.scanner.stage_shards(
            lambda sc, t, n: self.stagers[sc.device](t, n), tokens,
            np.asarray(lengths, dtype=np.int32), width=max(tokens.shape[1], 1))
        self.batches += int(self.stream is not None)
        return staged


def msv_scan_sharded(profile, tokens: np.ndarray, lengths: np.ndarray, mesh: ScanMesh
                     ) -> np.ndarray:
    """Scan a database sharded over the mesh's ``db`` axis: f32 ``[B]``
    scores on the host, pad rows removed. Across processes every process
    passes the whole batch, stages and scans only its own shards, and gets
    every score back."""
    tokens, lengths, true_b = pad_batch_to_mesh(
        np.asarray(tokens), np.asarray(lengths, dtype=np.int32), mesh.shape[DB_AXIS]
    )
    scanner = ShardedScanner(mesh)
    scores = scanner.scan(profile, scanner.stage(tokens, lengths))
    return scores.cpu().numpy()[:true_b]


def top_k_hits(scores, k: int):
    """``(values, indices)`` of the ``k`` best scores of a (gathered) score
    vector, best first: ``torch.topk``."""
    return torch.topk(torch.as_tensor(scores), k)
