"""Resumable database scans.

The reference has no checkpointing (scans are seconds-long; SURVEY.md §5)
— at pod scale a sweep over millions of sequences x thousands of
profiles is hours-long and preemptible, so the engine persists per-
(profile, shard) results and skips completed work on restart.

Layout: one ``.npz`` per (profile, shard) under the checkpoint dir plus
a ``manifest.json`` describing the partition, written atomically.

Staging economics (round-3 fix): the loop is SHARD-OUTER — each shard's
tokens are staged on device ONCE and every remaining profile scans it
through the stacked ``scan_many`` kernel (one call per M bucket), instead
of restaging the same shard once per profile (staging is this
environment's #1 hidden cost: a host->device upload per call measured as
a 2x slowdown). Checkpoint granularity stays per-(profile, shard).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ScanCheckpoint:
    directory: pathlib.Path

    def __init__(self, directory):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _chunk_path(self, profile_name: str, shard: int) -> pathlib.Path:
        safe = profile_name.replace("/", "_")
        return self.directory / f"{safe}.shard{shard:05d}.npz"

    def is_done(self, profile_name: str, shard: int) -> bool:
        return self._chunk_path(profile_name, shard).exists()

    def save(self, profile_name: str, shard: int, scores: np.ndarray) -> None:
        self.save_arrays(profile_name, shard, scores=scores)

    def save_arrays(self, profile_name: str, shard: int, **arrays) -> None:
        path = self._chunk_path(profile_name, shard)
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp, **{k: np.asarray(v) for k, v in arrays.items()}
        )
        os.replace(tmp, path)  # atomic publish

    def load(self, profile_name: str, shard: int) -> np.ndarray:
        with np.load(self._chunk_path(profile_name, shard)) as z:
            return z["scores"]

    def load_arrays(self, profile_name: str, shard: int) -> dict:
        with np.load(self._chunk_path(profile_name, shard)) as z:
            return {k: z[k] for k in z.files}

    def write_manifest(self, meta: dict) -> None:
        tmp = self.directory / "manifest.tmp"
        tmp.write_text(json.dumps(meta, indent=1))
        os.replace(tmp, self.directory / "manifest.json")

    def read_manifest(self) -> dict | None:
        p = self.directory / "manifest.json"
        return json.loads(p.read_text()) if p.exists() else None


def _check_manifest(checkpoint: ScanCheckpoint, meta: dict) -> None:
    manifest = checkpoint.read_manifest()
    if manifest is not None:
        # manifests written before the search sweep existed carry no
        # 'kind'; they are msv sweeps — resuming them must keep working
        manifest.setdefault("kind", "msv")
        if any(
            manifest.get(k) != meta[k]
            for k in ("num_sequences", "shard_size", "kind")
        ):
            raise ValueError(
                "checkpoint directory belongs to a different partition: "
                f"{manifest} vs {meta}"
            )
    checkpoint.write_manifest(meta)


def _log_chunks(checkpoint: ScanCheckpoint, num_shards: int, num_profiles: int,
                computed: int) -> None:
    """How many (profile, shard) chunks this run computed and how many it
    read back from an earlier run."""
    logger.info(
        "checkpoint %s: %d shards x %d profiles, %d chunks computed, %d read back",
        checkpoint.directory, num_shards, num_profiles, computed,
        num_shards * num_profiles - computed,
    )


def resumable_sweep(
    scanner,
    profiles,
    tokens: np.ndarray,
    lengths: np.ndarray,
    checkpoint: ScanCheckpoint,
    shard_size: int = 4096,
) -> dict[str, np.ndarray]:
    """Scan profiles x database in shards, skipping completed chunks.

    Returns {profile_name: scores [B]}. Safe to kill and rerun: each
    (profile, shard) result publishes atomically once computed. Each
    shard is staged on device once and scanned by every remaining
    profile via the stacked scan_many kernel (see module docstring).
    """
    b = tokens.shape[0]
    num_shards = -(-b // shard_size)
    _check_manifest(
        checkpoint,
        {
            "num_sequences": int(b),
            "shard_size": int(shard_size),
            "kind": "msv",
            "profiles": [p.name for p in profiles],
        },
    )

    done: dict[tuple, np.ndarray] = {}
    for shard in range(num_shards):
        lo, hi = shard * shard_size, min((shard + 1) * shard_size, b)
        todo = [p for p in profiles if not checkpoint.is_done(p.name, shard)]
        if not todo:
            continue
        staged = scanner.stage(tokens[lo:hi], lengths[lo:hi])
        scored = scanner.scan_many(todo, staged)
        for p in todo:
            scores = np.asarray(scored[p.name], dtype=np.float32)
            checkpoint.save(p.name, shard, scores)
            done[(p.name, shard)] = scores
        logger.info(
            "checkpointed shard %d/%d (%d profiles)",
            shard + 1, num_shards, len(todo),
        )
    _log_chunks(checkpoint, num_shards, len(profiles), len(done))

    return {
        p.name: np.concatenate(
            [
                done.get((p.name, s), None)
                if (p.name, s) in done
                else checkpoint.load(p.name, s)
                for s in range(num_shards)
            ]
        )
        if num_shards
        else np.zeros(0, np.float32)
        for p in profiles
    }


_SEARCH_FIELDS = (
    "msv_scores", "msv_pvalues", "viterbi_scores", "viterbi_pvalues",
    "forward_scores", "forward_pvalues", "passed_msv", "passed_viterbi",
    "passed_forward",
)


def resumable_search_sweep(
    pipeline,
    hmms,
    tokens: np.ndarray,
    lengths: np.ndarray,
    checkpoint: ScanCheckpoint,
    shard_size: int = 4096,
) -> dict:
    """Resumable full-cascade sweep (``sweep --stage search``):
    per-(profile, shard) SearchResults persist atomically; rerun skips
    completed chunks. Shard-outer like :func:`resumable_sweep` — each
    shard stages once and every remaining profile's cascade runs against
    the staged copy. Returns {hmm.name: SearchResult over the full B}.
    """
    from ..pipeline import SearchResult

    b = tokens.shape[0]
    num_shards = -(-b // shard_size)
    _check_manifest(
        checkpoint,
        {
            "num_sequences": int(b),
            "shard_size": int(shard_size),
            "kind": "search",
            "profiles": [h.name for h in hmms],
        },
    )

    done: dict[tuple, dict] = {}
    for shard in range(num_shards):
        lo, hi = shard * shard_size, min((shard + 1) * shard_size, b)
        todo = [h for h in hmms if not checkpoint.is_done(h.name, shard)]
        if not todo:
            continue
        shard_tokens = tokens[lo:hi]
        shard_lengths = lengths[lo:hi]
        staged = pipeline.scanner.stage(shard_tokens, shard_lengths)
        for hmm in todo:
            result = pipeline.search(hmm, staged, shard_tokens, shard_lengths)
            arrays = {f: getattr(result, f) for f in _SEARCH_FIELDS}
            checkpoint.save_arrays(hmm.name, shard, **arrays)
            done[(hmm.name, shard)] = arrays
            logger.info(
                "checkpointed search %s shard %d/%d",
                hmm.name, shard + 1, num_shards,
            )
    _log_chunks(checkpoint, num_shards, len(hmms), len(done))

    results = {}
    for hmm in hmms:
        # chunks computed this run assemble from memory; only chunks
        # completed by a PREVIOUS run are read back from disk
        chunks = [
            done.get((hmm.name, s)) or checkpoint.load_arrays(hmm.name, s)
            for s in range(num_shards)
        ]
        results[hmm.name] = SearchResult(
            **{
                f: np.concatenate([c[f] for c in chunks])
                if chunks
                # empty DB: keep the per-field dtype contract — the
                # passed_* fields are bool, the rest f32 (ADVICE r3)
                else np.zeros(0, bool if f.startswith("passed_") else np.float32)
                for f in _SEARCH_FIELDS
            }
        )
    return results
