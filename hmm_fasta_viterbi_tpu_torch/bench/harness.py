"""GCUPS benchmark harness of the PyTorch port: the counterpart of
``hmm_fasta_viterbi_tpu/bench/harness.py``, with its names, its
``BenchResult`` fields and its JSON line.

Unit of work (BASELINE.md): DP cells = seq_len * (model_length - 1) per
sequence; GCUPS = cells / second / 1e9. Protocol: one untimed warm-up
call, then the best of N wall-clock (``time.perf_counter``) runs of the
entry point, each ending in a host copy of its scores, so the device work
is inside the timed region. Differences from the JAX harness:

* ``_sync`` copies a torch tensor to the host with ``.cpu()``; the copy
  waits for the kernels that produce it;
* ``env_fingerprint`` records torch and CUDA versions, the card's name and
  count and ``nvidia-smi``'s name and power limit, or on the CPU the
  device type alone;
* ``emit_json_line`` takes no ``errors``: a row that fails raises and the
  bench prints no line, so the line's ``errors`` is always ``[]``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import platform
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from ..models.msv import MSVProfile

# BASELINE.md derived anchor: 1 GCUPS scans the reference 1400-profile
# benchmark pass (3 x 3500 aa) in 14.7 ms. The reference publishes no
# measured numbers, so this anchor is the vs_baseline denominator.
BASELINE_GCUPS = 1.0


@dataclasses.dataclass
class BenchResult:
    name: str
    gcups: float
    seconds: float
    cells: int
    batch: int
    seq_len: int
    model_length: int
    repetitions: int
    # per-repetition wall seconds (best-of is `seconds`), kept so a swing
    # between runs can be told from noise
    rep_seconds: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["rep_seconds"] = [round(s, 6) for s in self.rep_seconds]
        return d


def random_tokens(batch: int, seq_len: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Uniform random amino-acid tokens (the reference generator's
    distribution, FASTA_files/random_FASTA_generator.py); the JAX
    harness's arrays for the same arguments."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 20, size=(batch, seq_len)).astype(np.int32)
    lengths = np.full(batch, seq_len, dtype=np.int32)
    return tokens, lengths


def _sync(out) -> np.ndarray:
    """Wait for the device by copying the (small) scores to the host."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def time_scan(scan_fn: Callable[[], object], repetitions: int = 3) -> list[float]:
    """Per-repetition wall times of a scan, each synced on its result.

    Callers take ``min()`` for the best-of-N protocol and keep the full
    list in the JSON detail so the spread stays visible."""
    reps = []
    for _ in range(repetitions):
        t0 = time.perf_counter()
        _sync(scan_fn())
        reps.append(time.perf_counter() - t0)
    return reps


def bench_staged(name: str, scanner, profile: MSVProfile, staged,
                 repetitions: int = 3) -> BenchResult:
    """Time scans of a database staged once (the reference sweep shape: one
    FASTA x many profiles, benchmark_MSV.cpp:32-41). ``scanner`` is
    anything with ``scan(profile, staged)``."""

    def run():
        return scanner.scan(profile, staged)

    _sync(run())  # warm-up
    reps = time_scan(run, repetitions)
    seconds = min(reps)
    lengths = staged.lengths[: staged.num_sequences].cpu().numpy()
    cells = int(lengths.astype(np.int64).sum()) * (profile.model_length - 1)
    return BenchResult(
        name=name,
        gcups=cells / seconds / 1e9,
        seconds=seconds,
        cells=cells,
        batch=staged.num_sequences,
        seq_len=int(lengths.max()) if len(lengths) else 0,
        model_length=profile.model_length,
        repetitions=repetitions,
        rep_seconds=reps,
    )


def bench_profile(
    name: str,
    profile: MSVProfile,
    scan: Callable[[MSVProfile, np.ndarray, np.ndarray], object],
    tokens: np.ndarray,
    lengths: np.ndarray,
    repetitions: int = 3,
) -> BenchResult:
    """Time a scan of a host batch end to end (stage, pack and scan)."""
    batch, seq_len = tokens.shape

    def run():
        return scan(profile, tokens, lengths)

    _sync(run())  # warm-up
    reps = time_scan(run, repetitions)
    seconds = min(reps)
    cells = int(lengths.astype(np.int64).sum()) * (profile.model_length - 1)
    return BenchResult(
        name=name,
        gcups=cells / seconds / 1e9,
        seconds=seconds,
        cells=cells,
        batch=batch,
        seq_len=seq_len,
        model_length=profile.model_length,
        repetitions=repetitions,
        rep_seconds=reps,
    )


def env_fingerprint(device: str | torch.device = "cuda") -> dict:
    """The identity of the run recorded in the detail file: when, where,
    torch and CUDA versions, and the device the rows ran on. A card's power
    limit sets its speed under load, so a CUDA run records nvidia-smi's
    name and power limit beside the numbers."""
    device = torch.device(device)
    info = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
        "hostname": platform.node(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": "gpu" if device.type == "cuda" else device.type,
    }
    if device.type != "cuda":
        info["device_kind"] = device.type
        return info
    info["device_kind"] = torch.cuda.get_device_name(device)
    info["num_devices"] = torch.cuda.device_count()
    info["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return info


def emit_json_line(
    primary: BenchResult,
    extras: list[BenchResult],
    detail_path: str | None = None,
    device: str | torch.device = "cuda",
) -> str:
    """The single JSON line of a bench run.

    Only the tail (~2000 characters) of the bench's output is kept by the
    records, so the full per-rep detail goes to ``detail_path`` and the
    printed line stays compact: the headline metric plus a name -> GCUPS
    map of every extra."""
    detail = {
        "primary": primary.to_json(),
        "extras": [e.to_json() for e in extras],
        "errors": [],
        "env": env_fingerprint(device),
        "baseline_anchor": "1 GCUPS == 14.7 ms per reference 1400-profile pass (BASELINE.md)",
    }
    payload = {
        "metric": f"GCUPS_M{primary.model_length - 1}",
        "value": round(primary.gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(primary.gcups / BASELINE_GCUPS, 3),
        "extras": {e.name: round(e.gcups, 2) for e in extras},
        "errors": [],
    }
    if detail_path is not None:
        with open(detail_path, "w") as fh:
            json.dump(detail, fh, indent=1)
        payload["detail_file"] = detail_path
    else:
        payload["detail"] = detail
    return json.dumps(payload)
