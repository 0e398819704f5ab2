"""Profiling and timing hooks: a ``torch.profiler`` trace of a scan
(``device_trace``, the CLI's ``--profile-trace DIR``) with its phases
labelled (``phase``), and a section timer for the streamed commands'
phase line (the consumer's prefetch wait and scans, the producer thread's
parse, encode, stage and queue wait).

The port's counterparts of the JAX package's ``device_trace`` (a
``jax.profiler`` capture) and ``SectionTimer``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import pathlib
import time

import torch

logger = logging.getLogger(__name__)

# the phases of the CLI's `seconds:` line, each a labelled range of a trace
PHASES = ("parse", "stage", "msv", "viterbi", "forward", "domains", "report")

# whether a device_trace is recording: phase() labels only then
_tracing = False


@contextlib.contextmanager
def phase(name: str):
    """Label the enclosed region ``name`` in the trace being recorded
    (``torch.profiler.record_function``); nothing when no trace is."""
    if not _tracing:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def kernel_events(trace: dict) -> list[dict]:
    """The device kernels of an exported Chrome trace."""
    return [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]


def busy_share(trace: dict, labels=PHASES) -> tuple[float, float]:
    """(device busy share, window µs): the union of the kernels' intervals
    over the window from the first label's start to the last one's end (the
    ``labels`` ranges, by default the phases), as a share of that window."""
    ranges = [e for e in trace.get("traceEvents", [])
              if e.get("cat") == "user_annotation" and e.get("name") in labels]
    if not ranges:
        raise ValueError("the trace holds no phase label")
    lo = min(float(e["ts"]) for e in ranges)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in ranges)
    spans = sorted(
        (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
        for e in kernel_events(trace)
    )
    busy, end = 0.0, lo
    for start, stop in spans:
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    window = hi - lo
    return (busy / window if window > 0 else 0.0), window


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None):
    """Record a ``torch.profiler`` trace of the enclosed region (CPU
    activity, and CUDA activity when ``device`` is a CUDA device) and write
    it into ``log_dir`` as a Chrome trace (``<pid>.<ns>.pt.trace.json``,
    viewable in Perfetto); a no-op when ``log_dir`` is falsy. A trace that
    asked for CUDA activity and holds no kernel is logged as an error: it
    is no device trace."""
    global _tracing
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out_dir = pathlib.Path(log_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _tracing = True
    try:
        yield
    finally:
        _tracing = False
        if cuda:
            torch.cuda.synchronize(device)  # every kernel ends inside the trace
        prof.stop()
        path = out_dir / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        logger.info("profiler trace written to %s", path)
        if cuda:
            kernels = kernel_events(json.loads(path.read_text()))
            if kernels:
                logger.info("profiler trace: %d CUDA kernel events", len(kernels))
            else:
                logger.error(
                    "profiler trace %s asked for CUDA activity (CUPTI) and holds no CUDA "
                    "kernel event: it is no device trace", path,
                )


class SectionTimer:
    """Accumulating host-side phase timer with a one-line report."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        parts = [
            f"{k}={v*1e3:.1f}ms({v/total:.0%})" for k, v in sorted(
                self.sections.items(), key=lambda kv: -kv[1]
            )
        ]
        return " ".join(parts)
