"""Reading a run's device trace: a Chrome trace written by the program's
own ``runtime.profiling.device_trace`` (``torch.profiler`` with CUPTI),
which also labels the cascade's stages (``msv``, ``viterbi``,
``forward``) while it records.

The busy time is the union of the device operations' intervals (kernels,
copies, memsets) inside the benchmark's own window label, the arithmetic
of the program's ``profiling.busy_share`` applied to that label. An idle
gap is named by what the host was doing: the stage label and the
outermost host operation around the gap's middle (``host`` where no
PyTorch operation was running: the program's NumPy work).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "hmmbench.window"
QUERY = "hmmbench.query"
STAGES = ("msv", "viterbi", "forward")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: list  # (name, seconds), one a launch inside the window
    device_ops: list  # [name, seconds], the 10 that took most time
    idle_gaps: list  # [label, seconds], the 10 labels with most idle time


def _ranges(events, names) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events if e.get("cat") == "user_annotation" and e["name"] in names)


def _top_level(spans: list) -> list:
    """The spans not inside another, sorted by start."""
    out = []
    for lo, hi, name in sorted(spans):
        if out and hi <= out[-1][1]:
            continue
        out.append((lo, hi, name))
    return out


def _covering(spans: list, starts: list, t: float):
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and spans[k][1] >= t:
        return spans[k][2]
    return None


def summarize(trace: dict) -> Summary:
    events = trace.get("traceEvents", [])
    window = _ranges(events, (WINDOW,))
    if not window:
        raise ValueError("the trace holds no window label")
    lo, hi = window[0][0], window[0][1]
    spans = sorted(
        (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0)), hi),
         e["name"], e["cat"])
        for e in events if e.get("cat") in DEVICE_CATS
    )
    spans = [s for s in spans if s[1] > s[0]]
    busy, end, gaps = 0.0, lo, []
    for start, stop, _, _ in spans:
        if start > end:
            gaps.append((end, start))
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    if hi > end:
        gaps.append((end, hi))

    by_name = collections.Counter()
    for start, stop, name, _ in spans:
        by_name[name] += (stop - start) * 1e-6
    kernels = [(name, (stop - start) * 1e-6) for start, stop, name, cat in spans
               if cat == "kernel"]

    stages = _ranges(events, STAGES)
    queries = _ranges(events, (QUERY,))
    host = _top_level([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                       for e in events if e.get("cat") in HOST_CATS])
    stage_starts = [s[0] for s in stages]
    query_starts = [s[0] for s in queries]
    host_starts = [s[0] for s in host]
    idle = collections.Counter()
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        where = _covering(stages, stage_starts, mid) or (
            "between stages" if _covering(queries, query_starts, mid) else "between queries")
        idle[f"{where}/{_covering(host, host_starts, mid) or 'host'}"] += (g1 - g0) * 1e-6
    return Summary(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy * 1e-6,
        kernels=kernels,
        device_ops=[[name, sec] for name, sec in by_name.most_common(10)],
        idle_gaps=[[name, sec] for name, sec in idle.most_common(10)],
    )
