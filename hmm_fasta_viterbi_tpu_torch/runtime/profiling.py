"""Profiling and timing: one span primitive for the whole port.

``span(name)`` times a region by the host clock into every accumulator
collecting on the current thread (a ``SectionTimer`` whose ``scope`` is
open), and while a ``device_trace`` records it is also a labelled range
of the trace (a ``user_annotation``, as ``torch.profiler.record_function``
makes), so the program's host totals and the CUPTI kernels sit on one
clock in one Chrome trace. With no trace recording it calls nothing of
the profiler; outside any scope it only labels the trace.
``device_trace`` is the CLI's ``--profile-trace DIR``; ``busy_share`` and
``idle_by_span`` read what it wrote.

The port's counterparts of the JAX package's ``device_trace`` (a
``jax.profiler`` capture) and ``SectionTimer``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import pathlib
import threading
import time

import torch

logger = logging.getLogger(__name__)

# the phases of the CLI's `seconds:` line, each a labelled range of a trace
PHASES = ("parse", "stage", "msv", "viterbi", "forward", "domains", "report")

# whether a device_trace is recording: spans label the trace only then
_tracing = False
# numbers the labelled scopes of a trace ("search#<n>")
_scope_numbers = itertools.count(1)


class _Thread(threading.local):
    """A thread's open scopes, ``(accumulator, span depth at the scope's
    start)``, and its depth of open spans."""

    def __init__(self):
        self.sinks: list = []
        self.depth = 0


_thread = _Thread()


def _label(name: str):
    """Open a labelled range ``name`` of the trace being recorded, closed
    by :func:`_unlabel`: the user annotation ``record_function`` opens,
    through the binding beneath its op dispatch, which costs a traced
    range less host time (8.4 against 13.1 µs on an H100's host)."""
    return torch.autograd._record_function_with_args_enter(name)


def _unlabel(handle) -> None:
    torch.autograd._record_function_with_args_exit(handle)


class span:
    """Time the enclosed region as ``name``: its host-clock seconds and one
    call go to every accumulator collecting on this thread (marked nested
    when the span opened inside another span of that accumulator's
    scope), and while a trace records the region is also a labelled range
    of it, around the clock reads and the accumulators' adds."""

    __slots__ = ("name", "_label", "_depth", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._label = _label(self.name) if _tracing else None
        t = _thread
        self._depth = t.depth
        t.depth += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        t = _thread
        t.depth = self._depth
        for accumulator, base in t.sinks:
            accumulator.add(self.name, seconds, self._depth > base)
        if self._label is not None:
            _unlabel(self._label)
        return False


@contextlib.contextmanager
def scope(accumulator, label: str | None = None):
    """Collect every span this thread opens inside into ``accumulator``
    (an object with ``add(name, seconds, nested)``); an accumulator that
    already collects here is not added twice. With ``label``, while a
    trace records, the scope is also a range named ``<label>#<n>``, ``n``
    a number of its own: the spans inside it share that identifier."""
    t = _thread
    if any(a is accumulator for a, _ in t.sinks):
        yield
        return
    entry = (accumulator, t.depth)
    t.sinks.append(entry)
    handle = None
    if label is not None and _tracing:
        handle = _label(f"{label}#{next(_scope_numbers)}")
    try:
        yield
    finally:
        if handle is not None:
            _unlabel(handle)
        t.sinks.remove(entry)


class SectionTimer:
    """Accumulator of spans: host-clock ``seconds`` and ``calls`` a name,
    the given ``names`` present from the start at 0, and a one-line
    report."""

    def __init__(self, names=()):
        self.seconds: dict[str, float] = dict.fromkeys(names, 0.0)
        self.calls: dict[str, int] = dict.fromkeys(names, 0)
        self.nested: set[str] = set()  # names that ran inside another span here

    def add(self, name: str, seconds: float, nested: bool = False) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1
        if nested:
            self.nested.add(name)

    @contextlib.contextmanager
    def section(self, name: str):
        """The span ``name``, collected here with every span inside it."""
        with scope(self), span(name):
            yield

    def report(self) -> str:
        """Each name's milliseconds, largest first; the outer ones with
        their share of the outer total, then those that ran inside them."""
        ranked = sorted(self.seconds.items(), key=lambda kv: -kv[1])
        outer = [(k, v) for k, v in ranked if k not in self.nested]
        total = sum(v for _, v in outer) or 1.0
        parts = [f"{k}={v*1e3:.1f}ms({v/total:.0%})" for k, v in outer]
        inner = [f"{k}={v*1e3:.1f}ms" for k, v in ranked if k in self.nested]
        if inner:
            parts.append("inside: " + " ".join(inner))
        return " ".join(parts)


def kernel_events(trace: dict) -> list[dict]:
    """The device kernels of an exported Chrome trace."""
    return [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]


def _labelled(trace: dict) -> list[tuple[float, float, str]]:
    """``(start, end, name)`` of every labelled range, by start, the outer
    of two that start together first; a scope's ``<label>#<n>`` named
    ``<label>``."""
    return sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"].split("#")[0])
         for e in trace.get("traceEvents", []) if e.get("cat") == "user_annotation"),
        key=lambda r: (r[0], -r[1]),
    )


def _union(trace: dict, lo: float, hi: float) -> tuple[float, list]:
    """(busy µs, idle gaps) of the kernels' intervals clipped to [lo, hi]."""
    spans = sorted(
        (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
        for e in kernel_events(trace)
    )
    busy, end, gaps = 0.0, lo, []
    for start, stop in spans:
        if start > end:
            gaps.append((end, start))
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


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
    busy, _ = _union(trace, lo, hi)
    window = hi - lo
    return (busy / window if window > 0 else 0.0), window


def idle_by_span(trace: dict) -> tuple[float, float, dict[str, float]]:
    """(device busy share, window µs, {span: idle µs}) over the traced
    region, from the first labelled range's start to the last one's end:
    the kernels' union as :func:`busy_share` takes it, and each stretch of
    its idle time under the innermost labelled range around it (the one
    that started last), ``"no span"`` where none is."""
    ranges = _labelled(trace)
    if not ranges:
        raise ValueError("the trace holds no labelled range")
    lo = ranges[0][0]
    hi = max(r[1] for r in ranges)
    busy, gaps = _union(trace, lo, hi)
    # the starts and ends of the ranges that last, in time order, an end
    # before a start
    lasting = [k for k, r in enumerate(ranges) if r[1] > r[0]]
    marks = sorted([(ranges[k][0], 1, k) for k in lasting]
                   + [(ranges[k][1], 0, k) for k in lasting])
    idle: collections.Counter = collections.Counter()
    active: list[int] = []  # open ranges, by start: the last is the innermost
    at = 0

    def advance(until: float) -> None:
        """Open and close every range that starts or ends by ``until``."""
        nonlocal at
        while at < len(marks) and marks[at][0] <= until:
            _, opens, k = marks[at]
            if opens:
                active.append(k)
            else:
                active.remove(k)
            at += 1

    def attribute(us: float) -> None:
        idle[ranges[active[-1]][2] if active else "no span"] += us

    for g0, g1 in gaps:
        advance(g0)
        cur = g0
        while at < len(marks) and marks[at][0] < g1:
            t = marks[at][0]
            attribute(t - cur)
            advance(t)
            cur = t
        attribute(g1 - cur)
    window = hi - lo
    return (busy / window if window > 0 else 0.0), window, dict(idle)


def trace_summary(trace: dict) -> str:
    """The device's busy share over the traced region and its three
    largest idle totals by innermost span (:func:`idle_by_span`)."""
    share, window, idle = idle_by_span(trace)
    largest = sorted(idle.items(), key=lambda kv: -kv[1])[:3]
    return (f"device busy {share:.1%} of {window * 1e-6:.3f} s "
            f"({len(kernel_events(trace))} kernels); idle by innermost span: "
            + ", ".join(f"{name} {sec * 1e-6:.3f} s" for name, sec in largest))


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None):
    """Record a ``torch.profiler`` trace of the enclosed region (CPU
    activity, and CUDA activity when ``device`` is a CUDA device) and write
    it into ``log_dir`` as a Chrome trace (``<pid>.<ns>.pt.trace.json``,
    viewable in Perfetto); a no-op when ``log_dir`` is falsy. A CUDA trace
    is logged with the device's busy share and where it idled
    (:func:`trace_summary`); one that holds no kernel is logged as an
    error: it is no device trace."""
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
            trace = json.loads(path.read_text())
            if kernel_events(trace):
                logger.info("profiler trace: %s", trace_summary(trace))
            else:
                logger.error(
                    "profiler trace %s asked for CUDA activity (CUPTI) and holds no CUDA "
                    "kernel event: it is no device trace", path,
                )
