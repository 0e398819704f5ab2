"""Host-side phase timing: a section timer for the streamed commands'
phase line (the consumer's prefetch wait and scans, the producer thread's
parse, encode, stage and queue wait).

The port's copy of ``SectionTimer``; the JAX package's ``device_trace``
(a ``jax.profiler`` capture) has no counterpart here yet.
"""

from __future__ import annotations

import contextlib
import time


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
