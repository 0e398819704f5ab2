"""The share of its roofline a family of kernels reached in the traced
window: the least time (``work.least_seconds`` of the operations and
bytes the family was given, counted from the algorithm) over the summed
time of the family's kernels in the trace."""

import re

from hmmbench import work


def share(w, pattern: str, stages: tuple) -> float | None:
    if w.trace is None:
        return None
    kernel = re.compile(pattern)
    seconds = sum(sec for name, sec in w.trace.kernels if kernel.search(name))
    ops = sum(w.stage_work[s][0] for s in stages)
    nbytes = sum(w.stage_work[s][1] for s in stages)
    if seconds <= 0 or ops <= 0:
        return None
    return 100.0 * work.least_seconds(ops, nbytes) / seconds
