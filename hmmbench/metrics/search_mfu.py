"""search_mfu: the whole search's share of the card's FP32 peak over the
traced window: every stage's operations (``work.OPS_PER_CELL``, counted
from the algorithm) over the window's seconds times 67 TFLOP/s. It bounds
the kernels' rooflines from below: a kernel taken off the path leaves its
roofline silent, not this."""

from hmmbench import work


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    ops = sum(v[0] for v in w.stage_work.values())
    return 100.0 * ops / (w.trace.window_s * work.PEAK_FP32_OPS) if ops else None
