"""device_idle_pct: 100 x (1 - busy share) over the benchmark's window
label in the trace; busy is the union of the device operations'
intervals (``trace.summarize``)."""


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
