"""pack_ms: the program's ``SearchPipeline.phase_totals["pack"]`` over
the window (each profile pack or derived profile built on a cache miss,
inside whatever asked for it), per completed query; nothing where the
program has no such span."""


def read(w):
    seconds = w.phase_seconds.get("pack")
    if seconds is None or not w.queries:
        return None
    return seconds * 1e3 / w.queries
