"""restage_ms: the program's ``SearchPipeline.phase_totals["restage"]``
over the window (each survivor restaging: host gather, pad, upload and
length transitions, inside the stage it feeds), per completed query;
nothing where the program has no such span."""


def read(w):
    seconds = w.phase_seconds.get("restage")
    if seconds is None or not w.queries:
        return None
    return seconds * 1e3 / w.queries
