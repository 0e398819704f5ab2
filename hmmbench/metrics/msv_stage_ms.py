"""msv_stage_ms: the program's own ``SearchPipeline.phase_totals["msv"]``
over the window (each MSV stage ends in a host copy of its scores), per
completed query."""


def read(w):
    return w.phase_seconds["msv"] * 1e3 / w.queries if w.queries else None
