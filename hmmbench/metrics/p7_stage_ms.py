"""p7_stage_ms: the program's ``phase_totals["viterbi"] +
phase_totals["forward"]`` over the window (the survivors' restaging from
the host array included), per completed query."""


def read(w):
    if not w.queries:
        return None
    return (w.phase_seconds["viterbi"] + w.phase_seconds["forward"]) * 1e3 / w.queries
