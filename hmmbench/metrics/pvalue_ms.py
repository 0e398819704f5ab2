"""pvalue_ms: the program's ``SearchPipeline.phase_totals["pvalues"]``
over the window (every P-value and pass decision of a search: in the
plain cascade the host's work between the stages), per completed query;
nothing where the program has no such span."""


def read(w):
    seconds = w.phase_seconds.get("pvalues")
    if seconds is None or not w.queries:
        return None
    return seconds * 1e3 / w.queries
