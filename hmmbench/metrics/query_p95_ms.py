"""query_p95_ms: the 95th percentile of every completed query's latency
in the window, from its first search call to its last ``SearchResult`` on
the host (``statistics.quantiles``, 20 groups, the 19th cut point)."""

import statistics


def read(w):
    if w.queries < 20:
        return None
    return statistics.quantiles(w.latencies, n=20)[18] * 1e3
