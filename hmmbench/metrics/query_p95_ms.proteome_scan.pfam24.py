"""query_p95_ms.proteome_scan.pfam24: the tail of a query (all 24
cascades) in the proteome scan, read as ``query_p95_ms`` reads it; a
per-layer metric there, since a 51 s window completes too few of its
queries (about 50) for a tail held to a bound."""

from hmmbench.metrics.query_p95_ms import read  # noqa: F401
