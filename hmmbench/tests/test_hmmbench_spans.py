"""The readers of the program's cascade spans (``pvalue_ms``,
``restage_ms``, ``pack_ms``): the window's seconds of the span per
completed query, and nothing where the program has no such span or no
query completed."""

import pytest

from hmmbench import harness

SPANS = {"pvalue_ms": "pvalues", "restage_ms": "restage", "pack_ms": "pack"}


def _window(phase_seconds: dict, queries: int) -> harness.Window:
    return harness.Window(seconds=51.0, latencies=[0.25] * queries, msv_cells=0,
                          phase_seconds=phase_seconds, setup_s=20.0, rows={},
                          stage_work={}, trace=None)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_span_reads_its_milliseconds_per_query(metric):
    phases = {"msv": 20.0, "viterbi": 10.0, "forward": 5.0,
              "pvalues": 6.4, "restage": 1.2, "pack": 0.8}
    want = {"pvalue_ms": 6.4, "restage_ms": 1.2, "pack_ms": 0.8}[metric] * 1e3 / 400
    assert harness.reader(metric)(_window(phases, 400)) == pytest.approx(want)
    assert harness.reader(metric)(_window(phases, 0)) is None


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_program_without_the_span_reads_nothing(metric):
    """The parent commit's totals hold only the three stages."""
    phases = {"msv": 20.0, "viterbi": 10.0, "forward": 5.0}
    assert harness.reader(metric)(_window(phases, 400)) is None
