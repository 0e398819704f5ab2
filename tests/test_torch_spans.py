"""The port's one span primitive (runtime/profiling.py::span) on the CPU:
under a device trace every span of a search is a labelled range of its
name, as many as the accumulator counts and as long as it timed them (one
clock); the plain cascade's P-values lie between its stages and its
restaging inside them; a pipeline's totals hold every key from the start
and stay one dict; the pack cache's builds against its lookups; and no
trace, no profiler call."""

import json

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.pipeline import SEARCH_SPANS, MSVScanner, SearchPipeline
from hmm_fasta_viterbi_tpu_torch.runtime import profiling

STAGES = ("msv", "viterbi", "forward")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hmms(profile_dir):
    return [parse_hmm(profile_dir / f"{n}.hmm") for n in ("100", "200")]


@pytest.fixture(scope="module")
def database(hmms):
    """300 random rows of 40-200 residues, and each profile's consensus
    twice: rows that pass every stage for either profile."""
    rng = np.random.default_rng(25)
    lengths = rng.integers(40, 201, 300).astype(np.int32)
    rows = [rng.integers(0, 20, n) for n in lengths]
    for hmm in hmms:
        consensus = np.argmax(hmm.match_emissions[1:], axis=1)
        rows[rng.integers(0, 300)] = consensus
        rows[rng.integers(0, 300)] = consensus
    lengths = np.array([len(r) for r in rows], dtype=np.int32)
    tokens = np.zeros((len(rows), lengths.max()), dtype=np.int8)
    for k, r in enumerate(rows):
        tokens[k, : len(r)] = r
    return tokens, lengths


def _annotations(trace: dict) -> list[tuple[float, float, str]]:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in trace["traceEvents"] if e.get("cat") == "user_annotation")


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _traced_searches(tmp_path, hmms, database, searches=2):
    tokens, lengths = database
    sc = MSVScanner(device="cpu")
    bucketed = sc.stage_bucketed(tokens, lengths)
    pipeline = SearchPipeline(sc)
    with profiling.device_trace(str(tmp_path)):
        results = [pipeline.search_bucketed(hmms[k % len(hmms)], bucketed, tokens, lengths)
                   for k in range(searches)]
    trace = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())
    return pipeline, results, _annotations(trace)


def test_every_span_is_a_trace_range_on_one_clock(tmp_path, hmms, database):
    pipeline, results, ranges = _traced_searches(tmp_path, hmms, database)
    assert all(r.passed_forward.any() for r in results)
    for name in SEARCH_SPANS:
        mine = [r for r in ranges if r[2] == name]
        assert len(mine) == pipeline.timer.calls[name], name
    assert all(pipeline.timer.calls[name] > 0 for name in SEARCH_SPANS)
    traced = sum(hi - lo for lo, hi, name in ranges if name in SEARCH_SPANS) * 1e-6
    timed = sum(pipeline.timer.seconds.values())
    assert traced == pytest.approx(timed, rel=0.05)
    for name in STAGES:  # the stages, long enough to hold each to 5%
        traced = sum(hi - lo for lo, hi, n in ranges if n == name) * 1e-6
        assert traced == pytest.approx(pipeline.timer.seconds[name], rel=0.05), name


def test_the_plain_cascade_decides_between_its_stages(tmp_path, hmms, database):
    """No P-value range lies inside a stage range and every restaging lies
    inside a Viterbi or Forward range: msv_stage_ms and p7_stage_ms keep
    what they measure. Every span lies inside its search's range, one
    identifier a search."""
    _, _, ranges = _traced_searches(tmp_path, hmms, database, searches=3)
    stages = [r for r in ranges if r[2] in STAGES]
    p7 = [r for r in stages if r[2] != "msv"]
    pvalues = [r for r in ranges if r[2] == "pvalues"]
    restage = [r for r in ranges if r[2] == "restage"]
    assert pvalues and restage
    assert not any(_inside(p, s) for p in pvalues for s in stages)
    assert all(any(_inside(r, s) for s in p7) for r in restage)
    searches = [r for r in ranges if r[2].startswith("search#")]
    assert len({r[2] for r in searches}) == len(searches) == 3
    for r in ranges:
        if r[2] in SEARCH_SPANS:
            assert sum(_inside(r, s) for s in searches) == 1, r


def test_phase_totals_hold_every_key_from_the_start(hmms, database):
    pipeline = SearchPipeline(MSVScanner(device="cpu"))
    totals, last = pipeline.phase_totals, pipeline.phase_seconds
    assert totals == last == dict.fromkeys(SEARCH_SPANS, 0.0)
    tokens, lengths = database
    sc = pipeline.scanner
    pipeline.search_bucketed(hmms[0], sc.stage_bucketed(tokens, lengths), tokens, lengths)
    assert pipeline.phase_totals is totals and pipeline.phase_seconds is last
    assert set(totals) == set(SEARCH_SPANS) and totals == last
    assert all(last[k] > 0 for k in SEARCH_SPANS)


@pytest.mark.parametrize("cap", [2, None], ids=["cap2", "default"])
def test_pack_builds_against_lookups(hmms, database, monkeypatch, cap):
    """Two profiles searched in turns: through a cache of two packs every
    lookup builds (each search looks up three); through the default cache
    the second round builds nothing."""
    if cap is not None:
        monkeypatch.setattr(MSVScanner, "_CACHE_MAX", cap)
    tokens, lengths = database
    sc = MSVScanner(device="cpu")
    bucketed = sc.stage_bucketed(tokens, lengths)
    pipeline = SearchPipeline(sc)
    for hmm in hmms:
        pipeline.search_bucketed(hmm, bucketed, tokens, lengths)
    assert sc.pack_lookups == sc.pack_builds == 6
    # the derived profiles are pack spans too
    assert pipeline.timer.calls["pack"] == sc.pack_builds + len(hmms)
    for hmm in hmms:
        pipeline.search_bucketed(hmm, bucketed, tokens, lengths)
    assert sc.pack_lookups == 12
    if cap is None:
        assert sc.pack_builds == 6 and pipeline.phase_seconds["pack"] == 0.0
    else:
        assert sc.pack_builds == 12 and pipeline.phase_seconds["pack"] > 0


def test_no_trace_no_profiler_call(hmms, database, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no trace recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    timer = profiling.SectionTimer()
    with timer.section("outer"), profiling.scope(timer, "search"):
        with profiling.span("inner"):
            pass
    with profiling.span("alone"):  # outside any scope: collected nowhere
        pass
    assert timer.calls == {"inner": 1, "outer": 1} and timer.nested == {"inner"}
    tokens, lengths = database
    sc = MSVScanner(device="cpu")
    pipeline = SearchPipeline(sc)
    pipeline.search_bucketed(hmms[0], sc.stage_bucketed(tokens, lengths), tokens, lengths)
    assert pipeline.timer.calls["msv"] == 1


def test_section_report_shares_the_outer_spans():
    timer = profiling.SectionTimer()
    timer.add("search", 0.3)
    timer.add("msv", 0.2, nested=True)
    timer.add("prefetch_wait", 0.1)
    assert timer.report() == ("search=300.0ms(75%) prefetch_wait=100.0ms(25%) "
                              "inside: msv=200.0ms")
