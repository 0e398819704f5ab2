"""`--profile-trace DIR` (runtime/profiling.py::device_trace) on the CPU: a
whole-file scan writes a torch.profiler Chrome trace into DIR with the
phases of its `seconds:` line labelled; without the flag no profiler runs;
the streamed scan and the sweep say that they record no trace; a trace
that asked for CUDA activity and holds no kernel is logged as an error,
one that holds kernels with the device's busy share and its idle time by
innermost span; the device busy share is the union of the kernel
intervals over the labelled window; and a search's log line counts the
pack cache's builds and lookups."""

import json
import logging
import re

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.runtime import profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores, and many
    threads a worker on such ops mostly wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hit_fasta(profile_dir, tmp_path_factory):
    """The consensus of 100.hmm (a hit with one domain) and random rows."""
    hmm = parse_hmm(profile_dir / "100.hmm")
    consensus = "".join(AMINO_ACIDS[a] for a in np.argmax(hmm.match_emissions[1:], axis=1))
    rng = np.random.default_rng(2)
    rows = "".join(f">rand{k}\n" + "".join(AMINO_ACIDS[a] for a in rng.integers(0, 20, 150))
                   + "\n" for k in range(4))
    path = tmp_path_factory.mktemp("trace") / "hit.fsa"
    path.write_text(f">consensus\n{consensus}\n{rows}")
    return path


def _labels(trace: dict) -> set:
    """The labels of a trace, a search's ``search#<n>`` as ``search``."""
    return {e["name"].split("#")[0] for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"}


def test_scan_writes_a_trace_with_the_phase_labels(profile_dir, hit_fasta, tmp_path):
    trace_dir = tmp_path / "trace"
    out = tmp_path / "out.tsv"
    assert port_cli.main(["scan", "--stage", "search", "--domains", "--align", "--hmm",
                          str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta), "--device",
                          "cpu", "--profile-trace", str(trace_dir), "--out", str(out)]) == 0
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert _labels(trace) == set(profiling.PHASES) | {"pvalues", "restage", "pack", "search"}
    assert profiling.kernel_events(trace) == []
    share, window_us = profiling.busy_share(trace)
    assert share == 0.0 and window_us > 0
    assert not profiling._tracing
    # the traced run's report is the untraced one's
    plain = tmp_path / "plain.tsv"
    assert port_cli.main(["scan", "--stage", "search", "--domains", "--align", "--hmm",
                          str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta), "--device",
                          "cpu", "--out", str(plain)]) == 0
    assert out.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("stage", ["msv", "forward"])
def test_single_stage_trace_labels(profile_dir, hit_fasta, tmp_path, stage):
    trace_dir = tmp_path / "trace"
    assert port_cli.main(["scan", "--stage", stage, "--hmm", str(profile_dir / "100.hmm"),
                          "--fasta", str(hit_fasta), "--device", "cpu", "--profile-trace",
                          str(trace_dir), "--out", str(tmp_path / "o.tsv")]) == 0
    trace = json.loads(next(trace_dir.glob("*.pt.trace.json")).read_text())
    assert _labels(trace) == {"parse", "stage", stage, "pack", "report"}


def test_no_profiler_without_the_flag(profile_dir, hit_fasta, tmp_path, monkeypatch):
    """Without --profile-trace neither the profiler nor record_function runs."""

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler ran without --profile-trace")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    assert port_cli.main(["scan", "--stage", "search", "--domains", "--hmm",
                          str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta), "--device",
                          "cpu", "--out", str(tmp_path / "o.tsv")]) == 0
    with profiling.device_trace(None):
        with profiling.span("msv"):
            pass


@pytest.mark.parametrize("argv", [["scan", "--stream", "2", "--hmm"], ["sweep", "--hmm-db"]],
                         ids=["stream", "sweep"])
def test_untraced_routes_say_so(profile_dir, hit_fasta, tmp_path, caplog, argv):
    trace_dir = tmp_path / "trace"
    with caplog.at_level(logging.WARNING, logger=port_cli.__name__):
        assert port_cli.main([*argv, str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta),
                              "--device", "cpu", "--profile-trace", str(trace_dir),
                              "--out", str(tmp_path / "o.tsv")]) == 0
    assert "--profile-trace covers only the whole-file scan" in caplog.text
    assert not trace_dir.exists()


def test_cuda_trace_without_kernels_is_an_error(tmp_path, monkeypatch, caplog):
    """A trace that asked for CUDA activity (here on a machine without
    CUDA, so CUPTI records nothing) and holds no kernel is logged as an
    error, not passed off as a device trace."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    with caplog.at_level(logging.INFO, logger=profiling.__name__):
        with pytest.warns(UserWarning, match="CUDA"):
            with profiling.device_trace(str(tmp_path), "cuda"):
                with profiling.span("msv"):
                    torch.ones(8).add_(1)
    errors = [r.getMessage() for r in caplog.records if r.levelno == logging.ERROR]
    assert len(errors) == 1 and "holds no CUDA kernel event" in errors[0]
    assert _labels(json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())) == {"msv"}


def test_busy_share_is_the_union_of_kernels_over_the_labelled_window():
    trace = {"traceEvents": [
        {"cat": "user_annotation", "name": "stage", "ts": 100, "dur": 50},
        {"cat": "user_annotation", "name": "msv", "ts": 150, "dur": 150},
        {"cat": "user_annotation", "name": "other", "ts": 0, "dur": 1000},
        {"cat": "kernel", "name": "a", "ts": 90, "dur": 30},    # 100..120 inside
        {"cat": "kernel", "name": "b", "ts": 110, "dur": 20},   # overlaps a: ..130
        {"cat": "kernel", "name": "c", "ts": 200, "dur": 50},   # 200..250
        {"cat": "kernel", "name": "d", "ts": 290, "dur": 40},   # 290..300 inside
        {"cat": "cpu_op", "name": "e", "ts": 100, "dur": 200},
    ]}
    share, window = profiling.busy_share(trace)
    assert window == 200 and share == pytest.approx((30 + 50 + 10) / 200)
    assert [e["name"] for e in profiling.kernel_events(trace)] == ["a", "b", "c", "d"]
    with pytest.raises(ValueError, match="phase label"):
        profiling.busy_share({"traceEvents": []})


# a search traced 0-1.2 s (µs below): kernels 0.05-0.33 s inside msv and
# 0.73-0.88 s inside viterbi, the rest of the region idle
_SEARCH_TRACE = {"traceEvents": [
    {"cat": "user_annotation", "name": "search#7", "ts": 0, "dur": 1_000_000},
    {"cat": "user_annotation", "name": "msv", "ts": 0, "dur": 400_000},
    {"cat": "user_annotation", "name": "pvalues", "ts": 400_000, "dur": 200_000},
    {"cat": "user_annotation", "name": "viterbi", "ts": 600_000, "dur": 300_000},
    {"cat": "user_annotation", "name": "restage", "ts": 600_000, "dur": 110_000},
    {"cat": "user_annotation", "name": "report", "ts": 1_100_000, "dur": 100_000},
    {"cat": "kernel", "name": "msv_kernel", "ts": 50_000, "dur": 280_000},
    {"cat": "kernel", "name": "viterbi_kernel", "ts": 730_000, "dur": 150_000},
    {"cat": "cpu_op", "name": "aten::to", "ts": 600_000, "dur": 100_000},
]}


def test_idle_by_span_names_the_innermost_span():
    share, window, idle = profiling.idle_by_span(_SEARCH_TRACE)
    assert window == 1_200_000 and share == pytest.approx(430_000 / 1_200_000)
    assert idle == pytest.approx({
        "msv": 120_000, "pvalues": 200_000, "restage": 110_000, "viterbi": 40_000,
        "search": 100_000, "no span": 100_000, "report": 100_000,
    })
    assert sum(idle.values()) == pytest.approx(window * (1 - share))
    assert profiling.trace_summary(_SEARCH_TRACE) == (
        "device busy 35.8% of 1.200 s (2 kernels); idle by innermost span: "
        "pvalues 0.200 s, msv 0.120 s, restage 0.110 s")
    with pytest.raises(ValueError, match="labelled range"):
        profiling.idle_by_span({"traceEvents": []})


def test_cuda_trace_logs_busy_share_and_idle_by_span(tmp_path, monkeypatch, caplog):
    """device_trace's exit log over a CUDA trace (here a stand-in
    profiler's): the busy share and the three largest idle totals."""

    class Recorded:
        def __init__(self, activities):
            self.activities = activities

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump(_SEARCH_TRACE, f)

    monkeypatch.setattr(torch.profiler, "profile", Recorded)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    with caplog.at_level(logging.INFO, logger=profiling.__name__):
        with profiling.device_trace(str(tmp_path), "cuda"):
            pass
    msgs = [r.getMessage() for r in caplog.records]
    assert ("profiler trace: device busy 35.8% of 1.200 s (2 kernels); idle by innermost "
            "span: pvalues 0.200 s, msv 0.120 s, restage 0.110 s") in msgs
    assert not any(r.levelno >= logging.ERROR for r in caplog.records)


@pytest.mark.parametrize("extra", [[], ["--stream", "2"]], ids=["whole", "stream"])
def test_search_log_counts_the_pack_cache(profile_dir, hit_fasta, tmp_path, caplog, extra):
    """The search's log line gives the packs built of the lookups: the
    whole-file search looks up and builds its MSV, Viterbi and Forward
    packs once; the streamed one builds them once over three batches."""
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main(["scan", "--stage", "search", *extra, "--hmm",
                              str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta),
                              "--device", "cpu", "--out", str(tmp_path / "o.tsv")]) == 0
    prefix = "streamed search " if extra else "search "
    line = next(m for m in (r.getMessage() for r in caplog.records)
                if m.startswith(prefix) and "past MSV" in m)
    built, looked_up = map(int, re.search(r"packs built (\d+) of (\d+) lookups", line).groups())
    assert built == 3
    assert looked_up == 3 if not extra else looked_up >= 5
