"""`--profile-trace DIR` (runtime/profiling.py::device_trace) on the CPU: a
whole-file scan writes a torch.profiler Chrome trace into DIR with the
phases of its `seconds:` line labelled; without the flag no profiler runs;
the streamed scan and the sweep say that they record no trace; a trace
that asked for CUDA activity and holds no kernel is logged as an error;
and the device busy share is the union of the kernel intervals over the
labelled window."""

import json
import logging

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
    return {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}


def test_scan_writes_a_trace_with_the_phase_labels(profile_dir, hit_fasta, tmp_path):
    trace_dir = tmp_path / "trace"
    out = tmp_path / "out.tsv"
    assert port_cli.main(["scan", "--stage", "search", "--domains", "--align", "--hmm",
                          str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta), "--device",
                          "cpu", "--profile-trace", str(trace_dir), "--out", str(out)]) == 0
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert _labels(trace) == set(profiling.PHASES)
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
    assert _labels(trace) == {"parse", "stage", stage, "report"}


def test_no_profiler_without_the_flag(profile_dir, hit_fasta, tmp_path, monkeypatch):
    """Without --profile-trace neither the profiler nor record_function runs."""

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler ran without --profile-trace")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert port_cli.main(["scan", "--stage", "search", "--domains", "--hmm",
                          str(profile_dir / "100.hmm"), "--fasta", str(hit_fasta), "--device",
                          "cpu", "--out", str(tmp_path / "o.tsv")]) == 0
    with profiling.device_trace(None):
        with profiling.phase("msv"):
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
                with profiling.phase("msv"):
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
