"""The PyTorch port's streamed commands on the CPU (the kernels' plain
versions): ``scan --stream N`` (msv, viterbi, forward), ``scan --stage
search [--fast] [--domains] --stream N`` and ``sweep --stream N`` (msv,
search --fast), against the port's whole-file reports and the JAX CLI's
``--stream`` (--backend xla); the flag conflicts; the side-stream stager's
CPU path; and the int8 ``pad_token`` repair of the encoders.

Every streamed report is byte-equal to the port's whole-file report
(JSON: full-precision scores and p/E-values, E-values over the whole
database). Against the JAX CLI, MSV reports are byte-equal and the
Viterbi, Forward and search reports agree within
tests/test_torch_search.py's tolerances. Both CLIs parse with
``--loader python``; a batch of 3 records splits the hits across batches.
"""

import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu.io import fastaio as jax_fastaio
from hmm_fasta_viterbi_tpu.io import native as jax_native
from hmm_fasta_viterbi_tpu_torch import MSVProfile, P7Profile, StagedDatabase, parse_hmm
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.io import fastaio, native
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner, SideStreamStager

STREAM = ["--stream", "3"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores, and many
    threads a worker on such ops mostly wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _letters(tokens) -> str:
    return "".join(AMINO_ACIDS[int(t)] for t in tokens)


@pytest.fixture(scope="module")
def stream_fasta(profile_dir, tmp_path_factory):
    """Eleven records: random sequences of growing length, the consensus of
    100.hmm in the first and third batch of 3, a homolog sampled from it in
    the second, and one rejected record (a prohibited symbol)."""
    hmm = parse_hmm(profile_dir / "100.hmm")
    consensus = _letters(np.argmax(hmm.match_emissions[1:], axis=1))
    rng = np.random.default_rng(11)
    recs = [(f"rnd{i}", _letters(rng.integers(0, 20, 60 + 23 * i))) for i in range(7)]
    recs.insert(1, ("hitA", consensus))
    recs.insert(4, ("homolog", _letters(sample_sequences(hmm, 1, seed=3)[0])))
    recs.insert(6, ("bad", "ACDXZ"))
    recs.insert(8, ("hitB", consensus))
    path = tmp_path_factory.mktemp("stream") / "db.fsa"
    path.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
    return path


@pytest.fixture(scope="module")
def hmm_dir(profile_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_hmms")
    for stem in ("100", "200"):
        (d / f"{stem}.hmm").write_bytes((profile_dir / f"{stem}.hmm").read_bytes())
    return d


def _port(argv, out) -> bytes:
    assert port_cli.main([*argv, "--device", "cpu", "--out", str(out)]) == 0
    return out.read_bytes()


def _jax(argv, out) -> bytes:
    assert jax_cli.main([*argv, "--backend", "xla", "--out", str(out)]) == 0
    return out.read_bytes()


def _close(a, b, rtol):
    if a is None or b is None:
        return a == b
    return abs(a - b) <= rtol * abs(b)


def _same_search_rows(got: list, want: list) -> None:
    """tests/test_torch_search.py's comparison of a search report."""
    assert [(r["profile"], r["target"]) for r in got] == [(r["profile"], r["target"])
                                                          for r in want]
    assert any(r["hit"] for r in want)
    for g, w in zip(got, want):
        assert (g["hit"], g["msv_bits"], g["msv_p"]) == (w["hit"], w["msv_bits"], w["msv_p"])
        assert _close(g["viterbi_p"], w["viterbi_p"], 1e-3)
        for key in ("forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)
        assert [(d["env_from"], d["env_to"]) for d in g.get("domains", [])] == [
            (d["env_from"], d["env_to"]) for d in w.get("domains", [])]


@pytest.mark.parametrize("stage", ["msv", "viterbi", "forward"])
def test_scan_stream_equals_whole_and_jax(profile_dir, stream_fasta, tmp_path, stage, caplog):
    """scan --stream: byte-equal to the whole-file scan (E-values over all
    10 valid sequences); MSV byte-equal to the JAX CLI's --stream, the
    Viterbi and Forward scores within 1e-4 and 2e-3 nats of it (plus the
    4-decimal rounding) and their p-values within 1e-2; the phase line
    carries the producer's sections, the seconds line says it overlaps."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(stream_fasta),
              "--loader", "python", "--stage", stage, "--format", "json"]
    whole = _port(common, tmp_path / "whole")
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        streamed = _port([*common, *STREAM], tmp_path / "stream")
    assert streamed == whole and len(json.loads(whole)) == 10
    jax = _jax([*common, *STREAM], tmp_path / "jax")
    if stage == "msv":
        assert streamed == jax
    else:
        tol = (1e-4 if stage == "viterbi" else 2e-3) + 1e-4
        got, want = json.loads(streamed), json.loads(jax)
        assert [r["target"] for r in got] == [r["target"] for r in want]
        for g, w in zip(got, want):
            assert abs(g["score_nats"] - w["score_nats"]) <= tol
            assert _close(g["pvalue"], w["pvalue"], 1e-2) and _close(g["evalue"], w["evalue"],
                                                                     1e-2)
    msgs = [r.getMessage() for r in caplog.records]
    line = next(m for m in msgs if m.startswith("streamed scan phases:"))
    for section in ("prefetch_wait", "scan", "producer/parse", "producer/encode",
                    "producer/stage", "producer/put_wait"):
        assert f" {section}=" in f" {line}", section
    seconds = next(r for r in caplog.records if r.msg.startswith("seconds:"))
    assert "the phases do not add up to the total" in seconds.getMessage()
    phases = dict(zip(("parse", "stage", "msv", "viterbi", "forward"), seconds.args[:5]))
    assert phases[stage] > 0 and phases["parse"] > 0 and phases["stage"] > 0


@pytest.mark.parametrize("extra", [[], ["--fast"], ["--domains"]], ids=["plain", "fast",
                                                                         "domains"])
def test_search_stream_equals_whole_and_jax(profile_dir, stream_fasta, tmp_path, extra):
    """scan --stage search --stream (--fast, --domains): byte-equal to the
    whole-file search, its E-values and i-Evalues over the whole database;
    against the JAX CLI's --stream (which runs no prefilter on its XLA
    backend, so --fast is held to the port's whole-file run) the rows, hit
    flags, MSV fields and domain spans are equal, the p-values within the
    search tests' tolerances. Every planted row is a hit."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(stream_fasta),
              "--loader", "python", "--stage", "search", "--format", "json", *extra]
    whole = _port(common, tmp_path / "whole")
    streamed = _port([*common, *STREAM], tmp_path / "stream")
    assert streamed == whole
    rows = json.loads(streamed)
    assert {r["target"] for r in rows if r["hit"]} >= {"hitA", "hitB", "homolog"}
    if "--domains" in extra:
        assert all(r["ndom"] >= 1 for r in rows if r["hit"])
    if "--fast" not in extra:
        _same_search_rows(rows, json.loads(_jax([*common, *STREAM], tmp_path / "jax")))


@pytest.mark.parametrize("stage", ["msv", "search"])
def test_sweep_stream_equals_whole_and_jax(hmm_dir, stream_fasta, tmp_path, stage):
    """sweep --stream (msv; search --fast): byte-equal to the whole-file
    sweep; the MSV sweep byte-equal to the JAX CLI's --stream, the search
    sweep's rows equal to the JAX CLI's plain --stream cascade within the
    search tests' tolerances where the fast cascade keeps them (its rows'
    MSV fields, hit flags and, for hits, Forward)."""
    common = ["sweep", "--hmm-dir", str(hmm_dir), "--fasta", str(stream_fasta), "--loader",
              "python", "--stage", stage, "--format", "json"]
    fast = ["--fast"] if stage == "search" else []
    whole = _port([*common, *fast], tmp_path / "whole")
    streamed = _port([*common, *fast, *STREAM], tmp_path / "stream")
    assert streamed == whole
    jax = _jax([*common, *STREAM], tmp_path / "jax")
    if stage == "msv":
        assert streamed == jax and len(json.loads(jax)) == 20
        return
    got, want = json.loads(streamed), json.loads(jax)
    assert [(r["profile"], r["target"], r["hit"], r["msv_bits"], r["msv_p"]) for r in got] == [
        (r["profile"], r["target"], r["hit"], r["msv_bits"], r["msv_p"]) for r in want]
    for g, w in zip(got, want):
        if w["hit"]:
            assert _close(g["forward_p"], w["forward_p"], 1e-2)
            assert _close(g["evalue"], w["evalue"], 1e-2)


def test_flag_conflicts_exit_2_before_profiles_load(profile_dir, fasta_dir, tmp_path, caplog):
    """--stream with --bucketed (scan, sweep) or --checkpoint (sweep),
    --checkpoint with --bucketed, and a negative --stream (scan, sweep) exit
    2 before the profiles are read (a missing --hmm-dir would exit 1, a
    missing --hmm 2 with another message)."""
    fasta = ["--fasta", str(fasta_dir / "fasta_like_example.fsa"), "--device", "cpu"]
    missing = ["--hmm-dir", str(tmp_path / "missing")]
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(["scan", "--hmm", str(tmp_path / "missing.hmm"), *fasta,
                              *STREAM, "--bucketed"]) == 2
        for flags in (["--bucketed"], ["--checkpoint", str(tmp_path / "c")]):
            assert port_cli.main(["sweep", *missing, *fasta, *STREAM, *flags]) == 2
        assert port_cli.main(["sweep", *missing, *fasta, "--checkpoint", str(tmp_path / "c"),
                              "--bucketed"]) == 2
        assert port_cli.main(["scan", "--hmm", str(tmp_path / "missing.hmm"), *fasta,
                              "--stream", "-1"]) == 2
        assert port_cli.main(["sweep", *missing, *fasta, "--stream", "-1"]) == 2
    errors = [r.getMessage() for r in caplog.records]
    assert errors == [
        "--stream does not compose with --bucketed",
        "--stream does not compose with --bucketed or --checkpoint",
        "--stream does not compose with --bucketed or --checkpoint",
        "--checkpoint does not compose with --bucketed",
        "--stream must be at least 1 (0 reads the whole file)",
        "--stream must be at least 1 (0 reads the whole file)",
    ]
    assert not (tmp_path / "c").exists()


def test_streamed_commands_without_cuda_exit_2(profile_dir, fasta_dir, tmp_path, monkeypatch):
    """--device cuda (the default) without a card: exit 2 for the streamed,
    bucketed and checkpointed commands too."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    fasta = ["--fasta", str(fasta_dir / "fasta_like_example.fsa")]
    scan = ["scan", "--hmm", str(profile_dir / "100.hmm"), *fasta]
    sweep = ["sweep", "--hmm-db", str(profile_dir / "100.hmm"), *fasta]
    for argv in ([*scan, *STREAM], [*scan, "--bucketed"], [*sweep, *STREAM],
                 [*sweep, "--bucketed"], [*sweep, "--checkpoint", str(tmp_path / "c")]):
        assert port_cli.main(argv) == 2, argv


def test_side_stream_stager_on_the_cpu_is_stage():
    """On the CPU the stager is the scanner's stage: the same tensors, no
    side stream and no event."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 20, size=(6, 256)).astype(np.int8)
    lengths = np.array([0, 1, 37, 256, 100, 3], dtype=np.int32)
    scanner = MSVScanner(device="cpu")
    stager = SideStreamStager(scanner)
    assert stager.stream is None
    got, want = stager(tokens, lengths), scanner.stage(tokens, lengths)
    for field in ("tokens", "lengths", "tr_rows", "tr_probs"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.num_sequences == 6 and got.stream is None and got.ready is None
    assert stager.batches == 0


def test_side_staged_batch_without_its_event_is_refused(profile_dir):
    """Every scan entry refuses a batch that says it was staged on a side
    stream but carries no event: its uploads could still be running."""
    hmm = parse_hmm(profile_dir / "100.hmm")
    msv, p7 = MSVProfile.from_profile(hmm), P7Profile.from_profile(hmm)
    scanner = MSVScanner(device="cpu")
    rng = np.random.default_rng(4)
    staged = scanner.stage(rng.integers(0, 20, size=(3, 40)), np.full(3, 40, np.int32))
    side = StagedDatabase(staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
                          staged.num_sequences, stream=object(), ready=None)
    for scan in (lambda s: scanner.scan(msv, s), lambda s: scanner.scan_filter(msv, s),
                 lambda s: scanner.scan_many([msv], s), lambda s: scanner.scan_p7(p7, s),
                 lambda s: scanner.scan_p7_filter(p7, s)):
        scan(staged)
        with pytest.raises(RuntimeError, match="without its event"):
            scan(side)


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("pad_token", [0, 20, -1, 127])
def test_pad_token_repair(fasta_dir, dtype, pad_token):
    """A pad_token the dtype cannot hold (200 in int8) raises ValueError in
    both encoders instead of wrapping to -56; every valid encode stays
    byte-equal to the JAX package's."""
    db = fastaio.parse_fasta(fasta_dir / "fasta_like_example.fsa")
    jax_db = jax_fastaio.parse_fasta(fasta_dir / "fasta_like_example.fsa")
    flat = np.concatenate([np.frombuffer(r.sequence.encode(), np.uint8) for r in db.records])
    lookup = np.zeros(256, np.int8)
    lookup[np.frombuffer(AMINO_ACIDS.encode(), np.uint8)] = np.arange(20)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in db.records])]).astype(np.int64)
    headers = [r.header for r in db.records]
    port_batch = native.EncodedFastaBatch(headers, lookup[flat], offsets)
    jax_batch = jax_native.EncodedFastaBatch(headers, lookup[flat], offsets)
    for port, jax in ((db, jax_db), (port_batch, jax_batch)):
        got = port.encode(pad_multiple=256, pad_token=pad_token, dtype=dtype)
        want = jax.encode(pad_multiple=256, pad_token=pad_token, dtype=dtype)
        assert got[0].dtype == want[0].dtype == dtype
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
        if dtype is np.int8:
            with pytest.raises(ValueError, match="pad_token 200 does not fit int8"):
                port.encode(pad_token=200, dtype=np.int8)
            assert jax.encode(pad_token=200, dtype=np.int8)[0].min() == -56  # the trap
