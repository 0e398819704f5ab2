"""The PyTorch port's `scan` CLI (--device cpu) against the JAX CLI
(--backend xla): the TSV and JSON reports must be byte-equal. Both CLIs
parse with `--loader python`: the native .hmm parse differs from the
Python one by an ulp in some scores, which the JSON report's p-values show,
so a comparison must not depend on which parser each side reached."""

import logging

import pytest

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu.io import native as jax_native
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.io import native as port_native


def _assert_reports_equal(profile_dir, fasta_dir, tmp_path, fasta, fmt, extra):
    common = [
        "scan", "--loader", "python", "--hmm", str(profile_dir / "100.hmm"),
        "--fasta", str(fasta_dir / fasta), "--format", fmt, *extra,
    ]
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want = jax_out.read_bytes()
    assert want.count(b"Pfam-B_229") >= 1
    assert port_out.read_bytes() == want


@pytest.mark.parametrize(
    "extra", [[], ["--top", "2"], ["--max-evalue", "3.5"]], ids=["all", "top", "evalue"]
)
@pytest.mark.parametrize("fmt", ["tsv", "json"])
@pytest.mark.parametrize("fasta", ["fasta_like_example.fsa", "random_FASTA.fsa"])
def test_report_byte_equal_to_jax(profile_dir, fasta_dir, tmp_path, fasta, fmt, extra):
    _assert_reports_equal(profile_dir, fasta_dir, tmp_path, fasta, fmt, extra)


@pytest.mark.parametrize("failed", [jax_native, port_native], ids=["jax", "port"])
def test_report_byte_equal_when_one_native_loader_failed(profile_dir, fasta_dir, tmp_path,
                                                         monkeypatch, failed):
    """The JSON report (full-precision p-values) stays byte-equal when one
    package's native loader has cached a failure for the process, as a
    worker that read a half-written library once does, and the other's
    loads: the comparison pins both CLIs to one parser."""
    monkeypatch.setattr(failed, "_lib", None)
    monkeypatch.setattr(failed, "_load_error", "forced: the library could not be read")
    _assert_reports_equal(profile_dir, fasta_dir, tmp_path, "fasta_like_example.fsa", "json", [])


def test_cuda_device_without_cuda_exits_nonzero(profile_dir, fasta_dir, monkeypatch, caplog):
    """--device cuda (the default) on a machine without CUDA fails with a
    clear message; it never carries on on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = [
        "scan", "--hmm", str(profile_dir / "100.hmm"),
        "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
    ]
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(argv) == 2
    assert "torch.cuda.is_available() is false" in caplog.text


def test_only_msv_stage():
    """The port's stages are msv (the default), viterbi, forward and search;
    any other stage is refused by the parser."""
    parser = port_cli.build_parser()
    base = ["scan", "--hmm", "x.hmm", "--fasta", "y.fsa"]
    assert parser.parse_args(base).stage == "msv"
    for stage in ("viterbi", "forward", "search"):
        assert parser.parse_args([*base, "--stage", stage]).stage == stage
    with pytest.raises(SystemExit) as exc:
        parser.parse_args([*base, "--stage", "posterior"])
    assert exc.value.code == 2


def test_fast_and_sweep_flags():
    """scan takes --fast, --fused, --bucketed and --stream N; sweep takes
    --hmm-dir or --hmm-db, --stage msv|search, --fast, --bucketed, --stream
    N and --checkpoint DIR [--checkpoint-shard N], with the common flags
    (--config, --profile-trace and --mesh among them), and refuses --fused
    as the JAX CLI's sweep does."""
    parser = port_cli.build_parser()
    base = ["scan", "--hmm", "x.hmm", "--fasta", "y.fsa"]
    assert parser.parse_args([*base, "--stage", "search", "--fast"]).fast
    assert not parser.parse_args(base).fast
    assert parser.parse_args([*base, "--stage", "search", "--fused"]).fused
    assert not parser.parse_args(base).fused
    sweep = parser.parse_args(["sweep", "--hmm-dir", "d", "--fasta", "y.fsa", "--stage",
                               "search", "--fast", "--format", "json", "--top", "3",
                               "--device", "cpu", "--loader", "python", "--out", "o"])
    assert (sweep.hmm_dir, sweep.hmm_db, sweep.stage, sweep.fast, sweep.top) == (
        "d", None, "search", True, 3)
    assert parser.parse_args(["sweep", "--hmm-db", "p.hmm", "--fasta", "y.fsa"]).stage == "msv"
    scan = parser.parse_args([*base, "--bucketed", "--stream", "4"])
    assert (scan.bucketed, scan.stream) == (True, 4)
    assert (parser.parse_args(base).bucketed, parser.parse_args(base).stream) == (False, 0)
    sweep = parser.parse_args(["sweep", "--hmm-dir", "d", "--fasta", "y.fsa", "--bucketed",
                               "--stream", "8", "--checkpoint", "c", "--checkpoint-shard", "16"])
    assert (sweep.bucketed, sweep.stream, sweep.checkpoint, sweep.checkpoint_shard) == (
        True, 8, "c", 16)
    sweep = parser.parse_args(["sweep", "--hmm-dir", "d", "--fasta", "y.fsa"])
    assert (sweep.bucketed, sweep.stream, sweep.checkpoint, sweep.checkpoint_shard) == (
        False, 0, None, 4096)
    sweep = parser.parse_args(["sweep", "--hmm-dir", "d", "--fasta", "y.fsa", "--config",
                               "c.json", "--profile-trace", "t"])
    assert (sweep.config, sweep.profile_trace) == ("c.json", "t")
    assert parser.parse_args([*base, "--mesh", "db=2,sp=4"]).mesh == "db=2,sp=4"
    assert parser.parse_args(["sweep", "--hmm-dir", "d", "--fasta", "y.fsa", "--mesh",
                              "db=2,sp=4"]).mesh == "db=2,sp=4"
    assert parser.parse_args(base).mesh is None
    for flag in (["--fused"], ["--stage", "viterbi"]):
        with pytest.raises(SystemExit):
            parser.parse_args(["sweep", "--hmm-dir", "d", "--fasta", "y.fsa", *flag])
