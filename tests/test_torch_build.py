"""The port's `build` path (io/msaio.py, models/build.py, io/hmmwrite.py and
the `build` command) against the JAX package's.

The MSA reader, the profile estimate and the writer are host code and
equal the JAX copies byte for byte. The calibration scores random
sequences with the port's MSV, eager Viterbi and log-space Forward scans
(their plain versions here, `device="cpu"`) where the JAX package uses its
XLA scans: MSV and Viterbi `mu` agree within 1e-3 bits, Forward `tau`
within 5e-3 bits (Forward's 2e-3-nat tolerance through nats_to_bits and
the 96th percentile), every `lambda` exactly; so the written files are
compared byte for byte apart from their three STATS lines, which are
compared parsed, within those tolerances."""

import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu.io import hmmio as jax_hmmio
from hmm_fasta_viterbi_tpu.io import hmmwrite as jax_hmmwrite
from hmm_fasta_viterbi_tpu.io import msaio as jax_msaio
from hmm_fasta_viterbi_tpu.models import build as jax_build
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.io import hmmwrite, msaio
from hmm_fasta_viterbi_tpu_torch.models import build

MU_TOL, TAU_TOL = 1e-3, 5e-3
STATS = ("STATS LOCAL MSV", "STATS LOCAL VITERBI", "STATS LOCAL FORWARD")


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
def msa(profile_dir, tmp_path_factory):
    """An RF-annotated Stockholm MSA of 20 samples of 100.hmm (the port's
    `emit` and `align --format stockholm`), and the same rows as aligned
    FASTA."""
    tmp = tmp_path_factory.mktemp("msa")
    src = str(profile_dir / "100.hmm")
    assert port_cli.main(["emit", "--hmm", src, "--count", "20", "--seed", "5",
                          "--out", str(tmp / "samples.fsa")]) == 0
    sto = tmp / "samples.sto"
    assert port_cli.main(["align", "--hmm", src, "--fasta", str(tmp / "samples.fsa"),
                          "--loader", "python", "--format", "stockholm", "--out", str(sto)]) == 0
    names, rows, _ = msaio.read_msa(sto)
    afa = tmp / "samples.afa"
    afa.write_text("".join(f">{n}\n{r}\n" for n, r in zip(names, rows)))
    return sto, afa


@pytest.mark.parametrize("fmt", ["stockholm", "afa"])
def test_read_msa_equal(msa, fmt):
    path = msa[0] if fmt == "stockholm" else msa[1]
    got = msaio.read_msa(path)
    assert got == jax_msaio.read_msa(path)
    assert len(got[1]) >= 18 and (got[2] is not None) == (fmt == "stockholm")


@pytest.mark.parametrize("text", [
    "# STOCKHOLM 1.0\n#=GC RF\nrow1 ACD\n//\n",
    "# STOCKHOLM 1.0\nrow1 ACD\nrow2 AC\n//\n",
    "# STOCKHOLM 1.0\n#=GC RF xx\nrow1 ACD\n//\n",
    "# STOCKHOLM 1.0\n//\n",
    "ACD\n>row1\nACD\n",
    ">row1\nACD\n>row2\nAC\n",
], ids=["empty-rf", "ragged", "rf-width", "no-rows", "data-first", "ragged-afa"])
def test_malformed_msa_errors_equal(tmp_path, text):
    path = tmp_path / "bad.msa"
    path.write_text(text)
    with pytest.raises(jax_msaio.MSAParseError) as want:
        jax_msaio.read_msa(path)
    with pytest.raises(msaio.MSAParseError) as got:
        msaio.read_msa(path)
    assert str(got.value) == str(want.value)
    assert issubclass(msaio.MSAParseError, ValueError)


@pytest.mark.parametrize("weighting", ["pb", "none"])
@pytest.mark.parametrize("fmt", ["stockholm", "afa"])
def test_build_profile_and_writer_equal(msa, fmt, weighting):
    """build_profile's arrays bit for bit and format_hmm's text byte for
    byte, from RF match columns and from the gap-majority rule."""
    path = msa[0] if fmt == "stockholm" else msa[1]
    _, rows, rf = msaio.read_msa(path)
    got = build.build_profile(rows, rf=rf, name="rebuilt", weighting=weighting)
    want = jax_build.build_profile(rows, rf=rf, name="rebuilt", weighting=weighting)
    for field in ("match_emissions", "insert_emissions", "transitions"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert got.model_length == want.model_length and got.name == want.name
    assert hmmwrite.format_hmm(got) == jax_hmmwrite.format_hmm(want)
    with pytest.raises(ValueError, match="weighting"):
        build.build_profile(rows, weighting="bogus")
    for bad in ([], ["ACD", "AC"], ["---", "---"]):
        with pytest.raises(ValueError):
            build.build_profile(bad)


def test_writer_round_trip_and_structural_stars(profile_dir, tmp_path):
    """write_hmm(parse_hmm(P)) is the JAX writer's file; the last node's
    m->d and d->d are always '*', which a star_as_zero_prob parse reads as
    impossible."""
    src = parse_hmm(profile_dir / "100.hmm")
    out = tmp_path / "rt.hmm"
    hmmwrite.write_hmm(src, out)
    assert out.read_text() == jax_hmmwrite.format_hmm(jax_hmmio.parse_hmm(profile_dir / "100.hmm"))
    star = parse_hmm(out, star_as_zero_prob=True)
    last = star.model_length - 1
    assert star.transitions[last, 2] == 0.0 and star.transitions[last, 6] == 0.0
    assert parse_hmm(out).transitions[last, 2] == 1.0
    rt = parse_hmm(out)
    np.testing.assert_allclose(rt.match_emissions, src.match_emissions, atol=2e-5)
    assert rt.stats_local_msv_mu == pytest.approx(src.stats_local_msv_mu, abs=1e-3)


def _same_stats(got, want):
    for field in ("msv_mu", "viterbi_mu"):
        a, b = getattr(got, f"stats_local_{field}"), getattr(want, f"stats_local_{field}")
        assert abs(a - b) <= MU_TOL, (field, a, b)
    a, b = got.stats_local_forward_theta, want.stats_local_forward_theta
    assert abs(a - b) <= TAU_TOL, ("forward_tau", a, b)
    for field in ("msv_lambda", "viterbi_lambda", "forward_lambda"):
        assert getattr(got, f"stats_local_{field}") == getattr(want, f"stats_local_{field}")


@pytest.mark.parametrize("which", ["built", "100.hmm"])
def test_calibrate_profile_matches_jax(profile_dir, msa, which):
    """calibrate_profile(seed=0) with the port's plain versions against the
    JAX package's XLA scans, on a built profile and on 100.hmm."""
    if which == "built":
        _, rows, rf = msaio.read_msa(msa[0])
        got = build.calibrate_profile(build.build_profile(rows, rf=rf), seed=0, device="cpu")
        want = jax_build.calibrate_profile(jax_build.build_profile(rows, rf=rf), seed=0)
    else:
        got = build.calibrate_profile(parse_hmm(profile_dir / "100.hmm"), seed=0, device="cpu")
        want = jax_build.calibrate_profile(jax_hmmio.parse_hmm(profile_dir / "100.hmm"), seed=0)
    _same_stats(got, want)
    assert got.stats_local_msv_lambda == pytest.approx(np.log(2.0))
    assert np.isfinite(got.stats_local_forward_theta)


def _split_stats(text):
    lines = text.splitlines()
    stats = [line for line in lines if line.startswith(STATS)]
    return [line for line in lines if not line.startswith(STATS)], stats


@pytest.mark.parametrize("weighting", ["pb", "none"])
def test_build_cli_matches_jax(msa, tmp_path, weighting, capsys):
    """build --device cpu: the file equals the JAX CLI's apart from its STATS
    lines, which agree parsed within the calibration tolerances."""
    common = ["build", "--msa", str(msa[0]), "--name", "rebuilt", "--seed", "0",
              "--weighting", weighting]
    jax_out, port_out = tmp_path / "jax.hmm", tmp_path / "port.hmm"
    assert jax_cli.main([*common, "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    body, stats = _split_stats(port_out.read_text())
    want_body, want_stats = _split_stats(jax_out.read_text())
    assert body == want_body and len(stats) == 3
    _same_stats(parse_hmm(port_out), jax_hmmio.parse_hmm(jax_out))
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == out[-2].replace(str(jax_out), str(port_out))


def test_emit_align_build_scan_loop(profile_dir, tmp_path, capsys):
    """JAX's test_emit_align_build_scan_loop through the port's CLI: emit
    samples of 100.hmm, align them to a Stockholm MSA, build and calibrate a
    new profile from it, then search: the samples hit the rebuilt profile,
    random sequences do not."""
    src = str(profile_dir / "100.hmm")
    samples = tmp_path / "samples.fsa"
    assert port_cli.main(["emit", "--hmm", src, "--count", "20", "--seed", "5",
                          "--out", str(samples)]) == 0
    msa = tmp_path / "samples.sto"
    assert port_cli.main(["align", "--hmm", src, "--fasta", str(samples),
                          "--format", "stockholm", "--out", str(msa)]) == 0
    names, rows, rf = msaio.read_msa(msa)
    assert len(rows) >= 18 and rf is not None
    built = tmp_path / "rebuilt.hmm"
    assert port_cli.main(["build", "--msa", str(msa), "--out", str(built), "--name", "rebuilt",
                          "--device", "cpu"]) == 0
    rb = parse_hmm(built)
    assert rb.name == "rebuilt" and abs(rb.model_length - 101) <= 2
    rng = np.random.default_rng(1)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    with open(samples, "a") as f:
        for i in range(10):
            f.write(f">rnd{i}\n" + "".join(aas[k] for k in rng.integers(0, 20, 100)) + "\n")
    capsys.readouterr()
    assert port_cli.main(["scan", "--hmm", str(built), "--fasta", str(samples), "--device",
                          "cpu", "--stage", "search", "--format", "json"]) == 0
    hits = {r["target"] for r in json.loads(capsys.readouterr().out) if r["hit"]}
    assert sum(1 for t in hits if "sample" in t) >= 18
    assert not any("rnd" in t for t in hits)


def test_build_cuda_without_cuda_exits_2(msa, tmp_path, monkeypatch, caplog):
    """build runs on the card by default; without CUDA it exits 2 with a
    clear message and writes nothing (it never calibrates on the CPU
    instead)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    out = tmp_path / "x.hmm"
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(["build", "--msa", str(msa[0]), "--out", str(out)]) == 2
    assert "torch.cuda.is_available() is false" in caplog.text and not out.exists()
    assert port_cli.build_parser().parse_args(
        ["build", "--msa", "m", "--out", "o"]).device == "cuda"
