"""`--mesh` on the PyTorch port's `scan` and `sweep`, on the CPU: a mesh of
repeated `cpu` ranks (`--device cpu`, eight of them, as the JAX suite's
virtual devices) runs the kernels' plain versions sharded.

Every mesh report is byte-equal to the meshless port report: `--mesh
db=8`, `--mesh db=2 --stream 2` and `--mesh db=2,sp=4` (the wavefront) for
the msv, viterbi, forward and search stages, and the sweeps. Against the
JAX CLI with the same `--mesh` (its Pallas backend in interpret mode;
`--loader python` on both sides) the msv and viterbi reports are
byte-equal, the forward rows within 2e-3 nats and the search rows' p- and
E-values within 1e-2 relative, every hit decision equal. The JAX CLI's
rules hold: sp > 1 refuses --bucketed and --stream on scan and sweep and
--fast on scan's search stage (exit 2), while sweep --fast runs its
cascade exactly over the wavefront with the meshless --fast report; a mesh
larger than the devices exits 2 with its message, and a db-only mesh
serves `--stage viterbi|forward`."""

import contextlib
import io
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch.models.sample import sample_sequences

FWD_TOL = 2e-3
MESHES = {"db8": ["--mesh", "db=8"], "db2_stream": ["--mesh", "db=2", "--stream", "2"],
          "db2_sp4": ["--mesh", "db=2,sp=4"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The workers of a parallel test run share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _letters(tokens) -> str:
    return "".join(AMINO_ACIDS[int(t)] for t in tokens)


@pytest.fixture(scope="module")
def hmm_db(profile_dir, tmp_path_factory):
    """100.hmm and 200.hmm in one //-separated file."""
    path = tmp_path_factory.mktemp("meshdb") / "two.hmm"
    path.write_text("".join((profile_dir / f"{s}.hmm").read_text() for s in (100, 200)))
    return path


@pytest.fixture(scope="module")
def fasta(profile_dir, tmp_path_factory):
    """Random rows of 30-135 residues, two homologs of 100.hmm and its
    consensus: rows that stop at every stage, and hits."""
    hmm = parse_hmm(profile_dir / "100.hmm")
    rng = np.random.default_rng(23)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 30 + 15 * k)))
               for k in range(8)]
    for k, seq in enumerate(sample_sequences(hmm, 2, seed=5)):
        records.insert(3 + 3 * k, FastaRecord(f"homolog{k}", _letters(seq)))
    records.append(FastaRecord("consensus", _letters(np.argmax(hmm.match_emissions[1:], 1))))
    path = tmp_path_factory.mktemp("mesh") / "mesh.fsa"
    write_fasta(path, records)
    return path


def _port(args, out):
    assert port_cli.main([*args, "--device", "cpu", "--loader", "python", "--out", str(out)]) == 0
    return out.read_bytes()


def _jax(args, out):
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main([*args, "--backend", "pallas", "--loader", "python",
                             "--out", str(out)]) == 0
    return out.read_bytes()


def _rows(text: bytes) -> dict:
    lines = text.decode().splitlines()
    header = lines[0].lstrip("# ").split("\t")
    return {tuple(r[:2]): dict(zip(header, r)) for r in
            (line.split("\t") for line in lines[1:] if not line.startswith("#"))}


def _close(a, b, rtol):
    if "nan" in (a, b):
        return a == b
    return abs(float(a) - float(b)) <= rtol * abs(float(b))


def _same_as_jax(port: bytes, jax: bytes, stage: str) -> None:
    if stage in ("msv", "viterbi"):
        assert port == jax
        return
    got, want = _rows(port), _rows(jax)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if stage == "forward":
            assert abs(float(g["score_nats"]) - float(w["score_nats"])) <= FWD_TOL, (g, w)
            continue
        assert (g["hit"], g["msv_bits"], g["msv_p"]) == (w["hit"], w["msv_bits"], w["msv_p"])
        for col, rtol in (("viterbi_p", 1e-3), ("forward_p", 1e-2), ("evalue", 1e-2)):
            assert _close(g[col], w[col], rtol), (col, g, w)


def test_parse_mesh_is_jax_s():
    for spec in ("db=8,sp=1", "8", "all", "ALL", "db=2, sp=4", "sp=2", "db=3,", ""):
        assert port_cli._parse_mesh(spec) == jax_cli._parse_mesh(spec)
    for spec in ("foo=2", "db=x"):
        with pytest.raises(ValueError) as want:
            jax_cli._parse_mesh(spec)
        with pytest.raises(ValueError) as got:
            port_cli._parse_mesh(spec)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("stage", ["msv", "viterbi", "forward", "search"])
def test_mesh_scan_report(profile_dir, fasta, tmp_path, caplog, stage, mesh):
    """The mesh report equals the meshless one byte for byte, and the JAX
    CLI's with the same --mesh; each route logs its mesh."""
    args = ["scan", "--stage", stage, "--hmm", str(profile_dir / "100.hmm"), "--fasta",
            str(fasta)]
    plain = _port(args, tmp_path / "plain.tsv")
    with caplog.at_level(logging.INFO):
        got = _port([*args, *MESHES[mesh]], tmp_path / "mesh.tsv")
    assert got == plain
    log = "sp wavefront mesh: {'db': 2, 'sp': 4}" if mesh == "db2_sp4" else (
        f"mesh: {{'db': {8 if mesh == 'db8' else 2}, 'sp': 1}}")
    assert log in caplog.text
    if stage == "search":
        assert sum(r["hit"] == "1" for r in _rows(got).values()) == 3
    _same_as_jax(got, _jax([*args, *MESHES[mesh]], tmp_path / "jax.tsv"), stage)


@pytest.mark.parametrize("mesh", ["db8", "db2_sp4"])
def test_mesh_sweep_report(hmm_db, fasta, tmp_path, mesh):
    """sweep, msv and search stages (the stacked sweep sharded; or a
    wavefront a profile), byte-equal to the meshless sweep."""
    for stage in ("msv", "search"):
        args = ["sweep", "--stage", stage, "--hmm-db", str(hmm_db), "--fasta", str(fasta)]
        assert _port([*args, *MESHES[mesh]], tmp_path / "mesh.tsv") == _port(
            args, tmp_path / "plain.tsv")


def test_mesh_sweep_stream_and_domains(profile_dir, hmm_db, fasta, tmp_path):
    """A streamed, a bucketed and a checkpointed sweep on the db mesh, and
    --domains decoded on it: byte-equal to the meshless runs."""
    sweep = ["sweep", "--hmm-db", str(hmm_db), "--fasta", str(fasta)]
    plain = _port(sweep, tmp_path / "b.tsv")
    for flags in (["--stream", "5"], ["--bucketed"],
                  ["--checkpoint", str(tmp_path / "ckpt"), "--checkpoint-shard", "4"]):
        assert _port([*sweep, *flags, "--mesh", "db=2"], tmp_path / "a.tsv") == plain
    assert len(list((tmp_path / "ckpt").glob("*.npz"))) == 2 * 3
    domains = ["scan", "--stage", "search", "--domains", "--hmm", str(profile_dir / "100.hmm"),
               "--fasta", str(fasta)]
    for mesh in (["--mesh", "db=8"], ["--mesh", "db=2", "--stream", "3"]):
        assert _port([*domains, *mesh], tmp_path / "c.tsv") == _port(domains,
                                                                   tmp_path / "d.tsv")


def test_sp_mesh_refusals(profile_dir, fasta, tmp_path, caplog):
    """--mesh sp>1 refuses --bucketed and --stream on scan and sweep, and
    --fast on scan's search stage, with exit 2, before a profile is read;
    --fast on another stage is the parser's no-op, as in the JAX CLI."""
    scan = ["scan", "--hmm", str(tmp_path / "missing.hmm"), "--fasta", str(fasta), "--device",
            "cpu", "--mesh", "db=2,sp=4"]
    sweep = ["sweep", "--hmm-dir", str(tmp_path), "--fasta", str(fasta), "--device", "cpu",
             "--mesh", "db=2,sp=4"]
    with caplog.at_level(logging.ERROR):
        assert port_cli.main([*scan, "--bucketed"]) == 2
        assert port_cli.main([*scan, "--stage", "search", "--fast"]) == 2
        assert port_cli.main([*scan, "--stream", "2"]) == 2
        assert port_cli.main([*sweep, "--stream", "2"]) == 2
        assert port_cli.main([*sweep, "--bucketed"]) == 2
    assert [r.getMessage() for r in caplog.records] == [
        "--bucketed does not compose with --mesh sp>1",
        "--fast does not compose with --mesh sp>1",
        "--stream does not compose with --mesh sp>1",
        "--stream does not compose with --mesh sp>1",
        "--bucketed does not compose with --mesh sp>1",
    ]
    args = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta), "--fast"]
    assert _port([*args, "--mesh", "db=2,sp=4"], tmp_path / "m.tsv") == _port(
        args, tmp_path / "p.tsv")


def test_sp_mesh_sweep_fast_matches_meshless(hmm_db, fasta, tmp_path):
    """sweep --stage search --fast on a db=2,sp=4 mesh, which the JAX CLI
    does not refuse: the wavefront runs the prefilters exactly, and the
    report equals the meshless --fast sweep's byte for byte."""
    args = ["sweep", "--stage", "search", "--fast", "--hmm-db", str(hmm_db), "--fasta",
            str(fasta)]
    got = _port([*args, "--mesh", "db=2,sp=4"], tmp_path / "mesh.tsv")
    assert got == _port(args, tmp_path / "plain.tsv")
    assert sum(r["hit"] == "1" for r in _rows(got).values()) == 3


def test_mesh_larger_than_the_devices_exits_2(profile_dir, fasta, tmp_path, caplog,
                                              monkeypatch):
    """Eight CPU ranks under --device cpu; the visible cards under --device
    cuda (one here, faked): a larger mesh exits 2 with the JAX message and
    never runs on fewer ranks or on the CPU."""
    args = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta),
            "--loader", "python", "--out", str(tmp_path / "o.tsv")]
    with caplog.at_level(logging.ERROR):
        assert port_cli.main([*args, "--device", "cpu", "--mesh", "db=9"]) == 2
        assert port_cli.main([*args, "--device", "cpu", "--mesh", "db=4,sp=4"]) == 2
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        assert port_cli.main([*args, "--mesh", "db=2"]) == 2
        assert port_cli.main([*args, "--mesh", "db=1,sp=2"]) == 2
    assert [r.getMessage() for r in caplog.records] == [
        "mesh 9x1 needs more than the 8 available devices",
        "mesh 4x4 needs more than the 8 available devices",
        "mesh 2x1 needs more than the 1 available devices",
        "mesh 1x2 needs more than the 1 available devices",
    ]
    assert not (tmp_path / "o.tsv").read_bytes()


def test_db_mesh_viterbi_forward_route(profile_dir, fasta, tmp_path, caplog):
    """A db-only mesh serves --stage viterbi|forward (the scanner's
    scan_p7, sharded); `--mesh all` takes every rank."""
    for stage in ("viterbi", "forward"):
        args = ["scan", "--stage", stage, "--hmm", str(profile_dir / "100.hmm"), "--fasta",
                str(fasta)]
        with caplog.at_level(logging.INFO):
            got = _port([*args, "--mesh", "all"], tmp_path / "m.tsv")
        assert "mesh: {'db': 8, 'sp': 1}" in caplog.text
        assert got == _port(args, tmp_path / "p.tsv")
        assert len(_rows(got)) == 11
