"""The port's copy of runtime/config.py and `--config FILE` on `scan` and
`sweep`, read as the JAX CLI reads it: the cascade thresholds (msv_p,
viterbi_p, forward_p) go to the search pipeline and m_bucket to the
scanner; backend and l_chunk are knobs of the TPU kernels, ignored with a
warning each; use_mesh builds the (mesh_db x mesh_sp) mesh and shards
the scan over its db axis; unknown keys raise.

MSV scores are bit-exact in both packages, so an msv-stage sweep under
`--config` is byte-equal to the JAX CLI's; a search report's Forward p- and
E-values come from each package's own Forward scan and are held as
tests/test_torch_search.py holds them, with every row and decision
equal."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu.runtime.config import EngineConfig as JaxEngineConfig
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu_torch.runtime.config import EngineConfig

# looser than HMMER3's defaults (0.02, 1e-3, 1e-5): more rows pass each stage
THRESHOLDS = {"msv_p": 0.2, "viterbi_p": 0.05, "forward_p": 1e-3}


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
def fasta(profile_dir, tmp_path_factory):
    """Random rows, two homologs sampled from 100.hmm and pieces of its
    consensus inside random residues: rows that stop at each stage of the
    cascade under the default thresholds and pass further under looser
    ones."""
    hmm = parse_hmm(profile_dir / "100.hmm")
    rng = np.random.default_rng(17)
    consensus = np.argmax(hmm.match_emissions[1:], axis=1)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 100 + 9 * k)))
               for k in range(8)]
    for k, seq in enumerate(sample_sequences(hmm, 2, seed=3)):
        records.append(FastaRecord(f"homolog{k}", _letters(seq)))
    for start, stop in ((60, 74), (60, 78), (30, 44), (30, 47), (30, 50), (30, 60)):
        piece = [rng.integers(0, 20, 50), consensus[start:stop], rng.integers(0, 20, 40)]
        records.append(FastaRecord(f"fragment{start}_{stop}", _letters(np.concatenate(piece))))
    path = tmp_path_factory.mktemp("config") / "config.fsa"
    write_fasta(path, records)
    return path


@pytest.fixture(scope="module")
def hmm_db(profile_dir, tmp_path_factory):
    path = tmp_path_factory.mktemp("configdb") / "two.hmm"
    path.write_text("".join((profile_dir / f"{s}.hmm").read_text() for s in (100, 300)))
    return path


def _config(tmp_path, name="engine.json", **fields):
    path = tmp_path / name
    path.write_text(json.dumps(fields))
    return path


def _close(a, b, rtol):
    if a in (None, "nan") or b in (None, "nan"):
        return a == b
    return abs(float(a) - float(b)) <= rtol * abs(float(b))


def _rows(path):
    """The rows of a TSV report (a sweep writes a header line a profile)."""
    lines = path.read_text().splitlines()
    header = lines[0].lstrip("# ").split("\t")
    return [dict(zip(header, line.split("\t"))) for line in lines if not line.startswith("#")]


def _same_search_rows(got, want):
    assert [(r["target"], r["profile"]) for r in got] == [(r["target"], r["profile"])
                                                          for r in want]
    for g, w in zip(got, want):
        assert g["hit"] == w["hit"] and g["msv_bits"] == w["msv_bits"]
        assert g["msv_p"] == w["msv_p"] and _close(g["viterbi_p"], w["viterbi_p"], 1e-3)
        for key in ("forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)


def test_engine_config_round_trip_env_and_unknown_keys(tmp_path):
    cfg = EngineConfig(msv_p=0.05, m_bucket=128, mesh_db=None, use_mesh=False)
    path = tmp_path / "cfg.json"
    cfg.to_json(path)
    assert EngineConfig.from_json(path) == cfg
    assert path.read_text() == json.dumps(dataclasses.asdict(cfg), indent=1)
    env = {"HFV_MSV_P": "0.05", "HFV_M_BUCKET": "64", "HFV_MESH_DB": "none",
           "HFV_USE_MESH": "yes", "HFV_BACKEND": "xla", "HFV_LOADER": "python",
           "HFV_FORWARD_P": "1e-4", "OTHER": "1"}
    got = EngineConfig.from_env(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(JaxEngineConfig.from_env(env))
    assert (got.msv_p, got.m_bucket, got.mesh_db, got.use_mesh) == (0.05, 64, None, True)
    assert EngineConfig.from_env({}) == EngineConfig()
    # from_env dispatches on annotation strings
    assert {f.name: f.type for f in dataclasses.fields(EngineConfig)}["mesh_db"] == "int | None"
    bad = _config(tmp_path, "bad.json", msv_p=0.1, chunk=4)
    with pytest.raises(ValueError, match="unknown config keys"):
        EngineConfig.from_json(bad)


@pytest.mark.parametrize("fmt", ["tsv", "json"])
def test_scan_search_config_matches_jax(profile_dir, fasta, tmp_path, fmt):
    """scan --stage search --config with looser thresholds: the JAX CLI's
    rows and decisions, and more rows than the default thresholds give."""
    cfg = _config(tmp_path, **THRESHOLDS)
    common = ["scan", "--stage", "search", "--hmm", str(profile_dir / "100.hmm"), "--fasta",
              str(fasta), "--loader", "python", "--format", fmt]
    jax_out, port_out, plain = (tmp_path / f"{n}.out" for n in ("jax", "port", "plain"))
    assert jax_cli.main([*common, "--config", str(cfg), "--backend", "xla",
                         "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--config", str(cfg), "--device", "cpu",
                          "--out", str(port_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(plain)]) == 0
    if fmt == "json":
        got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
        base = json.loads(plain.read_text())
        for rows in (got, want, base):
            for r in rows:
                r["hit"] = str(int(r["hit"]))
    else:
        got, want, base = _rows(port_out), _rows(jax_out), _rows(plain)
    _same_search_rows(got, want)
    assert len(got) > len(base)


def test_sweep_config_matches_jax(profile_dir, hmm_db, fasta, tmp_path):
    """sweep (msv) under --config m_bucket 256 (the JAX scanner's default
    bucket; the port's is 8) is byte-equal to the JAX CLI's; sweep --stage
    search under the thresholds holds the JAX CLI's rows."""
    cfg = _config(tmp_path, m_bucket=256, **THRESHOLDS)
    common = ["sweep", "--hmm-db", str(hmm_db), "--fasta", str(fasta), "--loader", "python",
              "--config", str(cfg)]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    for stage in ("msv", "search"):
        assert jax_cli.main([*common, "--stage", stage, "--backend", "xla",
                             "--out", str(jax_out)]) == 0
        assert port_cli.main([*common, "--stage", stage, "--device", "cpu",
                              "--out", str(port_out)]) == 0
        if stage == "msv":
            assert port_out.read_bytes() == jax_out.read_bytes()
        else:
            _same_search_rows(_rows(port_out), _rows(jax_out))
            assert any(r["hit"] == "1" for r in _rows(port_out))


@pytest.mark.parametrize("route", [["--bucketed"], ["--stream", "2"]], ids=["bucketed", "stream"])
def test_config_on_every_scan_route(profile_dir, fasta, tmp_path, route):
    """--config reaches the bucketed and streamed searches: each report
    equals the whole-file search's under the same file."""
    cfg = _config(tmp_path, m_bucket=64, **THRESHOLDS)
    common = ["scan", "--stage", "search", "--hmm", str(profile_dir / "100.hmm"), "--fasta",
              str(fasta), "--device", "cpu", "--config", str(cfg)]
    whole, routed = tmp_path / "whole.tsv", tmp_path / "routed.tsv"
    assert port_cli.main([*common, "--out", str(whole)]) == 0
    assert port_cli.main([*common, *route, "--out", str(routed)]) == 0
    assert routed.read_bytes() == whole.read_bytes()
    assert len(whole.read_text().splitlines()) > 2


def test_config_on_checkpointed_sweep(profile_dir, fasta, tmp_path):
    cfg = _config(tmp_path, **THRESHOLDS)
    common = ["sweep", "--stage", "search", "--hmm-db", str(profile_dir / "100.hmm"), "--fasta",
              str(fasta), "--device", "cpu", "--config", str(cfg)]
    plain, ckpt = tmp_path / "plain.tsv", tmp_path / "ckpt.tsv"
    assert port_cli.main([*common, "--out", str(plain)]) == 0
    assert port_cli.main([*common, "--checkpoint", str(tmp_path / "c"), "--checkpoint-shard",
                          "2", "--out", str(ckpt)]) == 0
    assert ckpt.read_bytes() == plain.read_bytes()
    default = tmp_path / "default.tsv"
    assert port_cli.main([*common[:-2], "--out", str(default)]) == 0
    assert len(plain.read_text().splitlines()) > len(default.read_text().splitlines())


@pytest.mark.parametrize("command", ["scan", "sweep"])
def test_use_mesh_builds_the_mesh(profile_dir, fasta, tmp_path, caplog, command):
    """use_mesh with mesh_db 2 (mesh_sp 2: the db axis is what the scanner
    shards, as in the JAX package) shards the scan over two CPU ranks; the
    report is byte-equal to the run without a mesh."""
    cfg = _config(tmp_path, use_mesh=True, mesh_db=2, mesh_sp=2, **THRESHOLDS)
    plain_cfg = _config(tmp_path, "plain.json", **THRESHOLDS)
    target = ["--hmm"] if command == "scan" else ["--hmm-db"]
    base = [command, *target, str(profile_dir / "100.hmm"), "--fasta", str(fasta), "--device",
            "cpu", "--stage", "search"]
    mesh, plain = tmp_path / "mesh.tsv", tmp_path / "plain.tsv"
    with caplog.at_level(logging.INFO):
        assert port_cli.main([*base, "--config", str(cfg), "--out", str(mesh)]) == 0
    assert "mesh: {'db': 2, 'sp': 2}" in caplog.text
    assert port_cli.main([*base, "--config", str(plain_cfg), "--out", str(plain)]) == 0
    assert mesh.read_bytes() == plain.read_bytes()
    assert sum(r["hit"] == "1" for r in _rows(plain)) > 0


def test_unknown_config_key_exits_2(profile_dir, fasta, tmp_path, caplog):
    cfg = _config(tmp_path, msv_p=0.1, lchunk=64)
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta",
                              str(fasta), "--device", "cpu",
                              "--config", str(cfg)]) == 2
    assert "unknown config keys: ['lchunk']" in caplog.text


def test_tpu_knobs_warn_and_leave_the_report(profile_dir, fasta, tmp_path, caplog):
    """backend and l_chunk log one warning each and change nothing."""
    cfg = _config(tmp_path, backend="pallas", l_chunk=64, loader="python")
    common = ["scan", "--stage", "search", "--hmm", str(profile_dir / "100.hmm"), "--fasta",
              str(fasta), "--device", "cpu"]
    plain, knobs = tmp_path / "plain.tsv", tmp_path / "knobs.tsv"
    assert port_cli.main([*common, "--out", str(plain)]) == 0
    with caplog.at_level(logging.WARNING, logger=port_cli.__name__):
        assert port_cli.main([*common, "--config", str(cfg), "--out", str(knobs)]) == 0
    assert knobs.read_bytes() == plain.read_bytes()
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    for knob in ("backend", "l_chunk"):
        assert sum(f": {knob} is a knob of the TPU kernels" in m for m in warned) == 1
    assert not any("loader" in m for m in warned)
