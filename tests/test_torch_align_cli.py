"""The port's `scan --stage search --align`, `--msa-out` and `align` (--device
cpu) against the JAX CLI (--backend xla), both with `--loader python`.

The alignments are host NumPy tracebacks in both packages, so the
alignment blocks (TSV), the `alignments` of each JSON row, the `--msa-out`
file and every `align` report are byte-equal. The rows above the TSV blocks
carry Forward p- and E-values, which the port computes with its Forward
scan and the JAX XLA path with its own (2e-3 nats apart at most): they are
held as tests/test_torch_search.py holds them."""

import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu.ops import traceback as jax_tb
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch.io.msaio import read_msa
from hmm_fasta_viterbi_tpu_torch.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu_torch.ops import traceback as port_tb


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
def align_fasta(profile_dir, tmp_path_factory):
    """Random rows, the consensus of 100.hmm, two copies of it joined by
    junk, four sampled homologs and consensus fragments: hits with one and
    two domains, and rows the cascade stops at each stage."""
    hmm = parse_hmm(profile_dir / "100.hmm")
    rng = np.random.default_rng(23)
    consensus = np.argmax(hmm.match_emissions[1:], axis=1)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 90 + 11 * k)))
               for k in range(5)]
    records.insert(1, FastaRecord("consensus", _letters(consensus)))
    records.insert(3, FastaRecord(
        "double", _letters(np.concatenate([consensus, rng.integers(0, 20, 40), consensus]))))
    for k, seq in enumerate(sample_sequences(hmm, 4, seed=11)):
        records.append(FastaRecord(f"homolog{k}", _letters(seq)))
    for start, stop in ((20, 70), (30, 50)):
        piece = [rng.integers(0, 20, 35), consensus[start:stop], rng.integers(0, 20, 30)]
        records.append(FastaRecord(f"fragment{start}_{stop}", _letters(np.concatenate(piece))))
    path = tmp_path_factory.mktemp("align") / "align.fsa"
    write_fasta(path, records)
    return path


def _run_both(common, tmp_path, jax_extra=(), port_extra=()):
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--backend", "xla", *jax_extra, "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", *port_extra, "--out", str(port_out)]) == 0
    return jax_out.read_text(), port_out.read_text()


def _split(text, fmt):
    """(report rows as dicts, the alignment part): the TSV blocks after the
    rows, or each JSON row's (target, alignments)."""
    if fmt == "json":
        rows = json.loads(text)
        return rows, [(r["target"], r.get("alignments")) for r in rows]
    table, _, blocks = text.partition("\n\n== ")
    lines = table.splitlines()
    header = lines[0].lstrip("# ").split("\t")
    return [dict(zip(header, line.split("\t"))) for line in lines[1:]], blocks


def _close(a, b, rtol):
    if a in (None, "nan") or b in (None, "nan"):
        return a == b
    return abs(float(a) - float(b)) <= rtol * abs(float(b))


def _port_warned(caplog, text: str) -> bool:
    return any(r.name == port_cli.__name__ and r.levelno == logging.WARNING
               and text in r.getMessage() for r in caplog.records)


def _hit(row) -> bool:
    return str(row["hit"]) in ("1", "True")


def _same_rows(got, want):
    """tests/test_torch_search.py::test_cli_search_matches_jax's hold."""
    assert [r["target"] for r in got] == [r["target"] for r in want]
    for g, w in zip(got, want):
        assert str(g["hit"]) == str(w["hit"])
        assert g["msv_bits"] == w["msv_bits"] and g["msv_p"] == w["msv_p"]
        assert _close(g["viterbi_p"], w["viterbi_p"], 1e-3)
        for key in ("forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)


@pytest.mark.parametrize("route", [[], ["--bucketed"], ["--stream", "3"]],
                         ids=["whole", "bucketed", "stream"])
@pytest.mark.parametrize("fmt", ["tsv", "json"])
def test_scan_align_matches_jax(profile_dir, align_fasta, tmp_path, fmt, route):
    """scan --stage search --align: the alignment blocks byte-equal on every
    route that has the tokens (whole-file, --bucketed, --stream N: the
    streamed search keeps its survivors' tokens for --align); one block a
    domain of each hit, two for the two-copy row."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(align_fasta),
              "--loader", "python", "--stage", "search", "--align", "--format", fmt, *route]
    want_text, got_text = _run_both(common, tmp_path)
    want_rows, want_aln = _split(want_text, fmt)
    got_rows, got_aln = _split(got_text, fmt)
    _same_rows(got_rows, want_rows)
    assert got_aln == want_aln and want_aln
    if fmt == "json":
        hits = {r["target"]: r for r in got_rows if _hit(r)}
        assert len(hits) >= 6 and all(len(r["alignments"]) >= 1 for r in hits.values())
        assert len(hits["double"]["alignments"]) == 2
        assert all("alignments" not in r for r in got_rows if not _hit(r))
    else:
        assert got_text.count("\n== double domain ") == 2


@pytest.mark.parametrize("extra", [["--domains"], ["--fast"]], ids=["domains", "fast"])
def test_scan_align_with_domains_or_fast(profile_dir, align_fasta, tmp_path, extra):
    """--align beside --domains (the rows gain their envelopes) and --fast
    (the prefilters; the JAX CLI runs them on its Pallas backend only, so
    its report is the plain cascade's): the same hits, the alignment blocks
    byte-equal."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(align_fasta),
              "--loader", "python", "--stage", "search", "--align", *extra]
    want_text, got_text = _run_both(common, tmp_path)
    want_rows, want_aln = _split(want_text, "tsv")
    got_rows, got_aln = _split(got_text, "tsv")
    assert got_aln == want_aln and want_aln
    assert ({r["target"] for r in got_rows if _hit(r)}
            == {r["target"] for r in want_rows if _hit(r)})
    if extra == ["--domains"]:
        assert got_text.splitlines()[0].endswith("\tenv_from\tenv_to\tndom\tdom_scores")
        double = next(r for r in got_rows if r["target"] == "double")
        assert int(double["ndom"]) == 2


def test_scan_align_envelope_fallback(profile_dir, align_fasta, tmp_path, monkeypatch,
                                      caplog):
    """Past the traceback's DP budget, --align --domains aligns each posterior
    envelope of a hit instead of the whole row, in both CLIs alike; without
    --domains the over-budget hit keeps its row and loses its alignments,
    with a warning."""
    p7_rows = parse_hmm(profile_dir / "100.hmm").model_length
    # the two-copy row (240 residues) exceeds it; each copy fits
    budget = 3 * 8 * 160 * p7_rows / 2**30
    monkeypatch.setattr(jax_tb, "TRACEBACK_MAX_GIB", budget)
    monkeypatch.setattr(port_tb, "TRACEBACK_MAX_GIB", budget)
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(align_fasta),
              "--loader", "python", "--stage", "search", "--align", "--format", "json"]
    want_text, got_text = _run_both(common + ["--domains"], tmp_path)
    _, want_aln = _split(want_text, "json")
    rows, got_aln = _split(got_text, "json")
    assert got_aln == want_aln
    double = next(r for r in rows if r["target"] == "double")
    assert len(double["alignments"]) == 2 and double["alignments"][1]["seq_from"] > 100
    with caplog.at_level(logging.WARNING, logger=port_cli.__name__):
        want_text, got_text = _run_both(common, tmp_path)
    assert _port_warned(caplog, "alignment skipped for double")
    rows, got_aln = _split(got_text, "json")
    assert got_aln == _split(want_text, "json")[1]
    assert next(r for r in rows if r["target"] == "double")["alignments"] == []


@pytest.mark.parametrize("route", [[], ["--stream", "4"]], ids=["whole", "stream"])
def test_msa_out_byte_equal(profile_dir, align_fasta, tmp_path, route):
    """--msa-out: one Stockholm MSA of every hit domain, byte-equal to the
    JAX CLI's; it parses with the port's read_msa, a row a domain."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(align_fasta),
              "--loader", "python", "--stage", "search", "--align", *route]
    jax_msa, port_msa = tmp_path / "jax.sto", tmp_path / "port.sto"
    _, got_text = _run_both(common, tmp_path, ["--msa-out", str(jax_msa)],
                            ["--msa-out", str(port_msa)])
    assert port_msa.read_bytes() == jax_msa.read_bytes()
    names, rows, rf = read_msa(port_msa)
    assert len(rows) == got_text.count("\n== ") and rf is not None and len(rows) >= 7


def test_msa_out_needs_search_align(profile_dir, align_fasta, tmp_path, caplog):
    """--msa-out without --stage search --align exits 2 before any work."""
    base = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(align_fasta),
            "--device", "cpu", "--msa-out", str(tmp_path / "x.sto")]
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(base + ["--stage", "search"]) == 2
        assert port_cli.main(base + ["--align"]) == 2
    assert "--msa-out requires --stage search --align" in caplog.text
    assert not (tmp_path / "x.sto").exists()


@pytest.mark.parametrize("stream", [[], ["--stream", "2"]], ids=["whole", "stream"])
@pytest.mark.parametrize("fmt", ["tsv", "json", "stockholm"])
def test_align_byte_equal_to_jax(profile_dir, align_fasta, tmp_path, fmt, stream):
    """align: every sequence Viterbi-aligned to the profile, no cascade."""
    common = ["align", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(align_fasta),
              "--loader", "python", "--format", fmt, *stream]
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--out", str(port_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    text = port_out.read_text()
    if fmt == "json":
        assert len(json.loads(text)) == 13
    elif fmt == "stockholm":
        assert text.startswith("# STOCKHOLM 1.0") and text.count("double/") == 2
    else:
        assert text.count("== double domain ") == 2


def test_align_over_budget_warns_and_keeps_the_others(profile_dir, align_fasta, tmp_path,
                                                      monkeypatch, caplog):
    """A sequence past the traceback's DP budget is skipped with a warning
    (a null score in JSON) and every other sequence is still aligned, as in
    the JAX CLI."""
    long_fasta = tmp_path / "long.fsa"
    rng = np.random.default_rng(5)
    long_fasta.write_text(align_fasta.read_text()
                          + f">long\n{_letters(rng.integers(0, 20, 600))}\n")
    budget = 3 * 8 * 400 * parse_hmm(profile_dir / "100.hmm").model_length / 2**30
    monkeypatch.setattr(jax_tb, "TRACEBACK_MAX_GIB", budget)
    monkeypatch.setattr(port_tb, "TRACEBACK_MAX_GIB", budget)
    common = ["align", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(long_fasta),
              "--loader", "python", "--format", "json"]
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_cli.main([*common, "--out", str(jax_out)]) == 0
    with caplog.at_level(logging.WARNING):
        assert port_cli.main([*common, "--out", str(port_out)]) == 0
    assert _port_warned(caplog, "alignment skipped for long")
    assert port_out.read_bytes() == jax_out.read_bytes()
    rows = {r["target"]: r for r in json.loads(port_out.read_text())}
    assert rows["long"]["viterbi_nats"] is None and rows["long"]["alignments"] == []
    assert len(rows) == 14 and len(rows["consensus"]["alignments"]) == 1
