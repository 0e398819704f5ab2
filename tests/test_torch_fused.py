"""The PyTorch port's fused cascade (`SearchPipeline(fused=True)`,
`scan --stage search --fused`) on the CPU, where every stage runs its
kernel's plain version.

Against the JAX package's fused cascade (`SearchPipeline(MSVScanner(
backend="pallas", interpret=True, l_chunk=64), fused=True)`) on the JAX
suite's own batches (tests/test_search_pipeline.py: the mixed batch, the
non-identity compaction lanes, the Forward threshold straddler): the same
stage decisions, MSV and Viterbi scores within 1e-4 (0.0 expected) and
Forward within 2e-3 nats (JAX's fused Forward runs at the database's
L_pad). Against the port's own cascades: the result of `fast_msv=
fast_viterbi=True` bit for bit, the plain cascade's hits. Capacity
overflow (JAX's 200-copy batch) runs the staged cascade at the caps JAX
computes, and says so; the compaction reads no device value on the host.
The CLI's `--fused` report is byte-equal to `--fast`'s and, streamed, to
the whole-file one, and agrees with the JAX CLI's `--fused --backend
pallas` report field by field. JAX's results are computed once a module.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu import parse_hmm
from hmm_fasta_viterbi_tpu.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner
from hmm_fasta_viterbi_tpu.pipeline import SearchPipeline as JaxPipeline
from hmm_fasta_viterbi_tpu_torch import MSVProfile, P7Profile, convert
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.models import stats
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda
from hmm_fasta_viterbi_tpu_torch.parallel.mesh import make_scan_mesh
from hmm_fasta_viterbi_tpu_torch.pipeline import (
    MSVScanner, SearchPipeline, SearchResult, _gather_rows, compact_rows, fused_caps,
)

SCORE_TOL, FWD_TOL = 1e-4, 2e-3
FIELDS = [f.name for f in dataclasses.fields(SearchResult)]
# the cases on the mixed batch whose forward_p straddles its consensus
# row's Forward p-value: at it (a decision may flip) and outside the band
STRADDLE = {"straddle": 1.0, "straddle_x2": 2.0, "straddle_x05": 0.5}
CASES = ["mixed", "lanes", *STRADDLE]
# forward_p 1: every row Forward scored passes, and no other (JAX's fused
# host decision also passes the rows Forward never reached: NaN counts as
# p = 1 there, so this case is the port's own)
EVERY_FORWARD = "forward_p_1"


def _consensus(hmm) -> np.ndarray:
    return np.argmax(hmm.match_emissions[1:], axis=1)


def _letters(tokens) -> str:
    return "".join(AMINO_ACIDS[int(t)] for t in tokens)


@pytest.fixture(scope="module")
def hmm100(profile_dir):
    return parse_hmm(profile_dir / "100.hmm")


@pytest.fixture(scope="module")
def port_hmm(hmm100):
    return convert.profile_hmm_from_jax(hmm100)


def _mixed_batch(hmm):
    """tests/test_search_pipeline.py::mixed_batch: four random rows and the
    consensus at row 2."""
    rng = np.random.default_rng(21)
    cons = _consensus(hmm)
    seq_len = max(len(cons), 120)
    tokens = rng.integers(0, 20, size=(5, seq_len)).astype(np.int32)
    lengths = np.full(5, seq_len, dtype=np.int32)
    tokens[2, : len(cons)] = cons
    lengths[2] = len(cons)
    return tokens, lengths


def _lanes_batch(hmm, port_hmm):
    """tests/test_search_pipeline.py::test_fused_cascade_non_identity_
    compaction's batch and cutoffs: lane 1 passes the MSV filter's cut but
    not the exact MSV's (a hole in the second compaction), lane 2 passes
    MSV and fails the Viterbi filter, lane 3 is the consensus. The cutoffs
    come from the port's plain versions, which equal the JAX Pallas
    kernels bit for bit."""
    cons = _consensus(hmm)
    weak, medium = cons.copy(), cons.copy()
    weak[::5] = (weak[::5] + 7) % 20
    medium[::11] = (medium[::11] + 7) % 20
    tokens = np.random.default_rng(3).integers(0, 20, size=(5, len(cons))).astype(np.int32)
    tokens[1], tokens[2], tokens[3] = weak, medium, cons
    lengths = np.full(5, len(cons), dtype=np.int32)
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    prof, p7 = MSVProfile.from_profile(port_hmm), P7Profile.from_profile(port_hmm)
    filt = sc.scan_filter(prof, staged).numpy()
    exact = sc.scan(prof, staged).numpy()
    assert filt[1] > exact[1] and exact[2] > filt[1] and exact[3] > filt[1]
    thr = (float(exact[1]) + float(filt[1])) / 2
    vf = sc.scan_p7_filter(p7, staged).numpy()
    vit = sc.scan_p7(p7, staged, stage="viterbi").numpy()
    assert vf[3] > vf[2]
    vthr = (float(max(vf[2], vit[2])) + float(min(vf[3], vit[3]))) / 2
    kw = {"msv_p": float(stats.msv_pvalue(np.array([thr]), port_hmm)[0]),
          "viterbi_p": float(stats.viterbi_pvalue(np.array([vthr]), port_hmm)[0])}
    assert 0.0 < kw["msv_p"] < 1.0 and 0.0 < kw["viterbi_p"] < 1.0
    return tokens, lengths, kw, vf


@pytest.fixture(scope="module")
def cases(hmm100, port_hmm):
    """{case: (tokens, lengths, pipeline cutoffs)}; and the lanes batch's
    Viterbi filter scores."""
    tokens, lengths = _mixed_batch(hmm100)
    sc = MSVScanner(device="cpu")
    base = SearchPipeline(sc, forward_p=1.0, fast_msv=True, fast_viterbi=True).search(
        port_hmm, sc.stage(tokens, lengths), tokens, lengths)
    pv = float(base.forward_pvalues[2])
    assert base.passed_forward[2] and 0.0 < pv < 1.0
    lanes_tokens, lanes_lengths, lanes_kw, lanes_vf = _lanes_batch(hmm100, port_hmm)
    out = {"mixed": (tokens, lengths, {}), "lanes": (lanes_tokens, lanes_lengths, lanes_kw)}
    for name, factor in STRADDLE.items():
        out[name] = (tokens, lengths, {"forward_p": pv * factor})
    out[EVERY_FORWARD] = (tokens, lengths, {"forward_p": 1.0})
    return out, lanes_vf


@pytest.fixture(scope="module")
def jax_fused(hmm100, cases):
    """JAX's fused SearchResult of every case, on one interpret-mode scanner
    (the batches share a shape: one compile)."""
    sc = JaxScanner(backend="pallas", interpret=True, l_chunk=64)
    out = {}
    for name in CASES:
        tokens, lengths, kw = cases[0][name]
        out[name] = JaxPipeline(sc, fused=True, **kw).search(
            hmm100, sc.stage(tokens, lengths), tokens, lengths)
    return out


def _port_search(port_hmm, tokens, lengths, **kw):
    """(result, pipeline) of the port's cascade on a fresh CPU scanner."""
    sc = MSVScanner(device="cpu")
    pipeline = SearchPipeline(sc, **kw)
    return pipeline.search(port_hmm, sc.stage(tokens, lengths), tokens, lengths), pipeline


def _assert_same(got, want) -> None:
    """Every field equal, NaN where NaN, of the same dtype."""
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_fused_matches_jax_fused(port_hmm, cases, jax_fused, case):
    """The port's fused SearchResult against JAX's: the passed_* sets equal
    (at the straddling forward_p, each side's Forward decision follows its
    own p-value), MSV and Viterbi scores and p-values within 1e-4, Forward
    within 2e-3 nats, NaN where JAX's is NaN."""
    tokens, lengths, kw = cases[0][case]
    got, pipeline = _port_search(port_hmm, tokens, lengths, fused=True, **kw)
    want = jax_fused[case]
    assert pipeline.fused_runs == 1
    assert want.passed_viterbi.any()
    names = ["passed_msv", "passed_viterbi"]
    if case == "straddle":
        for r in (got, want):
            assert np.array_equal(r.passed_forward,
                                  np.nan_to_num(r.forward_pvalues, nan=2.0) <= kw["forward_p"])
    else:
        names.append("passed_forward")
    for name in names:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    for name, tol in (("msv_scores", SCORE_TOL), ("viterbi_scores", SCORE_TOL),
                      ("forward_scores", FWD_TOL)):
        a, b = getattr(got, name), getattr(want, name)
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)
    for name in ("msv_pvalues", "viterbi_pvalues"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("case", [*CASES, EVERY_FORWARD])
def test_fused_equals_fast_and_plain_hits(port_hmm, cases, case):
    """On the plain versions the fused result is the fast cascade's bit for
    bit (the compacted rows score as the restaged ones), and its stage
    decisions are the plain cascade's; the whole search counts under msv."""
    tokens, lengths, kw = cases[0][case]
    got, pipeline = _port_search(port_hmm, tokens, lengths, fused=True, **kw)
    fast, _ = _port_search(port_hmm, tokens, lengths, fast_msv=True, fast_viterbi=True, **kw)
    plain, _ = _port_search(port_hmm, tokens, lengths, **kw)
    _assert_same(got, fast)
    for name in ("passed_msv", "passed_viterbi", "passed_forward"):
        assert np.array_equal(getattr(got, name), getattr(plain, name)), name
    assert pipeline.phase_seconds["msv"] > 0
    assert pipeline.phase_seconds["viterbi"] == pipeline.phase_seconds["forward"] == 0.0
    assert pipeline.phase_totals == pipeline.phase_seconds


def test_fused_non_identity_compaction(port_hmm, cases, jax_fused):
    """The compaction holes of the lanes batch: lane 1 fails the exact MSV,
    lane 2 fails the Viterbi filter and records its own filter score (the
    score JAX's vfilt mis-indexing once gave another lane), lane 3 is
    rescored exactly; equal to JAX's fused lanes."""
    tokens, lengths, kw = cases[0]["lanes"]
    got, _ = _port_search(port_hmm, tokens, lengths, fused=True, **kw)
    plain, _ = _port_search(port_hmm, tokens, lengths, **kw)
    assert not got.passed_msv[1]
    assert got.passed_msv[2] and not got.passed_viterbi[2]
    assert got.passed_msv[3] and got.passed_viterbi[3]
    assert got.viterbi_scores[2] == cases[1][2] == jax_fused["lanes"].viterbi_scores[2]
    assert got.viterbi_scores[3] == plain.viterbi_scores[3]


def test_fused_overflow_falls_back(hmm100, port_hmm, caplog):
    """JAX's overflow batch, 200 consensus copies: all pass MSV, cap1 is 128
    at B = 200 as in JAX, so the fused cascade says so and the staged one
    answers, the result equal to the same pipeline's without fused."""
    cons = _consensus(hmm100)
    tokens = np.tile(cons, (200, 1)).astype(np.int32)
    lengths = np.full(200, len(cons), dtype=np.int32)
    assert fused_caps(200, 0.02) == (128, 128, 128)
    with caplog.at_level(logging.INFO, logger="hmm_fasta_viterbi_tpu_torch.pipeline"):
        got, pipeline = _port_search(port_hmm, tokens, lengths, fused=True)
    assert ("fused cascade capacity overflow (n1=200 n2=128 n3=128) — falling back to the "
            "staged pipeline") in caplog.text
    assert pipeline.fused_runs == 0
    staged, _ = _port_search(port_hmm, tokens, lengths)
    _assert_same(got, staged)
    assert got.hits.size == 200


@pytest.mark.parametrize("b, msv_p, caps", [
    (0, 0.02, (128, 128, 128)), (5, 0.02, (128, 128, 128)), (200, 0.02, (128, 128, 128)),
    (1000, 0.05, (384, 256, 128)), (4096, 0.02, (640, 256, 128)),
    (16384, 0.02, (2048, 768, 128)), (16384, 0.5, (16384, 16384, 128)),
])
def test_fused_caps_are_jax_caps(b, msv_p, caps):
    """JAX's _search_fused capacities for B rows (its b_pad = B rounded up
    to 128), written out."""
    assert fused_caps(b, msv_p) == caps


def test_compact_rows_reads_no_device_value(monkeypatch):
    """compact_rows and the row gather read nothing back to the host: every
    synchronising read raises while they run. Survivors keep their order,
    the count includes those past the cap, empty slots are -1 and become
    rows of length 0."""

    def raises(*args, **kwargs):
        raise AssertionError("a device value was read on the host")

    alive = torch.tensor([False, True, True, False, True, True, False, True])
    sc = MSVScanner(device="cpu")
    tokens = np.random.default_rng(0).integers(0, 20, size=(8, 12)).astype(np.int32)
    staged = sc.stage(tokens, np.arange(3, 11, dtype=np.int32))
    with monkeypatch.context() as m:
        for name in ("item", "__int__", "__bool__", "__index__", "cpu", "tolist", "numpy",
                     "nonzero"):
            m.setattr(torch.Tensor, name, raises)
        m.setattr(torch, "nonzero", raises)
        capped, n_capped = compact_rows(alive, 3)
        wide, n_wide = compact_rows(alive, 7)
        none, n_none = compact_rows(torch.zeros(8, dtype=torch.bool), 2)
        sub = _gather_rows(staged, wide)
    assert capped.tolist() == [1, 2, 4] and int(n_capped) == 5
    assert wide.tolist() == [1, 2, 4, 5, 7, -1, -1] and int(n_wide) == 5
    assert none.tolist() == [-1, -1] and int(n_none) == 0
    assert capped.dtype == torch.int64 and n_capped.dim() == 0

    rows = [1, 2, 4, 5, 7]
    want = sc.stage(tokens[rows], np.arange(3, 11, dtype=np.int32)[rows])
    assert sub.num_sequences == 7
    assert torch.equal(sub.tokens[:5], want.tokens)
    assert torch.equal(sub.lengths[:5], want.lengths)
    assert torch.equal(sub.tr_rows[:, :5], want.tr_rows)
    assert torch.equal(sub.tr_probs[:, :5], want.tr_probs)
    assert sub.lengths[5:].tolist() == [0, 0]
    assert (sub.tokens[5:] == msv_cuda.PAD_TOKEN).all()
    assert sub.tr_rows[:, 5:].tolist() == [[float("-inf")] * 2, [0.0] * 2]
    assert sub.tr_probs[:, 5:].tolist() == [[0.0] * 2, [1.0] * 2]


def test_fused_on_a_db_mesh_runs_staged(port_hmm, cases, caplog):
    """A scanner sharded over a db mesh runs the staged cascade (as JAX's
    fused path does), logged, with the staged cascade's result."""
    tokens, lengths, _ = cases[0]["mixed"]
    sc = MSVScanner(mesh=make_scan_mesh(db=2, devices=[torch.device("cpu")] * 2))
    staged = sc.stage(tokens, lengths)
    pipeline = SearchPipeline(sc, fused=True)
    with caplog.at_level(logging.INFO, logger="hmm_fasta_viterbi_tpu_torch.pipeline"):
        got = pipeline.search(port_hmm, staged, tokens, lengths)
    assert "the scanner is sharded over a mesh, running the staged pipeline" in caplog.text
    assert pipeline.fused_runs == 0
    _assert_same(got, SearchPipeline(sc).search(port_hmm, staged, tokens, lengths))


# -- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def search_fasta(hmm100, tmp_path_factory):
    """Random rows, the consensus, homologs sampled from 100.hmm and
    consensus fragments in random residues (some pass MSV only, some MSV
    and Viterbi only): rows that stop at each stage, Forward scores far
    apart, fewer than 16 MSV survivors."""
    rng = np.random.default_rng(41)
    consensus = _consensus(hmm100)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 120 + 7 * k)))
               for k in range(5)]
    records.insert(2, FastaRecord("consensus", _letters(consensus)))
    for k, seq in enumerate(sample_sequences(hmm100, 3, seed=5)):
        records.insert(4 + k, FastaRecord(f"homolog{k}", _letters(seq)))
    for start, stop in ((60, 76), (60, 80), (30, 46), (30, 48), (30, 50), (30, 62)):
        piece = [rng.integers(0, 20, 50), consensus[start:stop], rng.integers(0, 20, 40)]
        records.append(FastaRecord(f"fragment{start}_{stop}", _letters(np.concatenate(piece))))
    path = tmp_path_factory.mktemp("fused") / "search.fsa"
    write_fasta(path, records)
    return path


def _scan(profile_dir, fasta, fmt="tsv"):
    return ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta), "--loader",
            "python", "--stage", "search", "--format", fmt]


@pytest.mark.parametrize("fmt", ["tsv", "json"])
def test_cli_fused_report_equals_fast(profile_dir, search_fasta, tmp_path, fmt, caplog):
    """`--fused` reports `--fast`'s report byte for byte; the search line
    says the fused cascade ran."""
    common = [*_scan(profile_dir, search_fasta, fmt), "--device", "cpu"]
    fused, fast = tmp_path / "fused.out", tmp_path / "fast.out"
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main([*common, "--fused", "--out", str(fused)]) == 0
    assert port_cli.main([*common, "--fast", "--out", str(fast)]) == 0
    assert fused.read_bytes() == fast.read_bytes()
    assert b"\t1\n" in fused.read_bytes() or b'"hit": true' in fused.read_bytes()
    line = next(r.getMessage() for r in caplog.records if r.getMessage().startswith("search "))
    assert line.startswith("search Pfam-B_229 (fused): 15 seqs -> ")


def test_cli_fused_stream_equals_whole_file(profile_dir, search_fasta, tmp_path, caplog):
    """`--fused --stream 4` runs the fused cascade on each batch and reports
    the whole-file `--fused` report byte for byte."""
    common = [*_scan(profile_dir, search_fasta), "--device", "cpu", "--fused"]
    whole, streamed = tmp_path / "whole.tsv", tmp_path / "stream.tsv"
    assert port_cli.main([*common, "--out", str(whole)]) == 0
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main([*common, "--stream", "4", "--out", str(streamed)]) == 0
    assert streamed.read_bytes() == whole.read_bytes()
    assert any(r.getMessage().endswith(", the fused cascade on 4 batches")
               for r in caplog.records)


def _forward_nats_apart(p, q, lam_bits: float) -> float:
    """How many nats apart the Forward scores of two p-values below 1 are
    (p = exp(-lambda (bits - tau)))."""
    return abs(np.log(p) - np.log(q)) / lam_bits * stats.LN2


def test_cli_fused_matches_jax_cli(profile_dir, search_fasta, port_hmm, tmp_path):
    """Against the JAX CLI's `--fused --backend pallas` (interpret mode),
    JSON field by field: the same rows in the same order, the same hits,
    msv_bits, msv_p and viterbi_p; the Forward p- and E-values those of
    Forward scores within 2e-3 nats."""
    common = _scan(profile_dir, search_fasta, "json")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_cli.main([*common, "--fused", "--backend", "pallas", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--fused", "--device", "cpu", "--out", str(port_out)]) == 0
    want, got = json.loads(jax_out.read_text()), json.loads(port_out.read_text())
    assert [r["target"] for r in got] == [r["target"] for r in want]
    assert sum(r["hit"] for r in want) >= 4
    lam = port_hmm.stats_local_forward_lambda
    for g, w in zip(got, want):
        for key in ("profile", "hit", "msv_bits", "msv_p", "viterbi_p"):
            assert g[key] == w[key], (key, g, w)
        for key in ("forward_p", "evalue"):
            assert (g[key] is None) == (w[key] is None), (key, g, w)
            if g[key] is not None:
                assert _forward_nats_apart(g[key], w[key], lam) <= FWD_TOL, (key, g, w)


@pytest.mark.parametrize("flags, message", [
    (["--bucketed"], "--fused does not compose with --bucketed"),
    (["--mesh", "db=1,sp=2"], "--fused does not compose with --mesh sp>1"),
])
def test_cli_fused_refusals(profile_dir, search_fasta, tmp_path, caplog, flags, message):
    """The JAX CLI's refusals: exit 2 with its message."""
    with caplog.at_level(logging.ERROR, logger=port_cli.__name__):
        assert port_cli.main([*_scan(profile_dir, search_fasta), "--device", "cpu", "--fused",
                              *flags, "--out", str(tmp_path / "o.tsv")]) == 2
    assert message in caplog.text


def test_cli_fused_db_mesh_runs_staged(profile_dir, search_fasta, tmp_path, caplog):
    """`--fused --mesh db=2` runs the staged cascade, says so, and reports
    the meshless staged search's report."""
    common = [*_scan(profile_dir, search_fasta), "--device", "cpu"]
    meshed, plain = tmp_path / "mesh.tsv", tmp_path / "plain.tsv"
    with caplog.at_level(logging.INFO):
        assert port_cli.main([*common, "--fused", "--mesh", "db=2", "--out", str(meshed)]) == 0
    assert port_cli.main([*common, "--out", str(plain)]) == 0
    assert "running the staged pipeline" in caplog.text
    assert meshed.read_bytes() == plain.read_bytes()
