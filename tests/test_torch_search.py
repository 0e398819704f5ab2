"""The PyTorch port's search cascade (MSV -> Viterbi -> Forward) and its
`scan --stage search|viterbi|forward` CLI, on the CPU (the kernels' plain
versions), against the JAX package's SearchPipeline and CLI on the XLA
backend; and the fast cascade (the MSV and Viterbi prefilters) against the
JAX fast cascade on its Pallas backend in interpret mode.

MSV scores are equal bit for bit; Viterbi scores agree within 1e-4 and
Forward scores within 2e-3 (the JAX XLA path runs log-space Forward); the
stage decisions (the passed_* sets) are the same. Against the Pallas
kernels the MSV and Viterbi scores (filter scores included) are equal bit
for bit (tolerance 0.0) and Forward within 2e-3. ``scan --stage search
--domains`` gives the JAX CLI's rows, envelopes and domain spans, domain
scores within 2e-3 nats and i-Evalues within 1e-2 relative. The port gets
its own copy of the JAX profile (convert.profile_hmm_from_jax).
"""

import copy
import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu import parse_fasta, parse_hmm
from hmm_fasta_viterbi_tpu.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu.ops.reference import viterbi_oracle_batch
from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner
from hmm_fasta_viterbi_tpu.pipeline import SearchPipeline as JaxPipeline
from hmm_fasta_viterbi_tpu_torch import P7Profile, SearchPipeline, convert
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import SEARCH_SPANS, MSVScanner, select_p7_fns

VIT_TOL = 1e-4
FWD_TOL = 2e-3


def _letters(tokens) -> str:
    return "".join(AMINO_ACIDS[int(t)] for t in tokens)


@pytest.fixture(scope="module")
def hmm100(profile_dir):
    return parse_hmm(profile_dir / "100.hmm")


@pytest.fixture(scope="module")
def search_fasta(hmm100, tmp_path_factory):
    """Random sequences, the consensus, homologs sampled from the profile
    and a consensus fragment inside random residues: sequences that stop at
    every stage of the cascade."""
    rng = np.random.default_rng(41)
    consensus = np.argmax(hmm100.match_emissions[1:], axis=1)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 120 + 7 * k)))
               for k in range(6)]
    records.insert(2, FastaRecord("consensus", _letters(consensus)))
    for k, seq in enumerate(sample_sequences(hmm100, 3, seed=5)):
        records.insert(4 + k, FastaRecord(f"homolog{k}", _letters(seq)))
    # short consensus pieces: some pass MSV only, some MSV and Viterbi only
    for start, stop in ((60, 76), (60, 80), (30, 46), (30, 48), (30, 50), (30, 62)):
        piece = [rng.integers(0, 20, 50), consensus[start:stop], rng.integers(0, 20, 40)]
        records.append(FastaRecord(f"fragment{start}_{stop}", _letters(np.concatenate(piece))))
    path = tmp_path_factory.mktemp("search") / "search.fsa"
    write_fasta(path, records)
    return path


def test_search_pipeline_matches_jax(hmm100, search_fasta):
    db = parse_fasta(search_fasta)
    tokens, lengths = db.encode()
    port_sc = MSVScanner(device="cpu")
    got = SearchPipeline(port_sc).search(convert.profile_hmm_from_jax(hmm100),
                                         port_sc.stage(tokens, lengths), tokens, lengths)
    jax_sc = JaxScanner(backend="xla")
    want = JaxPipeline(jax_sc).search(hmm100, jax_sc.stage(tokens, lengths), tokens, lengths)

    assert np.array_equal(got.msv_scores, want.msv_scores)
    for name in ("passed_msv", "passed_viterbi", "passed_forward"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(np.isnan(got.viterbi_scores), np.isnan(want.viterbi_scores))
    assert np.array_equal(np.isnan(got.forward_scores), np.isnan(want.forward_scores))
    np.testing.assert_allclose(got.viterbi_scores, want.viterbi_scores, atol=VIT_TOL, rtol=0)
    np.testing.assert_allclose(got.forward_scores, want.forward_scores, atol=FWD_TOL, rtol=0)
    # every stage both keeps and drops sequences on this batch
    assert (got.passed_forward.any() and (~got.passed_msv).any()
            and (got.passed_msv & ~got.passed_viterbi).any()
            and (got.passed_viterbi & ~got.passed_forward).any())
    names = [db.records[i].header for i in got.hits]
    assert "consensus" in names and "homolog0" in names


def test_search_stage_phases_and_derived_cache(hmm100, search_fasta):
    """The pipeline records each stage's seconds, and hands the scanner the
    same derived profiles on every call with one hmm (pinned LRU), so its
    pack cache does not grow per call."""
    tokens, lengths = parse_fasta(search_fasta).encode()
    hmm = convert.profile_hmm_from_jax(hmm100)
    sc = MSVScanner(device="cpu")
    pipeline = SearchPipeline(sc)
    staged = sc.stage(tokens, lengths)
    first = pipeline.search(hmm, staged, tokens, lengths)
    n_cached = len(sc._profile_cache)
    second = pipeline.search(hmm, staged, tokens, lengths)
    assert len(sc._profile_cache) == n_cached == 3  # msv, viterbi, forward
    assert np.array_equal(first.passed_forward, second.passed_forward)
    assert set(pipeline.phase_seconds) == set(SEARCH_SPANS)
    assert all(pipeline.phase_seconds[k] > 0 for k in ("msv", "viterbi", "forward"))
    assert pipeline._derived(hmm)[1] is pipeline._derived(hmm)[1]
    copies = [copy.copy(hmm) for _ in range(pipeline._DERIVED_MAX + 3)]
    for h in copies:
        pipeline._derived(h)
    assert len(pipeline._derived_cache) == pipeline._DERIVED_MAX
    assert id(copies[0]) not in pipeline._derived_cache  # evicted (LRU)


def test_scan_p7_picks_eager_without_e_skip_d(hmm100):
    """A profile with a positive tdd breaks e_skip_d_ok: scan_p7 then runs
    the eager scan (no lazy window) and still matches the oracle."""
    p7 = P7Profile.from_profile(convert.profile_hmm_from_jax(hmm100))
    bad = type(p7)(**{**p7.__dict__, "tdd": np.where(
        np.isfinite(p7.tdd), np.float32(0.01), p7.tdd).astype(np.float32)})
    assert not p7_cuda.e_skip_d_ok(bad) and p7_cuda.e_skip_d_ok(p7)
    sc = MSVScanner(device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 20, size=(4, 60)).astype(np.int32)
    lengths = np.array([60, 31, 0, 5], dtype=np.int32)
    staged = sc.stage(tokens, lengths)
    for prof, lazy in ((bad, False), (p7, True)):
        got = sc.scan_p7(prof, staged, stage="viterbi").numpy()
        assert bool(sc._p7_pack(prof, "viterbi").lazy_k) == lazy
        np.testing.assert_allclose(got, viterbi_oracle_batch(prof, tokens, lengths),
                                   atol=VIT_TOL, rtol=0)
    with pytest.raises(ValueError, match="stage"):
        sc.scan_p7(p7, staged, stage="msv")
    vit_fn, fwd_fn = select_p7_fns("cpu")
    assert torch.equal(vit_fn(p7, tokens, lengths), sc.scan_p7(p7, staged, "viterbi"))
    assert torch.equal(fwd_fn(p7, tokens, lengths), sc.scan_p7(p7, staged, "forward"))


def _rows(path, fmt):
    text = path.read_text()
    if fmt == "json":
        return json.loads(text)
    lines = text.splitlines()
    header = lines[0].lstrip("# ").split("\t")
    return [dict(zip(header, line.split("\t"))) for line in lines[1:]]


def _close(a, b, rtol):
    if a in (None, "nan") or b in (None, "nan"):
        return a == b
    return abs(float(a) - float(b)) <= rtol * abs(float(b))


@pytest.mark.parametrize("fmt", ["tsv", "json"])
@pytest.mark.parametrize("extra", [[], ["--top", "5"], ["--max-evalue", "1e-3"]],
                         ids=["all", "top", "evalue"])
def test_cli_search_matches_jax(profile_dir, search_fasta, tmp_path, fmt, extra):
    """Same rows in the same order, the same hit flags, equal msv_bits and
    msv_p, and Viterbi/Forward p- and E-values within what the score
    tolerances allow (a score error of d nats moves a p-value by a factor
    of about exp(lambda d))."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(search_fasta),
              "--loader", "python", "--stage", "search", "--format", fmt, *extra]
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want, got = _rows(jax_out, fmt), _rows(port_out, fmt)
    assert [r["target"] for r in got] == [r["target"] for r in want]
    assert want and any(str(r["hit"]) in ("1", "True") for r in want)
    for g, w in zip(got, want):
        assert str(g["hit"]) == str(w["hit"]) and g["profile"] == w["profile"]
        assert g["msv_bits"] == w["msv_bits"] and g["msv_p"] == w["msv_p"]
        assert _close(g["viterbi_p"], w["viterbi_p"], 1e-3)
        for key in ("forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)


@pytest.mark.parametrize("stage", ["viterbi", "forward"])
def test_cli_single_stage_matches_jax(profile_dir, search_fasta, tmp_path, stage):
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(search_fasta),
              "--loader", "python", "--stage", stage]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want, got = _rows(jax_out, "tsv"), _rows(port_out, "tsv")
    assert [r["target"] for r in got] == [r["target"] for r in want]
    tol = (VIT_TOL if stage == "viterbi" else FWD_TOL) + 1e-4  # 4-decimal rounding
    for g, w in zip(got, want):
        assert abs(float(g["score_nats"]) - float(w["score_nats"])) <= tol
        assert _close(g["pvalue"], w["pvalue"], 1e-2)


def test_cli_search_log_lines(profile_dir, search_fasta, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main(["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta",
                              str(search_fasta), "--stage", "search", "--device", "cpu",
                              "--out", str(tmp_path / "o.tsv")]) == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("search ") and "past MSV" in m and "past Viterbi" in m
               for m in msgs)
    phases = next(r for r in caplog.records if r.msg.startswith("seconds:"))
    parse_s, stage_s, msv_s, vit_s, fwd_s, dom_s, report_s, total_s = phases.args
    assert min(msv_s, vit_s, fwd_s) > 0 and total_s >= msv_s + vit_s + fwd_s
    assert dom_s == 0.0  # no --domains


def test_fast_cascade_matches_jax_pallas(hmm100, search_fasta):
    """SearchPipeline(fast_msv=True, fast_viterbi=True) on the CPU gives the
    JAX fast cascade's SearchResult (MSVScanner(backend="pallas",
    interpret=True, l_chunk=64)): MSV and Viterbi scores and p-values equal
    NaN-aware (tolerance 0.0; a filter-rejected row keeps the filter's
    score and p-value), Forward within 2e-3, the same passed_* sets. Its
    hits are the plain cascade's."""
    tokens, lengths = parse_fasta(search_fasta).encode()
    hmm = convert.profile_hmm_from_jax(hmm100)
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    got = SearchPipeline(sc, fast_msv=True, fast_viterbi=True).search(
        hmm, staged, tokens, lengths)
    jsc = JaxScanner(backend="pallas", interpret=True, l_chunk=64)
    want = JaxPipeline(jsc, fast_msv=True, fast_viterbi=True).search(
        hmm100, jsc.stage(tokens, lengths), tokens, lengths)
    for name in ("msv_scores", "msv_pvalues", "viterbi_scores", "viterbi_pvalues"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("passed_msv", "passed_viterbi", "passed_forward"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(np.isnan(got.forward_scores), np.isnan(want.forward_scores))
    np.testing.assert_allclose(got.forward_scores, want.forward_scores, atol=FWD_TOL, rtol=0)

    plain = SearchPipeline(sc).search(hmm, staged, tokens, lengths)
    assert got.hits.tolist() == plain.hits.tolist() and got.hits.size
    for name in ("passed_msv", "passed_viterbi", "passed_forward"):
        assert np.array_equal(getattr(got, name), getattr(plain, name)), name
    # the prefilters pass survivors the exact stages reject, and record
    # their filter scores there: rescored rows carry the plain cascade's
    # exact scores bit for bit
    rescored = ~np.isnan(plain.viterbi_scores) & got.passed_msv
    assert np.array_equal(got.msv_scores[got.passed_msv], plain.msv_scores[got.passed_msv])
    assert (got.msv_scores >= plain.msv_scores).all()
    vit_exact = got.passed_viterbi
    assert np.array_equal(got.viterbi_scores[vit_exact], plain.viterbi_scores[vit_exact])
    assert (got.viterbi_scores[rescored] >= plain.viterbi_scores[rescored]).all()
    # both prefilters reject rows here, which keep their filter scores
    assert (got.msv_scores > plain.msv_scores).any()
    assert (got.viterbi_scores[rescored] > plain.viterbi_scores[rescored]).any()


def test_fast_search_phases_and_caches(hmm100, search_fasta):
    """The prefilters' time counts into the msv and viterbi phases; the
    filter packs are cached beside the exact ones."""
    tokens, lengths = parse_fasta(search_fasta).encode()
    hmm = convert.profile_hmm_from_jax(hmm100)
    sc = MSVScanner(device="cpu")
    pipeline = SearchPipeline(sc, fast_msv=True, fast_viterbi=True)
    pipeline.search(hmm, sc.stage(tokens, lengths), tokens, lengths)
    assert set(pipeline.phase_seconds) == set(SEARCH_SPANS)
    assert all(pipeline.phase_seconds[k] > 0 for k in ("msv", "viterbi", "forward"))
    msv_profile, p7 = pipeline._derived(hmm)
    assert sc._cache_get((id(msv_profile), "filter"), msv_profile) is not None
    assert sc._cache_get((id(p7), "p7_filter", None), p7) is not None


@pytest.mark.parametrize("fmt", ["tsv", "json"])
def test_cli_scan_fast_same_hits(profile_dir, search_fasta, tmp_path, fmt):
    """scan --stage search --fast reports the plain search's hit set; the
    JAX CLI ignores --fast off its Pallas backend, so the hits (not the
    filter-scored rows) are what the two CLIs share."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(search_fasta),
              "--loader", "python", "--stage", "search", "--format", fmt]
    fast_out, plain_out, jax_out = (tmp_path / f"{n}.out" for n in ("fast", "plain", "jax"))
    assert port_cli.main([*common, "--fast", "--device", "cpu", "--out", str(fast_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(plain_out)]) == 0
    assert jax_cli.main([*common, "--fast", "--backend", "xla", "--out", str(jax_out)]) == 0

    def hits(path):
        return {r["target"] for r in _rows(path, fmt) if str(r["hit"]) in ("1", "True")}

    assert hits(fast_out) == hits(plain_out) == hits(jax_out) and hits(plain_out)


# -- scan --stage search --domains ---------------------------------------------

@pytest.fixture(scope="module")
def domains_fasta(hmm100, tmp_path_factory):
    """The consensus of 100.hmm, a junk sequence, and two consensus copies
    joined by junk (JAX test_backward_posterior.py's --domains fixtures)."""
    seq = _letters(np.argmax(hmm100.match_emissions[1:], axis=1))
    junk = "ACDEFGHIKLMNPQRSTVWY"
    path = tmp_path_factory.mktemp("domains") / "domains.fsa"
    path.write_text(f">consensus\n{seq}\n>junk\n{junk}\n>double\n{seq}{junk * 3}{seq}\n")
    return path


def _domain_fields(rows, fmt):
    """Per reported row: (target, hit, env_from, env_to, ndom, [(from, to,
    score_nats, ievalue or None)])."""
    out = []
    for r in rows:
        if fmt == "json":
            doms = [(d["env_from"], d["env_to"], d["score_nats"], d["ievalue"])
                    for d in r.get("domains", [])]
            out.append((r["target"], bool(r["hit"]), r.get("env_from"), r.get("env_to"),
                        r.get("ndom"), doms))
        else:
            doms = []
            for d in filter(None, r["dom_scores"].split(";")):
                span, score = d.split(":")
                f, t = span.split("-")
                doms.append((int(f), int(t), float(score), None))
            env = [int(r[k]) if r[k] else None for k in ("env_from", "env_to", "ndom")]
            out.append((r["target"], r["hit"] == "1", *env, doms))
    return out


def _same_domains(got, want):
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        assert [d[:2] for d in g[5]] == [d[:2] for d in w[5]], (g, w)
        for gd, wd in zip(g[5], w[5]):
            assert abs(gd[2] - wd[2]) <= FWD_TOL + 1e-4  # 4-decimal rounding
            if wd[3] is not None:
                assert _close(gd[3], wd[3], 1e-2), (gd, wd)


@pytest.mark.parametrize("fmt", ["tsv", "json"])
@pytest.mark.parametrize("which", ["domains", "search"])
def test_cli_search_domains_matches_jax(profile_dir, domains_fasta, search_fasta, tmp_path,
                                        which, fmt):
    """scan --stage search --domains on the CPU against the JAX CLI
    (--backend xla, the lax.scan decode): the same rows, hit flags,
    env_from/env_to/ndom and domain spans; domain scores within 2e-3 nats,
    i-Evalues within 1e-2 relative; the double consensus decodes as >= 2
    domains, each a strong match."""
    fasta = domains_fasta if which == "domains" else search_fasta
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta),
              "--loader", "python", "--stage", "search", "--domains", "--format", fmt]
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want = _domain_fields(_rows(jax_out, fmt), fmt)
    got = _domain_fields(_rows(port_out, fmt), fmt)
    _same_domains(got, want)
    hits = [g for g in got if g[1]]
    assert hits and all(g[4] >= 1 for g in hits)
    if which == "domains":
        double = next(g for g in got if g[0] == "double")
        assert double[4] >= 2 and all(d[2] > 0 for d in double[5])
        consensus = next(g for g in got if g[0] == "consensus")
        assert consensus[2] <= 5 and consensus[3] >= 95 and consensus[4] == 1


def test_cli_search_domains_matches_jax_pallas(profile_dir, domains_fasta, tmp_path, caplog):
    """The same against the JAX CLI on its Pallas backend (the two-pass
    Pallas posterior kernels in interpret mode); the seconds line carries
    the domains phase."""
    common = ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(domains_fasta),
              "--loader", "python", "--stage", "search", "--domains"]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main([*common, "--backend", "pallas", "--out", str(jax_out)]) == 0
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    _same_domains(_domain_fields(_rows(port_out, "tsv"), "tsv"),
                  _domain_fields(_rows(jax_out, "tsv"), "tsv"))
    phases = next(r for r in caplog.records if r.msg.startswith("seconds:"))
    parse_s, stage_s, msv_s, vit_s, fwd_s, dom_s, report_s, total_s = phases.args
    assert dom_s > 0 and total_s >= msv_s + vit_s + fwd_s + dom_s
