"""The PyTorch port's profile sweep on the CPU: the stacked MSV scan
(``MSVScanner.scan_many``, exact and filter modes) against the JAX Pallas
kernels in interpret mode, and the ``sweep`` CLI against the JAX CLI.

MSV scores are compared bit for bit (tolerance 0.0), so the sweep's MSV
reports are byte-equal to the JAX CLI's; the search sweep's Viterbi and
Forward fields agree within what tests/test_torch_search.py allows (the
JAX XLA path runs its own Viterbi and log-space Forward).
"""

import copy
import json
import logging

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu import parse_hmm
from hmm_fasta_viterbi_tpu.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile
from hmm_fasta_viterbi_tpu.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu.ops.pallas_msv import msv_pallas_stacked
from hmm_fasta_viterbi_tpu.ops.reference import msv_oracle_batch
from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import convert
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner

STEMS = ("100", "200", "1400")


def _ports(profiles) -> list:
    """The port's copies of JAX MSVProfiles."""
    return [convert.msv_profile_from_jax(p) for p in profiles]


def _letters(tokens) -> str:
    return "".join(AMINO_ACIDS[int(t)] for t in tokens)


@pytest.fixture(scope="module")
def profiles(profile_dir):
    return [MSVProfile.from_profile(parse_hmm(profile_dir / f"{s}.hmm")) for s in STEMS]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 20, size=(40, 300)).astype(np.int32)
    lengths = rng.integers(0, 301, size=40).astype(np.int32)
    lengths[:4] = [0, 1, 64, 300]
    return tokens, lengths


@pytest.fixture(scope="module")
def hmm_dir(profile_dir, tmp_path_factory):
    """A profile directory holding 100.hmm, 200.hmm and 1400.hmm."""
    d = tmp_path_factory.mktemp("sweep_dir")
    for stem in STEMS:
        (d / f"{stem}.hmm").write_bytes((profile_dir / f"{stem}.hmm").read_bytes())
    return d


@pytest.fixture(scope="module")
def hmm_db(profile_dir, tmp_path_factory):
    """The same three profiles as one concatenated //-separated file."""
    path = tmp_path_factory.mktemp("sweep_db") / "three.hmm"
    path.write_bytes(b"".join((profile_dir / f"{s}.hmm").read_bytes() for s in STEMS))
    return path


@pytest.fixture(scope="module")
def sweep_fasta(profile_dir, tmp_path_factory):
    """Random sequences and homologs of 100.hmm and 200.hmm: some pass
    every stage of the cascade for one profile and none for the other."""
    rng = np.random.default_rng(17)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 90 + 11 * k)))
               for k in range(5)]
    for stem in ("100", "200"):
        hmm = parse_hmm(profile_dir / f"{stem}.hmm")
        for k, seq in enumerate(sample_sequences(hmm, 2, seed=int(stem))):
            records.insert(2 * k + 1, FastaRecord(f"hom{stem}_{k}", _letters(seq)))
    path = tmp_path_factory.mktemp("sweep_fasta") / "sweep.fsa"
    write_fasta(path, records)
    return path


# -- the stacked scan ----------------------------------------------------------

def test_stacked_plain_matches_jax_interpret(profiles, batch):
    """scan_many (exact) on the CPU == msv_pallas_stacked(interpret=True) on
    a 100/200 stack, == the oracle on all three, bit for bit (tolerance
    0.0)."""
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    got = sc.scan_many(_ports(profiles), sc.stage(tokens, lengths))
    want = np.asarray(msv_pallas_stacked(profiles[:2], tokens, lengths, l_chunk=64,
                                         interpret=True))
    for k, p in enumerate(profiles[:2]):
        assert np.array_equal(got[p.name], want[k])
    for p in profiles:
        assert np.array_equal(got[p.name], msv_oracle_batch(p, tokens, lengths))


@pytest.mark.parametrize("mode", ["exact", "filter"])
def test_scan_many_matches_jax_pallas_scan_many(profiles, batch, mode):
    """The port's scan_many == the JAX scanner's scan_many on its Pallas
    backend in interpret mode (l_chunk 64), in both modes, bit for bit
    (tolerance 0.0); filter >= exact on every sequence."""
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    got = sc.scan_many(_ports(profiles), sc.stage(tokens, lengths), mode=mode)
    jsc = JaxScanner(backend="pallas", interpret=True, l_chunk=64)
    want = jsc.scan_many(profiles, jsc.stage(tokens, lengths), mode=mode)
    assert set(got) == set(want) == {p.name for p in profiles}
    for p in profiles:
        assert got[p.name].dtype == np.float32 and got[p.name].shape == (len(lengths),)
        assert np.array_equal(got[p.name], np.asarray(want[p.name])), p.name
        if mode == "filter":
            exact = msv_oracle_batch(p, tokens, lengths)
            assert np.all((got[p.name] >= exact) | np.isneginf(exact))


def test_scan_many_groups_cache_and_singles(profiles, profile_dir, batch):
    """On the CPU profiles group by padded width, which has no cap (on the
    card by the MSV kernel's case, where 1301 and 1400 share one and 100 and
    200 have one each); each group's stacked pack is cached, pinned on the
    very profile objects; every row equals the single-profile scan (scan /
    scan_filter) bit for bit."""
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    profs = _ports([*profiles, MSVProfile.from_profile(parse_hmm(profile_dir / "1301.hmm"))])
    pers = [msv_cuda.kernel_per(msv_cuda.round_up(p.num_states, 8)) for p in profs]
    assert len(set(pers)) == 3 and pers[2] == pers[3]
    widths = {msv_cuda.round_up(p.num_states, 8) for p in profs}
    assert len(widths) == 4
    for mode, single in (("exact", sc.scan), ("filter", sc.scan_filter)):
        res = sc.scan_many(profs, staged, mode=mode)
        for p in profs:
            assert torch.equal(torch.from_numpy(res[p.name]), single(p, staged))
    n = len(sc._profile_cache)
    assert n == 4 * 2 + 4 * 2  # 4 widths x 2 modes, 4 exact and 4 filter singles
    sc.scan_many(profs, staged)
    assert len(sc._profile_cache) == n  # cached
    again = [copy.copy(p) for p in profs]
    res = sc.scan_many(again, staged)
    assert len(sc._profile_cache) == n + 4  # new objects: new packs
    assert np.array_equal(res[profs[3].name], sc.scan(profs[3], staged).numpy())
    with pytest.raises(ValueError, match="mode"):
        sc.scan_many(profs, staged, mode="viterbi")


# -- the sweep CLI -------------------------------------------------------------

def _rows(path, fmt):
    text = path.read_text()
    if fmt == "json":
        return json.loads(text)
    lines = [line for line in text.splitlines() if not line.startswith("# target")]
    return [line.split("\t") for line in lines]


@pytest.mark.parametrize("fmt", ["tsv", "json"])
@pytest.mark.parametrize("source", ["dir", "db"])
@pytest.mark.parametrize("extra", [[], ["--top", "2"], ["--max-evalue", "3.5"]],
                         ids=["all", "top", "evalue"])
def test_cli_sweep_msv_byte_equal_to_jax(hmm_dir, hmm_db, fasta_dir, tmp_path, fmt, source,
                                         extra):
    """sweep --stage msv: the TSV and the one JSON document are byte-equal
    to the JAX CLI's (--backend xla) for --hmm-dir and --hmm-db."""
    src = ["--hmm-dir", str(hmm_dir)] if source == "dir" else ["--hmm-db", str(hmm_db)]
    common = ["sweep", *src, "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
              "--loader", "python", "--format", fmt, *extra]
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want = jax_out.read_bytes()
    assert port_out.read_bytes() == want
    if fmt == "json" and not extra:
        assert len({r["profile"] for r in json.loads(want)}) == 3


def _close(a, b, rtol):
    if a in (None, "nan") or b in (None, "nan"):
        return a == b
    return abs(float(a) - float(b)) <= rtol * abs(float(b))


@pytest.mark.parametrize("fmt", ["tsv", "json"])
def test_cli_sweep_search_matches_jax(hmm_dir, sweep_fasta, tmp_path, fmt):
    """sweep --stage search: the same rows per profile in the same order and
    the same hit flags as the JAX CLI (--backend xla); msv_bits and msv_p
    equal, Viterbi/Forward p- and E-values within the score tolerances."""
    common = ["sweep", "--loader", "python", "--hmm-dir", str(hmm_dir), "--fasta", str(sweep_fasta),
              "--stage", "search", "--format", fmt]
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want, got = _rows(jax_out, fmt), _rows(port_out, fmt)
    if fmt == "tsv":
        keys = ["target", "profile", "msv_bits", "msv_p", "viterbi_p", "forward_p", "evalue",
                "hit"]
        want = [dict(zip(keys, r)) for r in want]
        got = [dict(zip(keys, r)) for r in got]
    assert [(r["profile"], r["target"]) for r in got] == [(r["profile"], r["target"])
                                                          for r in want]
    assert any(str(r["hit"]) in ("1", "True") for r in want)
    for g, w in zip(got, want):
        assert str(g["hit"]) == str(w["hit"])
        assert g["msv_bits"] == w["msv_bits"] and g["msv_p"] == w["msv_p"]
        assert _close(g["viterbi_p"], w["viterbi_p"], 1e-3)
        for key in ("forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)


def test_cli_sweep_fast_same_hits(hmm_dir, sweep_fasta, tmp_path, caplog):
    """sweep --stage search --fast reports the same hits as the plain
    search sweep, logs one survivor line per profile and the seconds line."""
    base = ["sweep", "--hmm-dir", str(hmm_dir), "--fasta", str(sweep_fasta), "--stage",
            "search", "--device", "cpu"]
    plain_out, fast_out = tmp_path / "plain.tsv", tmp_path / "fast.tsv"
    assert port_cli.main([*base, "--out", str(plain_out)]) == 0
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main([*base, "--fast", "--out", str(fast_out)]) == 0

    def hits(path):
        return {(r[1], r[0]) for r in _rows(path, "tsv") if r[7] == "1"}

    assert hits(fast_out) == hits(plain_out) and hits(plain_out)
    # hits of both 100.hmm (Pfam-B_229) and 200.hmm (Pfam-B_603)
    assert {p for p, _ in hits(plain_out)} == {"Pfam-B_229", "Pfam-B_603"}
    msgs = [r.getMessage() for r in caplog.records]
    assert sum(m.startswith("search ") and "past Viterbi" in m for m in msgs) == 3
    seconds = next(r for r in caplog.records if r.msg.startswith("seconds:"))
    parse_s, stage_s, msv_s, vit_s, fwd_s, dom_s, report_s, total_s = seconds.args
    # the reports, written after each profile's cascade, are timed apart
    assert min(msv_s, vit_s, report_s) > 0 and dom_s == 0.0
    assert total_s >= parse_s + stage_s + msv_s + vit_s + fwd_s + report_s


def test_cli_sweep_usage_errors(hmm_dir, profile_dir, fasta_dir, tmp_path, caplog):
    """Exactly one of --hmm-dir / --hmm-db (else exit 2), duplicate profile
    names refused (exit 2), a missing directory exits 1."""
    fasta = ["--fasta", str(fasta_dir / "fasta_like_example.fsa"), "--device", "cpu"]
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(["sweep", *fasta]) == 2
        assert port_cli.main(["sweep", "--hmm-dir", str(hmm_dir), "--hmm-db",
                              str(profile_dir / "100.hmm"), *fasta]) == 2
        assert port_cli.main(["sweep", "--hmm-dir", str(tmp_path / "missing"), *fasta]) == 1
        dupes = tmp_path / "dupes.hmm"
        one = (profile_dir / "100.hmm").read_bytes()
        dupes.write_bytes(one + one)
        assert port_cli.main(["sweep", "--hmm-db", str(dupes), *fasta]) == 2
    assert "exactly one of --hmm-dir / --hmm-db" in caplog.text
    assert "duplicate profile NAME" in caplog.text


def test_cli_sweep_cuda_without_cuda_exits_2(hmm_dir, fasta_dir, monkeypatch, caplog):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(["sweep", "--hmm-dir", str(hmm_dir), "--fasta",
                              str(fasta_dir / "fasta_like_example.fsa")]) == 2
    assert "torch.cuda.is_available() is false" in caplog.text
