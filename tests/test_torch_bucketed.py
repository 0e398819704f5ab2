"""The PyTorch port's length-bucketed staging on the CPU (the kernels' plain
versions) against the JAX package's: ``MSVScanner.stage_bucketed``,
``scan_bucketed``, ``scan_many_bucketed`` and
``SearchPipeline.search_bucketed``, and ``scan``/``sweep --bucketed``.

The bucket partition (the ``order`` arrays) equals the JAX package's; the
port stages a bucket at its longest sequence where the JAX package rounds
to its 256-residue chunk, so ``padded_cells_saved`` is held to JAX's
partition measured at the port's widths. Bucketed MSV scores equal the
unbucketed scan, the stacked sweep and the oracle bit for bit; a bucketed
search equals the unbucketed one field for field; the ``--bucketed``
reports are byte-equal to the unbucketed ones and, for MSV, to the JAX
CLI's (the search report within tests/test_torch_search.py's
tolerances). Both CLIs parse with ``--loader python``.
"""

import json

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner
from hmm_fasta_viterbi_tpu_torch import (
    MSVProfile, SearchPipeline, msv_oracle_batch, parse_hmm,
)
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores, and many
    threads a worker on such ops mostly wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _skewed(seed: int, b: int, l_max: int):
    """A length-skewed batch: lengths from a lognormal (median 120, sigma
    1.0) clipped to 1..l_max, the way protein databases are skewed."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.round(rng.lognormal(np.log(120), 1.0, b)), 1, l_max).astype(np.int32)
    tokens = rng.integers(0, 20, size=(b, l_max)).astype(np.int32)
    return tokens, lengths


@pytest.fixture(scope="module")
def skewed():
    return _skewed(5, 48, 1500)


@pytest.fixture(scope="module")
def hmms(profile_dir):
    return [parse_hmm(profile_dir / f"{s}.hmm") for s in ("100", "200")]


def test_partition_equals_jax(skewed):
    """The bucket order arrays equal the JAX package's (its default l_chunk
    of 256 is the port's L_CHUNK); the saved fraction is JAX's partition
    at the port's staged widths, each bucket's longest sequence."""
    tokens, lengths = skewed
    port = MSVScanner(device="cpu").stage_bucketed(tokens, lengths)
    jax = JaxScanner(backend="xla").stage_bucketed(tokens, lengths)
    assert len(port.buckets) == len(jax.buckets) > 2
    for got, want in zip(port.order, jax.order):
        np.testing.assert_array_equal(got, want)
    widths = [max(int(lengths[idx].max()), 1) for idx in jax.order]
    assert [s.tokens.shape[1] for s in port.buckets] == widths
    single = max(widths) * len(lengths)
    want = 1.0 - sum(w * idx.size for w, idx in zip(widths, jax.order)) / single
    assert port.padded_cells_saved == pytest.approx(want, rel=1e-12)
    assert port.padded_cells_saved > 0.5 and jax.padded_cells_saved > 0.3
    assert sum(s.num_sequences for s in port.buckets) == port.num_sequences == len(lengths)


def test_scan_bucketed_and_stacked_equal_scan_and_oracle(skewed, hmms):
    """scan_bucketed == scan == the oracle (with mode="filter", ==
    scan_filter), and scan_many_bucketed == scan_many, bit for bit, in the
    original order."""
    tokens, lengths = skewed
    scanner = MSVScanner(device="cpu")
    bucketed = scanner.stage_bucketed(tokens, lengths)
    staged = scanner.stage(tokens, lengths)
    profiles = [MSVProfile.from_profile(h) for h in hmms]
    for p in profiles:
        got = scanner.scan_bucketed(p, bucketed)
        assert got.dtype == np.float32 and got.shape == (len(lengths),)
        np.testing.assert_array_equal(got, scanner.scan(p, staged).numpy())
        np.testing.assert_array_equal(got, msv_oracle_batch(p, tokens, lengths))
        np.testing.assert_array_equal(scanner.scan_bucketed(p, bucketed, mode="filter"),
                                      scanner.scan_filter(p, staged).numpy())
    for mode in ("exact", "filter"):
        got = scanner.scan_many_bucketed(profiles, bucketed, mode=mode)
        want = scanner.scan_many(profiles, staged, mode=mode)
        assert set(got) == set(want) == {p.name for p in profiles}
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
def test_search_bucketed_equals_search(hmms, fast):
    """search_bucketed gives search's SearchResult field for field (the
    fast cascade's MSV filter a bucket at a time), on a skewed batch with
    the consensus planted so that every stage has survivors."""
    tokens, lengths = _skewed(7, 40, 600)
    hmm = hmms[0]
    consensus = np.argmax(hmm.match_emissions[1:], axis=1)
    for row in (3, 17):
        tokens[row, : consensus.size] = consensus
        lengths[row] = consensus.size
    scanner = MSVScanner(device="cpu")
    pipeline = SearchPipeline(scanner, fast_msv=fast, fast_viterbi=fast)
    want = pipeline.search(hmm, scanner.stage(tokens, lengths), tokens, lengths)
    got = pipeline.search_bucketed(hmm, scanner.stage_bucketed(tokens, lengths), tokens,
                                   lengths)
    assert got.passed_forward[[3, 17]].all()
    for field in want.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert pipeline.phase_seconds["msv"] > 0


def test_single_bucket_and_empty(hmms):
    """Uniform lengths stage as one bucket and still round-trip; an empty
    batch has no bucket and scans to nothing."""
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 20, size=(5, 96)).astype(np.int32)
    lengths = np.full(5, 96, dtype=np.int32)
    scanner = MSVScanner(device="cpu")
    profile = MSVProfile.from_profile(hmms[0])
    one = scanner.stage_bucketed(tokens, lengths)
    assert len(one.buckets) == 1 and one.padded_cells_saved == 0.0
    np.testing.assert_array_equal(scanner.scan_bucketed(profile, one),
                                  msv_oracle_batch(profile, tokens, lengths))
    empty = scanner.stage_bucketed(np.zeros((0, 8), np.int32), np.zeros(0, np.int32))
    assert empty.buckets == [] and empty.padded_cells_saved == 0.0
    assert scanner.scan_bucketed(profile, empty).shape == (0,)
    assert scanner.scan_many_bucketed([profile], empty)[profile.name].shape == (0,)


@pytest.fixture(scope="module")
def ragged_fasta(hmms, tmp_path_factory):
    """Skewed random sequences with the consensus of 100.hmm planted twice."""
    tokens, lengths = _skewed(13, 24, 900)
    consensus = np.argmax(hmms[0].match_emissions[1:], axis=1)
    records = [FastaRecord(f"r{i}", "".join(AMINO_ACIDS[t] for t in tokens[i, : lengths[i]]))
               for i in range(len(lengths))]
    for k, at in enumerate((4, 15)):
        records.insert(at, FastaRecord(f"hit{k}", "".join(AMINO_ACIDS[t] for t in consensus)))
    path = tmp_path_factory.mktemp("bucketed") / "ragged.fsa"
    write_fasta(path, records)
    return path


@pytest.fixture(scope="module")
def hmm_dir(profile_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("bucketed_hmms")
    for stem in ("100", "200"):
        (d / f"{stem}.hmm").write_bytes((profile_dir / f"{stem}.hmm").read_bytes())
    return d


def _close(a, b, rtol):
    if a is None or b is None:
        return a == b
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("cmd", [
    ["scan", "--stage", "msv"], ["scan", "--stage", "search"],
    ["scan", "--stage", "search", "--fast"], ["sweep", "--stage", "msv"],
    ["sweep", "--stage", "search", "--fast"],
], ids=["scan-msv", "scan-search", "scan-fast", "sweep-msv", "sweep-fast"])
def test_cli_bucketed_equals_unbucketed_and_jax(profile_dir, hmm_dir, ragged_fasta, tmp_path,
                                                cmd, caplog):
    """--bucketed reports (JSON: full-precision p-values) are byte-equal to
    the unbucketed ones; the bucketed MSV reports are byte-equal to the
    JAX CLI's --bucketed (--backend xla), the bucketed search report has
    its rows, hit flags and MSV fields, and its Viterbi/Forward p-values
    within tests/test_torch_search.py's tolerances (JAX's XLA backend runs
    no prefilter, so --fast is held to the port's own unbucketed run)."""
    src = ["--hmm", str(profile_dir / "100.hmm")] if cmd[0] == "scan" else [
        "--hmm-dir", str(hmm_dir)]
    common = [*cmd, *src, "--fasta", str(ragged_fasta), "--loader", "python", "--format", "json"]
    whole, bucketed, jax_out = tmp_path / "whole", tmp_path / "bucketed", tmp_path / "jax"
    assert port_cli.main([*common, "--device", "cpu", "--out", str(whole)]) == 0
    with caplog.at_level("INFO", logger=port_cli.__name__):
        assert port_cli.main([*common, "--device", "cpu", "--bucketed", "--out",
                              str(bucketed)]) == 0
    assert bucketed.read_bytes() == whole.read_bytes()
    line = next(r.getMessage() for r in caplog.records
                if r.getMessage().startswith("bucketed staging:"))
    assert int(line.split()[2]) > 2 and "padded cells saved" in line
    if "--fast" in cmd:
        return
    assert jax_cli.main([*common, "--backend", "xla", "--bucketed", "--out", str(jax_out)]) == 0
    if cmd[-1] == "msv":
        assert bucketed.read_bytes() == jax_out.read_bytes()
        return
    got, want = json.loads(bucketed.read_text()), json.loads(jax_out.read_text())
    assert [r["target"] for r in got] == [r["target"] for r in want]
    assert any(r["hit"] for r in want)
    for g, w in zip(got, want):
        assert (g["hit"], g["msv_bits"], g["msv_p"]) == (w["hit"], w["msv_bits"], w["msv_p"])
        assert _close(g["viterbi_p"], w["viterbi_p"], 1e-3)
        for key in ("forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)
