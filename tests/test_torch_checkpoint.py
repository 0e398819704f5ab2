"""The PyTorch port's resumable sweeps on the CPU (the kernels' plain
versions): ``runtime.checkpoint.resumable_sweep`` and
``resumable_search_sweep`` against the one-shot sweep and search, the
shard-outer staging, a rerun that recomputes only the deleted chunks, the
manifest checks (a mismatch raises, a manifest without ``kind`` is an MSV
sweep's), and ``sweep --checkpoint`` resuming a directory the JAX CLI wrote.

MSV scores and the MSV report are equal bit for bit and byte for byte;
the resumed search report equals the port's one-shot report byte for byte
and the JAX CLI's within tests/test_torch_search.py's tolerances. Both
CLIs parse with ``--loader python``.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu_torch import MSVProfile, SearchPipeline, msv_oracle_batch, parse_hmm
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner
from hmm_fasta_viterbi_tpu_torch.runtime.checkpoint import (
    ScanCheckpoint, resumable_search_sweep, resumable_sweep,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores, and many
    threads a worker on such ops mostly wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class CountingScanner(MSVScanner):
    """Counts stage calls and the profiles each scan_many is asked for."""

    def __init__(self):
        super().__init__(device="cpu")
        self.stage_calls = 0
        self.scanned: list[str] = []

    def stage(self, *args, **kwargs):
        self.stage_calls += 1
        return super().stage(*args, **kwargs)

    def scan_many(self, profiles, staged, **kwargs):
        self.scanned.extend(p.name for p in profiles)
        return super().scan_many(profiles, staged, **kwargs)


class Boom:
    """A scanner (or pipeline) that must not be used: every chunk is on disk."""

    @property
    def scanner(self):
        return self

    def stage(self, *args, **kwargs):
        raise AssertionError("resume must not rescan")


@pytest.fixture(scope="module")
def hmms(profile_dir):
    return [parse_hmm(profile_dir / f"{s}.hmm") for s in ("100", "200", "300")]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 20, size=(9, 64)).astype(np.int32)
    lengths = rng.integers(1, 65, size=9).astype(np.int32)
    return tokens, lengths


def test_resumable_sweep_stages_each_shard_once_and_resumes(tmp_path, hmms, batch):
    """N profiles x S shards stage S times; the scores equal scan_many's
    and the oracle's bit for bit; a rerun after deleting one (profile,
    shard) chunk restages that shard only and rescans that profile only;
    a complete checkpoint resumes without scanning."""
    tokens, lengths = batch
    profiles = [MSVProfile.from_profile(h) for h in hmms]
    scanner = CountingScanner()
    ckpt = ScanCheckpoint(tmp_path / "ckpt")
    res = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)
    assert scanner.stage_calls == 3  # ceil(9 / 4) shards, once each
    one_shot = MSVScanner(device="cpu").scan_many(
        profiles, MSVScanner(device="cpu").stage(tokens, lengths))
    for p in profiles:
        np.testing.assert_array_equal(res[p.name], one_shot[p.name])
        np.testing.assert_array_equal(res[p.name], msv_oracle_batch(p, tokens, lengths))
    assert len(list(ckpt.directory.glob("*.npz"))) == 9

    ckpt._chunk_path(profiles[1].name, 1).unlink()
    scanner.stage_calls, scanner.scanned = 0, []
    again = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)
    assert scanner.stage_calls == 1 and scanner.scanned == [profiles[1].name]
    for p in profiles:
        np.testing.assert_array_equal(again[p.name], res[p.name])
    resumed = resumable_sweep(Boom(), profiles, tokens, lengths, ckpt, shard_size=4)
    for p in profiles:
        np.testing.assert_array_equal(resumed[p.name], res[p.name])


def test_resumable_search_sweep_equals_search(tmp_path, hmms, batch):
    """The checkpointed cascade equals the unsharded search field for field
    (loose thresholds, and the consensus of 100.hmm planted in shard 1, so
    that Forward runs); a rerun after deleting a chunk recomputes it only,
    and a complete one resumes without scanning."""
    consensus = np.argmax(hmms[0].match_emissions[1:], axis=1)
    tokens = np.zeros((9, consensus.size), dtype=np.int32)
    tokens[:, :64] = batch[0]
    tokens[5] = consensus
    lengths = batch[1].copy()
    lengths[5] = consensus.size
    pipeline = SearchPipeline(MSVScanner(device="cpu"), msv_p=0.9, viterbi_p=0.9,
                              forward_p=0.9)
    ckpt = ScanCheckpoint(tmp_path / "sckpt")
    res = resumable_search_sweep(pipeline, hmms, tokens, lengths, ckpt, shard_size=4)
    assert res[hmms[0].name].passed_forward[5]
    staged = pipeline.scanner.stage(tokens, lengths)
    for hmm in hmms:
        want = pipeline.search(hmm, staged, tokens, lengths)
        for field in want.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(res[hmm.name], field), getattr(want, field),
                                          err_msg=field)
    path = ckpt._chunk_path(hmms[2].name, 2)
    path.unlink()
    before = {p.name: os.stat(p).st_mtime_ns for p in ckpt.directory.glob("*.npz")}
    again = resumable_search_sweep(pipeline, hmms, tokens, lengths, ckpt, shard_size=4)
    assert path.exists()
    assert {p.name: os.stat(p).st_mtime_ns for p in ckpt.directory.glob("*.npz")
            if p != path} == before
    resumed = resumable_search_sweep(Boom(), hmms, tokens, lengths, ckpt, shard_size=4)
    for hmm in hmms:
        for field in ("msv_scores", "forward_scores", "passed_forward"):
            np.testing.assert_array_equal(getattr(again[hmm.name], field),
                                          getattr(res[hmm.name], field))
            np.testing.assert_array_equal(getattr(resumed[hmm.name], field),
                                          getattr(res[hmm.name], field))


def test_manifest_mismatch_raises_and_legacy_manifest_resumes(tmp_path, hmms, batch):
    """A checkpoint of another partition (shard size, kind) is refused; a
    manifest without 'kind' (written before the search sweep existed) is an
    MSV sweep's and resumes."""
    tokens, lengths = batch
    profiles = [MSVProfile.from_profile(hmms[0])]
    scanner = MSVScanner(device="cpu")
    ckpt = ScanCheckpoint(tmp_path / "ckpt")
    res = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)
    with pytest.raises(ValueError, match="different partition"):
        resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=3)
    with pytest.raises(ValueError, match="different partition"):
        resumable_search_sweep(SearchPipeline(scanner), hmms[:1], tokens, lengths, ckpt,
                               shard_size=4)
    manifest = ckpt.read_manifest()
    del manifest["kind"]
    ckpt.write_manifest(manifest)
    resumed = resumable_sweep(Boom(), profiles, tokens, lengths, ckpt, shard_size=4)
    np.testing.assert_array_equal(resumed[profiles[0].name], res[profiles[0].name])


@pytest.fixture(scope="module")
def sweep_dir(profile_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_hmms")
    for stem in ("100", "200"):
        (d / f"{stem}.hmm").write_bytes((profile_dir / f"{stem}.hmm").read_bytes())
    return d


@pytest.fixture(scope="module")
def ckpt_fasta(hmms, tmp_path_factory):
    """Nine random sequences with the consensus of 100.hmm at rows 2 and 7."""
    rng = np.random.default_rng(21)
    consensus = "".join(AMINO_ACIDS[t] for t in np.argmax(hmms[0].match_emissions[1:], axis=1))
    seqs = ["".join(AMINO_ACIDS[t] for t in rng.integers(0, 20, 50 + 20 * i)) for i in range(9)]
    seqs[2] = seqs[7] = consensus
    path = tmp_path_factory.mktemp("ckpt_fasta") / "db.fsa"
    path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    return path


def _close(a, b, rtol):
    if a is None or b is None:
        return a == b
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("stage", ["msv", "search"])
def test_cli_resumes_a_jax_checkpoint(sweep_dir, ckpt_fasta, tmp_path, stage, caplog):
    """sweep --checkpoint: the port resumes a directory the JAX CLI wrote
    (--backend xla) after one chunk is deleted, recomputing that chunk only
    (the log counts it). MSV: the report is byte-equal to the JAX CLI's and
    to the port's one-shot sweep. Search: the port's own checkpointed run
    and a resume of it after a deletion are byte-equal to its one-shot
    sweep; the resumed JAX directory gives the JAX report's rows, hit flags
    and MSV fields, the p-values within the search tests' tolerances."""
    common = ["sweep", "--hmm-dir", str(sweep_dir), "--fasta", str(ckpt_fasta), "--loader",
              "python", "--stage", stage, "--format", "json"]
    ckpt = ["--checkpoint-shard", "4"]
    jax_dir, port_dir = tmp_path / "jax_ckpt", tmp_path / "port_ckpt"
    jax_out, port_out, one_shot = tmp_path / "jax", tmp_path / "port", tmp_path / "one"
    assert jax_cli.main([*common, "--backend", "xla", "--checkpoint", str(jax_dir), *ckpt,
                         "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(one_shot)]) == 0
    assert len(list(jax_dir.glob("*.npz"))) == 6  # 2 profiles x ceil(9 / 4) shards
    (jax_dir / "Pfam-B_603.shard00001.npz").unlink()
    with caplog.at_level(logging.INFO, logger="hmm_fasta_viterbi_tpu_torch"):
        assert port_cli.main([*common, "--device", "cpu", "--checkpoint", str(jax_dir), *ckpt,
                              "--out", str(port_out)]) == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.endswith("3 shards x 2 profiles, 1 chunks computed, 5 read back")
               for m in msgs), msgs
    if stage == "msv":
        assert [m for m in msgs if m.startswith("checkpointed")] == [
            "checkpointed shard 2/3 (1 profiles)"]
        assert port_out.read_bytes() == jax_out.read_bytes() == one_shot.read_bytes()
        return
    assert [m for m in msgs if m.startswith("checkpointed")] == [
        "checkpointed search Pfam-B_603 shard 2/3"]
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert [(r["profile"], r["target"]) for r in got] == [(r["profile"], r["target"])
                                                          for r in want]
    assert any(r["hit"] for r in want)
    for g, w in zip(got, want):
        assert (g["hit"], g["msv_bits"], g["msv_p"]) == (w["hit"], w["msv_bits"], w["msv_p"])
        for key in ("viterbi_p", "forward_p", "evalue"):
            assert _close(g[key], w[key], 1e-2), (key, g, w)
    port_ckpt = [*common, "--device", "cpu", "--checkpoint", str(port_dir), *ckpt]
    assert port_cli.main([*port_ckpt, "--out", str(port_out)]) == 0
    assert port_out.read_bytes() == one_shot.read_bytes()
    for chunk in port_dir.glob("*.shard00002.npz"):
        chunk.unlink()
    assert port_cli.main([*port_ckpt, "--out", str(port_out)]) == 0
    assert port_out.read_bytes() == one_shot.read_bytes()


def test_cli_checkpoint_shard_must_be_positive(sweep_dir, ckpt_fasta, tmp_path, caplog):
    with caplog.at_level(logging.ERROR):
        assert port_cli.main(["sweep", "--hmm-dir", str(sweep_dir), "--fasta", str(ckpt_fasta),
                              "--device", "cpu", "--checkpoint", str(tmp_path / "c"),
                              "--checkpoint-shard", "0"]) == 2
    assert "--checkpoint-shard must be at least 1" in caplog.text
