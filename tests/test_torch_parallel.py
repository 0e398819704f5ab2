"""The PyTorch port's device mesh on the CPU: meshes of repeated ``cpu``
ranks (the counterpart of the JAX suite's virtual 8-device CPU mesh) run
every db-sharded stage and the sp wavefront through the plain versions.

Mirrors tests/test_parallel.py. A score depends only on its own row and
the wavefront's block is a multiple of the Forward's rescale group, so
every sharded and wavefront scan is held bit for bit against the port's
single-device scan; against the JAX package (its XLA functions and NumPy
oracles on its 8 virtual devices) at the North star's tolerances (MSV
equal, Viterbi 1e-4, Forward 2e-3, posterior coverage 4e-3)."""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import parse_hmm as jax_parse_hmm
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile as JaxMSVProfile
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile as JaxP7Profile
from hmm_fasta_viterbi_tpu.ops.p7_scan import posterior_coverage_batch_xla
from hmm_fasta_viterbi_tpu.ops.reference import (
    forward_oracle_batch, msv_oracle_batch, viterbi_oracle_batch,
)
from hmm_fasta_viterbi_tpu.parallel import database as jax_database
from hmm_fasta_viterbi_tpu.parallel import mesh as jax_mesh
from hmm_fasta_viterbi_tpu.parallel import seqblocks as jax_seqblocks
from hmm_fasta_viterbi_tpu_torch import MSVProfile, MSVScanner, P7Profile, SearchPipeline
from hmm_fasta_viterbi_tpu_torch import parse_hmm
from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.ops.posterior_cuda import posterior_coverage_batch
from hmm_fasta_viterbi_tpu_torch.parallel.database import (
    ShardedDatabase, ShardedScanner, ShardedStager, msv_scan_sharded, pad_batch_to_mesh,
    top_k_hits,
)
from hmm_fasta_viterbi_tpu_torch.parallel.mesh import make_scan_mesh, shard_rows
from hmm_fasta_viterbi_tpu_torch.parallel.seqblocks import (
    BLOCK_GRANULE, SeqblockScanner, block_length, msv_scan_seqblocks, p7_scan_seqblocks,
)

from conftest import consensus_tokens

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8
VIT_TOL, FWD_TOL, COV_TOL = 1e-4, 2e-3, 4e-3


def cpu_mesh(db=None, sp=1):
    return make_scan_mesh(db=db, sp=sp, devices=CPU8)


@pytest.fixture(scope="module")
def hmm100(profile_dir):
    return parse_hmm(profile_dir / "100.hmm")


@pytest.fixture(scope="module")
def profile(hmm100):
    return MSVProfile.from_profile(hmm100)


@pytest.fixture(scope="module")
def jax_profile(profile_dir):
    return JaxMSVProfile.from_profile(jax_parse_hmm(profile_dir / "100.hmm"))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    lengths = np.array([64, 100, 1, 77, 128, 55, 9, 100, 31, 2], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 128)).astype(np.int32)
    return tokens, lengths


def single(profile, tokens, lengths) -> np.ndarray:
    scanner = MSVScanner(device="cpu")
    return scanner.scan(profile, scanner.stage(tokens, lengths)).numpy()


def test_database_sharded_scan(profile, jax_profile, batch):
    tokens, lengths = batch
    got = msv_scan_sharded(profile, tokens, lengths, cpu_mesh(db=8))
    want = msv_oracle_batch(jax_profile, tokens, lengths)
    np.testing.assert_array_equal(got, want)
    jax_got = jax_database.msv_scan_sharded(jax_profile, tokens, lengths,
                                            jax_mesh.make_scan_mesh(db=8, sp=1))
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, single(profile, tokens, lengths))


def test_pad_batch_to_mesh_and_shard_rows(batch):
    tokens, lengths = batch
    got = pad_batch_to_mesh(tokens, lengths, 8)
    want = jax_database.pad_batch_to_mesh(tokens, lengths, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (16,) and not got[1][10:].any() and got[2] == 10
    rows = shard_rows(10, 8)
    assert [r.stop - r.start for r in rows] == [1, 1, 1, 2, 1, 1, 1, 2]
    assert rows[0].start == 0 and rows[-1].stop == 10
    assert all(a.stop == b.start for a, b in zip(rows, rows[1:]))


def test_top_k(profile, batch):
    tokens, lengths = batch
    scores = msv_scan_sharded(profile, tokens, lengths, cpu_mesh(db=8))
    vals, idx = top_k_hits(scores, k=3)
    order = np.argsort(scores)[::-1][:3]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(), scores[order])
    jax_vals, jax_idx = jax_database.top_k_hits(jax.numpy.asarray(scores), k=3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_idx))


def _wavefront_vs_jax(profile, jax_profile, tokens, lengths, db, sp, **kw):
    got = msv_scan_seqblocks(profile, tokens, lengths, cpu_mesh(db=db, sp=sp), **kw)
    np.testing.assert_array_equal(got, single(profile, tokens, lengths))
    jax_got = jax_seqblocks.msv_scan_seqblocks(jax_profile, tokens, lengths,
                                               jax_mesh.make_scan_mesh(db=db, sp=sp))
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, msv_oracle_batch(jax_profile, tokens, lengths))


def test_seqblock_wavefront(profile, jax_profile, batch):
    """Residue blocks across 4 ranks x db across 2: the carry hand-off."""
    _wavefront_vs_jax(profile, jax_profile, *batch, db=2, sp=4)


def test_seqblock_pure_sp(profile, jax_profile, batch):
    """All 8 ranks on the sequence axis."""
    _wavefront_vs_jax(profile, jax_profile, *batch, db=1, sp=8)


def test_seqblock_long_sequence(profile, jax_profile):
    """One 4096-residue sequence split across 8 ranks."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 20, size=(1, 4096)).astype(np.int32)
    _wavefront_vs_jax(profile, jax_profile, tokens, np.array([4096], dtype=np.int32),
                      db=1, sp=8)


def test_seqblock_ragged_vs_block_boundaries(profile, jax_profile):
    """Rows that end on, just before and just after every block boundary
    (blocks of 32 over 4 ranks), and rows of 0 and 1 residues: a row ends
    in an earlier block and reaches the later ranks with length 0."""
    assert block_length(128, 4) == 32
    lengths = np.array([32, 31, 33, 64, 63, 65, 96, 95, 97, 128, 127, 1, 0], dtype=np.int32)
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, 20, size=(len(lengths), 128)).astype(np.int32)
    _wavefront_vs_jax(profile, jax_profile, tokens, lengths, db=1, sp=4)
    p7 = P7Profile.from_profile(parse_hmm(REPO_ROOT / "data" / "profile_HMMs" / "100.hmm"))
    one = MSVScanner(device="cpu")
    staged = one.stage(tokens, lengths)
    for stage in ("viterbi", "forward"):
        got = p7_scan_seqblocks(p7, tokens, lengths, cpu_mesh(db=1, sp=4), stage=stage,
                                group=3)
        np.testing.assert_array_equal(got, one.scan_p7(p7, staged, stage).numpy())


@pytest.mark.parametrize("group", [1, 2, 3, 8, None])
def test_seqblock_group_sizes(profile, batch, group):
    """Row groups of any size (the last one short) give the same scores."""
    tokens, lengths = batch
    got = msv_scan_seqblocks(profile, tokens, lengths, cpu_mesh(db=2, sp=4), group=group)
    np.testing.assert_array_equal(got, single(profile, tokens, lengths))


def _eager_profile(p7):
    """``p7`` with every finite tdd at 0.01: e_skip_d fails, the eager
    kernel runs."""
    bad = P7Profile(**{**p7.__dict__, "tdd": np.where(
        np.isfinite(p7.tdd), np.float32(0.01), p7.tdd).astype(np.float32)})
    assert not p7_cuda.e_skip_d_ok(bad)
    return bad


@pytest.mark.parametrize("stage", ["viterbi", "forward", "eager"])
def test_p7_seqblock_wavefront(profile_dir, stage):
    """The p7 stages over db = 2, sp = 4, rows crossing block boundaries:
    against JAX's oracles, and bit for bit the single-device scan (the lazy
    Viterbi; the eager one on a profile without e_skip_d; the Forward)."""
    p7 = P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    jax_p7 = JaxP7Profile.from_profile(jax_parse_hmm(profile_dir / "100.hmm"))
    rng = np.random.default_rng(29)
    lengths = np.array([300, 1, 170, 64, 299, 0, 96], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 300)).astype(np.int32)
    mesh = cpu_mesh(db=2, sp=4)
    one = MSVScanner(device="cpu")
    staged = one.stage(tokens, lengths)
    if stage == "eager":
        p7 = _eager_profile(p7)
        got = p7_scan_seqblocks(p7, tokens, lengths, mesh, stage="viterbi")
        np.testing.assert_array_equal(got, one.scan_p7(p7, staged, "viterbi").numpy())
        return
    got = p7_scan_seqblocks(p7, tokens, lengths, mesh, stage=stage)
    np.testing.assert_array_equal(got, one.scan_p7(p7, staged, stage).numpy())
    oracle = viterbi_oracle_batch if stage == "viterbi" else forward_oracle_batch
    want = oracle(jax_p7, tokens, lengths)
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite],
                               atol=VIT_TOL if stage == "viterbi" else FWD_TOL, rtol=0)
    assert np.all(np.isneginf(got[~finite]))


def test_forward_block_is_rescale_aligned():
    """Every block length is a multiple of the Forward's rescale group (and
    of JAX's 32-residue token group), so the rescale points of a block
    chain fall where one call puts them; and the blocks cover the row."""
    assert BLOCK_GRANULE % p7_cuda.FWD_RESCALE_GROUP == 0 and BLOCK_GRANULE % 32 == 0
    for seq_len in (0, 1, 7, 8, 31, 32, 33, 75, 80, 300, 1000, 4096, 10000):
        for sp in range(1, 9):
            blk = block_length(seq_len, sp)
            assert blk % p7_cuda.FWD_RESCALE_GROUP == 0 and blk % 32 == 0
            assert blk * sp >= seq_len and blk >= 1


def test_mesh_scanner_full_cascade_vs_oracle(profile_dir, batch):
    """A mesh scanner shards every stage over db = 8: MSV, its filter,
    Viterbi, its filter, Forward, each bit for bit the single-device
    scanner's, and against JAX's oracles."""
    tokens, lengths = batch
    hmm = parse_hmm(profile_dir / "100.hmm")
    jax_hmm = jax_parse_hmm(profile_dir / "100.hmm")
    msv, p7 = MSVProfile.from_profile(hmm), P7Profile.from_profile(hmm)
    sc = MSVScanner(mesh=cpu_mesh(db=8))
    one = MSVScanner(device="cpu")
    assert isinstance(sc, ShardedScanner) and isinstance(one, MSVScanner)
    staged, staged1 = sc.stage(tokens, lengths), one.stage(tokens, lengths)
    assert isinstance(staged, ShardedDatabase) and len(staged.shards) == 8
    assert len(sc.scanners) == 1  # eight shards on one device share its packs
    stages = {
        "msv": lambda s, x: s.scan(msv, x),
        "msv filter": lambda s, x: s.scan_filter(msv, x),
        "viterbi": lambda s, x: s.scan_p7(p7, x, stage="viterbi"),
        "viterbi filter": lambda s, x: s.scan_p7_filter(p7, x),
        "forward": lambda s, x: s.scan_p7(p7, x, stage="forward"),
    }
    got = {}
    for name, scan in stages.items():
        got[name] = scan(sc, staged).numpy()
        np.testing.assert_array_equal(got[name], scan(one, staged1).numpy(), err_msg=name)
    jax_msv, jax_p7 = JaxMSVProfile.from_profile(jax_hmm), JaxP7Profile.from_profile(jax_hmm)
    np.testing.assert_array_equal(got["msv"], msv_oracle_batch(jax_msv, tokens, lengths))
    assert np.all(got["msv filter"] >= got["msv"])
    np.testing.assert_allclose(got["viterbi"], viterbi_oracle_batch(jax_p7, tokens, lengths),
                               atol=VIT_TOL, rtol=0)
    assert np.all(got["viterbi filter"] >= got["viterbi"])
    np.testing.assert_allclose(got["forward"], forward_oracle_batch(jax_p7, tokens, lengths),
                               atol=FWD_TOL, rtol=0)


def test_mesh_scan_many_stacked(profile_dir, batch):
    """The stacked sweep on db = 8, exact and filter, plain and bucketed:
    each profile's scores the single-device sweep's, bit for bit."""
    tokens, lengths = batch
    profiles = [MSVProfile.from_profile(parse_hmm(profile_dir / f"{n}.hmm"))
                for n in (100, 200)]
    sc, one = MSVScanner(mesh=cpu_mesh(db=8)), MSVScanner(device="cpu")
    staged, staged1 = sc.stage(tokens, lengths), one.stage(tokens, lengths)
    bucketed, bucketed1 = sc.stage_bucketed(tokens, lengths), one.stage_bucketed(tokens, lengths)
    for mode in ("exact", "filter"):
        got = sc.scan_many(profiles, staged, mode=mode)
        want = one.scan_many(profiles, staged1, mode=mode)
        got_b = sc.scan_many_bucketed(profiles, bucketed, mode=mode)
        for p in profiles:
            np.testing.assert_array_equal(got[p.name], want[p.name])
            np.testing.assert_array_equal(got_b[p.name], want[p.name])
    exact = one.scan_many(profiles, staged1)
    jax_prof = JaxMSVProfile.from_profile(jax_parse_hmm(profile_dir / "200.hmm"))
    np.testing.assert_array_equal(exact[profiles[1].name],
                                  msv_oracle_batch(jax_prof, tokens, lengths))
    np.testing.assert_array_equal(sc.scan_bucketed(profiles[0], bucketed),
                                  exact[profiles[0].name])
    assert len(bucketed.buckets) == len(bucketed1.buckets)


def test_mesh_side_stream_stager(profile, batch):
    """A streamed batch staged onto the mesh (on the CPU: each shard by its
    device's side-stream stager, which stages it) scans as the single
    device does."""
    tokens, lengths = batch
    sc = MSVScanner(mesh=cpu_mesh(db=4))
    stager = ShardedStager(sc)
    staged = stager(tokens, lengths)
    assert stager.stream is None and stager.batches == 0
    assert isinstance(staged, ShardedDatabase) and len(staged.shards) == 4
    want = single(profile, tokens, lengths)
    np.testing.assert_array_equal(sc.scan(profile, staged).numpy(), want)
    # a device block staged a shard at a time (stage_device), one pad row
    # beyond the true size dropped
    block = torch.from_numpy(np.concatenate([tokens, tokens[:1]]).astype(np.int8))
    on_device = sc.stage_device(block, np.concatenate([lengths, lengths[:1]]),
                                num_sequences=len(lengths))
    np.testing.assert_array_equal(sc.scan(profile, on_device).numpy(), want)


def test_db_mesh_posterior_decode(profile_dir):
    """The --domains decode sharded over db = 8: bit for bit the
    single-device decode, and within 4e-3 of JAX's XLA decode."""
    p7 = P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    rng = np.random.default_rng(41)
    B, L = 5, 96
    tokens = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    lengths = np.array([L, 40, 1, 96, 64], dtype=np.int32)
    cov, tot = posterior_coverage_batch(p7, tokens, lengths, mesh=cpu_mesh(db=8))
    cov1, tot1 = posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    np.testing.assert_array_equal(cov, cov1)
    np.testing.assert_array_equal(tot, tot1)
    mask = posterior_coverage_batch(p7, tokens, lengths, mesh=cpu_mesh(db=3),
                                    mask_threshold=0.5)[0]
    np.testing.assert_array_equal(mask, (cov1 >= 0.5).astype(np.uint8))
    jax_p7 = JaxP7Profile.from_profile(jax_parse_hmm(profile_dir / "100.hmm"))
    cov_x, tot_x = posterior_coverage_batch_xla(jax_p7, tokens, lengths)
    lmin = min(cov.shape[1], cov_x.shape[1])
    np.testing.assert_allclose(cov[:, :lmin], np.asarray(cov_x)[:, :lmin], atol=COV_TOL, rtol=0)
    np.testing.assert_allclose(tot, tot_x, atol=FWD_TOL, rtol=0)


def _search_batch(hmm, seed, L, lengths):
    rng = np.random.default_rng(seed)
    hit = consensus_tokens(hmm)
    lengths = np.array([len(hit), *lengths], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), L)).astype(np.int32)
    tokens[0, : len(hit)] = hit
    return tokens, lengths


def _assert_same_result(got, want):
    for field in ("msv_scores", "msv_pvalues", "viterbi_scores", "viterbi_pvalues",
                  "forward_scores", "forward_pvalues", "passed_msv", "passed_viterbi",
                  "passed_forward"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)


def test_mesh_search_pipeline_matches_single_device(hmm100):
    """SearchPipeline over a db = 8 mesh scanner, plain and --fast: the
    single-device search's result, field for field (the consensus a hit)."""
    tokens, lengths = _search_batch(hmm100, 3, 160, [120, 160, 77, 1])
    sc, one = MSVScanner(mesh=cpu_mesh(db=8)), MSVScanner(device="cpu")
    for fast in (False, True):
        got = SearchPipeline(sc, fast_msv=fast, fast_viterbi=fast).search(
            hmm100, sc.stage(tokens, lengths), tokens, lengths)
        want = SearchPipeline(one, fast_msv=fast, fast_viterbi=fast).search(
            hmm100, one.stage(tokens, lengths), tokens, lengths)
        _assert_same_result(got, want)
        assert got.hits.tolist() == [0]


def test_sp_search_cascade_matches_single_device(hmm100):
    """The whole cascade through the wavefront (SeqblockScanner on db = 2,
    sp = 4): the single-device search's result, field for field."""
    tokens, lengths = _search_batch(hmm100, 37, 192, [50, 173, 192, 1, 128, 0])
    sb = SeqblockScanner(cpu_mesh(db=2, sp=4))
    got = SearchPipeline(sb).search(hmm100, sb.stage(tokens, lengths), tokens, lengths)
    one = MSVScanner(device="cpu")
    want = SearchPipeline(one).search(hmm100, one.stage(tokens, lengths), tokens, lengths)
    assert want.passed_forward[0] and got.passed_forward[0]
    _assert_same_result(got, want)
    many = sb.scan_many([MSVProfile.from_profile(hmm100)], sb.stage(tokens, lengths))
    np.testing.assert_array_equal(many[hmm100.name], want.msv_scores)


@pytest.mark.parametrize("kwargs", [dict(db=None, sp=3), dict(db=3, sp=3), dict(db=9),
                                    dict(db=None, sp=16), dict(db=4, sp=2), dict()])
def test_make_scan_mesh_errors(kwargs):
    """The JAX package's rules and messages, on 8 devices each side."""
    try:
        want = jax_mesh.make_scan_mesh(**kwargs)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            make_scan_mesh(**kwargs, devices=CPU8)
        assert str(got.value) == str(exc)
        return
    assert make_scan_mesh(**kwargs, devices=CPU8).shape == dict(want.shape)


def test_multihost_two_process_smoke():
    """torch.distributed over gloo: 2 processes x 4 cpu ranks run the
    db-sharded scan and the cross-process sp wavefront
    (tools/torch_multihost_smoke.py); a hung handshake is retried once."""
    script = REPO_ROOT / "tools" / "torch_multihost_smoke.py"
    env = {k: v for k, v in os.environ.items() if not k.startswith("MASTER_")}

    def attempt():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, str(script), str(i), "2", str(port)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                                  text=True, cwd=REPO_ROOT)
                 for i in range(2)]
        outs, ok = [], True
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n<timed out>")
                ok = False
        ok = ok and all(p.returncode == 0 for p in procs) and "MULTIHOST_OK" in outs[0]
        return ok, outs

    ok, outs = attempt()
    if not ok:
        ok, outs = attempt()
    assert ok, outs[0][-2000:] + outs[1][-2000:]


@pytest.mark.parametrize("cluster,grid,units", [(0, 132, 132), (4, 120, 30), (1, 64, 64)])
def test_p7_fill_counts_sequences_of_every_plan(monkeypatch, cluster, grid, units):
    """The wavefront's row-group fill on the card (``seqblocks._p7_fill``)
    is the sequences a launch of the plan runs at once: a block's for the
    wide block (``cluster`` 0), a cluster's for a cluster of wide blocks
    (one sequence a cluster of C blocks), a block's for the rows-in-memory
    case; the plan comes from ``p7_cuda.device_plan``, faked here."""
    from types import SimpleNamespace

    from hmm_fasta_viterbi_tpu_torch.parallel import seqblocks

    plan = p7_cuda.LaunchPlan(1, grid, 0, 0, 1, p7_cuda.BLOCK_THREADS, 0, cluster, 8)
    monkeypatch.setattr(p7_cuda, "device_plan", lambda *args, **kwargs: plan)
    assert seqblocks._p7_fill("eager", SimpleNamespace(m_pad=30184), 15, "cuda") == units
