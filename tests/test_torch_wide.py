"""Profiles wider than 2432 states on the CPU: the port's plain versions
against the JAX package's NumPy oracles and XLA path.

The two wide profiles are built as chip_smoke.py builds them
(``chip_smoke.join_profiles`` of WIDE_PAIRS: the nodes of 1400.hmm and
1301.hmm, LENG 2701; of 2405.hmm and 2365.hmm, LENG 4770), written to .hmm
files with the JAX package's writer and parsed by both packages. At B = 8
and L <= 64: the plain MSV equals ``msv_oracle_batch`` and ``msv_xla`` (1e-4,
0.0 expected), the eager and lazy Viterbi ``viterbi_xla`` (1e-4), Forward
``forward_xla`` (2e-3), the posterior decode ``posterior_coverage_batch_xla``
(coverage 4e-3, totals 2e-3); the plain Viterbi filter is >= ``viterbi_xla``
and equal to ``viterbi_filter_pallas(interpret=True)`` at L <= 16. The
scanner and the plain versions take M_pad past the register cases' 4864,
where the kernels' rows-in-memory cases take over: the three-profile join
of chip_smoke.py's MEM_JOINS (2405.hmm, 2365.hmm and 2207.hmm, LENG 6977)
through the plain MSV, Viterbi, Forward and posterior decode against the
JAX oracle and XLA path at the same tolerances, and the all-24 join (LENG
30181) through the plain MSV and the kernels' case and launch plan.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hmm_fasta_viterbi_tpu import parse_hmm as jax_parse_hmm
from hmm_fasta_viterbi_tpu.io.hmmwrite import write_hmm
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile as JaxMSVProfile
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile as JaxP7Profile
from hmm_fasta_viterbi_tpu.ops import pallas_p7
from hmm_fasta_viterbi_tpu.ops.p7_scan import (
    forward_xla, posterior_coverage_batch_xla, viterbi_xla,
)
from hmm_fasta_viterbi_tpu.ops.reference import msv_oracle_batch
from hmm_fasta_viterbi_tpu.ops.xla_scan import msv_xla
from hmm_fasta_viterbi_tpu_torch import MSVProfile, P7Profile, parse_hmm
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda, p7_cuda, posterior_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import (
    MSVScanner, forward_scores, viterbi_filter_scores, viterbi_scores,
)

B, L = 8, 64
MSV_TOL, VIT_TOL, FWD_TOL, COV_TOL, TOT_TOL = 1e-4, 1e-4, 2e-3, 4e-3, 2e-3



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The plain versions at M_pad up to 4872 on two threads: the suite runs
    files side by side, where more threads a worker only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def wide_files(profile_dir, tmp_path_factory):
    """{pair: (path, JAX ProfileHMM)}: each wide profile joined from the
    repo's JAX-parsed profiles and written with the JAX writer."""
    out_dir = tmp_path_factory.mktemp("wide")
    out = {}
    for pair in chip_smoke.WIDE_PAIRS:
        hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in pair))
        path = out_dir / f"wide_{'_'.join(pair)}.hmm"
        write_hmm(hmm, path)
        out[pair] = (path, jax_parse_hmm(path))
    return out


@pytest.fixture(scope="module")
def mem_files(profile_dir, tmp_path_factory):
    """{stems: (path, JAX ProfileHMM)}: each join of MEM_JOINS written with
    the JAX writer."""
    out_dir = tmp_path_factory.mktemp("mem")
    out = {}
    for stems in chip_smoke.MEM_JOINS:
        hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
        path = out_dir / f"mem_{len(stems)}.hmm"
        write_hmm(hmm, path)
        out[stems] = (path, jax_parse_hmm(path))
    return out


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(61)
    lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    lengths[:3] = [0, 1, L]
    return rng.integers(0, 20, size=(B, L)).astype(np.int32), lengths


def _max_d(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    same = a == b  # equal infinities count as 0
    return 0.0 if same.all() else float(np.abs(a[~same] - b[~same]).max())


@pytest.mark.parametrize("pair", chip_smoke.WIDE_PAIRS, ids="+".join)
def test_wide_profile_round_trip(wide_files, pair):
    """The joined profile, written by the JAX writer, parses to the same
    arrays in both packages, as chip_smoke.py builds it from the port's
    parser; LENG 2701 / 4770, the kernels' wide cases."""
    path, jax_hmm = wide_files[pair]
    port = parse_hmm(path)
    built = chip_smoke.wide_profile(pair)
    assert port.leng == jax_hmm.leng == built.leng == {("1400", "1301"): 2701,
                                                       ("2405", "2365"): 4770}[pair]
    for field in ("match_emissions", "insert_emissions", "transitions"):
        assert np.array_equal(getattr(port, field), getattr(jax_hmm, field))
        assert np.array_equal(getattr(built, field), getattr(port, field))
    m_pad = msv_cuda.round_up(port.leng, 8)
    assert msv_cuda.kernel_case(m_pad)[0] == 64
    assert p7_cuda.kernel_case(m_pad)[0] == p7_cuda.WIDE_THREADS


@pytest.mark.parametrize("pair", chip_smoke.WIDE_PAIRS, ids="+".join)
def test_wide_plain_msv_matches_jax(wide_files, profile_dir, batch, pair):
    """The scanner's plain MSV, exact and filter, and the stacked sweep with
    100.hmm: exact == msv_oracle_batch and msv_xla bit for bit, the filter
    >= exact, each stacked row == its single scan."""
    path, jax_hmm = wide_files[pair]
    tokens, lengths = batch
    prof = MSVProfile.from_profile(parse_hmm(path))
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    got = sc.scan(prof, staged).numpy()
    jprof = JaxMSVProfile.from_profile(jax_hmm)
    assert _max_d(got, msv_oracle_batch(jprof, tokens, lengths)) <= MSV_TOL
    assert np.array_equal(got, msv_oracle_batch(jprof, tokens, lengths))
    assert _max_d(got, np.asarray(msv_xla(jprof, tokens, lengths))) <= MSV_TOL
    filt = sc.scan_filter(prof, staged).numpy()
    assert np.all((filt >= got) | np.isneginf(got))
    small = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    for mode, single in (("exact", got), ("filter", filt)):
        res = sc.scan_many([small, prof], staged, mode=mode)
        assert np.array_equal(res[prof.name], single)
        assert np.array_equal(res[small.name], msv_oracle_batch(
            JaxMSVProfile.from_profile(jax_parse_hmm(profile_dir / "100.hmm")), tokens, lengths)
            if mode == "exact" else sc.scan_filter(small, staged).numpy())


@pytest.mark.parametrize("pair", chip_smoke.WIDE_PAIRS, ids="+".join)
def test_wide_plain_p7_matches_jax(wide_files, batch, pair):
    """The plain eager and lazy Viterbi == viterbi_xla within 1e-4 (and each
    other bit for bit), Forward == forward_xla within 2e-3."""
    path, jax_hmm = wide_files[pair]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    jp7 = JaxP7Profile.from_profile(jax_hmm)
    eager = viterbi_scores(p7, tokens, lengths, device="cpu", lazy=False).numpy()
    lazy = viterbi_scores(p7, tokens, lengths, device="cpu").numpy()
    assert np.array_equal(eager, lazy)
    assert _max_d(eager, np.asarray(viterbi_xla(jp7, tokens, lengths))) <= VIT_TOL
    fwd = forward_scores(p7, tokens, lengths, device="cpu").numpy()
    assert _max_d(fwd, np.asarray(forward_xla(jp7, tokens, lengths))) <= FWD_TOL


def test_wide_plain_posterior_matches_jax(wide_files, batch):
    """The plain posterior decode at LENG 4770 against the JAX XLA decode:
    coverage within 4e-3, totals within 2e-3 (an empty sequence: coverage
    0)."""
    path, jax_hmm = wide_files[("2405", "2365")]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    cov, tot = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    want_cov, want_tot = posterior_coverage_batch_xla(JaxP7Profile.from_profile(jax_hmm),
                                                      tokens, lengths)
    live = lengths > 0  # the JAX decode of an empty sequence is NaN
    assert not cov[~live].any()
    assert _max_d(cov[live], np.asarray(want_cov)[live, : cov.shape[1]]) <= COV_TOL
    assert _max_d(tot[live], np.asarray(want_tot)[live]) <= TOT_TOL


def test_wide_plain_filter_bounds_viterbi(wide_files, batch):
    """At LENG 4770 the plain Viterbi filter is >= viterbi_xla on every
    sequence, and equal to viterbi_filter_pallas(interpret=True) bit for
    bit on the first 16 residues."""
    path, jax_hmm = wide_files[("2405", "2365")]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    jp7 = JaxP7Profile.from_profile(jax_hmm)
    filt = viterbi_filter_scores(p7, tokens, lengths, device="cpu").numpy()
    exact = np.asarray(viterbi_xla(jp7, tokens, lengths))
    assert np.all((filt >= exact - 1e-4) | np.isneginf(exact))
    short = np.minimum(lengths, 16)
    got = viterbi_filter_scores(p7, tokens[:, :16], short, device="cpu").numpy()
    want = np.asarray(pallas_p7.viterbi_filter_pallas(jp7, tokens[:, :16], short, l_chunk=16,
                                                      interpret=True))
    assert np.array_equal(got, want)


def test_plain_versions_take_any_width(wide_files, profile_dir, batch):
    """Past the register cases' 4864 states the kernels' cases and launch
    plan pick the rows-in-memory case, and past 65536 the p7 case, plan and
    the posterior launch raise, naming that limit, while the scanner and the
    plain versions scan: a profile of 4870 states (M_pad 4872; the LENG 4770
    one joined with 100.hmm) through MSV, the sweep and Viterbi on the CPU,
    MSV equal to the JAX oracle."""
    tokens, lengths = batch
    hmm = chip_smoke.join_profiles(jax_parse_hmm(wide_files[("2405", "2365")][0]),
                                   jax_parse_hmm(profile_dir / "100.hmm"))
    assert hmm.leng == 4870
    m_pad = msv_cuda.round_up(hmm.leng, 8)
    assert msv_cuda.kernel_case(m_pad) == (msv_cuda.MEM_LANES, 5)
    assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, 5) and p7_cuda.kernel_per(m_pad) == 5
    plan = p7_cuda.plan_launch("forward", m_pad, 4, B, 128, 132)
    assert (plan.threads, plan.groups, plan.grid, plan.smem) == (p7_cuda.MEM_THREADS, 1, B, 0)
    too_wide = p7_cuda.MAX_KERNEL_STATES + 8
    for fn in (p7_cuda.kernel_case, p7_cuda.kernel_per):
        with pytest.raises(ValueError, match="65536"):
            fn(too_wide)
    with pytest.raises(ValueError, match="65536"):
        p7_cuda.plan_launch("forward", too_wide, 4, B, 128, 132)
    with pytest.raises(ValueError, match="65536"):  # the posterior launch's check
        posterior_cuda.backward_coverage_scan_cuda(
            torch.zeros((20, too_wide)), None, None, None, torch.zeros((B, L), dtype=torch.int8),
            None, None, None, None, None, None)
    path = wide_files[("2405", "2365")][0].parent / "w4870.hmm"
    write_hmm(hmm, path)
    prof = MSVProfile.from_profile(parse_hmm(path))
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    got = sc.scan(prof, staged).numpy()
    assert np.array_equal(got, msv_oracle_batch(JaxMSVProfile.from_profile(hmm), tokens,
                                                lengths))
    assert np.array_equal(sc.scan_many([prof], staged)[prof.name], got)
    vit = viterbi_scores(P7Profile.from_profile(parse_hmm(path)), tokens, lengths, device="cpu")
    assert torch.isfinite(vit[torch.from_numpy(lengths > 0)]).all()


@pytest.mark.parametrize("stems", chip_smoke.MEM_JOINS, ids=lambda s: f"{len(s)}-profile")
def test_mem_join_round_trip(mem_files, stems):
    """The joins past 4864 states, written by the JAX writer, parse to the
    same arrays in both packages and as chip_smoke.py builds them; both
    select the kernels' rows-in-memory cases."""
    path, jax_hmm = mem_files[stems]
    port = parse_hmm(path)
    built = chip_smoke.wide_profile(stems)
    assert port.leng == jax_hmm.leng == built.leng == {3: 6977, 24: 30181}[len(stems)]
    for field in ("match_emissions", "insert_emissions", "transitions"):
        assert np.array_equal(getattr(port, field), getattr(jax_hmm, field))
        assert np.array_equal(getattr(built, field), getattr(port, field))
    m_pad = msv_cuda.round_up(port.leng, 8)
    assert msv_cuda.kernel_case(m_pad)[0] == msv_cuda.MEM_LANES
    assert p7_cuda.kernel_case(m_pad)[0] == p7_cuda.MEM_THREADS


@pytest.mark.parametrize("stems", chip_smoke.MEM_JOINS, ids=lambda s: f"{len(s)}-profile")
def test_mem_join_plain_msv_matches_jax(mem_files, batch, stems):
    """The scanner's plain MSV at LENG 6977 and 30181: exact ==
    msv_oracle_batch bit for bit and msv_xla within 1e-4, the filter >=
    exact, the sweep's row == the single scan."""
    path, jax_hmm = mem_files[stems]
    tokens, lengths = batch
    prof = MSVProfile.from_profile(parse_hmm(path))
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    got = sc.scan(prof, staged).numpy()
    jprof = JaxMSVProfile.from_profile(jax_hmm)
    assert np.array_equal(got, msv_oracle_batch(jprof, tokens, lengths))
    assert _max_d(got, np.asarray(msv_xla(jprof, tokens, lengths))) <= MSV_TOL
    filt = sc.scan_filter(prof, staged).numpy()
    assert np.all((filt >= got) | np.isneginf(got))
    assert np.array_equal(sc.scan_many([prof], staged)[prof.name], got)


def test_mem_join_plain_p7_matches_jax(mem_files, batch):
    """At LENG 6977 the plain eager and lazy Viterbi == viterbi_xla within
    1e-4 (and each other bit for bit), Forward == forward_xla within 2e-3,
    the Viterbi filter >= viterbi_xla."""
    path, jax_hmm = mem_files[chip_smoke.MEM_JOINS[0]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    jp7 = JaxP7Profile.from_profile(jax_hmm)
    eager = viterbi_scores(p7, tokens, lengths, device="cpu", lazy=False).numpy()
    lazy = viterbi_scores(p7, tokens, lengths, device="cpu").numpy()
    assert np.array_equal(eager, lazy)
    exact = np.asarray(viterbi_xla(jp7, tokens, lengths))
    assert _max_d(eager, exact) <= VIT_TOL
    fwd = forward_scores(p7, tokens, lengths, device="cpu").numpy()
    assert _max_d(fwd, np.asarray(forward_xla(jp7, tokens, lengths))) <= FWD_TOL
    filt = viterbi_filter_scores(p7, tokens, lengths, device="cpu").numpy()
    assert np.all((filt >= exact - 1e-4) | np.isneginf(exact))


def test_mem_join_plain_posterior_matches_jax(mem_files, batch):
    """The plain posterior decode at LENG 6977 against the JAX XLA decode:
    coverage within 4e-3, totals within 2e-3."""
    path, jax_hmm = mem_files[chip_smoke.MEM_JOINS[0]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    cov, tot = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    want_cov, want_tot = posterior_coverage_batch_xla(JaxP7Profile.from_profile(jax_hmm),
                                                      tokens, lengths)
    live = lengths > 0  # the JAX decode of an empty sequence is NaN
    assert not cov[~live].any()
    assert _max_d(cov[live], np.asarray(want_cov)[live, : cov.shape[1]]) <= COV_TOL
    assert _max_d(tot[live], np.asarray(want_tot)[live]) <= TOT_TOL


def test_all_24_join_plans_the_rows_in_memory_case(mem_files):
    """The all-24 join (LENG 30181, M_pad 30184, 15 chain passes): every
    p7 kind plans the rows-in-memory case at each pass count it can run,
    the posterior backward pass at its suffix window."""
    path, _ = mem_files[chip_smoke.MEM_JOINS[1]]
    p7 = P7Profile.from_profile(parse_hmm(path))
    m_pad = p7_cuda.default_m_pad(p7)
    assert m_pad == 30184 and p7_cuda.chain_passes(m_pad) == 15
    assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, 30)
    window = posterior_cuda.prepare_suffix_chain(p7).shape[1]
    for kind in p7_cuda.BLOCKED_KINDS:
        passes = window if kind == "backward" else p7_cuda.chain_passes(m_pad)
        plan = p7_cuda.plan_launch(kind, m_pad, passes, 8, 40, 132)
        assert (plan.threads, plan.groups, plan.grid, plan.n_chain, plan.smem) == (
            p7_cuda.MEM_THREADS, 1, 8, 0, 0)
