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
scanner and the plain versions take M_pad past the p7 register cases' 4864,
where the MSV kernel and the lazy, filter and Forward p7 kinds run C-block
clusters up to 38,912 and the other p7 kinds' rows-in-memory cases take
over: the three-profile join of chip_smoke.py's MEM_JOINS (2405.hmm,
2365.hmm and 2207.hmm, LENG 6977) through the plain MSV, Viterbi (the lazy
one also at lazy_k = 1, whose chunks replay, and against the JAX lazy
kernel in interpret mode), the Viterbi filter (against the JAX filter
kernel in interpret mode), Forward and posterior decode against the JAX
oracle and XLA path at the same tolerances, the all-24 join (LENG
30181) through the plain MSV, Viterbi and Forward and the kernels' cases
and launch plans, the joins of CLUSTER_JOINS (the MSV clusters of 5, 8 and
9 blocks) through the plain MSV, and the all-24 join twice over (LENG
60362, past 38,912: the MSV kernel's 16-block cluster of 8-warp blocks, and
the posterior pair's C-block cluster of 13 256-thread blocks) through the
plain MSV and the
plain posterior decode (against ``posterior_coverage_batch_xla``), with a
NumPy model of that cluster's reduction order against the plain Forward.
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
    assert p7_cuda.kernel_case(m_pad)[0] == p7_cuda.KERNEL_THREADS
    assert all(p7_cuda.cluster_blocks(m_pad, kind) == p7_cuda.CLUSTER
               for kind in p7_cuda.BLOCKED_KINDS)


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
    """Past the register cases' 4864 states the p7 kernels' cases and
    launch plan pick the wide block (the eager kind: 1024 threads of 5
    states), a 3-block cluster (the Forward kind) or, with no kind, the
    rows-in-memory case, and the MSV kernel's a 3-block cluster, and
    past 65536 the p7 case, plan and the posterior launch raise, naming that
    limit, while the scanner and the plain versions scan:
    a profile of 4870 states (M_pad 4872; the LENG 4770 one joined with
    100.hmm) through MSV, the sweep and Viterbi on the CPU, MSV equal to the
    JAX oracle."""
    tokens, lengths = batch
    hmm = chip_smoke.join_profiles(jax_parse_hmm(wide_files[("2405", "2365")][0]),
                                   jax_parse_hmm(profile_dir / "100.hmm"))
    assert hmm.leng == 4870
    m_pad = msv_cuda.round_up(hmm.leng, 8)
    assert msv_cuda.kernel_case(m_pad) == (96, 52)
    assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, 5) and p7_cuda.kernel_per(m_pad) == 5
    assert p7_cuda.kernel_case(m_pad, "eager") == (p7_cuda.BLOCK_THREADS, 5)
    plan = p7_cuda.plan_launch("eager", m_pad, 13, B, 64, 132)
    assert (plan.threads, plan.cluster, plan.groups, plan.grid, plan.smem) == (
        p7_cuda.BLOCK_THREADS, p7_cuda.BLOCK_CLUSTER, 1, B,
        p7_cuda.blocked_smem_bytes(5, 7, 1, block=True))
    plan = p7_cuda.plan_launch("forward", m_pad, 4, B, 128, 132)
    assert (plan.threads, plan.cluster, plan.per, plan.groups, plan.grid) == (128, 3, 13, 1, 3 * B)
    assert p7_cuda.kernel_case(m_pad, "forward") == (128, 13)
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
    select the p7 kernels' rows-in-memory cases (with no kind) and the MSV
    kernel's C-block clusters (C = 3 and 13, chip_smoke.CLUSTER_SIZES); the
    eager and log-space kinds take the wide block at LENG 6977 and stay in
    memory at 30181."""
    path, jax_hmm = mem_files[stems]
    port = parse_hmm(path)
    built = chip_smoke.wide_profile(stems)
    assert port.leng == jax_hmm.leng == built.leng == {3: 6977, 24: 30181}[len(stems)]
    for field in ("match_emissions", "insert_emissions", "transitions"):
        assert np.array_equal(getattr(port, field), getattr(jax_hmm, field))
        assert np.array_equal(getattr(built, field), getattr(port, field))
    m_pad = msv_cuda.round_up(port.leng, 8)
    c = chip_smoke.CLUSTER_SIZES[chip_smoke.MEM_JOINS.index(stems)]
    assert msv_cuda.cluster_blocks(msv_cuda.kernel_case(m_pad)[0]) == c == {3: 3, 24: 13}[len(stems)]
    assert p7_cuda.kernel_case(m_pad)[0] == p7_cuda.MEM_THREADS
    for kind in p7_cuda.BLOCK_KINDS:
        assert p7_cuda.block_case(m_pad, kind) == (port.leng == 6977)


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


KT = p7_cuda.BLOCK_THREADS


def _block_shift(v: np.ndarray, s: int, per: int) -> np.ndarray:
    """csrc/p7_blocked.cuh::shift in the wide block ([B, KT * per] rows,
    thread t's slots k at t * per + k, fill -inf): below per (by 1, 2, 4, 8,
    16) slots k >= s move within the thread and the first s are the previous
    thread's last s; a larger shift writes the row into the shift buffer at
    t * stride + k and reads state t * per + k - s at sidx."""
    b = v.shape[0]
    x = v.reshape(b, KT, per)
    if s < per and s in (1, 2, 4, 8, 16):
        out = np.empty_like(x)
        out[:, :, s:] = x[:, :, : per - s]
        out[:, 1:, :s] = x[:, :-1, per - s:]
        out[:, 0, :s] = -np.inf
        return out.reshape(b, -1)
    stride = p7_cuda.blocked_stride(per)
    t, k = np.meshgrid(np.arange(KT), np.arange(per), indexing="ij")
    buf = np.full((b, KT * stride), np.nan, dtype=np.float32)
    buf[:, (t * stride + k).ravel()] = v
    j = (t * per + k - s).ravel()
    at = np.maximum(j, 0)
    at = at if per % 2 else at + at // per
    return np.where(j >= 0, buf[:, at], np.float32(-np.inf)).astype(np.float32)


def _block_reduce(v: np.ndarray, op) -> np.ndarray:
    """csrc/p7_blocked.cuh::block_reduce of one value a thread ([B, KT]): a
    warp butterfly, then lane l of every warp takes warp l mod (KT / 32)'s
    value and a butterfly over the lanes combines them; every thread ends
    with the same value."""
    t = np.arange(KT)
    for off in (16, 8, 4, 2, 1):
        v = op(v, v[:, t ^ off])
    w = KT // 32
    v = v[:, ::32][:, (t % 32) & (w - 1)]
    off = w // 2
    while off:
        v = op(v, v[:, t ^ off])
        off //= 2
    assert (v == v[:, :1]).all()
    return v[:, 0]


def _cluster_reduce(v: np.ndarray, op, c: int) -> np.ndarray:
    """E over a cluster of ``c`` wide blocks ([B, c * KT], one value a
    thread): each block's KT values as _block_reduce combines them
    (csrc/p7_blocked.cuh::wide_cluster_collect: lane l takes warp l's value
    of the block and a butterfly over the lanes combines the 32), then the
    blocks in rank order; c = 1 is the wide block's block_reduce."""
    parts = [_block_reduce(v[:, r * KT:(r + 1) * KT], op) for r in range(c)]
    acc = parts[0]
    for x in parts[1:]:
        acc = op(acc, x)
    return acc


def _cluster_shift(v: np.ndarray, s: int, per: int, c: int) -> np.ndarray:
    """A shift by s of a row of ``c`` wide blocks: the wide block's
    (_block_shift) for c = 1, else the plain shift, which the cluster's
    shifts equal (tests/test_torch_p7_layout.py, its
    _kernel_cluster_shift at BLOCK_THREADS)."""
    if c == 1:
        return _block_shift(v, s, per)
    out = np.full_like(v, -np.inf)
    out[:, s:] = v[:, :-s]
    return out


def _np_lse2(x: np.ndarray, y) -> np.ndarray:
    """p7_viterbi.cuh::combine<true> (JAX's _lse2) in float32."""
    mx = np.maximum(x, y)
    with np.errstate(invalid="ignore"):
        d = np.minimum(x, y) - mx
        return np.where(np.isnan(d), mx, mx + np.log1p(np.exp(d))).astype(np.float32)


def _block_model(kind: str, pack, staged, carry):
    """The wide block's eager (kind "eager") or log-space ("log") scan in
    NumPy, step for step as csrc/p7_viterbi.cuh::run_chunk runs it at KT =
    BLOCK_THREADS: the rows in the blocked layout, the plan's staged rows
    and the thread-major copy (p7_cuda.block_rows) for the others, the
    shifts of _block_shift and E by each thread's states in order, then
    _block_reduce; past MAX_BLOCK_STATES the cluster of C wide blocks' scan
    (block_chunk across the cluster): each block's slice of the thread-major
    rows, the plain shifts and E as _cluster_reduce. Kind "lazy" is
    block_chunk's CARRY step (the lazy kind past 38,912, the whole chain):
    the eager step reading pre_diag from the D row where the eager one
    combines it from M, I and D, E = max_j M_j, and the new rows' pre_diag
    max(max(M + tmm, I + tim), D + tdm) computed at the step's end into the
    D row. Returns the scan's (scores, m, i, d, s) as arrays."""
    lse = kind == "log"
    lazy = kind == "lazy"
    comb = _np_lse2 if lse else np.maximum
    m_pad = pack.m_pad
    passes = p7_cuda.chain_passes(m_pad)
    threads, per = p7_cuda.kernel_case(m_pad, kind)
    assert threads == KT
    c = p7_cuda.cluster_blocks(m_pad, kind)
    n = c * KT * per
    plan = p7_cuda.plan_launch(kind, m_pad, passes, B, 64, 132)
    tm = p7_cuda.block_rows(pack.trans, pack.chain, passes, per, c).numpy()
    tm = np.concatenate(np.split(tm, c), axis=2)  # [6 + passes, per, c * KT]

    def pad(x):
        return np.pad(np.asarray(x, dtype=np.float32), ((0, 0), (0, n - m_pad)),
                      constant_values=-np.inf)

    staged_rows = pad(np.concatenate([pack.trans[:6].numpy(), pack.chain[:passes].numpy()]))
    row = [staged_rows[q] if q < plan.n_trans + plan.n_chain else tm[q].T.reshape(-1)
           for q in range(6 + passes)]
    tmm, tmi, tmd, tim, tii, tdm = row[:6]
    msc, isc = pad(pack.emit_m.numpy()), pad(pack.emit_i.numpy())
    tr_b_mk, tr_e_c, tr_e_j = (np.float32(x) for x in pack.consts.numpy()[:3])
    tokens = staged.tokens.numpy().astype(np.int64).clip(0, 19)
    lengths = staged.lengths.numpy()
    tr_loop, tr_move = staged.tr_rows.numpy()
    m, i, d = (pad(x.numpy()) for x in carry[:3])
    sj, sc, sn, sb = carry[3].numpy().copy()
    for step in range(int(lengths.max())):
        valid = step < lengths
        pd = d if lazy else comb(comb(m + tmm, i + tim), d + tdm)
        diag = _cluster_shift(pd, 1, per, c)
        bt = (sb + tr_b_mk)[:, None]
        nm = msc[tokens[:, step]] + comb(diag, bt)
        ni = isc[tokens[:, step]] + comb(m + tmi, i + tii)
        ac = _cluster_shift(nm + tmd, 1, per, c)
        for p in range(passes):
            ac = comb(ac, _cluster_shift(ac, 1 << p, per, c) + row[6 + p])
        if lse:
            x = comb(nm, ac).reshape(-1, c * KT, per)
            mx = _cluster_reduce(x.max(axis=2), np.maximum, c)[:, None]
            total = np.zeros(x.shape[:2], dtype=np.float32)
            with np.errstate(invalid="ignore"):
                for k in range(per):
                    total = total + np.exp(np.where(x[:, :, k] == mx, np.float32(0),
                                                    x[:, :, k] - mx)).astype(np.float32)
            e = (mx[:, 0] + np.log(_cluster_reduce(total, np.add, c))).astype(np.float32)
        else:
            e = _cluster_reduce((nm if lazy else np.maximum(nm, ac)).reshape(-1, c * KT, per)
                                .max(axis=2), np.maximum, c)
        if lazy:
            ac = np.maximum(np.maximum(nm + tmm, ni + tim), ac + tdm)
        nj = comb(sj + tr_loop, e + tr_e_j)
        nc = comb(sc + tr_loop, e + tr_e_c)
        nn = sn + tr_loop
        nb = comb(nn + tr_move, nj + tr_move)
        m, i, d = (np.where(valid[:, None], new, old) for new, old in ((nm, m), (ni, i), (ac, d)))
        sj, sc, sn, sb = (np.where(valid, new, old) for new, old in
                          ((nj, sj), (nc, sc), (nn, sn), (nb, sb)))
    return (sc + tr_move, m[:, :m_pad], i[:, :m_pad], d[:, :m_pad],
            np.stack([sj, sc, sn, sb]))


def test_block_model_matches_plain(mem_files, batch):
    """The wide block (the eager and log-space kinds at LENG 6977: 1024
    threads of 7 states, 4 rows staged, 15 read thread-major) modelled in
    NumPy step for step: its larger shifts through the shift buffer and
    its E order (each thread's states in order, the warp butterfly, then
    the warps' butterfly) give the plain eager Viterbi's scores and carries
    bit for bit and the plain log-space Forward's scores within
    LOG_FWD_TOL; plain_versions hold plain against JAX
    (test_mem_join_plain_p7_matches_jax)."""
    path, _ = mem_files[chip_smoke.MEM_JOINS[0]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    pack = p7_cuda.viterbi_pack(p7, "cpu", lazy=False)
    assert p7_cuda.kernel_case(pack.m_pad, "eager") == (KT, 7)
    plan = p7_cuda.plan_launch("eager", pack.m_pad, 13, B, 64, 132)
    assert (plan.threads, plan.block, plan.n_trans, plan.n_chain) == (KT, True, 4, 0)
    staged = MSVScanner(device="cpu").stage(tokens, lengths)
    for kind in ("eager", "log"):
        run, carry = chip_smoke.p7_calls(kind, pack, staged)
        want = [x.numpy() for x in run(chip_smoke.PLAIN_FNS[kind], staged.tokens,
                                       staged.lengths, carry)]
        got = _block_model(kind, pack, staged, carry)
        if kind == "eager":
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
        else:
            assert _max_d(got[0], want[0]) <= chip_smoke.LOG_FWD_TOL
            assert np.isfinite(got[0][lengths > 0]).all()


def test_block_cluster_model_matches_plain(mem_files, batch):
    """The cluster of wide blocks (the eager and log-space kinds at LENG
    30181: 4 wide blocks of 1024 threads of 8 states, no row staged, all 21
    constant rows read from each block's thread-major slice) modelled in
    NumPy step for step: its E order (each thread's states in order, the
    warp butterfly, each block's 32 warps by a butterfly over the lanes,
    then the blocks in rank order) gives the plain eager Viterbi's scores
    and carries bit for bit and the plain log-space Forward's scores within
    LOG_FWD_TOL; plain_versions hold plain against JAX
    (test_all_24_join_plain_p7_matches_jax)."""
    path, _ = mem_files[chip_smoke.MEM_JOINS[1]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    pack = p7_cuda.viterbi_pack(p7, "cpu", lazy=False)
    assert p7_cuda.kernel_case(pack.m_pad, "eager") == (KT, 8)
    assert p7_cuda.cluster_blocks(pack.m_pad, "log") == 4
    plan = p7_cuda.plan_launch("eager", pack.m_pad, 15, B, 64, 132)
    assert (plan.threads, plan.cluster, plan.block_cluster, plan.n_trans, plan.n_chain) == (
        KT, 4, True, 0, 0)
    staged = MSVScanner(device="cpu").stage(tokens, lengths)
    for kind in ("eager", "log"):
        run, carry = chip_smoke.p7_calls(kind, pack, staged)
        want = [x.numpy() for x in run(chip_smoke.PLAIN_FNS[kind], staged.tokens,
                                       staged.lengths, carry)]
        got = _block_model(kind, pack, staged, carry)
        if kind == "eager":
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
        else:
            assert _max_d(got[0], want[0]) <= chip_smoke.LOG_FWD_TOL
            assert np.isfinite(got[0][lengths > 0]).all()


# the lazy kind past 38,912 states: the all-24 join twice over (LENG 60362)
# on a small batch
LAZY_B, LAZY_L = 4, 40


@pytest.fixture(scope="module")
def join_60362(profile_dir):
    """(the port's P7Profile, the JAX P7Profile) of the all-24 join twice
    over (chip_smoke.MSV_MEM_JOIN, LENG 60362, M_pad 60368)."""
    stems = chip_smoke.MSV_MEM_JOIN
    jax_hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    return (P7Profile.from_profile(chip_smoke.wide_profile(stems)),
            JaxP7Profile.from_profile(jax_hmm))


@pytest.mark.parametrize("extra", [(), ("2405", "2365")], ids=("60362", "34951"))
def test_past_32768_states_lazy_pack_matches_jax(profile_dir, extra):
    """Past 32,768 states the chain has 16 passes: the port's
    prepare_p7_device_lazy and pallas_p7's take lazy_k = 16 (no truncated
    window, no certificate: row 15 of the chain is chain data) and give the
    same arrays byte for byte (tolerance 0.0), at the all-24 join twice over
    (LENG 60362, where the lazy kind runs the eager kind's cluster of 8 wide
    blocks) and at the all-24 join with 2405 and 2365 (LENG 34951, its
    cluster of 5 wide blocks: past 32,768, below the 128-thread clusters'
    38,912)."""
    stems = chip_smoke.MSV_MEM_JOIN if not extra else chip_smoke.MEM_JOINS[1] + extra
    jax_hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    p7 = P7Profile.from_profile(chip_smoke.wide_profile(stems))
    m_pad = p7_cuda.default_m_pad(p7)
    assert m_pad == (60368 if not extra else 34952) and p7_cuda.chain_passes(m_pad) == 16
    assert p7_cuda.block_cluster_case(m_pad, "lazy")
    assert p7_cuda.cluster_blocks(m_pad, "lazy") == (8 if not extra else 5)
    got = p7_cuda.prepare_p7_device_lazy(p7)
    want = pallas_p7.prepare_p7_device_lazy(JaxP7Profile.from_profile(jax_hmm))
    assert got[5] == want[5] == 16
    for g, w in zip(got[:5], want[:5]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
    assert np.isfinite(got[3][:, 15]).any()  # chain data, not -inf or Cmax
    assert p7_cuda.e_skip_d_ok(p7)


def test_block_cluster_lazy_model_matches_plain(join_60362):
    """The lazy kind's case past 38,912 states (LENG 60362: 8 wide blocks of
    1024 threads of 8 states, the whole 16-pass chain, nothing certified)
    is the eager step with pre_diag carried in the D row: _block_model's
    lazy step (block_chunk's CARRY) gives the plain lazy Viterbi's scores
    and every carry (M, I, pre_diag, the specials) bit for bit with no
    replay, on a ragged batch of 4 x 40; its scores equal the plain eager
    Viterbi's and its pre_diag is max(max(M + tmm, I + tim), D + tdm) of the
    eager carries; a sequence past its length keeps its last valid step's
    pre_diag, so a two-call carry chain split at 17 equals one call."""
    p7, _ = join_60362
    rng = np.random.default_rng(62)
    tokens = rng.integers(0, 20, size=(LAZY_B, LAZY_L)).astype(np.int32)
    lengths = np.array([LAZY_L, 0, 17, 29], dtype=np.int32)
    pack = p7_cuda.viterbi_pack(p7, "cpu", lazy=True)
    assert pack.lazy_k == p7_cuda.chain_passes(pack.m_pad) == 16
    assert p7_cuda.kernel_case(pack.m_pad, "lazy") == (KT, 8)
    assert p7_cuda.cluster_blocks(pack.m_pad, "lazy") == 8
    staged = MSVScanner(device="cpu").stage(tokens, lengths)
    run, carry = chip_smoke.p7_calls("lazy", pack, staged)
    want = run(chip_smoke.PLAIN_FNS["lazy"], staged.tokens, staged.lengths, carry)
    assert int(want[5].sum()) == 0
    got = _block_model("lazy", pack, staged, carry)
    for g, w in zip(got, want[:5]):
        assert np.array_equal(g, w.numpy())
    eager_pack = p7_cuda.viterbi_pack(p7, "cpu", lazy=False)
    run_e, carry_e = chip_smoke.p7_calls("eager", eager_pack, staged)
    eager = run_e(chip_smoke.PLAIN_FNS["eager"], staged.tokens, staged.lengths, carry_e)
    assert torch.equal(eager[0], want[0]) and torch.equal(eager[4], want[4])
    live = torch.from_numpy(lengths > 0)
    pd = chip_smoke.pre_diag(eager_pack, *eager[1:4])
    assert torch.equal(pd[live], want[3][live])
    split = 17
    first = run(chip_smoke.PLAIN_FNS["lazy"], staged.tokens[:, :split].contiguous(),
                staged.lengths.clamp(max=split), carry)
    second = run(chip_smoke.PLAIN_FNS["lazy"], staged.tokens[:, split:].contiguous(),
                 (staged.lengths - split).clamp(min=0), first[1:5])
    for g, w in zip(second[:5], want[:5]):
        assert torch.equal(g, w)


def test_mem_join_plain_lazy_and_filter_match_jax(mem_files, batch):
    """At LENG 6977, where the lazy and filter kernels run 3-block
    clusters: the plain lazy Viterbi at a forced lazy_k = 1 replays chunks
    (its certificate fires) and equals the plain eager Viterbi bit for bit,
    viterbi_xla within 1e-4 and viterbi_pallas(lazy_k=1, interpret=True) on
    the first 16 residues bit for bit; the plain Viterbi filter is >=
    viterbi_xla and equal to viterbi_filter_pallas(interpret=True) on the
    first 16 residues bit for bit."""
    path, jax_hmm = mem_files[chip_smoke.MEM_JOINS[0]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    jp7 = JaxP7Profile.from_profile(jax_hmm)
    m_pad = p7_cuda.default_m_pad(p7)
    assert p7_cuda.cluster_blocks(m_pad, "lazy") == p7_cuda.cluster_blocks(m_pad, "filter") == 3
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    pack = p7_cuda.viterbi_pack(p7, "cpu", lazy=True, lazy_k=1)
    assert pack.lazy_k == 1
    carry = p7_cuda.viterbi_init_carry(staged.tr_rows, m_pad)
    lazy, *_, replays = p7_cuda.viterbi_lazy_scan_plain(
        *pack[:4], staged.tokens, staged.lengths, staged.tr_rows, pack.consts, *carry, 1)
    assert int(replays.sum()) > 0
    eager = viterbi_scores(p7, tokens, lengths, device="cpu", lazy=False).numpy()
    assert np.array_equal(lazy.numpy()[:B], eager)
    exact = np.asarray(viterbi_xla(jp7, tokens, lengths))
    assert _max_d(eager, exact) <= VIT_TOL
    short = np.minimum(lengths, 16)
    got = viterbi_scores(p7, tokens[:, :16], short, device="cpu", lazy_k=1).numpy()
    want = np.asarray(pallas_p7.viterbi_pallas(jp7, tokens[:, :16], short, l_chunk=16,
                                               interpret=True, lazy_k=1))
    assert np.array_equal(got, want)
    filt = viterbi_filter_scores(p7, tokens, lengths, device="cpu").numpy()
    assert np.all((filt >= exact - 1e-4) | np.isneginf(exact))
    got = viterbi_filter_scores(p7, tokens[:, :16], short, device="cpu").numpy()
    want = np.asarray(pallas_p7.viterbi_filter_pallas(jp7, tokens[:, :16], short, l_chunk=16,
                                                      interpret=True))
    assert np.array_equal(got, want)


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
    """The all-24 join (LENG 30181, M_pad 30184, 15 chain passes): the
    eager and log-space kinds plan a cluster of 4 wide blocks of 8 states a
    thread at the full chain, and the rows-in-memory case on a card that
    holds no such cluster (``clusters`` 0); the lazy, filter, Forward and
    row-saving Forward kinds, and the posterior backward pass at its suffix
    window, a 13-block cluster of 19 states a thread."""
    path, _ = mem_files[chip_smoke.MEM_JOINS[1]]
    p7 = P7Profile.from_profile(parse_hmm(path))
    m_pad = p7_cuda.default_m_pad(p7)
    assert m_pad == 30184 and p7_cuda.chain_passes(m_pad) == 15
    assert p7_cuda.kernel_case(m_pad) == (p7_cuda.MEM_THREADS, 30)
    window = posterior_cuda.prepare_suffix_chain(p7).shape[1]
    for kind in p7_cuda.BLOCKED_KINDS:
        passes = window if kind == "backward" else p7_cuda.chain_passes(m_pad)
        plan = p7_cuda.plan_launch(kind, m_pad, passes, 8, 40, 132)
        if kind in p7_cuda.CLUSTER_KINDS:
            assert (plan.threads, plan.cluster, plan.per, plan.groups, plan.grid) == (
                128, 13, 19, 1, 13 * 8)
        else:
            assert (plan.threads, plan.cluster, plan.per, plan.groups, plan.grid) == (
                p7_cuda.BLOCK_THREADS, 4, 8, 1, 4 * 8)
            assert plan.block_cluster and not plan.mem
            plan = p7_cuda.plan_launch(kind, m_pad, passes, 8, 40, 132, clusters=0)
            assert (plan.threads, plan.groups, plan.grid, plan.n_chain, plan.smem) == (
                p7_cuda.MEM_THREADS, 1, 8, 0, 0)
            assert plan.mem


@pytest.mark.parametrize("stems", chip_smoke.CLUSTER_JOINS, ids=lambda s: f"{len(s)}-profile")
def test_cluster_join_plain_msv_matches_jax(profile_dir, batch, stems):
    """The joins of CLUSTER_JOINS (LENG 11165, 18170, 19679) select the MSV
    kernel's 5-, 8- and 9-block clusters; the port's plain MSV on each (as
    chip_smoke.py builds it) == msv_oracle_batch bit for bit, and the filter
    >= exact."""
    tokens, lengths = batch
    jax_hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    hmm = chip_smoke.wide_profile(stems)
    assert hmm.leng == jax_hmm.leng == sum(int(s) for s in stems)
    m_pad = msv_cuda.round_up(hmm.leng, 8)
    c = chip_smoke.CLUSTER_SIZES[len(chip_smoke.MEM_JOINS) + chip_smoke.CLUSTER_JOINS.index(stems)]
    assert msv_cuda.cluster_blocks(msv_cuda.kernel_case(m_pad)[0]) == c
    prof = MSVProfile.from_profile(hmm)
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    got = sc.scan(prof, staged).numpy()
    assert np.array_equal(got, msv_oracle_batch(JaxMSVProfile.from_profile(jax_hmm), tokens,
                                                lengths))
    filt = sc.scan_filter(prof, staged).numpy()
    assert np.all((filt >= got) | np.isneginf(got))


def test_past_the_largest_cluster_plain_msv_matches_jax(profile_dir, batch):
    """The all-24 join twice over (chip_smoke.MSV_MEM_JOIN, LENG 60362) is
    past the 16-block cluster of 16-warp blocks' 38,912 states: the MSV
    kernel's 16-block cluster of 8-warp blocks, 120 states a lane. Its plain
    MSV == msv_oracle_batch bit for bit."""
    tokens, lengths = batch
    stems = chip_smoke.MSV_MEM_JOIN
    jax_hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    hmm = chip_smoke.wide_profile(stems)
    assert hmm.leng == jax_hmm.leng == 2 * 30181
    m_pad = msv_cuda.round_up(hmm.leng, 8)
    assert m_pad > msv_cuda.MAX_CLUSTER_STATES
    assert msv_cuda.kernel_case(m_pad) == (32 * 16, 120)
    got = MSVScanner(device="cpu").scan(MSVProfile.from_profile(hmm),
                                        MSVScanner(device="cpu").stage(tokens, lengths)).numpy()
    assert np.array_equal(got, msv_oracle_batch(JaxMSVProfile.from_profile(jax_hmm), tokens,
                                                lengths))


def test_all_24_join_plain_p7_matches_jax(mem_files, batch):
    """At LENG 30181 (15 chain passes) the plain eager Viterbi ==
    viterbi_xla within 1e-4 and Forward == forward_xla within 2e-3."""
    path, jax_hmm = mem_files[chip_smoke.MEM_JOINS[1]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    jp7 = JaxP7Profile.from_profile(jax_hmm)
    eager = viterbi_scores(p7, tokens, lengths, device="cpu", lazy=False).numpy()
    assert _max_d(eager, np.asarray(viterbi_xla(jp7, tokens, lengths))) <= VIT_TOL
    fwd = forward_scores(p7, tokens, lengths, device="cpu").numpy()
    assert _max_d(fwd, np.asarray(forward_xla(jp7, tokens, lengths))) <= FWD_TOL


def test_all_24_join_plain_posterior_matches_jax(mem_files, batch):
    """The plain posterior decode at LENG 30181 (where the backward pass
    runs a 13-block cluster on the card) against the JAX XLA decode:
    coverage within 4e-3, totals within 2e-3."""
    path, jax_hmm = mem_files[chip_smoke.MEM_JOINS[1]]
    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(path))
    assert p7_cuda.cluster_blocks(p7_cuda.default_m_pad(p7), "backward") == 13
    cov, tot = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    want_cov, want_tot = posterior_coverage_batch_xla(JaxP7Profile.from_profile(jax_hmm),
                                                      tokens, lengths)
    live = lengths > 0  # the JAX decode of an empty sequence is NaN
    assert not cov[~live].any()
    assert _max_d(cov[live], np.asarray(want_cov)[live, : cov.shape[1]]) <= COV_TOL
    assert _max_d(tot[live], np.asarray(want_tot)[live]) <= TOT_TOL


def test_past_the_largest_cluster_plain_posterior_matches_jax(profile_dir, batch):
    """The all-24 join twice over (chip_smoke.MSV_MEM_JOIN, LENG 60362,
    M_pad 60368), where the row-saving Forward and the backward pass run a
    C-block cluster of 13 256-thread blocks of 19 states a thread on the
    card: the port's plain posterior decode against the JAX XLA decode,
    coverage within 4e-3, totals within 2e-3."""
    tokens, lengths = batch
    stems = chip_smoke.MSV_MEM_JOIN
    jax_hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    p7 = P7Profile.from_profile(chip_smoke.wide_profile(stems))
    m_pad = p7_cuda.default_m_pad(p7)
    assert m_pad == 60368 and p7_cuda.cluster_blocks(m_pad, "backward") == 13
    assert p7_cuda.kernel_case(m_pad, "save") == p7_cuda.kernel_case(m_pad, "backward") == (
        p7_cuda.WIDE_CLUSTER_THREADS, 19)
    cov, tot = posterior_cuda.posterior_coverage_batch(p7, tokens, lengths, device="cpu")
    want_cov, want_tot = posterior_coverage_batch_xla(JaxP7Profile.from_profile(jax_hmm),
                                                      tokens, lengths)
    live = lengths > 0  # the JAX decode of an empty sequence is NaN
    assert not cov[~live].any()
    assert _max_d(cov[live], np.asarray(want_cov)[live, : cov.shape[1]]) <= COV_TOL
    assert _max_d(tot[live], np.asarray(want_tot)[live]) <= TOT_TOL


WIDE_KT = p7_cuda.WIDE_CLUSTER_THREADS


def _wide_cluster_reduce(v: np.ndarray, op, c: int) -> np.ndarray:
    """A reduction over a C-block cluster of 256-thread blocks ([B, c *
    256], one value a thread), as csrc/p7_blocked.cuh::cluster_reduce takes
    it: a warp butterfly, then each block's eight warps in the group's fixed
    order (combine_warps: pairs of neighbours, then pairs of pairs), then the
    blocks in rank order (cluster_collect)."""
    t = np.arange(WIDE_KT)
    acc = None
    for r in range(c):
        x = v[:, r * WIDE_KT:(r + 1) * WIDE_KT]
        for off in (16, 8, 4, 2, 1):
            x = op(x, x[:, t ^ off])
        assert all((x[:, 32 * w:32 * w + 32] == x[:, 32 * w:32 * w + 1]).all() for w in range(8))
        w = x[:, ::32]
        blk = op(op(op(w[:, 0], w[:, 1]), op(w[:, 2], w[:, 3])),
                 op(op(w[:, 4], w[:, 5]), op(w[:, 6], w[:, 7])))
        acc = blk if acc is None else op(acc, blk)
    return acc


def _wide_cluster_forward_model(pack, staged, carry, kind: str = "save"):
    """The row-saving Forward's scan on its C-block cluster of 256-thread
    blocks (csrc/p7_forward_kernel.cu::forward_body at KT = 256; ``kind``
    "forward": the plain Forward's, the same body without the saved rows,
    whose stores change no value) in NumPy
    float32, step for step: the rows padded with 0 to the cluster's c * 256
    * per states, the delete chain's passes as the plain shifts (which the
    cluster's shifts equal: tests/test_torch_p7_layout.py), E as each
    thread's states in order and then _wide_cluster_reduce's sum, and every
    FWD_RESCALE_GROUP steps the rescale max by _wide_cluster_reduce's max of
    each thread's max (from 0). Returns (scores, m, i, d, s[:6])."""
    f32 = np.float32
    m_pad = pack.m_pad
    threads, per = p7_cuda.kernel_case(m_pad, kind)
    c = p7_cuda.cluster_blocks(m_pad, kind)
    assert threads == WIDE_KT
    n = c * threads * per

    def pad(x):
        return np.pad(np.asarray(x, dtype=f32), ((0, 0), (0, n - m_pad)))

    def shift(x, s):
        out = np.zeros_like(x)
        out[:, s:] = x[:, :-s]
        return out

    tmm, tmi, tmd, tim, tii, tdm = pad(pack.trans[:6].numpy())
    chain = pad(pack.chain.numpy())
    modds, iodds = pad(pack.emit_m.numpy()), pad(pack.emit_i.numpy())
    p_b_mk, p_e_c, p_e_j = (f32(x) for x in pack.consts.numpy()[:3])
    tokens = staged.tokens.numpy().astype(np.int64).clip(0, 19)
    lengths = staged.lengths.numpy()
    p_loop, p_move = staged.tr_probs.numpy()
    m, i, d = (pad(x.numpy()) for x in carry[:3])
    sj, sc, sn, sb, log_scale, comp = carry[3].numpy()[:6].copy()
    for step in range(int(lengths.max())):
        valid = step < lengths
        diag = shift(m * tmm + i * tim + d * tdm, 1)
        nm = modds[tokens[:, step]] * (diag + (sb * p_b_mk)[:, None])
        ni = iodds[tokens[:, step]] * (m * tmi + i * tii)
        ac = shift(nm * tmd, 1)
        for k in range(chain.shape[0]):
            ac = ac + shift(ac, 1 << k) * chain[k]
        x = (nm + ac).reshape(-1, c * WIDE_KT, per)
        tot = np.zeros(x.shape[:2], dtype=f32)
        for k in range(per):
            tot = tot + x[:, :, k]
        e = _wide_cluster_reduce(tot, np.add, c)
        nj = sj * p_loop + e * p_e_j
        nc = sc * p_loop + e * p_e_c
        nn = sn * p_loop
        nb = nn * p_move + nj * p_move
        m, i, d = (np.where(valid[:, None], new, old) for new, old in ((nm, m), (ni, i), (ac, d)))
        sj, sc, sn, sb = (np.where(valid, new, old) for new, old in
                          ((nj, sj), (nc, sc), (nn, sn), (nb, sb)))
        if (step + 1) % p7_cuda.FWD_RESCALE_GROUP == 0:
            mx = np.maximum(m.reshape(-1, c * WIDE_KT, per).max(axis=2), f32(0))
            mx = _wide_cluster_reduce(mx, np.maximum, c)
            scale = np.maximum(np.maximum(mx, sc), np.maximum(sn, f32(1e-30)))
            inv = (f32(1) / scale).astype(f32)
            y = (np.log(scale) - comp).astype(f32)
            t_sum = (log_scale + y).astype(f32)
            new = (m * inv[:, None], i * inv[:, None], d * inv[:, None], sj * inv, sc * inv,
                   sn * inv, sb * inv, t_sum, ((t_sum - log_scale) - y).astype(f32))
            old = (m, i, d, sj, sc, sn, sb, log_scale, comp)
            m, i, d, sj, sc, sn, sb, log_scale, comp = (
                np.where(valid[:, None] if o.ndim == 2 else valid, nw, o)
                for nw, o in zip(new, old))
    with np.errstate(divide="ignore"):  # an empty sequence's C is 0: -inf, as plain
        score = (np.log(sc) + log_scale + staged.tr_rows.numpy()[1]).astype(f32)
    return (score, m[:, :m_pad], i[:, :m_pad], d[:, :m_pad],
            np.stack([sj, sc, sn, sb, log_scale, comp]))


def test_wide_cluster_model_matches_plain(join_60362, batch):
    """Forward and the row-saving Forward on their C-block cluster of
    256-thread blocks at LENG 60362 (13 blocks of 19 states a thread, one
    case for both) modelled in NumPy step for step
    (_wide_cluster_forward_model without SAVE): its reduction order (each
    thread's states in order, the warp butterfly, each block's eight warps
    in pairs of pairs, the blocks in rank order, for E and the rescale max)
    gives forward_prob_scan_plain's scores within FWD_TOL and its carries
    (M, I, D, the specials, the log scale) within FWD_TOL too; the plain
    versions are held against JAX (test_past_the_largest_cluster_plain_
    posterior_matches_jax)."""
    tokens, lengths = batch
    p7, _ = join_60362
    pack = p7_cuda.forward_pack(p7, "cpu")
    assert p7_cuda.cluster_blocks(pack.m_pad, "save") == 13
    assert (p7_cuda.cluster_blocks(pack.m_pad, "forward"), p7_cuda.kernel_case(pack.m_pad,
                                                                                "forward")) == (
        13, p7_cuda.kernel_case(pack.m_pad, "save"))
    staged = MSVScanner(device="cpu").stage(tokens, lengths)
    # the plain row-saving Forward's scores and carries are the plain Forward's
    run, carry = chip_smoke.p7_calls("forward", pack, staged)
    want = [x.numpy() for x in run(chip_smoke.PLAIN_FNS["forward"], staged.tokens,
                                   staged.lengths, carry)]
    got = _wide_cluster_forward_model(pack, staged, carry, "forward")
    live = lengths > 0
    assert np.isfinite(got[0][live]).all()
    assert _max_d(got[0], want[0]) <= FWD_TOL
    for g, w in zip(got[1:4], want[1:4]):
        assert _max_d(g, w) <= FWD_TOL
    assert _max_d(got[4], want[4][:6]) <= FWD_TOL
