"""The cases past 38,912 states of the Viterbi filter (B6) and MSV (B1-B3)
on the CPU: their launch plans, and NumPy models of the kernels' index math
held bit for bit against the plain versions and the JAX package.

Past 38,912 states (up to 65536) the Viterbi filter runs C-block clusters
of 256-thread blocks (``csrc/p7_viterbi.cuh::viterbi_wide_cluster_kernel``,
C = ceil(M_pad / 4864)) and MSV a 16-block cluster of 8-warp blocks
(``csrc/msv_kernel.cu::msv_wide_cluster_kernel``: a warp a block holds its
slice of 32 * PER states, each lane's last ``wide_staged(PER)`` table
entries staged in shared memory and its first ones read from the lane-major
copy ``msv_cuda.lane_rows``). The all-24 join twice over
(``chip_smoke.MSV_MEM_JOIN``, LENG 60362, M_pad 60368) takes 13 blocks of
19 states a thread for the filter, at its auto window of 7 of 16 passes,
and 16 blocks of 120 states a lane for MSV (84 staged, 36 from the copy).
The models run each kernel's step on a ragged batch of 4 x 40 with one
empty sequence, reading every table entry and constant row through the
kernel's own index math, and equal the plain versions bit for bit; the
plain filter equals the JAX filter kernel in interpret mode.
"""

import numpy as np
import pytest
import torch
from p7_layout_models import _kernel_cluster_shift, _sidx_row

import chip_smoke
from hmm_fasta_viterbi_tpu import parse_hmm as jax_parse_hmm
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile as JaxMSVProfile
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile as JaxP7Profile
from hmm_fasta_viterbi_tpu.ops import pallas_p7
from hmm_fasta_viterbi_tpu.ops.reference import msv_oracle_batch
from hmm_fasta_viterbi_tpu_torch import MSVProfile, P7Profile
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda, p7_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner, viterbi_filter_scores

B, L = 4, 40
LENGTHS = np.array([L, 0, 17, 29], dtype=np.int32)
F32 = np.float32
NEG_INF = F32(-np.inf)
SMS = 132  # the H100 SXM's multiprocessors


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores, and many
    threads a worker on such ops mostly wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def join(profile_dir):
    """(the port's join, the JAX package's) of the all-24 join twice over
    (LENG 60362)."""
    stems = chip_smoke.MSV_MEM_JOIN
    jax_hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    hmm = chip_smoke.wide_profile(stems)
    assert hmm.leng == jax_hmm.leng == 60362
    return hmm, jax_hmm


@pytest.fixture(scope="module")
def staged():
    rng = np.random.default_rng(38913)
    tokens = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    return tokens, MSVScanner(device="cpu").stage(tokens, LENGTHS)


# -- routing -----------------------------------------------------------------------

@pytest.mark.parametrize("m_pad,per", [(38920, 80), (40960, 80), (40968, 88), (60368, 120),
                                       (65536, 128)])
def test_msv_case_past_38912(m_pad, per):
    """Past 38,912 states, up to 65536, MSV runs 16 blocks of 8 warps, one
    warp a block following a sequence's slice (32 * 16 lanes, per 80..128 in
    steps of 8, the smallest that covers M_pad): a block stages each lane's
    last 84 states (76 at per 80) and its links in 232,448 bytes, and a
    persistent grid of the clusters the card holds, split among the profiles
    and at most the batch needs."""
    lanes, got = msv_cuda.kernel_case(m_pad)
    assert (lanes, got) == (32 * 16, per) and msv_cuda.cluster_blocks(lanes) == 16
    assert msv_cuda.wide_cluster_case(lanes, per)
    assert 512 * (per - 8) < m_pad <= 512 * per
    staged = msv_cuda.wide_staged(per)
    assert staged == (76 if per == 80 else 84) and staged % 8 == 4
    smem = msv_cuda.cluster_smem_bytes(per, 16)
    assert smem == 4 * 20 * 32 * staged + 8 * (16 + 16 * 15) <= msv_cuda.SMEM_PER_SM
    for b_pad, num_p, clusters, grid in ((256, 1, 7, 112), (20, 1, 7, 48), (256, 2, 7, 48),
                                         (1, 4, 7, 16), (256, 1, None, 128)):
        plan = msv_cuda.launch_plan(lanes, per, 4, b_pad, num_p, SMS, clusters=clusters)
        assert plan == msv_cuda.MsvPlan(8, grid, smem, 16)
    with pytest.raises(ValueError, match="fixed"):
        msv_cuda.launch_plan(lanes, per, 4, 256, 1, SMS, warps=8)


def test_msv_cases_at_the_ends():
    """The 16-block cluster of 16-warp blocks (per 76) ends at 38,912, the
    case of 8-warp blocks at 65536, and past it the rows-in-memory case takes
    every width (the kernel has no cap)."""
    assert msv_cuda.kernel_case(38912) == (512, 76)
    assert not msv_cuda.wide_cluster_case(512, 76)
    assert msv_cuda.cluster_smem_bytes(76, 16) == 4 * 20 * 32 * 76 + 16 * 256
    assert msv_cuda.kernel_case(38913) == (512, 80)
    assert msv_cuda.kernel_case(65536) == (512, 128)
    assert msv_cuda.kernel_case(65544) == (msv_cuda.MEM_LANES, 65)
    assert msv_cuda.MAX_WIDE_CLUSTER_STATES == 65536
    assert msv_cuda.WIDE_CLUSTER_PER == (80, 88, 96, 104, 112, 120, 128)


def test_msv_device_plan_routes(monkeypatch):
    """device_case and device_plan at LENG 60362: the 16-block cluster of
    8-warp blocks where the card holds one (the grid of the clusters it
    holds), the rows-in-memory case where it holds none (the occupancy
    query answering 0), in both modes."""
    monkeypatch.setattr(msv_cuda, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(msv_cuda, "max_clusters", lambda index, lanes, per, bf16: 7)
    for entry in (4, 2):
        assert msv_cuda.device_case(60368, entry, "cpu") == (512, 120)
        assert msv_cuda.device_plan(60368, entry, 256, 1, "cpu") == msv_cuda.MsvPlan(
            8, 112, 217088, 16)
    monkeypatch.setattr(msv_cuda, "_cluster_fits", lambda index, lanes, per, bf16: False)
    for entry in (4, 2):
        assert msv_cuda.device_case(60368, entry, "cpu") == (msv_cuda.MEM_LANES, 59)
        assert msv_cuda.device_plan(60368, entry, 256, 1, "cpu") == msv_cuda.MsvPlan(
            32, 256, 0)


@pytest.mark.parametrize("m_pad,c,per,n_trans,n_chain", [
    (38920, 9, 17, 6, 1), (60368, 13, 19, 5, 0), (65536, 14, 19, 5, 0)])
def test_filter_case_past_38912(m_pad, c, per, n_trans, n_chain):
    """Past 38,912 states the Viterbi filter runs C-block clusters of
    256-thread blocks (C = ceil(M_pad / 4864), per 17..19), as Forward and
    the posterior pair do: its bf16 emission rows (two steps of two rows),
    then as many transition rows, then chain rows, as fit 232,448 bytes
    beside its group and the cluster's area, at its window of 7 passes; a
    card that holds none plans the rows-in-memory case."""
    assert p7_cuda.kernel_case(m_pad, "filter") == (256, per)
    assert p7_cuda.cluster_blocks(m_pad, "filter") == c
    assert p7_cuda.wide_cluster_case(m_pad, "filter")
    plan = p7_cuda.plan_launch("filter", m_pad, 7, 64, 200, SMS)
    assert plan.wide_cluster and (plan.threads, plan.cluster, plan.per) == (256, c, per)
    assert (plan.n_trans, plan.n_chain) == (n_trans, n_chain)
    row = 4 * 256 * p7_cuda.blocked_stride(per)
    hrow = 4 * 256 * p7_cuda.bf16_stride(per) // 2
    base = 2 * row + 4 * hrow + 4 * (16 + 32) + 2 * row + 4 * 596
    assert plan.smem == base + (n_trans + n_chain) * row <= p7_cuda.SMEM_PER_SM
    assert plan.smem + row > p7_cuda.SMEM_PER_SM
    assert plan.smem == p7_cuda.blocked_smem_bytes(per, n_trans + n_chain, 1, bf16=True,
                                                   cluster=True, threads=256)
    assert p7_cuda.plan_launch("filter", m_pad, 7, 64, 200, SMS, clusters=7).grid == 7 * c
    mem = p7_cuda.plan_launch("filter", m_pad, 7, 64, 200, SMS, clusters=0)
    assert mem.mem and (mem.threads, mem.per) == (1024, -(-m_pad // 1024))


# -- MSV: the 16-block cluster of 8-warp blocks ------------------------------------

def _order_key(x: np.ndarray) -> np.ndarray:
    """csrc/msv_kernel.cu::order_key of f32 values: an int32 image whose
    integer order is the float order."""
    bits = x.astype(F32).view(np.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _key_float(key: np.ndarray) -> np.ndarray:
    return _order_key(key.view(F32)).view(F32)


def _msv_wide_model(emit: torch.Tensor, tr_consts, tokens, lengths, tr_rows, m_in, s_in):
    """csrc/msv_kernel.cu::msv_wide_cluster_kernel in NumPy float32 for one
    profile (``emit`` [20, M_pad], f32 or bf16): block r, lane l holds states
    (32 r + l) * per + k; a step's entry of state k is the block's shared
    table (staged as the kernel stages it: row aa, index l * S + k - 4 *
    low4, S = wide_staged(per)) for k >= 4 * low4, else group k // 4 of the
    lane-major copy (lane_rows, read at the kernel's float4 index); M_j =
    e + max(M_{j-1}, B + tr_B_Mk), M_{j-1} from the lane's own slot, lane l -
    1's last (a shuffle) or block r - 1's last (the exchange's halo); E a
    max in two chains a lane, the warp's redux of order keys, the blocks'
    keys; then J, C, N, B. Returns (scores, m, s) as msv_scan_plain."""
    m_pad = emit.shape[1]
    lanes, per = msv_cuda.kernel_case(m_pad)
    c = msv_cuda.cluster_blocks(lanes)
    assert msv_cuda.wide_cluster_case(lanes, per) and c == 16
    s_n = msv_cuda.wide_staged(per)
    low4 = (per - s_n) // 4
    tab = emit.float().numpy()
    # the block's shared table: i = aa * 32 S + l * S + s -> state (32 r + l) * per + 4 low4 + s
    k_row = 32 * s_n
    i = np.arange(20 * k_row)
    aa, w = i // k_row, i % k_row
    lane, slot = w // s_n, w % s_n
    smem = np.empty((c, 20 * k_row), dtype=F32)
    for r in range(c):
        col = (r * 32 + lane) * per + 4 * low4 + slot
        smem[r] = np.where(col < m_pad, tab[aa, np.minimum(col, m_pad - 1)], NEG_INF)
    smem = smem.reshape(c, 20, 32, s_n)
    # the lane-major copy: float4 index ((aa * C + r) * low4 + g) * 32 + l
    low = msv_cuda.lane_rows(emit.unsqueeze(0), per).numpy().reshape(-1, 4)
    g = np.arange(low4)
    idx = ((np.arange(20)[:, None, None, None] * c + np.arange(c)[None, :, None, None]) * low4
           + g[None, None, None, :]) * 32 + np.arange(32)[None, None, :, None]
    lows = low[idx].reshape(20, c, 32, 4 * low4)  # [aa, r, l, k < 4 low4]
    entries = np.concatenate([lows, smem.transpose(1, 0, 2, 3)], axis=3)  # [aa, r, l, per]
    assert entries.shape == (20, c, 32, per)

    tr_b_mk, tr_e_c, tr_e_j = (F32(x) for x in tr_consts.numpy())
    n = c * 32 * per
    m = np.full((tokens.shape[0], n), NEG_INF, dtype=F32)
    m[:, :m_pad] = m_in.numpy()
    st_j, st_c, st_n, st_b = (x.copy() for x in s_in.numpy())
    tr_loop, tr_move = tr_rows.numpy()
    toks = tokens.numpy().astype(np.int64).clip(0, 19)
    lens = lengths.numpy()
    for t in range(int(lens.max())):
        valid = t < lens
        e = entries[toks[:, t]]  # [B, r, l, k]: every state's entry this step
        old = m.reshape(-1, c, 32, per)
        prev = np.empty_like(old)
        prev[..., 1:] = old[..., :-1]  # the lane's own slots
        prev[:, :, 1:, 0] = old[:, :, :-1, per - 1]  # lane l - 1's last (the shuffle)
        prev[:, 1:, 0, 0] = old[:, :-1, 31, per - 1]  # block r - 1's last (the halo)
        prev[:, 0, 0, 0] = NEG_INF
        bt = (st_b + tr_b_mk).astype(F32)
        blk = (e + np.maximum(prev, bt[:, None, None, None])).astype(F32)
        new = blk.reshape(-1, n)
        lane_max = np.maximum(blk[..., 0::2].max(axis=3), blk[..., 1::2].max(axis=3))
        key = _order_key(lane_max).max(axis=2).max(axis=1)  # the warp's redux, the blocks'
        e_st = _key_float(key)
        nj = np.maximum(st_j + tr_loop, e_st + tr_e_j).astype(F32)
        nc = np.maximum(st_c + tr_loop, e_st + tr_e_c).astype(F32)
        nn = (st_n + tr_loop).astype(F32)
        nb = np.maximum(nn + tr_move, nj + tr_move).astype(F32)
        m = np.where(valid[:, None], new, m)
        st_j, st_c, st_n, st_b = (np.where(valid, a, b) for a, b in
                                  ((nj, st_j), (nc, st_c), (nn, st_n), (nb, st_b)))
    return (st_c + tr_move).astype(F32), m[:, :m_pad], np.stack([st_j, st_c, st_n, st_b])


@pytest.mark.parametrize("mode", ["exact", "filter"])
def test_msv_wide_model_matches_plain(join, staged, mode):
    """The MSV case past 38,912 states at LENG 60362 (16 blocks of 120
    states a lane, 84 staged) modelled in NumPy with the kernel's index
    math (_msv_wide_model): scores, M and the specials equal msv_scan_plain
    (exact) or msv_filter_scan_plain bit for bit, exact equals
    msv_oracle_batch, the filter is >= exact, and a two-call carry chain
    split at 17 equals one call."""
    hmm, jax_hmm = join
    tokens, st = staged
    msv = MSVProfile.from_profile(hmm)
    m_pad = msv_cuda.round_up(msv.num_states, 8)
    assert m_pad == 60368 and msv_cuda.kernel_case(m_pad) == (512, 120)
    pack = (msv_cuda.pack_profile if mode == "exact" else msv_cuda.pack_profile_filter)
    emit, consts = pack(msv, m_pad, "cpu")
    plain = msv_cuda.msv_scan_plain if mode == "exact" else msv_cuda.msv_filter_scan_plain
    m0, s0 = msv_cuda.init_carry(st.tr_rows, m_pad)
    args = (st.tokens, st.lengths, st.tr_rows)
    want = plain(emit, *args, consts, m0, s0)
    got = _msv_wide_model(emit, consts, *args, m0, s0)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    if mode == "exact":
        assert np.array_equal(got[0], msv_oracle_batch(JaxMSVProfile.from_profile(jax_hmm),
                                                       tokens, LENGTHS))
    else:
        exact = msv_cuda.msv_scan_plain(msv_cuda.pack_profile(msv, m_pad, "cpu")[0], *args,
                                        consts, m0, s0)[0].numpy()
        assert np.all(got[0] >= exact)
    split = 17
    first = _msv_wide_model(emit, consts, st.tokens[:, :split].contiguous(),
                            st.lengths.clamp(max=split), st.tr_rows, m0, s0)
    second = _msv_wide_model(emit, consts, st.tokens[:, split:].contiguous(),
                             (st.lengths - split).clamp(min=0), st.tr_rows,
                             torch.from_numpy(first[1]), torch.from_numpy(first[2]))
    for g, w in zip(second, got):
        assert np.array_equal(g, w)


def test_msv_lane_rows_index():
    """lane_rows holds state (32 r + l) * per + 4 g + i of row aa at (aa, r,
    g, l, i), -inf past M_pad, for the lanes' first per - wide_staged(per)
    states; a bf16 table is widened exactly."""
    rng = np.random.default_rng(7)
    m_pad = 40968
    per = msv_cuda.kernel_case(m_pad)[1]
    emit = torch.from_numpy(rng.normal(size=(2, 20, m_pad)).astype(F32))
    rows = msv_cuda.lane_rows(emit, per)
    low = per - msv_cuda.wide_staged(per)
    assert rows.shape == (2, 20, 16, low // 4, 32, 4) and rows.is_contiguous()
    for p, aa, r, g, lane, i in ((0, 0, 0, 0, 0, 0), (1, 19, 15, low // 4 - 1, 31, 3),
                                 (0, 7, 9, 0, 17, 2), (1, 3, 15, 0, 31, 0)):
        j = (32 * r + lane) * per + 4 * g + i
        want = emit[p, aa, j] if j < m_pad else float("-inf")
        assert rows[p, aa, r, g, lane, i] == want
    bf = emit.to(torch.bfloat16)
    assert torch.equal(msv_cuda.lane_rows(bf, per), msv_cuda.lane_rows(bf.float(), per))


# -- the Viterbi filter on 13 256-thread blocks ------------------------------------

def _filter_wide_model(pack, st, carry):
    """csrc/p7_viterbi.cuh::run_chunk's filter step at KT = 256 on a C-block
    cluster (viterbi_wide_cluster_kernel) in float32 torch ops, step for
    step: block r holds states r * 256 * per + t * per + k; the transition
    rows the plan stages read at sidx of the block's slice, the others and
    every chain row from the block's slice of their thread-major copy
    (case_rows: block_rows at 256 threads, fill -inf) at (q * per + k) * 256 +
    t; the bf16 emission rows widened; the shifts by one and the window's
    passes as the cluster takes them (_kernel_cluster_shift at 256
    threads: halos below per, the larger shifts by 32 and 64 through the
    landing rows); the tail max(a0) + aux over the cluster's warps on every
    state below M_pad; E the cluster's max. Returns (scores, m, i, d, s)."""
    m_pad = pack.m_pad
    kt, per = p7_cuda.kernel_case(m_pad, "filter")
    c = p7_cuda.cluster_blocks(m_pad, "filter")
    n = c * kt * per
    full = p7_cuda.chain_passes(m_pad)
    passes = pack.window
    plan = p7_cuda.plan_launch("filter", m_pad, passes, B, 200, SMS)
    assert plan.wide_cluster and plan.n_chain == 0
    tm = p7_cuda.case_rows(plan, pack.trans, pack.chain, passes, "cpu",
                           fill=float("-inf")).reshape(c, 6 + passes, per, kt)
    sidx = _sidx_row(kt * per, per)

    def const(q):
        """Row q (a transition, or chain pass q - 6) as a block reads it."""
        rows = []
        for r in range(c):
            if q < plan.n_trans:  # stage_row: the slice at sidx, fill -inf past M_pad
                width = kt * p7_cuda.blocked_stride(per)
                staged = torch.full((width,), float("-inf"))
                col = r * kt * per + torch.arange(kt * per)
                src = pack.trans[q] if q < 6 else pack.chain[q - 6]
                staged[sidx] = torch.where(col < m_pad, src[col.clamp(max=m_pad - 1)],
                                           torch.tensor(float("-inf")))
                rows.append(staged[sidx])
            else:  # TransRows / the chain's fallback: (q * per + k) * 256 + t
                rows.append(tm[r, q].t().reshape(-1))
        return torch.cat(rows)

    tmm, tmi, tmd, tim, tii, tdm = (const(q) for q in range(6))
    chain = [const(6 + p) for p in range(passes)]

    def pad(x, fill=float("-inf")):
        return torch.nn.functional.pad(x, (0, n - m_pad), value=fill)

    msc, isc = pad(pack.emit_m.float()), pad(pack.emit_i.float())

    def shift(x, s):
        return _kernel_cluster_shift(x, s, per, float("-inf"), c, kt)

    tr_b_mk, tr_e_c, tr_e_j, aux = pack.consts
    tr_loop, tr_move = st.tr_rows
    m, i, d = (pad(x) for x in carry[:3])
    s = tuple(carry[3])
    real = torch.arange(n) < m_pad
    toks = st.tokens.long().clamp(0, 19)
    for step in range(int(st.lengths.max())):
        sj, sc, sn, sb = s
        diag = shift(torch.maximum(torch.maximum(m + tmm, i + tim), d + tdm), 1)
        nm = msc[toks[:, step]] + torch.maximum(diag, (sb + tr_b_mk)[:, None])
        ni = isc[toks[:, step]] + torch.maximum(m + tmi, i + tii)
        pd = nm + tmd
        a_max = pd.reshape(-1, c * kt // 32, 32 * per).amax(dim=2).amax(dim=1)
        ac = shift(pd, 1)
        for p in range(passes):
            ac = torch.maximum(ac, shift(ac, 1 << p) + chain[p])
        if passes < full:
            ac = torch.where(real, torch.maximum(ac, (a_max + aux)[:, None]), ac)
        e = (nm if pack.e_skip_d else torch.maximum(nm, ac)).amax(dim=1)
        new = (nm, ni, ac, *p7_cuda._specials(e, sj, sc, sn, tr_loop, tr_move, tr_e_c, tr_e_j))
        valid = step < st.lengths
        m, i, d, *s = p7_cuda._freeze(valid, new, (m, i, d, *s))
    return (s[1] + tr_move, m[:, :m_pad], i[:, :m_pad], d[:, :m_pad], torch.stack(list(s)))


def test_filter_wide_model_matches_plain(join, staged):
    """The Viterbi filter on its C-block cluster of 13 256-thread blocks of
    19 states a thread at LENG 60362, at its auto window (7 of 16 passes:
    the tail term on), modelled step for step (_filter_wide_model: the
    staged and thread-major constant rows, the cluster's shifts by 1..64,
    the tail from the cluster's max(a0)): scores and every carry equal
    viterbi_filter_scan_plain bit for bit, and its scores are >= the plain
    eager Viterbi's."""
    hmm, _ = join
    _, st = staged
    p7 = P7Profile.from_profile(hmm)
    pack = p7_cuda.filter_pack(p7, "cpu")
    assert (pack.m_pad, pack.window, p7_cuda.chain_passes(pack.m_pad)) == (60368, 7, 16)
    assert p7_cuda.kernel_case(pack.m_pad, "filter") == (256, 19)
    assert p7_cuda.cluster_blocks(pack.m_pad, "filter") == 13
    run, carry = chip_smoke.p7_calls("filter", pack, st)
    want = run(chip_smoke.PLAIN_FNS["filter"], st.tokens, st.lengths, carry)
    got = _filter_wide_model(pack, st, carry)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    eager = p7_cuda.viterbi_pack(p7, "cpu", lazy=False)
    run_e, carry_e = chip_smoke.p7_calls("eager", eager, st)
    exact = run_e(chip_smoke.PLAIN_FNS["eager"], st.tokens, st.lengths, carry_e)[0]
    assert torch.all(got[0] >= exact)


def test_plain_filter_matches_jax_past_38912(join, staged):
    """At LENG 60362 the plain Viterbi filter (viterbi_filter_scores on the
    CPU) equals the JAX filter kernel, viterbi_filter_pallas(interpret=True),
    on the first 16 residues of the 4 sequences bit for bit."""
    hmm, jax_hmm = join
    tokens, _ = staged
    short = np.minimum(LENGTHS, 16)
    p7 = P7Profile.from_profile(hmm)
    got = viterbi_filter_scores(p7, tokens[:, :16], short, device="cpu").numpy()
    want = np.asarray(pallas_p7.viterbi_filter_pallas(JaxP7Profile.from_profile(jax_hmm),
                                                      tokens[:, :16], short, l_chunk=16,
                                                      interpret=True))
    assert np.array_equal(got, want)
