"""The PyTorch port's prefilters on the CPU: the bf16 round-up packers, the
plain MSV filter and the plain Viterbi filter, against the JAX package's
packers and its Pallas kernels in interpret mode.

Every comparison here is bitwise (tolerance 0.0): the packers must give
the JAX arrays byte for byte, and the plain filters the JAX kernels'
scores bit for bit. Each filter must also bound its exact oracle from
above on every sequence (filter >= exact, tolerance 0.0). The port gets
its own copies of the JAX profiles (convert.*_profile_from_jax).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import parse_hmm
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile
from hmm_fasta_viterbi_tpu.ops import pallas_msv, pallas_p7
from hmm_fasta_viterbi_tpu.ops.reference import msv_oracle_batch, viterbi_oracle_batch
from hmm_fasta_viterbi_tpu_torch import convert
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda, p7_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import (
    MSVScanner, viterbi_filter_scores, viterbi_scores,
)

STEMS = ("100", "200", "1400")
L_CHUNK = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here:
    the workers of a parallel test run share the machine's cores, and many
    threads a worker on such ops mostly wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(profile):
    """The port's copy of a JAX MSVProfile or P7Profile."""
    if isinstance(profile, P7Profile):
        return convert.p7_profile_from_jax(profile)
    return convert.msv_profile_from_jax(profile)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def _widen(bits) -> np.ndarray:
    """The f32 values of bf16 bit patterns (exact)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


@pytest.fixture(scope="module")
def profiles(profile_dir):
    out = {}
    for stem in STEMS:
        hmm = parse_hmm(profile_dir / f"{stem}.hmm")
        out[stem] = (MSVProfile.from_profile(hmm), P7Profile.from_profile(hmm))
    return out


@pytest.fixture(scope="module")
def batch():
    """48 random sequences up to 300 residues, the empty one among them."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 20, size=(48, 300)).astype(np.int32)
    lengths = rng.integers(0, 301, size=48).astype(np.int32)
    lengths[:5] = [0, 1, 63, 64, 300]
    return tokens, lengths


def _no_e_skip_d(p7, field="tdd"):
    """A profile whose positive tdd (the filter then runs the full chain) or
    positive tmd (the window stays truncated, so the tail reaches E) breaks
    e_skip_d_ok: E must include D."""
    vec = getattr(p7, field)
    bad = type(p7)(**{**p7.__dict__, field: np.where(
        np.isfinite(vec), np.float32(0.01), vec).astype(np.float32)})
    assert not p7_cuda.e_skip_d_ok(_port(bad))
    return bad


def _filter_geq(got, exact) -> bool:
    """filter >= exact on every sequence (both -inf for an empty one)."""
    return bool(np.all((got >= exact) | (np.isneginf(got) & np.isneginf(exact))))


# -- packers -----------------------------------------------------------------

def test_bf16_round_up_edge_values():
    """±0, ±inf, PAD_SCORE, exact bf16 values, subnormals, values that
    round to nearest below or above, and the largest finite f32: byte-equal
    to JAX, every output >= its input, exact bf16 values unchanged."""
    rng = np.random.default_rng(0)
    exact_bf16 = np.array([1.0, -2.5, 0.15625, -96.0, 2.0**100], dtype=np.float32)
    x = np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, msv_cuda.PAD_SCORE, 1e-40, -1e-40, 1.0000001,
                  -1.0000001, 3.4028235e38, -3.4028235e38, 1.17e-38, -1.17e-38],
                 dtype=np.float32),
        exact_bf16,
        rng.normal(0, 10, 4000).astype(np.float32),
        (rng.random(1000) * 1e-38).astype(np.float32) * rng.choice([-1, 1], 1000),
    ]).astype(np.float32)
    got = msv_cuda.bf16_round_up(x)
    assert got.dtype == np.uint16
    assert np.array_equal(got, _bits(pallas_msv.bf16_round_up(x)))
    widened = _widen(got)
    assert np.all(widened >= x)
    n0 = 13
    assert np.array_equal(widened[n0:n0 + len(exact_bf16)], exact_bf16)
    assert got[0] == 0x0000 and got[1] == 0x8000 and got[2] == 0x7F80 and got[3] == 0xFF80


def test_staging_widening_equals_torch_bf16_to_f32():
    """The kernel stages the filter's bf16 table as f32 by ``bits << 16``
    (csrc/msv_kernel.cu, Entries<uint16_t>::at); the plain version widens
    with ``emit.float()``. Both give the same f32 bits for all 65,536 bf16
    patterns, NaN payloads and both zeros and infinities included."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    staged = (bits.astype(np.uint32) << 16).view(np.float32)
    plain = msv_cuda.bf16_tensor(bits, "cpu").float().numpy()
    assert np.array_equal(staged.view(np.uint32), plain.view(np.uint32))
    nan = np.isnan(staged)
    assert int(nan.sum()) == 2 * 127  # exponent all ones, a nonzero mantissa, either sign
    assert np.array_equal(plain.view(np.uint32)[nan] >> 16, bits[nan].astype(np.uint32))
    assert np.array_equal(_widen(bits).view(np.uint32), staged.view(np.uint32))


def test_f32_round_up_matches_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 5, 500), [0.0, -0.0, np.inf, -np.inf, -1e30]]).astype(
        np.float32)
    got = msv_cuda.f32_round_up(x)
    assert got.tobytes() == np.asarray(pallas_msv.f32_round_up(x)).tobytes()
    assert np.all(got >= x)


def test_msv_filter_packer_every_profile(all_profile_paths):
    """prepare_scores_t_filter is byte-equal to JAX's at JAX's filter M_pad
    (round_up(Mr + 1, 256)) on all 24 profiles."""
    for path in all_profile_paths:
        prof = MSVProfile.from_profile(parse_hmm(path))
        m_pad = msv_cuda.round_up(prof.num_states + 1, 256)
        got = msv_cuda.prepare_scores_t_filter(_port(prof), m_pad)
        assert np.array_equal(got, _bits(pallas_msv.prepare_scores_t_filter(prof, m_pad))), path


def test_neg_inf_score_clamped_before_round_up(profiles):
    """A -inf emission score is clamped to PAD_SCORE before the bf16
    round-up, as JAX's packer does: the filter table stays finite there and
    byte-equal to JAX's."""
    prof = copy.copy(profiles["100"][0])
    scores = prof.scores_real.copy()
    scores[3, 7] = -np.inf
    scores[0, 0] = -np.inf
    prof.scores_real = scores
    got = msv_cuda.prepare_scores_t_filter(_port(prof))
    assert np.array_equal(got, _bits(pallas_msv.prepare_scores_t_filter(prof)))
    assert np.isfinite(_widen(got)).all()
    assert _widen(got)[7, 3] >= msv_cuda.PAD_SCORE


def test_viterbi_filter_packer_every_profile_and_window(all_profile_paths):
    """prepare_p7_device_filter (tables, chain constants, aux, window,
    e_skip_d) and pick_filter_window are byte-equal to JAX's on all 24
    profiles, for the auto window and every window 1..full_passes + 1."""
    for path in all_profile_paths:
        p7 = P7Profile.from_profile(parse_hmm(path))
        port = _port(p7)
        m_pad = p7_cuda.default_m_pad(port)
        full = p7_cuda.chain_passes(m_pad)
        assert p7_cuda.pick_filter_window(port, m_pad) == pallas_p7.pick_filter_window(p7, m_pad)
        for window in (None, *range(1, full + 2)):
            want = pallas_p7.prepare_p7_device_filter(p7, window_log2=window)
            got = p7_cuda.prepare_p7_device_filter(port, window_log2=window)
            assert np.array_equal(got[0], _bits(want[0])) and np.array_equal(got[1], _bits(want[1]))
            for g, w in zip(got[2:5], want[2:5]):
                assert g.tobytes() == np.asarray(w).tobytes(), (path, window)
            assert tuple(got[5:]) == tuple(want[5:]), (path, window)


def test_filter_window_auto_truncates_and_full_when_tdd_positive(profiles):
    """The auto window truncates the chain on 1400.hmm (4 of 11 passes, aux
    finite); a profile with a positive tdd runs the full chain with aux
    -inf. Both byte-equal to JAX."""
    p7 = profiles["1400"][1]
    for prof, window, finite_aux in ((p7, 4, True), (_no_e_skip_d(p7), 11, False)):
        got = p7_cuda.prepare_p7_device_filter(_port(prof))
        want = pallas_p7.prepare_p7_device_filter(prof)
        assert got[5] == want[5] == window
        assert got[4].tobytes() == np.asarray(want[4]).tobytes()
        assert np.isfinite(got[4][0, 3]) == finite_aux


# -- the plain MSV filter ------------------------------------------------------

def _jax_msv_filter(prof, tokens, lengths):
    tokens_t, lengths_p, tr_rows, b, l_chunk = pallas_msv._prepare_batch(tokens, lengths, L_CHUNK)
    m_pad = msv_cuda.round_up(prof.num_states + 1, 256)
    scores_t = pallas_msv.prepare_scores_t_filter(prof, m_pad)[None]
    consts = np.array([[prof.tr_B_Mk, prof.tr_E_C, prof.tr_E_J]], dtype=np.float32)
    out = pallas_msv._msv_pallas_padded(
        jnp.asarray(scores_t), jnp.asarray(tokens_t), jnp.asarray(lengths_p),
        jnp.asarray(tr_rows), jnp.asarray(consts), l_chunk=l_chunk, interpret=True,
        exact=False, skip_row0_guard=True,
    )
    return np.asarray(out)[0, :b]


@pytest.mark.parametrize("stem", STEMS)
def test_msv_filter_plain_matches_jax_interpret(profiles, batch, stem):
    """scan_filter on the CPU == JAX's filter kernel bit for bit (tolerance
    0.0), and >= the exact oracle on every sequence."""
    prof = profiles[stem][0]
    port = _port(prof)
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    got = sc.scan_filter(port, sc.stage(tokens, lengths)).numpy()
    assert np.array_equal(got, _jax_msv_filter(prof, tokens, lengths))
    exact = msv_oracle_batch(prof, tokens, lengths)
    assert _filter_geq(got, exact)
    assert (got > exact).any()  # the round-up is live
    assert sc._cache_get((id(port), "filter"), port) is not None


def test_msv_filter_carry_chain(profiles, batch):
    """Two filter calls split at 100 residues == one call: scores, M row
    and specials (tolerance 0.0)."""
    prof = _port(profiles["200"][0])
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    emit, consts = msv_cuda.pack_profile_filter(prof, msv_cuda.round_up(prof.num_states, 8), "cpu")
    assert emit.dtype == torch.bfloat16
    m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
    args = (staged.lengths, staged.tr_rows, consts)
    whole = msv_cuda.msv_filter_scan(emit, staged.tokens, *args, m, s)
    split = 100
    first = msv_cuda.msv_filter_scan(emit, staged.tokens[:, :split].contiguous(),
                                     staged.lengths.clamp(max=split), *args[1:], m, s)
    second = msv_cuda.msv_filter_scan(emit, staged.tokens[:, split:].contiguous(),
                                      (staged.lengths - split).clamp(min=0), *args[1:],
                                      first[1], first[2])
    for g, w in zip(second, whole):
        assert torch.equal(g, w)


# -- the plain Viterbi filter --------------------------------------------------

@pytest.mark.parametrize("stem,window,no_e_skip", [
    ("100", None, None), ("100", 1, None), ("100", 3, None), ("100", 3, "tdd"),
    ("100", None, "tdd"), ("100", None, "tmd"), ("100", 1, "tmd"), ("200", 2, None),
    ("1400", None, None), ("1400", 2, None),
])
def test_viterbi_filter_plain_matches_jax_interpret(profiles, batch, stem, window, no_e_skip):
    """The plain Viterbi filter == viterbi_filter_pallas(interpret=True) bit
    for bit (tolerance 0.0) for auto and truncated windows, with and without
    e_skip_d (E over M and D, the tail included), and >= the exact Viterbi
    oracle on every sequence."""
    p7 = profiles[stem][1]
    if no_e_skip:
        p7 = _no_e_skip_d(p7, no_e_skip)
    tokens, lengths = batch
    got = viterbi_filter_scores(_port(p7), tokens, lengths, device="cpu",
                                window_log2=window).numpy()
    want = np.asarray(pallas_p7.viterbi_filter_pallas(
        p7, tokens, lengths, l_chunk=L_CHUNK, interpret=True, window_log2=window))
    assert np.array_equal(got, want)
    # the NumPy oracle takes half a minute on 48 x 300 at M = 1400: there it
    # sees 8 sequences, and the plain eager scan (equal to it bit for bit,
    # tests/test_torch_p7.py) the whole batch
    n = 8 if stem == "1400" else len(lengths)
    assert _filter_geq(got[:n], viterbi_oracle_batch(p7, tokens[:n], lengths[:n]))
    eager = viterbi_scores(_port(p7), tokens, lengths, device="cpu", lazy=False).numpy()
    assert _filter_geq(got, eager)


def test_viterbi_filter_tail_is_live(profiles, batch):
    """At window 1 on 100.hmm the tail term lands on every row (row 0 and
    the pad rows included): the scores differ from the full-chain filter's
    and still equal JAX's (tolerance 0.0)."""
    p7 = _port(profiles["100"][1])
    tokens, lengths = batch
    w1 = viterbi_filter_scores(p7, tokens, lengths, device="cpu", window_log2=1).numpy()
    full = viterbi_filter_scores(p7, tokens, lengths, device="cpu").numpy()
    assert _filter_geq(w1, full) and (w1 > full).any()


@pytest.mark.parametrize("window", [None, 2])
def test_viterbi_filter_carry_chain(profiles, batch, window):
    """Two Viterbi filter calls split at 100 residues == one call: scores
    and every carry (M, I, D, J/C/N/B; tolerance 0.0)."""
    p7 = _port(profiles["100"][1])
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    pack = p7_cuda.filter_pack(p7, "cpu", window_log2=window)
    carry = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)

    def run(tok, lens, c):
        return p7_cuda.viterbi_filter_scan(*pack[:4], tok, lens, staged.tr_rows, pack.consts,
                                           *c, pack.window, pack.e_skip_d)

    whole = run(staged.tokens, staged.lengths, carry)
    split = 100
    first = run(staged.tokens[:, :split].contiguous(), staged.lengths.clamp(max=split), carry)
    second = run(staged.tokens[:, split:].contiguous(), (staged.lengths - split).clamp(min=0),
                 first[1:5])
    for g, w in zip(second, whole):
        assert torch.equal(g, w)


def test_scan_p7_filter_cache_and_entry(profiles, batch):
    """scan_p7_filter caches its pack under (id(p7), "p7_filter",
    window_log2) and equals the host entry viterbi_filter_scores."""
    p7 = _port(profiles["200"][1])
    tokens, lengths = batch
    sc = MSVScanner(device="cpu")
    staged = sc.stage(tokens, lengths)
    got = sc.scan_p7_filter(p7, staged)
    assert sc._cache_get((id(p7), "p7_filter", None), p7) is not None
    assert torch.equal(got, viterbi_filter_scores(p7, tokens, lengths, device="cpu"))
    assert torch.equal(sc.scan_p7_filter(p7, staged, window_log2=2),
                       viterbi_filter_scores(p7, tokens, lengths, device="cpu", window_log2=2))


# -- convert -------------------------------------------------------------------

def test_convert_filter_packs_round_trip(profiles):
    """The JAX packers' arrays carried into the port give the port's own
    packs, number for number: the MSV filter table, the stacked sweep packs
    in both modes and the Viterbi filter pack."""
    prof, p7 = profiles["200"]
    jax_table = pallas_msv.prepare_scores_t_filter(prof, msv_cuda.round_up(prof.num_states + 1,
                                                                           256))[None]
    consts = np.array([[prof.tr_B_Mk, prof.tr_E_C, prof.tr_E_J]], dtype=np.float32)
    emit, tc = convert.filter_profile_from_jax(jax_table, consts, prof.num_states, "cpu")
    own = msv_cuda.pack_profile_filter(_port(prof), emit.shape[1], "cpu")
    assert torch.equal(emit.view(torch.int16), own[0].view(torch.int16))
    assert torch.equal(tc, own[1])

    group = [profiles[s][0] for s in ("100", "200")]
    m_pad = msv_cuda.round_up(max(p.num_states for p in group), 8)
    jax_consts = np.array([[p.tr_B_Mk, p.tr_E_C, p.tr_E_J] for p in group], dtype=np.float32)
    for filt, prep in ((False, pallas_msv.prepare_scores_t),
                       (True, pallas_msv.prepare_scores_t_filter)):
        jax_stack = np.stack([prep(p, 256) for p in group])
        emit, tc = convert.stacked_profiles_from_jax(
            jax_stack, jax_consts, [p.num_states for p in group], "cpu")
        own_emit, own_tc = msv_cuda.pack_stacked([_port(p) for p in group], m_pad, "cpu",
                                                 filter_mode=filt)
        assert emit.dtype == own_emit.dtype == (torch.bfloat16 if filt else torch.float32)
        assert torch.equal(emit.view(torch.int16) if filt else emit,
                           own_emit.view(torch.int16) if filt else own_emit)
        assert torch.equal(tc, own_tc)

    for window in (None, 3):
        pack = convert.p7_filter_pack_from_jax(
            *pallas_p7.prepare_p7_device_filter(p7, window_log2=window), device="cpu")
        own = p7_cuda.filter_pack(_port(p7), "cpu", window_log2=window)
        for g, w in zip(pack[:5], own[:5]):
            assert g.dtype == w.dtype and torch.equal(g.view(torch.int16) if g.dtype ==
                                                      torch.bfloat16 else g,
                                                      w.view(torch.int16) if w.dtype ==
                                                      torch.bfloat16 else w)
        assert pack[5:] == own[5:]
