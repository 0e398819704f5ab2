"""The PyTorch port's Viterbi and Forward scans (their plain versions, which
CPU tensors run) against the JAX package's Pallas kernels in interpret
mode, its host packers and the NumPy oracles.

Tolerances are the JAX suite's own: Viterbi 1e-4 against the oracle, with
0.0 expected against the JAX kernel (same operands, same operation order);
the lazy scan equals the eager one bit for bit; Forward 2e-3. The
log-space Forward is held to 1e-4 against the JAX log-space kernel (the
same semiring with the same operands; the logarithms and the E sum's order
round differently) and 2e-3 against the oracle. The port gets its own
copies of the JAX profiles (convert.p7_profile_from_jax).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import parse_hmm, parse_hmm_text
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile
from hmm_fasta_viterbi_tpu.ops import pallas_p7
from hmm_fasta_viterbi_tpu.ops.reference import forward_oracle_batch, viterbi_oracle_batch
from hmm_fasta_viterbi_tpu_torch import convert
from hmm_fasta_viterbi_tpu_torch.ops import p7_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner, forward_scores, viterbi_scores

from test_hmm_parsing import MINI_HMM

VIT_TOL = 1e-4
FWD_TOL = 2e-3
LOG_FWD_TOL = 1e-4
RAGGED = np.array([64, 1, 33, 128, 17, 2, 0, 100], dtype=np.int32)


def _p7(profile_dir, stem):
    if stem == "mini":
        return P7Profile.from_profile(parse_hmm_text(MINI_HMM))
    return P7Profile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))


def _port(p7):
    """The port's copy of a JAX P7Profile."""
    return convert.p7_profile_from_jax(p7)


def _weak_damping(p7):
    """Near-free deletions (tdd = log 0.98): long delete runs compete, so a
    one-pass lazy window must fire (JAX test_lazy_viterbi_weak_damping_profile)."""
    tdd = np.where(np.isfinite(p7.tdd), np.float32(np.log(0.98)), p7.tdd).astype(np.float32)
    return dataclasses.replace(p7, tdd=tdd)


def _tokens(seed, batch, width):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 20, size=(batch, width)).astype(np.int32)


def _staged(tokens, lengths):
    return MSVScanner(device="cpu").stage(tokens, lengths)


def _viterbi_args(pack, staged):
    return (*pack[:4], staged.tokens, staged.lengths, staged.tr_rows, pack.consts,
            *p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad))


def _pre_diag(pack, m, i, d):
    """The lazy kernel's d slot, from the eager kernel's carries."""
    tmm, _, _, tim, _, tdm = pack.trans[:6]
    return torch.maximum(torch.maximum(m + tmm, i + tim), d + tdm)


# -- host packers ----------------------------------------------------------

@pytest.mark.parametrize("stem", ["100", "200", "1400", "2405", "mini"])
def test_packers_byte_equal_to_jax(profile_dir, stem):
    p7 = _p7(profile_dir, stem)
    for got, want in zip(p7_cuda.prepare_p7_device(_port(p7)), pallas_p7.prepare_p7_device(p7)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got_lazy = p7_cuda.prepare_p7_device_lazy(_port(p7))
    want_lazy = pallas_p7.prepare_p7_device_lazy(p7)
    assert got_lazy[5] == want_lazy[5]
    for got, want in zip(got_lazy[:5], want_lazy[:5]):
        assert got.tobytes() == want.tobytes()
    for got, want in zip(p7_cuda.prepare_p7_device_prob(_port(p7)),
                         pallas_p7.prepare_p7_device_prob(p7)):
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert p7_cuda.e_skip_d_ok(_port(p7)) == pallas_p7.e_skip_d_ok(p7)
    assert p7_cuda.pick_prob_chain_window(_port(p7)) == pallas_p7.pick_prob_chain_window(p7)
    m_pad = p7_cuda.default_m_pad(_port(p7))
    assert p7_cuda.chain_passes(m_pad) == max(1, int(np.ceil(np.log2(m_pad))))


def test_lazy_packer_every_window_and_length_probs(profile_dir):
    p7 = _p7(profile_dir, "100")
    for k in range(1, 8):
        got = p7_cuda.prepare_p7_device_lazy(_port(p7), lazy_k=k)
        want = pallas_p7.prepare_p7_device_lazy(p7, lazy_k=k)
        assert got[5] == want[5] == k
        assert got[3].tobytes() == want[3].tobytes() and got[4].tobytes() == want[4].tobytes()
    lengths = np.array([0, 1, 7, 3500, 36864, 2**20])
    got = p7_cuda.length_transition_probs(lengths)
    assert got.tobytes() == pallas_p7.length_transition_probs(lengths).tobytes()


# -- eager Viterbi ---------------------------------------------------------

@pytest.mark.parametrize("stem,width", [("100", 128), ("mini", 32)])
def test_plain_eager_equals_jax_kernel_and_oracle(profile_dir, stem, width):
    p7 = _p7(profile_dir, stem)
    lengths = np.minimum(RAGGED, width)
    tokens = _tokens(1, len(lengths), width)
    got = viterbi_scores(_port(p7), tokens, lengths, device="cpu", lazy=False).numpy()
    want = np.asarray(pallas_p7.viterbi_pallas(p7, tokens, lengths, interpret=True, lazy=False))
    assert np.array_equal(got, want)  # max |d| = 0.0
    oracle = viterbi_oracle_batch(p7, tokens, lengths)
    np.testing.assert_allclose(got, oracle, atol=VIT_TOL, rtol=0)
    assert np.isneginf(got[lengths == 0]).all()


def test_plain_eager_with_carries_equals_jax_p7_pallas_call(profile_dir):
    """p7_pallas_call (interpret mode, eager Viterbi) and the port's
    viterbi_scan from the same non-trivial carries, carried over by
    convert.py: scores and every carry are equal."""
    p7 = _p7(profile_dir, "100")
    b, width = 4, 48
    tokens = _tokens(2, b, width)
    lengths = np.full(b, width, dtype=np.int32)
    tokens_t, lengths_p, tr_rows, _, l_chunk = pallas_p7._prepare_tokens(tokens, lengths, width)
    packed = pallas_p7.prepare_p7_device(p7)
    m_pad, b_pad = packed[0].shape[0], tokens_t.shape[1]
    rng = np.random.default_rng(3)
    mr = p7.num_states
    carries = []
    for _ in range(3):
        c = np.full((m_pad, b_pad), -np.inf, dtype=np.float32)
        c[:mr] = rng.normal(-9.0, 3.0, size=(mr, b_pad)).astype(np.float32)
        carries.append(c)
    s_init = rng.normal(-6.0, 2.0, size=(4, b_pad)).astype(np.float32)
    score, m_out, i_out, d_out, s_out = pallas_p7.p7_pallas_call(
        *(jnp.asarray(x) for x in packed[:4]), jnp.asarray(tokens_t, dtype=jnp.int32),
        jnp.asarray(lengths_p), jnp.asarray(tr_rows), jnp.asarray(packed[4]),
        *(jnp.asarray(c) for c in carries), jnp.asarray(s_init),
        l_chunk=l_chunk, interpret=True,
    )

    staged = convert.staged_from_jax(tokens_t, lengths_p, tr_rows, b, "cpu")
    pack = convert.p7_pack_from_jax(*packed, "cpu")
    carry = convert.p7_carry_from_jax(*carries, s_init, "cpu")
    got = p7_cuda.viterbi_scan(*pack[:4], staged.tokens, staged.lengths, staged.tr_rows,
                               pack.consts, *carry)
    # lanes past b have length 0: the TPU kernel lets their rows run on
    assert np.array_equal(got[0].numpy()[:b], np.asarray(score)[:b])
    for g, w in zip(got[1:4], (m_out, i_out, d_out)):
        assert np.array_equal(g.numpy()[:b], np.asarray(w).T[:b])
    assert np.array_equal(got[4].numpy(), np.asarray(s_out))


# -- lazy Viterbi ----------------------------------------------------------

@pytest.mark.parametrize("stem,width", [("100", 160), ("mini", 40), ("weak", 40)])
def test_plain_lazy_equals_eager_every_window(profile_dir, stem, width):
    """Scores and carries of the lazy scan equal the eager scan's bit for
    bit for every window 1..n_passes (the d slot holds the eager carries'
    pre_diag); on 100.hmm the one-pass window fires and replays, and
    stays equal."""
    p7 = _weak_damping(_p7(profile_dir, "mini")) if stem == "weak" else _p7(profile_dir, stem)
    lengths = np.minimum(np.array([width, width - 7, 1, 0, width], dtype=np.int32), width)
    staged = _staged(_tokens(4, len(lengths), width), lengths)
    eager_pack = p7_cuda.viterbi_pack(_port(p7), "cpu", lazy=False)
    eager = p7_cuda.viterbi_scan(*_viterbi_args(eager_pack, staged))
    n_passes = p7_cuda.chain_passes(eager_pack.m_pad)
    fired = 0
    for k in range(1, n_passes + 1):
        pack = p7_cuda.viterbi_pack(_port(p7), "cpu", lazy=True, lazy_k=k)
        assert pack.lazy_k == k
        lazy = p7_cuda.viterbi_lazy_scan(*_viterbi_args(pack, staged), k)
        assert torch.equal(lazy[0], eager[0])
        assert torch.equal(lazy[1], eager[1]) and torch.equal(lazy[2], eager[2])
        assert torch.equal(lazy[3], _pre_diag(eager_pack, *eager[1:4]))
        assert torch.equal(lazy[4], eager[4])
        assert lazy[5].dtype == torch.int32 and int(lazy[5][3]) == 0  # empty sequence
        if k == n_passes:
            assert int(lazy[5].sum()) == 0  # the full chain needs no certificate
        fired += int(lazy[5].sum())
    if stem == "100":
        assert fired > 0, "the certificate never fired"
    oracle = viterbi_oracle_batch(p7, np.asarray(staged.tokens, dtype=np.int32), lengths)
    np.testing.assert_allclose(eager[0].numpy(), oracle, atol=VIT_TOL, rtol=0)


def test_weak_damping_lazy_equals_jax_lazy_kernel():
    """JAX's lazy kernel at lazy_k = 1 on the weak-damping profile (its
    certificate fires) and the port's agree bit for bit."""
    p7 = _weak_damping(P7Profile.from_profile(parse_hmm_text(MINI_HMM)))
    tokens = _tokens(23, 3, 40)
    lengths = np.array([40, 17, 40], dtype=np.int32)
    want = np.asarray(pallas_p7.viterbi_pallas(p7, tokens, lengths, interpret=True, lazy_k=1))
    got = viterbi_scores(_port(p7), tokens, lengths, device="cpu", lazy_k=1).numpy()
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, viterbi_oracle_batch(p7, tokens, lengths), atol=VIT_TOL, rtol=0)


# -- Forward ---------------------------------------------------------------

@pytest.mark.parametrize("stem,width", [("100", 128), ("mini", 32)])
def test_plain_forward_vs_jax_kernel_and_oracle(profile_dir, stem, width):
    p7 = _p7(profile_dir, stem)
    lengths = np.minimum(RAGGED, width)
    tokens = _tokens(6, len(lengths), width)
    got = forward_scores(_port(p7), tokens, lengths, device="cpu").numpy()
    want = np.asarray(pallas_p7.forward_pallas(p7, tokens, lengths, interpret=True))
    oracle = forward_oracle_batch(p7, tokens, lengths)
    assert np.isneginf(got[lengths == 0]).all() and np.isfinite(got[lengths > 0]).all()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=FWD_TOL, rtol=0)


def test_plain_log_forward_vs_jax_kernel_and_oracle(profile_dir):
    """forward_scores(prob_space=False) on the CPU (the plain log-space
    scan) against forward_pallas(prob_space=False, interpret=True): 1e-4;
    against the oracle: 2e-3; an empty sequence scores -inf."""
    p7 = _p7(profile_dir, "100")
    lengths = np.array([0, 1, 7, 33, 96], dtype=np.int32)
    tokens = _tokens(12, len(lengths), 96)
    got = forward_scores(_port(p7), tokens, lengths, device="cpu", prob_space=False).numpy()
    want = np.asarray(pallas_p7.forward_pallas(p7, tokens, lengths, interpret=True,
                                               prob_space=False))
    assert np.isneginf(got[0]) and np.isneginf(want[0]) and np.isfinite(got[1:]).all()
    np.testing.assert_allclose(got[1:], want[1:], atol=LOG_FWD_TOL, rtol=0)
    np.testing.assert_allclose(got, forward_oracle_batch(p7, tokens, lengths), atol=FWD_TOL,
                               rtol=0)
    prob = forward_scores(_port(p7), tokens, lengths, device="cpu").numpy()
    np.testing.assert_allclose(prob, got, atol=FWD_TOL, rtol=0)


def test_forward_ragged_long_tail_regression():
    """A short sequence beside a long one whose junk tail (token 0 = 'A',
    insert emissions biased towards it) grows the odds every step: the
    port freezes finished rows and specials, so the short sequence's C is
    never rescaled into underflow, even when its tail is not blanked
    (JAX test_forward_pallas_ragged_long_tail_regression)."""
    biased = MINI_HMM.replace("          3.0  ", "          0.05  ")
    p7 = P7Profile.from_profile(parse_hmm_text(biased))
    width = 512
    tokens = np.zeros((2, width), dtype=np.int32)
    tokens[0] = np.random.default_rng(7).integers(0, 20, size=width)
    lengths = np.array([width, 6], dtype=np.int32)
    want = forward_oracle_batch(p7, tokens, lengths)
    got = forward_scores(_port(p7), tokens, lengths, device="cpu").numpy()
    assert np.isfinite(got).all(), got
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)

    pack = p7_cuda.forward_pack(_port(p7), "cpu")
    tr_probs = torch.from_numpy(p7_cuda.length_transition_probs(lengths))
    staged = _staged(tokens, lengths)
    raw = p7_cuda.forward_prob_scan(
        *pack[:4], torch.from_numpy(tokens.astype(np.int8)), staged.lengths, staged.tr_rows,
        tr_probs, pack.consts, *p7_cuda.forward_init_carry(tr_probs, pack.m_pad),
    )[0].numpy()
    np.testing.assert_allclose(raw, want, atol=FWD_TOL, rtol=0)


def test_forward_long_l_accumulation_drift():
    """16384 residues, 2048 rescale groups: the Kahan-compensated log scale
    keeps the plain Forward within 5e-3 of the oracle (JAX
    test_forward_long_l_accumulation_drift, same gate)."""
    p7 = P7Profile.from_profile(parse_hmm_text(MINI_HMM))
    length = 16384
    tokens = _tokens(5, 1, length)
    lengths = np.array([length], dtype=np.int32)
    got = forward_scores(_port(p7), tokens, lengths, device="cpu").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, forward_oracle_batch(p7, tokens, lengths), atol=5e-3, rtol=0)


# -- carry chains ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["eager", "lazy", "lazy_k1", "forward", "forward_log"])
def test_carry_chain_equals_one_call(profile_dir, kind):
    """Two calls over L split at 40 (a multiple of FWD_RESCALE_GROUP; the
    second call takes the lengths less the split, clipped at 0) equal one
    call bit for bit, carries included."""
    split = 40
    assert split % p7_cuda.FWD_RESCALE_GROUP == 0
    p7 = _p7(profile_dir, "100")
    lengths = np.array([150, 93, 1, 0, 40, 41], dtype=np.int32)
    staged = _staged(_tokens(9, len(lengths), 150), lengths)
    if kind == "forward":
        pack = p7_cuda.forward_pack(_port(p7), "cpu")
        carry = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)

        def run(tokens, lens, c):
            return p7_cuda.forward_prob_scan(*pack[:4], tokens, lens, staged.tr_rows,
                                             staged.tr_probs, pack.consts, *c)
    elif kind == "forward_log":
        pack = p7_cuda.viterbi_pack(_port(p7), "cpu", lazy=False)
        carry = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)

        def run(tokens, lens, c):
            return p7_cuda.forward_log_scan(*pack[:4], tokens, lens, staged.tr_rows,
                                            pack.consts, *c)
    else:
        pack = p7_cuda.viterbi_pack(_port(p7), "cpu", lazy=kind != "eager",
                                    lazy_k=1 if kind == "lazy_k1" else None)
        carry = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)

        def run(tokens, lens, c):
            args = (*pack[:4], tokens, lens, staged.tr_rows, pack.consts, *c)
            if pack.lazy_k:
                return p7_cuda.viterbi_lazy_scan(*args, pack.lazy_k)
            return p7_cuda.viterbi_scan(*args)

    whole = run(staged.tokens, staged.lengths, carry)
    first = run(staged.tokens[:, :split].contiguous(), staged.lengths.clamp(max=split), carry)
    second = run(staged.tokens[:, split:].contiguous(), (staged.lengths - split).clamp(min=0),
                 first[1:5])
    for a, b in zip(second[:5], whole[:5]):
        assert torch.equal(a, b)
    if kind == "lazy_k1":
        assert int(whole[5].sum()) > 0  # the chained calls replayed too
    if kind in ("forward", "forward_log"):
        want = forward_oracle_batch(p7, np.asarray(staged.tokens, dtype=np.int32), lengths)
        np.testing.assert_allclose(whole[0].numpy(), want, atol=FWD_TOL, rtol=0)


# -- convert.py ------------------------------------------------------------

def test_convert_round_trips(profile_dir):
    """JAX packs carried over by convert.py are the port's own packs byte
    for byte; a JAX staged database's tr_probs are the port's; a JAX carry
    comes over transposed."""
    p7 = _p7(profile_dir, "200")
    for got, want in (
        (convert.p7_pack_from_jax(*pallas_p7.prepare_p7_device(p7), "cpu"),
         p7_cuda.viterbi_pack(_port(p7), "cpu", lazy=False)),
        (convert.p7_pack_from_jax(*pallas_p7.prepare_p7_device_lazy(p7)[:5], "cpu",
                                  lazy_k=pallas_p7.prepare_p7_device_lazy(p7)[5]),
         p7_cuda.viterbi_pack(_port(p7), "cpu", lazy=True)),
        (convert.p7_pack_from_jax(*pallas_p7.prepare_p7_device_prob(p7), "cpu"),
         p7_cuda.forward_pack(_port(p7), "cpu")),
    ):
        assert got.lazy_k == want.lazy_k
        for g, w in zip(got[:5], want[:5]):
            assert g.shape == w.shape and g.is_contiguous()
            assert g.numpy().tobytes() == w.numpy().tobytes()

    from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner

    lengths = np.array([0, 1, 40, 96], dtype=np.int32)
    tokens = _tokens(11, 4, 96)
    jax_staged = JaxScanner(backend="xla").stage(tokens, lengths)
    staged = convert.staged_from_jax(
        np.asarray(jax_staged.tokens_i8_t), np.asarray(jax_staged.lengths),
        np.asarray(jax_staged.tr_rows), jax_staged.num_sequences, "cpu",
        tr_probs=np.asarray(jax_staged.tr_probs),
    )
    assert np.array_equal(staged.tr_probs.numpy(), np.asarray(jax_staged.tr_probs))
    rebuilt = convert.staged_from_jax(
        np.asarray(jax_staged.tokens_i8_t), np.asarray(jax_staged.lengths),
        np.asarray(jax_staged.tr_rows), jax_staged.num_sequences, "cpu",
    )
    assert torch.equal(rebuilt.tr_probs, staged.tr_probs)
    port = MSVScanner(device="cpu").stage(tokens, lengths)
    assert torch.equal(port.tr_probs, staged.tr_probs[:, : len(lengths)])

    rng = np.random.default_rng(5)
    m, i, d = (rng.normal(size=(16, 128)).astype(np.float32) for _ in range(3))
    s = rng.normal(size=(8, 128)).astype(np.float32)
    got = convert.p7_carry_from_jax(m, i, d, s, "cpu")
    for g, w in zip(got, (m.T, i.T, d.T, s)):
        assert g.is_contiguous() and np.array_equal(g.numpy(), w)


# -- the kernels' limits ---------------------------------------------------

@pytest.mark.parametrize("m_pad,per", [(8, 1), (104, 1), (136, 2), (1400, 11), (2408, 19), (2432, 19),
                                       (2440, 10), (2704, 11), (4776, 19), (4864, 19),
                                       (4872, 5), (6984, 7), (30184, 30), (65536, 64)])
def test_kernel_states_per_thread(m_pad, per):
    """128 threads a sequence up to 2432 states, 128 in each block of the
    cluster pair up to 4864, and, whatever the kind, the rows-in-memory case
    (1024 threads, ``per`` tiles of 1024 states) up to 65536."""
    assert p7_cuda.kernel_per(m_pad) == per
    threads = 128 if m_pad <= 4864 else p7_cuda.MEM_THREADS
    assert p7_cuda.kernel_case(m_pad) == (threads, per)
    assert p7_cuda.cluster_blocks(m_pad) == (2 if 2432 < m_pad <= 4864 else 1)


def test_kernel_limit_names_itself():
    """Past 65536 states (the delete chain's 16 rows, the JAX kernels' own
    limit) the kernels' case, their launch plan and the posterior launch
    check raise, naming the limit; past 4864 the rows-in-memory case runs."""
    assert p7_cuda.MAX_KERNEL_STATES == 65536 and p7_cuda.MAX_WIDE_STATES == 4864
    assert p7_cuda.kernel_case(4872) == (p7_cuda.MEM_THREADS, 5)
    with pytest.raises(ValueError, match="65536"):
        p7_cuda.kernel_per(p7_cuda.MAX_KERNEL_STATES + 1)
    with pytest.raises(ValueError, match="65536"):
        p7_cuda.plan_launch("lazy", p7_cuda.MAX_KERNEL_STATES + 8, 5, 64, 128, 132)
