"""The PyTorch port's MSVScanner (on the CPU, the plain version) against
the JAX package's MSVScanner(backend="xla") and the NumPy oracle.
Comparisons are exact, as in test_torch_msv.py."""

import gc

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu import MSVProfile, msv_oracle_batch, parse_fasta, parse_hmm
from hmm_fasta_viterbi_tpu.ops import pallas_msv
from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner
from hmm_fasta_viterbi_tpu_torch import MSVScanner, convert
from hmm_fasta_viterbi_tpu_torch import parse_fasta as port_parse_fasta
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda


def _profile(profile_dir, stem):
    return MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))


@pytest.mark.parametrize("stem", ["100", "1400"])
@pytest.mark.parametrize("fasta", ["fasta_like_example.fsa", "random_FASTA.fsa"])
def test_stage_and_scan_equal_jax_xla(profile_dir, fasta_dir, fasta, stem):
    profile = _profile(profile_dir, stem)
    db = parse_fasta(fasta_dir / fasta)
    port = MSVScanner(device="cpu")
    got = port.scan(convert.msv_profile_from_jax(profile),
                    port.stage_fasta(port_parse_fasta(fasta_dir / fasta))).numpy()
    jax_sc = JaxScanner(backend="xla")
    want = np.asarray(jax_sc.scan(profile, jax_sc.stage_fasta(db)))
    assert got.shape == (len(db),)
    assert np.array_equal(got, want)


def test_converted_jax_staging_gives_same_scores(profile_dir):
    """A JAX StagedDatabase and the JAX scanner's device pack, carried
    over by convert.py, score the same as both scanners."""
    profile = _profile(profile_dir, "1001")
    rng = np.random.default_rng(11)
    lengths = np.array([0, 1, 40, 96, 64, 95], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 96)).astype(np.int32)
    jax_sc = JaxScanner(backend="xla")
    jax_staged = jax_sc.stage(tokens, lengths)
    want = np.asarray(jax_sc.scan(profile, jax_staged))

    staged = convert.staged_from_jax(
        np.asarray(jax_staged.tokens_i8_t), np.asarray(jax_staged.lengths),
        np.asarray(jax_staged.tr_rows), jax_staged.num_sequences, "cpu",
    )
    assert staged.tokens.shape == jax_staged.tokens_i8_t.shape[::-1]
    got = MSVScanner(device="cpu").scan(convert.msv_profile_from_jax(profile), staged).numpy()
    assert np.array_equal(got, want)

    scores_t, tr_consts, mr = jax_sc._device_profile(profile)
    emit, consts = convert.device_profile_from_jax(
        np.asarray(scores_t), np.asarray(tr_consts), mr, "cpu"
    )
    m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
    got_pack = msv_cuda.msv_scan(
        emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s
    )[0][: staged.num_sequences].numpy()
    assert np.array_equal(got_pack, want)
    assert np.array_equal(got, msv_oracle_batch(profile, tokens, lengths))


def test_stage_blanks_ragged_tails():
    """Tails past each length hold PAD_TOKEN, whatever the caller padded
    with (encode pads with 0 = 'A'): the JAX blank_ragged_tail contract."""
    rng = np.random.default_rng(12)
    lengths = np.array([0, 5, 33, 48], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 48)).astype(np.int32)
    staged = MSVScanner(device="cpu").stage(tokens, lengths)
    want = pallas_msv.blank_ragged_tail(tokens.T.astype(np.int8), lengths).T
    assert staged.tokens.dtype == torch.int8
    assert np.array_equal(staged.tokens.numpy(), want)
    assert staged.total_residues == int(lengths.sum())


def test_stage_device_rejects_bad_tokens():
    sc = MSVScanner(device="cpu")
    with pytest.raises(ValueError, match="int8"):
        sc.stage_device(torch.zeros((2, 8), dtype=torch.int32), np.array([8, 8]))
    with pytest.raises(ValueError, match="lengths"):
        sc.stage_device(torch.zeros((2, 8), dtype=torch.int8), np.array([8]))


def test_profile_cache_id_reuse_regression(profile_dir):
    """The profile cache is keyed by id(profile) and pins the object: a new
    profile allocated at a collected one's address must not hit its stale
    pack. Churn fresh profile objects and demand oracle parity every time
    (mirrors tests/test_pipeline.py)."""
    sc = MSVScanner(device="cpu")
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, 20, size=(3, 64)).astype(np.int32)
    lengths = np.full(3, 64, dtype=np.int32)
    staged = sc.stage(tokens, lengths)
    for i in range(12):
        stem = ("100", "200")[i % 2]
        profile = _profile(profile_dir, stem)
        port = convert.msv_profile_from_jax(profile)
        got = sc.scan(port, staged).numpy()
        assert np.array_equal(got, msv_oracle_batch(profile, tokens, lengths))
        del profile, port
        gc.collect()


def test_profile_cache_is_bounded():
    sc = MSVScanner(device="cpu")
    sentinels = []
    for i in range(sc._CACHE_MAX + 40):
        obj = object()
        sentinels.append(obj)
        sc._cache_put(("k", i), obj, payload=i)
    assert len(sc._profile_cache) == sc._CACHE_MAX
    assert sc._cache_get(("k", 0), sentinels[0]) is None  # evicted (LRU)
    last = sc._CACHE_MAX + 39
    assert sc._cache_get(("k", last), sentinels[last]) == last
