"""The port's own copies of the JAX package's framework-free host modules
(``io``, ``models``, ``ops.reference``) give the JAX modules' results: on
all 24 profiles and the FASTA fixtures, byte-equal arrays (dtype and shape
included) and equal scalars from the parsers, the python and native
loaders, the MSV and P7 models, the length transitions, the score
statistics, the homolog sampler and the NumPy oracles; and the
``convert.*_from_jax`` converters carry JAX objects into the port's
classes and back field for field.
"""

import ctypes
import dataclasses
import fcntl
import os
import pathlib
import time

import numpy as np
import pytest

import hmm_fasta_viterbi_tpu as jx
from hmm_fasta_viterbi_tpu.io import loader as jax_loader
from hmm_fasta_viterbi_tpu.io import native as jax_native
from hmm_fasta_viterbi_tpu.models import msv as jax_msv
from hmm_fasta_viterbi_tpu.models import p7 as jax_p7
from hmm_fasta_viterbi_tpu.models import sample as jax_sample
from hmm_fasta_viterbi_tpu.models import stats as jax_stats
from hmm_fasta_viterbi_tpu.ops import reference as jax_ref
from hmm_fasta_viterbi_tpu_torch import convert
from hmm_fasta_viterbi_tpu_torch.io import fastaio, hmmio, loader, native
from hmm_fasta_viterbi_tpu_torch.models import msv, p7, sample, stats
from hmm_fasta_viterbi_tpu_torch.ops import reference

from test_torch_posterior import STEMS

FASTAS = ("fasta_like_example.fsa", "random_FASTA.fsa")
# how long to wait for another process's build of native/build/libfastparse.so
NATIVE_WAIT_S = 120


@pytest.fixture(scope="module")
def native_loaders():
    """Both packages' native loaders, loaded. The port builds its own copy
    (``_kernels/``, written through ``os.replace``). The JAX module builds
    ``native/build/libfastparse.so`` in place, where another worker's build
    may still be writing it: under a file lock shared by this fixture's
    workers, it is loaded until it reads whole, a failure the JAX module
    cached in this worker cleared before each try."""
    assert native.native_available(), native._load_error
    native._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock_path = native._BUILD_DIR / "jax-native.lock"
    with open(lock_path, "w") as lock, pytest.MonkeyPatch.context() as mp:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + NATIVE_WAIT_S
        while True:
            mp.setattr(jax_native, "_load_error", None)
            try:
                jax_native._load()
                break
            except jax_native.NativeUnavailable:
                assert time.monotonic() < deadline, jax_native._load_error
                time.sleep(0.5)


def _same(got, want, where=""):
    """Equal values of the same kind: arrays byte for byte, dataclasses and
    sequences field by field, scalars by value (NaN equal to NaN)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    elif dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        fields = [f.name for f in dataclasses.fields(want)]
        assert fields == [f.name for f in dataclasses.fields(got)], where
        for name in fields:
            _same(getattr(got, name), getattr(want, name), f"{where}.{name}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{k}]")
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        assert got == want or (got != got and want != want), (where, got, want)


def _consensus_and_random(hmm, seed):
    """The profile's consensus, a random sequence and an empty one."""
    rng = np.random.default_rng(seed)
    cons = np.argmax(hmm.match_emissions[1:], axis=1).astype(np.int32)[:14]
    tokens = np.zeros((3, 14), dtype=np.int32)
    tokens[0, : len(cons)] = cons
    tokens[1] = rng.integers(0, 20, size=14)
    return tokens, np.array([len(cons), 11, 0], dtype=np.int32)


@pytest.mark.parametrize("stem", STEMS)
def test_profile_models_stats_and_oracles(profile_dir, native_loaders, stem):
    """parse_hmm, load_profile (python, and native: each package's own
    build of the library), MSVProfile/P7Profile.from_profile, the score statistics and
    every oracle (MSV, Viterbi, Forward, Backward, posterior_match) on
    short sequences."""
    path = profile_dir / f"{stem}.hmm"
    want_hmm = jx.parse_hmm(path)
    got_hmm = hmmio.parse_hmm(path)
    _same(got_hmm, want_hmm, "parse_hmm")
    _same(loader.load_profile(path, prefer="python"),
          jax_loader.load_profile(path, prefer="python"), "load_profile(python)")
    _same(loader.load_profile(path, prefer="native"),
          jax_loader.load_profile(path, prefer="native"), "load_profile(native)")

    want_msv = jax_msv.MSVProfile.from_profile(want_hmm)
    got_msv = msv.MSVProfile.from_profile(got_hmm)
    want_p7 = jax_p7.P7Profile.from_profile(want_hmm)
    got_p7 = p7.P7Profile.from_profile(got_hmm)
    _same(got_msv, want_msv, "MSVProfile")
    _same(got_p7, want_p7, "P7Profile")

    scores = np.array([-5.0, 0.0, 3.5, 17.25, 60.0, -np.inf, np.nan], dtype=np.float32)
    for fn in ("msv_pvalue", "viterbi_pvalue", "forward_pvalue"):
        _same(getattr(stats, fn)(scores, got_hmm), getattr(jax_stats, fn)(scores, want_hmm), fn)
    _same(stats.nats_to_bits(scores), jax_stats.nats_to_bits(scores), "nats_to_bits")
    pv = jax_stats.forward_pvalue(scores, want_hmm)
    _same(stats.evalue(pv, 16384), jax_stats.evalue(pv, 16384), "evalue")
    _same(stats.gumbel_pvalue(scores, 2.5, 0.69), jax_stats.gumbel_pvalue(scores, 2.5, 0.69),
          "gumbel_pvalue")
    _same(stats.exp_tail_pvalue(scores, -4.0, 0.69),
          jax_stats.exp_tail_pvalue(scores, -4.0, 0.69), "exp_tail_pvalue")

    tokens, lengths = _consensus_and_random(want_hmm, int(stem))
    _same(reference.msv_oracle_batch(got_msv, tokens, lengths),
          jax_ref.msv_oracle_batch(want_msv, tokens, lengths), "msv_oracle_batch")
    for fn in ("viterbi_oracle_batch", "forward_oracle_batch"):
        _same(getattr(reference, fn)(got_p7, tokens[:2], lengths[:2]),
              getattr(jax_ref, fn)(want_p7, tokens[:2], lengths[:2]), fn)
    seq = tokens[1, : lengths[1]]
    _same(list(reference.backward_oracle(got_p7, seq, return_rows=True)),
          list(jax_ref.backward_oracle(want_p7, seq, return_rows=True)), "backward_oracle")
    _same(list(reference.posterior_match(got_p7, seq)),
          list(jax_ref.posterior_match(want_p7, seq)), "posterior_match")

    # the converters: JAX objects into the port's classes, field for field
    _same(convert.profile_hmm_from_jax(want_hmm), got_hmm, "profile_hmm_from_jax")
    _same(convert.msv_profile_from_jax(want_msv), got_msv, "msv_profile_from_jax")
    _same(convert.p7_profile_from_jax(want_p7), got_p7, "p7_profile_from_jax")


@pytest.mark.parametrize("name", FASTAS)
def test_fasta_parsers_and_loaders(fasta_dir, native_loaders, name):
    """parse_fasta and load_fasta (python and native) give the JAX records,
    rejects and encoded batch."""
    path = fasta_dir / name
    want = jx.parse_fasta(path)
    got = fastaio.parse_fasta(path)
    _same(got, want, "parse_fasta")
    _same(list(got.encode()), list(want.encode()), "encode")
    _same(loader.load_fasta(path, prefer="python"),
          jax_loader.load_fasta(path, prefer="python"), "load_fasta(python)")
    got_n = loader.load_fasta(path, prefer="native")
    want_n = jax_loader.load_fasta(path, prefer="native")
    _same(list(got_n.encode()), list(want_n.encode()), "load_fasta(native).encode")
    assert [r.header for r in got_n.records] == [r.header for r in want_n.records]
    assert native._NATIVE_DIR == jax_native._NATIVE_DIR  # the repository's one native/


def test_length_transitions_and_sampler(profile_dir):
    """length_transitions on scalars and arrays; sample_sequences from one
    seed gives the same sequences."""
    lengths = np.array([0, 1, 7, 3500, 36864], dtype=np.int64)
    _same(list(msv.length_transitions(lengths)), list(jax_msv.length_transitions(lengths)),
          "length_transitions")
    _same(list(msv.length_transitions(350)), list(jax_msv.length_transitions(350)),
          "length_transitions(int)")
    for stem in ("100", "1400"):
        path = profile_dir / f"{stem}.hmm"
        got = sample.sample_sequences(hmmio.parse_hmm(path), 4, seed=7)
        want = jax_sample.sample_sequences(jx.parse_hmm(path), 4, seed=7)
        _same(list(got), list(want), f"sample_sequences {stem}")


def test_converted_profiles_are_copies(profile_dir):
    """The converters copy the arrays: changing the port's copy leaves the
    JAX object as it was."""
    want = jax_p7.P7Profile.from_profile(jx.parse_hmm(profile_dir / "100.hmm"))
    got = convert.p7_profile_from_jax(want)
    assert isinstance(got, p7.P7Profile) and not isinstance(got, jax_p7.P7Profile)
    before = want.tdd.copy()
    got.tdd[:] = 0.5
    assert np.array_equal(want.tdd, before)


def test_port_native_build_is_atomic(tmp_path, monkeypatch):
    """The port's native build writes the library into a file of its own
    process and moves it under the final name with os.replace: while the
    compiler runs the final name does not exist, and afterwards it holds a
    library that loads and nothing else is left beside it."""
    target = tmp_path / "libfastparse-test.so"
    seen, moves = [], []
    run, replace = native.subprocess.run, native.os.replace

    def compile_(cmd, **kwargs):
        seen.append(target.exists())
        return run(cmd, **kwargs)

    def move(src, dst):
        moves.append((pathlib.Path(src), pathlib.Path(dst)))
        replace(src, dst)

    monkeypatch.setattr(native.subprocess, "run", compile_)
    monkeypatch.setattr(native.os, "replace", move)
    assert native._build(target)
    assert seen == [False]
    assert moves == [(target.with_name(f"{target.name}.tmp.{os.getpid()}"), target)]
    assert [p.name for p in tmp_path.iterdir()] == [target.name]
    lib = ctypes.CDLL(str(target))
    lib.fp_abi_version.restype = ctypes.c_int32
    assert lib.fp_abi_version() == native._ABI_VERSION


def test_public_names_cover_the_jax_packages():
    """Every name of the JAX package's ``__all__`` is in the port's, each
    the port's own copy with the same value where it is data."""
    import hmm_fasta_viterbi_tpu_torch as port

    assert set(jx.__all__) <= set(port.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
    assert port.__version__ == jx.__version__
    assert port.AMINO_ACIDS == jx.AMINO_ACIDS and port.NUM_AMINO_ACIDS == jx.NUM_AMINO_ACIDS
    np.testing.assert_array_equal(port.BACKGROUND_FREQUENCIES, jx.BACKGROUND_FREQUENCIES)
    for name in set(jx.__all__) - {"__version__", "AMINO_ACIDS", "NUM_AMINO_ACIDS",
                                   "BACKGROUND_FREQUENCIES"}:
        assert getattr(port, name).__module__.startswith("hmm_fasta_viterbi_tpu_torch."), name
