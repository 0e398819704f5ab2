"""ctypes bindings for the native C++ fast data-loader (native/fastparse.cpp).

The reference's data_readers layer is C++ (SURVEY.md §2 #1/#2); this is
its TPU-framework equivalent: a zero-copy-ish loader producing the dense
arrays the device paths consume, with the pure-Python parsers
(io.hmmio / io.fastaio) as the always-available semantic reference.

Loading policy: the port builds its own copy of the library from
``native/fastparse.cpp`` with the flags of ``native/Makefile`` into
``hmm_fasta_viterbi_tpu_torch/_kernels/`` (never into ``native/build/``,
which the JAX package builds and reads), under a name that hashes the
source and the flags. The compiler writes a file of this process's own,
which ``os.replace`` then puts under the final name, so no process can
load a half-written library; only a finished file is loaded. On any
failure every entry point raises ``NativeUnavailable`` and callers fall
back to Python parsing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import logging
import os
import pathlib
import subprocess

import numpy as np

from .fastaio import FastaDatabase, FastaRecord
from .hmmio import NUM_TRANSITIONS, ProfileHMM
from .alphabet import NUM_AMINO_ACIDS

logger = logging.getLogger(__name__)

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
_SOURCE = _NATIVE_DIR / "fastparse.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_kernels"
# native/Makefile's CXXFLAGS less its warnings, and -shared
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
_ABI_VERSION = 3


class NativeUnavailable(RuntimeError):
    pass


class _FpHmm(ctypes.Structure):
    _fields_ = [
        ("model_length", ctypes.c_int32),
        ("name", ctypes.c_char * 256),
        ("msv_mu", ctypes.c_double),
        ("msv_lambda", ctypes.c_double),
        ("vit_mu", ctypes.c_double),
        ("vit_lambda", ctypes.c_double),
        ("fwd_tau", ctypes.c_double),
        ("fwd_lambda", ctypes.c_double),
        ("match_emissions", ctypes.POINTER(ctypes.c_float)),
        ("insert_emissions", ctypes.POINTER(ctypes.c_float)),
        ("transitions", ctypes.POINTER(ctypes.c_float)),
    ]


class _FpFasta(ctypes.Structure):
    _fields_ = [
        ("num_records", ctypes.c_int64),
        ("num_rejected", ctypes.c_int64),
        ("total_tokens", ctypes.c_int64),
        ("tokens", ctypes.POINTER(ctypes.c_int8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("headers", ctypes.POINTER(ctypes.c_char)),
        ("headers_bytes", ctypes.c_int64),
    ]


_lib = None
_load_error: str | None = None


def _lib_path() -> pathlib.Path:
    """The port's build of the library: ``_kernels/libfastparse-<key>.so``,
    ``key`` hashing the source and the flags (an edited source builds
    anew)."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    digest.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libfastparse-{digest.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> bool:
    """Compile the library into a file of this process, then move it to
    ``path`` with ``os.replace``: another process sees no file or a whole
    one."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp)],
            capture_output=True,
            timeout=120,
            text=True,
        )
        if proc.returncode != 0:
            logger.debug("native build failed: %s", proc.stderr[-500:])
            return False
        os.replace(tmp, path)
        return True
    except Exception as e:  # pragma: no cover
        logger.debug("native build error: %s", e)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        raise NativeUnavailable(_load_error)
    try:
        path = _lib_path()
    except OSError as e:
        _load_error = f"cannot read {_SOURCE}: {e}"
        raise NativeUnavailable(_load_error) from e
    if not path.exists() and not _build(path):
        _load_error = f"{path.name} not found and build failed"
        raise NativeUnavailable(_load_error)
    try:
        lib = ctypes.CDLL(str(path))
        lib.fp_abi_version.restype = ctypes.c_int32
        if lib.fp_abi_version() != _ABI_VERSION:
            # a build of another ABI under this name: rebuild once instead
            # of disabling the native loader for the process lifetime
            logger.info("fastparse ABI %d != %d, rebuilding",
                        lib.fp_abi_version(), _ABI_VERSION)
            import _ctypes

            handle = lib._handle
            del lib
            _ctypes.dlclose(handle)  # or dlopen would return the stale mapping
            if not _build(path):
                _load_error = "fastparse ABI mismatch and rebuild failed"
                raise NativeUnavailable(_load_error)
            lib = ctypes.CDLL(str(path))
            lib.fp_abi_version.restype = ctypes.c_int32
            if lib.fp_abi_version() != _ABI_VERSION:
                _load_error = "fastparse ABI mismatch after rebuild"
                raise NativeUnavailable(_load_error)
        lib.fp_parse_hmm.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FpHmm)]
        lib.fp_parse_hmm.restype = ctypes.c_int32
        lib.fp_parse_hmm_buf.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(_FpHmm),
        ]
        lib.fp_parse_hmm_buf.restype = ctypes.c_int32
        lib.fp_free_hmm.argtypes = [ctypes.POINTER(_FpHmm)]
        lib.fp_parse_fasta.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FpFasta)]
        lib.fp_parse_fasta.restype = ctypes.c_int32
        lib.fp_free_fasta.argtypes = [ctypes.POINTER(_FpFasta)]
        lib.fp_fasta_open.argtypes = [ctypes.c_char_p]
        lib.fp_fasta_open.restype = ctypes.c_void_p
        lib.fp_fasta_next.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(_FpFasta), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fp_fasta_next.restype = ctypes.c_int32
        lib.fp_fasta_close.argtypes = [ctypes.c_void_p]
    except OSError as e:  # pragma: no cover
        _load_error = f"failed to load {path}: {e}"
        raise NativeUnavailable(_load_error) from e
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def parse_hmm_native(path) -> ProfileHMM:
    """Native .hmm parse -> the same ProfileHMM the Python parser builds."""
    # alphabet guard BEFORE the C parser (which, like the reference,
    # never reads ALPH and would mis-parse a 4-column DNA profile);
    # I/O failures fall through so the native error path reports them
    from .hmmio import _check_alphabet

    try:
        with open(path, "r", errors="replace") as fh:
            head = fh.read(4096)
    except OSError:
        pass
    else:
        _check_alphabet(head)
    lib = _load()
    out = _FpHmm()
    rc = lib.fp_parse_hmm(str(path).encode(), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"fastparse: failed to parse {path} (code {rc})")
    try:
        return _hmm_from_struct(out)
    finally:
        lib.fp_free_hmm(ctypes.byref(out))


def _hmm_from_struct(out: _FpHmm) -> ProfileHMM:
    m = out.model_length
    match = np.ctypeslib.as_array(out.match_emissions, (m, NUM_AMINO_ACIDS)).copy()
    insert = np.ctypeslib.as_array(out.insert_emissions, (m, NUM_AMINO_ACIDS)).copy()
    trans = np.ctypeslib.as_array(out.transitions, (m, NUM_TRANSITIONS)).copy()
    return ProfileHMM(
        name=out.name.decode(),
        model_length=m,
        match_emissions=match,
        insert_emissions=insert,
        transitions=trans,
        stats_local_msv_mu=out.msv_mu,
        stats_local_msv_lambda=out.msv_lambda,
        stats_local_viterbi_mu=out.vit_mu,
        stats_local_viterbi_lambda=out.vit_lambda,
        stats_local_forward_theta=out.fwd_tau,
        stats_local_forward_lambda=out.fwd_lambda,
    )


def parse_hmm_multi_native(path) -> list[ProfileHMM]:
    """Native parse of a concatenated //-separated .hmm database (the
    hmmscan Pfam.hmm shape): fp_parse_hmm_buf walks model records in
    one read-only pass over the file bytes — the 13x parse-rate C fast
    path applied to whole-database loads (sweep/info --hmm-db)."""
    from .hmmio import _check_alphabet

    with open(path, "rb") as fh:
        data = fh.read()
    _check_alphabet(data[:4096].decode(errors="replace"))
    lib = _load()
    pos = ctypes.c_int64(0)
    profiles: list[ProfileHMM] = []
    while True:
        out = _FpHmm()
        rc = lib.fp_parse_hmm_buf(
            data, len(data), ctypes.byref(pos), ctypes.byref(out)
        )
        if rc == 4:  # kDone
            break
        if rc != 0:
            raise ValueError(
                f"fastparse: failed to parse model {len(profiles) + 1} "
                f"of {path} (code {rc})"
            )
        try:
            profiles.append(_hmm_from_struct(out))
        finally:
            lib.fp_free_hmm(ctypes.byref(out))
    if not profiles:
        raise ValueError(f"fastparse: no profiles in {path}")
    return profiles


def parse_fasta_arrays_native(path) -> tuple[np.ndarray, np.ndarray, list[str], int]:
    """Native FASTA parse -> (tokens int8 [B, Lmax], lengths, headers,
    num_rejected). Tokens are already alphabet-encoded and padded."""
    lib = _load()
    out = _FpFasta()
    rc = lib.fp_parse_fasta(str(path).encode(), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"fastparse: failed to parse {path} (code {rc})")
    try:
        b = int(out.num_records)
        offsets = np.ctypeslib.as_array(out.offsets, (b + 1,)).copy()
        flat = (
            np.ctypeslib.as_array(out.tokens, (int(out.total_tokens),)).copy()
            if out.total_tokens
            else np.zeros(0, dtype=np.int8)
        )
        raw_headers = ctypes.string_at(out.headers, out.headers_bytes) if out.headers_bytes else b""
        headers = raw_headers.decode().split("\0")[:b]
        lengths = np.diff(offsets).astype(np.int32)
        max_len = int(lengths.max()) if b else 0
        tokens = np.zeros((b, max(max_len, 1)), dtype=np.int8)
        for i in range(b):
            tokens[i, : lengths[i]] = flat[offsets[i] : offsets[i + 1]]
        return tokens, lengths, headers, int(out.num_rejected)
    finally:
        lib.fp_free_fasta(ctypes.byref(out))


@dataclasses.dataclass
class EncodedFastaBatch:
    """One streamed FASTA batch, already alphabet-encoded.

    Duck-typed to the FastaDatabase surface the streaming scan consumes
    (``__len__``, ``lengths``, ``records`` [headers only], ``encode``) —
    but the residues never exist as Python strings: the C++ reader emits
    the flat int8 token array directly, so genome-scale streams parse at
    native rate instead of the Python line loop's."""

    headers: list[str]
    flat: np.ndarray  # int8 concatenated encoded residues
    offsets: np.ndarray  # int64 [B + 1] into flat
    num_rejected: int = 0

    def __len__(self) -> int:
        return len(self.headers)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def records(self) -> list[FastaRecord]:
        # header-only view (streamed residues stay as tokens)
        return [FastaRecord(header=h, sequence="") for h in self.headers]

    def encode(
        self, pad_to: int | None = None, pad_multiple: int = 1,
        pad_token: int = 0, dtype=np.int32,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Same contract as FastaDatabase.encode (fastaio.py). With
        dtype=int8 the rows are straight memcpys of the reader's flat
        int8 token stream — no widening pass at all."""
        from .fastaio import check_pad_token, padded_width

        check_pad_token(pad_token, dtype)
        lengths = self.lengths
        max_len = padded_width(
            int(lengths.max()) if len(lengths) else 0, pad_to, pad_multiple
        )
        tokens = np.full((len(self.headers), max_len), pad_token, dtype=dtype)
        # per-row slice copies: memcpy-bound, measured 13x FASTER than a
        # single vectorized fancy-index scatter (whose int64 index arrays
        # cost 24 B/residue of traffic vs the slices' 4)
        for i in range(len(self.headers)):
            tokens[i, : lengths[i]] = self.flat[self.offsets[i] : self.offsets[i + 1]]
        return tokens, lengths


def iter_fasta_batches_native(path, batch_records: int = 8192):
    """Stream a FASTA natively as :class:`EncodedFastaBatch` chunks.

    Batch semantics match io.fastaio.iter_fasta_batches (at most
    ``batch_records`` valid records per batch, cut at header lines,
    rejections counted in the batch they were read in); the C++ reader
    (native/fastparse.cpp fp_fasta_open/next/close) keeps host memory
    at one batch regardless of database size."""
    lib = _load()
    handle = lib.fp_fasta_open(str(path).encode())
    if not handle:
        raise OSError(f"fastparse: cannot open {path}")
    try:
        done = ctypes.c_int32(0)
        while not done.value:
            out = _FpFasta()
            rc = lib.fp_fasta_next(
                handle, batch_records, ctypes.byref(out), ctypes.byref(done)
            )
            if rc != 0:
                raise ValueError(
                    f"fastparse: failed to stream {path} (code {rc})"
                )
            try:
                b = int(out.num_records)
                offsets = (
                    np.ctypeslib.as_array(out.offsets, (b + 1,)).copy()
                    if b
                    else np.zeros(1, dtype=np.int64)
                )
                flat = (
                    np.ctypeslib.as_array(
                        out.tokens, (int(out.total_tokens),)
                    ).copy()
                    if out.total_tokens
                    else np.zeros(0, dtype=np.int8)
                )
                raw = (
                    ctypes.string_at(out.headers, out.headers_bytes)
                    if out.headers_bytes
                    else b""
                )
                headers = raw.decode().split("\0")[:b]
            finally:
                lib.fp_free_fasta(ctypes.byref(out))
            if out.num_rejected:
                # parity with the Python parser's reference-mandated
                # reject-with-warning semantics (fastaio._classify_record;
                # FASTA_protein_sequences.cpp:29-41). The C reader keeps
                # only a count, not the rejected headers, so the warning
                # is per batch rather than per record.
                logger.warning(
                    "%s: rejected %d sequence(s) with invalid symbols "
                    "(use --loader python for per-record detail)",
                    path, int(out.num_rejected),
                )
            if b or out.num_rejected:
                yield EncodedFastaBatch(
                    headers=headers, flat=flat, offsets=offsets,
                    num_rejected=int(out.num_rejected),
                )
    finally:
        lib.fp_fasta_close(handle)


def parse_fasta_native(path) -> FastaDatabase:
    """Native FASTA parse materialized as a FastaDatabase (string view).

    For the array fast path use :func:`parse_fasta_arrays_native`.
    """
    from .alphabet import decode_sequence

    tokens, lengths, headers, num_rejected = parse_fasta_arrays_native(path)
    if num_rejected:
        logger.warning(
            "%s: rejected %d sequence(s) with invalid symbols "
            "(use --loader python for per-record detail)",
            path, num_rejected,
        )
    records = [
        FastaRecord(header=h, sequence=decode_sequence(tokens[i, : lengths[i]]))
        for i, h in enumerate(headers)
    ]
    return FastaDatabase(records=records, rejected=[])
