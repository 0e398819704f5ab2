"""Unified data loading: native fast path with pure-Python fallback.

``prefer`` policy: "auto" uses the C++ loader when the shared library is
available (building it once if a toolchain exists), "python" forces the
reference parsers, "native" requires the fast path.
"""

from __future__ import annotations

import logging
from typing import Literal

import numpy as np

from . import native
from .fastaio import FastaDatabase, parse_fasta
from .hmmio import ProfileHMM, parse_hmm

logger = logging.getLogger(__name__)

Prefer = Literal["auto", "native", "python"]


def load_profile(path, prefer: Prefer = "auto") -> ProfileHMM:
    if prefer != "python":
        try:
            return native.parse_hmm_native(path)
        except native.NativeUnavailable:
            if prefer == "native":
                raise
            logger.debug("native loader unavailable; using python parser")
    return parse_hmm(path)


def load_profiles(path, prefer: Prefer = "auto") -> list[ProfileHMM]:
    """Load a profile collection: a directory of per-model ``.hmm``
    files (the reference's layout, native fast path per file) or ONE
    concatenated ``//``-separated database file (the hmmscan
    ``Pfam.hmm`` shape; Python parser — the C parser is single-model)."""
    import pathlib

    p = pathlib.Path(path)
    if p.is_dir():
        files = sorted(p.glob("*.hmm"))
        return [load_profile(f, prefer=prefer) for f in files]
    if not p.is_file():
        raise FileNotFoundError(f"no profile directory or database at {p}")
    if prefer != "python":
        try:
            return native.parse_hmm_multi_native(p)
        except native.NativeUnavailable:
            if prefer == "native":
                raise
            logger.debug("native loader unavailable; using python parser")
    from .hmmio import parse_hmm_multi

    return parse_hmm_multi(p)


def load_fasta(path, prefer: Prefer = "auto") -> FastaDatabase:
    if prefer != "python":
        try:
            return native.parse_fasta_native(path)
        except native.NativeUnavailable:
            if prefer == "native":
                raise
            logger.debug("native loader unavailable; using python parser")
    return parse_fasta(path)


def stream_fasta(path, batch_records: int, prefer: Prefer = "auto"):
    """Yield bounded-memory FASTA batches (the scan --stream path).

    Native streaming reader when available (io.native
    iter_fasta_batches_native — residues go straight to int8 tokens),
    else the pure-Python line iterator (io.fastaio.iter_fasta_batches);
    both cut batches at header lines after ``batch_records`` valid
    records and expose ``encode`` / ``records`` / ``__len__``."""
    if prefer != "python":
        try:
            yield from native.iter_fasta_batches_native(path, batch_records)
            return
        except native.NativeUnavailable:
            if prefer == "native":
                raise
            logger.debug("native loader unavailable; using python parser")
    from .fastaio import iter_fasta_batches

    yield from iter_fasta_batches(path, batch_records)


def stream_fasta_prefetch(
    path,
    batch_records: int,
    prefer: Prefer = "auto",
    encode_pad_multiple: int | None = None,
    depth: int = 2,
    producer_sections: dict | None = None,
    stage_fn=None,
):
    """:func:`stream_fasta` with background prefetch: a worker thread
    parses (and optionally encodes + stages) the NEXT batch while the
    caller's device scan consumes the current one.

    The streamed scan loop is otherwise strictly serial —
    parse -> scan -> parse — which halves throughput once host parse
    time approaches device time (README's streaming pitch compares
    ~134 Mres/s native parse against ~143 Mres/s chip consumption;
    without overlap the end-to-end rate would be their HARMONIC sum).
    The native parser runs inside a ctypes call (GIL released) and the
    device wait is a blocking transfer (GIL released), so a plain
    thread overlaps them.

    ``stage_fn(tokens, lengths) -> staged`` (requires
    ``encode_pad_multiple``) additionally runs the host->device staging
    off-thread, double-buffered: batch N+1's pad/transpose/upload is in
    flight while batch N's search runs on device. Round-4 measurement
    showed the synchronous ``scanner.stage()`` call was 51% of the warm
    streamed-search wall (VERDICT r4 item 4) — most of it host-side
    numpy that a thread fully overlaps with the device wait.

    Yields ``batch`` when ``encode_pad_multiple`` is None,
    ``(batch, tokens, lengths)`` with ``batch.encode(pad_multiple=...)``
    already done off-thread, or ``(batch, tokens, lengths, staged)``
    with ``stage_fn``. Worker exceptions re-raise in the consumer.
    """
    import queue as _queue
    import threading
    import time as _time

    if stage_fn is not None and encode_pad_multiple is None:
        raise ValueError("stage_fn requires encode_pad_multiple")
    q: _queue.Queue = _queue.Queue(maxsize=max(1, depth))
    _END = object()
    # producer-side wall attribution (parse / encode / stage /
    # queue-full wait), accumulated into producer_sections when the
    # caller passes a dict — the prefetch_wait a consumer sees is
    # opaque without it
    secs = producer_sections if producer_sections is not None else {}
    secs.setdefault("parse", 0.0)
    secs.setdefault("encode", 0.0)
    if stage_fn is not None:
        secs.setdefault("stage", 0.0)
    secs.setdefault("put_wait", 0.0)

    def _work():
        try:
            it = stream_fasta(path, batch_records, prefer=prefer)
            while True:
                t0 = _time.perf_counter()
                batch = next(it, None)
                secs["parse"] += _time.perf_counter() - t0
                if batch is None:
                    break
                if encode_pad_multiple is None:
                    item = batch
                else:
                    t0 = _time.perf_counter()
                    # staged consumers only ever re-stage token subsets
                    # (survivor rescore), so encode straight to the
                    # kernel's int8 — the int32 detour costs 4x the
                    # producer-thread memory traffic, which on a 1-CPU
                    # host also steals GIL time from the consumer loop
                    tokens, lengths = batch.encode(
                        pad_multiple=encode_pad_multiple,
                        dtype=np.int8 if stage_fn is not None else np.int32,
                    )
                    secs["encode"] += _time.perf_counter() - t0
                    if stage_fn is None:
                        item = (batch, tokens, lengths)
                    else:
                        t0 = _time.perf_counter()
                        staged = stage_fn(tokens, lengths)
                        secs["stage"] += _time.perf_counter() - t0
                        item = (batch, tokens, lengths, staged)
                t0 = _time.perf_counter()
                q.put(item)
                secs["put_wait"] += _time.perf_counter() - t0
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            q.put(e)

    t = threading.Thread(target=_work, daemon=True, name="fasta-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # consumer abandoned the stream: drain so the worker can exit
        # (daemon thread; bounded queue would otherwise block it forever)
        while t.is_alive():
            try:
                q.get_nowait()
            except _queue.Empty:
                t.join(0.05)
    t.join(timeout=5)


def load_fasta_arrays(
    path, prefer: Prefer = "auto"
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """(tokens [B, Lmax] int, lengths [B], headers) — the scan-ready form."""
    if prefer != "python":
        try:
            tokens, lengths, headers, _ = native.parse_fasta_arrays_native(path)
            return tokens, lengths, headers
        except native.NativeUnavailable:
            if prefer == "native":
                raise
            logger.debug("native loader unavailable; using python parser")
    db = parse_fasta(path)
    tokens, lengths = db.encode()
    return tokens, lengths, [r.header for r in db.records]
