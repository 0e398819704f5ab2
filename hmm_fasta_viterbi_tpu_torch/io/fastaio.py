"""Protein FASTA reader producing validated records and dense token arrays.

Capability parity with the reference FASTA layer
(reference: data_readers/FASTA_protein_sequences.{hpp,cpp}):

* multi-line records are concatenated (FASTA_protein_sequences.cpp:18-23);
* any record containing a symbol outside the 20 amino acids is rejected
  whole, with a warning (FASTA_protein_sequences.cpp:26-41);
* the parity-facing ``sequences`` property prepends the ``#`` sentinel the
  reference substitutes for the header line — downstream array encoding
  replaces that with explicit indexing.

Deliberate fixes over the reference (SURVEY.md appendix, quirks 5/6):
empty lines no longer index out of bounds, content before the first header
raises, and warnings go through ``logging`` instead of stdout.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from .alphabet import SENTINEL, encode_sequence, is_valid_sequence

logger = logging.getLogger(__name__)


class FastaParseError(ValueError):
    """Raised on malformed FASTA input."""


@dataclasses.dataclass
class FastaRecord:
    header: str  # text after '>' (reference discards this; we keep it)
    sequence: str  # residues only, no sentinel

    def __len__(self) -> int:
        return len(self.sequence)


@dataclasses.dataclass
class FastaDatabase:
    """A parsed protein database: valid records plus rejection log."""

    records: list[FastaRecord]
    rejected: list[FastaRecord]

    @property
    def sequences(self) -> list[str]:
        """Reference-shaped view: ``'#' + residues`` per valid record
        (data_readers/FASTA_protein_sequences.cpp:20)."""
        return [SENTINEL + r.sequence for r in self.records]

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(r) for r in self.records], dtype=np.int32)

    def __len__(self) -> int:
        return len(self.records)

    def encode(
        self,
        pad_to: int | None = None,
        pad_multiple: int = 1,
        pad_token: int = 0,
        dtype=np.int32,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode all valid records into a padded token batch.

        Returns ``(tokens dtype [B, Lmax], lengths int32 [B])``. Padding
        residues use ``pad_token`` (they are masked out by the scan — see
        ops.xla_scan / ops.pallas_msv; SURVEY.md §7 hard part (e)).
        ``dtype`` defaults to int32 (the lax.scan fns' index dtype); the
        staged streaming path requests int8 — the kernel layout is int8
        anyway, and the int32 round-trip is 4x the memory traffic on the
        producer thread (see io.loader.stream_fasta_prefetch).
        """
        check_pad_token(pad_token, dtype)
        lengths = self.lengths
        max_len = padded_width(
            int(lengths.max()) if len(lengths) else 0, pad_to, pad_multiple
        )
        tokens = np.full((len(self.records), max_len), pad_token, dtype=dtype)
        for i, rec in enumerate(self.records):
            tokens[i, : len(rec)] = encode_sequence(rec.sequence)
        return tokens, lengths


def check_pad_token(pad_token: int, dtype) -> None:
    """Raise ValueError when the integer ``dtype`` cannot hold
    ``pad_token``: ``np.full`` would wrap it silently (200 becomes -56 in
    int8, the dtype the streamed producer encodes to). Shared by
    :meth:`FastaDatabase.encode` and the native ``EncodedFastaBatch.encode``."""
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        if not info.min <= pad_token <= info.max:
            raise ValueError(
                f"pad_token {pad_token} does not fit {dtype} ({info.min}..{info.max})"
            )


def padded_width(max_len: int, pad_to: int | None, pad_multiple: int) -> int:
    """Shared padding contract for :meth:`FastaDatabase.encode` and the
    native ``EncodedFastaBatch.encode`` — stream_fasta yields either type
    interchangeably, so the compiled-shape rounding must stay identical
    across loaders."""
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to={pad_to} < longest sequence {max_len}")
        max_len = pad_to
    return max(1, -(-max_len // pad_multiple) * pad_multiple)


def parse_fasta(path: str | os.PathLike) -> FastaDatabase:
    with open(path, "r") as f:
        text = f.read()
    return parse_fasta_text(text, source=str(path))


def parse_fasta_text(text: str, source: str = "<string>") -> FastaDatabase:
    headers: list[str] = []
    chunks: list[list[str]] = []
    for line in text.splitlines():
        if line.startswith(">"):
            headers.append(line[1:].strip())
            chunks.append([])
        elif line:
            if not chunks:
                raise FastaParseError(f"{source}: sequence data before first '>' header")
            chunks[-1].append(line.strip())

    records: list[FastaRecord] = []
    rejected: list[FastaRecord] = []
    for header, parts in zip(headers, chunks):
        _classify_record(
            FastaRecord(header=header, sequence="".join(parts)),
            records, rejected, source,
        )
    return FastaDatabase(records=records, rejected=rejected)


def _classify_record(
    rec: FastaRecord,
    records: list[FastaRecord],
    rejected: list[FastaRecord],
    source: str,
) -> None:
    """Whole-sequence accept/reject with a warning, as in the reference
    (FASTA_protein_sequences.cpp:29-41) — one definition shared by the
    whole-file and streaming parsers."""
    if is_valid_sequence(rec.sequence):
        records.append(rec)
    else:
        bad = next(c for c in rec.sequence if not is_valid_sequence(c))
        logger.warning(
            "sequence %r rejected: prohibited symbol %r in %s FASTA file",
            rec.header or rec.sequence[:30],
            bad,
            source,
        )
        rejected.append(rec)


def iter_fasta_batches(path: str | os.PathLike, batch_records: int = 8192):
    """Stream a FASTA file as :class:`FastaDatabase` batches.

    Yields databases of at most ``batch_records`` VALID records each,
    holding only the current batch in host memory — the scan path for
    databases too large to load whole (pair with MSVScanner staging,
    which already bounds device residency per shard). Validation,
    rejection warnings, and the data-before-header error are identical
    to :func:`parse_fasta` (shared _classify_record); rejected records
    are attached to the batch in which they were read."""
    source = str(path)
    records: list[FastaRecord] = []
    rejected: list[FastaRecord] = []
    header: str | None = None
    parts: list[str] = []

    def finish() -> None:
        nonlocal header, parts
        if header is not None:
            _classify_record(
                FastaRecord(header=header, sequence="".join(parts)),
                records, rejected, source,
            )
        header, parts = None, []

    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                finish()
                if len(records) >= batch_records:
                    batch = FastaDatabase(records=records, rejected=rejected)
                    records, rejected = [], []
                    yield batch
                header = line[1:].strip()
            elif line:
                if header is None:
                    raise FastaParseError(
                        f"{source}: sequence data before first '>' header"
                    )
                parts.append(line.strip())
    finish()
    if records or rejected:
        yield FastaDatabase(records=records, rejected=rejected)


def write_fasta(path, records: list[FastaRecord], width: int = 70) -> None:
    """Write records in wrapped FASTA format (wrap width as the reference
    generator's 70 columns, FASTA_files/random_FASTA_generator.py).
    ``path`` may be a filesystem path or an open text stream."""
    if hasattr(path, "write"):
        _write_fasta_records(path, records, width)
        return
    with open(path, "w") as f:
        _write_fasta_records(f, records, width)


def _write_fasta_records(f, records: list[FastaRecord], width: int) -> None:
    for rec in records:
        f.write(f">{rec.header}\n")
        for i in range(0, len(rec.sequence), width):
            f.write(rec.sequence[i : i + width] + "\n")
