"""Random protein FASTA corpus: the records of ``tools/generate_fasta.py``
(uniform residues, headers ``" random {i}"``), drawn from the same
``default_rng(seed)`` stream, so one seed writes the same file."""

from __future__ import annotations

import numpy as np

from .alphabet import AMINO_ACIDS
from .fastaio import FastaRecord


def generate_records(count: int, length: int, seed: int | None = None) -> list[FastaRecord]:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)
    records = []
    for i in range(count):
        seq = alphabet[rng.integers(0, len(alphabet), size=length)].tobytes().decode()
        records.append(FastaRecord(header=f" random {i}", sequence=seq))
    return records
