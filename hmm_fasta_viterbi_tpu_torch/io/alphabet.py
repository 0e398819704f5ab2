"""Protein alphabet and background model for the profile-HMM scan engine.

Capability parity with the reference MSV engine's amino-acid handling
(reference: algorithms/MSV_HMM.cpp:21-31): 20 canonical amino acids in
alphabetical one-letter order, and HMMER's default protein background
frequencies (p7_AminoFrequencies).

TPU-first notes: sequences are encoded once on the host into dense int32
token arrays (values 0..19) so that the device-side scan is pure array
compute — no string handling, no hash maps on the hot path.
"""

from __future__ import annotations

import numpy as np

# Canonical one-letter amino-acid alphabet, index order shared with the
# reference engine (A=0 .. Y=19).
AMINO_ACIDS: str = "ACDEFGHIKLMNPQRSTVWY"

NUM_AMINO_ACIDS: int = len(AMINO_ACIDS)

# Sentinel used by the reference FASTA layer to mark the start of a record
# (reference: data_readers/FASTA_protein_sequences.cpp:20). The array
# encoding replaces it with explicit 0-based indexing, but parity-facing
# string APIs still surface it.
SENTINEL: str = "#"

AA_TO_INDEX: dict[str, int] = {aa: i for i, aa in enumerate(AMINO_ACIDS)}

# HMMER default background frequencies for protein models
# (p7_AminoFrequencies; reference: algorithms/MSV_HMM.cpp:21-27).
BACKGROUND_FREQUENCIES: np.ndarray = np.array(
    [
        0.0787945, 0.0151600, 0.0535222, 0.0668298,  # A C D E
        0.0397062, 0.0695071, 0.0229198, 0.0590092,  # F G H I
        0.0594422, 0.0963728, 0.0237718, 0.0414386,  # K L M N
        0.0482904, 0.0395639, 0.0540978, 0.0683364,  # P Q R S
        0.0540687, 0.0673417, 0.0114135, 0.0304133,  # T V W Y
    ],
    dtype=np.float32,
)

# Fast byte-level lookup table: ASCII code -> token, -1 for invalid symbols.
_LOOKUP = np.full(256, -1, dtype=np.int32)
for _aa, _i in AA_TO_INDEX.items():
    _LOOKUP[ord(_aa)] = _i


def encode_sequence(seq: str) -> np.ndarray:
    """Encode a protein string (no sentinel) into int32 tokens 0..19.

    Raises ValueError on any symbol outside the 20-letter alphabet.
    """
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    tokens = _LOOKUP[raw]
    if (tokens < 0).any():
        bad = raw[tokens < 0][0]
        raise ValueError(f"invalid amino-acid symbol {chr(bad)!r} in sequence")
    return tokens


def decode_sequence(tokens: np.ndarray) -> str:
    """Inverse of :func:`encode_sequence`."""
    return "".join(AMINO_ACIDS[t] for t in np.asarray(tokens).tolist())


def is_valid_sequence(seq: str) -> bool:
    """True iff every symbol is one of the 20 amino acids (or the sentinel).

    Mirrors the reference's whole-sequence validation set
    (data_readers/FASTA_protein_sequences.cpp:26-27).
    """
    allowed = set(AMINO_ACIDS) | {SENTINEL}
    return all(c in allowed for c in seq)
