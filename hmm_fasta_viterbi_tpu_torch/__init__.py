"""hmm_fasta_viterbi_tpu_torch — the PyTorch/CUDA port of the profile-HMM
scan engine, for NVIDIA Hopper cards.

It stands beside ``hmm_fasta_viterbi_tpu``, the JAX/Pallas package that is
its reference, and imports only that package's JAX-free modules: the
parsers, the MSV and P7 models, the score statistics and the NumPy
oracles. So far it runs the MSV scan, the full-profile Viterbi and Forward
scans, the MSV -> Viterbi -> Forward search cascade with or without the
upper-bound MSV and Viterbi prefilters (``--fast``), and the stacked
profile sweep, through hand-written CUDA kernels on the card
(``csrc/*.cu``) or their plain PyTorch versions on the CPU.
"""

from hmm_fasta_viterbi_tpu.io.fastaio import parse_fasta
from hmm_fasta_viterbi_tpu.io.hmmio import parse_hmm
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile, length_transitions
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile
from hmm_fasta_viterbi_tpu.ops.reference import (
    forward_oracle_batch,
    msv_oracle_batch,
    viterbi_oracle_batch,
)

from .pipeline import MSVScanner, SearchPipeline, SearchResult, StagedDatabase

__all__ = [
    "MSVProfile",
    "MSVScanner",
    "P7Profile",
    "SearchPipeline",
    "SearchResult",
    "StagedDatabase",
    "forward_oracle_batch",
    "length_transitions",
    "msv_oracle_batch",
    "parse_fasta",
    "parse_hmm",
    "viterbi_oracle_batch",
]
