"""hmm_fasta_viterbi_tpu_torch — the PyTorch/CUDA port of the profile-HMM
scan engine, for NVIDIA Hopper cards.

It stands beside ``hmm_fasta_viterbi_tpu``, the JAX/Pallas package that is
its reference, and imports only that package's JAX-free modules: the
parsers, the MSV model, the score statistics and the NumPy oracles. So far
it runs the MSV scan, through a hand-written CUDA kernel on the card
(``csrc/msv_kernel.cu``) or its plain PyTorch version on the CPU.
"""

from hmm_fasta_viterbi_tpu.io.fastaio import parse_fasta
from hmm_fasta_viterbi_tpu.io.hmmio import parse_hmm
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile, length_transitions
from hmm_fasta_viterbi_tpu.ops.reference import msv_oracle_batch

from .pipeline import MSVScanner, StagedDatabase

__all__ = [
    "MSVProfile",
    "MSVScanner",
    "StagedDatabase",
    "length_transitions",
    "msv_oracle_batch",
    "parse_fasta",
    "parse_hmm",
]
