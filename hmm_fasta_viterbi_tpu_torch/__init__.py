"""hmm_fasta_viterbi_tpu_torch — the PyTorch/CUDA port of the profile-HMM
scan engine, for NVIDIA Hopper cards.

It stands beside ``hmm_fasta_viterbi_tpu``, the JAX/Pallas package that is
its reference, and imports nothing of it: the parsers (``io``), the MSV
and P7 models, score statistics and homolog sampler (``models``) and the
NumPy oracles (``ops.reference``) are the port's own copies of the JAX
package's framework-free modules. It runs the MSV scan, the full-profile
Viterbi and Forward scans (probability-space, and the log-space semiring
that referees it), the MSV -> Viterbi -> Forward search cascade with or
without the upper-bound MSV and Viterbi prefilters (``--fast``), the
posterior domain decode of its hits (``--domains``), and the stacked
profile sweep, through hand-written CUDA kernels on the card
(``csrc/*.cu``) or their plain PyTorch versions on the CPU; and it runs
them over ragged databases in length buckets (``--bucketed``), over
databases larger than host memory in streamed batches staged on a side
CUDA stream (``--stream N``), and as resumable checkpointed sweeps
(``runtime.checkpoint``, ``--checkpoint DIR``), and it shards them over a
device mesh (``parallel``, ``--mesh``): rows over its db axis, the residues
of long sequences over its sp axis as a wavefront. Its host commands align
sequences to a profile by Viterbi traceback (``ops.traceback``: ``scan
--align``, ``--msa-out``, ``align``), summarise profiles (``info``), sample
from them (``emit``), write random databases (``generate``) and build a
profile from an MSA (``models.build``, ``io.msaio``, ``io.hmmwrite``:
``build``), calibrating its STATS with the MSV, eager Viterbi and log-space
Forward kernels. ``runtime.config.EngineConfig`` carries the cascade
thresholds and ``m_bucket`` (``--config``), and
``runtime.profiling.device_trace`` records a ``torch.profiler`` trace of a
scan (``--profile-trace``). ``python -m hmm_fasta_viterbi_tpu_torch.bench``
times the JAX bench's rows through the port's entry points (``bench``).
"""

from .io.alphabet import AMINO_ACIDS, BACKGROUND_FREQUENCIES, NUM_AMINO_ACIDS
from .io.fastaio import FastaDatabase, FastaRecord, parse_fasta, parse_fasta_text
from .io.hmmio import HMMParseError, ProfileHMM, parse_hmm, parse_hmm_text
from .models.build import build_profile, calibrate_profile
from .models.msv import MSVProfile, expand_msv_scores, length_transitions, msv_transitions
from .models.p7 import P7Profile
from .ops.reference import (
    backward_oracle,
    forward_oracle_batch,
    msv_oracle,
    msv_oracle_batch,
    posterior_match,
    viterbi_oracle_batch,
)
from .pipeline import (
    BucketedDatabase,
    MSVScanner,
    SearchPipeline,
    SearchResult,
    SideStreamStager,
    StagedDatabase,
)
from .runtime.config import EngineConfig

__version__ = "0.1.0"

__all__ = [
    "AMINO_ACIDS",
    "BACKGROUND_FREQUENCIES",
    "BucketedDatabase",
    "EngineConfig",
    "FastaDatabase",
    "FastaRecord",
    "HMMParseError",
    "MSVProfile",
    "MSVScanner",
    "NUM_AMINO_ACIDS",
    "P7Profile",
    "ProfileHMM",
    "SearchPipeline",
    "SearchResult",
    "SideStreamStager",
    "StagedDatabase",
    "__version__",
    "backward_oracle",
    "build_profile",
    "calibrate_profile",
    "expand_msv_scores",
    "forward_oracle_batch",
    "length_transitions",
    "msv_oracle",
    "msv_oracle_batch",
    "msv_transitions",
    "parse_fasta",
    "parse_fasta_text",
    "parse_hmm",
    "parse_hmm_text",
    "posterior_match",
    "viterbi_oracle_batch",
]
