"""The rows of the port's bench: ``bench.py``'s rows (``main``, lines
150-757), each timed through the port's entry point, under the JAX row
name with the device in place of the backend (``_cuda`` or ``_cpu`` for
``_pallas`` / ``_xla``) and with the JAX row's shape and cell count.

Every row runs on every device: the rows the JAX bench runs on its Pallas
backend only (filter, 2405, the Viterbi filter, the cascades, the
posterior decode, the sweep's filter) run the kernels on the card and
their plain versions on the CPU. A row that fails raises: nothing is
caught and no row falls back to another path.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import pathlib
import sys
import tempfile
import time
import types

import numpy as np

from ..cli import _stream_search
from ..io.alphabet import AMINO_ACIDS
from ..io.hmmio import ProfileHMM, parse_hmm
from ..models.msv import MSVProfile
from ..models.p7 import P7Profile
from ..ops.posterior_cuda import posterior_coverage_batch
from ..ops.reference import msv_oracle_batch
from ..pipeline import MSVScanner, SearchPipeline, StagedDatabase, msv_scores
from .harness import BenchResult, bench_profile, bench_staged, random_tokens

PROFILE_DIR = pathlib.Path(__file__).resolve().parents[2] / "data" / "profile_HMMs"

# the posterior rows' hit batch (bench.py:521-522): 1024 sequences of 1024
# residues, seed 2
POSTERIOR_BATCH = 1024
POSTERIOR_LEN = 1024
POSTERIOR_SEED = 2


@dataclasses.dataclass
class Bench:
    """What every row reads: the arguments, the scanner, the headline
    batch (host arrays and staged) and 1400.hmm."""

    args: argparse.Namespace
    scanner: MSVScanner
    tokens: np.ndarray
    lengths: np.ndarray
    staged: StagedDatabase
    hmm: ProfileHMM
    headline: MSVProfile

    def name(self, row: str) -> str:
        """The row's name: the JAX row's with the device type (cuda, cpu)
        in place of the backend."""
        return f"{row}_{self.scanner.device.type}"

    def substage(self, rows: int) -> StagedDatabase:
        """The first ``rows`` sequences of the headline batch, staged."""
        return self.scanner.stage(self.tokens[:rows], self.lengths[:rows])


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def best_of(name: str, fn, reps: int, cells: int, batch: int, seq_len: int,
            model_length: int) -> BenchResult:
    """One untimed warm-up call of ``fn``, then the best of ``reps``
    wall-clock runs; ``fn`` returns host data, so each run ends when the
    device is done."""
    fn()
    rep_seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        rep_seconds.append(time.perf_counter() - t0)
    best = min(rep_seconds)
    return BenchResult(name=name, gcups=cells / best / 1e9, seconds=best, cells=cells,
                       batch=batch, seq_len=seq_len, model_length=model_length,
                       repetitions=reps, rep_seconds=rep_seconds)


def sweep(b: Bench) -> list[BenchResult]:
    """sweep24, the 24 sweep_pXXX rows and sweep24_filter (bench.py:279-366):
    all 24 profiles against the first 8192 sequences, ``scan_many`` (the
    stacked kernel, B3) in both modes, and each profile alone (B1)."""
    sb = min(b.args.batch, 8192)
    staged = b.substage(sb)
    profiles = [MSVProfile.from_profile(parse_hmm(path))
                for path in sorted(PROFILE_DIR.glob("*.hmm"), key=lambda p: int(p.stem))]
    cells = staged.total_residues * sum(p.model_length - 1 for p in profiles)
    reps = max(b.args.reps, 2)
    out = []
    for mode, row in (("exact", "sweep24"), ("filter", "sweep24_filter")):
        r = best_of(b.name(row), functools.partial(b.scanner.scan_many, profiles, staged, mode),
                    reps, cells, staged.num_sequences, b.args.seq_len, 0)
        out.append(r)
        log(f"{row}: {r.gcups:.2f} GCUPS over {cells / 1e9:.1f} GCells in "
            f"{r.seconds * 1e3:.1f} ms")
        if mode == "exact":
            # a best time a profile as the reference prints them
            # (benchmark_MSV.cpp:18-23,32-41)
            per = [bench_staged(b.name(f"sweep_p{p.model_length - 1}"), b.scanner, p, staged,
                                max(2, min(b.args.reps, 3))) for p in profiles]
            out += per
            log("sweep24 per-profile: "
                + " ".join(f"{r.model_length - 1}:{r.seconds * 1e3:.1f}ms" for r in per)
                + f" sum={sum(r.seconds for r in per) * 1e3:.1f}ms")
    return out


def filter_1400(b: Bench) -> list[BenchResult]:
    """filter_1400 (bench.py:370-385): the MSV filter (B2) on the headline
    batch."""
    r = bench_staged(b.name("filter_1400"), types.SimpleNamespace(scan=b.scanner.scan_filter),
                     b.headline, b.staged, b.args.reps)
    log(f"filter: {r.gcups:.2f} GCUPS ({r.seconds * 1e3:.1f} ms)")
    return [r]


def headline_2405(b: Bench) -> list[BenchResult]:
    """headline_2405 (bench.py:387-403): 2405.hmm (B1) on half the batch."""
    hb = max(128, b.args.batch // 2)
    p2405 = MSVProfile.from_profile(parse_hmm(PROFILE_DIR / "2405.hmm"))
    r = bench_staged(b.name("headline_2405"), b.scanner, p2405, b.substage(hb), b.args.reps)
    log(f"M2405: {r.gcups:.2f} GCUPS ({r.seconds * 1e3:.1f} ms, batch {r.batch})")
    return [r]


def stages(b: Bench) -> list[BenchResult]:
    """viterbi_1400, forward_1400 and viterbi_filter_1400 (bench.py:405-444):
    the lazy Viterbi (B7), Forward (B5) and Viterbi filter (B6) stage scans
    on a quarter of the batch."""
    sb = max(128, b.args.batch // 4)
    staged = b.substage(sb)
    p7 = P7Profile.from_profile(b.hmm)
    out = []
    for row, scan in (
        ("viterbi", functools.partial(b.scanner.scan_p7, stage="viterbi")),
        ("forward", functools.partial(b.scanner.scan_p7, stage="forward")),
        ("viterbi_filter", b.scanner.scan_p7_filter),
    ):
        r = bench_staged(b.name(f"{row}_1400"), types.SimpleNamespace(scan=scan), p7, staged,
                         b.args.reps)
        out.append(r)
        log(f"{row}: {r.gcups:.2f} GCUPS ({r.seconds * 1e3:.1f} ms, batch {r.batch})")
    return out


def cascade(b: Bench) -> list[BenchResult]:
    """cascade_1400 and cascade_fast_1400 (bench.py:446-502): the search
    cascade (B1, B7, B5; with both prefilters B2, B1, B6, B7, B5) on the
    first 4096 sequences, GCUPS in MSV cells."""
    cb = min(b.args.batch, 4096)
    tokens, lengths = b.tokens[:cb], b.lengths[:cb]
    staged = b.scanner.stage(tokens, lengths)
    cells = int(lengths.astype(np.int64).sum()) * (b.headline.model_length - 1)
    out = []
    for row, pipe in (
        ("cascade_1400", SearchPipeline(b.scanner)),
        ("cascade_fast_1400", SearchPipeline(b.scanner, fast_msv=True, fast_viterbi=True)),
    ):
        search = functools.partial(pipe.search, b.hmm, staged, tokens, lengths)
        r = best_of(b.name(row), search, max(b.args.reps, 2), cells, cb, b.args.seq_len,
                    b.headline.model_length)
        out.append(r)
        res = search()
        # on random rows the stages after MSV run almost empty
        log(f"{row}: {r.gcups:.2f} GCUPS ({r.seconds * 1e3:.1f} ms, batch {cb}); "
            f"{int(res.passed_msv.sum())} past MSV, {int(res.passed_viterbi.sum())} past "
            f"Viterbi, {int(res.passed_forward.sum())} hits")
    return out


def posterior(b: Bench) -> list[BenchResult]:
    """posterior_1400 and posterior_mask_1400 (bench.py:504-592): the
    posterior decode (B9, B10) of a 1024 x 1024 hit batch, f32 coverage and
    the uint8 mask thresholded on the device."""
    p7 = P7Profile.from_profile(b.hmm)
    tokens, lengths = random_tokens(POSTERIOR_BATCH, POSTERIOR_LEN, seed=POSTERIOR_SEED)
    cells = int(lengths.astype(np.int64).sum()) * (p7.model_length - 1)
    out = []
    for row, threshold in (("posterior_1400", None), ("posterior_mask_1400", 0.5)):
        decode = functools.partial(posterior_coverage_batch, p7, tokens, lengths,
                                   device=b.scanner.device, mask_threshold=threshold)
        r = best_of(b.name(row), decode, max(b.args.reps, 2), cells, POSTERIOR_BATCH,
                    POSTERIOR_LEN, p7.model_length)
        out.append(r)
        log(f"{row}: {r.gcups:.2f} GCUPS decode ({r.seconds * 1e3:.1f} ms, batch "
            f"{POSTERIOR_BATCH} x L {POSTERIOR_LEN})")
    return out


def write_corpus(path: str, n_seqs: int, seq_len: int) -> None:
    """The streamed row's FASTA: bench.py's corpus (seed 3, 70 residues a
    line), byte for byte."""
    rng = np.random.default_rng(3)
    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        for i in range(n_seqs):
            row = letters[rng.integers(0, 20, seq_len)].tobytes()
            lines = [row[off: off + 70] for off in range(0, len(row), 70)]
            fh.write(b"".join([f">s{i}\n".encode(), *(line + b"\n" for line in lines)]))


def stream_search(b: Bench) -> list[BenchResult]:
    """stream_search_1400 (bench.py:594-680): the streamed ``--fast`` search
    (parse on the producer thread, side-stream staging, B2, B1, B6, B7, B5
    a batch) over a generated FASTA in at least 4 batches, through the
    CLI's ``_stream_search``; GCUPS in MSV cells."""
    n_seqs = max(4, b.args.stream_seqs if not b.args.quick else 64)
    chunk = max(1, min(4096, n_seqs // 4))
    fd, corpus = tempfile.mkstemp(suffix=".fsa")
    os.close(fd)
    try:
        write_corpus(corpus, n_seqs, b.args.seq_len)
        s_args = types.SimpleNamespace(fasta=corpus, stream=chunk, loader="auto")
        pipe = SearchPipeline(b.scanner, fast_msv=True, fast_viterbi=True)
        _stream_search(s_args, pipe, [b.hmm], keep_tokens=False)  # warm-up
        best = None
        rep_seconds = []
        for _ in range(max(b.args.reps, 2)):
            t0 = time.perf_counter()
            _, n_total, cells, stream = _stream_search(s_args, pipe, [b.hmm], keep_tokens=False)
            rep_seconds.append(time.perf_counter() - t0)
            if n_total != n_seqs:
                raise RuntimeError(f"the stream read {n_total} of {n_seqs} records")
            if best is None or rep_seconds[-1] < best[0]:
                best = (rep_seconds[-1], stream)
    finally:
        os.unlink(corpus)
    seconds, stream = best
    r = BenchResult(name=b.name("stream_search_1400"), gcups=cells / seconds / 1e9,
                    seconds=seconds, cells=cells, batch=chunk, seq_len=b.args.seq_len,
                    model_length=b.hmm.model_length, repetitions=len(rep_seconds),
                    rep_seconds=rep_seconds)
    # the consumer's sections beside the producer's (``_Stream.log_phases``)
    wait = stream.timer.sections.get("prefetch_wait", 0.0)
    log(f"stream_search: {r.gcups:.2f} GCUPS e2e over {n_seqs} seqs ({seconds:.3f} s; host "
        f"parse not hidden by device work: {wait / seconds:.0%}; phases "
        f"{stream.timer.report()})")
    return [r]


def oracle(b: Bench) -> list[BenchResult]:
    """oracle_msv_numpy (bench.py:682-710): the sequential NumPy oracle on
    2 sequences, once, for context."""
    tokens, lengths = random_tokens(2, b.args.seq_len, seed=0)
    t0 = time.perf_counter()
    msv_oracle_batch(b.headline, tokens, lengths)
    dt = time.perf_counter() - t0
    cells = int(lengths.astype(np.int64).sum()) * (b.headline.model_length - 1)
    log(f"oracle: {cells / dt / 1e9:.3f} GCUPS ({dt * 1e3:.0f} ms)")
    return [BenchResult(name="oracle_msv_numpy", gcups=cells / dt / 1e9, seconds=dt,
                        cells=cells, batch=2, seq_len=b.args.seq_len,
                        model_length=b.headline.model_length, repetitions=1)]


def ref_b3(b: Bench) -> list[BenchResult]:
    """ref_1400_b3 (bench.py:712-731): the reference pass (1400.hmm x 3 x
    3500 aa, benchmark_MSV_1400.cpp:8-13) end to end through
    ``msv_scores`` (stage, pack, B1)."""
    tokens, lengths = random_tokens(3, 3500, seed=0)
    r = bench_profile(b.name("ref_1400_b3"), b.headline,
                      functools.partial(msv_scores, device=b.scanner.device), tokens, lengths,
                      b.args.reps)
    log(f"ref_b3: {r.gcups:.2f} GCUPS ({r.seconds * 1e3:.2f} ms; the reference pass shape)")
    return [r]


def e2e(b: Bench) -> list[BenchResult]:
    """e2e_1400 (bench.py:733-745, ``--e2e``): the headline batch end to end
    through ``msv_scores``."""
    r = bench_profile(b.name("e2e_1400"), b.headline,
                      functools.partial(msv_scores, device=b.scanner.device), b.tokens,
                      b.lengths, b.args.reps)
    log(f"e2e: {r.gcups:.2f} GCUPS ({r.seconds * 1e3:.1f} ms)")
    return [r]
