"""On-card smoke test of the PyTorch port (hmm_fasta_viterbi_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (device 0) and the CUDA toolkit's nvcc. In order:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: compiles csrc/*.cu from this checkout;
3. kernel against plain: for all 24 profiles of data/profile_HMMs, the
   MSV kernel and its plain PyTorch version on one ragged batch, and a
   two-call carry chain against one call, must be equal (max |d| = 0.0);
4. kernel against the NumPy oracle on 8 sequences of 1400.hmm and 2405.hmm;
5. main path: writes a seeded FASTA of 16384 x 3500 residues and runs
   `scan --hmm data/profile_HMMs/1400.hmm` through the port's CLI, which
   must launch the kernel; 16384 rows, the first 8 equal to the oracle;
6. timings with CUDA events at that shape: the kernel (best of 3) at
   1400.hmm and 2405.hmm, and the plain version at 1400.hmm.

Prints a JSON line about the kernel and, last, {"ok": true, ...}. Any
failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import logging
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hmm_fasta_viterbi_tpu.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch import MSVProfile, MSVScanner, msv_oracle_batch, parse_hmm
from hmm_fasta_viterbi_tpu_torch import cli, convert
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda

REPO = pathlib.Path(__file__).resolve().parent
PROFILES = REPO / "data" / "profile_HMMs"
DEVICE = "cuda:0"
SEED = 0
# bench.py's headline batch: 16384 random sequences of 3500 residues
BATCH, SEQ_LEN = 16384, 3500
# the ragged batch of the 24-profile check, and its carry-chain split
# (not a multiple of 32, the kernel's token group)
RAGGED_BATCH, RAGGED_LEN, SPLIT = 300, 600, 257


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; equal infinities count as 0, unequal ones as inf."""
    a, b = a.double(), b.double()
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].max())


def profile(stem: str) -> MSVProfile:
    return MSVProfile.from_profile(parse_hmm(PROFILES / f"{stem}.hmm"))


def kernel_args(scanner, prof, staged):
    emit, consts = convert.device_profile(prof, scanner.device)
    m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
    return emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s


def compare(args) -> float:
    """Kernel against plain on the same inputs; returns max |d| over the
    scores and both carries, and requires exact equality."""
    got = msv_cuda.msv_scan_cuda(*args)
    torch.cuda.synchronize()
    want = msv_cuda.msv_scan_plain(*args)
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)), f"kernel != plain, max |d| {err}")
    return err


def chain_error(args) -> float:
    """Two kernel calls over L split at SPLIT against one call."""
    emit, tokens, lengths, tr_rows, consts, m, s = args
    whole = msv_cuda.msv_scan_cuda(*args)
    first = msv_cuda.msv_scan_cuda(
        emit, tokens[:, :SPLIT].contiguous(), lengths.clamp(max=SPLIT),
        tr_rows, consts, m, s,
    )
    second = msv_cuda.msv_scan_cuda(
        emit, tokens[:, SPLIT:].contiguous(), (lengths - SPLIT).clamp(min=0),
        tr_rows, consts, first[1], first[2],
    )
    torch.cuda.synchronize()
    err = max(max_abs_diff(a, b) for a, b in zip(second, whole))
    require(all(torch.equal(a, b) for a, b in zip(second, whole)), f"carry chain != one call, max |d| {err}")
    return err


def best_ms(fn, reps: int) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


def main() -> int:
    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    scanner = MSVScanner(device=dev)
    rng = np.random.default_rng(SEED)
    max_err = 0.0

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    print(log.strip())

    # 3. kernel against plain, all 24 profiles, ragged batch
    lengths = rng.integers(0, RAGGED_LEN + 1, size=RAGGED_BATCH).astype(np.int32)
    lengths[:12] = np.minimum([0, 1, 2, 31, 32, 33, 64, 96, 256, 257, 512, 600], RAGGED_LEN)
    tokens = rng.integers(0, 20, size=(RAGGED_BATCH, RAGGED_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    stems = sorted((p.stem for p in PROFILES.glob("*.hmm")), key=int)
    require(len(stems) == 24, f"24 profiles, found {len(stems)}")
    for stem in stems:
        args = kernel_args(scanner, profile(stem), staged)
        err = compare(args)
        chain = chain_error(args)
        max_err = max(max_err, err, chain)
        print(f"kernel vs plain {stem}.hmm: B={RAGGED_BATCH} L<={RAGGED_LEN} max|d|={err} "
              f"chain at {SPLIT}: max|d|={chain}")

    # 4. kernel against the oracle
    lengths8 = np.minimum([0, 1, 32, 100, 257, 1000, 2048, SEQ_LEN], SEQ_LEN).astype(np.int32)
    tokens8 = rng.integers(0, 20, size=(8, SEQ_LEN)).astype(np.int32)
    staged8 = scanner.stage(tokens8, lengths8)
    for stem in ("1400", "2405"):
        prof = profile(stem)
        got = scanner.scan(prof, staged8).cpu().numpy()
        want = msv_oracle_batch(prof, tokens8, lengths8)
        require(np.array_equal(got, want), f"kernel != oracle on {stem}.hmm")
        print(f"kernel vs oracle {stem}.hmm: 8 seqs, equal (max|d|=0.0)")

    # 5. main path at full width through the CLI
    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)[tokens]
    with tempfile.TemporaryDirectory() as tmp:
        fasta = pathlib.Path(tmp) / "headline.fsa"
        out = pathlib.Path(tmp) / "scan.tsv"
        t0 = time.perf_counter()
        write_fasta(fasta, [
            FastaRecord(f"seq{i}", letters[i].tobytes().decode()) for i in range(BATCH)
        ])
        print(f"wrote {fasta.stat().st_size} bytes of FASTA in {time.perf_counter() - t0:.2f} s")
        handler = _Records()
        logging.getLogger(cli.__name__).addHandler(handler)
        msv_cuda.msv_scan_cuda.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["scan", "--hmm", str(PROFILES / "1400.hmm"), "--fasta", str(fasta),
                       "--device", DEVICE, "--format", "tsv", "--out", str(out)])
        e2e = time.perf_counter() - t0
        launches = msv_cuda.msv_scan_cuda.launches
        logging.getLogger(cli.__name__).removeHandler(handler)
        require(rc == 0, f"scan exited {rc}")
        require(launches > 0, "the CLI scan did not launch the kernel")
        rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
    require(len(rows) == BATCH, f"{len(rows)} report rows, expected {BATCH}")
    require(all(np.isfinite(float(r[2])) for r in rows), "non-finite score in the report")
    top = [int(r[0][3:]) for r in rows[:8]]
    want = msv_oracle_batch(profile("1400"), tokens[top], np.full(8, SEQ_LEN, dtype=np.int32))
    for r, w in zip(rows[:8], want):
        require(r[2] == str(round(float(w), 4)), f"report row {r[0]}: {r[2]} != oracle {w}")
    phases = next(r for r in handler.records if r.msg.startswith("seconds:"))
    parse_s, stage_s, scan_s, report_s, total_s = phases.args
    print(f"main path: scan {BATCH} x {SEQ_LEN} vs 1400.hmm via the CLI: {len(rows)} rows, "
          f"kernel launches {launches}, top 8 equal to the oracle")
    print(f"main path seconds: parse {parse_s:.3f} stage {stage_s:.3f} scan {scan_s:.3f} "
          f"report {report_s:.3f} cli total {total_s:.3f} end-to-end {e2e:.3f}")

    # 6. kernel against plain and timings at the main path's shape
    staged = scanner.stage(tokens, np.full(BATCH, SEQ_LEN, dtype=np.int32))
    timings = {}
    for stem, label in (("1400", "GCUPS_M1400"), ("2405", "headline_2405")):
        prof = profile(stem)
        args = kernel_args(scanner, prof, staged)
        err = compare(args)
        max_err = max(max_err, err)
        cells = staged.total_residues * prof.num_states
        ms = best_ms(lambda: msv_cuda.msv_scan_cuda(*args), reps=3)
        timings[stem] = ms
        print(f"{label}: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{BATCH} x {SEQ_LEN} x M={prof.num_states}; kernel vs plain max|d|={err})")
        if stem == "1400":
            plain_ms = best_ms(lambda: msv_cuda.msv_scan_plain(*args), reps=2)
            print(f"plain_GCUPS_M1400: {cells / plain_ms / 1e6:.2f} GCUPS "
                  f"({plain_ms:.3f} ms, best of 2)")
    print("card after timing:", nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))

    print(json.dumps({"kernels": [{
        "name": "msv_scan",
        "route": "cuda",
        "source": "hmm_fasta_viterbi_tpu_torch/csrc/msv_kernel.cu",
        "replaces": "hmm_fasta_viterbi_tpu/ops/pallas_msv.py:100",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timings["1400"],
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
