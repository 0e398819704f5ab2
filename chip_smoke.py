"""On-card smoke test of the PyTorch port (hmm_fasta_viterbi_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (device 0) and the CUDA toolkit's nvcc. In order:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: compiles csrc/*.cu from this checkout, one nvcc a source;
3. MSV kernel against plain: for all 24 profiles of data/profile_HMMs, the
   MSV kernel and its plain PyTorch version on one ragged batch, and a
   two-call carry chain against one call, must be equal (max |d| = 0.0);
4. MSV kernel against the NumPy oracle on 8 sequences of 1400.hmm and
   2405.hmm;
5. Viterbi and Forward kernels against plain, all 24 profiles, on a ragged
   batch of 64 sequences up to 600 residues (lengths 0, 1, 31, 32, 33, 257
   among them): eager Viterbi == plain, lazy == eager (scores and carries,
   bit for bit), lazy at lazy_k = 1 on 100.hmm replays chunks and equals
   the plain lazy version, replay counts included; Forward within FWD_TOL
   of plain; two-call carry chains equal one call (Forward split at a
   multiple of FWD_RESCALE_GROUP);
6. Viterbi and Forward kernels against the oracles on short sequences of
   100.hmm and 1400.hmm (1e-4, 2e-3);
7. main paths, each with every launch count set to 0 just before it and
   read just after, on a seeded FASTA of 16384 x 3500 random residues with
   32 sequences sampled from 1400.hmm at known rows:
   `scan --stage msv` (the MSV kernel; the top 8 rows equal the oracle),
   `scan --stage search` (MSV, then the lazy Viterbi and the Forward
   kernels; every planted row is a hit; survivor counts and per-phase
   seconds printed), `scan --stage viterbi` and `--stage forward` (every
   row scored, the planted rows on top), and the single-stage Viterbi entry
   with lazy=False at 4096 x 3500 (the eager kernel);
8. timings with CUDA events: the MSV kernel (best of 3) at 16384 x 3500
   against 1400.hmm and 2405.hmm and its plain version at 1400.hmm; the
   lazy and eager Viterbi and the Forward kernels (best of 3) at 4096 x
   3500 against 1400.hmm, the lazy fire rate, and each plain version once
   at that shape, held against the kernel.

Prints a JSON line about the kernels and, last, {"ok": true, ...}. Any
failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hmm_fasta_viterbi_tpu.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu.io.loader import load_profile
from hmm_fasta_viterbi_tpu.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu_torch import (
    MSVProfile, MSVScanner, P7Profile, forward_oracle_batch, msv_oracle_batch, parse_hmm,
    viterbi_oracle_batch,
)
from hmm_fasta_viterbi_tpu_torch import cli, convert
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda, p7_cuda
from hmm_fasta_viterbi_tpu_torch.pipeline import viterbi_scores

REPO = pathlib.Path(__file__).resolve().parent
PROFILES = REPO / "data" / "profile_HMMs"
DEVICE = "cuda:0"
SEED = 0
# bench.py's headline batch: 16384 random sequences of 3500 residues
BATCH, SEQ_LEN = 16384, 3500
# the MSV ragged batch of the 24-profile check, and its carry-chain split
# (not a multiple of 32, the kernel's token group)
RAGGED_BATCH, RAGGED_LEN, SPLIT = 300, 600, 257
# the Viterbi/Forward ragged batch and its split: a multiple of the
# Forward rescale group, not of the kernels' 128-residue chunk
P7_BATCH, P7_SPLIT = 64, 200
# the bench's Viterbi/Forward stage shape (viterbi_1400, forward_1400)
STAGE_BATCH = 4096
PLANTED = 32
VIT_TOL, FWD_TOL = 1e-4, 2e-3

KERNELS = {
    "msv_scan": ("csrc/msv_kernel.cu", "hmm_fasta_viterbi_tpu/ops/pallas_msv.py:100"),
    "viterbi_scan": ("csrc/p7_viterbi_kernel.cu", "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:166"),
    "viterbi_lazy_scan": ("csrc/p7_viterbi_kernel.cu",
                          "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:923"),
    "forward_prob_scan": ("csrc/p7_forward_kernel.cu",
                          "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:474"),
}
WRAPPERS = {
    "msv_scan": msv_cuda.msv_scan_cuda,
    "viterbi_scan": p7_cuda.viterbi_scan_cuda,
    "viterbi_lazy_scan": p7_cuda.viterbi_lazy_scan_cuda,
    "forward_prob_scan": p7_cuda.forward_prob_scan_cuda,
}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; equal infinities count as 0, unequal ones as inf."""
    a, b = a.double().cpu(), b.double().cpu()
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].max())


def require_equal(got, want, what: str) -> float:
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    require(all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)),
            f"{what}: not equal, max |d| {err}")
    return err


def profile(stem: str) -> MSVProfile:
    return MSVProfile.from_profile(parse_hmm(PROFILES / f"{stem}.hmm"))


def p7_profile(stem: str) -> P7Profile:
    return P7Profile.from_profile(parse_hmm(PROFILES / f"{stem}.hmm"))


def zero_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


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


def once_ms(fn):
    """One CUDA-event timing of ``fn``; returns (ms, result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line a compiled kernel case from nvcc's -Xptxas -v output:
    registers, spill stores/loads and shared memory, and the seconds each
    source took."""
    lines = [line for line in log.splitlines() if line.startswith(("$ nvcc", "built "))]
    for entry in re.split(r"Compiling entry function ", log)[1:]:
        case = re.search(r"(msv_kernel|viterbi_kernel|forward_kernel)ILi(\d+)E(?:Lb(\d))?",
                         entry.split("'")[1])
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        if case and regs:
            mode = {None: "", "0": ",eager", "1": ",lazy"}[case.group(3)]
            lines.append(
                f"{case.group(1)}<{case.group(2)}{mode}>: {regs.group(1)} registers, spill "
                f"{spill.group(1) if spill else '?'}/{spill.group(2) if spill else '?'} bytes, "
                f"smem {smem.group(1) if smem else 0} bytes"
            )
    return lines


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)


# -- MSV (phases 3, 4) ---------------------------------------------------------

def msv_args(scanner, prof, staged):
    emit, consts = convert.device_profile(prof, scanner.device)
    m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
    return emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s


def msv_compare(args) -> float:
    got = msv_cuda.msv_scan_cuda(*args)
    torch.cuda.synchronize()
    return require_equal(got, msv_cuda.msv_scan_plain(*args), "MSV kernel vs plain")


def msv_chain_error(args) -> float:
    emit, tokens, lengths, tr_rows, consts, m, s = args
    whole = msv_cuda.msv_scan_cuda(*args)
    first = msv_cuda.msv_scan_cuda(
        emit, tokens[:, :SPLIT].contiguous(), lengths.clamp(max=SPLIT), tr_rows, consts, m, s,
    )
    second = msv_cuda.msv_scan_cuda(
        emit, tokens[:, SPLIT:].contiguous(), (lengths - SPLIT).clamp(min=0),
        tr_rows, consts, first[1], first[2],
    )
    torch.cuda.synchronize()
    return require_equal(second, whole, "MSV carry chain vs one call")


# -- Viterbi / Forward (phases 5, 6) -------------------------------------------

def p7_calls(kind: str, pack, staged):
    """``(run(tokens, lengths, carry), fresh carry)`` of one p7 scan."""
    if kind == "forward":
        carry = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)

        def run(fn, tokens, lengths, c):
            return fn(*pack[:4], tokens, lengths, staged.tr_rows, staged.tr_probs,
                      pack.consts, *c)
    else:
        carry = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)

        def run(fn, tokens, lengths, c):
            args = (*pack[:4], tokens, lengths, staged.tr_rows, pack.consts, *c)
            return fn(*args, pack.lazy_k) if kind == "lazy" else fn(*args)
    return run, carry


CUDA_FNS = {"eager": p7_cuda.viterbi_scan_cuda, "lazy": p7_cuda.viterbi_lazy_scan_cuda,
            "forward": p7_cuda.forward_prob_scan_cuda}
PLAIN_FNS = {"eager": p7_cuda.viterbi_scan_plain, "lazy": p7_cuda.viterbi_lazy_scan_plain,
             "forward": p7_cuda.forward_prob_scan_plain}


def p7_chain_error(kind: str, pack, staged) -> float:
    """Two kernel calls split at P7_SPLIT against one call (bit for bit)."""
    run, carry = p7_calls(kind, pack, staged)
    fn = CUDA_FNS[kind]
    whole = run(fn, staged.tokens, staged.lengths, carry)
    first = run(fn, staged.tokens[:, :P7_SPLIT].contiguous(),
                staged.lengths.clamp(max=P7_SPLIT), carry)
    second = run(fn, staged.tokens[:, P7_SPLIT:].contiguous(),
                 (staged.lengths - P7_SPLIT).clamp(min=0), first[1:5])
    torch.cuda.synchronize()
    return require_equal(second[:5], whole[:5], f"{kind} carry chain vs one call")


def pre_diag(pack, m, i, d):
    tmm, _, _, tim, _, tdm = pack.trans[:6]
    return torch.maximum(torch.maximum(m + tmm, i + tim), d + tdm)


def p7_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    lengths = rng.integers(0, RAGGED_LEN + 1, size=P7_BATCH).astype(np.int32)
    lengths[:10] = [0, 1, 31, 32, 33, 257, 128, 129, 600, 599]
    tokens = rng.integers(0, 20, size=(P7_BATCH, RAGGED_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    stems = sorted((p.stem for p in PROFILES.glob("*.hmm")), key=int)
    for stem in stems:
        p7 = p7_profile(stem)
        eager_pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
        lazy_pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=True)
        fwd_pack = p7_cuda.forward_pack(p7, scanner.device)
        run_e, carry_v = p7_calls("eager", eager_pack, staged)
        run_l, _ = p7_calls("lazy", lazy_pack, staged)
        run_f, carry_f = p7_calls("forward", fwd_pack, staged)
        eager = run_e(p7_cuda.viterbi_scan_cuda, staged.tokens, staged.lengths, carry_v)
        lazy = run_l(p7_cuda.viterbi_lazy_scan_cuda, staged.tokens, staged.lengths, carry_v)
        fwd = run_f(p7_cuda.forward_prob_scan_cuda, staged.tokens, staged.lengths, carry_f)
        torch.cuda.synchronize()
        plain = run_e(p7_cuda.viterbi_scan_plain, staged.tokens, staged.lengths, carry_v)
        e_err = require_equal(eager, plain, f"{stem}.hmm eager Viterbi kernel vs plain")
        l_err = require_equal(
            (lazy[0], lazy[1], lazy[2], lazy[3], lazy[4]),
            (eager[0], eager[1], eager[2], pre_diag(eager_pack, *eager[1:4]), eager[4]),
            f"{stem}.hmm lazy Viterbi kernel vs eager kernel",
        )
        fwd_plain = run_f(p7_cuda.forward_prob_scan_plain, staged.tokens, staged.lengths, carry_f)
        f_err = max_abs_diff(fwd[0], fwd_plain[0])
        require(f_err <= FWD_TOL, f"{stem}.hmm Forward kernel vs plain: max |d| {f_err}")
        chains = [p7_chain_error(k, pk, staged)
                  for k, pk in (("eager", eager_pack), ("lazy", lazy_pack), ("forward", fwd_pack))]
        errors["viterbi_scan"] = max(errors["viterbi_scan"], e_err, chains[0])
        errors["viterbi_lazy_scan"] = max(errors["viterbi_lazy_scan"], l_err, chains[1])
        errors["forward_prob_scan"] = max(errors["forward_prob_scan"], f_err, chains[2])
        print(f"p7 kernels vs plain {stem}.hmm: B={P7_BATCH} L<={RAGGED_LEN} eager max|d|={e_err} "
              f"lazy(k={lazy_pack.lazy_k}) vs eager max|d|={l_err} replays={int(lazy[5].sum())} "
              f"forward(W={fwd_pack.chain.shape[0]}) max|d|={f_err:.3g}; chains at {P7_SPLIT} "
              f"max|d|={max(chains)}", flush=True)

    # lazy_k = 1 on 100.hmm: the certificate fires, the replay is counted
    k1 = p7_cuda.viterbi_pack(p7_profile("100"), scanner.device, lazy=True, lazy_k=1)
    run_k1, carry_k1 = p7_calls("lazy", k1, staged)
    got = run_k1(p7_cuda.viterbi_lazy_scan_cuda, staged.tokens, staged.lengths, carry_k1)
    torch.cuda.synchronize()
    want = run_k1(p7_cuda.viterbi_lazy_scan_plain, staged.tokens, staged.lengths, carry_k1)
    err = require_equal(got, want, "100.hmm lazy_k=1 kernel vs plain (replays included)")
    replays = int(got[5].sum())
    require(replays > 0, "lazy_k=1 on 100.hmm replayed no chunk")
    errors["viterbi_lazy_scan"] = max(errors["viterbi_lazy_scan"], err)
    print(f"lazy_k=1 on 100.hmm: {replays} chunks replayed, equal to plain (max|d|={err})")


def p7_kernels_vs_oracle(scanner, rng, errors: dict) -> None:
    lengths = np.array([0, 1, 100, 300], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 300)).astype(np.int32)
    for stem in ("100", "1400"):
        p7 = p7_profile(stem)
        staged = scanner.stage(tokens, lengths)
        vit = scanner.scan_p7(p7, staged, "viterbi").cpu().numpy()
        eager = viterbi_scores(p7, tokens, lengths, device=scanner.device, lazy=False).cpu().numpy()
        fwd = scanner.scan_p7(p7, staged, "forward").cpu().numpy()
        want_v = viterbi_oracle_batch(p7, tokens, lengths)
        want_f = forward_oracle_batch(p7, tokens, lengths)
        v_err = max(max_abs_diff(torch.from_numpy(x), torch.from_numpy(want_v)) for x in (vit, eager))
        f_err = max_abs_diff(torch.from_numpy(fwd), torch.from_numpy(want_f))
        require(v_err <= VIT_TOL, f"{stem}.hmm Viterbi kernels vs oracle: max |d| {v_err}")
        require(f_err <= FWD_TOL, f"{stem}.hmm Forward kernel vs oracle: max |d| {f_err}")
        print(f"p7 kernels vs oracle {stem}.hmm: lengths {lengths.tolist()} Viterbi (lazy, eager) "
              f"max|d|={v_err} (tol {VIT_TOL}), Forward max|d|={f_err:.3g} (tol {FWD_TOL})")


# -- main paths (phase 7) ------------------------------------------------------

def write_database(rng, path: pathlib.Path):
    """16384 random sequences of 3500 residues with PLANTED sequences
    sampled from 1400.hmm at known rows; returns (tokens, lengths, rows)."""
    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    lengths = np.full(BATCH, SEQ_LEN, dtype=np.int32)
    stride = BATCH // PLANTED
    rows = (np.arange(PLANTED) * stride + stride // 3).astype(np.int64)
    for row, seq in zip(rows, sample_sequences(parse_hmm(PROFILES / "1400.hmm"), PLANTED,
                                               seed=SEED)):
        seq = seq[:SEQ_LEN]
        tokens[row, : len(seq)] = seq
        lengths[row] = len(seq)
    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)[tokens]
    write_fasta(path, [
        FastaRecord(f"seq{i}", letters[i, : lengths[i]].tobytes().decode()) for i in range(BATCH)
    ])
    return tokens, lengths, rows


def run_cli(argv):
    handler = _Records()
    logging.getLogger(cli.__name__).addHandler(handler)
    zero_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    e2e = time.perf_counter() - t0
    counts = launches()
    logging.getLogger(cli.__name__).removeHandler(handler)
    require(rc == 0, f"{' '.join(argv[:3])} exited {rc}")
    phases = next(r for r in handler.records if r.msg.startswith("seconds:"))
    return counts, e2e, phases.args, handler.records


def print_seconds(label, args, e2e) -> None:
    parse_s, stage_s, msv_s, vit_s, fwd_s, report_s, total_s = args
    print(f"{label} seconds: parse {parse_s:.3f} stage {stage_s:.3f} msv {msv_s:.3f} "
          f"viterbi {vit_s:.3f} forward {fwd_s:.3f} report {report_s:.3f} "
          f"cli total {total_s:.3f} end-to-end {e2e:.3f}")


def main_paths(tmp: pathlib.Path, rng) -> dict:
    fasta = tmp / "headline.fsa"
    t0 = time.perf_counter()
    tokens, lengths, planted = write_database(rng, fasta)
    print(f"wrote {fasta.stat().st_size} bytes of FASTA ({PLANTED} planted homologs of "
          f"1400.hmm, lengths {int(lengths[planted].min())}-{int(lengths[planted].max())}) "
          f"in {time.perf_counter() - t0:.2f} s")
    hmm = str(PROFILES / "1400.hmm")
    counts = {}

    # scan --stage msv
    out = tmp / "scan.tsv"
    got, e2e, secs, _ = run_cli(["scan", "--hmm", hmm, "--fasta", str(fasta),
                                 "--device", DEVICE, "--out", str(out)])
    require(got["msv_scan"] > 0, "the MSV scan did not launch the MSV kernel")
    counts["msv_scan"] = got["msv_scan"]
    rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
    require(len(rows) == BATCH, f"{len(rows)} report rows, expected {BATCH}")
    require(all(np.isfinite(float(r[2])) for r in rows), "non-finite score in the report")
    top = np.array([int(r[0][3:]) for r in rows[:8]])
    # the profile as the CLI loads it (the native parser, where built, can
    # differ from parse_hmm in the last bit)
    cli_profile = MSVProfile.from_profile(load_profile(hmm))
    want = msv_oracle_batch(cli_profile, tokens[top].astype(np.int32), lengths[top])
    for r, w in zip(rows[:8], want):
        require(r[2] == str(round(float(w), 4)), f"report row {r[0]}: {r[2]} != oracle {w}")
    print(f"main path msv: scan {BATCH} x {SEQ_LEN} vs 1400.hmm via the CLI: {len(rows)} rows, "
          f"launches {got}, top 8 equal to the oracle")
    print_seconds("main path msv", secs, e2e)

    # scan --stage search
    out = tmp / "search.tsv"
    got, e2e, secs, records = run_cli(["scan", "--stage", "search", "--hmm", hmm, "--fasta",
                                       str(fasta), "--device", DEVICE, "--out", str(out)])
    require(got["msv_scan"] > 0, "the search did not launch the MSV kernel")
    require(got["viterbi_lazy_scan"] > 0, "the search did not launch the lazy Viterbi kernel")
    require(got["forward_prob_scan"] > 0, "the search did not launch the Forward kernel")
    counts["viterbi_lazy_scan"] = got["viterbi_lazy_scan"]
    counts["forward_prob_scan"] = got["forward_prob_scan"]
    rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
    hits = {int(r[0][3:]) for r in rows if r[7] == "1"}
    missed = sorted(set(planted.tolist()) - hits)
    require(not missed, f"planted homologs not reported as hits: rows {missed}")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    require(all(np.isfinite(float(r[2])) for r in rows), "non-finite msv_bits in the report")
    print(f"main path search: {summary}; {len(rows)} report rows, {len(hits)} hits, all "
          f"{PLANTED} planted rows among them; launches {got}")
    print_seconds("main path search", secs, e2e)

    # scan --stage viterbi / forward: every row scored, the planted ones on top
    for stage, kernel in (("viterbi", "viterbi_lazy_scan"), ("forward", "forward_prob_scan")):
        out = tmp / f"{stage}.tsv"
        got, e2e, secs, _ = run_cli(["scan", "--stage", stage, "--hmm", hmm, "--fasta",
                                     str(fasta), "--device", DEVICE, "--out", str(out)])
        require(got[kernel] > 0, f"scan --stage {stage} did not launch {kernel}")
        rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
        require(len(rows) == BATCH and all(np.isfinite(float(r[2])) for r in rows),
                f"scan --stage {stage}: {len(rows)} rows or a non-finite score")
        top = {int(r[0][3:]) for r in rows[:PLANTED]}
        require(top == set(planted.tolist()), f"scan --stage {stage}: planted rows not on top")
        print(f"main path {stage}: {len(rows)} rows, the {PLANTED} planted rows on top, "
              f"launches {got}")
        print_seconds(f"main path {stage}", secs, e2e)

    # the single-stage Viterbi entry, eager kernel, at the stage shape
    zero_launches()
    t0 = time.perf_counter()
    scores = viterbi_scores(p7_profile("1400"), tokens[:STAGE_BATCH], lengths[:STAGE_BATCH],
                            device=DEVICE, lazy=False).cpu().numpy()
    got = launches()
    require(got["viterbi_scan"] > 0, "viterbi_scores(lazy=False) did not launch the eager kernel")
    require(np.isfinite(scores).all() and scores.shape == (STAGE_BATCH,),
            "eager Viterbi entry: non-finite scores or wrong shape")
    counts["viterbi_scan"] = got["viterbi_scan"]
    print(f"main path viterbi entry (lazy=False): {STAGE_BATCH} x <= {SEQ_LEN} vs 1400.hmm in "
          f"{time.perf_counter() - t0:.3f} s, launches {got}")
    return counts


# -- timings (phase 8) ---------------------------------------------------------

def msv_timings(scanner, rng, errors: dict) -> dict:
    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(BATCH, SEQ_LEN, dtype=np.int32))
    out = {}
    for stem, label in (("1400", "GCUPS_M1400"), ("2405", "headline_2405")):
        prof = profile(stem)
        args = msv_args(scanner, prof, staged)
        err = msv_compare(args)
        errors["msv_scan"] = max(errors["msv_scan"], err)
        cells = staged.total_residues * prof.num_states
        ms = best_ms(lambda: msv_cuda.msv_scan_cuda(*args), reps=3)
        out[stem] = ms
        print(f"{label}: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{BATCH} x {SEQ_LEN} x M={prof.num_states}; kernel vs plain max|d|={err})")
        if stem == "1400":
            plain_ms = best_ms(lambda: msv_cuda.msv_scan_plain(*args), reps=2)
            out["plain"] = plain_ms
            print(f"plain_GCUPS_M1400: {cells / plain_ms / 1e6:.2f} GCUPS "
                  f"({plain_ms:.3f} ms, best of 2)")
    return out


def p7_timings(scanner, rng, errors: dict) -> dict:
    tokens = rng.integers(0, 20, size=(STAGE_BATCH, SEQ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(STAGE_BATCH, SEQ_LEN, dtype=np.int32))
    p7 = p7_profile("1400")
    cells = staged.total_residues * p7.num_states
    packs = {
        "viterbi_lazy_scan": ("lazy", p7_cuda.viterbi_pack(p7, scanner.device, lazy=True)),
        "viterbi_scan": ("eager", p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)),
        "forward_prob_scan": ("forward", p7_cuda.forward_pack(p7, scanner.device)),
    }
    out = {}
    for name, (kind, pack) in packs.items():
        run, carry = p7_calls(kind, pack, staged)
        ms = best_ms(lambda: run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry), reps=3)
        got = run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
        plain_ms, want = once_ms(lambda: run(PLAIN_FNS[kind], staged.tokens, staged.lengths, carry))
        if kind == "forward":
            err = max_abs_diff(got[0], want[0])
            require(err <= FWD_TOL, f"Forward kernel vs plain at the stage shape: {err}")
        else:
            err = require_equal(got, want, f"{kind} Viterbi kernel vs plain at the stage shape")
        errors[name] = max(errors[name], err)
        out[name] = (ms, plain_ms)
        extra = ""
        if kind == "lazy":
            chunks = STAGE_BATCH * -(-SEQ_LEN // p7_cuda.LAZY_CHUNK)
            fired = int(got[5].sum())
            extra = (f", lazy_k={pack.lazy_k}, {fired} of {chunks} chunks replayed "
                     f"({100.0 * fired / chunks:.4f}%)")
        print(f"{name}_1400: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{STAGE_BATCH} x {SEQ_LEN} x M={p7.num_states}{extra}); plain version "
              f"{plain_ms:.3f} ms ({cells / plain_ms / 1e6:.2f} GCUPS, once), kernel vs plain "
              f"max|d|={err:.3g}", flush=True)
    return out


def main() -> int:
    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    scanner = MSVScanner(device=dev)
    rng = np.random.default_rng(SEED)
    errors = dict.fromkeys(KERNELS, 0.0)

    with Phase("2. build"):
        lib_path, log = _build.build()
        print(f"library: {lib_path}")
        print("\n".join(ptxas_summary(log)))

    with Phase("3. MSV kernel vs plain, 24 profiles"):
        lengths = rng.integers(0, RAGGED_LEN + 1, size=RAGGED_BATCH).astype(np.int32)
        lengths[:12] = np.minimum([0, 1, 2, 31, 32, 33, 64, 96, 256, 257, 512, 600], RAGGED_LEN)
        tokens = rng.integers(0, 20, size=(RAGGED_BATCH, RAGGED_LEN)).astype(np.int8)
        staged = scanner.stage(tokens, lengths)
        stems = sorted((p.stem for p in PROFILES.glob("*.hmm")), key=int)
        require(len(stems) == 24, f"24 profiles, found {len(stems)}")
        for stem in stems:
            args = msv_args(scanner, profile(stem), staged)
            err = msv_compare(args)
            chain = msv_chain_error(args)
            errors["msv_scan"] = max(errors["msv_scan"], err, chain)
            print(f"kernel vs plain {stem}.hmm: B={RAGGED_BATCH} L<={RAGGED_LEN} max|d|={err} "
                  f"chain at {SPLIT}: max|d|={chain}")

    with Phase("4. MSV kernel vs oracle"):
        lengths8 = np.minimum([0, 1, 32, 100, 257, 1000, 2048, SEQ_LEN], SEQ_LEN).astype(np.int32)
        tokens8 = rng.integers(0, 20, size=(8, SEQ_LEN)).astype(np.int32)
        staged8 = scanner.stage(tokens8, lengths8)
        for stem in ("1400", "2405"):
            prof = profile(stem)
            got = scanner.scan(prof, staged8).cpu().numpy()
            require(np.array_equal(got, msv_oracle_batch(prof, tokens8, lengths8)),
                    f"kernel != oracle on {stem}.hmm")
            print(f"kernel vs oracle {stem}.hmm: 8 seqs, equal (max|d|=0.0)")

    with Phase("5. Viterbi/Forward kernels vs plain, 24 profiles"):
        p7_kernels_vs_plain(scanner, rng, errors)

    with Phase("6. Viterbi/Forward kernels vs oracle"):
        p7_kernels_vs_oracle(scanner, rng, errors)

    with Phase("7. main paths through the CLI and the entry point"):
        with tempfile.TemporaryDirectory() as tmp:
            counts = main_paths(pathlib.Path(tmp), rng)

    with Phase("8. timings"):
        msv_ms = msv_timings(scanner, rng, errors)
        p7_ms = p7_timings(scanner, rng, errors)
        print("card after timing:", nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))

    times = {"msv_scan": (msv_ms["1400"], msv_ms["plain"]), **p7_ms}
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"hmm_fasta_viterbi_tpu_torch/{source}",
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": errors[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
