"""Time the bucketed MSV scan on the card: a launch a bucket against one
launch over the row table, one JSON line a case.

    python3 tools/torch_bucketed_timing.py [--profiles 100,1400,2405] [--reps 3] [--wide]

The database is the proteome configuration's rows
(``hmmbench/configs/pfam_scan_proteome.json`` through
``hmmbench.traffic.generator.config_lengths``: its lognormal fit's
quantiles and its four longest entries, titin 34,350 first), residues
drawn from a seed, staged once by ``MSVScanner.stage_bucketed``. For each
profile (default 100.hmm, 1400.hmm and 2405.hmm: the register cases of
PER 4, 44 and 76) in exact and filter modes the line gives each bucket's
rows, longest row and launch time (``MSVScanner.scan`` or ``scan_filter``
on the bucket, its carry fill included), their sum, the bucket-at-a-time
scan whole (every bucket's launch and the scatter to the original order),
and the one launch over the row table (``scan_bucketed``'s), each the best
of ``--reps`` CUDA-event timings after a warm-up; and whether the two
scans' scores are equal bit for bit (the script exits 1 if any is not).
Beside them, in steps of one warp: the buckets' longest rows summed (what
a launch a bucket waits on) and the busiest warp's rows summed in the one
launch, as ``msv_cuda.table_walk`` hands the rows out.
First, one line a register case: its registers and spill bytes at its
block size (``msv_cuda.kernel_attrs``).

``--wide`` also holds the one launch against the bucket-at-a-time scan,
bit for bit and untimed, on the wider cases (joins of the repo's profiles:
LENG 4770 on the cluster pair, 6977 on 3-block clusters, 60362 on the
16-block clusters of 8-warp blocks and, under
``chip_smoke.no_block_clusters``, on the rows-in-memory case), over the
four longest rows and 2044 of the body, with the launch counters.

Each line gives the card's name and power limit. Needs one CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hmm_fasta_viterbi_tpu_torch import MSVProfile, MSVScanner, parse_hmm  # noqa: E402
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda  # noqa: E402
from hmmbench.traffic import generator  # noqa: E402

PROFILES = ROOT / "data" / "profile_HMMs"
SEED = 20261018
WIDE_JOINS = (("2405", "2365"), chip_smoke.MEM_JOINS[0], chip_smoke.MSV_MEM_JOIN)
WIDE_BODY = 2044


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    return out.splitlines()[0] if out else "not read"


def best_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
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


def database(rows: np.ndarray | None = None):
    """The proteome configuration's lengths (a subset ``rows`` of them) in
    a seeded order, and seeded random residues."""
    return chip_smoke.proteome_database(rows, SEED)


def per_bucket(scanner, profile, bucketed, mode: str) -> torch.Tensor:
    """The bucket-at-a-time scan: a launch a bucket, scattered back."""
    scan = scanner.scan if mode == "exact" else scanner.scan_filter
    return bucketed.in_order([scan(profile, staged) for staged in bucketed.buckets])


def one_launch(scanner, profile, bucketed, mode: str) -> torch.Tensor:
    return scanner._scan_table(profile, bucketed.table, mode)


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def timings(scanner, profiles, reps: int, gpu: str) -> bool:
    tokens, lengths = database()
    bucketed = scanner.stage_bucketed(tokens, lengths)
    torch.cuda.synchronize()
    table_lengths = bucketed.table.lengths.cpu().numpy()
    ok = True
    for profile in profiles:
        m_pad = msv_cuda.round_up(profile.num_states, scanner.m_bucket)
        plan = msv_cuda.device_plan(m_pad, 4, int(lengths.size), 1, scanner.device)
        lanes = msv_cuda.device_case(m_pad, 4, scanner.device)[0]
        busiest = max(sum(int(table_lengths[r]) for r in rows)
                      for rows in msv_cuda.table_walk(table_lengths, lanes, plan))
        for mode in ("exact", "filter"):
            scan = scanner.scan if mode == "exact" else scanner.scan_filter
            buckets = [{"rows": s.num_sequences, "longest": int(lengths[idx].max()),
                        "ms": best_ms(lambda s=s: scan(profile, s), reps)}
                       for idx, s in zip(bucketed.order, bucketed.buckets)]
            equal = bool(torch.equal(one_launch(scanner, profile, bucketed, mode),
                                     per_bucket(scanner, profile, bucketed, mode)))
            ok &= equal
            emit({
                "profile": profile.name, "states": profile.num_states,
                "case": msv_cuda.kernel_case(m_pad), "mode": mode, "rows": int(lengths.size),
                "residues": int(lengths.astype(np.int64).sum()), "buckets": buckets,
                "bucket_sum_ms": sum(b["ms"] for b in buckets),
                "per_bucket_ms": best_ms(lambda: per_bucket(scanner, profile, bucketed, mode),
                                         reps),
                "one_launch_ms": best_ms(lambda: one_launch(scanner, profile, bucketed, mode),
                                         reps),
                "steps_bucket_longest": sum(b["longest"] for b in buckets),
                "steps_busiest_warp": busiest,
                "plan": plan._asdict(), "bit_equal": equal, "card": gpu,
            })
    return ok


def wide_checks(scanner, gpu: str) -> bool:
    total = generator.config_lengths(json.loads(chip_smoke.PROTEOME_CONFIG.read_text())).size
    rows = np.concatenate([np.linspace(0, total - 5, WIDE_BODY).astype(np.int64),
                           np.arange(total - 4, total)])
    tokens, lengths = database(rows)
    bucketed = scanner.stage_bucketed(tokens, lengths)
    ok = True
    routes = [(stems, False) for stems in WIDE_JOINS] + [(WIDE_JOINS[-1], True)]
    for stems, mem in routes:
        profile = MSVProfile.from_profile(chip_smoke.wide_profile(stems))
        for mode in ("exact", "filter"):
            chip_smoke.zero_launches()
            if mem:
                with chip_smoke.no_block_clusters():
                    got = one_launch(scanner, profile, bucketed, mode)
                    want = per_bucket(scanner, profile, bucketed, mode)
            else:
                got = one_launch(scanner, profile, bucketed, mode)
                want = per_bucket(scanner, profile, bucketed, mode)
            equal = bool(torch.equal(got, want))
            ok &= equal
            fn = msv_cuda.msv_table_scan_cuda
            emit({"wide": profile.name[:40], "states": profile.num_states, "mode": mode,
                  "route": "mem" if mem else "clusters", "rows": int(lengths.size),
                  "buckets": len(bucketed.buckets), "bit_equal": equal,
                  "table_launches": fn.launches, "table_mem": fn.mem_launches,
                  "table_wide": fn.wide_launches, "table_clusters": fn.cluster_launches,
                  "table_cluster256": fn.block_cluster_launches, "card": gpu})
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profiles", default="100,1400,2405")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--wide", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gpu = card()
    for per in msv_cuda.KERNEL_PER:
        warps = msv_cuda.PLAN_WARPS[per]
        for bf16 in (False, True):
            regs, spill = msv_cuda.kernel_attrs(32, per, warps, bf16)
            emit({"attrs": per, "warps": warps, "bf16": bf16, "registers": regs,
                  "spill_bytes": spill})
    scanner = MSVScanner(device="cuda")
    profiles = [MSVProfile.from_profile(parse_hmm(PROFILES / f"{s}.hmm"))
                for s in args.profiles.split(",") if s]
    ok = timings(scanner, profiles, args.reps, gpu)
    if args.wide:
        ok &= wide_checks(scanner, gpu)
    emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
