"""The port's benchmark: prints ONE JSON line with the headline
metric, the counterpart of the root ``bench.py``.

    python -m hmm_fasta_viterbi_tpu_torch.bench [--device cuda|cpu] [--quick] ...

Headline: GCUPS of the exact MSV scan (B1) of 1400.hmm against a staged
batch of 16384 random 3500-residue sequences (``random_tokens(batch,
seq_len, seed=0)``, uploaded before the timed region), best of ``--reps``
wall-clock runs of ``MSVScanner.scan`` each synced by a host copy of the
scores. Then ``bench.py``'s rows in its order (``rows``), each with its
``--no-*`` switch: the 24-profile sweep, the MSV filter, the M=2405
headline, the Viterbi/Forward/Viterbi-filter stages, the cascades, the
posterior decode (with the stages), the streamed search, the NumPy
oracle, the reference pass, and with ``--e2e`` the headline batch end to
end. The headline's scores must all be finite before the line is printed.

Differences from ``bench.py``: ``--device cuda|cpu`` (default cuda)
answers ``--impl`` and ``--platform``, and a CUDA run without a card
raises; the detail goes to ``--detail-file``; every run is strict (no
``--strict``): a row that fails raises, the run exits non-zero and prints
no line, so ``errors`` is always ``[]``; there is no device probe.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from ..io.hmmio import parse_hmm
from ..models.msv import MSVProfile
from ..pipeline import MSVScanner
from . import rows
from .harness import bench_staged, emit_json_line, random_tokens

REPO = pathlib.Path(__file__).resolve().parents[2]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m hmm_fasta_viterbi_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernels (raises without a card); cpu: the plain versions")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--seq-len", type=int, default=3500)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true", help="small batch smoke run")
    ap.add_argument("--no-sweep", dest="sweep", action="store_false",
                    help="skip the 24-profile sweep (benchmark_MSV.cpp equivalent)")
    ap.add_argument("--e2e", action="store_true", help="also time the headline end to end")
    ap.add_argument("--no-stages", dest="stages", action="store_false",
                    help="skip the Viterbi/Forward stage and posterior decode timings")
    ap.add_argument("--no-filter", dest="filter", action="store_false",
                    help="skip the upper-bound MSV prefilter timing")
    ap.add_argument("--no-m2405", dest="m2405", action="store_false",
                    help="skip the M=2405 headline timing")
    ap.add_argument("--no-cascade", dest="cascade", action="store_false",
                    help="skip the search-cascade timings")
    ap.add_argument("--no-oracle", dest="oracle", action="store_false",
                    help="skip the NumPy sequential oracle context row")
    ap.add_argument("--no-stream", dest="stream_search", action="store_false",
                    help="skip the streamed search over a generated FASTA")
    ap.add_argument("--stream-seqs", type=int, default=16384,
                    help="streamed-search corpus size in sequences (x --seq-len residues "
                    "each; default 16384 x 3500 = 57 Mres)")
    ap.add_argument("--detail-file", default=str(REPO / "bench_detail_torch.json"),
                    help="where the per-rep detail goes (default: bench_detail_torch.json "
                    "at the repo root)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.quick:
        args.batch = min(args.batch, 128)
        args.reps = 2
    scanner = MSVScanner(device=args.device)
    print(f"# device={scanner.device} batch={args.batch} L={args.seq_len}", file=sys.stderr)

    tokens, lengths = random_tokens(args.batch, args.seq_len, seed=0)
    hmm = parse_hmm(rows.PROFILE_DIR / "1400.hmm")
    headline = MSVProfile.from_profile(hmm)
    bench = rows.Bench(args, scanner, tokens, lengths, scanner.stage(tokens, lengths), hmm,
                       headline)
    primary = bench_staged(bench.name("headline_1400"), scanner, headline, bench.staged,
                           args.reps)
    rows.log(f"headline: {primary.gcups:.2f} GCUPS ({primary.seconds * 1e3:.1f} ms)")

    extras = []
    for enabled, row in (
        (args.sweep, rows.sweep),
        (args.filter, rows.filter_1400),
        (args.m2405, rows.headline_2405),
        (args.stages, rows.stages),
        (args.cascade, rows.cascade),
        (args.stages, rows.posterior),
        (args.stream_search, rows.stream_search),
        (args.oracle, rows.oracle),
        (True, rows.ref_b3),
        (args.e2e, rows.e2e),
    ):
        if enabled:
            extras += row(bench)

    scores = scanner.scan(headline, bench.staged).cpu().numpy()
    if not np.all(np.isfinite(scores)):
        raise RuntimeError("benchmark scan produced non-finite scores")
    print(emit_json_line(primary, extras, detail_path=args.detail_file, device=scanner.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
