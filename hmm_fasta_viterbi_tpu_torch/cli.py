"""Command-line interface of the PyTorch port.

    python -m hmm_fasta_viterbi_tpu_torch scan --hmm P.hmm --fasta DB.fsa

The MSV scan of ``hmm_fasta_viterbi_tpu``'s ``scan`` with the same flags
and the same TSV/JSON report; ``--device`` (default ``cuda``) names the
torch device, and ``--device cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
import time

import numpy as np
import torch

from hmm_fasta_viterbi_tpu.io.loader import load_fasta, load_profile
from hmm_fasta_viterbi_tpu.models import stats
from hmm_fasta_viterbi_tpu.models.msv import MSVProfile

from .pipeline import MSVScanner

logger = logging.getLogger(__name__)


def _finite_or_none(x) -> float | None:
    """JSON-safe float: json.dump's bare ``NaN`` is invalid JSON for strict
    parsers, so a non-finite p/E-value becomes null."""
    x = float(x)
    return x if np.isfinite(x) else None


def _fmt_e(x) -> str:
    """TSV cell for a possibly-null p/E-value."""
    return "nan" if x is None else f"{x:.3e}"


@contextlib.contextmanager
def _out_sink(args):
    """The report sink: ``--out`` or stdout."""
    if args.out:
        with open(args.out, "w") as fh:
            yield fh
    else:
        yield sys.stdout


def _report(profile, db, scores: np.ndarray, args, out) -> None:
    bits = stats.nats_to_bits(scores)
    pvals = stats.msv_pvalue(scores, profile)
    evals = stats.evalue(pvals, len(db))
    order = np.argsort(-scores)
    if args.top:
        order = order[: args.top]
    rows = []
    for i in order:
        if args.max_evalue is not None and evals[i] > args.max_evalue:
            continue
        rows.append(
            {
                "target": db.records[i].header or f"seq{i}",
                "profile": profile.name,
                "score_nats": round(float(scores[i]), 4),
                "score_bits": round(float(bits[i]), 4),
                "pvalue": _finite_or_none(pvals[i]),
                "evalue": _finite_or_none(evals[i]),
            }
        )
    if args.format == "json":
        json.dump(rows, out, indent=1)
        out.write("\n")
    else:
        out.write("# target\tprofile\tscore_nats\tscore_bits\tpvalue\tevalue\n")
        for r in rows:
            out.write(
                f"{r['target']}\t{r['profile']}\t{r['score_nats']}\t"
                f"{r['score_bits']}\t{_fmt_e(r['pvalue'])}\t{_fmt_e(r['evalue'])}\n"
            )


def cmd_scan(args) -> int:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error(
            "--device %s: torch.cuda.is_available() is false (no CUDA card or "
            "a CPU-only torch); pass --device cpu to run the plain version",
            args.device,
        )
        return 2
    if args.out:
        open(args.out, "w").close()  # fail fast on a bad --out path
    t_start = time.perf_counter()
    hmm = load_profile(args.hmm, prefer=args.loader)
    db = load_fasta(args.fasta, prefer=args.loader)
    if not len(db):
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    tokens, lengths = db.encode()
    scanner = MSVScanner(device=device)
    t0 = time.perf_counter()
    profile = MSVProfile.from_profile(hmm)
    staged = scanner.stage(tokens, lengths)
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the upload belongs to the stage time
    t_staged = time.perf_counter()
    scores = scanner.scan(profile, staged).cpu().numpy()
    t_scanned = time.perf_counter()
    dt = t_scanned - t0
    cells = int(lengths.astype(np.int64).sum()) * profile.num_states
    logger.info(
        "scanned %d seqs x %s (%s) in %.3fs (%.2f GCUPS)",
        len(db), hmm.name, args.stage, dt, cells / dt / 1e9,
    )
    with _out_sink(args) as sink:
        _report(hmm, db, scores, args, out=sink)
    logger.info(
        "seconds: parse %.6f stage %.6f scan %.6f report %.6f total %.6f",
        t0 - t_start, t_staged - t0, t_scanned - t_staged,
        time.perf_counter() - t_scanned, time.perf_counter() - t_start,
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hmm_fasta_viterbi_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="command", required=True)

    scan = sub.add_parser("scan", help="scan a FASTA database against one profile")
    scan.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    scan.add_argument("--fasta", required=True, help="protein FASTA database")
    scan.add_argument(
        "--stage", default="msv", choices=["msv"],
        help="scoring stage (the port has the MSV filter so far)",
    )
    scan.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (the kernel) or cpu (its plain version)",
    )
    scan.add_argument("--format", default="tsv", choices=["tsv", "json"])
    scan.add_argument("--top", type=int, default=0, help="report only the top K hits (0 = all)")
    scan.add_argument("--max-evalue", type=float, default=None, help="E-value cutoff")
    scan.add_argument(
        "--loader", default="auto", choices=["auto", "native", "python"],
        help="data loader: native C++ fast path or pure-Python parsers",
    )
    scan.add_argument("--out", default=None, help="write results to FILE instead of stdout")
    scan.set_defaults(fn=cmd_scan)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    try:
        return args.fn(args)
    except (FileNotFoundError, IsADirectoryError) as e:
        logger.error("%s", e)
        return 2
    except ValueError as e:  # HMMParseError / FastaParseError / bad inputs
        logger.error("%s", e)
        return 2
