"""Command-line interface of the PyTorch port.

    python -m hmm_fasta_viterbi_tpu_torch scan --hmm P.hmm --fasta DB.fsa
        [--stage msv|viterbi|forward|search] [--fast] [--fused] [--domains]
        [--align [--msa-out FILE]] [--bucketed | --stream N]
        [--config FILE] [--profile-trace DIR] [--mesh db=N[,sp=M]]
    python -m hmm_fasta_viterbi_tpu_torch sweep --hmm-dir DIR | --hmm-db FILE
        --fasta DB.fsa [--stage msv|search] [--fast] [--config FILE]
        [--bucketed | --stream N | --checkpoint DIR [--checkpoint-shard N]]
        [--mesh db=N[,sp=M]]
    python -m hmm_fasta_viterbi_tpu_torch align --hmm P.hmm --fasta F.fsa
        [--format tsv|json|stockholm] [--stream N]
    python -m hmm_fasta_viterbi_tpu_torch info --hmm P.hmm | --hmm-dir DIR | --hmm-db FILE
        [--consensus]
    python -m hmm_fasta_viterbi_tpu_torch build --msa MSA --out P.hmm [--device cuda|cpu]
    python -m hmm_fasta_viterbi_tpu_torch emit --hmm P.hmm [--count N] [--consensus]
    python -m hmm_fasta_viterbi_tpu_torch generate --out random.fsa [--count N]

``hmm_fasta_viterbi_tpu``'s commands with the same flags and the same
reports, its ``--backend`` answered by ``--device``. ``scan`` reports one
stage's scores, or (``--stage search``) the MSV -> Viterbi -> Forward
cascade with a row for every MSV survivor (``--fast``: behind the
upper-bound MSV and Viterbi prefilters; ``--fused``: the whole cascade,
both prefilters included, enqueued on the device with the survivors
compacted there and read back once, the staged cascade's hits and
``--fast``'s report; ``--domains``: each reported hit's
posterior envelope and domains, each domain rescored by Forward;
``--align``: each hit's Viterbi alignments, traced back on the host, and
with ``--msa-out`` one Stockholm MSA of them); a sweep scores many profiles
against one staged database. ``--bucketed`` stages a ragged database in
length buckets (msv and search stages); ``--stream N`` reads the FASTA in
batches of N records, the next batch parsed, encoded and staged on a side
CUDA stream while the card scans this one, so host memory holds a batch and
the survivors; ``sweep --checkpoint DIR`` keeps each (profile, shard)
result under DIR and a rerun computes only the missing ones. ``--config``
reads an ``EngineConfig`` JSON file (the cascade thresholds and
``m_bucket``, and with ``use_mesh`` its mesh); ``--profile-trace DIR``
writes a ``torch.profiler`` trace of a whole-file scan, its phases
labelled. ``--mesh db=N[,sp=M]`` (or ``N``, or ``all``) shards a scan over
a device mesh (``parallel``): the database's rows over ``db``, and with
``sp`` > 1 each sequence's residues over ``sp`` as a wavefront; the
reports equal the meshless ones. ``align``, ``info``, ``emit`` and
``generate`` are host commands; ``build`` calibrates the profile it builds
with the MSV, eager Viterbi and log-space Forward kernels. ``--device``
(default ``cuda``) names the torch device, and ``--device cpu`` runs the
kernels' plain versions; a mesh takes the visible cards, or with ``--device
cpu`` :data:`CPU_MESH_DEVICES` CPU ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import pathlib
import sys
import time

import numpy as np
import torch

from .io.alphabet import decode_sequence
from .io.fastaio import FastaDatabase, FastaRecord, write_fasta
from .io.generate import generate_records
from .io.hmmio import parse_hmm
from .io.hmmwrite import write_hmm
from .io.loader import (
    load_fasta, load_profile, load_profiles, stream_fasta, stream_fasta_prefetch,
)
from .io.msaio import read_msa
from .models import stats
from .models.build import build_profile, calibrate_profile
from .models.msv import MSVProfile
from .models.p7 import P7Profile
from .models.sample import sample_sequences
from .ops.posterior_cuda import posterior_coverage_batch
from .ops.traceback import (
    alignment_row, consensus_string, domain_alignments, format_alignment, hit_alignments,
    stockholm_msa,
)
from .parallel.database import ShardedStager
from .parallel.mesh import make_scan_mesh
from .parallel.seqblocks import SeqblockScanner
from .pipeline import (
    PREFETCH_DEPTH, MSVScanner, SearchPipeline, SearchResult, SideStreamStager, forward_scores,
)
from .runtime.checkpoint import ScanCheckpoint, resumable_search_sweep, resumable_sweep
from .runtime.config import EngineConfig
from .runtime.profiling import SectionTimer, device_trace, span

logger = logging.getLogger(__name__)

_PVALUE_FNS = {
    "msv": stats.msv_pvalue,
    "viterbi": stats.viterbi_pvalue,
    "forward": stats.forward_pvalue,
}


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


@contextlib.contextmanager
def _json_accumulator(args, sink):
    """A sweep in JSON format writes ONE document: every profile's rows are
    collected and dumped as one array at the end (also after a failure
    part way, as --out was already truncated)."""
    if args.format != "json":
        yield None
        return
    rows: list = []
    try:
        yield rows
    finally:
        json.dump(rows, sink, indent=1)
        sink.write("\n")


def _write_json(rows, out, rows_sink) -> None:
    if rows_sink is not None:
        rows_sink.extend(rows)
    else:
        json.dump(rows, out, indent=1)
        out.write("\n")


def _report(profile, db, scores: np.ndarray, args, out, stage: str = "msv",
            rows_sink=None) -> None:
    bits = stats.nats_to_bits(scores)
    pvals = _PVALUE_FNS[stage](scores, profile)
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
        _write_json(rows, out, rows_sink)
    else:
        out.write("# target\tprofile\tscore_nats\tscore_bits\tpvalue\tevalue\n")
        for r in rows:
            out.write(
                f"{r['target']}\t{r['profile']}\t{r['score_nats']}\t"
                f"{r['score_bits']}\t{_fmt_e(r['pvalue'])}\t{_fmt_e(r['evalue'])}\n"
            )


def _coverage_segments(cov_row: np.ndarray, length: int) -> list:
    """1-based (from, to) spans of contiguous positions with summed
    match-posterior coverage >= 0.5 (HMMER-envelope-style: the position
    sits in the model core with posterior majority). Each segment is one
    domain of the multihit (nu = 2) model."""
    covered = cov_row[:length] >= 0.5
    idx = np.flatnonzero(covered)
    if not idx.size:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [idx.size - 1]))
    return [(int(idx[s]) + 1, int(idx[e]) + 1) for s, e in zip(starts, ends)]


def _envelope_from_coverage(cov_row: np.ndarray, length: int):
    """(env_from, env_to, ndom) summary of :func:`_coverage_segments`."""
    segs = _coverage_segments(cov_row, length)
    if not segs:
        return None
    return segs[0][0], segs[-1][1], len(segs)


def _hit_envelopes(p7, tokens, lengths, hit_idx: np.ndarray, device, mesh=None) -> dict:
    """Batched posterior decode of all hits, {hit index: segments}: one
    coverage call over the hits (the forward-save and backward-coverage
    kernels on the card, sharded over a db ``mesh``), thresholded at 0.5 on
    the device."""
    if not hit_idx.size:
        return {}
    l_max = max(int(lengths[hit_idx].max()), 1)
    cov, _ = posterior_coverage_batch(
        p7, tokens[hit_idx, :l_max], lengths[hit_idx], device=device, mask_threshold=0.5,
        mesh=mesh,
    )
    return {
        int(i): _coverage_segments(cov[k], int(lengths[i]))
        for k, i in enumerate(hit_idx)
    }


def _domain_scores(p7, tokens, lengths, segments: dict, device) -> dict:
    """Per-domain Forward scores: each envelope span rescored as its own
    subsequence in ONE batched probability-space Forward call (HMMER's
    envelope-rescoring shape). Returns {(hit_index, domain_rank):
    score_nats}."""
    spans = [
        (i, k, f, t)
        for i, segs in segments.items()
        for k, (f, t) in enumerate(segs)
    ]
    if not spans:
        return {}
    max_len = max(t - f + 1 for _, _, f, t in spans)
    sub = np.zeros((len(spans), max_len), dtype=np.int32)
    sub_len = np.zeros(len(spans), dtype=np.int32)
    for r, (i, _, f, t) in enumerate(spans):
        sub[r, : t - f + 1] = tokens[i, f - 1 : t]
        sub_len[r] = t - f + 1
    scores = forward_scores(p7, sub, sub_len, device=device).cpu().numpy()
    return {
        (i, k): float(scores[r]) for r, (i, k, _, _) in enumerate(spans)
    }


def _domain_rows(hmm, segs: list, dom_scores: dict, i: int, n_db: int) -> list:
    """The JSON ``domains`` of hit ``i``: each envelope with its rescored
    Forward score and its i-Evalue (that score through the Forward tail
    calibration, times the database size)."""
    out = []
    for k, (f, t) in enumerate(segs):
        s = dom_scores.get((i, k), 0.0)
        dp = float(stats.forward_pvalue(np.float64(s), hmm))
        out.append({
            "env_from": f,
            "env_to": t,
            "score_nats": round(float(s), 4),
            "score_bits": round(float(stats.nats_to_bits(s)), 4),
            "ievalue": dp * n_db,
        })
    return out


def _report_search(hmm, db, result, args, out, rows_sink=None, tokens=None, lengths=None,
                   device=None, phases=None, n_targets: int | None = None,
                   mesh=None) -> None:
    """One row per MSV survivor, ordered by Forward score (rows Forward
    never reached last), as the JAX CLI's search report. With the host
    ``tokens``/``lengths``: ``--domains`` decodes the hits that survive
    --top/--max-evalue on ``device`` and gives them env_from/env_to/ndom
    and their domains (the decode's seconds go into ``phases["domains"]``);
    the decode is sharded over a db ``mesh`` when there is one;
    ``--align`` gives each such hit its Viterbi alignments, traced back on
    the host (``ops.traceback``; past its DP budget each posterior envelope
    of ``--domains`` is aligned instead), and ``--msa-out`` writes them all
    as one Stockholm MSA. ``n_targets`` is the true database size for
    E-values: a streamed search's ``db`` holds only the MSV survivors
    (default ``len(db)``)."""
    n_db = n_targets if n_targets is not None else len(db)
    evals = stats.evalue(result.forward_pvalues, n_db)
    want_domains = bool(getattr(args, "domains", False)) and tokens is not None
    want_align = bool(getattr(args, "align", False)) and tokens is not None
    p7 = P7Profile.from_profile(hmm) if want_domains or want_align else None
    order = np.flatnonzero(result.passed_msv)
    order = order[np.argsort(-np.nan_to_num(result.forward_scores[order], nan=-np.inf))]
    if args.top:
        order = order[: args.top]
    if args.max_evalue is not None:
        # a NaN E-value (Forward never ran on the row) fails any cutoff
        order = order[evals[order] <= args.max_evalue]
    envelopes, dom_scores = {}, {}
    if want_domains:
        # decode only the reported hits: the decode is O(L * M) device work a hit
        timer = SectionTimer()
        with timer.section("domains"):
            envelopes = _hit_envelopes(p7, tokens, lengths,
                                       order[result.passed_forward[order]], device, mesh)
            dom_scores = _domain_scores(p7, tokens, lengths, envelopes, device)
        if phases is not None:
            phases["domains"] = timer.seconds["domains"]
    rows = []
    for i in order:
        row = {
            "target": db.records[i].header or f"seq{i}",
            "profile": hmm.name,
            "msv_bits": round(float(stats.nats_to_bits(result.msv_scores[i])), 4),
            "msv_p": _finite_or_none(result.msv_pvalues[i]),
            "viterbi_p": _finite_or_none(result.viterbi_pvalues[i]),
            "forward_p": _finite_or_none(result.forward_pvalues[i]),
            "evalue": _finite_or_none(evals[i]),
            "hit": bool(result.passed_forward[i]),
        }
        if want_domains and result.passed_forward[i]:
            segs = envelopes.get(int(i)) or []
            row["env_from"], row["env_to"], row["ndom"] = (
                (segs[0][0], segs[-1][1], len(segs)) if segs else (0, 0, 0))
            row["domains"] = _domain_rows(hmm, segs, dom_scores, int(i), n_db)
        if want_align and result.passed_forward[i]:
            try:
                doms = hit_alignments(p7, tokens[i, : int(lengths[i])],
                                      envelopes=envelopes.get(int(i)))
            except MemoryError as exc:
                logger.warning("alignment skipped for %s: %s", row["target"], exc)
                doms = []
            row["alignments"] = [alignment_row(d) for d in doms]
        rows.append(row)
    msa_path = getattr(args, "msa_out", None)
    if msa_path and want_align:
        # hmmsearch -A: one Stockholm MSA over every hit domain
        entries = [(r["target"], a) for r in rows for a in r.get("alignments", [])]
        with open(msa_path, "w") as fh:
            fh.write(stockholm_msa(entries, p7.num_states, hmm.name))
        logger.info("wrote %d aligned domains to %s", len(entries), msa_path)
    if args.format == "json":
        _write_json(rows, out, rows_sink)
    else:
        cols = "# target\tprofile\tmsv_bits\tmsv_p\tviterbi_p\tforward_p\tevalue\thit"
        out.write(cols + ("\tenv_from\tenv_to\tndom\tdom_scores" if want_domains else "") + "\n")
        for r in rows:
            line = (
                f"{r['target']}\t{r['profile']}\t{r['msv_bits']}\t{_fmt_e(r['msv_p'])}\t"
                f"{_fmt_e(r['viterbi_p'])}\t{_fmt_e(r['forward_p'])}\t"
                f"{_fmt_e(r['evalue'])}\t{int(r['hit'])}"
            )
            if want_domains:
                doms = ";".join(
                    f"{d['env_from']}-{d['env_to']}:{d['score_nats']}"
                    for d in r.get("domains", [])
                )
                line += (
                    f"\t{r.get('env_from', '')}\t{r.get('env_to', '')}"
                    f"\t{r.get('ndom', '')}\t{doms}"
                )
            out.write(line + "\n")
        for r in rows:
            for k, a in enumerate(r.get("alignments", [])):
                out.write(
                    f"\n== {r['target']} domain {k + 1} [hmm {a['hmm_from']}-{a['hmm_to']} / "
                    f"seq {a['seq_from']}-{a['seq_to']}]\n"
                )
                out.write(format_alignment(a, hmm.name, r["target"]) + "\n")


def _device(args) -> torch.device | None:
    """``--device``, or None (after logging why) when it names CUDA and
    torch has none: the CLI never carries on on the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error(
            "--device %s: torch.cuda.is_available() is false (no CUDA card or "
            "a CPU-only torch); pass --device cpu to run the plain versions",
            args.device,
        )
        return None
    return device


def _log_seconds(t_start, parse_s, stage_s, phases, report_s, streamed=False) -> None:
    """The ``seconds:`` line. ``streamed``: parse (with encode) and stage
    are the producer thread's sums and ran beside the device phases."""
    logger.info(
        "seconds: parse %.6f stage %.6f msv %.6f viterbi %.6f forward %.6f "
        "domains %.6f report %.6f total %.6f"
        + (" (streamed: parse, encode and stage ran on the producer thread beside the "
           "device phases, so the phases do not add up to the total)" if streamed else ""),
        parse_s, stage_s, phases["msv"], phases["viterbi"], phases["forward"],
        phases.get("domains", 0.0), report_s, time.perf_counter() - t_start,
    )


def _packs(scanner) -> str:
    """The scanner's pack cache, and its MSV launches a bucketed scan, in a
    search's log line."""
    line = f"packs built {scanner.pack_builds} of {scanner.pack_lookups} lookups"
    if scanner.bucketed_scans:
        line += (f", {scanner.bucketed_launches / scanner.bucketed_scans:g} MSV launches a "
                 "bucketed scan")
    return line


def _stage_bucketed_logged(scanner, tokens, lengths):
    bucketed = scanner.stage_bucketed(tokens, lengths)
    logger.info(
        "bucketed staging: %d buckets, %.0f%% padded cells saved",
        len(bucketed.buckets), 100 * bucketed.padded_cells_saved,
    )
    return bucketed


def _sync(scanner) -> None:
    """Wait for the scanner's uploads, on each of its cards: they belong
    to the stage time."""
    mesh = scanner.mesh
    devices = {scanner.device} if mesh is None else {x for row in mesh.devices for x in row}
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


# the EngineConfig knobs of the JAX package's TPU kernels: a score depends
# only on its own row, so the port's reports do not depend on them
_TPU_KNOBS = ("backend", "l_chunk")


def _load_config(args) -> None:
    """Read ``--config`` into ``args.engine_config`` (None without one), as
    the JAX CLI reads it: the cascade thresholds (``msv_p``, ``viterbi_p``,
    ``forward_p``) and ``m_bucket`` apply; ``loader`` does not (it comes
    from ``--loader``); the TPU knobs are ignored with a warning each;
    unknown keys raise ``ValueError``; ``use_mesh`` builds the scanner's
    (mesh_db x mesh_sp) mesh, sharded over db (:func:`_make_scanner`)."""
    args.engine_config = None
    if not args.config:
        return
    cfg = EngineConfig.from_json(args.config)
    keys = json.loads(pathlib.Path(args.config).read_text())
    for key in _TPU_KNOBS:
        if key in keys:
            logger.warning("--config %s: %s is a knob of the TPU kernels; the port ignores it",
                           args.config, key)
    args.engine_config = cfg


# the CPU ranks of a mesh under --device cpu: the JAX suite's virtual CPU
# devices (tests/conftest.py)
CPU_MESH_DEVICES = 8


def _parse_mesh(spec: str) -> dict:
    """'db=8,sp=1' | '8' | 'all' -> make_scan_mesh kwargs."""
    out: dict = {}
    if spec.strip().lower() == "all":
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            if k.strip() not in ("db", "sp"):
                raise ValueError(f"unknown mesh axis {k!r} (use db/sp)")
            out[k.strip()] = int(v)
        else:
            out["db"] = int(part)
    return out


def _mesh_devices(device: torch.device) -> list[torch.device]:
    """The devices a mesh is laid over: the visible cards, or under
    ``--device cpu`` CPU_MESH_DEVICES CPU ranks."""
    if device.type == "cpu":
        return [device] * CPU_MESH_DEVICES
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _sp_mesh(args, device):
    """The (db, sp) mesh when --mesh requests sp > 1: served by the
    wavefront (:class:`SeqblockScanner`), not the scanner's db sharding.
    A mesh larger than the devices raises ValueError (exit 2)."""
    if not args.mesh:
        return None
    kwargs = _parse_mesh(args.mesh)
    if kwargs.get("sp", 1) <= 1:
        return None
    return make_scan_mesh(**kwargs, devices=_mesh_devices(device))


def _wavefront(args) -> bool:
    """--mesh asks for sp > 1 (a malformed spec raises ValueError: exit 2)."""
    return bool(args.mesh) and _parse_mesh(args.mesh).get("sp", 1) > 1


def _make_scanner(args, device):
    """The scanner: with ``--mesh`` sp > 1 a :class:`SeqblockScanner`;
    else an :class:`MSVScanner` on ``device``, its M bucket from
    ``--config``, sharded over the db axis of ``--config``'s ``use_mesh``
    mesh or else of ``--mesh``'s (as the JAX CLI picks)."""
    cfg = args.engine_config
    sp_mesh = _sp_mesh(args, device)
    if sp_mesh is not None:
        logger.info("sp wavefront mesh: %s", dict(sp_mesh.shape))
        return SeqblockScanner(sp_mesh)
    kw = {} if cfg is None else {"m_bucket": cfg.m_bucket}
    if cfg is not None and cfg.use_mesh:
        scanner = MSVScanner.from_config(cfg, device, devices=_mesh_devices(device))
    elif args.mesh:
        kwargs = _parse_mesh(args.mesh)
        kwargs.pop("sp", None)
        scanner = MSVScanner(mesh=make_scan_mesh(**kwargs, devices=_mesh_devices(device)),
                             **kw)
    else:
        return MSVScanner(device=device, **kw)
    logger.info("mesh: %s", dict(scanner.mesh.shape))
    return scanner


def _make_pipeline(args, scanner) -> SearchPipeline:
    """The cascade with ``--fast``'s prefilters, ``scan --fused`` and
    ``--config``'s thresholds."""
    kw = dict(fast_msv=args.fast, fast_viterbi=args.fast, fused=getattr(args, "fused", False))
    cfg = args.engine_config
    if cfg is not None:
        kw.update(msv_p=cfg.msv_p, viterbi_p=cfg.viterbi_p, forward_p=cfg.forward_p)
    return SearchPipeline(scanner, **kw)


def _untraced(args, what: str) -> None:
    """``--profile-trace`` records the whole-file scan only (as in the JAX
    CLI, which ignores it elsewhere): say so instead of staying silent."""
    if args.profile_trace:
        logger.warning("--profile-trace covers only the whole-file scan; %s records no trace",
                       what)


def cmd_scan(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    if args.out:
        open(args.out, "w").close()  # fail fast on a bad --out path
    if args.msa_out and not (args.stage == "search" and args.align):
        logger.error("--msa-out requires --stage search --align")
        return 2
    if args.stream < 0:
        logger.error("--stream must be at least 1 (0 reads the whole file)")
        return 2
    _load_config(args)
    if _wavefront(args):
        # the wavefront has no buckets, no stream and no prefilters: refuse
        # rather than run the plain cascade under a flag the user asked for
        for flag, given in (("--stream", args.stream), ("--bucketed", args.bucketed),
                            ("--fast", args.fast and args.stage == "search"),
                            ("--fused", args.fused and args.stage == "search")):
            if given:
                logger.error("%s does not compose with --mesh sp>1", flag)
                return 2
    if args.fused and args.bucketed and args.stage == "search":
        logger.error("--fused does not compose with --bucketed")
        return 2
    if args.stream:
        if args.bucketed:
            logger.error("--stream does not compose with --bucketed")
            return 2
        _untraced(args, "a streamed scan")
        return _cmd_scan_stream(args, device)
    with device_trace(args.profile_trace, device):
        return _scan_whole_file(args, device)


def _scan_whole_file(args, device) -> int:
    """scan of a FASTA file loaded whole; each phase of the ``seconds:``
    line is a labelled range of a ``--profile-trace``."""
    t_start = time.perf_counter()
    with span("parse"):
        hmm = load_profile(args.hmm, prefer=args.loader)
        db = load_fasta(args.fasta, prefer=args.loader)
        if not len(db):
            logger.warning("no valid sequences in %s", args.fasta)
            return 1
        tokens, lengths = db.encode()
    scanner = _make_scanner(args, device)
    # --bucketed stages the msv and search stages in length buckets; the
    # Viterbi and Forward stages stage whole, as in the JAX CLI
    bucketed = args.bucketed and args.stage in ("msv", "search")
    t0 = time.perf_counter()
    with span("stage"):
        if bucketed:
            staged = _stage_bucketed_logged(scanner, tokens, lengths)
        else:
            staged = scanner.stage(tokens, lengths)
        _sync(scanner)
    t_staged = time.perf_counter()
    phases = {"msv": 0.0, "viterbi": 0.0, "forward": 0.0}
    if args.stage == "search":
        pipeline = _make_pipeline(args, scanner)
        if bucketed:
            result = pipeline.search_bucketed(hmm, staged, tokens, lengths)
        else:
            result = pipeline.search(hmm, staged, tokens, lengths)
        phases = dict(pipeline.phase_seconds)
        t_scanned = time.perf_counter()
        logger.info(
            "search %s%s: %d seqs -> %d past MSV -> %d past Viterbi -> %d hits (%.3fs, %s)",
            hmm.name, " (fused)" if pipeline.fused_runs else "", len(db),
            int(result.passed_msv.sum()),
            int(result.passed_viterbi.sum()), int(result.passed_forward.sum()),
            t_scanned - t0, _packs(scanner),
        )
        with span("report"), _out_sink(args) as sink:
            _report_search(hmm, db, result, args, out=sink, tokens=tokens, lengths=lengths,
                           device=device, phases=phases, mesh=scanner.mesh)
    else:
        with span(args.stage):
            if args.stage != "msv":
                scores = scanner.scan_p7(P7Profile.from_profile(hmm), staged,
                                         stage=args.stage).cpu().numpy()
            elif bucketed:
                scores = scanner.scan_bucketed(MSVProfile.from_profile(hmm), staged)
            else:
                scores = scanner.scan(MSVProfile.from_profile(hmm), staged).cpu().numpy()
        t_scanned = time.perf_counter()
        phases[args.stage] = t_scanned - t_staged
        dt = t_scanned - t0
        cells = int(lengths.astype(np.int64).sum()) * (hmm.model_length - 1)
        logger.info(
            "scanned %d seqs x %s (%s) in %.3fs (%.2f GCUPS)",
            len(db), hmm.name, args.stage, dt, cells / dt / 1e9,
        )
        with span("report"), _out_sink(args) as sink:
            _report(hmm, db, scores, args, out=sink, stage=args.stage)
    report_s = time.perf_counter() - t_scanned - phases.get("domains", 0.0)
    _log_seconds(t_start, t0 - t_start, t_staged - t0, phases, report_s)
    return 0


class _Stream:
    """The FASTA in batches of ``--stream`` records, each parsed, encoded
    to int8 and staged for ``scanner`` by a :class:`SideStreamStager` on
    the producer thread while the consumer scans the batch before. The
    consumer's wait for each batch goes to ``timer``'s prefetch_wait, the
    producer's seconds to ``producer`` (parse, encode, stage, put_wait)."""

    def __init__(self, args, scanner: MSVScanner):
        self.args = args
        self.stager = (SideStreamStager(scanner) if scanner.mesh is None
                       else ShardedStager(scanner))
        self.timer = SectionTimer()
        self.producer: dict = {}

    def __iter__(self):
        """``(batch, tokens, lengths, staged)`` of every batch that holds a
        valid record."""
        # rows padded to a multiple of 256 as in the JAX CLI (one compiled
        # shape a 256-residue bucket there); the kernels stop at each length
        stream = stream_fasta_prefetch(
            self.args.fasta, self.args.stream, prefer=self.args.loader,
            encode_pad_multiple=256, depth=PREFETCH_DEPTH, producer_sections=self.producer,
            stage_fn=self.stager,
        )
        while True:
            with self.timer.section("prefetch_wait"):
                item = next(stream, None)
            if item is None:
                return
            if len(item[0]):
                yield item

    def log_phases(self, label: str) -> None:
        """The JAX-shaped phase line, the consumer's sections beside the
        producer's (``producer/parse``, ``/encode``, ``/stage``,
        ``/put_wait``); on a card also the stream the batches were staged
        on."""
        for k, v in self.producer.items():
            self.timer.seconds[f"producer/{k}"] = v
        logger.info("streamed %s phases: %s", label, self.timer.report())
        stager = self.stager
        if stager.stream is not None:
            logger.info(
                "side-stream staging: %d batches staged on stream %#x, consumed on stream %#x",
                stager.batches, stager.stream.cuda_stream, stager.consumer.cuda_stream,
            )

    def log_seconds(self, t_start, phases: dict, report_s: float) -> None:
        """The ``seconds:`` line: parse (with encode) and stage are the
        producer's sums."""
        _log_seconds(t_start, self.producer["parse"] + self.producer["encode"],
                     self.producer["stage"], phases, report_s, streamed=True)


def _headers_db(headers: list) -> FastaDatabase:
    """A header-only database for the report of a streamed run."""
    return FastaDatabase(records=[FastaRecord(h, "") for h in headers], rejected=[])


def _cmd_scan_stream(args, device) -> int:
    """Streaming scan (msv, viterbi, forward): the FASTA is read in bounded
    record batches, each staged on the side stream while the card scores
    the one before; host memory holds one batch plus a score and a header
    a sequence. E-values use the true total database size, known once the
    stream ends. ``--stage search`` streams through
    :func:`_cmd_search_stream`."""
    if args.stage == "search":
        return _cmd_search_stream(args, device)
    t_start = time.perf_counter()
    hmm = load_profile(args.hmm, prefer=args.loader)
    scanner = _make_scanner(args, device)
    if args.stage == "msv":
        batch_scores = functools.partial(scanner.scan, MSVProfile.from_profile(hmm))
    else:
        # one scanner for every batch: its Viterbi/Forward packs are cached
        batch_scores = functools.partial(
            scanner.scan_p7, P7Profile.from_profile(hmm), stage=args.stage)
    stream = _Stream(args, scanner)
    headers: list[str] = []
    score_chunks: list[np.ndarray] = []
    total_cells = 0
    t0 = time.perf_counter()
    for batch, tokens, lengths, staged in stream:
        with stream.timer.section("scan"):
            score_chunks.append(batch_scores(staged).cpu().numpy())
        headers.extend(r.header for r in batch.records)
        total_cells += int(lengths.astype(np.int64).sum()) * (hmm.model_length - 1)
    stream.log_phases("scan")
    if not headers:
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    scores = np.concatenate(score_chunks)
    dt = time.perf_counter() - t0
    logger.info(
        "streamed %d seqs x %s (%s) in %.3fs (%.2f GCUPS)",
        len(headers), hmm.name, args.stage, dt, total_cells / dt / 1e9,
    )
    t_report = time.perf_counter()
    with _out_sink(args) as sink:
        _report(hmm, _headers_db(headers), scores, args, out=sink, stage=args.stage)
    phases = {"msv": 0.0, "viterbi": 0.0, "forward": 0.0,
              args.stage: stream.timer.seconds["scan"]}
    stream.log_seconds(t_start, phases, time.perf_counter() - t_report)
    return 0


@dataclasses.dataclass
class _StreamedSearch:
    """A profile's aggregate over a streamed cascade: the MSV survivors'
    rows of every SearchResult field, with their headers and (for
    ``--domains`` and ``--align``) their tokens."""

    result: SearchResult | None  # over the survivors only; None without sequences
    headers: list
    tokens: np.ndarray | None  # [S, L_max] int32 survivor tokens (keep_tokens)
    lengths: np.ndarray | None
    n_vit: int
    n_fwd: int


def _stream_search(args, pipeline, hmms, keep_tokens: bool):
    """ONE pass over the streamed FASTA, running the cascade of every
    profile on each batch and keeping that batch's MSV survivors only, the
    rows the search report prints. Per-sequence p-values do not depend on
    the database size, so every decision and reported number equals the
    whole-file search's; survivor token rows are kept only for
    ``--domains`` and ``--align``. The next batch is parsed, encoded and
    staged on the producer thread (:class:`SideStreamStager`) while this
    one's cascade runs; the consumer's seconds go to prefetch_wait
    (producer work not hidden by device work), search and compact.

    Returns ({profile name: _StreamedSearch}, total sequences, total
    cells, the :class:`_Stream`)."""
    fields = [f.name for f in dataclasses.fields(SearchResult)]
    agg = {
        h.name: {
            "kept": {f: [] for f in fields}, "headers": [],
            "tok_rows": [], "len_rows": [], "n_vit": 0, "n_fwd": 0,
        }
        for h in hmms
    }
    total_seqs = 0
    total_cells = 0
    stream = _Stream(args, pipeline.scanner)
    for batch, tokens, lengths, staged in stream:
        recs = batch.records
        for hmm in hmms:
            with stream.timer.section("search"):
                res = pipeline.search(hmm, staged, tokens, lengths)
            with stream.timer.section("compact"):
                a = agg[hmm.name]
                surv = np.flatnonzero(res.passed_msv)
                for f in fields:
                    a["kept"][f].append(getattr(res, f)[surv])
                a["headers"].extend(recs[i].header for i in surv)
                if keep_tokens:
                    for i in surv:
                        a["tok_rows"].append(tokens[i, : int(lengths[i])].astype(np.int32))
                        a["len_rows"].append(int(lengths[i]))
                a["n_vit"] += int(res.passed_viterbi.sum())
                a["n_fwd"] += int(res.passed_forward.sum())
        total_seqs += len(batch)
        total_cells += int(lengths.astype(np.int64).sum()) * sum(
            h.model_length - 1 for h in hmms
        )
    stream.log_phases("search")
    out = {}
    for hmm in hmms:
        a = agg[hmm.name]
        merged = (
            SearchResult(**{f: np.concatenate(a["kept"][f]) for f in fields})
            if total_seqs else None
        )
        toks = lens = None
        if keep_tokens:
            toks = np.zeros((len(a["tok_rows"]), max(a["len_rows"], default=1)), dtype=np.int32)
            for r, row in enumerate(a["tok_rows"]):
                toks[r, : row.size] = row
            lens = np.asarray(a["len_rows"], dtype=np.int32)
        out[hmm.name] = _StreamedSearch(
            result=merged, headers=a["headers"], tokens=toks,
            lengths=lens, n_vit=a["n_vit"], n_fwd=a["n_fwd"],
        )
    return out, total_seqs, total_cells, stream


def _cmd_search_stream(args, device) -> int:
    """scan --stage search --stream: see :func:`_stream_search`."""
    t_start = time.perf_counter()
    hmm = load_profile(args.hmm, prefer=args.loader)
    pipeline = _make_pipeline(args, _make_scanner(args, device))
    t0 = time.perf_counter()
    per_hmm, total_seqs, total_cells, stream = _stream_search(
        args, pipeline, [hmm], keep_tokens=args.domains or args.align)
    if not total_seqs:
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    agg = per_hmm[hmm.name]
    dt = time.perf_counter() - t0
    logger.info(
        "streamed search %s: %d seqs -> %d past MSV -> %d past Viterbi "
        "-> %d hits (%.3fs, %.2f GCUPS msv-equivalent, %s)%s",
        hmm.name, total_seqs, len(agg.headers), agg.n_vit, agg.n_fwd, dt,
        total_cells / dt / 1e9, _packs(pipeline.scanner),
        f", the fused cascade on {pipeline.fused_runs} batches" if args.fused else "",
    )
    phases = dict(pipeline.phase_totals)
    t_report = time.perf_counter()
    with _out_sink(args) as sink:
        _report_search(hmm, _headers_db(agg.headers), agg.result, args, out=sink,
                       tokens=agg.tokens, lengths=agg.lengths, device=device, phases=phases,
                       n_targets=total_seqs, mesh=pipeline.scanner.mesh)
    stream.log_seconds(t_start, phases,
                       time.perf_counter() - t_report - phases.get("domains", 0.0))
    return 0


def _cmd_sweep_stream(args, hmms, device, t_start) -> int:
    """Streaming sweep: ONE pass over the FASTA; each batch is staged once
    and scanned by every profile (msv: the stacked ``scan_many`` launches;
    search: each profile's cascade, keeping each batch's MSV survivors).
    Host memory holds one batch plus the per-profile results."""
    scanner = _make_scanner(args, device)
    t0 = time.perf_counter()
    if args.stage == "search":
        pipeline = _make_pipeline(args, scanner)
        per_hmm, total_seqs, _cells, stream = _stream_search(
            args, pipeline, hmms, keep_tokens=False)
        if not total_seqs:
            logger.warning("no valid sequences in %s", args.fasta)
            return 1
        logger.info(
            "streamed search sweep: %d profiles x %d seqs in %.3fs",
            len(hmms), total_seqs, time.perf_counter() - t0,
        )
        phases = dict(pipeline.phase_totals)
        t_report = time.perf_counter()
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for hmm in hmms:
                agg = per_hmm[hmm.name]
                _report_search(hmm, _headers_db(agg.headers), agg.result, args, out=sink,
                               rows_sink=acc, n_targets=total_seqs)
    else:
        profiles = [MSVProfile.from_profile(h) for h in hmms]
        score_chunks: dict[str, list[np.ndarray]] = {p.name: [] for p in profiles}
        headers: list[str] = []
        total_cells = 0
        stream = _Stream(args, scanner)
        for batch, tokens, lengths, staged in stream:
            with stream.timer.section("scan"):
                results = scanner.scan_many(profiles, staged)
            for p in profiles:
                score_chunks[p.name].append(results[p.name])
            headers.extend(r.header for r in batch.records)
            total_cells += int(lengths.astype(np.int64).sum()) * sum(
                h.model_length - 1 for h in hmms
            )
        stream.log_phases("sweep")
        if not headers:
            logger.warning("no valid sequences in %s", args.fasta)
            return 1
        dt = time.perf_counter() - t0
        logger.info(
            "streamed sweep: %d profiles x %d seqs in %.3fs (%.2f GCUPS)",
            len(profiles), len(headers), dt, total_cells / dt / 1e9,
        )
        phases = {"msv": stream.timer.seconds["scan"], "viterbi": 0.0, "forward": 0.0}
        t_report = time.perf_counter()
        db = _headers_db(headers)
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for p in profiles:
                _report(p, db, np.concatenate(score_chunks[p.name]), args, out=sink,
                        rows_sink=acc)
    stream.log_seconds(t_start, phases, time.perf_counter() - t_report)
    return 0


def _load_sweep_profiles(args) -> list | None:
    """The sweep's profiles: ``--hmm-dir`` (a directory of .hmm files) or
    ``--hmm-db`` (one concatenated //-separated file). None (a usage error)
    unless exactly one is given or when two profiles share a NAME (the
    results are keyed by it); [] when there is nothing to load."""
    hmm_db = args.hmm_db
    if bool(hmm_db) == bool(args.hmm_dir):
        logger.error("sweep needs exactly one of --hmm-dir / --hmm-db")
        return None
    if args.hmm_dir and not pathlib.Path(args.hmm_dir).is_dir():
        logger.error("--hmm-dir %s is not a directory", args.hmm_dir)
        return []
    if hmm_db and not pathlib.Path(hmm_db).is_file():
        logger.error("--hmm-db %s is not a file", hmm_db)
        return []
    hmms = load_profiles(hmm_db or args.hmm_dir, prefer=args.loader)
    if not hmms:
        logger.error("no profiles in %s", hmm_db or args.hmm_dir)
        return hmms
    seen: dict[str, int] = {}
    for h in hmms:
        seen[h.name] = seen.get(h.name, 0) + 1
    dupes = sorted(n for n, c in seen.items() if c > 1)
    if dupes:
        logger.error("duplicate profile NAME(s) in %s: %s", hmm_db or args.hmm_dir,
                     ", ".join(dupes))
        return None
    return hmms


def cmd_sweep(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    if args.out:
        open(args.out, "w").close()  # fail fast on a bad --out path
    # flag conflicts before the profile collection is parsed: a Pfam-scale
    # --hmm-db must not be loaded just to reject the flags
    if args.stream < 0:
        logger.error("--stream must be at least 1 (0 reads the whole file)")
        return 2
    if args.stream and (args.bucketed or args.checkpoint):
        logger.error("--stream does not compose with --bucketed or --checkpoint")
        return 2
    for flag, given in (("--stream", args.stream), ("--bucketed", args.bucketed)):
        if given and _wavefront(args):
            logger.error("%s does not compose with --mesh sp>1", flag)
            return 2
    if args.checkpoint and args.bucketed:
        # the checkpointed sweep stages shard by shard
        logger.error("--checkpoint does not compose with --bucketed")
        return 2
    if args.checkpoint_shard < 1:
        logger.error("--checkpoint-shard must be at least 1")
        return 2
    _load_config(args)
    _untraced(args, "a sweep")
    t_start = time.perf_counter()
    hmms = _load_sweep_profiles(args)
    if hmms is None:
        return 2
    if not hmms:
        return 1
    if args.stream:
        return _cmd_sweep_stream(args, hmms, device, t_start)
    db = load_fasta(args.fasta, prefer=args.loader)
    tokens, lengths = db.encode()
    scanner = _make_scanner(args, device)
    t0 = time.perf_counter()
    if args.checkpoint:
        # each shard is staged inside the sweep, once for every profile
        checkpoint = ScanCheckpoint(args.checkpoint)
    elif args.bucketed:
        staged = _stage_bucketed_logged(scanner, tokens, lengths)
    else:
        staged = scanner.stage(tokens, lengths)
    _sync(scanner)
    t_staged = time.perf_counter()
    phases = {"msv": 0.0, "viterbi": 0.0, "forward": 0.0}
    if args.stage == "search":
        # the cascade per profile, each profile's rows reported before the
        # next profile runs (a checkpointed sweep computes them all first)
        pipeline = _make_pipeline(args, scanner)
        if args.checkpoint:
            results = resumable_search_sweep(pipeline, hmms, tokens, lengths, checkpoint,
                                             shard_size=args.checkpoint_shard)
            run = lambda hmm: results[hmm.name]  # noqa: E731
        elif args.bucketed:
            run = lambda hmm: pipeline.search_bucketed(hmm, staged, tokens, lengths)  # noqa: E731
        else:
            run = lambda hmm: pipeline.search(hmm, staged, tokens, lengths)  # noqa: E731
        report_s = 0.0
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for hmm in hmms:
                result = run(hmm)
                logger.info(
                    "search %s: %d past MSV -> %d past Viterbi -> %d hits",
                    hmm.name, int(result.passed_msv.sum()),
                    int(result.passed_viterbi.sum()), int(result.passed_forward.sum()),
                )
                t_report = time.perf_counter()
                _report_search(hmm, db, result, args, out=sink, rows_sink=acc)
                report_s += time.perf_counter() - t_report
        phases = dict(pipeline.phase_totals)
    else:
        profiles = [MSVProfile.from_profile(h) for h in hmms]
        if args.checkpoint:
            results = resumable_sweep(scanner, profiles, tokens, lengths, checkpoint,
                                      shard_size=args.checkpoint_shard)
        elif args.bucketed:
            results = scanner.scan_many_bucketed(profiles, staged)
        else:
            results = scanner.scan_many(profiles, staged)
        t_scanned = time.perf_counter()
        phases["msv"] = t_scanned - t_staged
        cells = int(lengths.astype(np.int64).sum()) * sum(p.num_states for p in profiles)
        logger.info(
            "swept %d seqs x %d profiles (msv) in %.3fs (%.2f GCUPS)",
            len(db), len(profiles), phases["msv"], cells / phases["msv"] / 1e9,
        )
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for profile in profiles:
                _report(profile, db, results[profile.name], args, out=sink, rows_sink=acc)
        report_s = time.perf_counter() - t_scanned
    _log_seconds(t_start, t0 - t_start, t_staged - t0, phases, report_s)
    return 0


def cmd_info(args) -> int:
    """hmmstat-shaped profile summary: one row a .hmm with its NAME/LENG and
    the three STATS LOCAL calibration pairs the P-values come from;
    ``--consensus`` adds the model's consensus string."""
    if sum(bool(x) for x in (args.hmm, args.hmm_dir, args.hmm_db)) != 1:
        logger.error("info needs exactly one of --hmm / --hmm-dir / --hmm-db")
        return 2
    if args.hmm_dir:
        units = [
            (p.name, load_profile(p, prefer=args.loader))
            for p in sorted(pathlib.Path(args.hmm_dir).glob("*.hmm"))
        ]
    elif args.hmm_db:
        units = [(pathlib.Path(args.hmm_db).name, h)
                 for h in load_profiles(args.hmm_db, prefer=args.loader)]
    else:
        units = [(pathlib.Path(args.hmm).name, load_profile(args.hmm, prefer=args.loader))]
    if not units:
        logger.error("no .hmm files in %s", args.hmm_dir)
        return 1
    rows = []
    for fname, hmm in units:
        row = {
            "file": fname,
            "name": hmm.name,
            "leng": hmm.model_length - 1,
            "model_length": hmm.model_length,
            "msv_mu": hmm.stats_local_msv_mu,
            "msv_lambda": hmm.stats_local_msv_lambda,
            "viterbi_mu": hmm.stats_local_viterbi_mu,
            "viterbi_lambda": hmm.stats_local_viterbi_lambda,
            "forward_tau": hmm.stats_local_forward_theta,
            "forward_lambda": hmm.stats_local_forward_lambda,
        }
        if args.consensus:
            row["consensus"] = consensus_string(P7Profile.from_profile(hmm))
        rows.append(row)
    with _out_sink(args) as out:
        if args.format == "json":
            json.dump(rows, out, indent=1)
            out.write("\n")
        else:
            cols = list(rows[0].keys())
            out.write("# " + "\t".join(cols) + "\n")
            for r in rows:
                out.write("\t".join(str(r[c]) for c in cols) + "\n")
    return 0


def cmd_align(args) -> int:
    """hmmalign-shaped: Viterbi-align EVERY sequence of a FASTA to one
    profile (no cascade, no thresholds: ``scan --stage search --align``
    reports the hits' alignments). A host command: the traceback is
    per-sequence argmax bookkeeping in NumPy (``ops.traceback``)."""
    if args.stream < 0:
        logger.error("--stream must be at least 1 (0 reads the whole file)")
        return 2
    hmm = load_profile(args.hmm, prefer=args.loader)
    p7 = P7Profile.from_profile(hmm)
    if args.stream:
        # bounded host memory: one FASTA batch of tokens at a time

        def units():
            for batch in stream_fasta(args.fasta, args.stream, prefer=args.loader):
                if not len(batch):
                    continue
                toks, lens = batch.encode()
                recs = batch.records
                for i in range(len(batch)):
                    yield recs[i].header or f"seq{i}", toks[i, : int(lens[i])]
    else:
        db = load_fasta(args.fasta, prefer=args.loader)
        tokens, lengths = db.encode()

        def units():
            for i in range(len(db)):
                yield db.records[i].header or f"seq{i}", tokens[i, : int(lengths[i])]

    rows = []
    msa_entries = []
    with _out_sink(args) as out:
        for name, seq_tokens in units():
            try:
                score, doms = domain_alignments(p7, seq_tokens)
            except MemoryError as exc:
                # one sequence past the traceback's DP budget must not cost
                # the run's other alignments
                logger.warning("alignment skipped for %s: %s", name, exc)
                score, doms = float("nan"), []
            if args.format == "json":
                rows.append({
                    "target": name,
                    "profile": hmm.name,
                    "viterbi_nats": round(score, 4) if np.isfinite(score) else None,
                    "alignments": [alignment_row(d) for d in doms],
                })
            elif args.format == "stockholm":
                msa_entries.extend((name, d) for d in doms)
            else:
                for k, d in enumerate(doms):
                    out.write(
                        f"== {name} domain {k + 1} [hmm {d.hmm_from}-{d.hmm_to} / "
                        f"seq {d.seq_from}-{d.seq_to}]\n"
                    )
                    out.write(format_alignment(d, hmm.name, name) + "\n")
        if args.format == "json":
            json.dump(rows, out, indent=1)
            out.write("\n")
        elif args.format == "stockholm":
            out.write(stockholm_msa(msa_entries, p7.num_states, hmm.name))
    return 0


def cmd_build(args) -> int:
    """hmmbuild-shaped: build a profile from an MSA (Stockholm with ``#=GC
    RF``, the shape ``align --format stockholm`` writes, or aligned FASTA),
    calibrate its STATS by simulation on ``--device`` (the MSV, eager
    Viterbi and log-space Forward kernels on a card, their plain versions on
    the CPU) and write it as an HMMER3/b .hmm file."""
    device = _device(args)
    if device is None:
        return 2
    _, rows, rf = read_msa(args.msa)
    name = args.name or pathlib.Path(args.msa).stem
    hmm = build_profile(rows, rf=rf, name=name, weighting=args.weighting)
    t0 = time.perf_counter()
    hmm = calibrate_profile(hmm, seed=args.seed, device=device)
    calibrate_s = time.perf_counter() - t0
    write_hmm(hmm, args.out)
    logger.info(
        "built %s: LENG %d from %d aligned rows (%s match columns), calibrated on %s in "
        "%.3f s, MSV mu=%.2f",
        name, hmm.model_length - 1, len(rows), "RF" if rf else "gap-majority", device,
        calibrate_s, hmm.stats_local_msv_mu,
    )
    print(f"wrote {name} (LENG {hmm.model_length - 1}) to {args.out}")
    return 0


def cmd_emit(args) -> int:
    """hmmemit-shaped: sample sequences from the core profile
    (``models.sample``), or its consensus with ``--consensus``. The profile
    is parsed with ``star_as_zero_prob=True``, so a ``*`` transition is
    impossible, not the reference parser's exp(-0) = 1."""
    hmm = parse_hmm(args.hmm, star_as_zero_prob=True)
    if args.consensus:
        seqs = [consensus_string(P7Profile.from_profile(hmm))]
        names = [f"{hmm.name}-consensus"]
    else:
        seqs = [decode_sequence(t) for t in sample_sequences(hmm, args.count, args.seed)]
        names = [f"{hmm.name}-sample{i + 1}" for i in range(len(seqs))]
    records = [FastaRecord(n, s) for n, s in zip(names, seqs)]
    if args.out:
        write_fasta(args.out, records, args.width)
        print(f"wrote {len(records)} sequence(s) to {args.out}")
    else:
        write_fasta(sys.stdout, records, args.width)
    return 0


def cmd_generate(args) -> int:
    """A random protein FASTA corpus (``io.generate``)."""
    write_fasta(args.out, generate_records(args.count, args.length, args.seed), args.width)
    print(f"wrote {args.count} x {args.length} aa to {args.out}")
    return 0


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--fasta", required=True, help="protein FASTA database")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (the kernels) or cpu (their plain versions)",
    )
    ap.add_argument("--format", default="tsv", choices=["tsv", "json"])
    ap.add_argument("--top", type=int, default=0, help="report only the top K hits (0 = all)")
    ap.add_argument("--max-evalue", type=float, default=None, help="E-value cutoff")
    ap.add_argument(
        "--loader", default="auto", choices=["auto", "native", "python"],
        help="data loader: native C++ fast path or pure-Python parsers",
    )
    ap.add_argument("--out", default=None, help="write results to FILE instead of stdout")
    ap.add_argument(
        "--config", default=None, metavar="FILE",
        help="EngineConfig JSON: the cascade thresholds (msv_p, viterbi_p, forward_p) "
        "and m_bucket",
    )
    ap.add_argument(
        "--profile-trace", default=None, metavar="DIR",
        help="write a torch.profiler trace of a whole-file scan into DIR",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="shard scans over a device mesh: 'db=N[,sp=M]' or just 'N' "
        "(db axis size; 'all' uses all devices, e.g. --mesh db=8)",
    )


_FAST_HELP = ("search stage: bf16 upper-bound MSV + Viterbi prefilters "
              "with exact rescore of survivors")
_BUCKETED_HELP = "length-bucketed staging for ragged databases (msv/search stages)"


def _add_stream(ap: argparse.ArgumentParser, what: str) -> None:
    ap.add_argument(
        "--stream", type=int, default=0, metavar="N",
        help=f"stream the FASTA in batches of N records, {what} (bounded host memory; "
        "the next batch is staged on a side CUDA stream)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hmm_fasta_viterbi_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="command", required=True)

    scan = sub.add_parser("scan", help="scan a FASTA database against one profile")
    scan.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    scan.add_argument(
        "--stage", default="msv", choices=["msv", "viterbi", "forward", "search"],
        help="scoring stage, or search: the MSV -> Viterbi -> Forward cascade",
    )
    scan.add_argument("--fast", action="store_true", help=_FAST_HELP)
    scan.add_argument(
        "--fused", action="store_true",
        help="search stage: enqueue the whole cascade on the device (prefilters, survivor "
        "compaction and rescoring), one read-back; identical hits",
    )
    scan.add_argument(
        "--domains", action="store_true",
        help="search stage: posterior-decode an alignment envelope per hit",
    )
    scan.add_argument(
        "--align", action="store_true",
        help="search stage: report per-domain Viterbi alignments (host-side traceback of "
        "each hit)",
    )
    scan.add_argument(
        "--msa-out", default=None, metavar="FILE",
        help="with --align: write one Stockholm MSA of all hit domains (the hmmsearch -A "
        "product)",
    )
    scan.add_argument("--bucketed", action="store_true", help=_BUCKETED_HELP)
    _add_stream(scan, "search keeping only the MSV survivors between batches")
    _add_common(scan)
    scan.set_defaults(fn=cmd_scan)

    sweep = sub.add_parser(
        "sweep",
        help="scan a FASTA database against a profile directory or a "
        "concatenated .hmm database",
    )
    sweep.add_argument("--hmm-dir", default=None, help="directory of per-model .hmm files")
    sweep.add_argument(
        "--hmm-db", default=None, metavar="FILE",
        help="ONE concatenated //-separated .hmm database (the hmmscan Pfam.hmm shape)",
    )
    sweep.add_argument(
        "--stage", default="msv", choices=["msv", "search"],
        help="msv scores per profile, or the full cascade (hmmscan-shaped)",
    )
    sweep.add_argument("--fast", action="store_true", help=_FAST_HELP)
    sweep.add_argument("--bucketed", action="store_true", help=_BUCKETED_HELP)
    sweep.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="resumable sweep (msv or search stage): per-(profile, shard) results "
        "persist atomically under DIR; a rerun skips completed chunks",
    )
    sweep.add_argument(
        "--checkpoint-shard", type=int, default=4096, metavar="N",
        help="sequences per checkpoint shard (default 4096)",
    )
    _add_stream(sweep, "one database pass scanning every profile a batch")
    _add_common(sweep)
    sweep.set_defaults(fn=cmd_sweep)

    aln = sub.add_parser("align", help="Viterbi-align every FASTA sequence to one profile")
    aln.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    aln.add_argument("--fasta", required=True, help="protein FASTA")
    aln.add_argument(
        "--format", default="tsv", choices=["tsv", "json", "stockholm"],
        help="tsv: hmmsearch-style blocks; stockholm: one MSA over all domains (the "
        "hmmalign/hmmsearch -A product)",
    )
    aln.add_argument("--out", default=None)
    aln.add_argument("--loader", default="auto", choices=["auto", "native", "python"])
    aln.add_argument(
        "--stream", type=int, default=0, metavar="N",
        help="stream the FASTA in batches of N records (bounded host memory)",
    )
    aln.set_defaults(fn=cmd_align)

    inf = sub.add_parser(
        "info", help="profile summary: NAME/LENG/STATS per .hmm (hmmstat-shaped)"
    )
    inf.add_argument("--hmm", default=None, help="one HMMER3 .hmm profile")
    inf.add_argument("--hmm-dir", default=None, help="a profile directory")
    inf.add_argument("--hmm-db", default=None, metavar="FILE",
                     help="a concatenated //-separated .hmm database")
    inf.add_argument("--consensus", action="store_true",
                     help="also emit the model consensus string per profile")
    inf.add_argument("--format", default="tsv", choices=["tsv", "json"])
    inf.add_argument("--out", default=None)
    inf.add_argument("--loader", default="auto", choices=["auto", "native", "python"])
    inf.set_defaults(fn=cmd_info)

    bld = sub.add_parser(
        "build", help="build + calibrate a profile from an MSA (hmmbuild-shaped)"
    )
    bld.add_argument("--msa", required=True, help="Stockholm (RF-annotated) or aligned FASTA")
    bld.add_argument("--out", required=True, help="output .hmm path")
    bld.add_argument("--name", default=None, help="profile NAME (default: MSA file stem)")
    bld.add_argument("--seed", type=int, default=0, help="calibration simulation seed")
    bld.add_argument(
        "--weighting", default="pb", choices=["pb", "none"],
        help="sequence weighting: Henikoff position-based (H3 default) or uniform",
    )
    bld.add_argument(
        "--device", default="cuda",
        help="torch device of the calibration: cuda (the kernels) or cpu (their plain "
        "versions)",
    )
    bld.set_defaults(fn=cmd_build)

    emt = sub.add_parser("emit", help="sample sequences from a profile (hmmemit-shaped)")
    emt.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    emt.add_argument("--count", type=int, default=10)
    emt.add_argument("--seed", type=int, default=None)
    emt.add_argument("--consensus", action="store_true",
                     help="emit the consensus sequence instead of stochastic samples")
    emt.add_argument("--out", default=None, help="write FASTA to a file")
    emt.add_argument("--width", type=int, default=70)
    emt.set_defaults(fn=cmd_emit)

    gen = sub.add_parser("generate", help="generate a random protein FASTA corpus")
    gen.add_argument("--out", default="random_FASTA.fsa")
    gen.add_argument("--count", type=int, default=3)
    gen.add_argument("--length", type=int, default=3500)
    gen.add_argument("--seed", type=int, default=None)
    gen.add_argument("--width", type=int, default=70)
    gen.set_defaults(fn=cmd_generate)
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
