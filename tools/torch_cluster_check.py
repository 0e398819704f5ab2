"""Check the MSV kernel's C-block cluster cases, the Forward template's
cluster pair and the p7 kernels' C-block cluster cases against their plain
versions on the card.

    python3 tools/torch_cluster_check.py [--widths 2440,4872,...] [--p7 3,4,...,16]
                                         [--block 10,11,...] [--blocks 2:5,4:8,...]
                                         [--wide 9,...,14] [--time]
    python3 tools/torch_cluster_check.py --stress N [--stress-c 4,...,16]
                                         [--stress-wide 9,...,14] [--stress-blocks 5,...,8]
                                         [--stress-msv 38920,60368,65536]

MSV: for each M_pad of --widths (default: the boundaries of every cluster
size from the pair to 16 blocks, the ends of the 16-block cluster of 8-warp
blocks past 38,912, its per 80 and 88 at 40,960 and 40,968, and LENG 60362,
and one width past 65536), a random f32
table (-inf pad columns) scans a ragged batch of 64 sequences up to 300
residues: the exact kernel (carries in and out, a two-call carry chain
split at 129), the filter (the table rounded to bf16) and a stack of three
such tables, each equal to its plain version bit for bit; the launch
counters show which case ran (cluster_launches by C up to 38,912,
block_cluster_launches at 16 past it, mem_launches past 65536). Forward:
chip_smoke.py's wide check of both wide profiles (LENG
2701 and 4770), whose Forward and row-saving Forward run on the pair, and a
Forward carry chain split at a multiple of FWD_RESCALE_GROUP equal to one
call bit for bit. p7 past 4864 states: for each C of --p7 (default 3..16)
two joins of the repo's profiles that land on a C-block cluster, one just
past 2432 * (C - 1) states (the smallest states a thread of that C) and one
as near 2432 * C as they fill (19 a thread), through the lazy Viterbi (its
own window, and lazy_k = 1, whose certificate fires below 16 chain passes),
the Viterbi filter, Forward, the row-saving Forward and the backward pass
on a ragged batch of 8 sequences up to 300 residues: the lazy kernel and
the filter equal to their plain versions bit for bit (replay counts
included), the filter >= the lazy scores, Forward within FWD_TOL with a
carry chain split at P7_SPLIT equal to one call bit for bit, the
row-saving Forward equal to Forward, and the backward pass on the
row-saving kernel's rows within COV_TOL of its plain version and of the
plain decode; the launch counters show each at its C and none in memory.
The eager Viterbi and the log-space Forward past 4864 states: for each per
of --block (default: every BLOCK_PER) a join of the repo's profiles as near
BLOCK_THREADS * per states as they fill (past BLOCK_THREADS * (per - 1)),
then the joins of chip_smoke.MEM_JOINS (LENG 6977 and 30181), and for
each C:per of --blocks (default: every (C, per) the plan takes past
MAX_BLOCK_STATES, 16 pairs) a random profile (models/fuzz.py, a quarter of
its nodes delete-heavy) at the narrowest and the widest M_pad of that
cluster of wide blocks, on the same ragged batch: the eager kernel equal
to its plain version bit for bit (scores and carries) with a carry chain
split at P7_SPLIT equal to one call, the log-space kernel within
LOG_FWD_TOL, and past 38,912 states (p7_cuda.LAZY_BLOCK_STATES) the lazy
kernel on the same cluster equal to its plain version bit for bit (scores,
carries, 0 replays), its scores equal to the eager kernel's and its carry
chain equal to one call; the launch counters show the wide block
(block_launches) up to MAX_BLOCK_STATES and the cluster of C wide blocks
past it (block_cluster_launches by C), never the rows-in-memory case (and a
tree without the clusters of wide blocks, the rows-in-memory case past
MAX_BLOCK_STATES). Forward, the row-saving Forward and the backward pass
past 38,912 states: for each C of --wide (default 9..14) two joins of the
repo's profiles that land on a C-block cluster of 256-thread blocks of that
C, one just past 4864 * (C - 1) states and one as near 4864 * C (at most
65536) as they fill, on the same ragged batch: Forward's scores within
FWD_TOL of its plain version with a carry chain equal to one call, the
row-saving kernel's scores and carries within FWD_TOL of its plain version
and equal to the Forward kernel's bit for bit (both run the cluster), the
backward pass on the kernel's rows within COV_TOL of its plain version, the
whole decode within COV_TOL / TOT_TOL of the plain decode, and the Viterbi
filter at its auto window and at the whole chain equal to its plain version
bit for bit (scores and carries) and >= the eager kernel's scores; the
launch counters show the cluster of C blocks (block_cluster_launches by C)
and no rows-in-memory launch; and at the first width the rows-in-memory
route of a card that holds no such cluster (chip_smoke.no_block_clusters),
its counters showing it (Forward == the row-saving kernel there too, the
filter == plain). Then chip_smoke.py's wide
check (the cluster pairs, the backward pass's included). With --time, the
MSV cluster cases at 2048 x 1000, the Forward pair at 64 x 3500, each p7
join's Viterbi and Forward kernels at 64 x 1000
and its posterior pair at 64 x 1024 are timed (CUDA events, best of 3),
each also as microseconds a step (ms over the residues and the rounds of
64 rows on the clusters the card holds), and each --block join's eager
and log-space kernels at 64 x 1000 and at build's calibration shape, 256 x
400 (best of 3 on the wide block and its clusters, once in memory), and
each --blocks profile's at 64 x 1000, and each --wide profile's posterior
pair at 64 x 1024, beside the card's name and power limit. One line a check;
exits 1 on a failure.

--stress N runs the release protocol of the C-block clusters hard, and
nothing else: for each C of --stress-c (default 4..16) a join of the repo's
profiles filling a C-block cluster of 128-thread blocks (18-19 states a
thread, join_stems) through
the lazy Viterbi at lazy_k = 1 (its certificate fires, so chunks replay the
whole chain), the Viterbi filter at its longest window (the whole chain),
Forward, the row-saving Forward and the backward pass, for each C of
--stress-wide (default 9..14) a join filling a C-block cluster of
256-thread blocks through Forward, the row-saving Forward, the backward
pass and the Viterbi filter at its longest window, for each C of
--stress-blocks (default 5..8) a join past 38,912 states filling a cluster
of C wide blocks through the lazy Viterbi, and for each M_pad of
--stress-msv a random table through MSV, the MSV filter and the stacked
kernel on their 16-block cluster of 8-warp blocks, N launches each on
SURVIVOR_BATCH rows of 300 residues, every launch's results equal to the
first's bit for bit and the launch counters showing the case. The launches run in a child process that prints a line as each
ends; the parent fails the run, naming the (kind, C, launch) under way,
when the child falls silent for STRESS_SILENCE seconds (a hung kernel
cannot be cut from inside its own process) or exits otherwise than 0, and
prints the launch counts. Needs one CUDA card and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import selectors
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from hmm_fasta_viterbi_tpu_torch.models.fuzz import random_profile  # noqa: E402
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda, p7_cuda  # noqa: E402

WIDTHS = (2440, 4864, 4872, 7296, 7304, 9728, 9736, 12160, 17024, 19456, 19464, 21888,
          30184, 36488, 38912, 38920, 40960, 40968, 60368, 65536, 65544)
BATCH, LEN, SPLIT = 64, 300, 129


def random_emit(rng, m_pad: int, real: int) -> torch.Tensor:
    emit = np.full((msv_cuda.NUM_AA, m_pad), -np.inf, dtype=np.float32)
    emit[:, :real] = rng.normal(-0.5, 1.5, size=(msv_cuda.NUM_AA, real)).astype(np.float32)
    return torch.from_numpy(emit)


def counters(fn) -> dict:
    return {"launches": fn.launches, "wide": fn.wide_launches, "mem": fn.mem_launches,
            "cluster": dict(fn.cluster_launches), "blocks": dict(fn.block_cluster_launches)}


def msv_width(rng, scanner, m_pad: int, time_it: bool) -> dict:
    dev = scanner.device
    lengths = rng.integers(0, LEN + 1, size=BATCH).astype(np.int32)
    lengths[:4] = [0, 1, SPLIT, LEN]
    tokens = rng.integers(0, 20, size=(BATCH, LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    emit = random_emit(rng, m_pad, m_pad - 5).to(dev)
    consts = torch.tensor([-0.7, -0.7, -3.2], dtype=torch.float32, device=dev)
    m, s = msv_cuda.init_carry(staged.tr_rows, m_pad)
    args = (emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s)
    for fn in (msv_cuda.msv_scan_cuda, msv_cuda.msv_filter_scan_cuda,
               msv_cuda.msv_stacked_scan_cuda):
        msv_cuda.zero_launches(fn)
    got = msv_cuda.msv_scan_cuda(*args)
    chip_smoke.require_equal(got, msv_cuda.msv_scan_plain(*args), f"MSV at {m_pad}")
    first = msv_cuda.msv_scan_cuda(emit, staged.tokens[:, :SPLIT].contiguous(),
                                   staged.lengths.clamp(max=SPLIT), staged.tr_rows, consts, m, s)
    second = msv_cuda.msv_scan_cuda(emit, staged.tokens[:, SPLIT:].contiguous(),
                                    (staged.lengths - SPLIT).clamp(min=0), staged.tr_rows,
                                    consts, first[1], first[2])
    chip_smoke.require_equal(second, got, f"MSV carry chain at {m_pad}")
    bits = msv_cuda.bf16_round_up(emit.cpu().numpy())
    f_emit = msv_cuda.bf16_tensor(bits, dev)
    f_args = (f_emit, *args[1:])
    chip_smoke.require_equal(msv_cuda.msv_filter_scan_cuda(*f_args),
                             msv_cuda.msv_filter_scan_plain(*f_args), f"MSV filter at {m_pad}")
    stack = torch.stack([emit, f_emit.float(), emit.flip(0)])
    s_consts = torch.stack([consts, consts, consts + 0.25])
    s_args = (stack, staged.tokens, staged.lengths, staged.tr_rows, s_consts)
    chip_smoke.require_equal([msv_cuda.msv_stacked_scan_cuda(*s_args)],
                             [msv_cuda.msv_stacked_scan_plain(*s_args)],
                             f"stacked MSV at {m_pad}")
    torch.cuda.synchronize()
    lanes, per = msv_cuda.device_case(m_pad, 4, dev)
    plan = msv_cuda.device_plan(m_pad, 4, BATCH, 1, dev)
    out = {"m_pad": m_pad, "lanes": lanes, "per": per, "plan": plan._asdict(),
           "msv_scan": counters(msv_cuda.msv_scan_cuda),
           "msv_filter_scan": counters(msv_cuda.msv_filter_scan_cuda),
           "msv_stacked_scan": counters(msv_cuda.msv_stacked_scan_cuda), "equal": True}
    wide = getattr(msv_cuda, "wide_cluster_case", lambda *_: False)(lanes, per)
    for name in ("msv_scan", "msv_filter_scan", "msv_stacked_scan"):
        cnt = out[name]
        if wide:
            chip_smoke.require(set(cnt["blocks"]) == {16} and not cnt["cluster"]
                               and cnt["mem"] == 0,
                               f"MSV at {m_pad} ({name}): launches {cnt}, expected the 16-block "
                               "cluster of 8-warp blocks only")
    if msv_cuda.cluster_blocks(lanes) > 1:
        out["max_clusters"] = msv_cuda.max_clusters(dev.index or 0, lanes, per, False)
        out["regs_spill"] = msv_cuda.kernel_attrs(lanes, per, plan.warps, False)
    if time_it and msv_cuda.cluster_blocks(lanes) > 1:
        big = rng.integers(0, 20, size=(2048, 1000)).astype(np.int8)
        bstaged = scanner.stage(big, np.full(2048, 1000, dtype=np.int32))
        bm, bs = msv_cuda.init_carry(bstaged.tr_rows, m_pad)
        b_args = (emit, bstaged.tokens, bstaged.lengths, bstaged.tr_rows, consts, bm, bs)
        ms = chip_smoke.best_ms(lambda: msv_cuda.msv_scan_cuda(*b_args), reps=3)
        out["ms_2048x1000"] = ms
        out["gcups"] = 2048 * 1000 * (m_pad - 5) / ms / 1e6
    return out


P7_KINDS = ("lazy", "filter", "forward", "save", "backward")
P7_WRAPPERS = {"lazy": p7_cuda.viterbi_lazy_scan_cuda, "filter": p7_cuda.viterbi_filter_scan_cuda,
               "forward": p7_cuda.forward_prob_scan_cuda,
               "save": chip_smoke.posterior_cuda.forward_save_scan_cuda,
               "backward": chip_smoke.posterior_cuda.backward_coverage_scan_cuda}
POST_LEN = 1024  # the posterior pair's timed residues


def join_stems(c: int, high: bool, block: int = p7_cuda.MAX_GROUP_STATES) -> tuple[str, ...]:
    """The repo's profiles (LENG = the stem), largest first and as often as
    needed, whose join lands on a C-block cluster of ``c`` blocks of
    ``block`` states (2432: 128 threads of 19; 4864: 256 threads of 19, up
    to the chain's 65536): just past block * (c - 1) states (the last
    profile the smallest that crosses it) or, with ``high``, as near block *
    c as they fill."""
    sizes = sorted((int(stem) for stem in chip_smoke.stems()), reverse=True)
    lo, hi = block * (c - 1), min(block * c, p7_cuda.MAX_KERNEL_STATES)
    picks, total = [], 0
    while True:
        fit = [n for n in sizes if total + n <= (hi if high else lo)]
        if not fit:
            break
        picks.append(fit[0])
        total += fit[0]
    if not high:
        picks.append(min(n for n in sizes if total + n > lo))
    return tuple(str(n) for n in picks)


def p7_join(rng, scanner, stems: tuple[str, ...], time_it: bool) -> dict:
    dev = scanner.device
    p7 = chip_smoke.P7Profile.from_profile(chip_smoke.wide_profile(stems))
    m_pad = p7_cuda.default_m_pad(p7)
    c = p7_cuda.cluster_blocks(m_pad, "filter")
    staged = chip_smoke.ragged_wide_batch(scanner, rng)
    packs = chip_smoke.p7_packs(p7, dev)
    packs["lazy_k1"] = p7_cuda.viterbi_pack(p7, dev, lazy=True, lazy_k=1)
    for fn in P7_WRAPPERS.values():
        msv_cuda.zero_launches(fn)
    got, want = {}, {}
    for kind in ("lazy", "lazy_k1", "filter", "forward", "save"):
        base = "lazy" if kind == "lazy_k1" else kind
        run, carry = chip_smoke.p7_calls(base, packs[kind], staged)
        got[kind] = run(chip_smoke.CUDA_FNS[base], staged.tokens, staged.lengths, carry)
        torch.cuda.synchronize()
        want[kind] = run(chip_smoke.PLAIN_FNS[base], staged.tokens, staged.lengths, carry)
    name = f"LENG {p7.num_states}"
    for kind in ("lazy", "lazy_k1", "filter"):
        chip_smoke.require_equal(got[kind], want[kind], f"{name} {kind} kernel vs plain")
    chip_smoke.require_geq(got["filter"][0], got["lazy"][0], f"{name} filter vs lazy")
    f_err = chip_smoke.max_abs_diff(got["forward"][0], want["forward"][0])
    chip_smoke.require(f_err <= chip_smoke.FWD_TOL, f"{name} Forward vs plain: {f_err}")
    chip_smoke.require_equal(got["save"][:5], got["forward"], f"{name} row-saving vs Forward")
    chain = chip_smoke.p7_chain_error("forward", packs["forward"], staged)
    schain = chip_smoke.posterior_cuda.suffix_chain_rows(p7, dev)
    bwd_in = chip_smoke.backward_inputs(packs["forward"], schain, staged)
    cov = chip_smoke.posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
    torch.cuda.synchronize()
    b_err = chip_smoke.max_abs_diff(cov, chip_smoke.posterior_cuda.backward_coverage_scan_plain(
        *bwd_in))
    cov_p, _ = chip_smoke.posterior_decode(*chip_smoke.PLAIN_DECODE, packs["forward"], schain,
                                           staged)
    c_err = chip_smoke.max_abs_diff(cov, cov_p)
    chip_smoke.require(b_err <= chip_smoke.COV_TOL and c_err <= chip_smoke.COV_TOL,
                       f"{name} backward pass vs plain on its rows: {b_err}, coverage vs the "
                       f"plain decode: {c_err}")
    fires = int(got["lazy_k1"][5].sum())
    full = p7_cuda.chain_passes(m_pad)
    chip_smoke.require(fires > 0 or full > 15, f"{name}: lazy_k = 1 never fired")
    counts = {kind: counters(fn) | {"blocks": dict(fn.block_cluster_launches)}
              for kind, fn in P7_WRAPPERS.items()}
    for kind, cnt in counts.items():
        # past LAZY_BLOCK_STATES the lazy kind runs its cluster of wide blocks
        blocks = p7_cuda.block_cluster_case(m_pad, kind)
        want = p7_cuda.cluster_blocks(m_pad, kind)
        chip_smoke.require(set(cnt["blocks" if blocks else "cluster"]) == {want}
                           and cnt["mem"] == 0,
                           f"{name} {kind}: launches {cnt}, expected the {want}-block cluster "
                           f"only")
    out = {"join": "+".join(stems), "m_pad": m_pad, "c": c, "chain_passes": full,
           "lazy_k": packs["lazy"].lazy_k, "lazy_k1_fires": fires, "forward_max_abs": f_err,
           "forward_chain_max_abs": chain, "backward_max_abs": b_err, "coverage_max_abs": c_err,
           "launches": counts, "equal": True}
    for kind in P7_KINDS:
        plan = p7_cuda.device_plan(kind, m_pad, chip_smoke.passes_of(kind, packs[kind]), 64, dev)
        out[f"plan_{kind}"] = plan._asdict()
        out[f"regs_{kind}"] = p7_cuda.kernel_regs(kind, plan.per, plan.threads, plan.cluster)
        out[f"max_clusters_{kind}"] = p7_cuda.max_clusters(kind, plan.per, plan.smem,
                                                           dev.index or 0, plan.cluster,
                                                           plan.threads)
    if time_it:
        big = rng.integers(0, 20, size=(64, POST_LEN)).astype(np.int8)
        for kind in P7_KINDS:
            length = POST_LEN if kind in ("save", "backward") else 1000
            bstaged = scanner.stage(big[:, :length], np.full(64, length, dtype=np.int32))
            if kind == "backward":
                b_in = chip_smoke.backward_inputs(packs["forward"], schain, bstaged)
                fn = P7_WRAPPERS["backward"]
                ms = chip_smoke.best_ms(lambda: fn(*b_in), reps=3)
            else:
                run, carry = chip_smoke.p7_calls(kind, packs[kind], bstaged)
                fn = chip_smoke.CUDA_FNS[kind]
                ms = chip_smoke.best_ms(
                    lambda: run(fn, bstaged.tokens, bstaged.lengths, carry), reps=3)
            held = out[f"max_clusters_{kind}"]
            out[f"ms_{kind}_64x{length}"] = ms
            out[f"us_step_{kind}"] = ms * 1e3 / (length * -(-64 // held))
    return out


BLOCK_WRAPPERS = {"eager": p7_cuda.viterbi_scan_cuda, "log": p7_cuda.forward_log_scan_cuda}


def block_stems(per: int) -> tuple[str, ...]:
    """The repo's profiles, largest first, whose join fills a wide block of
    ``per`` states a thread as near BLOCK_THREADS * per states as they go
    (each profile at most once; past BLOCK_THREADS * (per - 1))."""
    sizes = sorted((int(stem) for stem in chip_smoke.stems()), reverse=True)
    hi = p7_cuda.BLOCK_THREADS * per
    picks, total = [], 0
    for n in sizes:
        if total + n <= hi:
            picks.append(n)
            total += n
    if total <= hi - p7_cuda.BLOCK_THREADS:
        raise ValueError(f"no join of the repo's profiles fills per {per}")
    return tuple(str(n) for n in picks)


def block_cluster_widths(pairs) -> list[int]:
    """The narrowest and the widest M_pad of each (C, per) cluster of wide
    blocks the plan takes."""
    out = []
    for c, per in pairs:
        widths = [m for m in range(p7_cuda.MAX_BLOCK_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8)
                  if p7_cuda.cluster_blocks(m, "eager") == c
                  and p7_cuda.kernel_case(m, "eager")[1] == per]
        if not widths:
            raise ValueError(f"the plan takes no cluster of {c} wide blocks of per {per}")
        out += sorted({widths[0], widths[-1]})
    return out


def p7_block_join(rng, scanner, hmm, name: str, time_it: bool) -> dict:
    """The eager and log-space kernels on ``hmm`` (``name``: its join or
    width) against their plain versions (the wide block up to
    MAX_BLOCK_STATES, else the cluster of wide blocks, or in a tree without
    it the rows-in-memory case), and the lazy kernel where it runs the same
    cluster (past LAZY_BLOCK_STATES), with the launch counters; timed with
    ``time_it``."""
    dev = scanner.device
    p7 = chip_smoke.P7Profile.from_profile(hmm)
    m_pad = p7_cuda.default_m_pad(p7)
    threads, per = p7_cuda.kernel_case(m_pad, "eager")
    block = p7_cuda.block_case(m_pad, "eager")
    blocks = hasattr(p7_cuda, "block_cluster_case") and p7_cuda.block_cluster_case(m_pad, "eager")
    c = p7_cuda.cluster_blocks(m_pad, "eager") if blocks else 1
    wrappers = dict(BLOCK_WRAPPERS)
    if hasattr(p7_cuda, "LAZY_BLOCK_STATES") and p7_cuda.block_cluster_case(m_pad, "lazy"):
        wrappers["lazy"] = p7_cuda.viterbi_lazy_scan_cuda
    staged = chip_smoke.ragged_wide_batch(scanner, rng)
    pack = p7_cuda.viterbi_pack(p7, dev, lazy=False)
    packs = {"eager": pack, "log": pack, "lazy": p7_cuda.viterbi_pack(p7, dev, lazy=True)}
    for fn in wrappers.values():
        msv_cuda.zero_launches(fn)
    got, want = {}, {}
    for kind in wrappers:
        run, carry = chip_smoke.p7_calls(kind, packs[kind], staged)
        got[kind] = run(chip_smoke.CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
        torch.cuda.synchronize()
        want[kind] = run(chip_smoke.PLAIN_FNS[kind], staged.tokens, staged.lengths, carry)
    name = f"{name}, LENG {p7.num_states}"
    e_err = chip_smoke.require_equal(got["eager"], want["eager"], f"{name} eager kernel vs plain")
    chain = chip_smoke.p7_chain_error("eager", pack, staged)
    l_err = chip_smoke.max_abs_diff(got["log"][0], want["log"][0])
    chip_smoke.require(l_err <= chip_smoke.LOG_FWD_TOL, f"{name} log-space vs plain: {l_err}")
    lazy = {}
    if "lazy" in wrappers:
        lazy["lazy_max_abs"] = chip_smoke.require_equal(got["lazy"], want["lazy"],
                                                        f"{name} lazy kernel vs plain")
        chip_smoke.require_equal([got["lazy"][0]], [got["eager"][0]], f"{name} lazy vs eager")
        chip_smoke.require(int(got["lazy"][5].sum()) == 0 and packs["lazy"].lazy_k == 16,
                           f"{name}: the lazy kernel replayed or certified a window")
        lazy["lazy_chain_max_abs"] = chip_smoke.p7_chain_error("lazy", packs["lazy"], staged)
    counts = {kind: counters(fn) | {"block": fn.block_launches,
                                    "blocks": dict(getattr(fn, "block_cluster_launches", {}))}
              for kind, fn in wrappers.items()}
    for kind, cnt in counts.items():
        if block:
            ok, what = cnt["block"] > 0 and cnt["mem"] == 0, "wide block"
        elif blocks:
            ok = set(cnt["blocks"]) == {c} and cnt["mem"] == 0 and cnt["block"] == 0
            what = f"cluster of {c} wide blocks"
        else:
            ok, what = cnt["mem"] > 0 and cnt["block"] == 0, "rows-in-memory case"
        chip_smoke.require(ok, f"{name} {kind}: launches {cnt}, expected the {what} only")
    out = {"join": name, "m_pad": m_pad, "threads": threads, "per": per, "cluster": c,
           "chain_passes": p7_cuda.chain_passes(m_pad), "eager_max_abs": e_err,
           "eager_chain_max_abs": chain, "log_max_abs": l_err, **lazy, "launches": counts,
           "equal": True}
    for kind in wrappers:
        plan = p7_cuda.device_plan(kind, m_pad, p7_cuda.chain_passes(m_pad), 64, dev)
        out[f"plan_{kind}"] = plan._asdict()
        out[f"regs_{kind}"] = p7_cuda.kernel_regs(kind, plan.per, plan.threads, plan.cluster)
        if blocks:
            out[f"clusters_{kind}"] = p7_cuda.max_clusters(kind, plan.per, plan.smem, dev.index or 0,
                                                           plan.cluster, plan.threads)
    if time_it:
        big = rng.integers(0, 20, size=(256, 1000)).astype(np.int8)
        shapes = ((64, 1000),) if name.startswith("random") else ((64, 1000), (256, 400))
        for rows, length in shapes:
            bstaged = scanner.stage(big[:rows, :length], np.full(rows, length, dtype=np.int32))
            for kind in wrappers:
                run, carry = chip_smoke.p7_calls(kind, packs[kind], bstaged)
                fn = chip_smoke.CUDA_FNS[kind]
                plan = p7_cuda.device_plan(kind, m_pad, p7_cuda.chain_passes(m_pad), rows, dev)
                ms = chip_smoke.best_ms(lambda: run(fn, bstaged.tokens, bstaged.lengths, carry),
                                        reps=1 if plan.mem else 3)
                rounds = -(-rows // (plan.grid // max(plan.cluster, 1)))
                out[f"ms_{kind}_{rows}x{length}"] = ms
                out[f"us_step_{kind}_{rows}x{length}"] = ms * 1e3 / (length * rounds)
    return out


WIDE_WRAPPERS = {"forward": p7_cuda.forward_prob_scan_cuda,
                 "save": chip_smoke.posterior_cuda.forward_save_scan_cuda,
                 "backward": chip_smoke.posterior_cuda.backward_coverage_scan_cuda,
                 "filter": p7_cuda.viterbi_filter_scan_cuda}


def posterior_vs_plain(scanner, p7, staged, name: str) -> dict:
    """Forward, the row-saving Forward and the backward pass on ``staged``
    against their plain versions, the row-saving Forward == Forward bit for
    bit (both run one case) and Forward's carry chain: the errors."""
    dev = scanner.device
    fpack = p7_cuda.forward_pack(p7, dev)
    schain = chip_smoke.posterior_cuda.suffix_chain_rows(p7, dev)
    run, carry = chip_smoke.p7_calls("save", fpack, staged)
    got = run(chip_smoke.CUDA_FNS["save"], staged.tokens, staged.lengths, carry)
    torch.cuda.synchronize()
    want = run(chip_smoke.PLAIN_FNS["save"], staged.tokens, staged.lengths, carry)
    fwd = run(chip_smoke.CUDA_FNS["forward"], staged.tokens, staged.lengths, carry)
    s_err = max(chip_smoke.max_abs_diff(g, w) for g, w in zip(got[:5], want[:5]))
    fp_err = chip_smoke.max_abs_diff(fwd[0], want[0])
    chip_smoke.require(s_err <= chip_smoke.FWD_TOL and fp_err <= chip_smoke.FWD_TOL,
                       f"{name} row-saving Forward vs plain (scores and carries): {s_err}, "
                       f"Forward vs plain: {fp_err}")
    f_err = chip_smoke.require_equal(got[:5], fwd, f"{name} row-saving Forward vs Forward")
    f_chain = chip_smoke.p7_chain_error("forward", fpack, staged)
    bwd_in = chip_smoke.backward_inputs(fpack, schain, staged)
    cov = chip_smoke.posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
    torch.cuda.synchronize()
    b_err = chip_smoke.max_abs_diff(
        cov, chip_smoke.posterior_cuda.backward_coverage_scan_plain(*bwd_in))
    cov_p, tot_p = chip_smoke.posterior_decode(*chip_smoke.PLAIN_DECODE, fpack, schain, staged)
    c_err, t_err = chip_smoke.max_abs_diff(cov, cov_p), chip_smoke.max_abs_diff(bwd_in[8], tot_p)
    chip_smoke.require(b_err <= chip_smoke.COV_TOL and c_err <= chip_smoke.COV_TOL
                       and t_err <= chip_smoke.TOT_TOL,
                       f"{name} backward pass vs plain on its rows: {b_err}, the decode: "
                       f"{c_err}, totals {t_err}")
    return {"forward_max_abs": fp_err, "forward_chain_max_abs": f_chain, "save_max_abs": s_err,
            "save_vs_forward_max_abs": f_err, "backward_max_abs": b_err,
            "coverage_max_abs": c_err, "totals_max_abs": t_err}


def filter_vs_plain(scanner, p7, staged, name: str) -> dict:
    """The Viterbi filter at its auto window and at the whole chain on
    ``staged`` against its plain version (scores and carries, bit for bit)
    and >= the eager kernel's scores: the errors."""
    eager = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
    run, carry = chip_smoke.p7_calls("eager", eager, staged)
    exact = run(chip_smoke.CUDA_FNS["eager"], staged.tokens, staged.lengths, carry)[0]
    msv_cuda.zero_launches(p7_cuda.viterbi_scan_cuda)  # the filter's counters alone
    out = {}
    for window in (None, p7_cuda.chain_passes(p7_cuda.default_m_pad(p7))):
        err, run_w = chip_smoke.filter_vs_plain(p7, staged, exact, window)
        out[f"filter_w{run_w}_max_abs"] = err
    return out


def p7_wide_cluster(rng, scanner, hmm, name: str, time_it: bool, mem_route: bool) -> dict:
    """Forward, the row-saving Forward and the backward pass on ``hmm``
    past 38,912 states against their plain versions (posterior_vs_plain),
    and the Viterbi filter (filter_vs_plain), on their C-block cluster of
    256-thread blocks, with the launch counters; with ``mem_route`` also on
    the rows-in-memory route of a card that holds no such cluster; timed
    with ``time_it``."""
    dev = scanner.device
    p7 = chip_smoke.P7Profile.from_profile(hmm)
    m_pad = p7_cuda.default_m_pad(p7)
    c = p7_cuda.cluster_blocks(m_pad, "save")
    staged = chip_smoke.ragged_wide_batch(scanner, rng)
    name = f"{name}, LENG {p7.num_states}"
    for fn in WIDE_WRAPPERS.values():
        msv_cuda.zero_launches(fn)
    out = {"join": name, "m_pad": m_pad, "cluster": c,
           **posterior_vs_plain(scanner, p7, staged, name),
           **filter_vs_plain(scanner, p7, staged, name)}
    counts = {kind: counters(fn) | {"blocks": dict(fn.block_cluster_launches)}
              for kind, fn in WIDE_WRAPPERS.items()}
    for kind, cnt in counts.items():
        chip_smoke.require(set(cnt["blocks"]) == {c} and cnt["mem"] == 0 and not cnt["cluster"],
                           f"{name} {kind}: launches {cnt}, expected the cluster of {c} "
                           f"256-thread blocks only")
    out["launches"] = counts
    fpack = p7_cuda.forward_pack(p7, dev)
    window = p7_cuda.filter_pack(p7, dev).window
    for kind in WIDE_WRAPPERS:
        passes = window if kind == "filter" else fpack.chain.shape[0]
        plan = p7_cuda.device_plan(kind, m_pad, passes, 64, dev)
        chip_smoke.require(plan.wide_cluster and plan.cluster == c, f"{name} {kind}: plan {plan}")
        out[f"plan_{kind}"] = plan._asdict()
        out[f"regs_{kind}"] = p7_cuda.kernel_regs(kind, plan.per, plan.threads, plan.cluster)
        out[f"clusters_{kind}"] = p7_cuda.max_clusters(kind, plan.per, plan.smem, dev.index or 0,
                                                       plan.cluster, plan.threads)
    if mem_route:
        with chip_smoke.no_block_clusters():
            for fn in WIDE_WRAPPERS.values():
                msv_cuda.zero_launches(fn)
            out["mem_route"] = posterior_vs_plain(scanner, p7, staged, f"{name} (rows in memory)")
            out["mem_route"].update(filter_vs_plain(scanner, p7, staged,
                                                    f"{name} (rows in memory)"))
            cnt = {kind: counters(fn) | {"blocks": dict(fn.block_cluster_launches)}
                   for kind, fn in WIDE_WRAPPERS.items()}
        chip_smoke.require(all(x["mem"] > 0 and not x["blocks"] for x in cnt.values()),
                           f"{name}: the rows-in-memory route launched {cnt}")
        out["mem_route"]["launches"] = cnt
    if time_it:
        big = rng.integers(0, 20, size=(64, POST_LEN)).astype(np.int8)
        bstaged = scanner.stage(big, np.full(64, POST_LEN, dtype=np.int32))
        schain = chip_smoke.posterior_cuda.suffix_chain_rows(p7, dev)
        b_in = chip_smoke.backward_inputs(fpack, schain, bstaged)
        run, carry = chip_smoke.p7_calls("save", fpack, bstaged)
        f_pack = p7_cuda.filter_pack(p7, dev)
        f_staged = scanner.stage(big[:, :1000], np.full(64, 1000, dtype=np.int32))
        f_run, f_carry = chip_smoke.p7_calls("filter", f_pack, f_staged)
        for kind, call in (("filter", lambda: f_run(WIDE_WRAPPERS["filter"], f_staged.tokens,
                                                     f_staged.lengths, f_carry)),
                           ("forward", lambda: run(WIDE_WRAPPERS["forward"], bstaged.tokens,
                                                    bstaged.lengths, carry)),
                           ("save", lambda: run(WIDE_WRAPPERS["save"], bstaged.tokens,
                                                bstaged.lengths, carry)),
                           ("backward", lambda: WIDE_WRAPPERS["backward"](*b_in))):
            ms = chip_smoke.best_ms(call, reps=3)
            held = out[f"clusters_{kind}"]
            steps = 1000 if kind == "filter" else POST_LEN
            out[f"ms_{kind}_64x{steps}"] = ms
            out[f"us_step_{kind}"] = ms * 1e3 / (steps * -(-64 // held))
    return out


# -- the release stress -------------------------------------------------------

STRESS_LEN = 300
STRESS_KINDS = ("lazy", "filter", "forward", "save", "backward")
# seconds without a launch ending that count as a hang: a launch takes well
# under one, a case's set-up (its join and packs) a few
STRESS_SILENCE = 120.0


def stress_cases(cs, wide_cs, block_cs=()) -> list[tuple[str, int, tuple[str, ...], str]]:
    """(kind, C, join, label) of every stressed case: the 128-thread kinds
    on the join of the repo's profiles as near 2432 * C states as they fill
    (join_stems: 18-19 states a thread) for each C of ``cs``, Forward, the
    row-saving Forward and the backward pass on the join as near 4864 * C
    (at most 65536) for each C of ``wide_cs`` on 256-thread blocks, the
    Viterbi filter there too (labelled ``<kind>256``), and the lazy Viterbi
    on the join as near 8192
    * C (past 38,912, at most 65536) for each C of ``block_cs`` on its
    cluster of C wide blocks (labelled ``lazy_blocks``)."""
    out = []
    for c in cs:
        stems = join_stems(c, True)
        m_pad = p7_cuda.round_up(sum(int(s) for s in stems), 8)
        # past LAZY_BLOCK_STATES the lazy kind is no 128-thread case
        out += [(kind, c, stems, kind) for kind in STRESS_KINDS
                if not p7_cuda.block_cluster_case(m_pad, kind)]
    wide_block = p7_cuda.WIDE_CLUSTER_THREADS * p7_cuda.WIDE_CLUSTER_PER[-1]
    for c in wide_cs:
        out += [(kind, c, join_stems(c, True, wide_block), f"{kind}256") for kind in WIDE_WRAPPERS]
    wide = p7_cuda.BLOCK_THREADS * p7_cuda.BLOCK_CLUSTER_PER[-1]
    out += [("lazy", c, join_stems(c, True, wide), "lazy_blocks") for c in block_cs]
    return out


MSV_STRESS_WRAPPERS = {"msv": msv_cuda.msv_scan_cuda, "msv_filter": msv_cuda.msv_filter_scan_cuda,
                       "msv_stacked": msv_cuda.msv_stacked_scan_cuda}


def msv_stress(n: int, widths, staged, rng) -> None:
    """MSV, the MSV filter and the stacked kernel (three tables) on a random
    table of each M_pad of ``widths`` (the 16-block cluster of 8-warp
    blocks past 38,912 states), n launches each, every result equal to the
    first (compared on the card) and the counters at C 16 alone; lines as
    stress_child's, labelled ``msv<mode>_<M_pad>`` with C 16."""
    dev = staged.tokens.device
    for m_pad in widths:
        emit = random_emit(rng, m_pad, m_pad - 5).to(dev)
        consts = torch.tensor([-0.7, -0.7, -3.2], dtype=torch.float32, device=dev)
        m, s = msv_cuda.init_carry(staged.tr_rows, m_pad)
        f_emit = msv_cuda.bf16_tensor(msv_cuda.bf16_round_up(emit.cpu().numpy()), dev)
        stack = torch.stack([emit, f_emit.float(), emit.flip(0)])
        calls = {
            "msv": lambda: msv_cuda.msv_scan_cuda(emit, staged.tokens, staged.lengths,
                                                  staged.tr_rows, consts, m, s),
            "msv_filter": lambda: msv_cuda.msv_filter_scan_cuda(
                f_emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s),
            "msv_stacked": lambda: (msv_cuda.msv_stacked_scan_cuda(
                stack, staged.tokens, staged.lengths, staged.tr_rows,
                torch.stack([consts, consts, consts + 0.25])),),
        }
        for kind, call in calls.items():
            fn = MSV_STRESS_WRAPPERS[kind]
            msv_cuda.zero_launches(fn)
            label = f"{kind}_{m_pad}"
            first = None
            for i in range(n):
                print(f"start {label} 16 {i}", flush=True)
                got = call()
                torch.cuda.synchronize()
                if first is None:
                    first = got
                else:
                    chip_smoke.require(all(torch.equal(g, w) for g, w in zip(got, first)),
                                       f"stress {label} launch {i}: not equal to the first")
                print(f"done {label} 16 {i}", flush=True)
            chip_smoke.require(fn.block_cluster_launches == {16: n} and fn.mem_launches == 0
                               and not fn.cluster_launches,
                               f"stress {label}: launches {counters(fn)}; expected {n} on the "
                               "16-block cluster of 8-warp blocks")


def stress_child(n: int, cs, wide_cs, block_cs=(), msv_widths=()) -> int:
    """The stress's launches (stress_cases, then msv_stress): one line a
    launch as it starts and as it ends, ``start|done <label> <C> <launch>``,
    then ``STRESS_DONE``; raises on a result that differs from the case's
    first launch (compared on the card) or a launch counted elsewhere."""
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    scanner = chip_smoke.MSVScanner(device=dev)
    rng = np.random.default_rng(chip_smoke.SEED + 20)
    tokens = rng.integers(0, 20, size=(chip_smoke.SURVIVOR_BATCH, STRESS_LEN)).astype(np.int8)
    lengths = rng.integers(STRESS_LEN // 2, STRESS_LEN + 1,
                           size=chip_smoke.SURVIVOR_BATCH).astype(np.int32)
    staged = scanner.stage(tokens, lengths)
    p7s = {}
    for kind, c, stems, label in stress_cases(cs, wide_cs, block_cs):
        if stems not in p7s:
            p7s[stems] = chip_smoke.P7Profile.from_profile(chip_smoke.wide_profile(stems))
        p7 = p7s[stems]
        m_pad = p7_cuda.default_m_pad(p7)
        if kind == "lazy":
            pack = p7_cuda.viterbi_pack(p7, dev, lazy=True, lazy_k=1)
        elif kind == "filter":
            pack = p7_cuda.filter_pack(p7, dev, window_log2=p7_cuda.chain_passes(m_pad))
        else:
            pack = p7_cuda.forward_pack(p7, dev)
        if kind == "backward":
            schain = chip_smoke.posterior_cuda.suffix_chain_rows(p7, dev)
            b_in = chip_smoke.backward_inputs(pack, schain, staged)

            def call():
                return (chip_smoke.posterior_cuda.backward_coverage_scan_cuda(*b_in),)
        else:
            run, carry = chip_smoke.p7_calls(kind, pack, staged)

            def call():
                return run(chip_smoke.CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
        fn = P7_WRAPPERS[kind]
        msv_cuda.zero_launches(fn)
        first = None
        for i in range(n):
            print(f"start {label} {c} {i}", flush=True)
            got = call()
            torch.cuda.synchronize()
            if first is None:
                first = got
                if kind == "lazy":
                    fires = int(got[5].sum())
                    chip_smoke.require(fires > 0 or p7_cuda.chain_passes(m_pad) > 15,
                                       f"stress lazy C {c}: lazy_k = 1 never fired")
                    print(f"lazy at C {c} (M_pad {m_pad}): {fires} chunks replayed a launch",
                          flush=True)
            else:
                chip_smoke.require(all(torch.equal(g, w) for g, w in zip(got, first)),
                                   f"stress {label} C {c} launch {i}: not equal to the first")
            print(f"done {label} {c} {i}", flush=True)
        wide = p7_cuda.wide_cluster_case(m_pad, kind) or p7_cuda.block_cluster_case(m_pad, kind)
        by_c = fn.block_cluster_launches if wide else fn.cluster_launches
        chip_smoke.require(by_c == {c: n} and fn.mem_launches == 0,
                           f"stress {kind} C {c}: launches {counters(fn)}, "
                           f"{dict(fn.block_cluster_launches)}; expected {n} at C {c}")
    msv_stress(n, msv_widths, staged, rng)
    print("STRESS_DONE", flush=True)
    return 0


def stress(n: int, cs, wide_cs, block_cs=(), msv_widths=()) -> int:
    """Run stress_child in a child process and watch it: fails, naming the
    launch under way, when the child falls silent for STRESS_SILENCE
    seconds or exits otherwise than 0."""
    cmd = [sys.executable, __file__, "--stress-child", str(n),
           "--stress-c", ",".join(map(str, cs)), "--stress-wide", ",".join(map(str, wide_cs)),
           "--stress-blocks", ",".join(map(str, block_cs)),
           "--stress-msv", ",".join(map(str, msv_widths))]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    sel = selectors.DefaultSelector()
    sel.register(child.stdout, selectors.EVENT_READ)
    last, done, launches = "the child's set-up", False, {}
    try:
        while True:
            if not sel.select(STRESS_SILENCE):
                child.kill()
                child.wait()
                print(f"STRESS_HANG: no launch ended for {STRESS_SILENCE} s; under way: {last}",
                      flush=True)
                return 1
            line = child.stdout.readline()
            if not line:
                break
            line = line.strip()
            if line.startswith("start "):
                last = line[len("start "):]
            elif line.startswith("done "):
                kind, c, _ = line.split()[1:]
                launches[f"{kind}_c{c}"] = launches.get(f"{kind}_c{c}", 0) + 1
            elif line == "STRESS_DONE":
                done = True
            else:
                print(line, flush=True)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    ok = done and child.returncode == 0
    print(json.dumps({"stress": "ok" if ok else "failed", "launches_each": n,
                      "launches": launches, "total_launches": sum(launches.values()),
                      "seconds": time.perf_counter() - t0, "last": last,
                      "child_rc": child.returncode}), flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default=",".join(str(w) for w in WIDTHS))
    ap.add_argument("--p7", default=",".join(str(c) for c in range(3, p7_cuda.MAX_CLUSTER + 1)))
    ap.add_argument("--block", default=",".join(str(per) for per in p7_cuda.BLOCK_PER))
    pairs = sorted({(p7_cuda.cluster_blocks(m, "eager"), p7_cuda.kernel_case(m, "eager")[1])
                    for m in range(p7_cuda.MAX_BLOCK_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8)})
    ap.add_argument("--blocks", default=",".join(f"{c}:{per}" for c, per in pairs))
    wide = sorted({p7_cuda.cluster_blocks(m, "save")
                   for m in range(p7_cuda.MAX_CLUSTER_STATES + 8, p7_cuda.MAX_KERNEL_STATES + 1, 8)})
    ap.add_argument("--wide", default=",".join(map(str, wide)))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--stress", type=int, default=0)
    ap.add_argument("--stress-child", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--stress-c", default=",".join(str(c) for c in range(4, p7_cuda.MAX_CLUSTER + 1)))
    ap.add_argument("--stress-wide", default=",".join(map(str, wide)))
    # the lazy kind's clusters of wide blocks past 38,912 states
    lazy_blocks = sorted({p7_cuda.cluster_blocks(m, "lazy")
                          for m in range(p7_cuda.LAZY_BLOCK_STATES + 8,
                                         p7_cuda.MAX_KERNEL_STATES + 1, 8)})
    ap.add_argument("--stress-blocks", default=",".join(map(str, lazy_blocks)))
    ap.add_argument("--stress-msv", default="38920,60368,65536")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cluster_check: no CUDA card", file=sys.stderr)
        return 1
    stress_cs = [int(x) for x in args.stress_c.split(",") if x]
    stress_wide = [int(x) for x in args.stress_wide.split(",") if x]
    stress_blocks = [int(x) for x in args.stress_blocks.split(",") if x]
    stress_msv = [int(x) for x in args.stress_msv.split(",") if x]
    if args.stress_child:
        return stress_child(args.stress_child, stress_cs, stress_wide, stress_blocks, stress_msv)
    if args.stress:
        _build.build()  # once, before the child's clock starts
        return stress(args.stress, stress_cs, stress_wide, stress_blocks, stress_msv)
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    _, log = _build.build()
    for line in chip_smoke.ptxas_summary(log):
        if "msv_kernel" in line and "true" in line or "forward" in line or "cluster" in line:
            print(line)
    scanner = chip_smoke.MSVScanner(device=dev)
    rng = np.random.default_rng(chip_smoke.SEED)
    for m_pad in (int(w) for w in args.widths.split(",") if w):
        print(json.dumps(msv_width(rng, scanner, m_pad, args.time)), flush=True)

    for c in (int(x) for x in args.p7.split(",") if x):
        for high in (False, True):
            print(json.dumps(p7_join(rng, scanner, join_stems(c, high), args.time)), flush=True)

    pers = [int(x) for x in args.block.split(",") if x]
    for stems in [block_stems(per) for per in pers] + (list(chip_smoke.MEM_JOINS) if pers else []):
        print(json.dumps(p7_block_join(rng, scanner, chip_smoke.wide_profile(stems),
                                       "+".join(stems), args.time)), flush=True)
    pairs = [tuple(int(v) for v in x.split(":")) for x in args.blocks.split(",") if x]
    fuzz = np.random.default_rng(chip_smoke.SEED + 19)
    for m_pad in block_cluster_widths(pairs):
        print(json.dumps(p7_block_join(rng, scanner, random_profile(fuzz, m_pad),
                                       f"random M_pad {m_pad}", args.time)), flush=True)
    wide_block = p7_cuda.WIDE_CLUSTER_THREADS * p7_cuda.WIDE_CLUSTER_PER[-1]
    for k, (c, high) in enumerate((int(x), high) for x in args.wide.split(",") if x
                                  for high in (False, True)):
        stems = join_stems(c, high, wide_block)
        print(json.dumps(p7_wide_cluster(rng, scanner, chip_smoke.wide_profile(stems),
                                         "+".join(stems), args.time, k == 0)), flush=True)

    errors = dict.fromkeys(chip_smoke.KERNELS, 0.0)
    chip_smoke.wide_kernels_vs_plain(scanner, rng, errors)
    lengths = rng.integers(0, chip_smoke.WIDE_LEN + 1, size=chip_smoke.WIDE_BATCH).astype(np.int32)
    lengths[:4] = [0, 1, 129, chip_smoke.WIDE_LEN]
    tokens = rng.integers(0, 20, size=(chip_smoke.WIDE_BATCH, chip_smoke.WIDE_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    for hmm in chip_smoke.wide_profiles():
        pack = p7_cuda.forward_pack(chip_smoke.P7Profile.from_profile(hmm), dev)
        plan = p7_cuda.device_plan("forward", pack.m_pad, pack.chain.shape[0], 64, dev)
        chain = chip_smoke.p7_chain_error("forward", pack, staged)
        print(json.dumps({"forward_pair": hmm.name, "m_pad": pack.m_pad,
                          "plan": plan._asdict(), "chain_max_abs": chain}), flush=True)
    print(json.dumps({k: v for k, v in errors.items() if k.endswith("_wide")}))
    if args.time:
        work = {}
        for name, (ms, plain_ms) in chip_smoke.wide_timings(scanner, rng, errors, work).items():
            b_ms, b_by = chip_smoke.bound(*work[name])
            print(json.dumps({"kernel": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "card": card}), flush=True)
    print("CLUSTER_CHECK_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
