"""Check and time the wide cases of the PyTorch port's kernels on the card.

    python3 tools/torch_wide_timing.py [--tree DIR] [--label NAME] [--check] [--mem]
                                       [--posterior] [--clusters] [--block] [--rule]

The wide cases are the kernels' code paths for profiles of 2433 to 4864
states (M_pad). With --check, chip_smoke.py's phase-8 check of them runs
first (wide_kernels_vs_plain: both wide profiles, LENG 2701 and 4770,
through every kernel against its plain version). Then its phase-10 wide
timings (wide_timings: MSV, the MSV filter and the stacked kernel at 2048 x
3500, the p7 kernels at 64 x 3500, the posterior pair at 64 x 1024, against
the LENG 4770 join; best of 3 CUDA-event timings, each plain version once
and held against the kernel) print one JSON line a case: its ms, its plain
version's ms, its bound (chip_smoke.bound) and the card's name and power
limit. With --mem, phase 10's timings of the cases past 4864 states follow
(mem_timings: the MSV kernels against the LENG 6977 join at 2048 x 1000 and
the stacked kernel over it and the all-24 join, the p7 kernels at 64 x 1000,
the posterior pair at 64 x 1024; a tree that has the MSV C-block clusters
also times the MSV rows-in-memory case past 38,912 states, and one that has
the p7 C-block clusters the p7 cases against the all-24 join, LENG 30181,
too), one JSON line a case as well; for a tree whose mem_timings stops at
LENG 6977 this script times the lazy Viterbi, the Viterbi filter, Forward
(64 x 1000) and the row-saving Forward (64 x 1024) against the all-24 join
itself, once after a warm-up (rows ``<kernel>_30181``). With --posterior
(in place of the wide timings) it times the posterior pair past 2432 states
alone: the row-saving Forward and the backward pass on its rows at 64 x
1024 against LENG 4770, 6977, 30181 and 60362, best of 3 (rows
``<kernel>_<LENG>``), and at LENG 60362 also at the sequences of one
posterior_coverage_batch call, 26 x 1024 (rows ``<kernel>_60362_chunk``),
the same work for any tree. With --clusters (in place of the wide timings,
beside --posterior) it times the lazy Viterbi, the Viterbi filter and
Forward against the LENG 6977 and 30181 joins at 64 x 1000, best of 3 (rows
``<kernel>_<LENG>``: the C-block clusters of 3 and 13 blocks), then the
lazy Viterbi and Forward against the all-24 join twice over (LENG 60362,
past 38,912 states: whatever case the tree plans there, best of 3 on a
cluster, once in memory) and the lazy Viterbi against two joins between
32,769 and 38,912 states, where its chain has 16 passes (the all-24 join
with 2405 and 2365, LENG 34951, and with 2405, 2365, 2207 and 1705, LENG
38863), at 64 x 1000, and, in a tree whose lazy kind has the clusters of
wide blocks (p7_cuda.LAZY_BLOCK_STATES), at those two joins again on the
case the tree does not plan there: the cluster of 5 wide blocks (rows
``viterbi_lazy_scan_<LENG>_blocks``) or the 128-thread C-block cluster of
15 or 16 blocks (``_cluster``); then the Viterbi filter at 64 x 1000 and
MSV, the MSV filter and the stacked kernel at MSV_MEM_BATCH x 1000 (256)
against the LENG 60362 join and the two joins at the ends of the range
past 38,912 states (the all-24 join with 2405, 2365, 2207, 1705 and 100,
LENG 38963; the all-24 join twice over with 2405 and 2207, LENG 64974),
best of 3 on whatever case the tree plans (rows ``<kernel>_<LENG>``). With --block (in place
of the wide timings) it times the eager Viterbi and the log-space Forward
past 4864 states alone, through whatever case the tree plans (the
rows-in-memory case before the wide block and, past 9216 states, before
the clusters of wide blocks): against the LENG 6977 join at 64 x 1000 (rows
``<kernel>_6977``) and at build's calibration shape, 256 x 400
(``<kernel>_6977_cal``), against the LENG 30181 join at both shapes
(``<kernel>_30181``, ``<kernel>_30181_cal``), against the LENG 60362 join
and the joins of chip_smoke.CLUSTER_JOINS (LENG 11165, 18170, 19679) at 64
x 1000 (``<kernel>_<LENG>``); best of 3, a rows-in-memory case once, each
after a warm-up; the same work for any tree. A tree with the clusters of
wide blocks also times its rows-in-memory route at LENG 30181 (a card that
holds no such cluster, chip_smoke.no_block_clusters; ``<kernel>_30181_mem``)
and, with --rule, every cluster size its compiled cases cover at LENG
30181, 18170 and 19679 (C = 4..7, 3..4, 3..4: per 8, 6, 5, 5; 6, 5; 7, 5;
the plan's rule takes the smallest C) at the join's shapes, rows
``<kernel>_<LENG>[_cal]_c<C>``. The
ptxas line of every kernel case (registers and spills) prints first.

Everything is imported from the checkout DIR (default: this script's):
its chip_smoke.py, its package and its kernels, built there at first use.
Two trees compare in one call by running the script once for each, in
turns (parent, change, change, parent). Needs one CUDA card and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

import numpy as np


def p7_rows_30181(chip_smoke, scanner, rng, work: dict) -> dict:
    """The lazy Viterbi, the Viterbi filter and Forward at 64 x 1000 and the
    row-saving Forward at 64 x 1024 against the all-24 join (LENG 30181),
    once after a warm-up, through the tree's own helpers; no plain version."""
    p7 = chip_smoke.P7Profile.from_profile(chip_smoke.mem_profiles()[1])
    packs = chip_smoke.p7_packs(p7, scanner.device)
    b, n = chip_smoke.SURVIVOR_BATCH, chip_smoke.MEM_TIME_LEN
    tokens = rng.integers(0, 20, size=(b, n)).astype(np.int8)
    out = {}
    for name, kind, length in (("viterbi_lazy_scan", "lazy", n), ("viterbi_filter_scan", "filter", n),
                               ("forward_prob_scan", "forward", n),
                               ("forward_save_scan", "save", chip_smoke.POST_TIME_LEN)):
        staged = scanner.stage(tokens[:, :length], np.full(b, length, dtype=np.int32))
        run, carry = chip_smoke.p7_calls(kind, packs[kind], staged)
        fn = chip_smoke.CUDA_FNS[kind]
        ms = chip_smoke.best_ms(lambda: run(fn, staged.tokens, staged.lengths, carry), reps=1)
        key = f"{name}_30181"
        out[key] = (ms, float("nan"))
        ops = chip_smoke.OPS_PER_CELL["forward" if kind == "save" else kind]
        work[key] = (ops(chip_smoke.passes_of(kind, packs[kind])) * b * length * p7.num_states,
                     chip_smoke.nbytes(*packs[kind][:4], staged.tokens))
        print(f"{key}: {ms:.3f} ms (once, {b} x {length} x M={p7.num_states})", flush=True)
    return out


def posterior_rows_past(chip_smoke, scanner, rng, work: dict) -> dict:
    """The posterior pair at 64 x 1024 against the wider wide profile (LENG
    4770) and the joins past 4864 states (LENG 6977 and 30181, and the
    all-24 join twice over, LENG 60362, there also at the 26 rows of one
    posterior_coverage_batch call): the row-saving Forward, then the
    backward pass on its rows, each best of 3 after a warm-up, through the
    tree's own helpers; no plain version. Rows ``forward_save_scan_<LENG>``
    and ``backward_coverage_scan_<LENG>`` (``..._chunk`` at 26 rows)."""
    b, n = chip_smoke.SURVIVOR_BATCH, chip_smoke.POST_TIME_LEN
    tokens = rng.integers(0, 20, size=(b, n)).astype(np.int8)
    post = chip_smoke.posterior_cuda
    p7_cuda = chip_smoke.p7_cuda
    out = {}
    for hmm in (chip_smoke.wide_profiles()[1], *chip_smoke.mem_profiles(),
                chip_smoke.msv_mem_profile()):
        p7 = chip_smoke.P7Profile.from_profile(hmm)
        fpack = p7_cuda.forward_pack(p7, scanner.device)
        schain = post.suffix_chain_rows(p7, scanner.device)
        shapes = [(b, "")]
        if p7.num_states > p7_cuda.MAX_CLUSTER_STATES:
            shapes.append((post.POST_BYTES // (n * fpack.m_pad * 2), "_chunk"))
        for rows, tag in shapes:
            staged = scanner.stage(tokens[:rows], np.full(rows, n, dtype=np.int32))
            fwd_in = (*fpack[:4], staged.tokens, staged.lengths, staged.tr_rows,
                      staged.tr_probs, fpack.consts,
                      *p7_cuda.forward_init_carry(staged.tr_probs, fpack.m_pad))
            saved = post.forward_save_scan_cuda(*fwd_in)
            bwd_in = (fpack.emit_m, fpack.emit_i, fpack.trans, schain, staged.tokens,
                      staged.lengths, staged.tr_probs, fpack.consts, saved[0], saved[5],
                      saved[6])
            cells = rows * n * p7.num_states
            for name, fn, args, ops, moved in (
                    ("forward_save_scan", post.forward_save_scan_cuda, fwd_in,
                     chip_smoke.OPS_PER_CELL["forward"](fpack.chain.shape[0]),
                     (*fwd_in, *saved)),
                    ("backward_coverage_scan", post.backward_coverage_scan_cuda, bwd_in,
                     chip_smoke.OPS_PER_CELL["backward"](schain.shape[0]),
                     (*bwd_in, saved[0]))):
                ms = chip_smoke.best_ms(lambda: fn(*args), reps=3)
                key = f"{name}_{p7.num_states}{tag}"
                out[key] = (ms, float("nan"))
                work[key] = (ops * cells, chip_smoke.nbytes(*moved))
                print(f"{key}: {ms:.3f} ms (best of 3, {rows} x {n} x M={p7.num_states})",
                      flush=True)
            del saved, bwd_in
    return out


def cluster_rows_past(chip_smoke, scanner, rng, work: dict) -> dict:
    """The lazy Viterbi, the Viterbi filter and Forward at 64 x 1000
    against the joins of chip_smoke.MEM_JOINS (LENG 6977 and 30181: the
    C-block clusters of 3 and 13 128-thread blocks), best of 3 after a
    warm-up, through the tree's own helpers; no plain version. Rows
    ``<kernel>_<LENG>``."""
    b, n = chip_smoke.SURVIVOR_BATCH, chip_smoke.MEM_TIME_LEN
    tokens = rng.integers(0, 20, size=(b, n)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(b, n, dtype=np.int32))
    p7_cuda = chip_smoke.p7_cuda
    lazy_fwd = (("viterbi_lazy_scan", "lazy"), ("forward_prob_scan", "forward"))
    joins = [(hmm, (("viterbi_lazy_scan", "lazy"), ("viterbi_filter_scan", "filter"),
                    ("forward_prob_scan", "forward"))) for hmm in chip_smoke.mem_profiles()]
    joins += [(chip_smoke.msv_mem_profile(), lazy_fwd)]
    joins += [(chip_smoke.wide_profile(chip_smoke.MEM_JOINS[1] + extra), lazy_fwd[:1])
              for extra in (("2405", "2365"), ("2405", "2365", "2207", "1705"))]
    out = {}

    def time_kind(p7, packs, name, kind, tag=""):
        plan = p7_cuda.device_plan(kind, packs[kind].m_pad,
                                   chip_smoke.passes_of(kind, packs[kind]), b, scanner.device)
        reps = 1 if plan.mem else 3
        run, carry = chip_smoke.p7_calls(kind, packs[kind], staged)
        fn = chip_smoke.CUDA_FNS[kind]
        ms = chip_smoke.best_ms(lambda: run(fn, staged.tokens, staged.lengths, carry), reps=reps)
        key = f"{name}_{p7.num_states}{tag}"
        out[key] = (ms, float("nan"))
        passes = chip_smoke.passes_of(kind, packs[kind])
        work[key] = (chip_smoke.OPS_PER_CELL[kind](passes) * b * n * p7.num_states,
                     chip_smoke.nbytes(*packs[kind][:4], staged.tokens))
        print(f"{key}: {ms:.3f} ms (best of {reps}, {b} x {n} x M={p7.num_states}; plan "
              f"{plan})", flush=True)

    for hmm, kinds in joins:
        p7 = chip_smoke.P7Profile.from_profile(hmm)
        packs = chip_smoke.p7_packs(p7, scanner.device)
        for name, kind in kinds:
            time_kind(p7, packs, name, kind)
        m_pad = p7_cuda.default_m_pad(p7)
        if 32768 < m_pad <= p7_cuda.MAX_CLUSTER_STATES and hasattr(p7_cuda, "LAZY_BLOCK_STATES"):
            # where the chain has 16 passes, the lazy kind on the case the
            # plan does not take: its clusters of wide blocks start at
            # LAZY_BLOCK_STATES
            first = p7_cuda.LAZY_BLOCK_STATES
            blocks = p7_cuda.block_cluster_case(m_pad, "lazy")
            p7_cuda.LAZY_BLOCK_STATES = p7_cuda.MAX_CLUSTER_STATES if blocks else 32768
            try:
                time_kind(p7, packs, "viterbi_lazy_scan", "lazy",
                          "_cluster" if blocks else "_blocks")
            finally:
                p7_cuda.LAZY_BLOCK_STATES = first
    return out


def past_38912_joins(chip_smoke) -> list:
    """The joins past 38,912 states of --clusters' filter and MSV rows:
    LENG 38963, 60362 and 64974."""
    every = tuple(chip_smoke.stems())
    return [chip_smoke.wide_profile(every + ("2405", "2365", "2207", "1705", "100")),
            chip_smoke.msv_mem_profile(),
            chip_smoke.wide_profile(chip_smoke.MSV_MEM_JOIN + ("2405", "2207"))]


def past_rows(chip_smoke, scanner, rng, work: dict) -> dict:
    """The Viterbi filter at 64 x 1000 and MSV, the MSV filter and the
    stacked kernel at 256 x 1000 against past_38912_joins, best of 3 after a
    warm-up on whatever case the tree plans, through the tree's own helpers;
    no plain version. Rows ``<kernel>_<LENG>``."""
    p7_cuda, msv_cuda = chip_smoke.p7_cuda, chip_smoke.msv_cuda
    b, n = 256, chip_smoke.MEM_TIME_LEN
    tokens = rng.integers(0, 20, size=(b, n)).astype(np.int8)
    msv_staged = scanner.stage(tokens, np.full(b, n, dtype=np.int32))
    few = chip_smoke.SURVIVOR_BATCH
    p7_staged = scanner.stage(tokens[:few], np.full(few, n, dtype=np.int32))
    out = {}
    for hmm in past_38912_joins(chip_smoke):
        p7 = chip_smoke.P7Profile.from_profile(hmm)
        leng = p7.num_states
        pack = p7_cuda.filter_pack(p7, scanner.device)
        plan = p7_cuda.device_plan("filter", pack.m_pad, pack.window, few, scanner.device)
        run, carry = chip_smoke.p7_calls("filter", pack, p7_staged)
        fn = chip_smoke.CUDA_FNS["filter"]
        ms = chip_smoke.best_ms(lambda: run(fn, p7_staged.tokens, p7_staged.lengths, carry),
                                reps=3)
        key = f"viterbi_filter_scan_{leng}"
        out[key] = (ms, float("nan"))
        work[key] = (chip_smoke.OPS_PER_CELL["filter"](pack.window) * few * n * leng,
                     chip_smoke.nbytes(*pack[:4], pack.consts, p7_staged.tokens))
        print(f"{key}: {ms:.3f} ms (best of 3, {few} x {n} x M={leng}, window {pack.window}; "
              f"plan {plan})", flush=True)
        msv = chip_smoke.MSVProfile.from_profile(hmm)
        cells = b * n * leng
        for name, fmode in (("msv_scan", False), ("msv_filter_scan", True)):
            args = chip_smoke.msv_args(scanner, msv, msv_staged, filter_mode=fmode)
            call = chip_smoke.MSV_FNS[fmode][0]
            ms = chip_smoke.best_ms(lambda: call(*args), reps=3)
            key = f"{name}_{leng}"
            out[key] = (ms, float("nan"))
            work[key] = (chip_smoke.OPS_PER_CELL["msv"](0) * cells, chip_smoke.nbytes(*args))
            print(f"{key}: {ms:.3f} ms (best of 3, {b} x {n} x M={leng}; plan "
                  f"{chip_smoke.msv_plan_text(args[0], b)})", flush=True)
        emit, consts = scanner._stacked_pack((msv,), "exact")
        s_args = (emit, msv_staged.tokens, msv_staged.lengths, msv_staged.tr_rows, consts)
        ms = chip_smoke.best_ms(lambda: msv_cuda.msv_stacked_scan_cuda(*s_args), reps=3)
        key = f"msv_stacked_scan_{leng}"
        out[key] = (ms, float("nan"))
        work[key] = (chip_smoke.OPS_PER_CELL["msv"](0) * cells, chip_smoke.nbytes(*s_args))
        print(f"{key}: {ms:.3f} ms (best of 3, {b} x {n} x M={leng}, one profile)", flush=True)
    return out


@contextlib.contextmanager
def forced_blocks(p7_cuda, c: int):
    """The plan's cluster of wide blocks forced to ``c`` blocks (per the
    smallest that covers M_pad at c), every other case as planned."""
    real = p7_cuda.cluster_blocks

    def forced(m_pad, kind=None):
        return c if p7_cuda.block_cluster_case(m_pad, kind) else real(m_pad, kind)

    p7_cuda.cluster_blocks = forced
    try:
        yield
    finally:
        p7_cuda.cluster_blocks = real


def block_rows_past(chip_smoke, scanner, rng, work: dict, rule: bool) -> dict:
    """The eager Viterbi and the log-space Forward against the joins past
    4864 states (--block; with ``rule``, --rule's forced cluster sizes),
    through the tree's own helpers; no plain version."""
    p7_cuda = chip_smoke.p7_cuda
    tokens = rng.integers(0, 20, size=(256, 1000)).astype(np.int8)
    both = ((64, 1000, ""), (256, 400, "_cal"))
    joins = [(chip_smoke.mem_profiles()[0], both), (chip_smoke.mem_profiles()[1], both),
             (chip_smoke.msv_mem_profile(), both[:1])]
    joins += [(chip_smoke.wide_profile(stems), both[:1]) for stems in chip_smoke.CLUSTER_JOINS]
    new = hasattr(p7_cuda, "block_cluster_case")
    out = {}

    def time_join(pack, leng, shapes, tag=""):
        passes = p7_cuda.chain_passes(pack.m_pad)
        for rows, length, shape_tag in shapes:
            staged = scanner.stage(tokens[:rows, :length], np.full(rows, length, dtype=np.int32))
            for name, kind in (("viterbi_scan", "eager"), ("forward_log_scan", "log")):
                plan = p7_cuda.device_plan(kind, pack.m_pad, passes, rows, scanner.device)
                reps = 1 if plan.mem else 3
                run, carry = chip_smoke.p7_calls(kind, pack, staged)
                fn = chip_smoke.CUDA_FNS[kind]
                ms = chip_smoke.best_ms(lambda: run(fn, staged.tokens, staged.lengths, carry),
                                        reps=reps)
                key = f"{name}_{leng}{shape_tag}{tag}"
                out[key] = (ms, float("nan"))
                work[key] = (chip_smoke.OPS_PER_CELL[kind](passes) * rows * length * leng,
                             chip_smoke.nbytes(*pack[:4], pack.consts, staged.tokens,
                                               staged.lengths, staged.tr_rows, *carry))
                units = plan.grid // max(plan.cluster, 1) * plan.groups
                rounds = -(-rows // units)
                print(f"{key}: {ms:.3f} ms (best of {reps}, {rows} x {length} x M={leng}; "
                      f"{ms * 1e3 / (length * rounds):.2f} us a step, {rounds} rounds; plan "
                      f"{plan})", flush=True)

    for hmm, shapes in joins:
        p7 = chip_smoke.P7Profile.from_profile(hmm)
        pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
        time_join(pack, p7.num_states, shapes)
        if new and hasattr(chip_smoke, "no_block_clusters") and p7.num_states == 30181:
            with chip_smoke.no_block_clusters():
                time_join(pack, p7.num_states, shapes[:1], "_mem")
        if new and rule and p7.num_states in (30181, 18170, 19679):
            smallest = p7_cuda.cluster_blocks(pack.m_pad, "eager")
            for c in range(smallest + 1, p7_cuda.MAX_BLOCK_CLUSTER + 1):
                per = -(-pack.m_pad // (p7_cuda.BLOCK_THREADS * c))
                if per not in p7_cuda.BLOCK_CLUSTER_PER:
                    break
                with forced_blocks(p7_cuda, c):
                    time_join(pack, p7.num_states, shapes, f"_c{c}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--mem", action="store_true")
    ap.add_argument("--posterior", action="store_true")
    ap.add_argument("--clusters", action="store_true")
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--rule", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    import torch

    import chip_smoke
    from hmm_fasta_viterbi_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_wide_timing: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi("name,power.limit")
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    lib, log = _build.build()
    print(f"{args.label}: library {lib}")
    for line in chip_smoke.ptxas_summary(log):
        print(f"{args.label}: {line}")
    scanner = chip_smoke.MSVScanner(device=dev)
    rng = np.random.default_rng(chip_smoke.SEED)
    errors = dict.fromkeys(chip_smoke.KERNELS, 0.0)
    if args.check:
        chip_smoke.wide_kernels_vs_plain(scanner, rng, errors)
    work, out = {}, {}
    if args.posterior:
        out.update(posterior_rows_past(chip_smoke, scanner, rng, work))
    if args.clusters:
        out.update(cluster_rows_past(chip_smoke, scanner, rng, work))
        out.update(past_rows(chip_smoke, scanner, rng, work))
    if args.block:
        out.update(block_rows_past(chip_smoke, scanner, rng, work, args.rule))
    if not (args.posterior or args.clusters or args.block):
        out = chip_smoke.wide_timings(scanner, rng, errors, work)
    if args.mem:
        out.update(chip_smoke.mem_timings(scanner, rng, errors, work))
        if not hasattr(chip_smoke, "P7_CLUSTER_WRAPPERS"):
            out.update(p7_rows_30181(chip_smoke, scanner, rng, work))

    for name, (ms, plain_ms) in out.items():
        b_ms, b_by = chip_smoke.bound(*work[name])
        print(json.dumps({"label": args.label, "kernel": name, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
                          "max_abs_err": errors.get(name), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
