"""Time the PyTorch port's p7 kernels on the card, one JSON line a case.

    python3 tools/torch_p7_timing.py [--label NAME] [--batches 4096,64] [--groups 1,2,4]
                                     [--kernels forward_save_scan,backward_coverage_scan]

Times the eager and lazy Viterbi, the Forward, the Viterbi filter (its
auto window) and the log-space Forward kernels against 1400.hmm at B x 3500
for each batch B (random residues from a seed, all one length), and the
posterior pair at 1024 x 1024 (the row-saving Forward, then the backward
coverage pass on its rows); best of 3 CUDA-event timings after one warm-up.
--kernels times only the kernels named (the wrappers' names, as above).

Each line gives the card's name and power limit, and, where the tree under
test has the blocked kernels' launch plan (ops/p7_cuda.py::device_plan), the
groups, grid, staged chain rows, shared-memory bytes and registers of the
case. --groups also times each case at each of those group counts a block
that fits (the wrappers' ``groups`` argument), at every batch.

The script imports the port from the first `hmm_fasta_viterbi_tpu_torch` on
sys.path, its own checkout last, so PYTHONPATH=<another checkout> times that
checkout's kernels with the same inputs: two trees compare in one call by
running it once for each, in turns. Needs one CUDA card and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

# the checkout this script sits in, after any PYTHONPATH entry
sys.path.append(str(pathlib.Path(__file__).resolve().parent.parent))

from hmm_fasta_viterbi_tpu_torch import MSVScanner, P7Profile, parse_hmm  # noqa: E402
from hmm_fasta_viterbi_tpu_torch.ops import _build, p7_cuda, posterior_cuda  # noqa: E402

PROFILE = "1400.hmm"
SEQ_LEN = 3500
SAVE_SHAPE = (1024, 1024)
SEED = 0


def best_ms(fn, reps: int = 3) -> float:
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


def plan_of(kind: str, pack, passes: int, b: int, device, groups=None) -> dict:
    if not hasattr(p7_cuda, "device_plan") or kind not in p7_cuda.BLOCKED_KINDS:
        return {}
    plan = p7_cuda.device_plan(kind, pack.m_pad, passes, b, device, groups)
    return {**plan._asdict(), "regs": p7_cuda.kernel_regs(kind, p7_cuda.kernel_per(pack.m_pad))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--batches", default="4096,64")
    ap.add_argument("--groups", default="")
    ap.add_argument("--kernels", default="")
    args = ap.parse_args()
    forced = [int(x) for x in args.groups.split(",") if x]
    only = {x for x in args.kernels.split(",") if x}
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda:0")
    _build.build()
    scanner = MSVScanner(device=device)
    root = pathlib.Path(p7_cuda.__file__).resolve().parents[2]
    p7 = P7Profile.from_profile(parse_hmm(root / "data" / "profile_HMMs" / PROFILE))
    rng = np.random.default_rng(SEED)
    eager = p7_cuda.viterbi_pack(p7, device, lazy=False)
    lazy = p7_cuda.viterbi_pack(p7, device, lazy=True)
    fwd = p7_cuda.forward_pack(p7, device)
    filt = p7_cuda.filter_pack(p7, device)
    n_passes = p7_cuda.chain_passes(eager.m_pad)

    def emit(name, b, length, ms, kind, pack, passes, groups=None):
        cells = b * length * p7.num_states
        print(json.dumps({"label": args.label, "kernel": name, "batch": b, "length": length,
                          "M": p7.num_states, "ms": ms, "gcups": cells / ms / 1e6,
                          "card": card, **plan_of(kind, pack, passes, b, device, groups)}),
              flush=True)

    def time_case(name, kind, pack, passes, b, length, fn):
        if only and name not in only:
            return
        emit(name, b, length, best_ms(fn), kind, pack, passes)
        for g in forced if plan_of(kind, pack, passes, b, device) else ():
            most = plan_of(kind, pack, passes, b, device)["max_groups"]
            if g <= most:
                emit(name, b, length, best_ms(lambda: fn(groups=g)), kind, pack, passes, g)

    for b in (int(x) for x in args.batches.split(",") if x):
        tokens = rng.integers(0, 20, size=(b, SEQ_LEN)).astype(np.int8)
        st = scanner.stage(tokens, np.full(b, SEQ_LEN, dtype=np.int32))
        vc = p7_cuda.viterbi_init_carry(st.tr_rows, eager.m_pad)
        fc = p7_cuda.forward_init_carry(st.tr_probs, fwd.m_pad)
        vargs = (st.tokens, st.lengths, st.tr_rows)
        cases = (
            ("viterbi_lazy_scan", "lazy", lazy, lazy.lazy_k,
             lambda **g: p7_cuda.viterbi_lazy_scan_cuda(*lazy[:4], *vargs, lazy.consts, *vc,
                                                        lazy.lazy_k, **g)),
            ("viterbi_scan", "eager", eager, n_passes,
             lambda **g: p7_cuda.viterbi_scan_cuda(*eager[:4], *vargs, eager.consts, *vc, **g)),
            ("forward_prob_scan", "forward", fwd, fwd.chain.shape[0],
             lambda **g: p7_cuda.forward_prob_scan_cuda(*fwd[:4], *vargs, st.tr_probs,
                                                        fwd.consts, *fc, **g)),
            ("viterbi_filter_scan", "filter", filt, filt.window,
             lambda **g: p7_cuda.viterbi_filter_scan_cuda(*filt[:4], *vargs, filt.consts, *vc,
                                                          filt.window, filt.e_skip_d, **g)),
            ("forward_log_scan", "log", eager, n_passes,
             lambda **g: p7_cuda.forward_log_scan_cuda(*eager[:4], *vargs, eager.consts, *vc,
                                                       **g)),
        )
        for name, kind, pack, passes, fn in cases:
            time_case(name, kind, pack, passes, b, SEQ_LEN, fn)

    b, length = SAVE_SHAPE
    tokens = rng.integers(0, 20, size=(b, length)).astype(np.int8)
    st = scanner.stage(tokens, np.full(b, length, dtype=np.int32))
    fc = p7_cuda.forward_init_carry(st.tr_probs, fwd.m_pad)
    save = lambda **g: posterior_cuda.forward_save_scan_cuda(  # noqa: E731
        *fwd[:4], st.tokens, st.lengths, st.tr_rows, st.tr_probs, fwd.consts, *fc, **g)
    time_case("forward_save_scan", "save", fwd, fwd.chain.shape[0], b, length, save)
    total, *_, fm, ls = save()
    schain = posterior_cuda.suffix_chain_rows(p7, device)
    bwd = (fwd.emit_m, fwd.emit_i, fwd.trans, schain, st.tokens, st.lengths, st.tr_probs,
           fwd.consts, total, fm, ls)
    time_case("backward_coverage_scan", "backward", fwd, schain.shape[0], b, length,
              lambda **g: posterior_cuda.backward_coverage_scan_cuda(*bwd, **g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
