"""Time the PyTorch port's MSV kernels on the card, one JSON line a case.

    python3 tools/torch_msv_timing.py [--label NAME]

Times the exact MSV kernel at 16384 x 3500 against 1400.hmm and 2405.hmm,
the MSV filter kernel against 1400.hmm, and the stacked sweep over the 24
profiles of data/profile_HMMs at 8192 x 3500 in both modes, one line a
stacked launch (a kernel case of the tree under test: the profiles it
groups, their states and padded width) and one line for the whole sweep.
Residues are random from a seed, all one length; best of 3 CUDA-event
timings after one warm-up. Each line gives the card's name and power limit.

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

from hmm_fasta_viterbi_tpu_torch import MSVProfile, MSVScanner, parse_hmm  # noqa: E402
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda  # noqa: E402

SEQ_LEN = 3500
BATCH = 16384
SWEEP_BATCH = 8192
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


def kernel_case(m_pad: int):
    """The tree's kernel case of an M row (the sweep's grouping key)."""
    fn = getattr(msv_cuda, "kernel_case", None) or msv_cuda.kernel_per
    return fn(m_pad)


def kernel_states(case) -> int:
    """States a case's kernel scans a profile: lanes x states a lane."""
    return case[0] * case[1] if isinstance(case, tuple) else 32 * case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda:0")
    _build.build()
    scanner = MSVScanner(device=device)
    root = pathlib.Path(msv_cuda.__file__).resolve().parents[2] / "data" / "profile_HMMs"
    stems = sorted((p.stem for p in root.glob("*.hmm")), key=int)
    profs = {s: MSVProfile.from_profile(parse_hmm(root / f"{s}.hmm")) for s in stems}
    rng = np.random.default_rng(SEED)

    def emit(kernel, ms, cells, **extra):
        print(json.dumps({"label": args.label, "kernel": kernel, "ms": ms,
                          "gcups": cells / ms / 1e6, "card": card, **extra}), flush=True)

    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    st = scanner.stage(tokens, np.full(BATCH, SEQ_LEN, dtype=np.int32))
    for stem, mode in (("1400", "exact"), ("2405", "exact"), ("1400", "filter")):
        p = profs[stem]
        m_pad = msv_cuda.round_up(p.num_states, 8)
        if mode == "exact":
            emit_t, consts = msv_cuda.pack_profile(p, m_pad, device)
            fn = msv_cuda.msv_scan_cuda
        else:
            emit_t, consts = msv_cuda.pack_profile_filter(p, m_pad, device)
            fn = msv_cuda.msv_filter_scan_cuda
        m, s = msv_cuda.init_carry(st.tr_rows, m_pad)
        ms = best_ms(lambda: fn(emit_t, st.tokens, st.lengths, st.tr_rows, consts, m, s))
        emit(f"msv_{mode}_{stem}", ms, BATCH * SEQ_LEN * p.num_states, batch=BATCH,
             length=SEQ_LEN, M=p.num_states, case=str(kernel_case(m_pad)))
    del st

    tokens = rng.integers(0, 20, size=(SWEEP_BATCH, SEQ_LEN)).astype(np.int8)
    st = scanner.stage(tokens, np.full(SWEEP_BATCH, SEQ_LEN, dtype=np.int32))
    groups: dict = {}
    for stem, p in profs.items():
        groups.setdefault(kernel_case(msv_cuda.round_up(p.num_states, 8)), []).append(stem)
    cells_all = SWEEP_BATCH * SEQ_LEN * sum(p.num_states for p in profs.values())
    for mode in ("exact", "filter"):
        packs = []
        for case, members in groups.items():
            group = tuple(profs[s] for s in members)
            emit_t, consts = scanner._stacked_pack(group, mode)
            packs.append((emit_t, consts))
            ms = best_ms(lambda: msv_cuda.msv_stacked_scan_cuda(
                emit_t, st.tokens, st.lengths, st.tr_rows, consts))
            mr = sum(p.num_states for p in group)
            emit(f"sweep_{mode}_group", ms, SWEEP_BATCH * SEQ_LEN * mr, batch=SWEEP_BATCH,
                 length=SEQ_LEN, case=str(case), profiles=members, sum_mr=mr,
                 m_pad=int(emit_t.shape[2]),
                 kernel_states=len(group) * kernel_states(case))
        ms = best_ms(lambda: [msv_cuda.msv_stacked_scan_cuda(e, st.tokens, st.lengths,
                                                             st.tr_rows, c) for e, c in packs])
        emit(f"sweep24_{mode}", ms, cells_all, batch=SWEEP_BATCH, length=SEQ_LEN,
             launches=len(packs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
