"""Check the MSV kernel's C-block cluster cases and the Forward template's
cluster pair against their plain versions on the card.

    python3 tools/torch_cluster_check.py [--widths 2440,4872,...] [--time]

MSV: for each M_pad of --widths (default: the boundaries of every cluster
size from the pair to 16 blocks, and two widths past 38,912), a random f32
table (-inf pad columns) scans a ragged batch of 64 sequences up to 300
residues: the exact kernel (carries in and out, a two-call carry chain
split at 129), the filter (the table rounded to bf16) and a stack of three
such tables, each equal to its plain version bit for bit; the launch
counters show which case ran (cluster_launches by C, mem_launches past
38,912). Forward: chip_smoke.py's wide check of both wide profiles (LENG
2701 and 4770), whose Forward and row-saving Forward run on the pair, and a
Forward carry chain split at a multiple of FWD_RESCALE_GROUP equal to one
call bit for bit. With --time, the MSV cluster cases at 2048 x 1000 and the
Forward pair at 64 x 3500 are timed (CUDA events, best of 3), beside the
card's name and power limit. One line a check; exits 1 on a failure.
Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda, p7_cuda  # noqa: E402

WIDTHS = (2440, 4864, 4872, 7296, 7304, 9728, 9736, 12160, 17024, 19456, 19464, 21888,
          30184, 36488, 38912, 38920, 60368)
BATCH, LEN, SPLIT = 64, 300, 129


def random_emit(rng, m_pad: int, real: int) -> torch.Tensor:
    emit = np.full((msv_cuda.NUM_AA, m_pad), -np.inf, dtype=np.float32)
    emit[:, :real] = rng.normal(-0.5, 1.5, size=(msv_cuda.NUM_AA, real)).astype(np.float32)
    return torch.from_numpy(emit)


def counters(fn) -> dict:
    return {"launches": fn.launches, "wide": fn.wide_launches, "mem": fn.mem_launches,
            "cluster": dict(fn.cluster_launches)}


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
    out = {"m_pad": m_pad, "lanes": lanes, "per": per,
           "plan": msv_cuda.device_plan(m_pad, 4, BATCH, 1, dev)._asdict(),
           "msv_scan": counters(msv_cuda.msv_scan_cuda),
           "msv_filter_scan": counters(msv_cuda.msv_filter_scan_cuda),
           "msv_stacked_scan": counters(msv_cuda.msv_stacked_scan_cuda), "equal": True}
    if msv_cuda.cluster_blocks(lanes) > 1:
        out["max_clusters"] = msv_cuda.max_clusters(dev.index or 0, lanes, per, False)
        out["regs_spill"] = msv_cuda.kernel_attrs(lanes, per, msv_cuda.CLUSTER_WARPS, False)
    if time_it and m_pad <= msv_cuda.MAX_CLUSTER_STATES:
        big = rng.integers(0, 20, size=(2048, 1000)).astype(np.int8)
        bstaged = scanner.stage(big, np.full(2048, 1000, dtype=np.int32))
        bm, bs = msv_cuda.init_carry(bstaged.tr_rows, m_pad)
        b_args = (emit, bstaged.tokens, bstaged.lengths, bstaged.tr_rows, consts, bm, bs)
        ms = chip_smoke.best_ms(lambda: msv_cuda.msv_scan_cuda(*b_args), reps=3)
        out["ms_2048x1000"] = ms
        out["gcups"] = 2048 * 1000 * (m_pad - 5) / ms / 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default=",".join(str(w) for w in WIDTHS))
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cluster_check: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    _, log = _build.build()
    for line in chip_smoke.ptxas_summary(log):
        if "msv_kernel" in line and "true" in line or "forward" in line:
            print(line)
    scanner = chip_smoke.MSVScanner(device=dev)
    rng = np.random.default_rng(chip_smoke.SEED)
    for m_pad in (int(w) for w in args.widths.split(",") if w):
        print(json.dumps(msv_width(rng, scanner, m_pad, args.time)), flush=True)

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
