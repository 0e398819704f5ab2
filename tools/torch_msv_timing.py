"""Time the PyTorch port's MSV kernels on the card, one JSON line a case.

    python3 tools/torch_msv_timing.py [--label NAME] [--warps 8,12,16,...] [--probe]

Times the exact MSV kernel at 16384 x 3500 against 1400.hmm and 2405.hmm,
the MSV filter kernel against both, and the stacked sweep over the 24
profiles of data/profile_HMMs at 8192 x 3500 in both modes, one line a
stacked launch (a kernel case of the tree under test: the profiles it
groups, their states and padded width) and one line for the whole sweep.
Each line carries the launch plan the tree picked (warps a block, grid,
dynamic shared memory; null for a tree without ``msv_cuda.device_plan``).
Residues are random from a seed, all one length; best of 3 CUDA-event
timings after one warm-up. Each line gives the card's name and power limit.

``--warps`` also times every register case of those runs at each listed
block size W (one block an SM and profile), each line with the case's
registers and spill bytes at that W. ``--probe`` runs two measurements of the card itself: the
throughput of FP32 max (FMNMX) against FP32 add (FADD) and of the MSV
cell's mix (max, add, max), from a small kernel built here with nvcc; and
a census of the exact MSV kernel's step at PER 44 (1400.hmm) in the SASS
of the built library (cuobjdump): the instructions of its innermost loop
by opcode, against the 44 x 3 + 11 = 143 a step's cells need.

The script imports the port from the first `hmm_fasta_viterbi_tpu_torch` on
sys.path, its own checkout last, so PYTHONPATH=<another checkout> times that
checkout's kernels with the same inputs: two trees compare in one call by
running it once for each, in turns. Needs one CUDA card and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys
from collections import Counter

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


def plan_of(emit: torch.Tensor, b_pad: int, **force) -> dict | None:
    """The tree's launch plan of a launch over ``emit`` ([20, M_pad] or [P,
    20, M_pad]), or None for a tree without one."""
    fn = getattr(msv_cuda, "device_plan", None)
    if fn is None:
        return None
    num_p = emit.shape[0] if emit.dim() == 3 else 1
    return fn(emit.shape[-1], emit.element_size(), b_pad, num_p, emit.device, **force)._asdict()


def attrs_of(emit: torch.Tensor, warps: int) -> dict:
    lanes, per = kernel_case(emit.shape[-1])
    regs, local = msv_cuda.kernel_attrs(lanes, per, warps, emit.dtype == torch.bfloat16)
    return {"registers": regs, "spill_bytes": local, "register_cap": msv_cuda.register_cap(warps)}


# -- the card: FP32 max against add ---------------------------------------------

PROBE_SOURCE = r"""
#include <cuda_runtime.h>
// op 0: FADD, 1: FMNMX, 2: the MSV cell (max, add, max into E); 8
// independent chains a thread, 16 unrolled rounds an iteration. Inline PTX
// keeps every instruction (no folding of repeated maxes).
template <int OP>
__global__ void __launch_bounds__(256) alu_probe(float* out, float seed, int iters) {
  float a[8], e[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = seed * (threadIdx.x + k);
    e[k] = -seed * k;
  }
  const float b = seed * 0.5f, c = seed * 0.25f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (OP == 0) {
          asm volatile("add.f32 %0, %0, %1;" : "+f"(a[k]) : "f"(b));
        } else if (OP == 1) {
          asm volatile("max.f32 %0, %0, %1;" : "+f"(a[k]) : "f"(e[(k + u) & 7]));
        } else {
          float t;
          asm volatile("max.f32 %0, %1, %2;" : "=f"(t) : "f"(a[k]), "f"(b));
          asm volatile("add.f32 %0, %1, %2;" : "=f"(a[k]) : "f"(t), "f"(c));
          asm volatile("max.f32 %0, %0, %1;" : "+f"(e[k]) : "f"(a[k]));
        }
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k] + e[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int alu_probe_launch(int op, int blocks, int iters, float* out, void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  if (op == 0) alu_probe<0><<<blocks, 256, 0, st>>>(out, 1.0f, iters);
  else if (op == 1) alu_probe<1><<<blocks, 256, 0, st>>>(out, 1.0f, iters);
  else alu_probe<2><<<blocks, 256, 0, st>>>(out, 1.0f, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
# FP32 instructions a thread an iteration of each op, as written
PROBE_OPS = {"fadd": (0, {"FADD": 128}), "fmax": (1, {"FMNMX": 128}),
             "cell": (2, {"FMNMX": 256, "FADD": 128})}
# (ptxas may issue an add.f32 as FFMA x * 1 + y: the census shows which)


def cuobjdump() -> str:
    return str(pathlib.Path(_build.find_nvcc()).parent / "cuobjdump")


def sass_functions(lib: pathlib.Path) -> dict[str, list[str]]:
    """The SASS of a library, one list of instruction lines a function."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
        elif name is not None and re.match(r"\s*(/\*[0-9a-f]{4,}\*/|\.L_x_\d+:)", line):
            funcs[name].append(line)
    return funcs


def loops(lines: list[str]) -> list[dict]:
    """Every loop of a function's SASS (a backward branch and the span up to
    it), innermost first: its length and opcodes."""
    instrs, labels, pending = [], {}, []
    for line in lines:
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update(dict.fromkeys(pending, addr))
            pending = []
            instrs.append((addr, m.group(2), m.group(3)))
    found = []
    for addr, op, rest in instrs:
        target = re.match(r"\s*(?:(0x[0-9a-f]+)|`\((\.L_x_\d+)\))", rest)
        if not op.startswith("BRA") or target is None:
            continue
        start = int(target.group(1), 16) if target.group(1) else labels.get(target.group(2), addr + 1)
        if start > addr:
            continue
        body = Counter(o.split(".")[0] for a, o, _ in instrs if start <= a <= addr)
        found.append({"length": sum(body.values()), "opcodes": dict(body)})
    return sorted(found, key=lambda loop: loop["length"])


def fp32(loop: dict) -> int:
    return sum(loop["opcodes"].get(o, 0) for o in ("FMNMX", "FADD", "FFMA"))


def step_loop(found: list[dict]) -> dict:
    """The innermost of ``found`` (:func:`loops`) that holds nearly all the
    FP32 instructions (FMNMX, FADD, FFMA) the busiest loop holds: a probe's
    loop, or the MSV kernel's step (its outer loops add a few)."""
    most = max((fp32(loop) for loop in found), default=0)
    return next((loop for loop in found if fp32(loop) >= 0.9 * most), {"length": 0, "opcodes": {}})


def probe(emit_line) -> None:
    """FP32 max against add throughput, and the census of the MSV step."""
    src_hash = hashlib.sha256(PROBE_SOURCE.encode()).hexdigest()[:16]
    out_dir = _build.BUILD_ROOT / f"alu_probe-{src_hash}"
    lib_path = out_dir / "libaluprobe.so"
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "probe.cu").write_text(PROBE_SOURCE)
        subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                        str(out_dir / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.alu_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096  # 2048 threads an SM
    out = torch.empty(blocks * 256, dtype=torch.float32, device="cuda:0")
    stream = torch.cuda.current_stream().cuda_stream
    funcs = sass_functions(lib_path)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    mhz = float(clock.split()[0]) if clock else float("nan")
    for name, (op, written) in PROBE_OPS.items():
        ms = best_ms(lambda: lib.alu_probe_launch(op, blocks, iters, out.data_ptr(), stream))
        fn = next(v for k, v in funcs.items() if f"alu_probeILi{op}E" in k)
        loop = step_loop(loops(fn))
        warp_instr = {o: blocks * 8 * iters * n for o, n in written.items()}
        rate = {o: n / (sms * mhz * 1e3 * ms) for o, n in warp_instr.items()}
        emit_line(f"probe_{name}", ms, kind="probe",
                  per_sm_cycle_at_max_clock=rate, clocks_max_sm_mhz=mhz,
                  loop=loop, written_per_iteration=written)
    for name, lines in sass_functions(_build.build()[0]).items():
        if re.search(r"msv_kernelILi44ELi32EfLi\d+E", name):
            found = [loop for loop in loops(lines) if "FMNMX" in loop["opcodes"]]
            emit_line("census_msv_44", float("nan"), kind="census", function=name,
                      step=step_loop(found), cell_instructions_per_step=44 * 3 + 11,
                      loops=found)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--warps", default="",
                    help="comma-separated block sizes to time every register case at")
    ap.add_argument("--probe", action="store_true",
                    help="FP32 max against add on the card, and the SASS census of the step")
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
    warps_list = [int(w) for w in args.warps.split(",") if w]

    def emit(kernel, ms, cells=None, **extra):
        gcups = cells / ms / 1e6 if cells else None
        print(json.dumps({"label": args.label, "kernel": kernel, "ms": ms, "gcups": gcups,
                          "card": card, **extra}), flush=True)

    def sweep_warps(kernel, fn, emit_t, b_pad, cells, **extra):
        """The case at each block size of --warps."""
        for w in warps_list:
            ms = best_ms(lambda: fn(warps=w))
            emit(f"{kernel}_w{w}", ms, cells, plan=plan_of(emit_t, b_pad, warps=w),
                 **attrs_of(emit_t, w), **extra)

    if args.probe:
        probe(emit)

    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    st = scanner.stage(tokens, np.full(BATCH, SEQ_LEN, dtype=np.int32))
    for stem, mode in (("1400", "exact"), ("2405", "exact"), ("1400", "filter"),
                       ("2405", "filter")):
        p = profs[stem]
        m_pad = msv_cuda.round_up(p.num_states, 8)
        if mode == "exact":
            emit_t, consts = msv_cuda.pack_profile(p, m_pad, device)
            cuda_fn = msv_cuda.msv_scan_cuda
        else:
            emit_t, consts = msv_cuda.pack_profile_filter(p, m_pad, device)
            cuda_fn = msv_cuda.msv_filter_scan_cuda
        m, s = msv_cuda.init_carry(st.tr_rows, m_pad)

        def run(**force):
            return cuda_fn(emit_t, st.tokens, st.lengths, st.tr_rows, consts, m, s, **force)

        ms = best_ms(run)
        cells = BATCH * SEQ_LEN * p.num_states
        shape = dict(batch=BATCH, length=SEQ_LEN, M=p.num_states, case=str(kernel_case(m_pad)))
        emit(f"msv_{mode}_{stem}", ms, cells, plan=plan_of(emit_t, BATCH), **shape)
        sweep_warps(f"msv_{mode}_{stem}", run, emit_t, BATCH, cells, **shape)
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

            def run(**force):
                return msv_cuda.msv_stacked_scan_cuda(emit_t, st.tokens, st.lengths,
                                                      st.tr_rows, consts, **force)

            ms = best_ms(run)
            mr = sum(p.num_states for p in group)
            shape = dict(batch=SWEEP_BATCH, length=SEQ_LEN, case=str(case), profiles=members,
                         sum_mr=mr, m_pad=int(emit_t.shape[2]),
                         kernel_states=len(group) * kernel_states(case))
            cells = SWEEP_BATCH * SEQ_LEN * mr
            emit(f"sweep_{mode}_group", ms, cells, plan=plan_of(emit_t, SWEEP_BATCH), **shape)
            if case[0] == 32:
                sweep_warps(f"sweep_{mode}_group", run, emit_t, SWEEP_BATCH, cells, **shape)
        ms = best_ms(lambda: [msv_cuda.msv_stacked_scan_cuda(e, st.tokens, st.lengths,
                                                             st.tr_rows, c) for e, c in packs])
        emit(f"sweep24_{mode}", ms, cells_all, batch=SWEEP_BATCH, length=SEQ_LEN,
             launches=len(packs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
