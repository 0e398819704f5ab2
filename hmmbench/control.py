"""Readings for the check's limits, on the card at a cell's own size:

    python3 hmmbench/control.py --workload <name> --seeds 1,2,3 --seconds 6 [--fast 3]

For each seed, one run of the cell with a short window: the sound
program's numbers (the lower readings) and, on the same rows, the numbers
of the reference computed in bfloat16 in the program's place (the
control). ``--fast N`` also runs the program's own lower-precision path
(its bf16 round-up MSV and Viterbi prefilters switched on) on the first
N seeds. One JSON line a seed. The benchmark's own runs run none of this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fast", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from hmmbench import harness

    cell = harness.load_cell(args.workload)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        started = STARTED if k == 0 else time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, "cuda", started, control=True)
        line = {"seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                "program": {n: out["numbers"][n] for n in out["limits"]},
                "bf16_reference": out["numbers"].get("control"), "metrics": out["metrics"]}
        if k < args.fast:
            fast = harness.run(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                               {"fast_msv": True, "fast_viterbi": True})
            line["fast_path"] = {n: fast["numbers"][n] for n in fast["limits"]}
            line["fast_path_correct"] = fast["correct"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
