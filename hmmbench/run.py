"""Run one cell of the benchmark of ``hmm_fasta_viterbi_tpu_torch``:

    python3 hmmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the check's numbers beside their
limits on standard error and, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``check``. Exits
non-zero without a result when no CUDA card is visible, when the
program loaded JAX or the JAX package, or when the program is missing.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the top-level module names the process must not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "hmm_fasta_viterbi_tpu")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        import hmm_fasta_viterbi_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"hmmbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("hmmbench: no CUDA card is visible (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from hmmbench import harness

    cell = harness.load_cell(args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"hmmbench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    numbers, limits = out.pop("numbers"), out.pop("limits")
    for name, value in numbers.items():
        print(f"check {name} = {value!r} (limit {limits[name]!r})", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
