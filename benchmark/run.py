"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up makes the cell's frame pool from the
seed, warms up the cell's own shapes and measures for ``--seconds``; the
run then checks a sample of what the timed path delivered against the plain
reference. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled part of the window; the last lines of
standard error give each number compared beside its limit. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits with 2; with a forbidden module loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Run as a script, the benchmark's own folder would shadow modules of the
# standard library: put the checkout's root in its place.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
    except harness.ForbiddenModules as e:
        print(e, file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        bound = (f"at least {c['min']}" if "min" in c
                 else f"limit {c['limit']}")
        print(f"compared {name} {c['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
