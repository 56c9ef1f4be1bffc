"""The control of a cell's comparison: the plain reference put in the engine's
place, its float steps computed in bfloat16, the precision below the float32
that the configuration states. The comparison has to reject it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

For each seed it makes the cell's frame pool and the run's sample of pool
pairs as a run does, computes the control's output for each sampled pair
(through the host filters where the cell's entry applies them), offers it in
every slot of a batch, and compares it with the float32 reference exactly as
a run compares the engine's frames.
One JSON line per seed: each number compared beside its limit, and whether
the run would have called it correct. The benchmark's own runs do not run
it.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.frames import make_pool  # noqa: E402


def control_readings(cell, seed: int, device) -> dict:
    """The compared numbers of the control on ``seed``'s sample."""
    import importlib

    ref = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    t = cell.traffic
    stereo = cell.config["stereo"]
    left, right = make_pool(t["pool"], tuple(cell.config["image_shape"]),
                            cell.config["scene"]["max_disp"], seed, device)
    sample = harness.Sample(t["pool"], t["check_pool_pairs"],
                            t["check_frames"], t.get("batch", 1),
                            np.random.default_rng([seed, 1]))
    host_post = harness.entry(t).HOST_POST
    pairs = sorted(sample.pairs)
    out = {}
    for pair in pairs:
        disp, valid = ref.compute_disparity(left[pair], right[pair], stereo,
                                            device, precision="bfloat16")
        if host_post:
            disp, valid = ref.host_postprocess(disp, valid, stereo)
        out[pair] = disp, valid
    for slot in range(max(sample.slots, len(pairs))):
        pair = pairs[slot % len(pairs)]
        sample.offer(slot, pair, *out[pair], slot=slot % sample.slots)
    compared = harness.check(cell, left, right, sample, host_post, device)
    return {"workload": cell.name, "seed": seed,
            "correct": harness.within(compared), "compared": compared}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control_readings(cell, seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
