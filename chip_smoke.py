"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits nonzero without a
result line):

  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the four CUDA kernels (nvcc, sm_90a) and the host
     speckle filter (g++) from the sources in this checkout;
  3. kernels: on kitti_like_pair(seed=0) at 375x1242 with the
     kitti_sgm8_128 preset (D=128), runs each kernel and its plain torch
     version on the card, requires bit-equal results, and times both with
     CUDA events (medians);
  4. slice: build_pipeline(KITTI_SGM8_128, "cuda") serves 8 requests
     (seeds 0-3, twice), each followed by host_postprocess and
     evaluate_disparity; frame 0 must reproduce the reference package's
     hashes (stereo_tpu_torch/testdata/kitti_sgm8_128_seed0.json), the
     repeated seeds their first answers, and the launch counters must show
     K1, K3 and K4 once and K2 eight times per frame.

Prints, on the lines before the last, the card's name and power limit
and one JSON object with each kernel's launches, error and times; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stereo_tpu_torch import (  # noqa: E402
    KITTI_SGM8_128,
    build_pipeline,
    host_postprocess,
    native,
)
from stereo_tpu_torch.data import kitti_like_pair  # noqa: E402
from stereo_tpu_torch.eval import evaluate_disparity  # noqa: E402
from stereo_tpu_torch.ops import (  # noqa: E402
    census_cost_volume,
    census_transform,
    median_3x3,
    select_disparity,
    sgm_aggregate,
)
from stereo_tpu_torch.ops.cuda import (  # noqa: E402
    census_cost,
    launch_counts,
    median3x3,
    reset_launch_counts,
    sgm_paths,
    sgm_select,
)
from stereo_tpu_torch.ops.cuda.build import load_kernels  # noqa: E402
from stereo_tpu_torch.ops.cuda.launch import run  # noqa: E402
from stereo_tpu_torch.ops.sgm import PATH_STEPS  # noqa: E402

FIXTURE = ROOT / "stereo_tpu_torch" / "testdata" / "kitti_sgm8_128_seed0.json"
CFG = KITTI_SGM8_128
PLAIN = CFG.replace(backend="torch")
SEEDS = (0, 1, 2, 3, 0, 1, 2, 3)

#: name -> (source, the TPU kernel it replaces)
KERNEL_INFO = {
    "census_cost": ("stereo_tpu_torch/csrc/census_cost.cu",
                    "stereo_tpu/ops/pallas/cost_kernel.py:206"),
    "sgm_paths": ("stereo_tpu_torch/csrc/sgm_paths.cu",
                  "stereo_tpu/ops/pallas/sgm_kernel.py:399"),
    "sgm_select": ("stereo_tpu_torch/csrc/sgm_select.cu",
                   "stereo_tpu/ops/pallas/sgm_kernel.py:992"),
    "median3x3": ("stereo_tpu_torch/csrc/median3x3.cu",
                  "stereo_tpu/ops/pallas/filter_kernel.py:33"),
}
#: Per frame of the main path.
EXPECTED_LAUNCHES = {"census_cost": 1, "sgm_paths": CFG.num_paths,
                     "sgm_select": 1, "median3x3": 1}


def sha16(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device-clock ms of ``fn()`` over ``reps`` CUDA-event-timed
    calls, after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(
            f"{name}: kernel differs from its plain version "
            f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, max abs err "
            f"{max_abs_err(got, want) if got.shape == want.shape else 'n/a'})"
        )
    return max_abs_err(got, want)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's main path runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    load_kernels()
    native.load()
    print(f"build: kernels + speckle library in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    pair = kitti_like_pair(seed=0)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    cl = census_transform(left, CFG.census_window)
    cr = census_transform(right, CFG.census_window)
    one_view = cuda_ms(lambda: census_transform(left, CFG.census_window),
                       reps=10)
    print(f"census_transform (plain torch, both views): {2 * one_view:.4f} ms")
    rows = {}

    cost = census_cost(cl, cr, CFG)
    torch.cuda.synchronize()
    cost_plain = census_cost_volume(left, right, PLAIN)
    torch.cuda.synchronize()
    rows["census_cost"] = dict(
        max_abs_err=require_equal("census_cost", cost.to(torch.int32),
                                  cost_plain),
        ms=cuda_ms(lambda: census_cost(cl, cr, CFG), reps=20),
        plain_ms=cuda_ms(
            lambda: census_cost_volume(left, right, PLAIN), reps=3),
    )

    s = sgm_paths(cost, CFG)
    torch.cuda.synchronize()
    s_plain = sgm_aggregate(cost_plain, PLAIN)
    torch.cuda.synchronize()
    rows["sgm_paths"] = dict(
        max_abs_err=require_equal("sgm_paths", s.to(torch.int32), s_plain),
        ms=cuda_ms(lambda: sgm_paths(cost, CFG), reps=10),
        plain_ms=cuda_ms(lambda: sgm_aggregate(cost_plain, PLAIN), reps=2),
    )
    # One direction at a time, straight through the C entry point (these
    # launches bypass the wrapper's counter), into a scratch sum.
    h, w, d = cost.shape
    scratch = torch.empty_like(s)
    per_dir = {
        f"{dy:+d},{dx:+d}": cuda_ms(
            lambda: run("stpu_sgm_path", dev, cost.data_ptr(),
                        scratch.data_ptr(), h, w, d, dy, dx, CFG.p1, CFG.p2,
                        1), reps=10)
        for dy, dx in PATH_STEPS[: CFG.num_paths]
    }
    print("sgm_paths per direction (dy,dx) ms: " + json.dumps(per_dir))

    disp, valid = sgm_select(s, CFG)
    torch.cuda.synchronize()
    disp_plain, valid_plain = select_disparity(s_plain, PLAIN)
    torch.cuda.synchronize()
    require_equal("sgm_select valid", valid, valid_plain)
    rows["sgm_select"] = dict(
        max_abs_err=require_equal("sgm_select disp", disp, disp_plain),
        ms=cuda_ms(lambda: sgm_select(s, CFG), reps=20),
        plain_ms=cuda_ms(lambda: select_disparity(s_plain, PLAIN), reps=3),
    )

    med = median3x3(disp)
    torch.cuda.synchronize()
    med_plain = median_3x3(disp_plain)
    torch.cuda.synchronize()
    rows["median3x3"] = dict(
        max_abs_err=require_equal("median3x3", med, med_plain),
        ms=cuda_ms(lambda: median3x3(disp), reps=50),
        plain_ms=cuda_ms(lambda: median_3x3(disp_plain), reps=20),
    )

    # The plain chain on the card is the reference composition too.
    fx = json.loads(FIXTURE.read_text())
    if (sha16(med_plain), sha16(valid_plain)) != (fx["disp"], fx["valid"]):
        raise AssertionError("plain torch path on the card misses the fixture")
    for name, r in rows.items():
        print(f"kernel {name}: equal to plain; {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f} ms)")
    return rows


def phase_slice(dev) -> dict:
    """8 requests through the entry points a user calls."""
    fx = json.loads(FIXTURE.read_text())
    pairs = {seed: kitti_like_pair(seed=seed) for seed in set(SEEDS)}
    fn = build_pipeline(CFG, device=dev)
    fn(pairs[0].left, pairs[0].right)  # warm-up: caches, allocator
    torch.cuda.synchronize()

    reset_launch_counts()
    answers, device_ms, e2e_ms = {}, [], []
    for i, seed in enumerate(SEEDS):
        pair = pairs[seed]
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(pair.left, pair.right)
        end.record()
        disp, valid = host_postprocess(res.disp, res.valid, CFG)
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))

        raw = (sha16(res.disp), sha16(res.valid))
        post = (sha16(disp), sha16(valid))
        if res.disp.shape != pair.left.shape or not bool(
                torch.isfinite(res.disp).all()):
            raise AssertionError(f"frame {i}: bad disparity map")
        if seed in answers and answers[seed] != (raw, post):
            raise AssertionError(f"frame {i}: seed {seed} answered differently")
        answers[seed] = (raw, post)
        print(f"frame {i} seed {seed}: device {device_ms[-1]:.3f} ms, end to "
              f"end {e2e_ms[-1]:.3f} ms, bad3 {m['bad3']:.6f}, density "
              f"{m['density']:.6f}")
        if seed == 0:
            want = ((fx["disp"], fx["valid"]), (fx["post_disp"],
                                                 fx["post_valid"]))
            if (raw, post) != want or int(valid.sum()) != fx["post_n_valid"]:
                raise AssertionError(
                    f"frame {i}: hashes {raw} {post} != fixture {want}")
            if (m["bad3"], m["density"]) != (fx["bad3"], fx["density"]):
                raise AssertionError(f"frame {i}: metrics {m} != fixture")
    counts = launch_counts()
    want_counts = {k: v * len(SEEDS) for k, v in EXPECTED_LAUNCHES.items()}
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts} != {want_counts}")
    print(f"slice: {len(SEEDS)} frames, median device "
          f"{statistics.median(device_ms):.3f} ms, median end to end "
          f"{statistics.median(e2e_ms):.3f} ms; frame 0 matches the "
          f"reference hashes")
    return counts


def main() -> int:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    rows = phase_kernels(dev)
    counts = phase_slice(dev)
    kernels = [
        dict(name=name, route="cuda", source=KERNEL_INFO[name][0],
             replaces=KERNEL_INFO[name][1], launches=counts[name], **r)
        for name, r in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
