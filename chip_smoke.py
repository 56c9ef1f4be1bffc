"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits nonzero without a
result line):

  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the five CUDA kernels (nvcc, sm_90a, one compiler per
     source, all at once) and the host speckle filter (g++) from the
     sources in this checkout;
  3. kernels: runs each kernel form and its plain torch version on the card
     at the shapes its path gives it, requires bit-equal results, and
     times both with CUDA events (medians):
       - K1 census_cost, K2 sgm_paths (fixed P2), K3 sgm_select and K4
         median3x3 on kitti_like_pair(seed=0) at 375x1242 with the
         kitti_sgm8_128 preset (D=128);
       - K2 with adaptive P2 on the same pair with kitti_sgm8_128_quality;
       - K3's integer-winner form (emit_d0, the exact LR check's left
         view) at 375x1242x128;
       - K5 sad_cost and K3 at D=16 on the tsukuba_sad16 pair (288x384);
  4. slices: each path serves a few requests through build_pipeline(cfg,
     "cuda"), host_postprocess and evaluate_disparity, with the launch
     counters set to 0 just before and read just after: kitti_sgm8_128
     (K1 1, K2 8, K3 1, K4 1 per frame), kitti_sgm8_128_quality (the same),
     kitti_sgm8_128 with lr_exact (K1 2, K2 16, K3 2, K4 1) and
     tsukuba_sad16 (K5 1, K3 1, K4 1). Frame 0 of each must reproduce the
     reference package's hashes (stereo_tpu_torch/testdata/*_seed0.json)
     and the repeated seeds their first answers.

Prints, on the lines before the last, the card's name and power limit
and one JSON object with each kernel form's launches (its wrapper's count
summed over the slices that run that form), error and times; the last
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
from typing import Callable, Dict, NamedTuple, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stereo_tpu_torch import (  # noqa: E402
    KITTI_SGM8_128,
    KITTI_SGM8_128_QUALITY,
    PRESETS,
    TSUKUBA_SAD16,
    build_pipeline,
    host_postprocess,
    native,
)
from stereo_tpu_torch.data import kitti_like_pair, make_pair  # noqa: E402
from stereo_tpu_torch.eval import evaluate_disparity  # noqa: E402
from stereo_tpu_torch.ops import (  # noqa: E402
    adaptive_p2_map,
    census_cost_volume,
    census_transform,
    median_3x3,
    sad_cost_volume,
    select_disparity,
    sgm_aggregate,
)
from stereo_tpu_torch.ops.cuda import (  # noqa: E402
    census_cost,
    launch_counts,
    median3x3,
    reset_launch_counts,
    sad_cost,
    sgm_paths,
    sgm_select,
)
from stereo_tpu_torch.ops.cuda.build import load_kernels  # noqa: E402
from stereo_tpu_torch.ops.cuda.launch import run  # noqa: E402
from stereo_tpu_torch.ops.sgm import PATH_STEPS  # noqa: E402

TESTDATA = ROOT / "stereo_tpu_torch" / "testdata"
CFG = KITTI_SGM8_128
PLAIN = CFG.replace(backend="torch")
QCFG = KITTI_SGM8_128_QUALITY
LRCFG = CFG.replace(lr_exact=True)
SAD = TSUKUBA_SAD16

_PALLAS = "stereo_tpu/ops/pallas/"
#: kernel form -> (wrapper, source, the TPU kernel it replaces)
KERNEL_INFO = {
    "census_cost": ("census_cost", "stereo_tpu_torch/csrc/census_cost.cu",
                    _PALLAS + "cost_kernel.py:206"),
    "sad_cost": ("sad_cost", "stereo_tpu_torch/csrc/sad_cost.cu",
                 _PALLAS + "cost_kernel.py:584"),
    "sgm_paths": ("sgm_paths", "stereo_tpu_torch/csrc/sgm_paths.cu",
                  _PALLAS + "sgm_kernel.py:399"),
    "sgm_paths/adaptive": ("sgm_paths", "stereo_tpu_torch/csrc/sgm_paths.cu",
                           _PALLAS + "sgm_kernel.py:399"),
    "sgm_select": ("sgm_select", "stereo_tpu_torch/csrc/sgm_select.cu",
                   _PALLAS + "sgm_kernel.py:992"),
    "sgm_select/d0": ("sgm_select", "stereo_tpu_torch/csrc/sgm_select.cu",
                      _PALLAS + "sgm_kernel.py:1224"),
    "sgm_select/d16": ("sgm_select", "stereo_tpu_torch/csrc/sgm_select.cu",
                       _PALLAS + "sgm_kernel.py:992"),
    "median3x3": ("median3x3", "stereo_tpu_torch/csrc/median3x3.cu",
                  _PALLAS + "filter_kernel.py:33"),
}


def tsukuba_pair(seed: int):
    """The tsukuba_sad16 fixture's pair family (the reference's bench)."""
    return make_pair((288, 384), max_disp=14, kind="shapes", texture="cloud",
                     seed=seed)


class Slice(NamedTuple):
    fixture: str                      # testdata/<fixture>_seed0.json
    pair: Callable[[int], object]     # seed -> StereoPair
    seeds: Tuple[int, ...]
    launches: Dict[str, int]          # per frame
    forms: Tuple[str, ...]            # KERNEL_INFO rows this path runs


SLICES = (
    Slice("kitti_sgm8_128", kitti_like_pair, (0, 1, 2, 3, 0, 1, 2, 3),
          dict(census_cost=1, sgm_paths=8, sgm_select=1, median3x3=1),
          ("census_cost", "sgm_paths", "sgm_select", "median3x3")),
    Slice("kitti_sgm8_128_quality", kitti_like_pair, (0, 1, 0, 1),
          dict(census_cost=1, sgm_paths=8, sgm_select=1, median3x3=1),
          ("census_cost", "sgm_paths/adaptive", "sgm_select", "median3x3")),
    Slice("kitti_sgm8_128_lr_exact", kitti_like_pair, (0, 1, 0, 1),
          dict(census_cost=2, sgm_paths=16, sgm_select=2, median3x3=1),
          ("census_cost", "sgm_paths", "sgm_select/d0", "median3x3")),
    Slice("tsukuba_sad16", tsukuba_pair, (0, 1, 2, 3, 0, 1, 2, 3),
          dict(sad_cost=1, sgm_select=1, median3x3=1),
          ("sad_cost", "sgm_select/d16", "median3x3")),
)


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


def synced(fn):
    """``fn()``, then wait for the card, so a fault shows where it ran."""
    out = fn()
    torch.cuda.synchronize()
    return out


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


def per_direction_ms(dev, cost, scratch, image_ptr, cfg) -> Dict[str, float]:
    """One K2 direction at a time, straight through the C entry point
    (these launches bypass the wrapper's counter), into a scratch sum."""
    h, w, d = cost.shape
    return {
        f"{dy:+d},{dx:+d}": cuda_ms(
            lambda: run("stpu_sgm_path", dev, cost.data_ptr(), image_ptr,
                        scratch.data_ptr(), h, w, d, dy, dx, cfg.p1, cfg.p2,
                        cfg.p2_min, cfg.adaptive_grad_floor, 1), reps=10)
        for dy, dx in PATH_STEPS[: cfg.num_paths]
    }


def phase_kernels(dev) -> dict:
    """Each kernel form against its plain version at its path's shapes."""
    pair = kitti_like_pair(seed=0)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    cl = census_transform(left, CFG.census_window)
    cr = census_transform(right, CFG.census_window)
    one_view = cuda_ms(lambda: census_transform(left, CFG.census_window),
                       reps=10)
    print(f"census_transform (plain torch, both views): {2 * one_view:.4f} ms")
    rows = {}

    cost = synced(lambda: census_cost(cl, cr, CFG))
    cost_plain = synced(lambda: census_cost_volume(left, right, PLAIN))
    rows["census_cost"] = dict(
        max_abs_err=require_equal("census_cost", cost.to(torch.int32),
                                  cost_plain),
        ms=cuda_ms(lambda: census_cost(cl, cr, CFG), reps=20),
        plain_ms=cuda_ms(
            lambda: census_cost_volume(left, right, PLAIN), reps=3),
    )

    s = synced(lambda: sgm_paths(cost, CFG))
    s_plain = synced(lambda: sgm_aggregate(cost_plain, PLAIN))
    rows["sgm_paths"] = dict(
        max_abs_err=require_equal("sgm_paths", s.to(torch.int32), s_plain),
        ms=cuda_ms(lambda: sgm_paths(cost, CFG), reps=10),
        plain_ms=cuda_ms(lambda: sgm_aggregate(cost_plain, PLAIN), reps=2),
    )
    scratch = torch.empty_like(s)
    print("sgm_paths per direction (dy,dx) ms: " + json.dumps(
        per_direction_ms(dev, cost, scratch, None, CFG)))

    # K2 adaptive: the quality preset has the same census and D as CFG, so
    # the cost volume above is its cost volume.
    qplain = QCFG.replace(backend="torch")
    s_q = synced(lambda: sgm_paths(cost, QCFG, image=left))
    s_q_plain = synced(lambda: sgm_aggregate(cost_plain, qplain, image=left))
    rows["sgm_paths/adaptive"] = dict(
        max_abs_err=require_equal("sgm_paths adaptive", s_q.to(torch.int32),
                                  s_q_plain),
        ms=cuda_ms(lambda: sgm_paths(cost, QCFG, image=left), reps=10),
        plain_ms=cuda_ms(lambda: sgm_aggregate(cost_plain, qplain,
                                               image=left), reps=2),
    )
    img32 = left.to(torch.int32)
    print("sgm_paths adaptive per direction (dy,dx) ms: " + json.dumps(
        per_direction_ms(dev, cost, scratch, img32.data_ptr(), QCFG)))
    # The TPU's alternative: eight [H, W] P2 maps precomputed outside the
    # kernel (plain torch here), which the in-kernel division replaces.
    maps_ms = cuda_ms(lambda: [adaptive_p2_map(left, QCFG, -dy, -dx)
                               for dy, dx in PATH_STEPS], reps=10)
    print(f"adaptive P2 as 8 precomputed maps (plain torch): {maps_ms:.4f} ms")

    disp, valid = synced(lambda: sgm_select(s, CFG))
    disp_plain, valid_plain = synced(lambda: select_disparity(s_plain, PLAIN))
    require_equal("sgm_select valid", valid, valid_plain)
    rows["sgm_select"] = dict(
        max_abs_err=require_equal("sgm_select disp", disp, disp_plain),
        ms=cuda_ms(lambda: sgm_select(s, CFG), reps=20),
        plain_ms=cuda_ms(lambda: select_disparity(s_plain, PLAIN), reps=3),
    )

    lrplain = LRCFG.replace(backend="torch")
    got = synced(lambda: sgm_select(s, LRCFG, emit_d0=True))
    want = synced(lambda: select_disparity(s_plain, lrplain, emit_d0=True))
    require_equal("sgm_select d0 valid", got[1], want[1])
    require_equal("sgm_select d0 disp", got[0], want[0])
    rows["sgm_select/d0"] = dict(
        max_abs_err=require_equal("sgm_select d0", got[2], want[2]),
        ms=cuda_ms(lambda: sgm_select(s, LRCFG, emit_d0=True), reps=20),
        plain_ms=cuda_ms(lambda: select_disparity(s_plain, lrplain,
                                                  emit_d0=True), reps=3),
    )

    med = synced(lambda: median3x3(disp))
    med_plain = synced(lambda: median_3x3(disp_plain))
    rows["median3x3"] = dict(
        max_abs_err=require_equal("median3x3", med, med_plain),
        ms=cuda_ms(lambda: median3x3(disp), reps=50),
        plain_ms=cuda_ms(lambda: median_3x3(disp_plain), reps=20),
    )

    # The plain chain on the card is the reference composition too.
    fx = json.loads((TESTDATA / "kitti_sgm8_128_seed0.json").read_text())
    if (sha16(med_plain), sha16(valid_plain)) != (fx["disp"], fx["valid"]):
        raise AssertionError("plain torch path on the card misses the fixture")

    # tsukuba_sad16: K5, then K3 at D=16 on the raw SAD cost (num_paths=0).
    tp = tsukuba_pair(0)
    tl = torch.from_numpy(tp.left).to(dev)
    tr = torch.from_numpy(tp.right).to(dev)
    splain = SAD.replace(backend="torch")
    sad = synced(lambda: sad_cost(tl, tr, SAD))
    sad_plain = synced(lambda: sad_cost_volume(tl, tr, splain))
    rows["sad_cost"] = dict(
        max_abs_err=require_equal("sad_cost", sad.to(torch.int32), sad_plain),
        ms=cuda_ms(lambda: sad_cost(tl, tr, SAD), reps=20),
        plain_ms=cuda_ms(lambda: sad_cost_volume(tl, tr, splain), reps=5),
    )
    d16, v16 = synced(lambda: sgm_select(sad, SAD))
    d16_plain, v16_plain = synced(lambda: select_disparity(sad_plain, splain))
    require_equal("sgm_select d16 valid", v16, v16_plain)
    rows["sgm_select/d16"] = dict(
        max_abs_err=require_equal("sgm_select d16 disp", d16, d16_plain),
        ms=cuda_ms(lambda: sgm_select(sad, SAD), reps=20),
        plain_ms=cuda_ms(lambda: select_disparity(sad_plain, splain), reps=5),
    )

    for name, r in rows.items():
        print(f"kernel {name}: equal to plain; {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f} ms)")
    return rows


def run_slice(dev, sl: Slice) -> Dict[str, int]:
    """The slice's requests through the entry points a user calls; returns
    the launch counts of that run alone."""
    fx = json.loads((TESTDATA / f"{sl.fixture}_seed0.json").read_text())
    cfg = PRESETS[fx["preset"]].replace(**fx.get("overrides", {}))
    pairs = {seed: sl.pair(seed) for seed in set(sl.seeds)}
    fn = build_pipeline(cfg, device=dev)
    fn(pairs[0].left, pairs[0].right)  # warm-up: caches, allocator
    torch.cuda.synchronize()

    reset_launch_counts()
    answers, device_ms, e2e_ms = {}, [], []
    for i, seed in enumerate(sl.seeds):
        pair = pairs[seed]
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(pair.left, pair.right)
        end.record()
        disp, valid = host_postprocess(res.disp, res.valid, cfg)
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))

        raw = (sha16(res.disp), sha16(res.valid))
        post = (sha16(disp), sha16(valid))
        if res.disp.shape != pair.left.shape or not bool(
                torch.isfinite(res.disp).all()):
            raise AssertionError(f"{sl.fixture} frame {i}: bad disparity map")
        if seed in answers and answers[seed] != (raw, post):
            raise AssertionError(
                f"{sl.fixture} frame {i}: seed {seed} answered differently")
        answers[seed] = (raw, post)
        print(f"{sl.fixture} frame {i} seed {seed}: device "
              f"{device_ms[-1]:.3f} ms, end to end {e2e_ms[-1]:.3f} ms, bad3 "
              f"{m['bad3']:.6f}, density {m['density']:.6f}")
        if seed == 0:
            want = ((fx["disp"], fx["valid"]), (fx["post_disp"],
                                                 fx["post_valid"]))
            if (raw, post) != want or int(valid.sum()) != fx["post_n_valid"]:
                raise AssertionError(f"{sl.fixture} frame {i}: hashes {raw} "
                                     f"{post} != fixture {want}")
            if (m["bad3"], m["density"]) != (fx["bad3"], fx["density"]):
                raise AssertionError(
                    f"{sl.fixture} frame {i}: metrics {m} != fixture")
    counts = launch_counts()
    want_counts = dict.fromkeys(counts, 0)
    want_counts.update(
        {k: v * len(sl.seeds) for k, v in sl.launches.items()})
    if counts != want_counts:
        raise AssertionError(
            f"{sl.fixture}: launch counts {counts} != {want_counts}")
    print(f"slice {sl.fixture}: {len(sl.seeds)} frames, median device "
          f"{statistics.median(device_ms):.3f} ms, median end to end "
          f"{statistics.median(e2e_ms):.3f} ms; frame 0 matches the "
          f"reference hashes; launches {counts}")
    return counts


def main() -> int:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    rows = phase_kernels(dev)
    launches = dict.fromkeys(KERNEL_INFO, 0)
    for sl in SLICES:
        counts = run_slice(dev, sl)
        for form in sl.forms:
            launches[form] += counts[KERNEL_INFO[form][0]]
    missing = [form for form, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"no main path launched {missing}")
    kernels = [
        dict(name=form, route="cuda", source=KERNEL_INFO[form][1],
             replaces=KERNEL_INFO[form][2], launches=launches[form],
             **rows[form])
        for form in KERNEL_INFO
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
