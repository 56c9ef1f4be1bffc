"""Where a frame's time goes on the card, for each path chip_smoke.py checks.

    python3 profile_paths.py [--frames 6] [SLICE ...]
    python3 profile_paths.py --forms
    python3 profile_paths.py --k2

Kernel forms and paths are timed here, and against their bounds by
``python -m stereo_tpu_torch.eval.roofline``; ``chip_smoke.py`` checks
them and times nothing. The stream is timed by the benchmark:
``python3 benchmark/run.py --workload kitti-stream-b48 --trace 1`` gives
its device ops, idle gaps and spans on host frames.

For each named slice of ``chip_smoke.SLICES`` (all by default, the exact
mode's paths such as ``kitti_sgm8_128_exact_2x2`` and
``kitti_sgm8_128_exact_2x2_dplane`` included; config and model come from
the slice's fixture file, as there) the model serves a few frames with the
images already on the card and no synchronisation between frames, under
``torch.profiler``; the script prints one JSON line per slice with the wall
time, the device's busy time and idle share, and the device time by kernel
(the port's CUDA kernels by name, everything else as plain torch, its six
largest launches by name in ``plain_top``), all per frame. For a pyramid
slice it also times the model's stages one by one with CUDA events
(medians). Needs a CUDA card; prints its name and power limit first.

``--forms`` instead profiles K5 and K4 alone, each in a train of launches
through its wrapper, at the shapes the paths give them (and K5 at
375x1242x128, the SAD form of kitti_sgm8_128, which no path runs): one
JSON line per form with the kernel's device time per launch and any other
device time the call spends (plain torch launches around the kernel;
``eval.roofline.profiled_ms``).

``--k2`` profiles K2 alone the same way, eight directions per call on
random costs: its whole-frame form at KITTI size (fixed and adaptive P2,
375x1242x128), at config 4's (1988x2880x256, fixed and adaptive) and at
1988x2880x128; at each of them the six directions other than the
horizontals as six single launches and, where the checkout has them, as
the two sweep groups (both straight through K2's C entry, adding into a
scratch S, whatever the launch plan would choose for the shape); the two
horizontals
alone (``steps``; one launch where the checkout pairs them) and each
horizontal alone, and, where the checkout's ``sgm_paths`` takes a
rectangle, its rectangle form at the same shapes
(a tile's in-frame rectangle, 20 rows and 276 columns in from each edge),
and where it takes a shear, the down-right diagonals two ways: the whole
form's two directions and the sheared form's two verticals of the whole
sheared volume. Each row gives the device ms per call and the launches
per call.
It also runs against an older checkout (copy it there), whose K2 has the
whole-frame form only: the two checkouts' whole forms compare in one call.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time

import torch

from chip_smoke import (
    QUALITY_P2,
    SAD,
    SADSGM,
    SLICES,
    cfg4_pair,
    load_slice,
    phase_device,
    to_dev,
    tsukuba_pair,
)
from stereo_tpu_torch import KITTI_SGM8_128, KITTI_SGM8_128_QUALITY
from stereo_tpu_torch.config import MIDDLEBURY_FULL_256_TILED
from stereo_tpu_torch.data import kitti_like_pair, make_pair
from stereo_tpu_torch.eval.hard_suite import SCENARIOS
from stereo_tpu_torch.eval.roofline import cuda_ms, profiled_ms
from stereo_tpu_torch.models.pyramid import (
    PyramidSGM,
    _local_minmax_center,
    _pool2,
    _residual_cost_volume,
    _upsample2,
)
from stereo_tpu_torch.ops import census_transform
from stereo_tpu_torch.ops.cuda import (
    launch_counts,
    median3x3,
    reset_launch_counts,
    sad_cost,
    sgm_paths,
    sgm_select,
)
from stereo_tpu_torch.ops.cuda.build import KERNEL_SIGNATURES
from stereo_tpu_torch.ops.cuda.launch import run
from stereo_tpu_torch.ops.sgm import PATH_STEPS
from stereo_tpu_torch.pipeline import compute_disparity

#: Substrings of the port's kernel names, as the profiler reports them.
KERNELS = ("census_transform_kernel", "census_cost_kernel",
           "sad_cost_kernel", "sgm_path_kernel", "sgm_select_kernel",
           "median3x3_kernel")
WARMUP = 3


def profiled(run, frames: int) -> dict:
    """``run()`` (``frames`` frames, ending in a wait for the card) under
    the profiler: wall and device time per frame, by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = dict.fromkeys((*KERNELS, "plain torch"), 0.0)
    plain = {}
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        key = next((k for k in KERNELS if k in ev.key), "plain torch")
        by_kernel[key] += us / 1e3
        if key == "plain torch":
            plain[ev.key[:60]] = plain.get(ev.key[:60], 0.0) + us / 1e3
        launches += ev.count
    busy_ms = sum(by_kernel.values())
    if busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    return {
        "frames": frames, "wall_ms": wall_ms / frames,
        "device_busy_ms": busy_ms / frames,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches": launches / frames,
        "device_ms": {k: v / frames for k, v in by_kernel.items()},
        "plain_top": {k: v / frames for k, v in sorted(
            plain.items(), key=lambda kv: -kv[1])[:6]},
    }


def profile_slice(sl, frames: int, dev: torch.device) -> dict:
    _, _, model = load_slice(sl)
    fn = model.build(dev)
    left, right = to_dev(sl.pair(0), dev)
    for _ in range(WARMUP):
        fn(left, right)
    torch.cuda.synchronize()

    def run():
        for _ in range(frames):
            fn(left, right)
        torch.cuda.synchronize()

    return {"slice": sl.name, "model": model.name,
            "shape": list(left.shape), **profiled(run, frames)}


def pyramid_stages(sl, dev: torch.device) -> dict:
    """The pyramid model's stages on the slice's pair, each timed alone (ms,
    CUDA-event medians): the same calls ``PyramidSGM`` makes."""
    _, _, model = load_slice(sl)
    cfg, r = model.cfg, model.residual_range
    left, right = to_dev(sl.pair(0), dev)
    h, w = left.shape
    coarse_cfg = model.coarse_cfg()
    pl, pr = _pool2(left), _pool2(right)
    res_c = compute_disparity(pl, pr, coarse_cfg)
    up = _upsample2(res_c.disp, h, w)
    cl = census_transform(left, cfg.census_window)
    cr = census_transform(right, cfg.census_window)
    base, vol, res_cfg = model.residual_volume(left, right)
    base_i = torch.round(base).to(torch.int32)
    vol8 = vol.to(res_cfg.cost_volume_dtype)
    s = sgm_paths(vol8, res_cfg, image=left)
    disp_r, _ = sgm_select(s, res_cfg)
    frame = model.build(dev)
    stages = {
        "pool2 x2": lambda: (_pool2(left), _pool2(right)),
        "coarse pass (K1, K2 x8, K3, K4 at half size, D/2)":
            lambda: compute_disparity(pl, pr, coarse_cfg),
        "upsample + min/max centre": lambda: _local_minmax_center(up),
        "census transform x2 (K1's transform stage)":
            lambda: (census_transform(left, cfg.census_window),
                     census_transform(right, cfg.census_window)),
        "gather volume":
            lambda: _residual_cost_volume(cl, cr, base_i, r // 2, r),
        "coarse pass to masked volume (residual_volume)":
            lambda: model.residual_volume(left, right),
        f"K2 x8 at D={r}": lambda: sgm_paths(vol8, res_cfg, image=left),
        f"K3 md={-(r // 2)}": lambda: sgm_select(s, res_cfg),
        "K4": lambda: median3x3(disp_r),
        "whole frame": lambda: frame(left, right),
    }
    return {"slice": sl.fixture, "census_window": list(cfg.census_window),
            **{name: cuda_ms(fn, reps=10) for name, fn in stages.items()}}


def kernel_forms(dev: torch.device, reps: int = 50) -> list:
    """K5 and K4 alone, ``reps`` calls through the wrapper under the
    profiler after a warm-up; per call, the kernel's device time and the
    device time of anything else the call launched."""
    tsukuba = tsukuba_pair(0)
    tl, tr = to_dev(tsukuba, dev)
    tmap = torch.from_numpy(tsukuba.gt_disp).to(dev)
    hl, hr = to_dev(make_pair((160, 288), max_disp=96, seed=0,
                              **SCENARIOS["radiometric"]), dev)
    kitti = kitti_like_pair(seed=0)
    kl, kr = to_dev(kitti, dev)
    kmap = torch.from_numpy(kitti.gt_disp).to(dev)
    cmap = torch.from_numpy(cfg4_pair((1988, 2880))(0).gt_disp).to(dev)
    forms = {
        "sad_cost 288x384x16 (tsukuba_sad16)":
            ("sad_cost_kernel", lambda: sad_cost(tl, tr, SAD)),
        "sad_cost 160x288x128 (census_vs_sad)":
            ("sad_cost_kernel", lambda: sad_cost(hl, hr, SADSGM)),
        "sad_cost 375x1242x128 (kitti_sgm8_128, cost_fn=sad)":
            ("sad_cost_kernel", lambda: sad_cost(kl, kr, SADSGM)),
        "median3x3 288x384 (tsukuba_sad16)":
            ("median3x3_kernel", lambda: median3x3(tmap)),
        "median3x3 375x1242": ("median3x3_kernel", lambda: median3x3(kmap)),
        "median3x3 1988x2880": ("median3x3_kernel", lambda: median3x3(cmap)),
    }
    rows = []
    for name, (kernel, fn) in forms.items():
        got = profiled_ms(fn, kernel, reps=reps)
        if got is None:
            raise RuntimeError(f"{name}: the profiler recorded no launch "
                               f"of {kernel}")
        rows.append({"form": name, "calls": reps, "kernel_device_ms": got[0],
                     "other_device_ms": got[1], "other_launches": got[2]})
    return rows


def k2_forms(dev: torch.device, reps: int = 10) -> list:
    """K2's whole-frame form, its six other directions as single launches
    and as the two sweep groups where this checkout has them, its
    horizontals (both, and each alone), and its rectangle form where this
    checkout has one, at KITTI and config-4 sizes: device ms per call
    (``profiled_ms``, per launch times the launches of a call). Where the
    checkout has the sheared form, also the
    two down-right diagonals of the whole form and the sheared form's two
    verticals of the whole sheared volume [H, W + H - 1, D] (the same
    scans)."""

    def row(form, call):
        reset_launch_counts()
        call()
        launches = launch_counts()["sgm_paths"]
        got = profiled_ms(call, "sgm_path_kernel", reps=reps)
        if got is None:
            raise RuntimeError(f"{form}: the profiler recorded no K2 launch")
        return {"form": form, "calls": reps, "launches_per_call": launches,
                "kernel_device_ms_per_call": got[0] * launches,
                "other_device_ms": got[1]}

    # the checkout's C entry takes a sweep group's work (step +-2, 0)
    groups = len(KERNEL_SIGNATURES["stpu_sgm_path"]) == 26
    if groups:
        from stereo_tpu_torch.ops.cuda.sgm_kernel import _group_work

    def entry_row(form, steps, cost, image, cfg):
        # K2's C entry straight, each step one launch into a scratch S it
        # adds into (these launches bypass the wrapper's counter)
        h, w, d = cost.shape
        scratch = torch.zeros((h, w, d), dtype=torch.int16, device=dev)
        img = image.to(torch.int32) if cfg.adaptive_p2 else None

        def call():
            for dy, dx in steps:
                work = (None, None)
                if abs(dy) == 2:
                    work = tuple(t.data_ptr() for t in _group_work(
                        dev, h, w, d))
                run("stpu_sgm_path", dev, cost.data_ptr(), 1,
                    None if img is None else img.data_ptr(),
                    scratch.data_ptr(), h, w, d, dy, dx, cfg.p1, cfg.p2,
                    cfg.p2_min, cfg.adaptive_grad_floor, 1, 0, 0, h, 0, w, 0,
                    0, 0, None, *work[:2 * groups])

        got = profiled_ms(call, "sgm_path_kernel", reps=reps)
        if got is None:
            raise RuntimeError(f"{form}: the profiler recorded no K2 launch")
        return {"form": form, "calls": reps, "launches_per_call": len(steps),
                "kernel_device_ms_per_call": got[0] * len(steps),
                "other_device_ms": got[1]}

    gen = torch.Generator(device=dev).manual_seed(0)
    params = inspect.signature(sgm_paths).parameters
    rect, shear, subset = ("rect" in params, "shear" in params,
                           "steps" in params)
    rows = []
    for name, cfg, shape in (
            ("kitti 375x1242x128", KITTI_SGM8_128, (375, 1242, 128)),
            ("kitti adaptive 375x1242x128", KITTI_SGM8_128_QUALITY,
             (375, 1242, 128)),
            ("config 4 1988x2880x256", MIDDLEBURY_FULL_256_TILED,
             (1988, 2880, 256)),
            ("config 4 adaptive 1988x2880x256",
             MIDDLEBURY_FULL_256_TILED.replace(**QUALITY_P2),
             (1988, 2880, 256)),
            ("1988x2880x128", KITTI_SGM8_128, (1988, 2880, 128))):
        h, w, _ = shape
        cost = torch.randint(0, 64, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
        image = torch.randint(0, 256, (h, w), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        rows.append(entry_row(f"six single directions {name}",
                              PATH_STEPS[2:8], cost, image, cfg))
        if groups:
            rows.append(entry_row(f"sweep groups {name}", ((2, 0), (-2, 0)),
                                  cost, image, cfg))
        forms = {"whole": {}}
        if subset:
            forms.update({"horizontals": {"steps": ((0, 1), (0, -1))},
                          "horizontal (0,+1)": {"steps": ((0, 1),)},
                          "horizontal (0,-1)": {"steps": ((0, -1),)}})
        if rect:
            forms["rect"] = {"rect": (20, h - 20, 276, w - 276)}
        for form, kw in forms.items():
            rows.append(row(f"sgm_paths {form} {name}",
                            lambda: sgm_paths(cost, cfg, image=image, **kw)))
        if shear:
            from stereo_tpu_torch.ops.sgm import V_STEPS, shear_window

            sheared = shear_window(cost, 0, h, 1, 0, w + h - 1)
            image_sh = shear_window(image, 0, h, 1, 0, w + h - 1)
            for form, call in (
                    ("diagonals+1", lambda: sgm_paths(
                        cost, cfg, image=image, steps=PATH_STEPS[4:6])),
                    ("shear+1", lambda: sgm_paths(
                        sheared, cfg, image=image_sh, steps=V_STEPS,
                        shear=(1, 0, w)))):
                rows.append(row(f"sgm_paths {form} {name}", call))
            del sheared, image_sh
        del cost, image
    return rows


def main(argv=None) -> int:
    by_name = {sl.name: sl for sl in SLICES}
    ap = argparse.ArgumentParser(prog="profile_paths.py")
    ap.add_argument("slices", nargs="*", default=list(by_name),
                    help=f"slices to profile, of {sorted(by_name)}")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--forms", action="store_true",
                    help="profile K5 and K4 alone instead of the slices")
    ap.add_argument("--k2", action="store_true",
                    help="profile K2's forms alone instead of the slices")
    args = ap.parse_args(argv)
    phase_device()
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    if args.forms or args.k2:
        for row in (kernel_forms if args.forms else k2_forms)(dev):
            print(json.dumps(row))
        return 0
    for name in args.slices:
        sl = by_name[name]
        print(json.dumps(profile_slice(sl, args.frames, dev)))
        if isinstance(load_slice(sl)[2], PyramidSGM):
            print(json.dumps({"pyramid_stages": pyramid_stages(sl, dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
