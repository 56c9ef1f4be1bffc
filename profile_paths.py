"""Where a frame's time goes on the card, for each path chip_smoke.py drives.

    python3 profile_paths.py [--frames 6] [SLICE ...]
    python3 profile_paths.py --forms
    python3 profile_paths.py --k2

For each named slice of ``chip_smoke.SLICES`` (all by default; config and
model come from the slice's fixture file, as there) the model serves a few
frames with the images already on the card and no synchronisation between
frames, under ``torch.profiler``; the script prints one JSON line per slice
with the wall time, the device's busy time and idle share, and the device
time by kernel (the port's CUDA kernels by name, everything else as plain
torch), all per frame. For a pyramid slice it also times the model's
stages one by one with CUDA events (medians). The name
``kitti_stream_batch48`` (last by default) is the batched stream: one
48-frame batch of ``chip_smoke.py``'s stream frames, on the card, through
``StreamRunner.run_batches`` after a warm-up batch, profiled the same way
(the wall time ends with the runner's wait on the batch's event). Needs a
CUDA card; prints its name and power limit first.

``--forms`` instead profiles K5 and K4 alone, each in a train of launches
through its wrapper, at the shapes the paths give them (and K5 at
375x1242x128, the SAD form of kitti_sgm8_128, which no path runs): one
JSON line per form with the kernel's device time per launch and any other
device time the call spends (plain torch launches around the kernel;
``eval.roofline.profiled_ms``).

``--k2`` profiles K2 alone the same way, eight directions per call on
random costs: its whole-frame form at KITTI size (fixed and adaptive P2,
375x1242x128) and at config 4's (1988x2880x256), and, where the checkout's
``sgm_paths`` takes a rectangle, its rectangle form at the same shapes
(a tile's in-frame rectangle, 20 rows and 276 columns in from each edge).
It also runs against an older checkout (copy it there), whose K2 has the
whole-frame form only: the two checkouts' whole forms compare in one call.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

import numpy as np
import torch

from chip_smoke import (
    CFG,
    SAD,
    SADSGM,
    SLICES,
    STREAM_SHAPE,
    cfg4_pair,
    cuda_ms,
    load_slice,
    phase_device,
    stream_pair,
    to_dev,
    tsukuba_pair,
)
from stereo_tpu_torch import KITTI_SGM8_128, KITTI_SGM8_128_QUALITY
from stereo_tpu_torch.config import MIDDLEBURY_FULL_256_TILED
from stereo_tpu_torch.data import kitti_like_pair, make_pair
from stereo_tpu_torch.eval.hard_suite import SCENARIOS
from stereo_tpu_torch.eval.roofline import profiled_ms
from stereo_tpu_torch.models.pyramid import (
    PyramidSGM,
    _local_minmax_center,
    _pool2,
    _residual_cost_volume,
    _upsample2,
)
from stereo_tpu_torch.ops import census_transform
from stereo_tpu_torch.ops.cuda import (
    median3x3,
    sad_cost,
    sgm_paths,
    sgm_select,
)
from stereo_tpu_torch.parallel import StreamRunner, make_tile_mesh
from stereo_tpu_torch.pipeline import compute_disparity

#: Substrings of the port's kernel names, as the profiler reports them.
KERNELS = ("census_transform_kernel", "census_cost_kernel",
           "sad_cost_kernel", "sgm_path_kernel", "sgm_select_kernel",
           "median3x3_kernel")
WARMUP = 3
#: The batched stream's row: kitti_sgm8_128, one batch of this many frames.
STREAM_ROW, STREAM_BATCH = "kitti_stream_batch48", 48


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
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        key = next((k for k in KERNELS if k in ev.key), "plain torch")
        by_kernel[key] += us / 1e3
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

    return {"slice": sl.fixture, "model": model.name,
            "shape": list(left.shape), **profiled(run, frames)}


def profile_stream(dev: torch.device) -> dict:
    """One batch of the stream after a warm-up batch, frames on the card."""
    pairs = [stream_pair(i) for i in range(STREAM_BATCH)]
    batch = [tuple(torch.from_numpy(np.stack([getattr(p, side)
                                              for p in pairs])).to(dev)
                   for side in ("left", "right"))]
    runner = StreamRunner(CFG, make_tile_mesh([dev], (1, 1)), STREAM_SHAPE,
                          batch_size=STREAM_BATCH, device=dev)
    runner.run_batches(batch)
    runner.frames_done, runner.elapsed = 0, 0.0  # the cursor, not a resume
    torch.cuda.synchronize()
    return {"slice": STREAM_ROW, "model": "StreamRunner.run_batches, 1x1",
            "shape": list(STREAM_SHAPE),
            **profiled(lambda: runner.run_batches(batch), STREAM_BATCH)}


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
    """K2's whole-frame form, and its rectangle form where this checkout
    has one, at KITTI and config-4 sizes: device ms per call of eight
    directions (``profiled_ms``, per launch times 8)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rect = "rect" in inspect.signature(sgm_paths).parameters
    rows = []
    for name, cfg, shape in (
            ("kitti 375x1242x128", KITTI_SGM8_128, (375, 1242, 128)),
            ("kitti adaptive 375x1242x128", KITTI_SGM8_128_QUALITY,
             (375, 1242, 128)),
            ("config 4 1988x2880x256", MIDDLEBURY_FULL_256_TILED,
             (1988, 2880, 256))):
        h, w, _ = shape
        cost = torch.randint(0, 64, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
        image = torch.randint(0, 256, (h, w), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        forms = {"whole": {}}
        if rect:
            forms["rect"] = {"rect": (20, h - 20, 276, w - 276)}
        for form, kw in forms.items():
            got = profiled_ms(lambda: sgm_paths(cost, cfg, image=image, **kw),
                              "sgm_path_kernel", reps=reps)
            if got is None:
                raise RuntimeError(f"{name}: the profiler recorded no K2 "
                                   f"launch")
            rows.append({"form": f"sgm_paths {form} {name}", "calls": reps,
                         "kernel_device_ms_per_call": got[0] * 8,
                         "other_device_ms": got[1]})
        del cost, image
    return rows


def main(argv=None) -> int:
    by_name = {sl.fixture: sl for sl in SLICES}
    ap = argparse.ArgumentParser(prog="profile_paths.py")
    ap.add_argument("slices", nargs="*", default=[*by_name, STREAM_ROW],
                    help=f"slices to profile, of {sorted(by_name)} and "
                         f"{STREAM_ROW}")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--forms", action="store_true",
                    help="profile K5 and K4 alone instead of the slices")
    ap.add_argument("--k2", action="store_true",
                    help="profile K2's forms alone instead of the slices")
    args = ap.parse_args(argv)
    phase_device()
    dev = torch.device("cuda", 0)
    if args.forms or args.k2:
        for row in (kernel_forms if args.forms else k2_forms)(dev):
            print(json.dumps(row))
        return 0
    for name in args.slices:
        if name == STREAM_ROW:
            print(json.dumps(profile_stream(dev)))
            continue
        sl = by_name[name]
        print(json.dumps(profile_slice(sl, args.frames, dev)))
        if isinstance(load_slice(sl)[2], PyramidSGM):
            print(json.dumps({"pyramid_stages": pyramid_stages(sl, dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
