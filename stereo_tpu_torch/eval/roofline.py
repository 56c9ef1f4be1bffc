"""Per-kernel roofline on an NVIDIA H100: byte and operation models of the
kernels, the measured ALU anchor, and a per-kernel report.

The counterpart of ``stereo_tpu/eval/roofline.py``, written for this card
(the reference models a TPU v5e's vector unit). For each kernel it states

  * the bytes the function must move (each input read once, each output
    written once) and the elementwise integer or float operations it does
    on those inputs, both from the shapes alone;
  * both bounds, bytes over the card's memory rate and operations over its
    ALU rate, and which one binds;
  * the fraction of the binding bound achieved.

The fraction of record (``sol_fraction``) uses FIXED published rates:
3.35 TB/s of device memory and the 67 T/s float32 rate outside the tensor
cores (the data sheet gives no separate integer rate, and counts a fused
multiply-add as two operations, so adds, mins and compares cannot reach
it). ``measure_alu_peak`` measures what a register-resident chain of adds
and mins achieves on this card, in float32 and in int32. That anchor is a
diagnostic beside the fraction of record: ``sol_fraction_anchor`` is the
same fraction with the operations held against the anchor instead of the
published rate. (The reference folds its anchor in through ``max(measured,
fixed)``; here the anchor lies below the published rate, so that rule would
print the fraction of record twice.)

    python -m stereo_tpu_torch.eval.roofline --preset kitti_sgm8_128

needs a CUDA card (a time taken on a CPU says nothing about the card).
"""

from __future__ import annotations

import json
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from ..config import StereoConfig

#: Published peaks of one H100 SXM at 700 W: device memory, and the float32
#: rate outside the tensor cores, which the kernels' integer ALU work is
#: held against too.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

#: The reference's anchor programs as (rows, k, chains): the element count
#: is rows * 64 * 128, as its 64 blocks of [rows, 128].
ANCHOR_PROGRAMS = ((512, 256, 4), (256, 512, 4))
ANCHOR_SWEEP = ((512, 256, 8), (512, 512, 8), (256, 256, 16), (512, 256, 2))
_ANCHOR_COLS = 64 * 128


def bound(nbytes: float, ops: float) -> Dict[str, object]:
    """The least time this card could take: the bytes the function must
    move (inputs read once, outputs written once) over the memory rate, or
    its operations over the peak rate, whichever is larger. ``nbytes`` and
    ``operations`` are kept beside it for the fractions."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None,  # no single PyTorch call computes any form
                nbytes=nbytes, operations=ops)


def cost_bound(h, w, d, words, ops_per_voxel, ctx=0):
    """K1's cost stage: a left [H, W, words] and a right [H, W + ctx, words]
    int32 descriptor plane in (as the transform stage writes them), int8
    volume out."""
    return bound((2 * w + ctx) * h * words * 4 + h * w * d,
                 h * w * d * ops_per_voxel)


def transform_bound(h, w, window, rank=False, image_bytes=1):
    """K1's transform stage on one [H, W] image of ``image_bytes`` per
    pixel: the image in, the int32 census words (or rank) out; per pixel
    and off-centre neighbour a compare and its bit's or (rank: an add)."""
    wy, wx = window
    words = 1 if rank else (wy * wx + 30) // 32
    return bound(h * w * (image_bytes + 4 * words), h * w * (wy * wx - 1) * 2)


def sad_bound(h, w, d, window, right_context=0, image_bytes=1):
    """K5: the two images in at ``image_bytes`` per pixel (the right one
    ``right_context`` columns wider), the int16 volume out. The kernel
    reads the images in their own type, as ``transform_bound`` counts K1's,
    and every path gives it uint8. Operations: the least work of the
    function, 8 per voxel whatever the ``window``, since running sums make
    the window's size free: the absolute difference (a subtract and an
    absolute value), the vertical and the horizontal running sum (an add
    and a subtract each), the divide by the area (a high multiply) and the
    select of ``max_unary_cost``."""
    del window  # the running sums cost the same at any window
    return bound((2 * w + right_context) * h * image_bytes + h * w * d * 2,
                 h * w * d * 8)


def paths_bound(cost, cfg, n_paths=None, mask=False):
    """K2 (all directions of one call: ``n_paths`` of them, default
    cfg.num_paths): the cost volume in, the int16 S out, the int32 image in
    with adaptive P2, the [H, W] byte mask in with the mask form; per voxel
    and direction about 10 integer operations (3 adds, 5 mins counting the
    reduction, the renormalising subtract, the accumulate)."""
    h, w, d = cost.shape
    nbytes = h * w * d * (cost.element_size() + 2)
    if cfg.adaptive_p2:
        nbytes += h * w * 4
    if mask:
        nbytes += h * w
    return bound(nbytes, h * w * d * (n_paths or cfg.num_paths) * 10)


def select_bound(h, w, d, emit_d0=False, spill=0):
    """K3: int16 S in, float32 disp and one validity byte out (int32 d0
    with emit_d0; with the emit_qr form, ``spill`` > 0 columns wide, also
    d0, the LR byte, float32 qr and the spill); per voxel about 6 compares
    and selects."""
    out = h * w * (5 + 4 * emit_d0)
    if spill:
        out = h * w * (5 + 4 + 1 + 4) + h * spill * 4
    return bound(h * w * d * 2 + out, h * w * d * 6)


def median_bound(h, w):
    """K4: float32 map in and out; 19 exchanges of a min and a max."""
    return bound(2 * h * w * 4, h * w * 38)


def peak_bound(n, k):
    """K6: one 4-byte element in and out, 2k chain operations each."""
    return bound(2 * n * 4, 2 * k * n)


def sol_fractions(row: Dict[str, object], measured_ops_per_s: float
                  ) -> Dict[str, float]:
    """The fractions of the binding bound a row (``bound``'s keys plus
    ``ms``) achieved: ``sol_fraction`` against the fixed published rates,
    ``sol_fraction_anchor`` with the operations held against the measured
    anchor instead of the published ALU rate."""
    t_bytes = row["nbytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = row["operations"] / measured_ops_per_s * 1e3
    return dict(
        sol_fraction=row["bound_ms"] / row["ms"],
        sol_fraction_anchor=max(t_ops, t_bytes) / row["ms"],
    )


def _require_card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the roofline is measured on a CUDA card; a time "
                           "taken on a CPU says nothing about it")
    return device


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


def profiled_ms(fn, kernel: str, reps: int = 20, attempts: int = 3
                ) -> Optional[Tuple[float, float, float]]:
    """The device time of ``fn()`` by ``torch.profiler`` over a train of
    ``reps`` calls after a warm-up: (ms per launch of the kernels whose
    name contains ``kernel``, ms of every other device launch per call,
    those launches per call). The kernel alone, without the host's launch
    path that ``cuda_ms`` includes. The profiler on the card now and then
    records none of a train's launches: the train then runs again, up to
    ``attempts`` times, and None is returned if it never records one."""
    cuda = torch.autograd.DeviceType.CUDA

    def device_us(ev) -> float:
        us = getattr(ev, "self_device_time_total", None)
        return ev.self_cuda_time_total if us is None else us

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if ev.device_type == cuda]
        ours = [ev for ev in evs if kernel in ev.key]
        other = [ev for ev in evs if kernel not in ev.key]
        n = sum(ev.count for ev in ours)
        if n:
            return (sum(map(device_us, ours)) / n / 1e3,
                    sum(map(device_us, other)) / reps / 1e3,
                    sum(ev.count for ev in other) / reps)
    return None


def _train_ms(fn, launches: int, trains: int = 3) -> float:
    """Device ms per call of ``fn()`` in a train of ``launches`` calls
    between one pair of CUDA events (the least of ``trains`` trains): the
    queue stays full, so the host's launch path is not in the time, as it
    is in ``cuda_ms`` for a kernel this short."""
    best = float("inf")
    for _ in range(trains):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


def measure_alu_peak(device="cuda", iters: int = 30, sweep: bool = False
                     ) -> Dict[str, float]:
    """Achieved elementwise operations per second of K6 on this card, by
    element type: the best over the reference's anchor programs (a peak is
    a maximum, and an unlucky schedule is a one-sided error), each timed
    as trains of ``iters`` launches. Prints one JSON line per program.
    ``sweep`` widens the program set."""
    from ..ops.cuda import alu_peak

    device = _require_card(device)
    programs = ANCHOR_PROGRAMS + (ANCHOR_SWEEP if sweep else ())
    best = {"float32": 0.0, "int32": 0.0}
    for dtype in (torch.float32, torch.int32):
        name = str(dtype).split(".")[1]
        for rows, k, chains in programs:
            x = torch.ones(rows * _ANCHOR_COLS, dtype=dtype, device=device)
            for _ in range(3):
                alu_peak(x, k, chains)
            ms = _train_ms(lambda: alu_peak(x, k, chains), iters)
            rate = 2.0 * k * x.numel() / (ms * 1e-3)
            print(json.dumps({
                "anchor_dtype": name, "anchor_rows": rows, "anchor_k": k,
                "anchor_chains": chains, "ms": ms, "gops": rate / 1e9,
            }), flush=True)
            best[name] = max(best[name], rate)
    return best


def per_kernel_report(cfg: StereoConfig, shape: Tuple[int, int] = (375, 1242),
                      device="cuda", iters: int = 20,
                      alu_peak: Optional[Dict[str, float]] = None
                      ) -> List[dict]:
    """Time each kernel of the classic census path alone on ``device``, on
    a synthetic pair of ``shape``, with the real intermediates as inputs;
    one row per kernel (printed as a JSON line) with the reference's
    columns: ms, bytes_mb, gops, achieved_tops, hbm_bound_ms, alu_bound_ms,
    binding, sol_fraction, sol_fraction_anchor."""
    from ..data import make_pair
    from ..ops.cuda import (
        census_cost,
        median3x3,
        sgm_paths,
        sgm_select,
        transform_words,
    )

    if cfg.cost_fn != "census" or cfg.num_paths == 0 or cfg.lr_exact:
        raise NotImplementedError(
            "the per-kernel roofline covers the census + SGM path with the "
            "cheap LR check")
    device = _require_card(device)
    h, w = shape
    d = cfg.num_disparities
    pair = make_pair(shape, max_disp=max(4, d * 3 // 4), kind="shapes",
                     texture="cloud", seed=0)
    left = torch.from_numpy(pair.left).to(device)
    right = torch.from_numpy(pair.right).to(device)
    if alu_peak is None:
        alu_peak = measure_alu_peak(device, iters=max(10, iters // 3))
        print(json.dumps({"alu_peak_gops": {k: v / 1e9
                                            for k, v in alu_peak.items()}}),
              flush=True)

    cl = transform_words(left, cfg.census_window)
    cr = transform_words(right, cfg.census_window)
    cost = census_cost(cl, cr, cfg)
    s = sgm_paths(cost, cfg, image=left)
    disp, _ = sgm_select(s, cfg)
    stages = [
        ("census transform x2", "int32",
         lambda: (transform_words(left, cfg.census_window),
                  transform_words(right, cfg.census_window)),
         bound(*(2 * transform_bound(h, w, cfg.census_window)[k]
                 for k in ("nbytes", "operations")))),
        ("census_cost", "int32", lambda: census_cost(cl, cr, cfg),
         cost_bound(h, w, d, cfg.census_words, 5)),
        (f"sgm_paths x{cfg.num_paths}", "int32",
         lambda: sgm_paths(cost, cfg, image=left), paths_bound(cost, cfg)),
        ("sgm_select", "int32", lambda: sgm_select(s, cfg),
         select_bound(h, w, d)),
    ]
    if cfg.median_filter:
        stages.append(("median3x3", "float32", lambda: median3x3(disp),
                       median_bound(h, w)))
    rows = []
    for name, anchor, fn, model in stages:
        ms = cuda_ms(fn, reps=iters, warmup=2)
        t_bytes = model["nbytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = model["operations"] / PEAK_OPS_PER_S * 1e3
        rows.append({
            "kernel": name, "ms": ms, "bytes_mb": model["nbytes"] / 1e6,
            "gops": model["operations"] / 1e9,
            "achieved_tops": model["operations"] / (ms * 1e-3) / 1e12,
            "hbm_bound_ms": t_bytes, "alu_bound_ms": t_ops,
            "binding": "alu" if t_ops > t_bytes else "hbm",
            **sol_fractions(dict(model, ms=ms), alu_peak[anchor]),
        })
    rows.append({
        "kernel": "TOTAL(kernels)", "ms": sum(r["ms"] for r in rows),
        "shape": [h, w, d], "device": torch.cuda.get_device_name(device),
        "alu_peak_gops": {k: v / 1e9 for k, v in alu_peak.items()},
        "alu_peak_fixed_gops": PEAK_OPS_PER_S / 1e9,
        "adaptive_p2": bool(cfg.adaptive_p2),
        "note": "each kernel timed alone with CUDA events through its "
                "wrapper (K1's transform stage on both images as one row)",
    })
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def main(argv=None) -> int:
    import argparse

    from ..config import PRESETS

    ap = argparse.ArgumentParser(prog="python -m stereo_tpu_torch.eval.roofline")
    ap.add_argument("--preset", default="kitti_sgm8_128", choices=sorted(PRESETS))
    ap.add_argument("--shape", type=int, nargs=2, default=(375, 1242),
                    metavar=("H", "W"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--anchor-sweep", action="store_true",
                    help="widen the anchor's program set")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    peak = measure_alu_peak(args.device, iters=args.iters,
                            sweep=args.anchor_sweep)
    print(json.dumps({"alu_peak_gops_best": {k: v / 1e9
                                             for k, v in peak.items()}}))
    per_kernel_report(PRESETS[args.preset], tuple(args.shape), args.device,
                      iters=args.iters, alu_peak=peak)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
