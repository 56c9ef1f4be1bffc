"""Command-line interface of the port.

    python -m stereo_tpu_torch.cli run --demo --preset kitti_sgm8_128 \\
        [--model classic|block_matching|pyramid] [--set key=value ...] \\
        [--device cuda|cpu]

runs one synthetic pair (with exact ground truth) through the named model
and ``host_postprocess`` and prints the metrics as one JSON line, as the
reference's ``stereo_tpu.cli run`` does. Timings go to stderr with the
device they ran on.

    python -m stereo_tpu_torch.cli stream [--kitti ROOT] [--limit N] \\
        [--batch B] [--batch-axis NB] [--tiles TY,TX] [--manifest PATH] \\
        [--demo-shape H W] [--device cuda|cpu]

streams KITTI frames (``frame_pairs``) or synthetic ones through
``StreamRunner`` on a local mesh and prints its stats as one JSON line;

    python -m stereo_tpu_torch.cli scale [--devices 1,2] [--tiles TY,TX] \\
        [--demo-shape H W] [--iters N] [--device cuda|cpu]

prints ``scaling_report``'s rows, one JSON line each. Image files for
``run``, ``info``, ``eval`` and ``bench`` are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import torch

from .config import PRESETS, StereoConfig
from .models import MODELS, get_model

#: Calls timed after the first for the steady-state median.
STEADY_CALLS = 5


def _apply_overrides(cfg: StereoConfig, sets) -> StereoConfig:
    fields = {f.name: f for f in dataclasses.fields(StereoConfig)}
    kw = {}
    for s in sets or []:
        if "=" not in s:
            raise SystemExit(f"--set expects key=value, got {s!r}")
        k, v = s.split("=", 1)
        if k not in fields:
            raise SystemExit(
                f"unknown config field {k!r}; valid: {sorted(fields)}"
            )
        t = fields[k].type
        if t in ("int", int):
            kw[k] = int(v)
        elif t in ("float", float):
            kw[k] = float(v)
        elif t in ("bool", bool):
            kw[k] = v.lower() in ("1", "true", "yes", "on")
        elif "Tuple" in str(t):
            kw[k] = tuple(int(x) for x in v.split(","))
        else:
            kw[k] = v
    return cfg.replace(**kw) if kw else cfg


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _cfg_from_args(args) -> StereoConfig:
    cfg = PRESETS.get(args.preset)
    if cfg is None:
        raise SystemExit(f"unknown preset {args.preset!r}; valid: {sorted(PRESETS)}")
    return _apply_overrides(cfg, args.set)


def cmd_stream(args) -> int:
    from .parallel import StreamRunner, make_tile_mesh
    from .parallel.mesh import cuda_devices

    cfg = _cfg_from_args(args)
    device = torch.device(args.device)
    batch = args.batch_axis
    if args.tiles:
        ty, tx = (int(v) for v in args.tiles.split(","))
    else:
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        ty, tx = max(1, cards // batch), 1
    n = batch * ty * tx
    devices = [device] * n if device.type != "cuda" else cuda_devices(n)
    mesh = make_tile_mesh(devices, mesh_shape=(ty, tx), batch=batch)

    if args.kitti:
        from .data.kitti import frame_pairs

        frames = list(frame_pairs(args.kitti, limit=args.limit))
        shape = frames[0][0].shape
    else:
        from .data.synthetic import make_pair

        nf = args.limit or 32
        shape = tuple(args.demo_shape)
        max_disp = max(4, cfg.num_disparities * 3 // 4)
        frames = [
            (p.left, p.right)
            for p in (
                make_pair(shape, max_disp=max_disp, kind="shapes",
                          texture="cloud", seed=i)
                for i in range(nf)
            )
        ]

    runner = StreamRunner(cfg, mesh, shape, batch_size=args.batch,
                          manifest_path=args.manifest, device=device)
    stats = runner.run(frames)
    print(json.dumps({**stats, "device": _device_name(device)}))
    return 0


def cmd_scale(args) -> int:
    from .eval.scaling import scaling_report

    cfg = _cfg_from_args(args)
    device = torch.device(args.device)
    counts = ([int(v) for v in args.devices.split(",")] if args.devices
              else None)
    ty, tx = ((int(v) for v in args.tiles.split(",")) if args.tiles
              else (1, 1))
    devices = None
    if device.type != "cuda":
        devices = [device] * max(counts or [1])
    rows = scaling_report(cfg, image_shape=tuple(args.demo_shape),
                          device_counts=counts, tiles_per_device=(ty, tx),
                          iters=args.iters, devices=devices)
    for r in rows:
        print(json.dumps(r))
    return 0


def cmd_run(args) -> int:
    from .data.synthetic import make_pair
    from .eval.metrics import evaluate_disparity
    from .pipeline import host_postprocess

    cfg = _cfg_from_args(args)
    if not args.demo:
        raise SystemExit("only --demo (a synthetic pair) is ported so far")
    pair = make_pair(
        tuple(args.demo_shape), max_disp=args.demo_max_disp,
        kind="shapes", texture="cloud", seed=args.seed,
    )
    device = torch.device(args.device)
    fn = get_model(args.model, cfg=cfg).build(device)

    def timed():
        t0 = time.perf_counter()
        res = fn(pair.left, pair.right)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, res

    first_s, res = timed()
    steady_s = statistics.median(timed()[0] for _ in range(STEADY_CALLS))
    print(
        f"[{pair.name}] on {_device_name(device)}: first call {first_s:.3f}s "
        f"(includes the kernel build), steady-state {steady_s * 1e3:.3f} ms",
        file=sys.stderr,
    )
    disp, valid = host_postprocess(res.disp, res.valid, cfg)
    m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
    print(json.dumps({"pair": pair.name, **{k: round(v, 5) for k, v in m.items()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="one pair -> metrics JSON line")
    p.add_argument("--preset", default="kitti_sgm8_128")
    p.add_argument("--model", default="classic", choices=sorted(MODELS),
                   help="model family (classic = the full SGM pipeline)")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.add_argument("--demo", action="store_true", help="synthetic pair")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--demo-max-disp", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("stream", help="a frame stream -> stats JSON line")
    p.add_argument("--preset", default="kitti_sgm8_128")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.add_argument("--kitti", help="KITTI root for real frames")
    p.add_argument("--limit", type=int)
    p.add_argument("--batch", type=int, help="frames per step")
    p.add_argument("--batch-axis", type=int, default=1,
                   help="size of the 'batch' mesh axis")
    p.add_argument("--tiles", help="ty,tx tile mesh per frame")
    p.add_argument("--manifest", help="stream resume manifest")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--device", default="cuda")
    p.set_defaults(func=cmd_stream)

    p = sub.add_parser("scale", help="scaling report -> JSON line per row")
    p.add_argument("--preset", default="kitti_sgm8_128")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.add_argument("--devices", help="comma list of device counts")
    p.add_argument("--tiles", help="ty,tx tiles per frame")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.set_defaults(func=cmd_scale)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
