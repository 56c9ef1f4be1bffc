"""Command-line interface of the port, command for command as
``stereo_tpu.cli``:

  info    the backend, the cards and the presets
  run     one rectified pair (files, a Middlebury scene or --demo) ->
          disparity, metrics, depth and point-cloud exports
  eval    a dataset sweep with metrics and resume (Middlebury, KITTI,
          synthetic pairs) or the hard suite
  stream  the batched video stream (config 5)
  scale   the scaling report
  bench   one timed config on a synthetic pair

Every command takes ``--device cuda|cpu`` (default ``cuda``: the kernels on
the card; ``cpu`` runs the plain torch path), and every command but
``info`` takes ``--preset``, ``--set key=value`` (a config field) and
``--model``. ``--log LEVEL`` before the command sets the log level
(``utils/log.setup``; default ``STEREO_TPU_LOG``, else INFO). Timings go to
stderr with the device they ran on, results to stdout. For example::

    python -m stereo_tpu_torch.cli run --left l.png --right r.png \\
        --gt gt.png --out d.pfm --rig 721.5,0.54 --depth-out z.npy \\
        --ply cloud.ply [--tiles TY,TX | --exact-mesh TY,TX]
    python -m stereo_tpu_torch.cli eval --hard-suite --limit 1
    python -m stereo_tpu_torch.cli bench --iters 20
    python -m stereo_tpu_torch.cli stream --limit 96 --batch 48 \\
        --profile prof/

``--profile DIR`` (``run``, ``stream``) writes a ``torch.profiler`` chrome
trace, ``DIR/trace.json``: for ``run`` one call after a warm-up, for
``stream`` the whole stream, kernel builds included. The stream's host work
shows there as spans (``utils/trace.py``): ``stream.collect`` (pulling a
batch's frames), ``stream.stage`` (stack, pin, copy in), ``stream.enqueue``
(every launch of a batch), ``stream.wait`` (the wait for a batch's event),
``stream.deliver`` (the ``on_result`` call) and ``stream.checkpoint`` (the
pipeline emptied and the manifest written; ``wait`` and ``deliver`` nest
inside).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import PRESETS, StereoConfig
from .models import MODELS, get_model


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


def _grid(spec: str, device: torch.device):
    """A local ``ty x tx`` tile grid: the cards in turn, or ``device``."""
    from .parallel import make_tile_mesh
    from .parallel.mesh import cuda_devices

    ty, tx = (int(v) for v in spec.split(","))
    n = ty * tx
    devices = cuda_devices(n) if device.type == "cuda" else [device] * n
    return make_tile_mesh(devices, mesh_shape=(ty, tx))


def _load_pair(args):
    from .data.synthetic import make_pair

    if args.demo:
        return make_pair(
            tuple(args.demo_shape), max_disp=args.demo_max_disp,
            kind="shapes", texture="cloud", seed=args.seed,
        )
    if args.scene:
        from .data.middlebury import load_scene

        return load_scene(args.scene)
    if not (args.left and args.right):
        raise SystemExit("need --left/--right, --scene, or --demo")
    from .data.middlebury import load_image_gray
    from .data.synthetic import StereoPair

    left = load_image_gray(args.left)
    right = load_image_gray(args.right)
    gt = np.zeros(left.shape, np.float32)
    gtv = np.zeros(left.shape, bool)
    if args.gt:
        if args.gt.endswith(".pfm"):
            from .data.middlebury import read_pfm

            gt = read_pfm(args.gt)
            gtv = np.isfinite(gt) & (gt > 0)
        else:
            from .data.kitti import read_kitti_disparity

            gt, gtv = read_kitti_disparity(args.gt)
    name = os.path.splitext(os.path.basename(args.left))[0]
    return StereoPair(left, right, gt, gtv, name=name)


def _card_lines():
    """One line per CUDA card: its name and power limit as nvidia-smi
    reports them (the name alone where nvidia-smi is missing)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return [smi[i] if i < len(smi) else torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())]


def cmd_info(args) -> int:
    device = torch.device(args.device)
    cuda = device.type == "cuda" and torch.cuda.is_available()
    print(f"backend: {'cuda' if cuda else 'cpu'} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    print(f"devices: {_card_lines() if cuda else ['cpu']}")
    print("presets:")
    for name, cfg in PRESETS.items():
        print(
            f"  {name:28s} cost={cfg.cost_fn:6s} D={cfg.num_disparities:3d} "
            f"paths={cfg.num_paths} subpix={int(cfg.subpixel)} "
            f"lr={int(cfg.lr_check)}"
        )
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dump_volume(path: str, pair, cfg: StereoConfig,
                 device: torch.device) -> None:
    """S of the whole frame through K1 and K2 (their plain twins on the
    CPU), saved as the reference's int32 volume."""
    from .pipeline import _kernel_cost, kernel_sum

    left = torch.tensor(pair.left, device=device)
    right = torch.tensor(pair.right, device=device)
    s_vol = kernel_sum(_kernel_cost(left, right, cfg), cfg, left)
    np.save(path, s_vol.to(torch.int32).cpu().numpy())
    print(f"wrote {path}", file=sys.stderr)


def _rig_of(args):
    """The rig from --rig or --calib, or the calib.txt beside --scene when
    depth or points are asked for; None otherwise."""
    from .utils.depth import CameraRig, parse_middlebury_calib

    if args.rig:
        parts = [float(v) for v in args.rig.split(",")]
        if len(parts) < 2:
            raise SystemExit("--rig expects fx,baseline[,doffs]")
        return CameraRig(parts[0], parts[1],
                         parts[2] if len(parts) > 2 else 0.0)
    if args.calib:
        return parse_middlebury_calib(args.calib)
    if args.scene and (args.depth_out or args.ply):
        calib = os.path.join(args.scene, "calib.txt")
        if os.path.exists(calib):
            return parse_middlebury_calib(calib)
    return None


def _profiled(out_dir: str, device: torch.device, call):
    """``call()`` under ``torch.profiler`` (host ops and spans, and the
    card's kernels and copies on a card), its chrome trace written to
    ``out_dir/trace.json``; returns what ``call`` returns."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = call()
        _sync(device)
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"profile trace written to {trace}", file=sys.stderr)
    return out


def cmd_run(args) -> int:
    from .eval.metrics import evaluate_disparity
    from .pipeline import host_postprocess

    cfg = _cfg_from_args(args)
    pair = _load_pair(args)
    device = torch.device(args.device)

    if args.tiles:
        from .parallel import build_halo_pipeline

        fn = build_halo_pipeline(cfg, _grid(args.tiles, device),
                                 device=device)
    elif args.exact_mesh:
        from .parallel import build_exact_pipeline

        fn = build_exact_pipeline(cfg, _grid(args.exact_mesh, device),
                                  dplane_cost=args.dplane_cost,
                                  device=device)
    else:
        fn = get_model(args.model, cfg=cfg).build(device)
    left = torch.tensor(pair.left, device=device)
    right = torch.tensor(pair.right, device=device)

    if args.profile:
        fn(left, right)  # the kernels' build and the allocator outside
        _sync(device)
        res = _profiled(args.profile, device, lambda: fn(left, right))
    else:
        from .utils.timing import chained_seconds_per_call

        t0 = time.perf_counter()
        res = fn(left, right)
        _sync(device)
        first_s = time.perf_counter() - t0
        steady = chained_seconds_per_call(fn, (left, right), iters=5,
                                          repeats=1)
        print(
            f"[{pair.name}] on {_device_name(device)}: first call "
            f"{first_s:.2f}s, steady-state {steady:.4f}s "
            f"({1.0 / steady:.1f} fps)",
            file=sys.stderr,
        )

    if args.dump_volume:
        _dump_volume(args.dump_volume, pair, cfg, device)

    disp, valid = host_postprocess(res.disp, res.valid, cfg)
    if pair.gt_valid.any():
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        print(json.dumps({"pair": pair.name, **{k: round(v, 5) for k, v in m.items()}}))

    rig = _rig_of(args)
    if (args.depth_out or args.ply) and rig is None:
        raise SystemExit(
            "--depth-out/--ply need rig intrinsics: --rig fx,baseline[,doffs]"
            " or --calib calib.txt (auto-discovered beside --scene)"
        )
    if args.depth_out:
        from .utils.depth import disparity_to_depth

        depth = disparity_to_depth(disp, valid, rig, device=device)
        np.save(args.depth_out, depth.cpu().numpy())
        print(f"wrote {args.depth_out}", file=sys.stderr)
    if args.ply:
        from .utils.depth import reproject, write_ply

        pts = reproject(disp, valid, rig, device=device)
        n = write_ply(args.ply, pts, valid, colors=pair.left)
        print(f"wrote {args.ply} ({n} points)", file=sys.stderr)

    if args.out:
        from .utils.viz import colorize_disparity, save_png

        ext = os.path.splitext(args.out)[1]
        if ext == ".pfm":
            from .data.middlebury import write_pfm

            write_pfm(args.out, np.where(valid, disp, np.inf))
        elif ext == ".png" and args.kitti_format:
            from .data.kitti import write_kitti_disparity

            write_kitti_disparity(args.out, disp, valid)
        else:
            save_png(args.out, colorize_disparity(disp, valid))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_eval(args) -> int:
    from .eval.harness import EvalHarness

    cfg = _cfg_from_args(args)
    device = torch.device(args.device)

    if args.hard_suite:
        # The adversarial synthetic sweep (eval/hard_suite.py).
        from .eval.hard_suite import run_hard_suite

        rows = run_hard_suite(
            cfg,
            shape=tuple(args.demo_shape),
            seeds=tuple(range(args.limit or 3)),
            model=args.model,
            device=device,
        )
        for r in rows:
            print(json.dumps(r))
            if args.results:
                with open(args.results, "a") as f:
                    f.write(json.dumps({"metric": "hard_suite", **r}) + "\n")
        return 0

    def pairs():
        if args.middlebury:
            from .data.middlebury import discover_scenes, load_scene

            for d in discover_scenes(args.middlebury):
                yield load_scene(d)
        elif args.kitti:
            from .data.kitti import list_frame_ids, load_kitti_pair

            ids = list_frame_ids(args.kitti)[: args.limit or None]
            for fid in ids:
                yield load_kitti_pair(args.kitti, fid)
        else:
            from .data.synthetic import make_pair

            n = args.limit or 8
            max_disp = max(4, cfg.num_disparities * 3 // 4)
            for i in range(n):
                yield make_pair(
                    (192, 320), max_disp=max_disp, kind="shapes",
                    texture="cloud", seed=i,
                )

    harness = EvalHarness(
        cfg,
        results_path=args.results,
        manifest_path=args.manifest,
        artifacts_dir=args.artifacts,
        model=args.model,
        device=device,
    )
    summary = harness.run(pairs())
    print(json.dumps(summary))
    return 0


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
    if args.profile:
        stats = _profiled(args.profile, device, lambda: runner.run(frames))
    else:
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


def cmd_bench(args) -> int:
    from .data.synthetic import make_pair
    from .pipeline import build_pipeline
    from .utils.timing import chained_seconds_per_call

    cfg = _cfg_from_args(args)
    device = torch.device(args.device)
    pair = make_pair(
        tuple(args.demo_shape), max_disp=args.demo_max_disp,
        kind="shapes", texture="cloud", seed=0,
    )
    fn = build_pipeline(cfg, device)
    left = torch.tensor(pair.left, device=device)
    right = torch.tensor(pair.right, device=device)
    sec = chained_seconds_per_call(fn, (left, right), iters=args.iters)
    print(json.dumps({
        "preset": args.preset, "shape": list(pair.left.shape),
        "sec_per_frame": round(sec, 6), "fps": round(1.0 / sec, 2),
        "device": _device_name(device),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_device(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (the kernels on the card) or cpu")

    def add_common(p):
        p.add_argument("--preset", default="kitti_sgm8_128")
        p.add_argument("--set", action="append", metavar="KEY=VALUE")
        p.add_argument("--model", default="classic", choices=sorted(MODELS),
                       help="model family (classic = the full SGM pipeline)")
        add_device(p)

    p = sub.add_parser("info", help="backend, cards and presets")
    add_device(p)
    p.set_defaults(func=cmd_info)

    p = sub.add_parser("run", help="one pair -> disparity and exports")
    add_common(p)
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--gt")
    p.add_argument("--scene", help="Middlebury scene directory")
    p.add_argument("--demo", action="store_true", help="synthetic pair")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--demo-max-disp", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help=".png (colormap), .pfm, or KITTI .png")
    p.add_argument("--kitti-format", action="store_true")
    p.add_argument("--tiles", help="halo-tiled run over a ty,tx grid")
    p.add_argument("--exact-mesh", help="exact reshard mode over ty,tx")
    p.add_argument("--dplane-cost", action="store_true",
                   help="with --exact-mesh: build the cost volume on "
                        "disparity planes before the reshard")
    p.add_argument("--rig", metavar="FX,BASELINE[,DOFFS]",
                   help="rig intrinsics for depth/point-cloud export")
    p.add_argument("--calib", help="Middlebury calib.txt path")
    p.add_argument("--depth-out", metavar="NPY",
                   help="save metric depth (Z = f*B/(d+doffs)) as .npy")
    p.add_argument("--ply", metavar="PLY",
                   help="export the valid pixels as a 3-D point cloud")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace (trace.json) there")
    p.add_argument("--dump-volume", metavar="NPY",
                   help="save the aggregated cost volume S (int32)")
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("eval", help="a dataset sweep or the hard suite")
    add_common(p)
    p.add_argument("--middlebury", help="root of Middlebury scene dirs")
    p.add_argument("--kitti", help="KITTI 2015 training root")
    p.add_argument("--hard-suite", action="store_true",
                   help="adversarial synthetic sweep (radiometric/"
                        "occlusion/textureless/slant/thin/jitter)")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(160, 288),
                   help="pair shape for --hard-suite")
    p.add_argument("--limit", type=int)
    p.add_argument("--results", help="append JSONL records here")
    p.add_argument("--manifest", help="resume manifest path")
    p.add_argument("--artifacts", help="write disparity/error PNGs here")
    p.set_defaults(func=cmd_eval)

    p = sub.add_parser("stream", help="a frame stream -> stats JSON line")
    add_common(p)
    p.add_argument("--kitti", help="KITTI root for real frames")
    p.add_argument("--limit", type=int)
    p.add_argument("--batch", type=int, help="frames per step")
    p.add_argument("--batch-axis", type=int, default=1,
                   help="size of the 'batch' mesh axis")
    p.add_argument("--tiles", help="ty,tx tile mesh per frame")
    p.add_argument("--manifest", help="stream resume manifest")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the whole stream, "
                        "its stream.* spans included (trace.json), there")
    p.set_defaults(func=cmd_stream)

    p = sub.add_parser("scale", help="scaling report -> JSON line per row")
    add_common(p)
    p.add_argument("--devices", help="comma list of device counts")
    p.add_argument("--tiles", help="ty,tx tiles per frame")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(func=cmd_scale)

    p = sub.add_parser("bench", help="one timed config -> JSON line")
    add_common(p)
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--demo-max-disp", type=int, default=96)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(func=cmd_bench)

    ap.add_argument("--log", default=None, help="log level (DEBUG/INFO/...)")
    args, _ = ap.parse_known_args(argv)
    from .utils.log import setup

    setup(args.log)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
