"""Disparity -> metric depth and 3-D points, as ``stereo_tpu/utils/depth.py``.

A rectified rig turns a disparity map into depth, Z = f * B / (d + doffs)
(the Middlebury calib.txt convention, doffs being the difference of the
principal points' x), and into points in the left camera's frame.
``disparity_to_depth`` and ``reproject`` are torch and compute on the
device of a tensor input (a numpy input goes to ``device``); they are
bit-exact to the reference's jnp, whose weak typing rounds every Python
float to float32 before the op: each such constant is an explicit float32
here, and each product is its own rounded operation, never a fused
multiply-add. ``write_ply`` is a host-side (numpy) writer for inspection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraRig:
    """Rectified stereo rig intrinsics.

    focal_px: focal length in pixels (fx of the rectified left camera).
    baseline: camera separation, in whatever unit depth should come out in
      (Middlebury calib.txt gives mm; KITTI gives m).
    doffs: principal-point x difference cx_right - cx_left (Middlebury's
      "doffs"; 0 for KITTI-style rigs).
    cx, cy: left principal point for reprojection (default: image center).
    """

    focal_px: float
    baseline: float
    doffs: float = 0.0
    cx: Optional[float] = None
    cy: Optional[float] = None


def parse_middlebury_calib(path: str) -> CameraRig:
    """Parse a Middlebury 2014 ``calib.txt`` into a CameraRig.

    Lines look like::

        cam0=[3997.684 0 1176.728; 0 3997.684 1011.728; 0 0 1]
        doffs=131.111
        baseline=193.001
    """
    vals = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            k, v = line.strip().split("=", 1)
            vals[k] = v
    m = vals.get("cam0", "").strip("[]").replace(";", " ").split()
    if len(m) < 9:
        raise ValueError(f"no cam0 matrix in {path}")
    fx, cx, cy = float(m[0]), float(m[2]), float(m[5])
    return CameraRig(
        focal_px=fx,
        baseline=float(vals.get("baseline", 0.0)),
        doffs=float(vals.get("doffs", 0.0)),
        cx=cx,
        cy=cy,
    )


def _f32(value: float, device) -> torch.Tensor:
    """A Python float rounded once to a float32 scalar on ``device``."""
    return torch.tensor(np.float32(value), device=device)


def _on_device(disp, device) -> torch.Tensor:
    """``disp`` as float32 on its own device (a tensor) or ``device``."""
    if not isinstance(disp, torch.Tensor):
        disp = torch.as_tensor(np.asarray(disp), device=torch.device(device))
    return disp.to(torch.float32)


def disparity_to_depth(disp, valid, rig: CameraRig, eps: float = 1e-6,
                       device="cuda") -> torch.Tensor:
    """Z = f * B / (d + doffs); invalid or near-zero disparity -> 0 depth.

    Returns float32 [H, W] on the device of ``disp`` (a tensor) or on
    ``device`` (numpy input). ``f * B`` is one double product rounded once
    to float32, as the reference's ``jnp.float32(focal_px * baseline)``.
    """
    d = _on_device(disp, device)
    dev = d.device
    d = d + _f32(rig.doffs, dev)
    eps_f = _f32(eps, dev)
    z = _f32(rig.focal_px * rig.baseline, dev) / torch.maximum(d, eps_f)
    ok = torch.as_tensor(valid, device=dev).to(torch.bool) & (d > eps_f)
    return torch.where(ok, z, z.new_zeros(()))


def reproject(disp, valid, rig: CameraRig, device="cuda") -> torch.Tensor:
    """Disparity -> [H, W, 3] float32 XYZ points in the left camera frame.

    X = (x - cx) * Z / f, Y = (y - cy) * Z / f, Z as ``disparity_to_depth``;
    invalid pixels get (0, 0, 0). As the reference: (x - cx) * Z, then
    times the float32 reciprocal of f, two rounded products.
    """
    d = _on_device(disp, device)
    dev = d.device
    h, w = d.shape
    cx = rig.cx if rig.cx is not None else (w - 1) / 2.0
    cy = rig.cy if rig.cy is not None else (h - 1) / 2.0
    z = disparity_to_depth(d, valid, rig)
    xs = (torch.arange(w, dtype=torch.float32, device=dev)
          - _f32(cx, dev))[None, :]
    ys = (torch.arange(h, dtype=torch.float32, device=dev)
          - _f32(cy, dev))[:, None]
    inv_f = _f32(1.0 / rig.focal_px, dev)
    x = (xs * z) * inv_f
    y = (ys * z) * inv_f
    return torch.stack([x, y, z], dim=-1)


def write_ply(path: str, points, valid, colors=None,
              max_depth: Optional[float] = None) -> int:
    """Write valid points as an ASCII PLY file; returns the vertex count.

    points: [H, W, 3] (numpy, or a tensor on any device).
    colors: optional [H, W] grayscale (uint8) or [H, W, 3] RGB.
    max_depth: drop points beyond this Z (sky/occlusion spikes).
    """
    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    ok = np.asarray(valid, bool).reshape(-1) & (pts[:, 2] > 0)
    if max_depth is not None:
        ok &= pts[:, 2] <= max_depth
    pts = pts[ok]
    rgb = None
    if colors is not None:
        c = np.asarray(colors)
        if c.ndim == 2:
            c = np.repeat(c[..., None], 3, axis=-1)
        rgb = c.reshape(-1, 3)[ok].astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if rgb is None:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            for p, c in zip(pts, rgb):
                f.write(
                    f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n"
                )
    return len(pts)
