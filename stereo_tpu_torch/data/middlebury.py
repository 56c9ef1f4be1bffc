"""Middlebury stereo scenes: rectified 8-bit pairs and their ground truth.

Twin of ``stereo_tpu/data/middlebury.py`` (numpy and PIL, with the port's
native PNM/PFM readers); gives the reference's arrays bit for bit. No
dataset ships with the repository; the loaders read a local copy.
Layouts:
  * 2001/2003 (tsukuba, teddy, cones): <scene>/im2.{ppm,png}, im6.*,
    disp2.{pgm,png} with disparities scaled by ``gt_scale`` (16 for
    tsukuba, 4 for the quarter-size 2003 sets by default);
  * 2014 (full resolution): <scene>/im0.png, im1.png, disp0.pfm.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from .synthetic import StereoPair


def load_image_gray(path: str) -> np.ndarray:
    """An image as [H, W] uint8 grayscale (ITU-R BT.601 luma).

    Binary PGM/PPM files go through the native reader (its library must
    build: a failed build raises); other files, and PNM variants the native
    reader refuses, through PIL.
    """
    if path.endswith((".pgm", ".ppm", ".pnm")):
        from ..native import read_pnm_gray

        img = read_pnm_gray(path)
        if img is not None:
            return img
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.uint8)


def read_pfm(path: str) -> np.ndarray:
    """A Middlebury .pfm disparity map as [H, W] float32.

    PFM stores rows bottom to top; Inf marks unknown disparity. Single
    channel files go through the native reader, colour ones (first
    channel) through numpy.
    """
    from ..native import read_pfm_native

    native = read_pfm_native(path)
    if native is not None:
        return native
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1").strip()
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1").strip()
        m = re.match(r"^(\d+)\s+(\d+)$", dims)
        if not m:
            raise ValueError(f"{path}: bad PFM dims line {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").strip())
        endian = "<" if scale < 0 else ">"
        channels = 3 if header == "PF" else 1
        data = np.frombuffer(
            f.read(w * h * channels * 4), dtype=endian + "f4"
        )
    data = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    if channels == 3:
        data = data[..., 0]
    return np.ascontiguousarray(data[::-1]).astype(np.float32)


def write_pfm(path: str, data: np.ndarray) -> None:
    """Write [H, W] float32 as little-endian Pf."""
    data = np.asarray(data, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(data[::-1]).tobytes())


def _first_existing(scene_dir: str, names) -> Optional[str]:
    for n in names:
        p = os.path.join(scene_dir, n)
        if os.path.exists(p):
            return p
    return None


def load_scene(scene_dir: str, gt_scale: Optional[float] = None) -> StereoPair:
    """One Middlebury scene directory, its layout detected."""
    name = os.path.basename(os.path.normpath(scene_dir))

    left_p = _first_existing(
        scene_dir, ["im0.png", "im2.png", "im2.ppm", "view1.png", "scene1.row3.col1.ppm"]
    )
    right_p = _first_existing(
        scene_dir, ["im1.png", "im6.png", "im6.ppm", "view5.png", "scene1.row3.col5.ppm"]
    )
    if left_p is None or right_p is None:
        raise FileNotFoundError(f"no stereo pair found in {scene_dir}")

    gt = None
    gt_valid = None
    pfm = _first_existing(scene_dir, ["disp0.pfm", "disp0GT.pfm", "disp1.pfm"])
    img_gt = _first_existing(
        scene_dir, ["disp2.pgm", "disp2.png", "disp1.png", "truedisp.row3.col3.pgm"]
    )
    if pfm is not None:
        gt = read_pfm(pfm)
        gt_valid = np.isfinite(gt) & (gt > 0)
        gt = np.where(gt_valid, gt, 0.0).astype(np.float32)
    elif img_gt is not None:
        raw = load_image_gray(img_gt).astype(np.float32)
        if gt_scale is None:
            # tsukuba's ground truth is scaled by 16, the 2003 quarter-size
            # sets' by 4.
            gt_scale = 16.0 if "tsukuba" in name.lower() else 4.0
        gt = raw / gt_scale
        gt_valid = raw > 0

    left = load_image_gray(left_p)
    right = load_image_gray(right_p)
    if gt is None:
        gt = np.zeros(left.shape, np.float32)
        gt_valid = np.zeros(left.shape, bool)
    return StereoPair(
        left=left, right=right, gt_disp=gt, gt_valid=gt_valid, name=name
    )


def discover_scenes(root: str):
    """Scene directories under ``root`` that hold a loadable pair."""
    for entry in sorted(os.listdir(root)):
        d = os.path.join(root, entry)
        if os.path.isdir(d) and _first_existing(
            d, ["im0.png", "im2.png", "im2.ppm", "view1.png"]
        ):
            yield d
