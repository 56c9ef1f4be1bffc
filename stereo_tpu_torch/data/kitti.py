"""KITTI 2015 stereo frames (configs 3 and 5).

Twin of ``stereo_tpu/data/kitti.py`` (numpy and PIL); gives the
reference's arrays bit for bit. Layout of the training split:
  <root>/image_2/000000_10.png     left frame
  <root>/image_3/000000_10.png     right frame
  <root>/disp_noc_0/000000_10.png  ground-truth disparity, uint16 PNG,
                                   value / 256, 0 = invalid.

``frame_pairs`` yields the _10 and _11 frames of each id in turn, the
stream that ``StreamRunner`` and the CLI's ``stream --kitti`` consume.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .middlebury import load_image_gray
from .synthetic import StereoPair


def read_kitti_disparity(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(disp float32, valid bool) from a KITTI uint16 disparity PNG."""
    from PIL import Image

    raw = np.asarray(Image.open(path))
    if raw.dtype != np.uint16:
        raise ValueError(f"{path}: expected uint16 PNG, got {raw.dtype}")
    disp = raw.astype(np.float32) / 256.0
    return disp, raw > 0


def write_kitti_disparity(path: str, disp: np.ndarray, valid: np.ndarray) -> None:
    """Write disparity in the KITTI uint16 convention (0 = invalid)."""
    from PIL import Image

    q = np.clip(np.round(disp * 256.0), 1, 65535).astype(np.uint16)
    q = np.where(valid, q, 0).astype(np.uint16)
    Image.fromarray(q, mode="I;16").save(path)


def load_kitti_pair(root: str, frame_id: str, occluded: bool = False) -> StereoPair:
    """One training pair by id, e.g. '000000_10'."""
    left = load_image_gray(os.path.join(root, "image_2", frame_id + ".png"))
    right = load_image_gray(os.path.join(root, "image_3", frame_id + ".png"))
    gt_dir = "disp_occ_0" if occluded else "disp_noc_0"
    gt_path = os.path.join(root, gt_dir, frame_id + ".png")
    if os.path.exists(gt_path):
        gt, gt_valid = read_kitti_disparity(gt_path)
    else:
        gt = np.zeros(left.shape, np.float32)
        gt_valid = np.zeros(left.shape, bool)
    return StereoPair(left, right, gt, gt_valid, name=f"kitti-{frame_id}")


def list_frame_ids(root: str) -> list:
    """The ids of the left frames ``*_10.png``, sorted."""
    return sorted(
        os.path.basename(p)[:-4]
        for p in glob.glob(os.path.join(root, "image_2", "*_10.png"))
    )


def frame_pairs(
    root: str, limit: Optional[int] = None
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(left, right) uint8 frames for streaming: _10 then _11 of each id,
    pairs with a missing side skipped, at most ``limit`` of them."""
    count = 0
    for fid in list_frame_ids(root):
        for suffix in ("_10", "_11"):
            stem = fid[:-3] + suffix
            lp = os.path.join(root, "image_2", stem + ".png")
            rp = os.path.join(root, "image_3", stem + ".png")
            if not (os.path.exists(lp) and os.path.exists(rp)):
                continue
            yield load_image_gray(lp), load_image_gray(rp)
            count += 1
            if limit is not None and count >= limit:
                return
