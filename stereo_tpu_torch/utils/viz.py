"""Disparity visualization: colormap PNG and error-map writers (numpy
only; the port's copy of the reference's ``utils/viz.py``)."""

from __future__ import annotations

import numpy as np

# Compact turbo-like colormap: anchor RGB points, linearly interpolated.
_ANCHORS = np.array(
    [
        [48, 18, 59],
        [70, 107, 227],
        [40, 187, 235],
        [48, 240, 152],
        [164, 252, 59],
        [242, 211, 56],
        [249, 117, 21],
        [200, 35, 2],
        [122, 4, 3],
    ],
    dtype=np.float32,
)


def colorize_disparity(
    disp: np.ndarray,
    valid: np.ndarray | None = None,
    max_disp: float | None = None,
) -> np.ndarray:
    """[H, W] disparity -> [H, W, 3] uint8 (invalid pixels black)."""
    disp = np.asarray(disp, dtype=np.float32)
    if valid is None:
        valid = np.isfinite(disp)
    if max_disp is None:
        max_disp = float(disp[valid].max()) if valid.any() else 1.0
    t = np.clip(disp / max(max_disp, 1e-6), 0.0, 1.0)
    pos = t * (len(_ANCHORS) - 1)
    i0 = np.clip(np.floor(pos).astype(int), 0, len(_ANCHORS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _ANCHORS[i0] * (1 - frac) + _ANCHORS[i0 + 1] * frac
    rgb = np.where(valid[..., None], rgb, 0.0)
    return rgb.astype(np.uint8)


def error_map(
    disp: np.ndarray, gt: np.ndarray, gt_valid: np.ndarray, delta: float = 3.0
) -> np.ndarray:
    """Green = correct, red = bad-delta, black = no GT. [H, W, 3] uint8."""
    err = np.abs(np.asarray(disp) - np.asarray(gt))
    out = np.zeros((*err.shape, 3), dtype=np.uint8)
    ok = gt_valid & (err <= delta)
    bad = gt_valid & (err > delta)
    out[ok] = (40, 180, 70)
    out[bad] = (210, 40, 40)
    return out


def save_png(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)
