# Verbatim numpy copy of stereo_tpu/eval/metrics.py (the port imports no jax).
"""Disparity quality metrics: bad-delta, EPE, density.

Definitions (BASELINE.json:2, SURVEY.md §6):
  * bad-delta — share of evaluated pixels with |d - d_gt| > delta (the
    headline quality metric at delta = 3.0);
  * EPE — mean absolute disparity error over evaluated pixels;
  * density — share of GT-valid pixels where the estimate itself is valid.

Convention: bad/EPE are computed over pixels that are valid in BOTH the
ground truth and the estimate (matching how sparse-GT KITTI evaluation
treats non-estimated pixels when density is reported separately).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def evaluate_disparity(
    disp: np.ndarray,
    gt_disp: np.ndarray,
    gt_valid: Optional[np.ndarray] = None,
    est_valid: Optional[np.ndarray] = None,
    deltas=(1.0, 2.0, 3.0),
) -> Dict[str, float]:
    disp = np.asarray(disp, dtype=np.float32)
    gt_disp = np.asarray(gt_disp, dtype=np.float32)
    if gt_valid is None:
        gt_valid = np.isfinite(gt_disp) & (gt_disp > 0)
    if est_valid is None:
        est_valid = np.ones_like(gt_valid)
    gt_valid = np.asarray(gt_valid, dtype=bool)
    est_valid = np.asarray(est_valid, dtype=bool)

    both = gt_valid & est_valid
    n_gt = int(gt_valid.sum())
    n_both = int(both.sum())
    out: Dict[str, float] = {
        "density": (n_both / n_gt) if n_gt else 0.0,
        "n_eval": float(n_both),
    }
    if n_both == 0:
        for dl in deltas:
            out[f"bad{dl:g}"] = 1.0
        out["epe"] = float("inf")
        return out

    err = np.abs(disp[both] - gt_disp[both])
    for dl in deltas:
        out[f"bad{dl:g}"] = float((err > dl).mean())
    out["epe"] = float(err.mean())
    # KITTI 2015 official D1: error > 3 px AND > 5% of the true disparity.
    gt = gt_disp[both]
    out["d1"] = float(((err > 3.0) & (err > 0.05 * np.abs(gt))).mean())
    return out
