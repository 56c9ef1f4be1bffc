"""K2 and K3 wrappers: SGM path aggregation (csrc/sgm_paths.cu) and
disparity selection (csrc/sgm_select.cu).

K2 replaces ``stereo_tpu/ops/pallas/sgm_kernel.py:_h_kernel``,
``_v_kernel`` and the path half of ``_v_fused_kernel``; K3 replaces the
selection epilogue of ``_v_fused_kernel`` (its base form). Together they
compute what ``sgm_wta_fused_pallas`` does, with S materialized once in
int16 between them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...config import StereoConfig
from ..postprocess import select_disparity
from ..sgm import PATH_STEPS, sgm_aggregate
from .launch import on_cpu, require, require_disparities, run


def _check_int16_bound(cfg: StereoConfig) -> None:
    """Each path cost is at most max_unary_cost + P2, so S fits int16 iff
    num_paths * (max_unary_cost + P2) < 2^15."""
    bound = cfg.num_paths * (cfg.max_unary_cost + cfg.p2)
    if bound >= 1 << 15:
        raise ValueError(f"int16 SGM sum may overflow: bound {bound}")


def sgm_paths(cost: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """[H, W, D] int16 S = sum of the cfg.num_paths (4 or 8) path costs of
    an int8 cost volume: one kernel launch per direction. CPU tensors take
    the plain version (``ops.sgm.sgm_aggregate``)."""
    if cfg.num_paths not in (4, 8):
        raise ValueError(f"sgm_paths needs 4 or 8 paths, got {cfg.num_paths}")
    if cfg.adaptive_p2:
        raise NotImplementedError(
            "adaptive_p2 is not ported yet (ROADMAP Queue 2: adaptive-P2 "
            "forms of K2)"
        )
    _check_int16_bound(cfg)
    if on_cpu(cost):
        return sgm_aggregate(cost, cfg).to(torch.int16)
    require(cost, "cost", torch.int8, 3)
    h, w, d = cost.shape
    require_disparities(d)
    s = torch.empty((h, w, d), dtype=torch.int16, device=cost.device)
    for i, (step_y, step_x) in enumerate(PATH_STEPS[: cfg.num_paths]):
        run("stpu_sgm_path", cost.device, cost.data_ptr(), s.data_ptr(),
            h, w, d, step_y, step_x, cfg.p1, cfg.p2, int(i > 0))
        sgm_paths.launches += 1
    return s


sgm_paths.launches = 0


def sgm_select(s: torch.Tensor, cfg: StereoConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(disp [H, W] float32, valid [H, W] bool) from S: first-min WTA,
    uniqueness, subpixel and the cheap LR check, median excluded. CPU
    tensors take the plain version (``ops.postprocess.select_disparity``)."""
    if cfg.lr_exact:
        raise NotImplementedError(
            "lr_exact is not ported yet (ROADMAP Queue 2: _v_fused_kernel "
            "emit_d0)"
        )
    if on_cpu(s):
        return select_disparity(s, cfg)
    require(s, "s", torch.int16, 3)
    h, w, d = s.shape
    require_disparities(d)
    if cfg.min_disparity < 0:
        raise ValueError("the CUDA select kernel needs min_disparity >= 0")
    disp = torch.empty((h, w), dtype=torch.float32, device=s.device)
    valid = torch.empty((h, w), dtype=torch.bool, device=s.device)
    run("stpu_sgm_select", s.device, s.data_ptr(), disp.data_ptr(),
        valid.data_ptr(), h, w, d, int(cfg.min_disparity), int(cfg.subpixel),
        int(cfg.uniqueness_ratio > 0), 1.0 + cfg.uniqueness_ratio,
        int(cfg.lr_check), cfg.lr_tau)
    sgm_select.launches += 1
    return disp, valid


sgm_select.launches = 0
