"""Census-Hamming cost volume (plain torch).

Twin of ``stereo_tpu/ops/cost.py`` for whole frames: the volume is
``[H, W, D]`` with lane d searching disparity ``min_disparity + d``; the
right-view sample column ``x - md - d`` is clamped at 0, and entries whose
column is negative take ``max_unary_cost`` so they never win WTA.
"""

from __future__ import annotations

import torch

from ..config import StereoConfig
from .census import census_transform, hamming_distance


def shifted_index(w: int, num_disparities: int, min_disparity: int,
                  device) -> torch.Tensor:
    """[W, D] right-view column read by (x, lane d): max(x - md - d, 0)."""
    xs = torch.arange(w, device=device)[:, None]
    ds = torch.arange(num_disparities, device=device)[None, :]
    return (xs - min_disparity - ds).clamp(min=0)


def invalid_mask(w: int, num_disparities: int, min_disparity: int,
                 device) -> torch.Tensor:
    """[W, D] bool, True where x - md - d < 0 (no right sample)."""
    xs = torch.arange(w, device=device)[:, None]
    ds = torch.arange(num_disparities, device=device)[None, :]
    return xs < min_disparity + ds


def census_cost_from_descriptors(
    cl: torch.Tensor, cr: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """[H, W, D] int32 Hamming costs of [H, W, words] descriptor planes."""
    w = cl.shape[1]
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    idx = shifted_index(w, d, md, cl.device)
    cost = hamming_distance(cl[:, :, None, :], cr[:, idx])
    bad = invalid_mask(w, d, md, cl.device)
    return cost.masked_fill(bad[None], cfg.max_unary_cost)


def census_cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """Census-Hamming cost volume. Returns [H, W, D] int32 in [0, bits]."""
    cl = census_transform(left, cfg.census_window)
    cr = census_transform(right, cfg.census_window)
    return census_cost_from_descriptors(cl, cr, cfg)
