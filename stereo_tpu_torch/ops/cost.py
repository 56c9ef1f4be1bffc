"""Census-Hamming, rank and SAD cost volumes (plain torch).

Twin of ``stereo_tpu/ops/cost.py`` for whole frames: the volume is
``[H, W, D]`` with lane d searching disparity ``min_disparity + d``; the
right-view sample column ``x - md - d`` is clamped at 0, and entries whose
column is negative take ``max_unary_cost`` so they never win WTA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import StereoConfig
from .census import census_transform, hamming_distance, rank_transform


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


def rank_cost_from_descriptors(
    rl: torch.Tensor, rr: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """[H, W, D] int32 absolute rank differences of two [H, W] rank maps."""
    w = rl.shape[1]
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    idx = shifted_index(w, d, md, rl.device)
    cost = (rl.to(torch.int32)[:, :, None] - rr.to(torch.int32)[:, idx]).abs()
    bad = invalid_mask(w, d, md, rl.device)
    return cost.masked_fill(bad[None], cfg.max_unary_cost)


def rank_cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """Rank-transform cost volume |rank_l(x) - rank_r(x - md - d)| over
    ``cfg.census_window``. Returns [H, W, D] int32 in [0, window area - 1]."""
    rl = rank_transform(left, cfg.census_window)
    rr = rank_transform(right, cfg.census_window)
    return rank_cost_from_descriptors(rl, rr, cfg)


def box_sum(img: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Windowed box sum of an [H, W] or [H, W, C] integer array with
    edge-replicated borders, by separable prefix sums. Returns the same
    shape in int64."""
    wy, wx = window
    ry, rx = wy // 2, wx // 2
    h, w = img.shape[:2]
    rows = torch.arange(-ry, h + ry, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-rx, w + rx, device=img.device).clamp(0, w - 1)
    cs = img[rows][:, cols].to(torch.int64).cumsum(dim=0)
    rowsum = cs[wy - 1:].clone()                        # [H, W + 2rx, ...]
    rowsum[1:] -= cs[:-wy]
    cs = rowsum.cumsum(dim=1)
    out = cs[:, wx - 1:].clone()
    out[:, 1:] -= cs[:, :-wx]
    return out


def sad_cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """SAD block-matching cost volume: the window sum of
    ``|L(y, x) - R(y, max(x - md - d, 0))|`` with the AD array (not the
    image) edge-replicated, floor-divided by the window area, and
    ``max_unary_cost`` where ``x - md - d < 0``. Returns [H, W, D] int32
    in [0, 255]."""
    w = left.shape[1]
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    idx = shifted_index(w, d, md, left.device)
    l32 = left.to(torch.int32)
    ad = (l32[:, :, None] - right.to(torch.int32)[:, idx]).abs()  # [H, W, D]
    area = cfg.sad_window[0] * cfg.sad_window[1]
    summed = (box_sum(ad, cfg.sad_window) // area).to(torch.int32)
    bad = invalid_mask(w, d, md, left.device)
    return summed.masked_fill(bad[None], cfg.max_unary_cost)


def cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """Dispatch on ``cfg.cost_fn``. Returns [H, W, D] int32."""
    if cfg.cost_fn == "census":
        return census_cost_volume(left, right, cfg)
    if cfg.cost_fn == "rank":
        return rank_cost_volume(left, right, cfg)
    return sad_cost_volume(left, right, cfg)
