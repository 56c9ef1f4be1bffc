"""Census-Hamming, rank and SAD cost volumes (plain torch).

Twin of ``stereo_tpu/ops/cost.py``: the volume is ``[H, W, D]`` with lane d
searching disparity ``min_disparity + d``. For a block of a larger frame
(``parallel/bands.py``) the right-view quantity is ``[H, W + ctx, ...]``:
``right_context`` = ctx frame-true columns precede the block, lane d of
column x samples block column ``x + ctx - md - d`` clamped at 0, and
entries whose GLOBAL column ``x_offset + x - md - d`` is negative take
``max_unary_cost`` so they never win WTA. Whole frames are ``x_offset = 0``,
``right_context = 0``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import StereoConfig
from .census import (
    census_transform_plain,
    hamming_distance,
    rank_transform_plain,
)


#: Voxels per row chunk of the descriptor costs: the gathered [rows, W, D,
#: words] int64 temporaries of one chunk stay near 1 GB, so a 1988x2880x256
#: volume (1.47 G voxels) fits a card's memory in the plain version too.
_CHUNK_VOXELS = 1 << 26


def shifted_index(w: int, num_disparities: int, min_disparity: int,
                  device, ctx: int = 0) -> torch.Tensor:
    """[W, D] right-view column read by (x, lane d):
    max(x + ctx - md - d, 0)."""
    xs = torch.arange(w, device=device)[:, None]
    ds = torch.arange(num_disparities, device=device)[None, :]
    return (xs + ctx - min_disparity - ds).clamp(min=0)


def invalid_mask(w: int, num_disparities: int, min_disparity: int,
                 device, x_offset: int = 0) -> torch.Tensor:
    """[W, D] bool, True where the global x_offset + x - md - d < 0 (no
    right sample)."""
    xs = x_offset + torch.arange(w, device=device)[:, None]
    ds = torch.arange(num_disparities, device=device)[None, :]
    return xs < min_disparity + ds


def _descriptor_cost(dl: torch.Tensor, dr: torch.Tensor, cfg: StereoConfig,
                     combine, x_offset: int, right_context: int
                     ) -> torch.Tensor:
    """[H, W, D] int32 ``combine(left[:, :, None], right[:, idx])`` of a
    left [H, W, ...] and a right [H, W + ctx, ...] descriptor plane, rows in
    chunks, with the globally invalid entries at ``max_unary_cost``."""
    h, w = dl.shape[:2]
    if dr.shape[0] != h or dr.shape[1] != w + right_context:
        raise ValueError(
            f"right descriptors {tuple(dr.shape)} do not match left "
            f"{tuple(dl.shape)} with right_context={right_context}")
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    idx = shifted_index(w, d, md, dl.device, right_context)
    bad = invalid_mask(w, d, md, dl.device, x_offset)[None]
    rows = max(1, _CHUNK_VOXELS // (w * d))
    return torch.cat([
        combine(dl[y:y + rows, :, None], dr[y:y + rows][:, idx]).masked_fill(
            bad, cfg.max_unary_cost)
        for y in range(0, h, rows)
    ])


def census_cost_from_descriptors(
    cl: torch.Tensor, cr: torch.Tensor, cfg: StereoConfig, x_offset: int = 0,
    right_context: int = 0,
) -> torch.Tensor:
    """[H, W, D] int32 Hamming costs of a left [H, W, words] and a right
    [H, W + right_context, words] descriptor plane."""
    return _descriptor_cost(cl, cr, cfg, hamming_distance, x_offset,
                            right_context)


def census_cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
    x_offset: int = 0, right_context: int = 0,
) -> torch.Tensor:
    """Census-Hamming cost volume. ``right`` is [H, W + right_context]; the
    transform runs on it whole, so with context >= D - 1 + the census
    radius the interior costs are the whole frame's. Returns [H, W, D]
    int32 in [0, bits]."""
    cl = census_transform_plain(left, cfg.census_window)
    cr = census_transform_plain(right, cfg.census_window)
    return census_cost_from_descriptors(cl, cr, cfg, x_offset, right_context)


def _abs_rank_diff(rl: torch.Tensor, rr: torch.Tensor) -> torch.Tensor:
    return (rl.to(torch.int32) - rr.to(torch.int32)).abs()


def rank_cost_from_descriptors(
    rl: torch.Tensor, rr: torch.Tensor, cfg: StereoConfig, x_offset: int = 0,
    right_context: int = 0,
) -> torch.Tensor:
    """[H, W, D] int32 absolute rank differences of a left [H, W] and a
    right [H, W + right_context] rank map."""
    return _descriptor_cost(rl, rr, cfg, _abs_rank_diff, x_offset,
                            right_context)


def rank_cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
    x_offset: int = 0, right_context: int = 0,
) -> torch.Tensor:
    """Rank-transform cost volume |rank_l(x) - rank_r(x - md - d)| over
    ``cfg.census_window``; framing as in ``census_cost_volume``. Returns
    [H, W, D] int32 in [0, window area - 1]."""
    rl = rank_transform_plain(left, cfg.census_window)
    rr = rank_transform_plain(right, cfg.census_window)
    return rank_cost_from_descriptors(rl, rr, cfg, x_offset, right_context)


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
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
    x_offset: int = 0, right_context: int = 0,
) -> torch.Tensor:
    """SAD block-matching cost volume: the window sum of
    ``|L(y, x) - R(y, max(x + ctx - md - d, 0))|`` with the AD array (not
    the image) edge-replicated, floor-divided by the window area, and
    ``max_unary_cost`` where the global ``x_offset + x - md - d < 0``.
    Returns [H, W, D] int32 in [0, 255]."""
    w = left.shape[1]
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    idx = shifted_index(w, d, md, left.device, right_context)
    l32 = left.to(torch.int32)
    ad = (l32[:, :, None] - right.to(torch.int32)[:, idx]).abs()  # [H, W, D]
    area = cfg.sad_window[0] * cfg.sad_window[1]
    summed = (box_sum(ad, cfg.sad_window) // area).to(torch.int32)
    bad = invalid_mask(w, d, md, left.device, x_offset)
    return summed.masked_fill(bad[None], cfg.max_unary_cost)


def cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
    x_offset: int = 0, right_context: int = 0,
) -> torch.Tensor:
    """Dispatch on ``cfg.cost_fn``. Returns [H, W, D] int32."""
    if cfg.cost_fn == "census":
        return census_cost_volume(left, right, cfg, x_offset, right_context)
    if cfg.cost_fn == "rank":
        return rank_cost_volume(left, right, cfg, x_offset, right_context)
    return sad_cost_volume(left, right, cfg, x_offset, right_context)
