"""Winner-take-all disparity selection + subpixel refinement (plain torch).

Twin of ``stereo_tpu/ops/wta.py``. The only float steps are the uniqueness
product and the subpixel parabola; both are single IEEE float32 operations
on integer-valued operands, done here in the reference's order, so the
result is bit-identical:

    unique  <=>  f32(c2) > f32(c0) * f32(1 + ratio)
    offset   =  f32(cm - cp) / f32(2 * max(denom, 1)),
                denom = cp + cm - 2 c0  (offset 0 where denom <= 0)
    disp     =  (f32(d0) + clip(offset, -0.5, 0.5)) + f32(md)

The reference's ``big`` sentinel (``iinfo.max``) is never added to here:
out-of-range lanes are masked instead, so no integer overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import StereoConfig

#: The reference's integer sentinel for lanes outside the +-1 uniqueness
#: exclusion (``jnp.iinfo(int32).max``); only ever compared, never added to.
_BIG = torch.iinfo(torch.int32).max


def first_argmin(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, first index of the min) over the last axis, ties to the
    smallest index."""
    d = s.shape[-1]
    c0 = s.min(dim=-1).values
    ds = torch.arange(d, device=s.device, dtype=torch.int32)
    d0 = torch.where(s == c0[..., None], ds, d).min(dim=-1).values
    return c0, d0


def wta_with_aux(
    s: torch.Tensor, cfg: StereoConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select disparities from the aggregated volume.

    Args:
      s: [H, W, D] integer aggregated (or raw) cost volume.

    Returns:
      disp: [H, W] float32 (subpixel-refined if cfg.subpixel), md included.
      valid: [H, W] bool (False where the uniqueness test rejects).
      disp_int: [H, W] float32 integer winner, md included.
    """
    s = s.to(torch.int32)
    d = s.shape[-1]
    ds = torch.arange(d, device=s.device, dtype=torch.int32)
    c0, d0 = first_argmin(s)

    valid = torch.ones(d0.shape, dtype=torch.bool, device=s.device)
    if cfg.uniqueness_ratio > 0:
        near = (ds - d0[..., None]).abs() <= 1
        c2 = s.masked_fill(near, _BIG).min(dim=-1).values
        # f32(1 + ratio) is rounded before the multiply, as JAX rounds its
        # weak-typed scalar; a Python float here could multiply in double.
        f = torch.tensor(1.0 + cfg.uniqueness_ratio, dtype=torch.float32,
                         device=s.device)
        valid = c2.to(torch.float32) > c0.to(torch.float32) * f

    disp = d0.to(torch.float32)
    if cfg.subpixel and d > 1:
        lo = (d0 - 1).clamp(min=0).long()[..., None]
        hi = (d0 + 1).clamp(max=d - 1).long()[..., None]
        cm = torch.gather(s, -1, lo)[..., 0]
        cp = torch.gather(s, -1, hi)[..., 0]
        denom = cp + cm - 2 * c0
        offset = torch.where(
            denom > 0,
            (cm - cp).to(torch.float32)
            / (2 * denom.clamp(min=1)).to(torch.float32),
            0.0,
        ).clamp(-0.5, 0.5)
        interior = (d0 > 0) & (d0 < d - 1)
        disp = disp + torch.where(interior, offset, 0.0)

    disp = disp + cfg.min_disparity
    disp_int = (d0 + cfg.min_disparity).to(torch.float32)
    return disp, valid, disp_int
