"""Coarse-to-fine pyramid SGM; twin of ``stereo_tpu/models/pyramid.py``.

SGM cost scales with H*W*D. A half-resolution pass with D/2 disparities
costs 1/8th of the full volume and already localizes disparity to a few
pixels; the full-resolution pass then only searches a residual window of R
offsets around the upsampled coarse estimate:

  * coarse pass: the ordinary pipeline on 2x2-mean-pooled images;
  * residual pass: census descriptors of both images in their own frames,
    the right ones gathered at x - base(x) - o for o in [-R/2, R/2); the
    [H, W, R] residual volume is aggregated by the same SGM with
    min_disparity = -R/2, and the final disparity is base + residual.

On CUDA tensors the coarse pass runs the pipeline's kernels, the census
descriptors of the residual pass come from K1's transform stage (through
``census_transform``), the residual volume is plain torch (an index
gather, as it is plain XLA on the TPU; the
reference's one-hot matmul form exists because the TPU cannot gather), its
aggregation is ``sgm_paths`` at D = R (the staged S of the reference's
``sgm_aggregate_pallas``), then ``sgm_select`` and ``median3x3``.

Accuracy: exact where the true disparity lies within R/2 of the coarse
estimate; coarse errors beyond that and SGM smoothing in residual space
cost a few percent of bad-3 on discontinuity-heavy scenes. The classic
model is the reference-parity path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import KITTI_SGM8_128, StereoConfig
from ..ops import census_transform, hamming_distance, median_3x3, sgm_aggregate
from ..ops.census import census_transform_plain
from ..ops.cuda import median3x3
from ..ops.wta import wta_with_aux
from ..pipeline import (
    StereoResult,
    compute_disparity,
    kernel_select,
    use_kernels,
)
from .base import StereoModel


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices of an axis of length n padded by edge replication."""
    return torch.arange(-before, n + after, device=device).clamp(0, n - 1)


def _pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling to uint8 (odd extents padded by edge replication;
    the float32 mean is truncated, as the reference's astype)."""
    h, w = img.shape
    rows = _edge_index(h, 0, h % 2, img.device)
    cols = _edge_index(w, 0, w % 2, img.device)
    p = img.to(torch.float32)[rows][:, cols]
    pooled = p.reshape(len(rows) // 2, 2, len(cols) // 2, 2).mean(dim=(1, 3))
    return pooled.to(torch.uint8)


def _upsample2(base: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of a coarse disparity, scaled by 2."""
    up = base.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[:h, :w] * 2.0


def _local_minmax_center(base: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Centre of the local disparity spread, round((minpool_k + maxpool_k)
    / 2) with ties to even: a window of R then covers a local spread of up
    to R at discontinuities."""
    r = k // 2
    h, w = base.shape
    p = base[_edge_index(h, r, r, base.device)][
        :, _edge_index(w, r, r, base.device)][None, None]
    mx = F.max_pool2d(p, k, stride=1)[0, 0]
    mn = -F.max_pool2d(-p, k, stride=1)[0, 0]
    return torch.round((mn + mx) * 0.5)


def _residual_cost_volume(cl: torch.Tensor, cr: torch.Tensor,
                          base_i: torch.Tensor, half: int, r: int
                          ) -> torch.Tensor:
    """vol[y, x, o] = hamming(cl[y, x], cr[y, clip(x - base - (o - half))]),
    [H, W, R] int32: one index gather of the right descriptors over all R
    offsets (the reference's ``gather`` form)."""
    h, w = base_i.shape
    dev = base_i.device
    xs = torch.arange(w, device=dev)[None, :, None]
    offs = torch.arange(r, device=dev)[None, None, :] - half
    src = (xs - base_i.to(torch.int64)[:, :, None] - offs).clamp(0, w - 1)
    rows = torch.arange(h, device=dev)[:, None, None]
    return hamming_distance(cl[:, :, None, :], cr[rows, src])


class PyramidSGM(StereoModel):
    name = "pyramid"

    def __init__(
        self,
        cfg: StereoConfig = KITTI_SGM8_128,
        residual_range: int = 16,
        census_window=None,
    ):
        """``census_window``: None (default) inherits ``cfg``'s window; a
        caller trading quality for speed passes the 1-word ``(5, 5)``
        descriptor explicitly."""
        super().__init__(cfg)
        if residual_range % 2:
            raise ValueError("residual_range must be even")
        self.residual_range = residual_range
        if census_window is not None:
            self.cfg = self.cfg.replace(census_window=tuple(census_window))

    def coarse_cfg(self) -> StereoConfig:
        """The half-resolution pass's config: D/2 disparities, integer
        winners, median, no LR check (its validity mask is discarded)."""
        return self.cfg.replace(
            num_disparities=max(8, self.cfg.num_disparities // 2),
            lr_check=False,
            median_filter=True,
            subpixel=False,
        )

    def residual_volume(self, left: torch.Tensor, right: torch.Tensor):
        """The coarse pass and the residual cost volume around it.

        Returns (base, vol, res_cfg): the [H, W] float32 centre of each
        pixel's search window, the [H, W, R] int32 cost volume whose lane o
        searches disparity base + o - R/2, and the config its aggregation
        and selection run under (D = R, min_disparity = -R/2, no LR).
        """
        cfg = self.cfg
        r = self.residual_range
        half = r // 2
        h, w = left.shape
        d = cfg.num_disparities

        # --- coarse pass at half resolution, D/2 ---
        res_c = compute_disparity(_pool2(left), _pool2(right),
                                  self.coarse_cfg())
        base = _local_minmax_center(_upsample2(res_c.disp, h, w))

        # --- residual volume at full resolution over [-r/2, r/2) ---
        transform = (census_transform if use_kernels(cfg, left.device)
                     else census_transform_plain)
        cl = transform(left, cfg.census_window)
        cr = transform(right, cfg.census_window)
        base = base.clamp(0, d - 1)
        base_i = torch.round(base).to(torch.int32)
        vol = _residual_cost_volume(cl, cr, base_i, half, r)
        # invalid where the total disparity leaves the image or the search
        # range of the classic model (float compares, as the reference's)
        total = base[:, :, None] + (torch.arange(r, device=left.device) - half)
        xs = torch.arange(w, device=left.device)[None, :, None]
        invalid = (xs - total < 0) | (total < 0) | (total > d - 1)
        vol = vol.masked_fill(invalid, cfg.max_unary_cost)
        res_cfg = cfg.replace(
            num_disparities=r, min_disparity=-half, lr_check=False
        )
        return base, vol, res_cfg

    def _forward(self, left: torch.Tensor, right: torch.Tensor
                 ) -> StereoResult:
        cfg = self.cfg
        base, vol, res_cfg = self.residual_volume(left, right)
        on_kernels = use_kernels(cfg, left.device)
        if on_kernels:
            disp_r, ok = kernel_select(
                vol.to(res_cfg.cost_volume_dtype), res_cfg, left)
        else:
            s = sgm_aggregate(vol, res_cfg, image=left)
            disp_r, ok, _ = wta_with_aux(s, res_cfg)
        disp = base + disp_r
        ok = ok & (disp >= 0) & (disp <= cfg.num_disparities - 1)
        if cfg.median_filter:
            disp = median3x3(disp) if on_kernels else median_3x3(disp)
        return StereoResult(disp=disp, valid=ok)

    def build(self, device="cuda"):
        device = torch.device(device)

        def run(left, right) -> StereoResult:
            return self._forward(torch.as_tensor(left).to(device),
                                 torch.as_tensor(right).to(device))

        return run
