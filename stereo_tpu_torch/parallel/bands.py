"""Single-device row-band and column-patch processing for frames too large
to process whole.

Twin of ``stereo_tpu/parallel/bands.py``. Config 4 (2880x1988 at 256
disparities) has a 1.5 G-voxel cost volume; this runner splits the frame
into horizontal bands, and optionally column patches, processed one after
the other, each extended by a warm-up halo:

  * horizontal SGM paths are exact in a band (bands span the full width);
  * vertical and diagonal paths start fresh at the extended edge: a
    bounded error, measured against the whole frame by the tests;
  * memory scales with the patch, not the frame.

Column patches pass their static global column origin to
``compute_disparity``, so disparity-range masking and LR framing stay
frame-exact; only the SGM warm-up at patch edges is approximate. Two
overlap regimes, as the reference:

  * stitched (the default where supported: census or rank cost with the
    cheap LR check): patches carry only the warm-up halo. The disparity
    search reads frame-true right-image context (``right_context``)
    instead of a +D left halo, and the LR check min-combines each patch's
    partial right-view packed min (``PatchParts.qr`` / ``.spill``) across
    neighbours, re-gating a 2 (D + md) strip per interior edge. The stitch
    itself is plain torch on [H, W] maps, as it is XLA on the TPU;
  * legacy (``lr_stitch=False``, SAD cost, or the exact LR check): halo + D
    on the left for the disparity search, + D on the right when an LR
    check is on.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import StereoConfig, TileConfig
from ..ops.postprocess import BIG, lr_gate_from_right_map, unpack_partial_min
from ..pipeline import StereoResult, compute_disparity, compute_patch_parts


def _spans(size: int, parts: int, lo_halo: int, hi_halo: int):
    """[(start, stop, ext_start, ext_stop)] of ``parts`` equal pieces of
    [0, size): each piece and its extension by the halos, clipped to the
    frame."""
    step = -(-size // parts)
    out = []
    for i in range(parts):
        a, b = i * step, min(size, (i + 1) * step)
        out.append((a, b, max(0, a - lo_halo), min(size, b + hi_halo)))
    return out


class BandPlan(NamedTuple):
    """How a frame is cut: ``rows`` and ``cols`` hold, per band and per
    column patch, (start, stop, extended start, extended stop)."""

    stitched: bool
    halo: int
    rows: List[Tuple[int, int, int, int]]
    cols: List[Tuple[int, int, int, int]]


def right_context_of(cfg: StereoConfig, f0: int) -> int:
    """Right-image context columns of a stitched patch that starts at frame
    column ``f0``: the search reach D - 1 + md, clipped at the frame."""
    return f0 - max(0, f0 - (cfg.num_disparities - 1 + int(cfg.min_disparity)))


def plan_bands(
    cfg: StereoConfig,
    image_shape: Tuple[int, int],
    n_bands: int,
    n_cols: int = 1,
    halo: Optional[int] = None,
    lr_stitch: Optional[bool] = None,
) -> BandPlan:
    """The split ``build_banded_pipeline`` runs, with its checks."""
    h, w = image_shape
    if halo is None:
        halo = TileConfig().resolved_halo(cfg)
    bh = -(-h // n_bands)
    bw = -(-w // n_cols)
    if (n_bands - 1) * bh >= h or (n_cols - 1) * bw >= w:
        raise ValueError(
            f"degenerate split: {n_bands} bands x {n_cols} cols of a "
            f"{h}x{w} frame leaves empty patches; reduce the split counts"
        )
    reach = cfg.num_disparities + int(cfg.min_disparity)
    # Each patch must span at least the search reach D + min_disparity, so
    # that a position's sources straddle at most two patches; the halo must
    # cover the descriptor window, so that the owned columns' partials and
    # the right-context descriptors are frame-true.
    min_pw = min(bw + halo, w - (n_cols - 1) * bw + halo) if n_cols > 1 else w
    stitch_ok = (
        n_cols > 1 and cfg.lr_check and not cfg.lr_exact
        and cfg.num_paths > 0 and cfg.cost_fn in ("census", "rank")
        and min_pw >= reach and halo >= cfg.window_radius
    )
    if lr_stitch is None:
        lr_stitch = stitch_ok
    elif lr_stitch and not stitch_ok:
        raise ValueError(
            "lr_stitch needs n_cols > 1 column patches, the cheap-LR "
            "re-index (lr_check without lr_exact), SGM paths, a "
            "census/rank cost, and a halo covering the descriptor "
            "window radius"
        )
    if lr_stitch:
        cols = _spans(w, n_cols, halo, halo)
    else:
        # Both LR modes read rightward across the patch edge.
        cols = _spans(w, n_cols, halo + reach,
                      halo + (reach if cfg.lr_check else 0))
    return BandPlan(lr_stitch, halo, _spans(h, n_bands, halo, halo), cols)


def build_banded_pipeline(
    cfg: StereoConfig,
    image_shape: Tuple[int, int],
    n_bands: int,
    n_cols: int = 1,
    halo: Optional[int] = None,
    lr_stitch: Optional[bool] = None,
    device="cuda",
):
    """``(left, right) -> StereoResult`` processing row bands (and
    optionally column patches) of a frame of ``image_shape``.

    Args:
      image_shape: (H, W) frame extent.
      n_bands: horizontal bands (peak memory ~ 1 / n_bands).
      n_cols: column patches with static global x offsets.
      halo: warm-up rows and columns; default ``TileConfig`` derives it
        from the config (window radius + 16).
      lr_stitch: force the stitched regime on or off (None: on where
        supported).
      device: where the images are moved and the result stays.
    """
    h, w = image_shape
    device = torch.device(device)
    plan = plan_bands(cfg, image_shape, n_bands, n_cols, halo, lr_stitch)
    band = (_stitched_band if plan.stitched else _overlap_band)(
        cfg, w, plan.cols)

    def banded(left, right) -> StereoResult:
        left = torch.as_tensor(left).to(device)
        right = torch.as_tensor(right).to(device)
        if tuple(left.shape) != (h, w):
            raise ValueError(
                f"banded pipeline built for {(h, w)}, got {tuple(left.shape)}")
        parts = [
            tuple(m[y0 - e0:y1 - e0] for m in band(left[e0:e1], right[e0:e1]))
            for y0, y1, e0, e1 in plan.rows
        ]
        return StereoResult(disp=torch.cat([p[0] for p in parts]),
                            valid=torch.cat([p[1] for p in parts]))

    return banded


def _overlap_band(cfg: StereoConfig, w: int, cols):
    """The legacy regime on one band of rows: every column patch is
    extended by its full overlap, run as a framed ``compute_disparity`` and
    cropped."""

    def band(left, right):
        out = []
        for x0, x1, f0, f1 in cols:
            res = compute_disparity(left[:, f0:f1], right[:, f0:f1], cfg,
                                    x_offset=f0, image_width=w)
            out.append((res.disp[:, x0 - f0:x1 - f0],
                        res.valid[:, x0 - f0:x1 - f0]))
        return (torch.cat([o[0] for o in out], dim=1),
                torch.cat([o[1] for o in out], dim=1))

    return band


def _stitched_band(cfg: StereoConfig, w: int, cols):
    """The stitched regime on one band of rows.

    Each patch carries only the warm-up halo in x and reads
    ``right_context`` frame-true columns of the right image; the LR check
    is reassembled from the patches' partial right-view packed mins:

      1. the full-width map is the elementwise min of every patch's qr
         (over [f0, f1)) and spill (over [f0 - SP, f0), clipped at the
         frame edge), each drawing sources only from the columns the patch
         owns, so every (position, source column) pair is counted once;
      2. pixels within D + md of an interior edge get their LR verdict
         recomputed from the stitched map (their own patch saw a truncated
         one); everywhere else the patch's verdict is already frame-true.
    """
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    reach = d + md
    edges = [x0 for x0, *_ in cols[1:]]

    def band(left, right):
        own, full = [], None
        for x0, x1, f0, f1 in cols:
            ctx = right_context_of(cfg, f0)
            p = compute_patch_parts(
                left[:, f0:f1], right[:, f0 - ctx:f1], cfg, x_offset=f0,
                image_width=w, right_context=ctx, own=(x0 - f0, x1 - f0))
            osl = slice(x0 - f0, x1 - f0)
            own.append((p.disp[:, osl], p.ok_nolr[:, osl], p.lr_bit[:, osl],
                        p.d0[:, osl]))
            maps = [F.pad(p.qr, (f0, w - f1), value=BIG)]
            sa = max(0, f0 - p.spill.shape[1])
            if sa < f0:
                maps.append(F.pad(p.spill[:, p.spill.shape[1] - (f0 - sa):],
                                  (sa, w - f0), value=BIG))
            for m in maps:
                full = m if full is None else torch.minimum(full, m)
        disp, ok_nolr, gate, d0 = (torch.cat([o[i] for o in own], dim=1)
                                   for i in range(4))
        d_r = unpack_partial_min(full, d)
        for xe in edges:
            a, b = max(0, xe - reach), min(w, xe + reach)
            gate[:, a:b] = lr_gate_from_right_map(
                d0[:, a:b], d_r, cfg, x_offset=a, image_width=w, r_offset=0)
        return disp, ok_nolr & gate

    return band
