"""Disparity post-processing: cheap LR consistency and the 3x3 median
(plain torch).

Twin of ``stereo_tpu/ops/postprocess.py`` for whole frames. The right-view
map re-indexes the aggregated left volume, S_R(y, xr, d) = S(y, xr+md+d, d);
lanes whose source column leaves the frame never win, and a column with no
lane left takes winner 0. The LR test compares integer winners.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import StereoConfig
from .wta import first_argmin, wta_with_aux

#: Median-of-9 exchange network (Paeth): after these swaps v[4] is the
#: median. Same order as the reference's.
MEDIAN_NET = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)


def right_disparity_from_volume(s: torch.Tensor, cfg: StereoConfig
                                ) -> torch.Tensor:
    """[H, W] float32 right-view WTA disparity (md included): the first
    argmin lane of S(y, xr+md+d, d) over in-frame lanes (lane 0 for a
    column with none), plus md."""
    h, w, d = s.shape
    md = int(cfg.min_disparity)
    s = s.to(torch.int32)
    src = (torch.arange(w, device=s.device)[:, None] + md
           + torch.arange(d, device=s.device)[None, :])        # [W, D]
    oof = src >= w
    lanes = torch.arange(d, device=s.device)[None, :].expand(w, d)
    s_r = s[:, src.clamp(max=w - 1), lanes]                    # [H, W, D]
    # The reference fills out-of-frame lanes with iinfo.max // 2, which
    # no aggregate reaches; all-out columns then tie at lane 0.
    s_r = s_r.masked_fill(oof[None], torch.iinfo(torch.int32).max // 2)
    return (first_argmin(s_r)[1] + md).to(torch.float32)


def lr_consistency(disp_l: torch.Tensor, disp_r: torch.Tensor,
                   cfg: StereoConfig) -> torch.Tensor:
    """[H, W] bool: |d_L(x) - d_R(x - round(d_L(x)))| <= tau and the
    correspondence x - round(d_L(x)) is in frame. Lookup offsets outside
    [md, md + D) clamp to the nearest disparity plane, as the reference's
    one-hot select does."""
    h, w = disp_l.shape
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    xs = torch.arange(w, device=disp_l.device)[None, :]
    xr = torch.round(xs - disp_l).to(torch.int64)
    in_frame = (xr >= 0) & (xr < w)
    shift = (xs - xr).clamp(md, md + d - 1)
    d_r_at = torch.gather(disp_r, 1, (xs - shift).clamp(0, w - 1))
    tau = torch.tensor(cfg.lr_tau, dtype=torch.float32, device=disp_l.device)
    return ((disp_l - d_r_at).abs() <= tau) & in_frame


def median_3x3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median with replicated edges, by the 19-exchange network."""
    h, w = disp.shape
    rows = torch.arange(h, device=disp.device)
    cols = torch.arange(w, device=disp.device)
    v = []
    for dy in (-1, 0, 1):
        r = disp[(rows + dy).clamp(0, h - 1)]
        for dx in (-1, 0, 1):
            v.append(r[:, (cols + dx).clamp(0, w - 1)])
    for i, j in MEDIAN_NET:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def apply_postprocess(
    disp: torch.Tensor,
    valid: torch.Tensor,
    s: torch.Tensor,
    cfg: StereoConfig,
    disp_int: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cheap LR check + median, per config. Returns (disp, valid).

    The LR check compares INTEGER winners (``disp_int``; falls back to
    rounding ``disp``), as in standard SGM.
    """
    if cfg.lr_check and not cfg.lr_exact:
        disp_r = right_disparity_from_volume(s, cfg)
        d_l = disp_int if disp_int is not None else torch.round(disp)
        valid = valid & lr_consistency(d_l, disp_r, cfg)
    if cfg.median_filter:
        disp = median_3x3(disp)
    return disp, valid


def select_disparity(s: torch.Tensor, cfg: StereoConfig, emit_d0: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """WTA + subpixel + uniqueness + cheap LR on S, median excluded: the
    plain version of the ``sgm_select`` kernel. Returns (disp, valid), or
    with ``emit_d0`` (disp, valid, d0) where d0 is the [H, W] int32 integer
    winner lane (md excluded). With ``cfg.lr_exact`` the cheap LR check is
    off: the caller compares against the right view's own winners."""
    disp, valid, d_int = wta_with_aux(s, cfg)
    disp, valid = apply_postprocess(
        disp, valid, s, cfg.replace(median_filter=False), disp_int=d_int
    )
    if emit_d0:
        return disp, valid, (d_int - cfg.min_disparity).to(torch.int32)
    return disp, valid
