"""Disparity post-processing: cheap LR consistency and the 3x3 median
(plain torch).

Twin of ``stereo_tpu/ops/postprocess.py``. The right-view map re-indexes
the aggregated left volume, S_R(y, xr, d) = S(y, xr+md+d, d); lanes whose
source column leaves the frame never win, and a column with no lane left
takes winner 0. The LR test compares integer winners. For a column patch
of a larger frame (``parallel/bands.py``) the functions take the patch's
global origin and the frame's width, and the packed partial mins
(``right_view_partial_min``, ``right_view_spill``) let neighbouring
patches min-combine into the frame's right-view map. The reference
selects by one-hot sweeps to avoid gathers on a TPU; here the same clamped
lookups are gathers.
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


#: The reference's float32 sentinel for an empty packed min.
BIG = 3e38


def _pack_radix(num_disparities: int) -> int:
    """The smallest power of two >= D: the radix of a packed min."""
    return 1 << max(0, (num_disparities - 1).bit_length())


def right_disparity_from_volume(
    s: torch.Tensor, cfg: StereoConfig, x_offset: int = 0,
    image_width: Optional[int] = None,
) -> torch.Tensor:
    """[H, W] float32 right-view WTA disparity (md included): the first
    argmin lane of S(y, min(xr+md+d, W-1), d) over the lanes whose global
    source column ``x_offset + xr + md + d`` is below ``image_width`` (lane
    0 for a column with none), plus md. ``x_offset`` / ``image_width``
    place the block in a larger frame; the defaults are the whole frame."""
    h, w, d = s.shape
    md = int(cfg.min_disparity)
    if image_width is None:
        image_width = w
    s = s.to(torch.int32)
    src = (torch.arange(w, device=s.device)[:, None] + md
           + torch.arange(d, device=s.device)[None, :])        # [W, D]
    oof = x_offset + src >= image_width
    lanes = torch.arange(d, device=s.device)[None, :].expand(w, d)
    s_r = s[:, src.clamp(max=w - 1), lanes]                    # [H, W, D]
    # The reference fills out-of-frame lanes with iinfo.max // 2, which
    # no aggregate reaches; all-out columns then tie at lane 0.
    s_r = s_r.masked_fill(oof[None], torch.iinfo(torch.int32).max // 2)
    return (first_argmin(s_r)[1] + md).to(torch.float32)


def spill_width(num_disparities: int, min_disparity: int = 0) -> int:
    """Left-spill width SP: block-local position p < 0 has sources
    p + md + d, d < D, so the deepest reachable one is -(D + md - 1);
    padded to a multiple of 128 (and at least 128), as the reference."""
    need = num_disparities + int(min_disparity)
    return max(128, -(-need // 128) * 128)


def _packed_partial_min(
    s: torch.Tensor, cfg: StereoConfig, positions: torch.Tensor,
    x_offset: int, image_width: Optional[int],
    src: Optional[Tuple[int, int]],
) -> torch.Tensor:
    """[H, P] float32 min over d of S(y, p+md+d, d) * PD + d at the
    block-local right-view ``positions`` p, over the lanes whose source
    column lies in ``src`` (block-local (lo, hi), default the block) and
    globally below ``image_width``; BIG where no lane is left."""
    h, w, d = s.shape
    md = int(cfg.min_disparity)
    if image_width is None:
        image_width = w
    lo, hi = src if src is not None else (0, w)
    lanes = torch.arange(d, device=s.device)[None, :]
    srcs = positions[:, None] + md + lanes                      # [P, D]
    bad = (srcs < lo) | (srcs >= hi) | (x_offset + srcs >= image_width)
    q = (s[:, srcs.clamp(0, w - 1), lanes.expand_as(srcs)].to(torch.float32)
         * _pack_radix(d) + lanes.to(torch.float32))
    return q.masked_fill(bad[None], BIG).min(dim=2).values


def right_view_partial_min(
    s: torch.Tensor, cfg: StereoConfig, x_offset: int = 0,
    image_width: Optional[int] = None,
    src: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """[H, W] float32 packed right-view PARTIAL min of a block:
    m_r(x) = min over d of S(x+md+d, d) * PD + d, so (value, first argmin)
    ride one float32 number (exact: all below 2^24). ``src`` restricts the
    source columns to the range the block owns, so that the elementwise
    min over neighbouring blocks counts every frame column once."""
    pos = torch.arange(s.shape[1], device=s.device)
    return _packed_partial_min(s, cfg, pos, x_offset, image_width, src)


def right_view_spill(
    s: torch.Tensor, cfg: StereoConfig, x_offset: int = 0,
    image_width: Optional[int] = None,
    src: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """[H, SP] float32 packed partial mins at the block-local positions
    [-SP, 0) left of the block (SP = ``spill_width``): this block's
    contribution to the previous column patch's right-view map."""
    sp = spill_width(s.shape[2], int(cfg.min_disparity))
    pos = torch.arange(sp, device=s.device) - sp
    return _packed_partial_min(s, cfg, pos, x_offset, image_width, src)


def unpack_partial_min(m_r: torch.Tensor, num_disparities: int
                       ) -> torch.Tensor:
    """Right-view winner LANE (float32) of a packed min map; 0 where every
    lane was masked (the map still holds BIG)."""
    pd = _pack_radix(num_disparities)
    d_r = m_r - torch.floor(m_r * (1.0 / pd)) * float(pd)
    return torch.where(m_r < BIG, d_r, 0.0)


def lr_gate_from_right_map(
    d0: torch.Tensor, d_r: torch.Tensor, cfg: StereoConfig,
    x_offset: int = 0, image_width: Optional[int] = None, r_offset: int = 0,
) -> torch.Tensor:
    """[H, Wl] bool LR gate of left winner LANES ``d0`` ([H, Wl] at global
    origin ``x_offset``) against a right-view winner-lane map ``d_r``
    ([H, Wr] at global origin ``r_offset``): |d0 - d_R(x - d0 - md)| <=
    lr_tau with the lookup clamped into the map, and the correspondence
    globally in [0, image_width)."""
    h, wl = d0.shape
    wr = d_r.shape[1]
    if image_width is None:
        image_width = x_offset + wl
    md = int(cfg.min_disparity)
    d0i = d0.to(torch.int64)
    xs = torch.arange(wl, device=d0.device)[None, :]
    xr_g = x_offset + xs - d0i - md
    in_frame = (xr_g >= 0) & (xr_g < image_width)
    idx = (xr_g - r_offset).clamp(0, wr - 1)
    d_r_at = torch.gather(d_r, 1, idx).to(torch.float32)
    tau = torch.tensor(cfg.lr_tau, dtype=torch.float32, device=d0.device)
    return ((d0i.to(torch.float32) - d_r_at).abs() <= tau) & in_frame


def lr_consistency(disp_l: torch.Tensor, disp_r: torch.Tensor,
                   cfg: StereoConfig, x_offset: int = 0,
                   image_width: Optional[int] = None) -> torch.Tensor:
    """[H, W] bool: |d_L(x) - d_R(x - round(d_L(x)))| <= tau and the
    correspondence x - round(d_L(x)) is in the (global) frame. Lookup
    offsets outside [md, md + D) clamp to the nearest disparity plane, as
    the reference's one-hot select does."""
    h, w = disp_l.shape
    if image_width is None:
        image_width = w
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    xs = torch.arange(w, device=disp_l.device)[None, :]
    xr = torch.round(xs - disp_l).to(torch.int64)
    in_frame = (x_offset + xr >= 0) & (x_offset + xr < image_width)
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
    x_offset: int = 0,
    image_width: Optional[int] = None,
    disp_int: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cheap LR check + median, per config. Returns (disp, valid).

    The LR check compares INTEGER winners (``disp_int``; falls back to
    rounding ``disp``), as in standard SGM.
    """
    if cfg.lr_check and not cfg.lr_exact:
        disp_r = right_disparity_from_volume(s, cfg, x_offset, image_width)
        d_l = disp_int if disp_int is not None else torch.round(disp)
        valid = valid & lr_consistency(d_l, disp_r, cfg, x_offset,
                                       image_width)
    if cfg.median_filter:
        disp = median_3x3(disp)
    return disp, valid


def select_disparity(s: torch.Tensor, cfg: StereoConfig, emit_d0: bool = False,
                     x_offset: int = 0, image_width: Optional[int] = None,
                     emit_qr: bool = False,
                     own: Optional[Tuple[int, int]] = None,
                     ) -> Tuple[torch.Tensor, ...]:
    """WTA + subpixel + uniqueness + cheap LR on S, median excluded: the
    plain version of the ``sgm_select`` kernel, in its three forms.

    Base: (disp, valid). With ``emit_d0``: (disp, valid, d0), d0 the
    [H, W] int32 integer winner lane (md excluded). With ``cfg.lr_exact``
    the cheap LR check is off: the caller compares against the right
    view's own winners. ``x_offset`` / ``image_width`` frame a block of a
    larger image.

    With ``emit_qr``, for a column patch whose LR check is stitched across
    patches: (disp, ok_nolr, lr_bit, d0, qr, spill), where ok_nolr [H, W]
    bool is the uniqueness gate alone, lr_bit [H, W] bool the LR verdict
    against the patch's own partial map, and qr [H, W], spill [H, SP]
    float32 the packed right-view partial mins over the source columns in
    ``own`` (block-local (lo, hi), default the block):
    ``right_view_partial_min`` and ``right_view_spill``.
    """
    if emit_qr:
        if not cfg.lr_check or cfg.lr_exact:
            raise ValueError("emit_qr needs the cheap LR check (lr_check "
                             "without lr_exact)")
        if image_width is None:
            image_width = x_offset + s.shape[1]
        disp, ok_nolr, d_int = wta_with_aux(s, cfg)
        d0 = (d_int - cfg.min_disparity).to(torch.int32)
        qr = right_view_partial_min(s, cfg, x_offset, image_width, src=own)
        spill = right_view_spill(s, cfg, x_offset, image_width, src=own)
        lr_bit = lr_gate_from_right_map(
            d0, unpack_partial_min(qr, cfg.num_disparities), cfg,
            x_offset=x_offset, image_width=image_width, r_offset=x_offset)
        return disp, ok_nolr, lr_bit, d0, qr, spill
    disp, valid, d_int = wta_with_aux(s, cfg)
    disp, valid = apply_postprocess(
        disp, valid, s, cfg.replace(median_filter=False), x_offset,
        image_width, disp_int=d_int
    )
    if emit_d0:
        return disp, valid, (d_int - cfg.min_disparity).to(torch.int32)
    return disp, valid
