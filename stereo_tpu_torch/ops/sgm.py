"""Semi-Global Matching path aggregation (plain torch).

Twin of ``stereo_tpu/ops/sgm.py``. For each path direction r,

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1, L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

with ``L_r(p, .) = C(p, .)`` wherever the predecessor ``p - r`` is out of
frame (a fresh start at each scanline's first pixel) and the d-1 / d+1
neighbours edge-replicated at d = 0 and d = D-1.

With a ``valid`` mask (a tile of a larger frame, ``parallel/tiling.py``),
``L_r(p, .) = C(p, .)`` also wherever the predecessor is invalid, whatever
p's own validity: paths start fresh at the mask's edges, as the
reference's (``stereo_tpu/ops/sgm.py:82``, ``:204-257``; on the diagonals
its sheared mask marks the same diagonal predecessors). The diagonals are walked
directly: a row step whose carry is the previous row's, shifted one column
(the reference shears the volume instead; the predecessors are the same).

With ``cfg.adaptive_p2`` and an image, P2 becomes per pixel and direction:
``grad = |I(p) - I(p-r)| - adaptive_grad_floor`` and
``P2(p) = max(p2_min, P2 // grad)`` where ``grad > 0``, else ``P2``
(``adaptive_p2_map``). The predecessor of a diagonal step is the diagonal
neighbour for the image as for the carry.

With the reference's ``constrain`` hooks (its exact mode's sharding
annotations, ``stereo_tpu/ops/sgm.py:238-256``) the sum follows the
reference's structure instead: the horizontals on ``rows_local((cost,
valid, img))``, the verticals on ``cols_local((cost, valid, img))``, and
each diagonal family as the verticals of the sheared volume (``_shear``),
under the sheared validity, then ``_unshear``. The bits are the same; the
hooks see the reference's trees in its order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..config import StereoConfig

#: Travel step (dy, dx) of each path; pixel p's predecessor is p - step.
#: The first four are the 4-path set (horizontal, then vertical).
PATH_STEPS = (
    (0, 1), (0, -1), (1, 0), (-1, 0),
    (1, 1), (-1, -1), (1, -1), (-1, 1),
)
#: The horizontals and the verticals: the exact mode scans the first on
#: row bands, the second on column bands and on bands of the sheared volume.
H_STEPS, V_STEPS = PATH_STEPS[:2], PATH_STEPS[2:4]


def adaptive_p2_map(image: torch.Tensor, cfg: StereoConfig, dy: int, dx: int
                    ) -> torch.Tensor:
    """[H, W] int32 effective P2 for one path direction.

    ``dy, dx`` is the offset of the path PREDECESSOR, pred(y, x) =
    (y + dy, x + dx), as in the reference. Entries whose predecessor falls
    outside the image are don't-care (the scans fresh-start there).
    """
    img = image.to(torch.int32)
    prev = torch.roll(img, (-dy, -dx), (0, 1))
    grad = (img - prev).abs() - cfg.adaptive_grad_floor
    p2 = torch.full_like(img, cfg.p2)
    q = torch.div(p2, grad.clamp(min=1), rounding_mode="floor")
    return torch.where(grad > 0, q.clamp(min=cfg.p2_min), p2)


def _recur(l_prev: torch.Tensor, c: torch.Tensor, p1: int,
           p2: Union[int, torch.Tensor]) -> torch.Tensor:
    """One recurrence step for a batch of lines: [L, D] -> [L, D]; ``p2``
    is a scalar or an [L, 1] per-line penalty."""
    m = l_prev.min(dim=-1, keepdim=True).values
    dn = torch.cat([l_prev[:, :1], l_prev[:, :-1]], dim=1) + p1
    up = torch.cat([l_prev[:, 1:], l_prev[:, -1:]], dim=1) + p1
    cand = torch.minimum(torch.minimum(l_prev, m + p2), torch.minimum(dn, up))
    return c + cand - m


def _predecessor_valid(valid: torch.Tensor, dy: int, dx: int
                      ) -> torch.Tensor:
    """[H, W] bool: pixel p's predecessor p - (dy, dx) lies in the frame
    and is valid."""
    h, w = valid.shape
    pv = torch.zeros_like(valid)
    pv[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = valid[
        max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return pv


def path_cost(cost: torch.Tensor, cfg: StereoConfig, step,
              image: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[H, W, D] int32 path cost L_r for one travel step (dy, dx); P2 is
    adaptive if ``cfg.adaptive_p2`` and ``image`` ([H, W]) is given; with
    ``valid`` ([H, W] bool) L_r = C where the predecessor is invalid."""
    c = cost.to(torch.int32)
    h, w, _ = c.shape
    dy, dx = step
    p2 = cfg.p2
    if cfg.adaptive_p2 and image is not None:
        p2 = adaptive_p2_map(image, cfg, -dy, -dx)            # [H, W]
    keep = None if valid is None else _predecessor_valid(valid, dy, dx)
    out = torch.empty_like(c)
    if dy == 0:
        xs = range(w) if dx > 0 else range(w - 1, -1, -1)
        prev = None
        for x in xs:
            if prev is None:
                prev = c[:, x]
            else:
                p2_x = p2 if isinstance(p2, int) else p2[:, x, None]
                prev = _recur(prev, c[:, x], cfg.p1, p2_x)
                if keep is not None:
                    prev = torch.where(keep[:, x, None], prev, c[:, x])
            out[:, x] = prev
        return out
    ys = range(h) if dy > 0 else range(h - 1, -1, -1)
    prev = None
    for y in ys:
        if prev is None:
            row = c[y]
        else:
            if dx > 0:      # predecessor column x - 1; x = 0 starts fresh
                pred = torch.cat([prev[:1], prev[:-1]], dim=0)
            elif dx < 0:    # predecessor column x + 1; x = W-1 starts fresh
                pred = torch.cat([prev[1:], prev[-1:]], dim=0)
            else:
                pred = prev
            p2_y = p2 if isinstance(p2, int) else p2[y, :, None]
            row = _recur(pred, c[y], cfg.p1, p2_y)
            if dx > 0:
                row[0] = c[y, 0]
            elif dx < 0:
                row[w - 1] = c[y, w - 1]
            if keep is not None:
                row = torch.where(keep[y, :, None], row, c[y])
        out[y] = row
        prev = row
    return out


def sum_paths(cost: torch.Tensor, cfg: StereoConfig, steps: Sequence,
              image: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[H, W, D] int32 sum of ``path_cost`` over the travel ``steps``."""
    s = None
    for step in steps:
        l_r = path_cost(cost, cfg, step, image, valid)
        s = l_r if s is None else s + l_r
    return s


def _shear(x: torch.Tensor, sign: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shear rows so that diagonals become columns, as the reference's
    ``_shear``: sign +1 ``sheared[y, x'] = x[y, x' + y - (H-1)]`` (the
    down-right diagonal), sign -1 ``sheared[y, x'] = x[y, x' - y]`` (the
    down-left one), source columns clipped into the frame. Returns
    (sheared [H, W+H-1, ...], valid [H, W+H-1] bool: the source column lies
    in the frame)."""
    h, w = x.shape[:2]
    return shear_window(x, 0, h, sign, 0, w + h - 1), shear_valid(
        h, w, sign, 0, w + h - 1, x.device)


def shear_source(y0: int, rows: int, h: int, sign: int, x0: int,
                 width: int, device) -> torch.Tensor:
    """[rows, width] int64 source column (unclipped) of the sheared columns
    [x0, x0 + width) on the frame rows [y0, y0 + rows) of an h-row frame."""
    ys = y0 + torch.arange(rows, device=device)[:, None]
    xs = x0 + torch.arange(width, device=device)[None, :]
    return xs + ys - (h - 1) if sign > 0 else xs - ys


def shear_valid(h: int, w: int, sign: int, x0: int, width: int, device
                ) -> torch.Tensor:
    """[h, width] bool: where the sheared columns [x0, x0 + width) of an
    h x w frame have their source column in the frame."""
    src = shear_source(0, h, h, sign, x0, width, device)
    return (src >= 0) & (src < w)


def shear_window(x: torch.Tensor, y0: int, h: int, sign: int, x0: int,
                 width: int) -> torch.Tensor:
    """The sheared columns [x0, x0 + width) of the rows that ``x`` holds:
    ``x`` is [rows, W, ...], the frame rows [y0, y0 + rows) of an h x W
    frame; returns [rows, width, ...], source columns clipped into the
    frame (``_shear`` restricted to a row band and a column band)."""
    rows, w = x.shape[:2]
    src = shear_source(y0, rows, h, sign, x0, width, x.device)
    index = (torch.arange(rows, device=x.device)[:, None], src.clamp(0, w - 1))
    pixel = x[0, 0].numel() * x.element_size() if rows and w else 0
    if (x.dim() == 3 and x.is_contiguous() and pixel % 8 == 0
            and x.storage_offset() * x.element_size() % 8 == 0):
        # A pixel's values move as 8-byte words: the gather copies the
        # same bytes with an eighth of the elements of an int8 volume.
        return x.view(torch.int64)[index].view(x.dtype)
    return x[index]


def _unshear(x: torch.Tensor, sign: int, w: int) -> torch.Tensor:
    """Inverse of ``_shear``: [H, W, ...] from [H, W+H-1, ...]."""
    return unshear_rows(x, 0, x.shape[0], sign, w)


def unshear_rows(x: torch.Tensor, y0: int, h: int, sign: int, w: int
                 ) -> torch.Tensor:
    """The unsheared [rows, w, ...] of ``x`` [rows, w+h-1, ...], the frame
    rows [y0, y0 + rows) of a sheared h x w frame: frame column c of row y
    is sheared column c - y + (h-1) (sign +1) or c + y (sign -1). A
    strided view of ``x``, which must be contiguous."""
    if not x.is_contiguous():
        raise ValueError("unshear_rows needs a contiguous tensor")
    rows, wp = x.shape[:2]
    inner = x[0, 0].numel() if rows and wp else 1
    if sign > 0:
        row_stride, first = (wp - 1) * inner, (h - 1 - y0) * inner
    else:
        row_stride, first = (wp + 1) * inner, y0 * inner
    return x.as_strided((rows, w, *x.shape[2:]),
                        (row_stride, inner, *x.stride()[2:]),
                        x.storage_offset() + first)


def sgm_aggregate(cost: torch.Tensor, cfg: StereoConfig,
                  image: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None,
                  constrain=None, scan=sum_paths) -> torch.Tensor:
    """Sum of SGM path costs S(p, d) = sum_r L_r(p, d).

    Args:
      cost: [H, W, D] integer matching-cost volume.
      cfg: num_paths in {0, 4, 8}, P1/P2, adaptive P2.
      image: [H, W] reference-view intensities; used only with
        ``cfg.adaptive_p2`` (without it P2 stays fixed, as in the reference).
      valid: [H, W] bool mask of real pixels (a tile's in-frame rectangle);
        None: all valid.
      constrain: the reference's (rows_local, cols_local) hooks of its
        exact mode: ``rows_local`` is applied to the (cost, valid, image)
        tuple before the horizontals, ``cols_local`` to it before the
        verticals and to each sheared family's tuple before its scans
        (the module docstring). Each takes a tuple and returns one.
      scan: ``(cost, cfg, steps, image, valid) -> S`` of one family of
        directions: ``sum_paths``, or K2's wrapper on the kernel route
        (``pipeline.kernel_sum``).

    Returns:
      [H, W, D] summed volume (int32 from ``sum_paths``); num_paths=0
      returns the cost as int32.
    """
    if cfg.num_paths == 0:
        return cost.to(torch.int32)
    if valid is not None and tuple(valid.shape) != tuple(cost.shape[:2]):
        raise ValueError(f"valid {tuple(valid.shape)} != cost "
                         f"{tuple(cost.shape[:2])}")
    if constrain is None:
        return scan(cost, cfg, PATH_STEPS[: cfg.num_paths], image, valid)
    h, w = cost.shape[:2]
    if valid is None:
        valid = torch.ones((h, w), dtype=torch.bool, device=cost.device)
    img = image if cfg.adaptive_p2 else None
    rows_local, cols_local = constrain[0], constrain[1]
    c_r, v_r, i_r = rows_local((cost, valid, img))
    s = scan(c_r, cfg, H_STEPS, i_r, v_r)
    c_c, v_c, i_c = cols_local((cost, valid, img))
    s = s + scan(c_c, cfg, V_STEPS, i_c, v_c)
    if cfg.num_paths == 8:
        for sign in (+1, -1):
            c_sh, v_geom = _shear(c_c, sign)
            v_sh = _shear(v_c, sign)[0] & v_geom
            i_sh = _shear(i_c, sign)[0] if i_c is not None else None
            c_sh, v_sh, i_sh = cols_local((c_sh, v_sh, i_sh))
            d_out = scan(c_sh, cfg, V_STEPS, i_sh, v_sh)
            s = s + _unshear(d_out.contiguous(), sign, w)
    return s
