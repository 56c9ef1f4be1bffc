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
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import StereoConfig

#: Travel step (dy, dx) of each path; pixel p's predecessor is p - step.
#: The first four are the 4-path set (horizontal, then vertical).
PATH_STEPS = (
    (0, 1), (0, -1), (1, 0), (-1, 0),
    (1, 1), (-1, -1), (1, -1), (-1, 1),
)


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


def sgm_aggregate(cost: torch.Tensor, cfg: StereoConfig,
                  image: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None,
                  constrain=None) -> torch.Tensor:
    """Sum of SGM path costs S(p, d) = sum_r L_r(p, d).

    Args:
      cost: [H, W, D] integer matching-cost volume.
      cfg: num_paths in {0, 4, 8}, P1/P2, adaptive P2.
      image: [H, W] reference-view intensities; used only with
        ``cfg.adaptive_p2`` (without it P2 stays fixed, as in the reference).
      valid: [H, W] bool mask of real pixels (a tile's in-frame rectangle);
        None: all valid.
      constrain: the reference's sharding annotators of its exact mode;
        not ported, anything but None raises.

    Returns:
      [H, W, D] int32 summed volume; num_paths=0 returns the cost as int32.
    """
    if constrain is not None:
        raise NotImplementedError(
            "constrain (the exact reshard mode's sharding hooks) is not "
            "ported yet (ROADMAP Queue 1: parallel/exact.py)")
    if cfg.num_paths == 0:
        return cost.to(torch.int32)
    if valid is not None and tuple(valid.shape) != tuple(cost.shape[:2]):
        raise ValueError(f"valid {tuple(valid.shape)} != cost "
                         f"{tuple(cost.shape[:2])}")
    s = None
    for step in PATH_STEPS[: cfg.num_paths]:
        l_r = path_cost(cost, cfg, step, image, valid)
        s = l_r if s is None else s + l_r
    return s
