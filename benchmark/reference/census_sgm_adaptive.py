"""Plain reference of the census + SGM pipeline with an edge-aware P2.

What ``census_sgm.py`` computes, with one change in the path recurrence: the
penalty of a jump of more than one disparity is taken per pixel and
direction from the reference (left) image,

    g(p)  = |I(p) - I(p - r)| - adaptive_grad_floor
    P2(p) = max(p2_min, P2 // g(p))   where g(p) > 0, else P2
    L_r(p, d) = C(p, d) + min(L_r(p - r, d), L_r(p - r, d +- 1) + P1,
                              min_k L_r(p - r, k) + P2(p))
                - min_k L_r(p - r, k)

where p - r is the predecessor along the path, for the image as for the
carry: on a diagonal it is the diagonal neighbour. Where the predecessor
leaves the frame the path starts fresh (L_r = C), and P2 there is read by
no one. The census, the cost volume, the selection, the left-right check,
the median and the speckle filter are ``census_sgm.py``'s own functions.

This is Hirschmueller's adaptive penalty (TPAMI 30(2), 2008: P2 = P2' /
|I_p - I_q|, kept at least P1), in the form the engine's quality preset
states, with these departures from the paper:

- a sensor-noise floor: ``adaptive_grad_floor`` is taken off the gradient
  before the division, so a gradient at or below it keeps the configured P2;
- integer division rounding down (both operands are positive integers), so
  every value up to the selection stays an integer;
- the lower bound is ``p2_min``, not P1; and a zero gradient, where the
  paper's quotient is undefined, keeps the configured P2.

Written from the recurrence, imports nothing of the engine, and keeps the
whole path in int32 as ``census_sgm.py`` does, so the benchmark compares the
engine with it bit for bit. ``precision="bfloat16"`` computes the selection's
float steps in bfloat16: the cell's control, which its comparison must
reject.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .census_sgm import (PATH_STEPS, _step, cost_volume, lr_check, median3x3,
                         select)
from .speckle import filter_speckles

#: What this reference computes; a configuration asking for anything else is
#: refused rather than compared against the wrong semantics (fixed P2 is
#: ``census_sgm.py``'s).
SUPPORTED = {"cost_fn": ("census",), "adaptive_p2": (True,),
             "lr_exact": (False,), "fill_occlusions": (False,)}


def check_config(cfg: Dict) -> None:
    """Raise unless ``cfg`` (the configuration file's ``stereo`` fields) is
    one this reference computes."""
    for key, allowed in SUPPORTED.items():
        if cfg[key] not in allowed:
            raise NotImplementedError(
                f"the census_sgm_adaptive reference computes {key} in "
                f"{allowed}, not {cfg[key]!r}")
    if cfg["num_paths"] not in (4, 8):
        raise NotImplementedError("the census_sgm_adaptive reference runs 4 "
                                  "or 8 SGM paths")


def penalty(cur: torch.Tensor, pred: torch.Tensor, cfg: Dict
            ) -> torch.Tensor:
    """[L, 1] int32 P2 of a line of pixels of intensity ``cur`` whose
    predecessors have intensity ``pred`` (both [L] int32)."""
    p2 = int(cfg["p2"])
    g = (cur - pred).abs() - int(cfg["adaptive_grad_floor"])
    adapted = (p2 // g.clamp(min=1)).clamp(min=int(cfg["p2_min"]))
    return torch.where(g > 0, adapted, torch.full_like(g, p2))[:, None]


def add_path(s: torch.Tensor, cost: torch.Tensor, img: torch.Tensor,
             cfg: Dict, step: Tuple[int, int]) -> None:
    """Add the path cost L_r of one travel step (dy, dx) into ``s`` [H, W, D]
    int32, P2 from ``img`` [H, W] int32; L_r = C wherever the predecessor
    leaves the frame."""
    h, w, _ = cost.shape
    p1 = int(cfg["p1"])
    dy, dx = step
    if dy == 0:
        prev = None
        for x in (range(w) if dx > 0 else range(w - 1, -1, -1)):
            c = cost[:, x].to(torch.int32)
            if prev is None:
                prev = c
            else:
                prev = _step(prev, c, p1, penalty(img[:, x], img[:, x - dx],
                                                  cfg))
            s[:, x] += prev
        return
    prev = None
    for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
        c = cost[y].to(torch.int32)
        if prev is None:
            row = c
        else:
            up_img = img[y - dy]
            if dx > 0:      # predecessor x - 1; column 0 starts fresh
                pred = torch.cat([prev[:1], prev[:-1]], dim=0)
                pred_img = torch.cat([up_img[:1], up_img[:-1]])
            elif dx < 0:    # predecessor x + 1; column W-1 starts fresh
                pred = torch.cat([prev[1:], prev[-1:]], dim=0)
                pred_img = torch.cat([up_img[1:], up_img[-1:]])
            else:
                pred, pred_img = prev, up_img
            row = _step(pred, c, p1, penalty(img[y], pred_img, cfg))
            if dx > 0:
                row[0] = c[0]
            elif dx < 0:
                row[w - 1] = c[w - 1]
        s[y] += row
        prev = row


def compute_disparity(left, right, cfg: Dict, device="cpu",
                      precision: str = "float32"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The device stages on one pair: (disp [H, W] float32, valid [H, W]
    bool) as numpy. ``left``, ``right``: [H, W] uint8 arrays or tensors;
    ``left`` is the image P2 is taken from."""
    check_config(cfg)
    ftype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    left = torch.as_tensor(left).to(device)
    right = torch.as_tensor(right).to(device)
    cost = cost_volume(left, right, cfg)
    img = left.to(torch.int32)
    s = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    for step in PATH_STEPS[:cfg["num_paths"]]:
        add_path(s, cost, img, cfg, step)
    del cost
    disp, valid, d0 = select(s, cfg, ftype)
    if cfg["lr_check"]:
        valid = valid & lr_check(s, d0, cfg)
    del s
    if cfg["median_filter"]:
        disp = median3x3(disp)
    return disp.cpu().numpy(), valid.cpu().numpy()


def host_postprocess(disp: np.ndarray, valid: np.ndarray, cfg: Dict
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The host filters: speckle removal with size max(speckle_max_size,
    round(speckle_rel * H * W)) and tolerance speckle_tau."""
    check_config(cfg)
    size = max(cfg["speckle_max_size"],
               int(round(cfg["speckle_rel"] * disp.shape[0] * disp.shape[1])))
    if size > 0:
        valid = filter_speckles(disp, valid, cfg["speckle_tau"], size)
    return disp, valid
