"""Plain reference of the census + SGM pipeline that the benchmark's cells run.

A whole rectified pair in, the left-view disparity map and its validity out:
census transform, Hamming cost volume, 4- or 8-path SGM, winner-take-all with
the subpixel parabola and the uniqueness gate, the cheap left-right check on
integer winners, the 3x3 median. ``host_postprocess`` applies the speckle
filter (``speckle.py``) as the served path does on the host.

Written in plain torch from the recurrences, in the form of the engine's plain
ops as they stood when the benchmark was defined, and imports nothing of the
engine: the benchmark compares the engine with it bit for bit. Every value up
to the selection is an integer below 2^24; the only float steps are the
uniqueness product and the subpixel parabola, single IEEE float32 operations
in a fixed order, so any difference is a fault and not rounding. It runs on
any device; the paths keep one [H, D] or [W, D] line of int32 in flight and
add it into one int32 sum beside the int8 cost volume.

``precision="bfloat16"`` computes those float steps in bfloat16 instead: the
benchmark's control, which its comparison must reject.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .speckle import filter_speckles

#: Travel step (dy, dx) of each path; the first four are the 4-path set.
PATH_STEPS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))

#: Median-of-9 exchange network: after these swaps v[4] is the median.
MEDIAN_NET = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)

#: Voxels per row chunk of the cost volume, so that the gathered int64
#: descriptors of one chunk stay near 1 GB.
CHUNK_VOXELS = 1 << 26

#: What this reference computes; a configuration asking for anything else is
#: refused rather than compared against the wrong semantics.
SUPPORTED = {"cost_fn": ("census",), "adaptive_p2": (False,),
             "lr_exact": (False,), "fill_occlusions": (False,)}


def check_config(cfg: Dict) -> None:
    """Raise unless ``cfg`` (the configuration file's ``stereo`` fields) is
    one this reference computes."""
    for key, allowed in SUPPORTED.items():
        if cfg[key] not in allowed:
            raise NotImplementedError(
                f"the census_sgm reference computes {key} in {allowed}, "
                f"not {cfg[key]!r}")
    if cfg["num_paths"] not in (4, 8):
        raise NotImplementedError("the census_sgm reference runs 4 or 8 "
                                  "SGM paths")


def census(img: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """[H, W, words] int64 census words in [0, 2^32): bit k is set where the
    k-th off-centre neighbour (row-major) is strictly below the centre,
    borders replicating the edge pixel."""
    wy, wx = window
    ry, rx = wy // 2, wx // 2
    h, w = img.shape
    dev = img.device
    img = img.to(torch.int32)
    offsets = [(dy - ry, dx - rx) for dy in range(wy) for dx in range(wx)
               if (dy, dx) != (ry, rx)]
    words = []
    for start in range(0, len(offsets), 32):
        word = torch.zeros((h, w), dtype=torch.int64, device=dev)
        for bit, (oy, ox) in enumerate(offsets[start:start + 32]):
            rows = (torch.arange(h, device=dev) + oy).clamp(0, h - 1)
            cols = (torch.arange(w, device=dev) + ox).clamp(0, w - 1)
            nb = img[rows][:, cols]
            word |= (nb < img).to(torch.int64) << bit
        words.append(word)
    return torch.stack(words, dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg: Dict
                ) -> torch.Tensor:
    """[H, W, D] int8 Hamming costs: lane d of column x compares the left
    pixel with the right pixel max(x - md - d, 0); lanes whose x - md - d is
    negative take the descriptor's bit count, so they never win."""
    window = tuple(cfg["census_window"])
    d = cfg["num_disparities"]
    md = int(cfg["min_disparity"])
    bits = window[0] * window[1] - 1
    cl, cr = census(left, window), census(right, window)
    h, w = left.shape
    dev = left.device
    xs = torch.arange(w, device=dev)[:, None]
    ds = torch.arange(d, device=dev)[None, :]
    idx = (xs - md - ds).clamp(min=0)
    bad = (xs < md + ds)[None]
    rows = max(1, CHUNK_VOXELS // (w * d))
    out = torch.empty((h, w, d), dtype=torch.int8, device=dev)
    for y in range(0, h, rows):
        ham = popcount32(cl[y:y + rows, :, None] ^ cr[y:y + rows][:, idx])
        out[y:y + rows] = ham.sum(dim=-1).masked_fill(bad, bits).to(torch.int8)
    return out


def _step(prev: torch.Tensor, c: torch.Tensor, p1: int, p2: int
          ) -> torch.Tensor:
    """L(p) = C(p) + min(L(q, d), L(q, d +- 1) + P1, min_k L(q, k) + P2)
    - min_k L(q, k) for a batch of lines [L, D], q the predecessor; the
    d +- 1 neighbours are edge-replicated."""
    m = prev.min(dim=-1, keepdim=True).values
    dn = torch.cat([prev[:, :1], prev[:, :-1]], dim=1) + p1
    up = torch.cat([prev[:, 1:], prev[:, -1:]], dim=1) + p1
    best = torch.minimum(torch.minimum(prev, m + p2), torch.minimum(dn, up))
    return c + best - m


def add_path(s: torch.Tensor, cost: torch.Tensor, p1: int, p2: int,
             step: Tuple[int, int]) -> None:
    """Add the path cost L_r of one travel step (dy, dx) into ``s`` [H, W, D]
    int32; L_r = C wherever the predecessor leaves the frame."""
    h, w, _ = cost.shape
    dy, dx = step
    if dy == 0:
        prev = None
        for x in (range(w) if dx > 0 else range(w - 1, -1, -1)):
            c = cost[:, x].to(torch.int32)
            prev = c if prev is None else _step(prev, c, p1, p2)
            s[:, x] += prev
        return
    prev = None
    for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
        c = cost[y].to(torch.int32)
        if prev is None:
            row = c
        else:
            if dx > 0:      # predecessor x - 1; column 0 starts fresh
                pred = torch.cat([prev[:1], prev[:-1]], dim=0)
            elif dx < 0:    # predecessor x + 1; column W-1 starts fresh
                pred = torch.cat([prev[1:], prev[-1:]], dim=0)
            else:
                pred = prev
            row = _step(pred, c, p1, p2)
            if dx > 0:
                row[0] = c[0]
            elif dx < 0:
                row[w - 1] = c[w - 1]
        s[y] += row
        prev = row


def first_argmin(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, first index of the min) over the last axis."""
    c0 = s.min(dim=-1).values
    ds = torch.arange(s.shape[-1], device=s.device, dtype=torch.int32)
    d0 = torch.where(s == c0[..., None], ds, s.shape[-1]).min(dim=-1).values
    return c0, d0


def select(s: torch.Tensor, cfg: Dict, ftype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Winner-take-all with the subpixel parabola and the uniqueness gate,
    their float steps in ``ftype``:

        unique  <=>  c2 > c0 * (1 + ratio)      (c2: best outside d0 +- 1)
        offset   =  (cm - cp) / (2 * denom),  denom = cp + cm - 2 c0 > 0
        disp     =  d0 + clip(offset, -0.5, 0.5) + md

    Returns (disp float32, unique bool, d0 int32)."""
    d = s.shape[-1]
    ds = torch.arange(d, device=s.device, dtype=torch.int32)
    c0, d0 = first_argmin(s)
    unique = torch.ones(d0.shape, dtype=torch.bool, device=s.device)
    ratio = cfg["uniqueness_ratio"]
    if ratio > 0:
        near = (ds - d0[..., None]).abs() <= 1
        c2 = s.masked_fill(near, torch.iinfo(torch.int32).max).min(-1).values
        f = torch.tensor(1.0 + ratio, dtype=torch.float32,
                         device=s.device).to(ftype)
        unique = c2.to(ftype) > c0.to(ftype) * f
    disp = d0.to(ftype)
    if cfg["subpixel"] and d > 1:
        cm = torch.gather(s, -1, (d0 - 1).clamp(min=0).long()[..., None])[..., 0]
        cp = torch.gather(s, -1, (d0 + 1).clamp(max=d - 1).long()[..., None])[..., 0]
        denom = cp + cm - 2 * c0
        offset = torch.where(
            denom > 0,
            (cm - cp).to(ftype) / (2 * denom.clamp(min=1)).to(ftype),
            torch.zeros((), dtype=ftype, device=s.device),
        ).clamp(-0.5, 0.5)
        interior = (d0 > 0) & (d0 < d - 1)
        disp = disp + torch.where(interior, offset,
                                  torch.zeros((), dtype=ftype,
                                              device=s.device))
    disp = (disp + cfg["min_disparity"]).to(torch.float32)
    return disp, unique, d0


def lr_check(s: torch.Tensor, d0: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """The cheap left-right check: the right view's winner at column xr is
    the first argmin over d of S(y, xr + md + d, d), over the lanes whose
    source column lies in the frame (lane 0 where none does); a left pixel
    passes where |d0 - d_R(x - d0 - md)| <= lr_tau, its lookup clamped to
    the planes [md, md + D), and x - d0 - md lies in the frame."""
    h, w, d = s.shape
    md = int(cfg["min_disparity"])
    dev = s.device
    src = (torch.arange(w, device=dev)[:, None] + md
           + torch.arange(d, device=dev)[None, :])
    lanes = torch.arange(d, device=dev)[None, :].expand(w, d)
    s_r = s[:, src.clamp(max=w - 1), lanes]
    s_r.masked_fill_((src >= w)[None], torch.iinfo(torch.int32).max // 2)
    d_r = (first_argmin(s_r)[1] + md).to(torch.float32)
    del s_r
    d_l = (d0 + md).to(torch.float32)
    xs = torch.arange(w, device=dev)[None, :]
    xr = torch.round(xs - d_l).to(torch.int64)
    in_frame = (xr >= 0) & (xr < w)
    shift = (xs - xr).clamp(md, md + d - 1)
    d_r_at = torch.gather(d_r, 1, (xs - shift).clamp(0, w - 1))
    tau = torch.tensor(cfg["lr_tau"], dtype=torch.float32, device=dev)
    return ((d_l - d_r_at).abs() <= tau) & in_frame


def median3x3(disp: torch.Tensor) -> torch.Tensor:
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


def compute_disparity(left, right, cfg: Dict, device="cpu",
                      precision: str = "float32"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The device stages on one pair: (disp [H, W] float32, valid [H, W]
    bool) as numpy. ``left``, ``right``: [H, W] uint8 arrays or tensors."""
    check_config(cfg)
    ftype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    left = torch.as_tensor(left).to(device)
    right = torch.as_tensor(right).to(device)
    cost = cost_volume(left, right, cfg)
    s = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    for step in PATH_STEPS[:cfg["num_paths"]]:
        add_path(s, cost, cfg["p1"], cfg["p2"], step)
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
