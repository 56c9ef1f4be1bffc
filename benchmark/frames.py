"""Synthetic rectified pairs from a seed, made in bulk on the device.

The scene family of the engine's ``make_pair(kind="shapes",
texture="cloud")``, as its stream bench uses: a background plane at 15% of
``max_disp`` with three fronto-parallel objects (boxes or ellipses) at
40-100% of it, integer disparities; the right view a band-limited cloud
(bilinearly upsampled noise from an eighth of the resolution, stretched to
[0, 255]) mixed 65/35 with uniform random dots; the left view samples it at
x - d. The random numbers come from a ``torch.Generator`` on ``device`` seeded
with the run's seed, so one seed gives the same pool on the same kind of
device, in a few large calls whatever the pool's size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_pool(n: int, shape: Tuple[int, int], max_disp: int, seed: int,
              device) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right): [n, H, W] uint8 arrays in host memory."""
    h, w = shape
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def uniform(*size):
        return torch.rand(size, generator=g, device=device)

    def integers(lo, hi, size):
        return torch.randint(lo, hi, size, generator=g,
                             device=device).to(torch.float32)

    ys = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    disp = torch.full((n, h, w), max(1.0, 0.15 * max_disp), device=device)
    for _ in range(3):
        cy = integers(h // 6, 5 * h // 6, (n, 1, 1))
        cx = integers(w // 6, 5 * w // 6, (n, 1, 1))
        ry = integers(h // 10, h // 4, (n, 1, 1))
        rx = integers(w // 10, w // 4, (n, 1, 1))
        level = max_disp * (0.4 + 0.6 * uniform(n, 1, 1))
        box = ((ys - cy).abs() < ry) & ((xs - cx).abs() < rx)
        ellipse = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 1.0
        mask = torch.where(uniform(n, 1, 1) < 0.5, box, ellipse)
        disp = torch.where(mask & (level > disp), level, disp)
    disp = disp.round().clamp(0, max_disp)

    bh, bw = h // 8 + 2, w // 8 + 2
    base = torch.randn((n, bh, bw), generator=g, device=device)
    gy = torch.linspace(0, bh - 1.001, h, device=device)
    gx = torch.linspace(0, bw - 1.001, w, device=device)
    y0, x0 = gy.floor().long(), gx.floor().long()
    fy, fx = (gy - y0)[:, None], (gx - x0)[None, :]
    top, bottom = base[:, y0], base[:, y0 + 1]
    cloud = (top[:, :, x0] * (1 - fy) * (1 - fx)
             + bottom[:, :, x0] * fy * (1 - fx)
             + top[:, :, x0 + 1] * (1 - fy) * fx
             + bottom[:, :, x0 + 1] * fy * fx)
    lo = cloud.amin(dim=(1, 2), keepdim=True)
    hi = cloud.amax(dim=(1, 2), keepdim=True)
    cloud = (cloud - lo) / (hi - lo + 1e-9)
    dots = integers(0, 256, (n, h, w))
    right = 0.65 * cloud * 255.0 + 0.35 * dots
    src = (xs - disp).long().clamp(0, w - 1)
    left = torch.gather(right, 2, src)
    return tuple(t.clamp(0, 255).to(torch.uint8).cpu().numpy()
                 for t in (left, right))
