"""K4 wrapper: 3x3 median (csrc/median3x3.cu).

Replaces ``stereo_tpu/ops/pallas/filter_kernel.py:_median_kernel``.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..postprocess import median_3x3
from .launch import count_launch, on_cpu, require, run


def median3x3(disp: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 3x3 median with replicated edges. CPU tensors take
    the plain version (``ops.postprocess.median_3x3``)."""
    if on_cpu(disp):
        return median_3x3(disp)
    require(disp, "disp", torch.float32, 2)
    h, w = disp.shape
    out = torch.empty_like(disp)
    run("stpu_median3x3", disp.device, disp.data_ptr(), out.data_ptr(), h, w)
    count_launch(median3x3, h, w)
    return out


median3x3.forms = Counter()
