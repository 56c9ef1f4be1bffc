"""K1 wrapper: census-Hamming cost volume (csrc/census_cost.cu).

Replaces ``stereo_tpu/ops/pallas/cost_kernel.py:_cost_kernel_x``. The
census transform itself stays plain torch, as it stays in XLA on the TPU.
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from ..cost import census_cost_from_descriptors
from .launch import on_cpu, require, require_disparities, run


def census_cost(cl: torch.Tensor, cr: torch.Tensor, cfg: StereoConfig
                ) -> torch.Tensor:
    """[H, W, D] int8 cost volume from [H, W, words] int64 census
    descriptors (``ops.census.census_transform``).

    CPU tensors take the plain version (``ops.cost``); CUDA tensors launch
    the kernel.
    """
    if cl.shape != cr.shape:
        raise ValueError(f"descriptor shapes differ: {cl.shape} vs {cr.shape}")
    if cfg.cost_fn != "census":
        raise ValueError(f"census_cost needs cost_fn='census', got {cfg.cost_fn}")
    if on_cpu(cl, cr):
        return census_cost_from_descriptors(cl, cr, cfg).to(
            cfg.cost_volume_dtype
        )
    h, w, words = cl.shape
    d = cfg.num_disparities
    require_disparities(d)
    if words != cfg.census_words or words not in (1, 2):
        raise ValueError(f"expected {cfg.census_words} census words, got {words}")
    if cfg.min_disparity < 0:
        raise ValueError("the CUDA cost kernel needs min_disparity >= 0")
    # Same bits, 32-bit words: int64 -> int32 wraps values >= 2^31.
    cl32 = cl.to(torch.int32).contiguous()
    cr32 = cr.to(torch.int32).contiguous()
    require(cl32, "cl", torch.int32, 3)
    require(cr32, "cr", torch.int32, 3)
    out = torch.empty((h, w, d), dtype=torch.int8, device=cl.device)
    run("stpu_census_cost", cl.device, cl32.data_ptr(), cr32.data_ptr(),
        out.data_ptr(), h, w, d, words, int(cfg.min_disparity),
        cfg.max_unary_cost)
    census_cost.launches += 1
    return out


census_cost.launches = 0
