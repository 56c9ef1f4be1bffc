"""K1 and K5 wrappers: census-Hamming (csrc/census_cost.cu) and SAD
(csrc/sad_cost.cu) cost volumes.

K1 replaces ``stereo_tpu/ops/pallas/cost_kernel.py:_cost_kernel_x``; the
census transform itself stays plain torch, as it stays in XLA on the TPU.
K5 replaces ``_sad_kernel`` (through ``sad_cost_volume_pallas``).
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from ..cost import census_cost_from_descriptors, sad_cost_volume
from .launch import MAX_DISPARITIES, on_cpu, require, require_disparities, run


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


def sad_cost(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
             ) -> torch.Tensor:
    """[H, W, D] int16 SAD cost volume of two [H, W] images, any D in
    [1, 256]. CPU tensors take the plain version (``ops.cost``); CUDA
    tensors launch the kernel."""
    if left.shape != right.shape or left.ndim != 2:
        raise ValueError(f"expected two [H, W] images: {left.shape}, {right.shape}")
    if cfg.cost_fn != "sad":
        raise ValueError(f"sad_cost needs cost_fn='sad', got {cfg.cost_fn}")
    if on_cpu(left, right):
        return sad_cost_volume(left, right, cfg).to(torch.int16)
    h, w = left.shape
    d = cfg.num_disparities
    wy, wx = cfg.sad_window
    if not 1 <= d <= MAX_DISPARITIES:
        raise ValueError(f"sad_cost takes D in [1, {MAX_DISPARITIES}], got {d}")
    if wy % 2 == 0 or wx % 2 == 0:
        raise ValueError(f"sad_window must be odd, got {cfg.sad_window}")
    if cfg.min_disparity < 0:
        raise ValueError("the CUDA cost kernel needs min_disparity >= 0")
    # int32 images: the reference's astype(int32), for any input dtype.
    l32 = left.to(torch.int32).contiguous()
    r32 = right.to(torch.int32).contiguous()
    require(l32, "left", torch.int32, 2)
    require(r32, "right", torch.int32, 2)
    out = torch.empty((h, w, d), dtype=torch.int16, device=left.device)
    run("stpu_sad_cost", left.device, l32.data_ptr(), r32.data_ptr(),
        out.data_ptr(), h, w, d, int(cfg.min_disparity), wy, wx,
        cfg.max_unary_cost)
    sad_cost.launches += 1
    return out


sad_cost.launches = 0
