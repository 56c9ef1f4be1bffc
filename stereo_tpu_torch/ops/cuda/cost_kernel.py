"""K1 and K5 wrappers: census-Hamming and rank (csrc/census_cost.cu) and
SAD (csrc/sad_cost.cu) cost volumes.

K1 replaces ``stereo_tpu/ops/pallas/cost_kernel.py:_cost_kernel_x`` and
``_cost_kernel`` (D below 128), in their census and rank forms; the census
and rank transforms themselves stay plain torch, as they stay in XLA on
the TPU. K5 replaces ``_sad_kernel`` (through ``sad_cost_volume_pallas``).

For a block of a larger frame the wrappers take the block's global column
origin ``x_offset`` and ``right_context`` frame-true columns that precede
the block in the right descriptors or image (``ops.cost``).
"""

from __future__ import annotations

from collections import Counter

import torch

from ...config import StereoConfig
from ..cost import (
    census_cost_from_descriptors,
    rank_cost_from_descriptors,
    sad_cost_volume,
)
from .launch import count_launch, on_cpu, require, require_disparities, run

#: The kernel's combine of a left and a right descriptor.
_HAMMING, _ABS_DIFF = 0, 1


def _check_framing(what: str, left: torch.Tensor, right: torch.Tensor,
                   x_offset: int, right_context: int) -> None:
    """Raise unless ``right`` is ``left``'s shape with ``right_context``
    extra leading columns, and both origins are non-negative ints.
    ``what`` names the two inputs in the message."""
    if x_offset < 0 or right_context < 0:
        raise ValueError(f"x_offset {x_offset} and right_context "
                         f"{right_context} must be >= 0")
    want = (left.shape[0], left.shape[1] + right_context, *left.shape[2:])
    if tuple(right.shape) != want:
        raise ValueError(
            f"{what}: expected right {want} for left {tuple(left.shape)} "
            f"with right_context={right_context}, got {tuple(right.shape)}")


def _launch_descriptor_cost(dl: torch.Tensor, dr: torch.Tensor, words: int,
                            combine: int, cfg: StereoConfig, x_offset: int,
                            right_context: int) -> torch.Tensor:
    """K1 on a left [H, W, ...] and a right [H, W + right_context, ...]
    plane of 32-bit descriptors (int64 or int32 holding the same low 32
    bits): [H, W, D] int8."""
    h, w = dl.shape[:2]
    d = cfg.num_disparities
    require_disparities(d)
    if cfg.min_disparity < 0:
        raise ValueError("the CUDA cost kernel needs min_disparity >= 0")
    # Same bits, 32-bit words: int64 -> int32 wraps values >= 2^31.
    dl32 = dl.to(torch.int32).contiguous()
    dr32 = dr.to(torch.int32).contiguous()
    require(dl32, "left descriptors", torch.int32, dl.ndim)
    require(dr32, "right descriptors", torch.int32, dl.ndim)
    out = torch.empty((h, w, d), dtype=torch.int8, device=dl.device)
    run("stpu_census_cost", dl.device, dl32.data_ptr(), dr32.data_ptr(),
        out.data_ptr(), h, w, d, words, combine, int(cfg.min_disparity),
        cfg.max_unary_cost, right_context, x_offset)
    return out


def census_cost(cl: torch.Tensor, cr: torch.Tensor, cfg: StereoConfig,
                x_offset: int = 0, right_context: int = 0) -> torch.Tensor:
    """[H, W, D] int8 cost volume from int64 census descriptors
    (``ops.census.census_transform``), left [H, W, words] and right
    [H, W + right_context, words], any D in [1, 256].

    CPU tensors take the plain version (``ops.cost``); CUDA tensors launch
    the kernel.
    """
    if cl.ndim != 3:
        raise ValueError(f"expected [H, W, words] descriptors: {cl.shape}")
    _check_framing("descriptors", cl, cr, x_offset, right_context)
    if cfg.cost_fn != "census":
        raise ValueError(f"census_cost needs cost_fn='census', got {cfg.cost_fn}")
    if on_cpu(cl, cr):
        return census_cost_from_descriptors(
            cl, cr, cfg, x_offset, right_context).to(cfg.cost_volume_dtype)
    words = cl.shape[2]
    if words != cfg.census_words or words not in (1, 2):
        raise ValueError(f"expected {cfg.census_words} census words, got {words}")
    out = _launch_descriptor_cost(cl, cr, words, _HAMMING, cfg, x_offset,
                                  right_context)
    count_launch(census_cost, *out.shape, words,
                 bool(x_offset or right_context))
    return out


census_cost.forms = Counter()


def rank_cost(rl: torch.Tensor, rr: torch.Tensor, cfg: StereoConfig,
              x_offset: int = 0, right_context: int = 0) -> torch.Tensor:
    """[H, W, D] int8 cost volume |rank_l(x) - rank_r(x - md - d)| from
    int32 rank maps (``ops.census.rank_transform``), left [H, W] and right
    [H, W + right_context], any D in [1, 256]: K1's absolute-difference
    form.

    CPU tensors take the plain version (``ops.cost``); CUDA tensors launch
    the kernel.
    """
    if rl.ndim != 2:
        raise ValueError(f"expected [H, W] rank maps: {rl.shape}")
    _check_framing("rank maps", rl, rr, x_offset, right_context)
    if cfg.cost_fn != "rank":
        raise ValueError(f"rank_cost needs cost_fn='rank', got {cfg.cost_fn}")
    if on_cpu(rl, rr):
        return rank_cost_from_descriptors(
            rl, rr, cfg, x_offset, right_context).to(cfg.cost_volume_dtype)
    out = _launch_descriptor_cost(rl, rr, 1, _ABS_DIFF, cfg, x_offset,
                                  right_context)
    count_launch(rank_cost, *out.shape, bool(x_offset or right_context))
    return out


rank_cost.forms = Counter()


def sad_cost(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
             x_offset: int = 0, right_context: int = 0) -> torch.Tensor:
    """[H, W, D] int16 SAD cost volume of a left [H, W] and a right
    [H, W + right_context] image, any D in [1, 256]; ``x_offset`` is the
    block's global column origin. CPU tensors take the plain version
    (``ops.cost``); CUDA tensors launch the kernel."""
    if left.ndim != 2:
        raise ValueError(f"expected [H, W] images: {left.shape}")
    _check_framing("images", left, right, x_offset, right_context)
    if cfg.cost_fn != "sad":
        raise ValueError(f"sad_cost needs cost_fn='sad', got {cfg.cost_fn}")
    if on_cpu(left, right):
        return sad_cost_volume(left, right, cfg, x_offset,
                               right_context).to(torch.int16)
    h, w = left.shape
    d = cfg.num_disparities
    wy, wx = cfg.sad_window
    require_disparities(d)
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
        cfg.max_unary_cost, right_context, x_offset)
    count_launch(sad_cost, h, w, d, wy, wx, bool(x_offset),
                 bool(right_context))
    return out


sad_cost.forms = Counter()
