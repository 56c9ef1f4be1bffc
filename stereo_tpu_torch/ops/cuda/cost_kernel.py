"""K1 and K5 wrappers: the census and rank transforms and the
census-Hamming and rank cost volumes (csrc/census_cost.cu), and the SAD
cost volume (csrc/sad_cost.cu).

K1 replaces ``stereo_tpu/ops/pallas/cost_kernel.py:census_cost_volume_pallas``
and ``rank_cost_volume_pallas``: ``transform_words`` is its transform stage
(the reference's ``census_transform`` / ``rank_transform`` calls, in XLA on
the TPU), one launch per image, which writes the 32-bit words the cost
stage reads; ``census_cost`` and ``rank_cost`` are its cost stage, which
replaces ``_cost_kernel_x`` and ``_cost_kernel`` (D below 128). K5
replaces ``_sad_kernel`` (through ``sad_cost_volume_pallas``).

For a block of a larger frame the wrappers take the block's global column
origin ``x_offset`` and ``right_context`` frame-true columns that precede
the block in the right descriptors or image (``ops.cost``).
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch

from ...config import StereoConfig
from ..census import (
    _check_window,
    census_transform_plain,
    rank_transform_plain,
)
from ..cost import (
    census_cost_from_descriptors,
    rank_cost_from_descriptors,
    sad_cost_volume,
)
from .launch import count_launch, on_cpu, require, require_disparities, run

#: The kernel's combine of a left and a right descriptor.
_HAMMING, _ABS_DIFF = 0, 1

#: Image types the transform stage reads as they are (any other is
#: converted to int32 first), by the kernel's code for them.
_IMAGE_TYPES = {torch.uint8: 0, torch.float32: 1, torch.int32: 2}


def transform_words(img: torch.Tensor, window: Tuple[int, int],
                    rank: bool = False) -> torch.Tensor:
    """K1's transform stage on an [H, W] image: the census words as int32
    [H, W, words] (the bits of ``ops.census.census_transform``, each word
    held in an int32), or with ``rank`` the [H, W] int32 rank map. Values
    compare as int32 (float32 truncated toward zero), borders replicate the
    edge pixel.

    CPU tensors take the plain version (``ops.census``); CUDA tensors
    launch the kernel, one launch per image.
    """
    if img.ndim != 2:
        raise ValueError(f"expected an [H, W] image: {tuple(img.shape)}")
    _check_window(window, "rank" if rank else "census", bits=not rank)
    wy, wx = window
    if on_cpu(img):
        if rank:
            return rank_transform_plain(img, window)
        return census_transform_plain(img, window).to(torch.int32)
    if img.dtype not in _IMAGE_TYPES:
        img = img.to(torch.int32)
    img = img.contiguous()
    require(img, "image", img.dtype, 2)
    h, w = img.shape
    words = (wy * wx + 30) // 32
    shape = (h, w) if rank else (h, w, words)
    out = torch.empty(shape, dtype=torch.int32, device=img.device)
    run("stpu_census_transform", img.device, img.data_ptr(), out.data_ptr(),
        h, w, wy, wx, _IMAGE_TYPES[img.dtype], int(rank))
    count_launch(transform_words, h, w, wy, wx, rank, str(img.dtype))
    return out


transform_words.forms = Counter()


def _plain_words(t: torch.Tensor) -> torch.Tensor:
    """Census words as the plain Hamming takes them: int64 in [0, 2^32)
    (from int64 words, or int32 ones holding the same 32 bits)."""
    return t.to(torch.int64) & 0xFFFFFFFF


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
    """K1's cost stage on a left [H, W, ...] and a right
    [H, W + right_context, ...] plane of int32 descriptors, as
    ``transform_words`` writes them: [H, W, D] int8."""
    h, w = dl.shape[:2]
    d = cfg.num_disparities
    require_disparities(d)
    if cfg.min_disparity < 0:
        raise ValueError("the CUDA cost kernel needs min_disparity >= 0")
    require(dl, "left descriptors", torch.int32, dl.ndim)
    require(dr, "right descriptors", torch.int32, dl.ndim)
    out = torch.empty((h, w, d), dtype=torch.int8, device=dl.device)
    run("stpu_census_cost", dl.device, dl.data_ptr(), dr.data_ptr(),
        out.data_ptr(), h, w, d, words, combine, int(cfg.min_disparity),
        cfg.max_unary_cost, right_context, x_offset)
    return out


def census_cost(cl: torch.Tensor, cr: torch.Tensor, cfg: StereoConfig,
                x_offset: int = 0, right_context: int = 0) -> torch.Tensor:
    """[H, W, D] int8 cost volume from census descriptors, left
    [H, W, words] and right [H, W + right_context, words], any D in
    [1, 256]: K1's cost stage.

    CPU tensors take the plain version (``ops.cost``), from int32 words
    (``transform_words``) or int64 ones (``ops.census.census_transform``);
    CUDA tensors launch the kernel on int32 words (``transform_words``).
    """
    if cl.ndim != 3:
        raise ValueError(f"expected [H, W, words] descriptors: {cl.shape}")
    _check_framing("descriptors", cl, cr, x_offset, right_context)
    if cfg.cost_fn != "census":
        raise ValueError(f"census_cost needs cost_fn='census', got {cfg.cost_fn}")
    if on_cpu(cl, cr):
        return census_cost_from_descriptors(
            _plain_words(cl), _plain_words(cr), cfg, x_offset,
            right_context).to(cfg.cost_volume_dtype)
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
    int32 rank maps (``transform_words(..., rank=True)``), left [H, W] and
    right [H, W + right_context], any D in [1, 256]: K1's
    absolute-difference form.

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
