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
the block in the right descriptors or image (``ops.cost``). The origin is
negative for a tile on the frame's left edge (``parallel/tiling.py``, the
reference's traced tile origin ``ix * bw - halo``): the voxels whose global
column ``x_offset + x - md - d`` is below 0 take ``max_unary_cost``, as at
any origin. Each wrapper counts a launch under the sign of the origin
(``origin_sign``), so a tile at a negative origin is a form of its own.
"""

from __future__ import annotations

import functools
import struct
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
    launch the kernel, one launch per image (an image that is not
    contiguous or does not start on a 16-byte boundary is copied once).
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
    if not img.is_contiguous() or img.data_ptr() % 16:
        # e.g. frame i of a stacked batch of 375 x 1242 uint8 frames
        img = img.clone(memory_format=torch.contiguous_format)
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


def origin_sign(x_offset: int) -> int:
    """-1, 0 or 1: the sign of a block's origin, as a launch form counts
    it (0 and 1 compare equal to False and True)."""
    return (x_offset > 0) - (x_offset < 0)


def _check_framing(what: str, left: torch.Tensor, right: torch.Tensor,
                   x_offset: int, right_context: int) -> None:
    """Raise unless ``right`` is ``left``'s shape with ``right_context``
    extra leading columns, ``right_context`` >= 0 and ``x_offset`` an int
    (of any sign). ``what`` names the two inputs in the message."""
    if not isinstance(x_offset, int) or right_context < 0:
        raise ValueError(f"x_offset {x_offset} must be an int and "
                         f"right_context {right_context} >= 0")
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
                 origin_sign(x_offset) or bool(right_context))
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
    count_launch(rank_cost, *out.shape,
                 origin_sign(x_offset) or bool(right_context))
    return out


rank_cost.forms = Counter()


#: Largest SAD window side the kernel takes: its tiles stage a halo of at
#: most 8 rows and columns, the row limit of the reference's TPU kernel
#: (stereo_tpu/ops/pallas/cost_kernel.py:sad_kernel_supported).
SAD_MAX_WINDOW = 17

#: int32 and float32 images go to the kernel with values in
#: [-SAD_MAX_VALUE, SAD_MAX_VALUE] (16-bit sensors, of either sign): every
#: window sum is then at most 2 * 65535 * 17 * 17 < 2^31, where the
#: kernel's 32-bit sums and ``sad_divisor`` are exact.
SAD_MAX_VALUE = 65535


@functools.lru_cache(maxsize=None)
def sad_divisor(area: int) -> Tuple[int, int]:
    """(magic, shift) with ``floor(n / area) == (n * magic) >> shift`` for
    every 0 <= n < 2^31: K5's division of the integer window sums of int32
    and float32 images by the window's area, one 32x32->64-bit multiply
    and a shift on the card.

    shift = 31 + ceil(log2(area)) and magic = ceil(2^shift / area), so
    0 <= magic * area - 2^shift < area <= 2^(shift - 31): the round-up
    method (Granlund and Montgomery, PLDI 1994), which is exact for
    dividends below 2^31. magic < 2^32."""
    if area < 1:
        raise ValueError(f"area must be >= 1, got {area}")
    shift = 31 + (area - 1).bit_length()
    return -(-(1 << shift) // area), shift


@functools.lru_cache(maxsize=None)
def sad_reciprocal(area: int) -> Tuple[float, float]:
    """(inv, bias) = (f32(1 / area), f32(0.5 / area)), K5's divide of the
    float window sums of uint8 images: for every sum 0 <= n <= 255 * area,
    ``floor(f32(n * inv + bias)) == n // area`` with one rounding (a fused
    multiply-add), and the kernel takes the floor with a round-down add.

    (n + 1/2) / area lies at least 1 / (2 * area) from an integer, and the
    rounding of inv and of the fused multiply-add move it by less than
    2^-14 for n below 2^17 and areas up to 17 * 17."""
    if area < 1:
        raise ValueError(f"area must be >= 1, got {area}")
    return _f32(1.0 / area), _f32(0.5 / area)


def _f32(x: float) -> float:
    """``x`` rounded to float32 (to nearest)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _sad_images(left: torch.Tensor, right: torch.Tensor):
    """The pair as K5 reads it: both uint8, both float32 or both int32 as
    they are, anything else converted to int32 (the reference's
    astype(int32)). Raises for values outside the range the kernel's sums
    admit (``SAD_MAX_VALUE``; one reduction and a wait for the card per
    image that is not uint8)."""
    for name, img in (("left", left), ("right", right)):
        if img.dtype in (torch.uint8, torch.bool):
            continue
        lo, hi = torch.stack(torch.aminmax(img)).tolist()
        if not (-SAD_MAX_VALUE <= lo and hi <= SAD_MAX_VALUE):
            raise ValueError(
                f"{name}: the SAD kernel takes values in [-{SAD_MAX_VALUE}, "
                f"{SAD_MAX_VALUE}], got [{lo}, {hi}]")
    if left.dtype != right.dtype or left.dtype not in _IMAGE_TYPES:
        left, right = left.to(torch.int32), right.to(torch.int32)
    return left.contiguous(), right.contiguous()


def sad_cost(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
             x_offset: int = 0, right_context: int = 0) -> torch.Tensor:
    """[H, W, D] int16 SAD cost volume of a left [H, W] and a right
    [H, W + right_context] image, any D in [1, 256] and odd windows up to
    17x17; ``x_offset`` is the block's global column origin. CPU tensors
    take the plain version (``ops.cost``); CUDA tensors launch the kernel,
    which reads uint8, float32 (truncated toward zero) and int32 images as
    they are (``_sad_images``)."""
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
    if max(wy, wx) > SAD_MAX_WINDOW:
        raise ValueError(f"the CUDA SAD kernel takes windows up to "
                         f"{SAD_MAX_WINDOW}x{SAD_MAX_WINDOW}, got "
                         f"{cfg.sad_window}")
    if cfg.min_disparity < 0:
        raise ValueError("the CUDA cost kernel needs min_disparity >= 0")
    left, right = _sad_images(left, right)
    require(left, "left", left.dtype, 2, aligned=False)
    require(right, "right", left.dtype, 2, aligned=False)
    out = torch.empty((h, w, d), dtype=torch.int16, device=left.device)
    magic, shift = sad_divisor(wy * wx)
    inv, bias = sad_reciprocal(wy * wx)
    run("stpu_sad_cost", left.device, left.data_ptr(), right.data_ptr(),
        out.data_ptr(), h, w, d, int(cfg.min_disparity), wy, wx,
        cfg.max_unary_cost, right_context, x_offset,
        _IMAGE_TYPES[left.dtype], magic, shift, inv, bias)
    count_launch(sad_cost, h, w, d, wy, wx, origin_sign(x_offset),
                 bool(right_context), str(left.dtype))
    return out


sad_cost.forms = Counter()
