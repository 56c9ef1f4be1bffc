"""Census and rank transforms and Hamming distance.

Twin of ``stereo_tpu/ops/census.py``. Descriptors keep the reference's
``[H, W, words]`` layout; each 32-bit word is held in an int64 with a value
in ``[0, 2^32)``, because torch's uint32 supports few ops.

``census_transform`` and ``rank_transform`` run their plain torch twins
(``census_transform_plain``, ``rank_transform_plain``) on a CPU tensor and
K1's transform stage (``ops.cuda.transform_words``) on a CUDA tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _neighbors(img: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """[wy*wx - 1, H, W]: the off-centre window neighbours of every pixel
    in row-major order, borders replicating the edge pixel."""
    wy, wx = window
    ry, rx = wy // 2, wx // 2
    h, w = img.shape
    dev = img.device
    offsets = [(dy - ry, dx - rx) for dy in range(wy) for dx in range(wx)
               if (dy, dx) != (ry, rx)]
    oy = torch.tensor([o[0] for o in offsets], device=dev)
    ox = torch.tensor([o[1] for o in offsets], device=dev)
    rows = (torch.arange(h, device=dev)[None, :] + oy[:, None]).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev)[None, :] + ox[:, None]).clamp(0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def _check_window(window: Tuple[int, int], what: str, bits: bool) -> None:
    """Raise unless ``window`` is odd in both dims and, for a census
    (``bits``), has at most 64 off-centre pixels."""
    wy, wx = window
    if wy % 2 == 0 or wx % 2 == 0:
        raise ValueError(f"{what} window dims must be odd")
    if bits and wy * wx - 1 > 64:
        raise ValueError("census descriptor limited to 64 bits")


def census_transform(img: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Census descriptor per pixel, as ``census_transform_plain`` defines
    it: the plain twin on a CPU tensor, K1's transform stage on a CUDA
    tensor (its 32-bit words widened to int64 in [0, 2^32))."""
    if img.device.type == "cpu":
        return census_transform_plain(img, window)
    from .cuda import transform_words

    return transform_words(img, window).to(torch.int64) & 0xFFFFFFFF


def census_transform_plain(img: torch.Tensor, window: Tuple[int, int]
                           ) -> torch.Tensor:
    """Census descriptor per pixel (plain torch, any device).

    Args:
      img: [H, W] image (uint8 or float); comparisons use raw values.
      window: (rows, cols), both odd, at most 64 bits (rows*cols - 1).

    Returns:
      [H, W, n_words] int64 descriptor words in [0, 2^32). Bit k is 1 iff
      the k-th off-center neighbor (row-major order) is strictly less than
      the center pixel; it lands in word k // 32 at bit k % 32. Borders
      replicate the edge pixel.
    """
    _check_window(window, "census", bits=True)
    bits = window[0] * window[1] - 1
    img = img.to(torch.int32)
    dev = img.device
    neighbors = _neighbors(img, window)                       # [bits, H, W]
    set_bits = (neighbors < img).to(torch.int64)
    weight = 1 << (torch.arange(bits, device=dev) % 32)       # [bits]
    words = [
        (set_bits[i:i + 32] * weight[i:i + 32, None, None]).sum(dim=0)
        for i in range(0, bits, 32)
    ]
    return torch.stack(words, dim=-1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR; torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...] int32 popcount(a XOR b) summed over the trailing word axis of
    two [..., n_words] descriptors."""
    return _popcount32(a ^ b).sum(dim=-1).to(torch.int32)


def rank_transform(img: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """[H, W] int32 rank transform as ``rank_transform_plain`` defines it:
    the plain twin on a CPU tensor, K1's transform stage on a CUDA
    tensor."""
    if img.device.type == "cpu":
        return rank_transform_plain(img, window)
    from .cuda import transform_words

    return transform_words(img, window, rank=True)


def rank_transform_plain(img: torch.Tensor, window: Tuple[int, int]
                         ) -> torch.Tensor:
    """[H, W] int32 rank transform (plain torch, any device): the count of
    window neighbours strictly below the centre pixel (the scalar cousin of
    census; its cost is the absolute rank difference). Borders replicate
    the edge pixel."""
    _check_window(window, "rank", bits=False)
    img = img.to(torch.int32)
    return (_neighbors(img, window) < img).sum(dim=0, dtype=torch.int32)
