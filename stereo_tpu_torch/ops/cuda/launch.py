"""Shared checks and the launch call of the kernel wrappers.

A wrapper runs its plain torch version only for tensors on the CPU; for
CUDA tensors it checks them, launches its kernel on the current stream, or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from .build import check_launch, load_kernels

#: Most disparities the kernels take: one warp holds D in 32 lanes, up to
#: 8 to a lane.
MAX_DISPARITIES = 256


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if every one is on CUDA;
    raises for a mix or another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA: {kinds}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            aligned: bool = True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` with
    ``ndim`` dimensions, 16-byte aligned unless ``aligned`` is False."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
        raise ValueError(f"{name}: must be contiguous"
                         + " and 16-byte aligned" * aligned)


def require_disparities(d: int) -> None:
    if not 1 <= d <= MAX_DISPARITIES:
        raise ValueError(
            f"the CUDA kernels take num_disparities in "
            f"[1, {MAX_DISPARITIES}], got {d}"
        )


def count_launch(wrapper, *form) -> None:
    """Add one to ``wrapper``'s count of kernel launches, under ``form``:
    the shape and whatever else picks the kernel's instantiation. Called
    where the wrapper launches its kernel, and nowhere else."""
    wrapper.forms[form] += 1


def run(fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` with ``args`` and ``device``'s current
    stream; raise if the launch reported an error."""
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    check_launch(fn, err)
