"""K6 wrapper: the ALU peak anchor (csrc/alu_peak.cu).

Replaces the local kernel of
``stereo_tpu/eval/roofline.py:_measure_vpu_peak_one`` (reached through
``pl.pallas_call`` at roofline.py:154): per element, ``chains`` independent
accumulators run ``k / chains`` dependent ``min(a + 1, BIG)`` steps in
registers and are summed, 2k operations for one load and one store.
``eval.roofline.measure_alu_peak`` times it over the reference's programs.
"""

from __future__ import annotations

from collections import Counter

import torch

from .launch import count_launch, on_cpu, require, run

#: The reference's anchor programs as (k, chains); the kernel is
#: instantiated for these.
PROGRAMS = ((256, 4), (512, 4), (256, 8), (512, 8), (256, 16), (256, 2))

#: Saturation value and seed spacing by element type. float32 is the
#: reference's; int32 is what the cost, path and selection kernels issue.
_BIG = {torch.float32: 3e38, torch.int32: 1 << 30}
_SEED = {torch.float32: 0.25, torch.int32: 1}


def alu_peak_plain(x: torch.Tensor, k: int, chains: int) -> torch.Tensor:
    """The chain in closed form: a chain seeded with ``x + c * q`` (q = 1/4
    for float32, 1 for int32) grows by 1 per step until it saturates, so
    after ``k // chains`` steps it holds ``min(x + c * q + k // chains,
    BIG)``; the result is the sum over c. Equal to the step-by-step chain
    wherever each step is exact: float32 inputs that are multiples of 1/4
    below 2^20, any int32 input below 2^30."""
    steps = k // chains
    big, seed = _BIG[x.dtype], _SEED[x.dtype]
    total = torch.zeros_like(x)
    for c in range(chains):
        total = total + torch.clamp(x + c * seed + steps, max=big)
    return total


def alu_peak(x: torch.Tensor, k: int, chains: int) -> torch.Tensor:
    """``alu_peak_plain`` as one kernel launch: ``x`` is a contiguous float32
    or int32 tensor of any shape, ``(k, chains)`` one of ``PROGRAMS``. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.dtype not in _BIG:
        raise TypeError(f"expected float32 or int32, got {x.dtype}")
    if (k, chains) not in PROGRAMS:
        raise ValueError(f"(k, chains) must be one of {PROGRAMS}, got "
                         f"{(k, chains)}")
    if on_cpu(x):
        return alu_peak_plain(x, k, chains)
    require(x, "x", x.dtype, x.dim())
    out = torch.empty_like(x)
    run("stpu_alu_peak", x.device, x.data_ptr(), out.data_ptr(), x.numel(), k,
        chains, int(x.dtype == torch.int32))
    count_launch(alu_peak, x.numel(), str(x.dtype), k, chains)
    return out


alu_peak.forms = Counter()
