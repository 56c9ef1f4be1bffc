"""The work a frame needs, from its shape alone, and the card's published peaks.

A frozen copy of the engine's byte and operation models
(``eval/roofline.py`` as it stood when the benchmark was defined), so that a
change to the engine cannot move the yardstick. Bytes count each input read
once and each output written once; operations are the elementwise integer
work of each stage.
"""

from __future__ import annotations

from typing import Dict

#: Published peaks of one NVIDIA H100 SXM (data sheet, 700 W): device memory
#: bandwidth, and the float32 rate outside the tensor cores, which the
#: integer ALU work is held against (a fused multiply-add counts two).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

#: Operations per voxel: the census cost stage (two words: xor, bit count,
#: add), each SGM path direction (3 adds, 5 mins counting the reduction, the
#: renormalising subtract, the accumulate), the selection (compares and
#: selects).
COST_OPS_PER_VOXEL = 5
PATH_OPS_PER_VOXEL = 10
SELECT_OPS_PER_VOXEL = 6
#: Operations per pixel of the 3x3 median: 19 exchanges of a min and a max.
MEDIAN_OPS_PER_PIXEL = 38


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger (ms)."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S) * 1e3


def paths_bound_ms(h: int, w: int, d: int, num_paths: int,
                   cost_bytes: int = 1) -> float:
    """K2, all directions of a frame: the cost volume in, the int16 sum out,
    ``PATH_OPS_PER_VOXEL`` per voxel and direction."""
    return bound_ms(h * w * d * (cost_bytes + 2),
                    h * w * d * num_paths * PATH_OPS_PER_VOXEL)


def frame_work(h: int, w: int, cfg: Dict) -> Dict[str, float]:
    """The whole frame: every stage's operations (census transform of both
    images, cost, paths, selection, median) and only the bytes no
    implementation can avoid (the uint8 pair in, float32 disparity and one
    validity byte out)."""
    d = cfg["num_disparities"]
    wy, wx = cfg["census_window"]
    voxels = h * w * d
    ops = (2 * h * w * (wy * wx - 1) * 2
           + voxels * COST_OPS_PER_VOXEL
           + voxels * cfg["num_paths"] * PATH_OPS_PER_VOXEL
           + voxels * SELECT_OPS_PER_VOXEL
           + (h * w * MEDIAN_OPS_PER_PIXEL if cfg["median_filter"] else 0))
    nbytes = h * w * (2 + 4 + 1)
    return {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms(nbytes, ops)}
