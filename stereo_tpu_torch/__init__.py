"""stereo_tpu_torch — the stereo engine on PyTorch and hand-written Hopper
CUDA kernels.

A port of ``stereo_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference: census, rank or SAD cost -> 4/8-path SGM (fixed or adaptive
P2) -> WTA + subpixel + uniqueness + cheap or exact LR check -> 3x3 median
-> host speckle filter and occlusion fill, bit-identical to the reference;
``models`` holds the classic, block-matching and pyramid families and
``eval`` the hard evaluation suite. Imports torch and numpy, never jax.
"""

from .config import (
    KITTI_SGM8_128,
    KITTI_SGM8_128_QUALITY,
    KITTI_STREAM_MULTIHOST,
    MIDDLEBURY_CENSUS_SGM4_64,
    MIDDLEBURY_FULL_256_TILED,
    PRESETS,
    TSUKUBA_SAD16,
    StereoConfig,
    TileConfig,
    from_reference,
)
from .pipeline import (
    StereoResult,
    build_pipeline,
    compute_disparity,
    host_postprocess,
)

__version__ = "0.1.0"

__all__ = [
    "StereoConfig",
    "TileConfig",
    "StereoResult",
    "build_pipeline",
    "compute_disparity",
    "host_postprocess",
    "from_reference",
    "PRESETS",
    "KITTI_SGM8_128",
    "KITTI_SGM8_128_QUALITY",
    "MIDDLEBURY_CENSUS_SGM4_64",
    "TSUKUBA_SAD16",
    "MIDDLEBURY_FULL_256_TILED",
    "KITTI_STREAM_MULTIHOST",
]
