"""Processing a frame in pieces on one device: row bands and column
patches (``bands``). The multi-device tilings of the reference
(``stereo_tpu/parallel/{mesh,tiling,exact,stream}.py``) are not ported."""

from .bands import BandPlan, build_banded_pipeline, plan_bands

__all__ = ["BandPlan", "build_banded_pipeline", "plan_bands"]
