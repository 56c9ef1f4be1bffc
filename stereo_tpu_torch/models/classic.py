"""Reference-parity models: full SGM and plain block matching."""

from __future__ import annotations

from ..config import KITTI_SGM8_128, TSUKUBA_SAD16, StereoConfig
from ..pipeline import build_pipeline
from .base import StereoModel


class ClassicSGM(StereoModel):
    """The full census/rank/SAD + SGM pipeline (the reference's model)."""

    name = "classic"

    def __init__(self, cfg: StereoConfig = KITTI_SGM8_128):
        super().__init__(cfg)

    def build(self, device="cuda"):
        return build_pipeline(self.cfg, device)


class BlockMatching(StereoModel):
    """Cost volume + WTA with no path aggregation."""

    name = "block_matching"

    def __init__(self, cfg: StereoConfig = TSUKUBA_SAD16):
        super().__init__(cfg.replace(num_paths=0))

    def build(self, device="cuda"):
        return build_pipeline(self.cfg, device)
