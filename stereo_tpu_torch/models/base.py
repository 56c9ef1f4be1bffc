"""Common model interface."""

from __future__ import annotations

from typing import Callable

from ..config import StereoConfig


class StereoModel:
    """A named, configured disparity estimator.

    ``build(device)`` returns ``(left, right) -> StereoResult`` with the
    work on ``device``; models are pure functions of their config (no
    trained weights in classical stereo: the "parameters" are penalties
    and windows).
    """

    name: str = "base"

    def __init__(self, cfg: StereoConfig):
        self.cfg = cfg

    def build(self, device="cuda") -> Callable:
        raise NotImplementedError

    def describe(self) -> dict:
        return {
            "model": self.name,
            "cost_fn": self.cfg.cost_fn,
            "D": self.cfg.num_disparities,
            "paths": self.cfg.num_paths,
        }
