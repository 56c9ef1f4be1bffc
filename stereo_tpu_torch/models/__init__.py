"""Model zoo: named stereo-matching model families behind one interface.

  * ``ClassicSGM``     -- the full reference-parity pipeline.
  * ``BlockMatching``  -- cost + WTA only (no path aggregation).
  * ``PyramidSGM``     -- coarse-to-fine: half-resolution SGM predicts a
    base disparity, the full-resolution pass only searches a small
    residual window around it (see pyramid.py).

``get_model(name, **kw)`` builds by name for the CLI and the evaluation
suite; twin of ``stereo_tpu/models``.
"""

from .base import StereoModel
from .classic import BlockMatching, ClassicSGM
from .pyramid import PyramidSGM

MODELS = {
    "classic": ClassicSGM,
    "block_matching": BlockMatching,
    "pyramid": PyramidSGM,
}


def get_model(name: str, **kwargs) -> StereoModel:
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; valid: {sorted(MODELS)}")
    return MODELS[name](**kwargs)


__all__ = [
    "StereoModel",
    "ClassicSGM",
    "BlockMatching",
    "PyramidSGM",
    "MODELS",
    "get_model",
]
