"""Static pipeline configuration, field for field the JAX package's.

``StereoConfig``, ``TileConfig`` and ``PRESETS`` mirror
``stereo_tpu/config.py`` exactly (the port tests hold every preset against
the reference), with two differences:

  * ``backend`` selects between the plain torch ops and the hand-written
    CUDA kernels: ``"auto"`` runs the kernels on CUDA tensors and the plain
    ops on CPU tensors, ``"torch"`` forces the plain ops on any device,
    ``"cuda"`` forces the kernels (and raises on CPU tensors);
  * ``cost_volume_dtype`` is a torch dtype.

The classic SGM path has no learned weights; its "parameters" are this
config, and ``from_reference`` carries a reference config across
(``from_reference(dataclasses.asdict(jax_cfg))``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Full static configuration of the stereo pipeline (see the JAX twin
    for the meaning and tuning history of every field)."""

    # --- matching cost -----------------------------------------------------
    cost_fn: str = "census"            # "census" (Hamming) | "sad" | "rank"
    census_window: Tuple[int, int] = (5, 5)   # (rows, cols); 5x5 -> 24-bit
    sad_window: Tuple[int, int] = (9, 9)      # block-matching window

    # --- cost volume -------------------------------------------------------
    num_disparities: int = 64          # D
    min_disparity: int = 0

    # --- SGM aggregation ---------------------------------------------------
    num_paths: int = 8                 # 0 (plain WTA), 4 (HV), 8 (HV+diag)
    p1: int = 10                       # small-change penalty
    p2: int = 120                      # discontinuity penalty
    adaptive_p2: bool = False          # P2 / |dI| scaling (Hirschmueller '08)
    p2_min: int = 30                   # floor for adaptive P2
    adaptive_grad_floor: int = 0       # sensor-noise floor for adaptive P2

    # --- selection / refinement -------------------------------------------
    subpixel: bool = True              # parabola fit around the WTA winner
    lr_check: bool = True              # left-right consistency
    lr_tau: float = 1.0                # max |d_L - d_R| allowed
    lr_exact: bool = False             # True: full 2nd pass for the right view
    uniqueness_ratio: float = 0.0      # 0 disables; else best/second-best gate

    # --- post-filter -------------------------------------------------------
    median_filter: bool = True         # 3x3 median on the disparity map
    speckle_max_size: int = 0          # 0 disables speckle removal
    speckle_rel: float = 0.0           # speckle size as a fraction of H*W
    speckle_tau: float = 2.0
    fill_occlusions: bool = False      # fill invalid pixels from row neighbors

    # --- numerics ----------------------------------------------------------
    cost_dtype: str = "int32"          # plain-path cost dtype
    backend: str = "auto"              # "auto" | "torch" | "cuda"

    def __post_init__(self) -> None:
        if self.cost_fn not in ("census", "sad", "rank"):
            raise ValueError(
                f"cost_fn must be census|sad|rank, got {self.cost_fn}"
            )
        if self.num_paths not in (0, 4, 8):
            raise ValueError(f"num_paths must be 0|4|8, got {self.num_paths}")
        if self.num_disparities < 1:
            raise ValueError("num_disparities must be >= 1")
        cw = self.census_window
        if cw[0] % 2 == 0 or cw[1] % 2 == 0:
            raise ValueError("census_window dims must be odd")
        if cw[0] * cw[1] - 1 > 64:
            raise ValueError("census descriptor limited to 64 bits")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )

    @property
    def census_words(self) -> int:
        """Number of 32-bit words holding the census descriptor."""
        bits = self.census_window[0] * self.census_window[1] - 1
        return (bits + 31) // 32

    @property
    def max_unary_cost(self) -> int:
        """Upper bound of the per-pixel matching cost (drives dtype choice)."""
        if self.cost_fn in ("census", "rank"):
            return self.census_window[0] * self.census_window[1] - 1
        return 255

    @property
    def window_radius(self) -> int:
        """Descriptor/window support radius in pixels (max over y/x)."""
        win = (
            self.census_window
            if self.cost_fn in ("census", "rank")
            else self.sad_window
        )
        return max(win[0] // 2, win[1] // 2)

    @property
    def cost_volume_dtype(self) -> torch.dtype:
        """Narrowest exact dtype for the materialized cost volume: int8 for
        census/rank (costs <= 63), int16 for SAD (costs <= 255)."""
        return torch.int8 if self.max_unary_cost <= 127 else torch.int16

    def replace(self, **kw) -> "StereoConfig":
        return dataclasses.replace(self, **kw)


def from_reference(d: dict) -> StereoConfig:
    """The port's config for a reference config given as a plain dict
    (``dataclasses.asdict`` of a ``stereo_tpu.config.StereoConfig``).

    Tuples come back from JSON as lists and are restored; the reference's
    ``backend`` names a JAX execution mode, which has no meaning here, so
    the port's default (``"auto"``) is used.
    """
    names = {f.name for f in dataclasses.fields(StereoConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown StereoConfig fields {sorted(unknown)}")
    kw = {k: v for k, v in d.items() if k != "backend"}
    for k in ("census_window", "sad_window"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return StereoConfig(**kw)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Spatial tiling, field for field the reference's. The banded runner
    (``parallel/bands.py``) and the halo-tiled pipeline
    (``parallel/tiling.py``) take their default halo from
    ``resolved_halo``; ``mesh_shape`` is the tile grid (ty, tx) the tiled
    pipeline defaults to; ``batch_axis`` describes the reference's stream,
    which is not ported yet, and is kept so configs carry across."""

    mesh_shape: Tuple[int, int] = (1, 1)
    halo: Optional[int] = None
    batch_axis: bool = False

    def resolved_halo(self, cfg: StereoConfig) -> int:
        """The overlap width: ``halo`` if set, else the descriptor window's
        radius plus a 16-pixel strip in which SGM path costs settle before
        they enter the patch's interior."""
        if self.halo is not None:
            return self.halo
        warmup = 16
        return cfg.window_radius + warmup


def tile_from_reference(d: dict) -> TileConfig:
    """The port's TileConfig for a reference TileConfig given as a plain
    dict (``dataclasses.asdict``, possibly through JSON: lists become
    tuples again)."""
    names = {f.name for f in dataclasses.fields(TileConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown TileConfig fields {sorted(unknown)}")
    kw = dict(d)
    if "mesh_shape" in kw:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return TileConfig(**kw)


# ---------------------------------------------------------------------------
# Named presets, identical to stereo_tpu/config.py (tests hold them equal).
# ---------------------------------------------------------------------------

#: Config 1 — Middlebury Tsukuba pair, block SAD, 16 disparities, WTA.
TSUKUBA_SAD16 = StereoConfig(
    cost_fn="sad",
    sad_window=(9, 9),
    num_disparities=16,
    num_paths=0,
    subpixel=False,
    lr_check=True,
    median_filter=True,
)

#: Config 2 — Middlebury half-res, census + 4-path SGM, 64 disparities.
MIDDLEBURY_CENSUS_SGM4_64 = StereoConfig(
    cost_fn="census",
    census_window=(9, 7),
    num_disparities=64,
    num_paths=4,
    p1=14,
    p2=120,
    uniqueness_ratio=0.02,
    speckle_rel=80 / (160 * 288),
    subpixel=True,
    lr_check=True,
)

#: Config 3 — KITTI 2015 full-res, 8-path SGM, 128 disparities + subpixel
#: + LR check + uniqueness + resolution-relative speckle. The port's main
#: path.
KITTI_SGM8_128 = StereoConfig(
    cost_fn="census",
    census_window=(9, 7),
    num_disparities=128,
    num_paths=8,
    p1=14,
    p2=120,
    uniqueness_ratio=0.02,
    speckle_rel=80 / (160 * 288),
    subpixel=True,
    lr_check=True,
)

#: Config 3q — the quality variant: + adaptive P2 with a noise floor.
KITTI_SGM8_128_QUALITY = KITTI_SGM8_128.replace(
    adaptive_p2=True, adaptive_grad_floor=12, p2_min=30
)

#: Config 4 — Middlebury full-res 2880x1988, 256 disparities, tiled.
MIDDLEBURY_FULL_256_TILED = StereoConfig(
    cost_fn="census",
    census_window=(9, 7),
    num_disparities=256,
    num_paths=8,
    p1=14,
    p2=120,
    uniqueness_ratio=0.02,
    speckle_rel=80 / (160 * 288),
    subpixel=True,
    lr_check=True,
)

#: Config 5 — batched KITTI video stream; same per-frame pipeline as 3.
KITTI_STREAM_MULTIHOST = KITTI_SGM8_128

PRESETS = {
    "tsukuba_sad16": TSUKUBA_SAD16,
    "middlebury_census_sgm4_64": MIDDLEBURY_CENSUS_SGM4_64,
    "kitti_sgm8_128": KITTI_SGM8_128,
    "kitti_sgm8_128_quality": KITTI_SGM8_128_QUALITY,
    "middlebury_full_256_tiled": MIDDLEBURY_FULL_256_TILED,
    "kitti_stream_multihost": KITTI_STREAM_MULTIHOST,
}
