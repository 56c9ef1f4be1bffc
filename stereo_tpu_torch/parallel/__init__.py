"""Processing a frame in pieces: row bands and column patches on one
device (``bands``), and the halo-exchange tile grid (``tiling``) over the
tiles of a ``TileMesh`` (``mesh``), in one process or one
``torch.distributed`` rank per tile. The reference's exact reshard mode
(``stereo_tpu/parallel/exact.py``) and its stream (``stream.py``) are not
ported."""

from .bands import BandPlan, build_banded_pipeline, plan_bands
from .mesh import TileMesh, initialize_multihost, make_tile_mesh
from .tiling import build_halo_pipeline


def build_exact_pipeline(*args, **kwargs):
    """The reference's exact reshard mode; not ported yet."""
    raise NotImplementedError(
        "build_exact_pipeline (the exact reshard mode) is not ported yet "
        "(ROADMAP Queue 1: parallel/exact.py)")


__all__ = ["BandPlan", "build_banded_pipeline", "plan_bands", "TileMesh",
           "build_exact_pipeline", "build_halo_pipeline",
           "initialize_multihost", "make_tile_mesh"]
