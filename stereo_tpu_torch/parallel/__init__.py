"""Processing a frame in pieces: row bands and column patches on one
device (``bands``), the halo-exchange tile grid (``tiling``) over the
tiles of a ``TileMesh`` (``mesh``), in one process or one
``torch.distributed`` rank per tile, and the batched video stream over the
mesh's 'batch' replicas (``stream``). The reference's exact reshard mode
(``stereo_tpu/parallel/exact.py``) is not ported."""

from .bands import BandPlan, build_banded_pipeline, plan_bands
from .mesh import TileMesh, initialize_multihost, make_tile_mesh
from .stream import StreamResult, StreamRunner, build_stream_pipeline
from .tiling import build_halo_pipeline


def build_exact_pipeline(*args, **kwargs):
    """The reference's exact reshard mode; not ported yet."""
    raise NotImplementedError(
        "build_exact_pipeline (the exact reshard mode) is not ported yet "
        "(ROADMAP Queue 1: parallel/exact.py)")


__all__ = ["BandPlan", "build_banded_pipeline", "plan_bands", "TileMesh",
           "StreamResult", "StreamRunner", "build_exact_pipeline",
           "build_halo_pipeline", "build_stream_pipeline",
           "initialize_multihost", "make_tile_mesh"]
