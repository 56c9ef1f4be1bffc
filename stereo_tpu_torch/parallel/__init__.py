"""Processing a frame in pieces: row bands and column patches on one
device (``bands``), the halo-exchange tile grid (``tiling``) over the
tiles of a ``TileMesh`` (``mesh``), in one process or one
``torch.distributed`` rank per tile, the batched video stream over the
mesh's 'batch' replicas (``stream``), and the exact reshard mode
(``exact``): the reference's all-to-all between SGM's pass families,
written out over the same grid, bit-identical to the whole frame."""

from .bands import BandPlan, build_banded_pipeline, plan_bands
from .exact import build_exact_pipeline
from .mesh import TileMesh, initialize_multihost, make_tile_mesh
from .stream import StreamResult, StreamRunner, build_stream_pipeline
from .tiling import build_halo_pipeline

__all__ = ["BandPlan", "build_banded_pipeline", "plan_bands", "TileMesh",
           "StreamResult", "StreamRunner", "build_exact_pipeline",
           "build_halo_pipeline", "build_stream_pipeline",
           "initialize_multihost", "make_tile_mesh"]
