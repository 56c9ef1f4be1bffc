"""Tile meshes and multi-process bring-up.

Twin of ``stereo_tpu/parallel/mesh.py``. A ``TileMesh`` names the tile
grid ('batch', 'ty', 'tx') and one device per tile. Made in a process
without a ``torch.distributed`` process group it is a local grid: one
process runs every tile (``parallel/tiling.py``), the form a single card
uses. Made under a process group of more than one process it is a
distributed grid: each rank runs one tile, rank r the r-th in row-major
order, and the ranks exchange halo strips point to point.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the ``torch.distributed`` process group (no-op for one
    process).

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://`` is
    added), ``num_processes`` the world size and ``process_id`` this
    process's rank; nothing is read from the environment. The backend is
    ``nccl`` where a CUDA card is present and ``gloo`` otherwise.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError("initialize_multihost needs the coordinator's "
                         "address, the number of processes and this "
                         "process's id")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square (a, b) with a * b = n, a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


class TileMesh(NamedTuple):
    """A ('batch', 'ty', 'tx') grid of tiles: ``devices`` holds one device
    per tile in row-major order; ``distributed``: one rank per tile."""

    batch: int
    ty: int
    tx: int
    devices: Tuple[torch.device, ...]
    distributed: bool

    @property
    def shape(self):
        return {"batch": self.batch, "ty": self.ty, "tx": self.tx}

    def device(self, b: int, iy: int, ix: int) -> torch.device:
        return self.devices[(b * self.ty + iy) * self.tx + ix]


def cuda_devices(n: int = 0):
    """``n`` CUDA devices, the cards in turn (card i % count), or every
    card when ``n`` is 0; raises RuntimeError without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass the CPU explicitly to run "
                           "there")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n or count)]


def make_tile_mesh(
    devices: Optional[Sequence] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    batch: int = 1,
) -> TileMesh:
    """Mesh over ('batch', 'ty', 'tx').

    'ty'/'tx' tile image rows/columns; 'batch' replicates the grid. With
    ``mesh_shape=None`` the non-batch devices are factored as square as
    possible, favouring 'ty' (row tiling needs no disparity-aware halo).
    ``devices`` may repeat one device (a local grid on one card). Default:
    one CUDA device per process of the process group (rank r on card r
    modulo the count), or without a group every CUDA card; without a card
    the default raises RuntimeError (pass the CPU to run there).
    """
    procs = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if devices is None:
        devices = cuda_devices(procs if procs > 1 else 0)
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    if mesh_shape is None:
        a, b = _factor2(n // batch)
        mesh_shape = (b, a)  # favor more row tiles
    ty, tx = mesh_shape
    if batch * ty * tx != n:
        raise ValueError(f"batch*ty*tx={batch*ty*tx} != {n} devices")
    if procs > 1 and n != procs:
        raise ValueError(f"a distributed grid has one tile per process: "
                         f"{n} devices for {procs} processes")
    return TileMesh(batch, ty, tx, devices, procs > 1)
