"""One rank of the distributed tile grid, for tests/test_torch_tiling.py.

Each process joins a gloo process group at a localhost address, runs its
tile of ``build_halo_pipeline`` on the CPU, and writes the replicated
frame it received to ``<outdir>/rank<r>.npz``. Imports no jax.

Usage: python torch_tile_worker.py <rank> <nprocs> <port> <outdir> <case>
where <case> is a JSON object: cfg (StereoConfig fields), shape, grid
(ty, tx), halo (or null), lr_stitch (or null), seed.
"""

import json
import os
import sys

rank, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
case = json.loads(sys.argv[5])

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stereo_tpu_torch.config import StereoConfig, TileConfig  # noqa: E402
from stereo_tpu_torch.data import make_pair  # noqa: E402
from stereo_tpu_torch.parallel import (  # noqa: E402
    build_halo_pipeline,
    initialize_multihost,
    make_tile_mesh,
)

torch.set_num_threads(1)
initialize_multihost(f"127.0.0.1:{port}", nprocs, rank)  # gloo: no card
cfg = StereoConfig(**case["cfg"])
grid = tuple(case["grid"])
pair = make_pair(tuple(case["shape"]), max_disp=12, kind="shapes",
                 seed=case["seed"])
mesh = make_tile_mesh(["cpu"] * nprocs, mesh_shape=grid)
assert mesh.distributed
fn = build_halo_pipeline(cfg, mesh, TileConfig(mesh_shape=grid,
                                               halo=case["halo"]),
                         lr_stitch=case["lr_stitch"], device="cpu")
res = fn(pair.left, pair.right)
np.savez(os.path.join(outdir, f"rank{rank}.npz"), disp=res.disp.numpy(),
         valid=res.valid.numpy())
torch.distributed.destroy_process_group()
print(f"rank {rank}: ok", flush=True)
