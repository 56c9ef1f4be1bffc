"""One rank of a distributed tile grid, for tests/test_torch_exact.py.

Each process joins a gloo process group at a localhost address on device
``cpu:<rank>``, exchanges ``chunks_of`` its tile through the grid's
all-to-all, once for each of ``DTYPES``, and writes what it received to
``<outdir>/a2a_rank<r>.pt``, then runs ``build_exact_pipeline`` (without
and with the disparity-plane cost) on the CPU and writes the replicated
frames it received to ``<outdir>/exact<0|1>_rank<r>.npz``. Imports no
jax.

Usage: python torch_exact_worker.py <rank> <nprocs> <port> <outdir> <case>
where <case> is a JSON object: cfg (StereoConfig fields), shape, grid
(ty, tx), seed.
"""

import json
import os
import sys

import torch


#: The dtypes of the worker's all-to-alls, one exchange each.
DTYPES = (torch.int16, torch.bool, torch.float32)


def chunk_shape(k: int, i: int, j: int):
    """The shape of the chunk tile i sends tile j in exchange k: uneven
    volumes and maps, empty for some pairs."""
    shape = (i + 1, j + 2, 3) if k == 0 else (2 * j + 1, i + 3)
    return (0,) + shape[1:] if (i + j) % 4 == 3 else shape


def chunks_of(k: int, i: int, order):
    """Tile i's chunks of exchange k by destination: int16 volumes, bool
    masks or float32 maps."""
    out = {}
    for j, dst in enumerate(order):
        shape = chunk_shape(k, i, j)
        n = int(torch.tensor(shape).prod())
        vals = torch.arange(n).reshape(shape) * (i + 1) - 7 * j
        out[dst] = ((vals * 97).to(torch.int16), vals % 3 == 0,
                    vals.to(torch.float32) / 8)[k]
    return out


def main():
    rank, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    case = json.loads(sys.argv[5])
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

    import numpy as np

    from stereo_tpu_torch.config import StereoConfig
    from stereo_tpu_torch.data import make_pair
    from stereo_tpu_torch.parallel import (
        build_exact_pipeline,
        initialize_multihost,
        make_tile_mesh,
    )
    from stereo_tpu_torch.parallel.tiling import make_grid

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", nprocs, rank)  # gloo: no card
    mesh = make_tile_mesh([f"cpu:{r}" for r in range(nprocs)],
                          mesh_shape=tuple(case["grid"]))
    assert mesh.distributed
    grid = make_grid(mesh)
    (tile,) = grid.tiles
    i = grid.order.index(tile)
    got = [grid.all_to_all(
        {tile: chunks_of(k, i, grid.order)},
        lambda a, b: chunk_shape(k, grid.order.index(a),
                                 grid.order.index(b)))[tile]
        for k in range(len(DTYPES))]
    torch.save(got, os.path.join(outdir, f"a2a_rank{rank}.pt"))

    pair = make_pair(tuple(case["shape"]), max_disp=9, kind="shapes",
                     seed=case["seed"])
    cfg = StereoConfig(**case["cfg"])
    for dplane in (False, True):
        res = build_exact_pipeline(cfg, mesh, dplane_cost=dplane,
                                   device="cpu")(pair.left, pair.right)
        np.savez(os.path.join(outdir, f"exact{int(dplane)}_rank{rank}.npz"),
                 disp=res.disp.numpy(), valid=res.valid.numpy())
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
