"""One step of every multi-tile mode at a tiny size.

Twin of the reference's ``dryrun_multichip`` (``__graft_entry__.py:25-123``):
the same mesh rule, configuration, frames and steps, on a local grid of
``n_devices`` tiles on one device (``["cuda"] * n`` on the card, the CPU
when asked):

  * the batched stream over 'batch' and the tile grid (stitched where
    tx > 1, by explicit request: ``lr_stitch=True`` raises where the
    stitched regime does not apply);
  * the halo-tiled pipeline on a tile-only mesh, stitched where tx > 1,
    and its legacy regime;
  * the exact reshard mode and its disparity-plane cost, which must agree.

    python -m stereo_tpu_torch.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import StereoConfig
from .parallel import (
    build_exact_pipeline,
    build_halo_pipeline,
    build_stream_pipeline,
    make_tile_mesh,
)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run one step of each mode on a local grid of ``n_devices`` tiles on
    ``device``; raises AssertionError where a mode gives the wrong shape or
    the disparity-plane cost differs from the exact mode."""
    device = torch.device(device)
    batch = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    tiles = n_devices // batch
    # The tile grid factored tx-major: the stitched LR regime rides 'tx'.
    tx = 1
    for cand in range(int(tiles ** 0.5), 0, -1):
        if tiles % cand == 0:
            tx = tiles // cand
            break
    ty = tiles // tx
    mesh = make_tile_mesh([device] * n_devices, mesh_shape=(ty, tx),
                          batch=batch)

    cfg = StereoConfig(
        cost_fn="census", num_disparities=8, num_paths=8, subpixel=True,
        lr_check=True, median_filter=True,
    )
    rng = np.random.default_rng(0)
    h, w = 32, 48 * tx  # tiles stay >= D + md wide for the stitch gate

    frames_l = rng.integers(0, 256, size=(batch, h, w)).astype(np.uint8)
    frames_r = rng.integers(0, 256, size=(batch, h, w)).astype(np.uint8)
    stream_fn = build_stream_pipeline(cfg, mesh, (h, w),
                                      lr_stitch=tx > 1 or None, device=device)
    res = stream_fn(frames_l, frames_r)
    assert res.disp.shape == (batch, h, w)

    tile_mesh = make_tile_mesh([device] * (ty * tx), mesh_shape=(ty, tx))
    res_h = build_halo_pipeline(cfg, tile_mesh, lr_stitch=tx > 1 or None,
                                device=device)(frames_l[0], frames_r[0])
    assert res_h.disp.shape == (h, w)

    res_hl = build_halo_pipeline(cfg, tile_mesh, lr_stitch=False,
                                 device=device)(frames_l[0], frames_r[0])
    assert res_hl.disp.shape == (h, w)

    # The reference's "Pallas kernels inside shard_map tiles" step is the
    # halo steps above: on the card their tiles run the kernels.

    res2 = build_exact_pipeline(cfg, mesh, device=device)(frames_l[0],
                                                          frames_r[0])
    assert res2.disp.shape == (h, w)

    res3 = build_exact_pipeline(cfg, mesh, dplane_cost=True, device=device)(
        frames_l[0], frames_r[0])
    assert res3.disp.shape == (h, w)
    assert torch.equal(res3.disp, res2.disp)
    assert torch.equal(res3.valid, res2.valid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m stereo_tpu_torch.dryrun")
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
