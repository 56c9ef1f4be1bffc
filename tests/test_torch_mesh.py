"""The port's tile mesh and multi-process bring-up against
``stereo_tpu.parallel.mesh`` on the CPU: the same grid shapes and the same
refusals for the same device counts (the reference's fake CPU devices, the
port's repeated CPU device)."""

import jax
import numpy as np
import pytest
import torch

from stereo_tpu.parallel import make_tile_mesh as j_mesh
from stereo_tpu_torch.config import StereoConfig
from stereo_tpu_torch.data import make_pair
from stereo_tpu_torch.parallel import (
    TileMesh,
    build_exact_pipeline,
    build_halo_pipeline,
    initialize_multihost,
    make_tile_mesh,
)
from stereo_tpu_torch.pipeline import compute_disparity

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "n, mesh_shape, batch",
    [(8, None, 1), (8, (2, 4), 1), (8, None, 2), (6, None, 1), (4, (1, 4), 1),
     (1, None, 1), (7, None, 1), (8, (2, 2), 2)],
)
def test_mesh_shape_matches_reference(n, mesh_shape, batch):
    """The default grid is the most-square factoring, favouring row
    tiles; a given shape is taken as it is."""
    got = make_tile_mesh(["cpu"] * n, mesh_shape, batch)
    want = j_mesh(jax.devices()[:n], mesh_shape, batch)
    assert got.shape == dict(want.shape)
    assert len(got.devices) == n and not got.distributed
    assert got.device(batch - 1, got.ty - 1, got.tx - 1) == torch.device("cpu")


@pytest.mark.parametrize(
    "n, mesh_shape, batch, match",
    [(8, None, 3, "not divisible by batch"), (8, (3, 2), 1, "!= 8 devices"),
     (6, (2, 2), 2, "!= 6 devices")],
)
def test_mesh_errors_match_reference(n, mesh_shape, batch, match):
    with pytest.raises(ValueError, match=match):
        make_tile_mesh(["cpu"] * n, mesh_shape, batch)
    with pytest.raises(ValueError, match=match):
        j_mesh(jax.devices()[:n], mesh_shape, batch)


def test_default_devices_without_a_process_group(monkeypatch):
    """Without ``devices`` the mesh takes every CUDA card; without a card
    it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        mesh = make_tile_mesh()
        assert len(mesh.devices) == torch.cuda.device_count()
        assert not mesh.distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_tile_mesh()


def test_initialize_multihost_single_process_is_a_noop():
    initialize_multihost(num_processes=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(num_processes=2)


def test_distributed_grid_needs_a_process_group():
    """A mesh that asks for one rank per tile never drops to the local
    grid: without a process group the pipeline raises."""
    mesh = TileMesh(1, 1, 2, (torch.device("cpu"),) * 2, distributed=True)
    img = np.zeros((16, 64), dtype=np.uint8)
    fn = build_halo_pipeline(StereoConfig(num_disparities=16), mesh,
                             device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        fn(img, img)


def test_exact_pipeline_is_not_ported():
    """A 1x1 grid reshards nothing: the exact mode is ``compute_disparity``
    on the whole frame."""
    cfg = StereoConfig(num_disparities=16)
    pair = make_pair((24, 64), max_disp=10, kind="shapes", seed=5)
    got = build_exact_pipeline(cfg, make_tile_mesh(["cpu"], (1, 1)),
                               device="cpu")(pair.left, pair.right)
    want = compute_disparity(torch.from_numpy(pair.left),
                             torch.from_numpy(pair.right), cfg)
    assert torch.equal(got.disp, want.disp)
    assert torch.equal(got.valid, want.valid)
