"""The port's masked SGM, rectangular-tile mode and halo-tiled pipeline
against the reference on the CPU.

The same numpy inputs (``make_pair`` and integers from a seed) go through
``stereo_tpu`` (its golden ``jnp`` path, one case through
``pallas_interpret``) and ``stereo_tpu_torch``; every comparison is exact
(``assert_array_equal``, tolerance 0): the tile bodies are the same integer
pipeline and the stitch is elementwise min, unpack and compare on values
below 2^24. The reference's tile grid runs under ``shard_map`` over the
conftest's fake CPU devices; the port's on its local grid (one process)
and, in the gloo test, one ``torch.distributed`` process per tile, which
must give the local grid's bits.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.config import TileConfig as JTile
from stereo_tpu.data import make_pair
from stereo_tpu.ops.sgm import sgm_aggregate as j_sgm
from stereo_tpu.parallel import build_halo_pipeline as j_halo
from stereo_tpu.parallel import make_tile_mesh as j_mesh
from stereo_tpu.pipeline.pipeline import compute_disparity as j_compute
from stereo_tpu.pipeline.pipeline import compute_patch_parts as j_parts
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.config import TileConfig as TTile
from stereo_tpu_torch.ops.sgm import sgm_aggregate as t_sgm
from stereo_tpu_torch.parallel import build_halo_pipeline as t_halo
from stereo_tpu_torch.parallel import make_tile_mesh as t_mesh
from stereo_tpu_torch.pipeline import compute_disparity as t_compute
from stereo_tpu_torch.pipeline import compute_patch_parts as t_parts

torch.set_num_threads(1)

ADAPTIVE = dict(adaptive_p2=True, p2_min=6, adaptive_grad_floor=4)


def _mask(kind, h, w, rng):
    if kind == "random":
        return rng.random((h, w)) < 0.7
    m = np.zeros((h, w), dtype=bool)
    m[3:h - 2, 5:w - 4] = True
    return m


@pytest.mark.parametrize("mask", ["random", "rect"])
@pytest.mark.parametrize("p2", ["fixed", "adaptive"])
@pytest.mark.parametrize("paths", [4, 8])
def test_masked_sgm_matches_reference(paths, p2, mask):
    """Where a pixel's predecessor is invalid its path starts fresh,
    whatever the pixel's own validity; the diagonals take the diagonal
    predecessor, as the reference's sheared mask does."""
    rng = np.random.default_rng(paths * 10 + len(p2 + mask))
    h, w, d = 13, 21, 8
    cost = rng.integers(0, 40, size=(h, w, d), dtype=np.int32)
    image = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    valid = _mask(mask, h, w, rng)
    kw = dict(num_disparities=d, num_paths=paths, p1=3, p2=20,
              **(ADAPTIVE if p2 == "adaptive" else {}))
    got = t_sgm(torch.from_numpy(cost), TCfg(**kw),
                image=torch.from_numpy(image), valid=torch.from_numpy(valid))
    want = jax.jit(functools.partial(j_sgm, cfg=JCfg(**kw)))(
        cost, image=image, valid=valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jit(fn, cfg, **static):
    """The reference's ``fn(left, right, cfg, **static)`` compiled whole
    (its op-by-op dispatch is several times slower on the CPU)."""
    return jax.jit(functools.partial(fn, cfg=cfg, **static))


def _tile_inputs(seed, h, w, ctx=0):
    pair = make_pair((h, w + ctx), max_disp=10, kind="shapes", seed=seed)
    left = np.ascontiguousarray(pair.left[:, ctx:])
    return left, pair.right


@pytest.mark.parametrize(
    "kw, frame",
    [(dict(), dict(x_offset=-40, y_offset=-6, image_width=70,
                   image_height=20)),
     (dict(**ADAPTIVE), dict(x_offset=-1, y_offset=3, image_width=60,
                             image_height=24)),
     (dict(lr_exact=True), dict(x_offset=-20, y_offset=-2, image_width=50,
                                image_height=30)),
     (dict(cost_fn="sad", sad_window=(5, 5), num_paths=0),
      dict(x_offset=-36, y_offset=0, image_width=80, image_height=40))],
    ids=["census", "adaptive", "lr_exact", "sad"],
)
def test_rect_tile_matches_reference(kw, frame):
    """``compute_disparity`` on a tile at a negative origin whose block
    reaches past the frame on three sides: every output over the whole
    tile, out-of-frame pixels included, equals the reference's golden
    rectangular-tile path."""
    left, right = _tile_inputs(3, 24, 72)
    cfg = dict(num_disparities=16, **kw)
    got = t_compute(torch.from_numpy(left), torch.from_numpy(right),
                    TCfg(**cfg), **frame)
    want = _jit(j_compute, JCfg(backend="jnp", **cfg), **frame)(left, right)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want.disp))


@pytest.mark.parametrize("x_offset, y_offset", [(-24, -4), (30, 2)])
def test_rect_patch_parts_match_reference(x_offset, y_offset):
    """``compute_patch_parts`` as a stitched tile: right context, an own
    range and a rectangle, at a negative and a positive origin."""
    ctx = 15
    left, right = _tile_inputs(5, 20, 64, ctx)
    cfg = dict(num_disparities=16)
    call = dict(x_offset=x_offset, image_width=80, right_context=ctx,
                own=(8, 56), y_offset=y_offset, image_height=18)
    got = t_parts(torch.from_numpy(left), torch.from_numpy(right),
                  TCfg(**cfg), **call)
    want = _jit(j_parts, JCfg(backend="jnp", **cfg), **call)(left, right)
    for name in ("disp", "d0", "qr", "spill"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    for name in ("ok_nolr", "lr_bit"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name)).astype(bool), err_msg=name)


def _halo_pair(shape, seed):
    return make_pair(shape, max_disp=12, kind="shapes", seed=seed)


def _run_both(kw, shape, grid, lr_stitch=None, halo=None, seed=7,
              backend="jnp"):
    """(port, reference) results of ``build_halo_pipeline`` on one grid,
    as numpy (disp, valid)."""
    pair = _halo_pair(shape, seed)
    n = grid[0] * grid[1]
    got = t_halo(TCfg(**kw), t_mesh(["cpu"] * n, grid),
                 TTile(mesh_shape=grid, halo=halo), lr_stitch=lr_stitch,
                 device="cpu")(pair.left, pair.right)
    want = j_halo(JCfg(backend=backend, **kw), j_mesh(jax.devices()[:n], grid),
                  JTile(mesh_shape=grid, halo=halo),
                  lr_stitch=lr_stitch)(pair.left, pair.right)
    return ((got.disp.numpy(), got.valid.numpy()),
            (np.asarray(want.disp), np.asarray(want.valid)))


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


D16 = dict(num_disparities=16)


@pytest.mark.parametrize(
    "kw, shape, grid, lr_stitch, halo",
    [(dict(num_paths=8, **D16), (48, 200), (2, 2), None, None),
     (dict(num_paths=8, **D16), (48, 200), (2, 2), False, None),
     (dict(num_paths=4, **ADAPTIVE, **D16), (45, 190), (4, 2), None, None),
     (dict(num_paths=8, **D16), (37, 150), (4, 2), False, 6),
     (dict(cost_fn="rank", census_window=(5, 5), **D16), (40, 200), (2, 2),
      None, None),
     (dict(cost_fn="sad", sad_window=(5, 5), num_paths=0, **D16), (40, 130),
      (1, 2), None, None),
     (dict(lr_exact=True, **D16), (40, 130), (1, 2), None, None),
     (dict(num_paths=8, min_disparity=120, p1=0, p2=0, **D16), (32, 384),
      (4, 2), True, 4)],
    ids=["stitched_2x2", "legacy_2x2", "adaptive_4x2_ragged",
         "legacy_4x2_ragged_halo6", "rank_2x2", "sad_1x2", "lr_exact_1x2",
         "large_min_disparity_4x2"],
)
def test_halo_pipeline_matches_reference(kw, shape, grid, lr_stitch, halo):
    """The local grid against the reference's tile grid, bit for bit:
    both regimes, census, rank and SAD costs, the exact LR check, frames
    that do not divide the grid (the padding is cropped), a narrow halo,
    and a min_disparity so large against the halo that the stitched map's
    leading columns come from the previous tile only."""
    _assert_equal(*_run_both(kw, shape, grid, lr_stitch, halo))


def test_halo_pipeline_matches_pallas_reference():
    """One case against the reference's Pallas kernels (interpret mode),
    which frame the tile by its bounds instead of a mask: the cropped
    frames agree."""
    _assert_equal(*_run_both(dict(num_paths=8, **D16), (32, 160), (1, 2),
                             backend="pallas_interpret"))


@pytest.mark.parametrize(
    "kw",
    [dict(cost_fn="sad", **D16), dict(lr_exact=True, **D16),
     dict(num_paths=0, **D16), dict(num_disparities=128)],
    ids=["sad", "lr_exact", "no_paths", "tiles_narrower_than_D"],
)
def test_explicit_lr_stitch_refusals(kw):
    """lr_stitch=True where the stitched regime does not apply raises in
    both packages with the same message; so does a trivial grid."""
    pair = _halo_pair((32, 192), 1)
    for cfg_kw, grid in ((kw, (2, 2)), (D16, (1, 1))):
        n = grid[0] * grid[1]
        with pytest.raises(ValueError, match="lr_stitch needs"):
            t_halo(TCfg(**cfg_kw), t_mesh(["cpu"] * n, grid), lr_stitch=True,
                   device="cpu")(pair.left, pair.right)
        with pytest.raises(ValueError, match="lr_stitch needs"):
            j_halo(JCfg(backend="jnp", **cfg_kw),
                   j_mesh(jax.devices()[:n], grid),
                   lr_stitch=True)(pair.left, pair.right)


def test_trivial_grid_is_the_whole_frame():
    """A 1x1 grid without padding runs the whole-frame pipeline."""
    pair = _halo_pair((24, 96), 2)
    got = t_halo(TCfg(**D16), t_mesh(["cpu"], (1, 1)), device="cpu")(
        pair.left, pair.right)
    whole = t_compute(torch.from_numpy(pair.left),
                      torch.from_numpy(pair.right), TCfg(**D16))
    assert torch.equal(got.disp, whole.disp)
    assert torch.equal(got.valid, whole.valid)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize(
    "case",
    [dict(cfg=dict(num_paths=8, **D16), shape=[20, 40], grid=[1, 2],
          halo=None, lr_stitch=False, seed=4),
     dict(cfg=dict(num_paths=8, **D16), shape=[37, 170], grid=[2, 2],
          halo=None, lr_stitch=None, seed=6)],
    ids=["2proc_legacy_two_hops", "4proc_stitched_ragged"],
)
def test_gloo_grid_matches_local_grid(tmp_path, case):
    """One gloo process per tile: every rank receives the replicated
    frame, equal bit for bit to the local grid's."""
    n = case["grid"][0] * case["grid"][1]
    worker = os.path.join(os.path.dirname(__file__), "torch_tile_worker.py")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(n), str(port), str(tmp_path),
         json.dumps(case)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("gloo worker timed out")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    grid = tuple(case["grid"])
    pair = _halo_pair(tuple(case["shape"]), case["seed"])
    local = t_halo(TCfg(**case["cfg"]), t_mesh(["cpu"] * n, grid),
                   TTile(mesh_shape=grid, halo=case["halo"]),
                   lr_stitch=case["lr_stitch"], device="cpu")(
        pair.left, pair.right)
    for r in range(n):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["disp"], local.disp.numpy())
        np.testing.assert_array_equal(got["valid"], local.valid.numpy())
