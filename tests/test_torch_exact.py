"""The port's exact reshard mode, its ``constrain`` hooks and the dryrun
twin against the reference on the CPU.

The same numpy inputs go through ``stereo_tpu`` (its ``build_exact_pipeline``
over the conftest's 8 fake CPU devices, and its golden ``compute_disparity``
on the whole frame) and ``stereo_tpu_torch`` (its exact program on a local
grid of CPU tiles, the wrappers running their plain twins). Every
comparison is exact (``assert_array_equal``, tolerance 0): the exact mode
moves data between tiles and never changes a value. The gloo tests run the
same program as one ``torch.distributed`` process per tile
(``tests/torch_exact_worker.py``), which must give the local grid's bits.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.data import make_pair
from stereo_tpu.ops.sgm import _shear as j_shear
from stereo_tpu.ops.sgm import _unshear as j_unshear
from stereo_tpu.ops.sgm import sgm_aggregate as j_sgm
from stereo_tpu.parallel import build_exact_pipeline as j_exact
from stereo_tpu.parallel import make_tile_mesh as j_mesh
from stereo_tpu.pipeline.pipeline import compute_disparity as j_compute
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.dryrun import dryrun_multichip
from stereo_tpu_torch.ops.cuda import sgm_paths
from stereo_tpu_torch.ops.sgm import (
    PATH_STEPS,
    _shear,
    _unshear,
    path_cost,
    shear_valid,
    shear_window,
    unshear_rows,
)
from stereo_tpu_torch.ops.sgm import sgm_aggregate as t_sgm
from stereo_tpu_torch.parallel import build_exact_pipeline as t_exact
from stereo_tpu_torch.parallel import make_tile_mesh as t_mesh
from stereo_tpu_torch.parallel.exact import band_bounds
from stereo_tpu_torch.parallel.tiling import LocalGrid
from stereo_tpu_torch.pipeline import compute_disparity as t_compute
from stereo_tpu_torch import pipeline as tpipe
from stereo_tpu_torch.pipeline import use_kernels

torch.set_num_threads(1)

#: The reference's five exact-mode tests
#: (tests/distributed/test_parallel.py:33, 43, 179, 210, 224): pair
#: (shape, max_disp, kind, seed), config, dplane_cost.
REFERENCE_CASES = {
    "8path_subpixel": ((64, 96), 10, "shapes", 0,
                       dict(num_disparities=16, num_paths=8, subpixel=True),
                       False),
    "4path_no_subpixel": ((48, 64), 8, "slant", 1,
                          dict(num_disparities=8, num_paths=4,
                               subpixel=False, median_filter=False), False),
    "adaptive_p2": ((48, 64), 8, "shapes", 6,
                    dict(num_disparities=16, num_paths=8, adaptive_p2=True,
                         p2_min=20, subpixel=True), False),
    "dplane": ((48, 64), 10, "shapes", 11,
               dict(num_disparities=16, num_paths=8, subpixel=True), True),
    "dplane_wta_only": ((48, 64), 10, "slant", 12,
                        dict(num_disparities=16, num_paths=0, subpixel=True,
                             median_filter=False), True),
}

#: Beyond the reference's: the exact LR check, SAD without paths on
#: disparity planes, and a frame whose H (37), W (61), W + H - 1 (97) and D
#: (13) divide by none of the grid's 8 tiles, with adaptive P2 and its
#: noise floor (a wrong image slice at a band's edge shows there).
MORE_CASES = {
    "lr_exact": ((48, 64), 10, "shapes", 13,
                 dict(num_disparities=16, num_paths=8, lr_exact=True),
                 False),
    "sad_wta_dplane": ((48, 64), 10, "shapes", 14,
                       dict(cost_fn="sad", num_disparities=16, num_paths=0,
                            sad_window=(9, 9)), True),
    "uneven": ((37, 61), 9, "shapes", 15,
               dict(num_disparities=13, num_paths=8, adaptive_p2=True,
                    p2_min=20, adaptive_grad_floor=6), False),
    "uneven_dplane": ((37, 61), 9, "shapes", 15,
                      dict(num_disparities=13, num_paths=8), True),
}


@pytest.fixture(scope="module")
def mesh42():
    assert jax.device_count() >= 8, "tests need 8 fake CPU devices"
    return j_mesh(jax.devices()[:8], mesh_shape=(4, 2))


def _port_exact(pair, kw, dplane, grid=(4, 2)):
    mesh = t_mesh(["cpu"] * (grid[0] * grid[1]), grid)
    return t_exact(TCfg(**kw), mesh, dplane_cost=dplane, device="cpu")(
        pair.left, pair.right)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_exact_matches_reference(mesh42, case):
    """The reference's five exact configurations on the port's 4x2 local
    grid: equal to the reference's exact mode on its 8 fake devices and to
    its golden whole frame."""
    shape, md, kind, seed, kw, dplane = REFERENCE_CASES[case]
    pair = make_pair(shape, max_disp=md, kind=kind, seed=seed)
    got = _port_exact(pair, kw, dplane)
    _assert_same(got, j_exact(JCfg(**kw), mesh42, dplane_cost=dplane)(
        pair.left, pair.right))
    _assert_same(got, j_compute(pair.left, pair.right, JCfg(**kw)))


@pytest.mark.parametrize("case", sorted(MORE_CASES))
def test_exact_more_configs_match_reference(mesh42, case):
    shape, md, kind, seed, kw, dplane = MORE_CASES[case]
    pair = make_pair(shape, max_disp=md, kind=kind, seed=seed)
    got = _port_exact(pair, kw, dplane)
    _assert_same(got, j_compute(pair.left, pair.right,
                                JCfg(backend="jnp", **kw)))
    if case == "lr_exact":
        _assert_same(got, j_exact(JCfg(**kw), mesh42)(pair.left, pair.right))


@pytest.mark.parametrize("grid", [(1, 2), (3, 1), (2, 3)])
def test_exact_grids_equal_whole_frame(grid):
    """Other grids, the uneven frame: the port's exact mode is the port's
    whole frame."""
    shape, md, kind, seed, kw, _ = MORE_CASES["uneven"]
    pair = make_pair(shape, max_disp=md, kind=kind, seed=seed)
    want = t_compute(torch.from_numpy(pair.left),
                     torch.from_numpy(pair.right), TCfg(**kw))
    for dplane in (False, True):
        got = _port_exact(pair, kw, dplane, grid)
        assert torch.equal(got.disp, want.disp)
        assert torch.equal(got.valid, want.valid)


def test_band_bounds_partition():
    assert band_bounds(375, 4) == [(0, 94), (94, 188), (188, 282),
                                   (282, 375)]
    assert band_bounds(3, 5) == [(0, 1), (1, 2), (2, 3), (3, 3), (3, 3)]


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("trail", [(), (5,), (8,)])
def test_shear_and_unshear_match_reference(sign, trail):
    rng = np.random.default_rng(3 + sign)
    x = rng.integers(-50, 50, size=(7, 11, *trail)).astype(np.int32)
    got, got_valid = _shear(torch.from_numpy(x), sign)
    want, want_valid = j_shear(jnp.asarray(x), sign)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(
        _unshear(got, sign, 11).numpy(),
        np.asarray(j_unshear(want, sign, 11)))
    # A row band's window of a column band, and its unshear, are the whole
    # shear's.
    band = shear_window(torch.from_numpy(x[2:5]), 2, 7, sign, 4, 9)
    np.testing.assert_array_equal(band.numpy(), np.asarray(want)[2:5, 4:13])
    rows = unshear_rows(got[2:5].contiguous(), 2, 7, sign, 11)
    np.testing.assert_array_equal(rows.numpy(), x[2:5])
    np.testing.assert_array_equal(shear_valid(7, 11, sign, 4, 9, "cpu"),
                                  np.asarray(want_valid)[:, 4:13])


def _identity(tree):
    return tree


def _recorder(log, tag):
    def hook(tree):
        log.append((tag, tuple(None if x is None else tuple(x.shape)
                               for x in tree)))
        return tree
    return hook


_HOOK_CFGS = {"4": dict(num_paths=4),
              "8": dict(num_paths=8),
              "8_adaptive": dict(num_paths=8, adaptive_p2=True, p2_min=6,
                                 adaptive_grad_floor=4)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cfg", sorted(_HOOK_CFGS))
def test_constrain_hooks_match_reference(cfg, masked):
    """Identity hooks give the unconstrained sum and the reference's;
    recording hooks see the reference's trees in its order."""
    kw = dict(num_disparities=6, p1=3, p2=20, **_HOOK_CFGS[cfg])
    rng = np.random.default_rng(len(cfg))
    h, w = 9, 13
    cost = rng.integers(0, 40, size=(h, w, 6)).astype(np.int32)
    image = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    valid = rng.random((h, w)) < 0.8 if masked else None
    tv = None if valid is None else torch.from_numpy(valid)
    args_t = (torch.from_numpy(cost), TCfg(**kw), torch.from_numpy(image), tv)
    args_j = (jnp.asarray(cost), JCfg(**kw), jnp.asarray(image),
              None if valid is None else jnp.asarray(valid))
    plain = t_sgm(*args_t)
    assert torch.equal(t_sgm(*args_t, constrain=(_identity, _identity)),
                       plain)
    log_t, log_j = [], []
    got = t_sgm(*args_t, constrain=(_recorder(log_t, "rows"),
                                    _recorder(log_t, "cols")))
    want = j_sgm(*args_j, constrain=(_recorder(log_j, "rows"),
                                     _recorder(log_j, "cols")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert log_t == log_j and len(log_t) == (4 if cfg != "4" else 2)


@pytest.mark.parametrize("lr_exact", [False, True])
def test_compute_disparity_dplanes_hook_matches_reference(lr_exact):
    """The disparity-plane hook takes the cost volume (of both views under
    lr_exact) before the other two hooks, as the reference's."""
    pair = make_pair((24, 48), max_disp=8, kind="shapes", seed=21)
    kw = dict(num_disparities=12, num_paths=8, lr_exact=lr_exact)
    log_t, log_j = [], []

    def hooks(log):
        return (_recorder(log, "rows"), _recorder(log, "cols"),
                lambda vol: _recorder(log, "planes")((vol,))[0])

    got = t_compute(torch.from_numpy(pair.left), torch.from_numpy(pair.right),
                    TCfg(**kw), constrain=hooks(log_t))
    want = j_compute(pair.left, pair.right, JCfg(backend="jnp", **kw),
                     constrain=hooks(log_j))
    _assert_same(got, want)
    assert log_t == log_j and log_t[0] == ("planes", ((24, 48, 12),))


def test_kernels_for_masked_and_constrained_calls(monkeypatch):
    """The backend rule of a call: the device and ``backend`` alone decide
    (``use_kernels``; the device is an object: no card), so a masked or
    constrained call that ``use_kernels`` sends to the kernels takes the
    kernel route with its mask and hooks under ``backend="auto"`` and
    ``"cuda"`` alike, raising nothing, and backend='torch' or CPU tensors
    take the plain path."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    auto, forced, plain = TCfg(), TCfg(backend="cuda"), TCfg(backend="torch")
    assert use_kernels(auto, cuda) and use_kernels(forced, cuda)
    assert not use_kernels(plain, cuda) and not use_kernels(auto, cpu)
    routed = []

    def kernel_path(left, right, cfg, x_offset, iw, ctx, box, valid,
                    constrain):
        routed.append((valid, constrain))
        return "kernels"

    monkeypatch.setattr(tpipe, "_kernel_path", kernel_path)
    monkeypatch.setattr(tpipe, "use_kernels", lambda cfg, device: True)
    img = torch.zeros(2, 8, dtype=torch.uint8)
    mask, hooks = torch.ones(2, 8, dtype=torch.bool), (_identity, _identity)
    for kw in (dict(valid=mask), dict(constrain=hooks),
               dict(valid=mask, constrain=hooks + (_identity,))):
        for cfg in (auto, forced):
            assert t_compute(img, img, cfg, **kw) == "kernels"
            assert routed.pop() == (kw.get("valid"), kw.get("constrain"))


def _paths_want(cost, cfg, steps, image=None, valid=None):
    return sum(path_cost(cost, cfg, st, image, valid) for st in steps)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("steps", [PATH_STEPS[:2], PATH_STEPS[2:4],
                                   (PATH_STEPS[5],), PATH_STEPS[4:]])
def test_sgm_paths_steps_on_cpu(steps, adaptive):
    """K2's plain version with a subset of the directions: the sum of their
    path costs, under the rectangle form's mask too."""
    cfg = TCfg(num_disparities=10, num_paths=8, adaptive_p2=adaptive,
               p2_min=8, adaptive_grad_floor=3)
    rng = np.random.default_rng(len(steps))
    cost = torch.from_numpy(rng.integers(0, 49, size=(11, 17, 10))).to(
        torch.int8)
    image = torch.from_numpy(rng.integers(0, 256, size=(11, 17)))
    img = image if adaptive else None
    got = sgm_paths(cost, cfg, image=img, steps=steps)
    assert got.dtype == torch.int16
    assert torch.equal(got.to(torch.int32), _paths_want(cost, cfg, steps, img))
    mask = torch.zeros((11, 17), dtype=torch.bool)
    mask[2:9, 3:15] = True
    got = sgm_paths(cost, cfg, image=img, steps=steps, rect=(2, 9, 3, 15))
    assert torch.equal(got.to(torch.int32),
                       _paths_want(cost, cfg, steps, img, mask))


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("x0, width", [(0, 9), (7, 13), (20, 8)])
def test_sgm_paths_sheared_form_on_cpu(sign, x0, width):
    """K2's sheared form, plain: the verticals of a band of the sheared
    volume under the sheared validity, over the whole band; the bands of a
    frame add up to the reference's diagonals."""
    h, w = 12, 17  # W + H - 1 = 28
    cfg = TCfg(num_disparities=8, num_paths=8, adaptive_p2=True, p2_min=8,
               adaptive_grad_floor=3)
    rng = np.random.default_rng(2 * x0 + (sign > 0))
    cost = torch.from_numpy(rng.integers(0, 49, size=(h, w, 8))).to(
        torch.int8)
    image = torch.from_numpy(rng.integers(0, 256, size=(h, w)))
    c_sh = shear_window(cost, 0, h, sign, x0, width)
    i_sh = shear_window(image, 0, h, sign, x0, width)
    got = sgm_paths(c_sh, cfg, image=i_sh, steps=PATH_STEPS[2:4],
                    shear=(sign, x0, w))
    valid = shear_valid(h, w, sign, x0, width, "cpu")
    assert torch.equal(got.to(torch.int32), _paths_want(
        c_sh, cfg, PATH_STEPS[2:4], i_sh, valid))
    whole = torch.cat([
        sgm_paths(shear_window(cost, 0, h, sign, a, b - a), cfg,
                  image=shear_window(image, 0, h, sign, a, b - a),
                  steps=PATH_STEPS[2:4], shear=(sign, a, w))
        for a, b in band_bounds(w + h - 1, 3)], dim=1)
    diag = PATH_STEPS[4:6] if sign > 0 else PATH_STEPS[6:8]
    assert torch.equal(_unshear(whole.contiguous(), sign, w).to(torch.int32),
                       _paths_want(cost, cfg, diag, image))
    with pytest.raises(ValueError, match="verticals"):
        sgm_paths(c_sh, cfg, image=i_sh, steps=PATH_STEPS[:2],
                  shear=(sign, x0, w))
    with pytest.raises(ValueError, match="sheared frame"):
        sgm_paths(c_sh, cfg, image=i_sh, steps=PATH_STEPS[2:4],
                  shear=(sign, w + h - width, w))


def test_local_grid_all_to_all():
    """Each tile gets what every tile addressed to it, sources in tile
    order, uneven and empty chunks too; a chunk of another shape than the
    receiver expects, or of another dtype, is refused; row bands gather in
    tile order."""
    grid = LocalGrid(t_mesh(["cpu"] * 6, (3, 2)))

    def shape(t, u):
        i, j = grid.order.index(t), grid.order.index(u)
        return (i + 1, j * ((i + j) % 3 > 0))

    chunks = {t: {u: torch.full(shape(t, u), i * 10 + j, dtype=torch.int16)
                  for j, u in enumerate(grid.order)}
              for i, t in enumerate(grid.order)}
    got = grid.all_to_all(chunks, shape)
    for u in grid.order:
        assert list(got[u]) == grid.order
        for t in grid.order:
            assert torch.equal(got[u][t], chunks[t][u])
    with pytest.raises(ValueError, match="expected"):
        grid.all_to_all(chunks, lambda t, u: shape(u, t))
    first = grid.order[0]
    chunks[first][first] = chunks[first][first].to(torch.int32)
    with pytest.raises(ValueError, match="one dtype"):
        grid.all_to_all(chunks, shape)
    bands = {t: torch.full((i % 3, 4), i) for i, t in enumerate(grid.order)}
    rows, lo = [], 0
    for t in grid.order:
        rows.append((lo, lo + bands[t].shape[0]))
        lo = rows[-1][1]
    assert torch.equal(grid.gather_rows(bands, rows),
                       torch.cat([bands[t] for t in grid.order]))
    with pytest.raises(ValueError, match="rows"):
        grid.gather_rows(bands, rows[::-1])


def test_dryrun_multichip_on_cpu():
    dryrun_multichip(8, device="cpu")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


#: The gloo case: the 8-path config, 2x2 ranks, a frame that no count
#: divides, exact and with the disparity-plane cost.
GLOO_CASE = dict(cfg=dict(num_disparities=13, num_paths=8, adaptive_p2=True,
                          p2_min=20, adaptive_grad_floor=6),
                 shape=[37, 61], grid=[2, 2], seed=15)


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Four gloo processes, one per tile of a 2x2 grid (devices
    ``cpu:<rank>``): each writes what it received from the grid's
    all-to-all and the exact mode's replicated frames."""
    out = tmp_path_factory.mktemp("exact_gloo")
    n = 4
    worker = os.path.join(os.path.dirname(__file__), "torch_exact_worker.py")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(n), str(port), str(out),
         json.dumps(GLOO_CASE)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("gloo worker timed out")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-3000:]}"
    return out, n


def test_gloo_all_to_all_matches_local_grid(gloo_ranks):
    """The distributed grid's all-to-all, uneven and empty int16, bool and
    float32 chunks (``torch_exact_worker.chunks_of``), against the local
    grid's."""
    out, n = gloo_ranks
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_exact_worker import DTYPES, chunk_shape, chunks_of

    grid = LocalGrid(t_mesh(["cpu"] * n, tuple(GLOO_CASE["grid"])))
    for r, t in enumerate(grid.order):
        got = torch.load(out / f"a2a_rank{r}.pt")
        assert len(got) == len(DTYPES)
        for k, dtype in enumerate(DTYPES):
            want = grid.all_to_all(
                {u: chunks_of(k, i, grid.order)
                 for i, u in enumerate(grid.order)},
                lambda a, b: chunk_shape(k, grid.order.index(a),
                                         grid.order.index(b)))[t]
            assert list(got[k]) == list(want) == grid.order
            for src, x in want.items():
                assert x.dtype == dtype
                assert got[k][src].dtype == dtype
                assert torch.equal(got[k][src], x)


@pytest.mark.parametrize("dplane", [False, True])
def test_gloo_exact_matches_local_grid(gloo_ranks, dplane):
    """One gloo process per tile: every rank receives the replicated
    frame, equal bit for bit to the local grid's and the whole frame's."""
    out, n = gloo_ranks
    pair = make_pair(tuple(GLOO_CASE["shape"]), max_disp=9, kind="shapes",
                     seed=GLOO_CASE["seed"])
    local = _port_exact(pair, GLOO_CASE["cfg"], dplane,
                        tuple(GLOO_CASE["grid"]))
    whole = t_compute(torch.from_numpy(pair.left),
                      torch.from_numpy(pair.right), TCfg(**GLOO_CASE["cfg"]))
    assert torch.equal(local.disp, whole.disp)
    for r in range(n):
        got = np.load(out / f"exact{int(dplane)}_rank{r}.npz")
        np.testing.assert_array_equal(got["disp"], local.disp.numpy())
        np.testing.assert_array_equal(got["valid"], local.valid.numpy())
