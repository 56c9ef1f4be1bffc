"""The port's pipeline (CPU, plain ops) against the reference pipeline.

Exact equality of disp and valid against both reference backends: the
golden jnp composition and the Pallas kernels in interpret mode.
"""

import json

import numpy as np
import pytest
import torch

from stereo_tpu import config as jconfig
from stereo_tpu.data import make_pair
from stereo_tpu.pipeline import pipeline as jpipe
from stereo_tpu_torch import cli, config as tconfig, pipeline as tpipe

torch.set_num_threads(1)

_KITTI32 = dict(num_disparities=32)


def _port(left, right, kw, preset="kitti_sgm8_128"):
    cfg = tconfig.PRESETS[preset].replace(**kw)
    return tpipe.build_pipeline(cfg, device="cpu")(left, right)


def _ref(left, right, kw, backend, preset="kitti_sgm8_128"):
    cfg = jconfig.PRESETS[preset].replace(backend=backend, **kw)
    return jpipe.build_pipeline(cfg)(left, right)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want.disp))


@pytest.mark.parametrize(
    "preset, kw",
    [
        ("kitti_sgm8_128", _KITTI32),
        ("kitti_sgm8_128", dict(_KITTI32, min_disparity=3)),
        ("kitti_sgm8_128", dict(_KITTI32, subpixel=False, lr_check=False,
                                uniqueness_ratio=0.0, median_filter=False)),
        ("middlebury_census_sgm4_64", _KITTI32),
        ("kitti_sgm8_128", dict(_KITTI32, num_paths=0)),
    ],
)
def test_compute_disparity_matches_jnp(preset, kw):
    pair = make_pair((48, 160), max_disp=20, texture="cloud", seed=1)
    _assert_same(_port(pair.left, pair.right, kw, preset),
                 _ref(pair.left, pair.right, kw, "jnp", preset))


@pytest.mark.parametrize(
    "shape, d", [((48, 160), 32), ((32, 160), 128)]
)
def test_compute_disparity_matches_pallas_interpret(shape, d):
    pair = make_pair(shape, max_disp=20)
    kw = dict(num_disparities=d)
    _assert_same(_port(pair.left, pair.right, kw),
                 _ref(pair.left, pair.right, kw, "pallas_interpret"))


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize(
    "kw",
    [
        _KITTI32,
        dict(_KITTI32, adaptive_grad_floor=0),
        dict(_KITTI32, num_paths=4, min_disparity=2, p2_min=150),  # > p2
    ],
    ids=["preset", "floor0", "paths4_p2min"],
)
def test_quality_preset_matches_reference(kw, backend):
    pair = make_pair((40, 128), max_disp=20, texture="cloud", seed=3)
    preset = "kitti_sgm8_128_quality"
    _assert_same(_port(pair.left, pair.right, kw, preset),
                 _ref(pair.left, pair.right, kw, backend, preset))


#: The reference's own exact-LR cases (tests/ops/test_pallas_fused.py).
_LR_EXACT = dict(
    cost_fn="census", census_window=(5, 5), num_disparities=16, num_paths=8,
    p1=10, p2=120, subpixel=True, lr_check=True, lr_exact=True,
    median_filter=True,
)


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(subpixel=False),
        dict(uniqueness_ratio=0.05),
        dict(adaptive_p2=True, p2_min=25),
        dict(median_filter=False),
    ],
    ids=["base", "nosubpix", "uniq", "adaptive", "nomedian"],
)
def test_lr_exact_matches_reference(kw, backend):
    rng = np.random.default_rng(17)
    left = rng.integers(0, 256, size=(48, 144)).astype(np.uint8)
    right = np.roll(left, 5, axis=1)
    kw = dict(_LR_EXACT, **kw)
    got = _port(left, right, kw)
    _assert_same(got, _ref(left, right, kw, backend))
    # The exact check differs from the cheap one somewhere on this pair.
    cheap = _port(left, right, dict(kw, lr_exact=False))
    assert not torch.equal(got.valid, cheap.valid)


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize(
    "kw", [{}, dict(min_disparity=3, sad_window=(5, 7), subpixel=True)],
    ids=["preset", "md3_5x7"],
)
def test_tsukuba_sad16_matches_reference(kw, backend):
    pair = make_pair((48, 96), max_disp=14, kind="shapes", texture="cloud",
                     seed=4)
    _assert_same(_port(pair.left, pair.right, kw, "tsukuba_sad16"),
                 _ref(pair.left, pair.right, kw, backend, "tsukuba_sad16"))


@pytest.mark.parametrize("speckle_max_size", [0, 60])
def test_host_postprocess_matches_reference(speckle_max_size):
    pair = make_pair((48, 160), max_disp=20, noise_std=12.0, seed=2)
    kw = dict(_KITTI32, speckle_max_size=speckle_max_size)
    got = _port(pair.left, pair.right, kw)
    want = _ref(pair.left, pair.right, kw, "jnp")
    cfg_t = tconfig.KITTI_SGM8_128.replace(**kw)
    cfg_j = jconfig.KITTI_SGM8_128.replace(**kw)
    gd, gv = tpipe.host_postprocess(got.disp, got.valid, cfg_t)
    wd, wv = jpipe.host_postprocess(want.disp, want.valid, cfg_j)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() < np.asarray(want.valid).sum()  # speckles were removed


def test_host_postprocess_fills_occlusions():
    pair = make_pair((48, 160), max_disp=20, kind="layers", noise_std=6.0,
                     seed=2)
    kw = dict(_KITTI32, fill_occlusions=True)
    got = _port(pair.left, pair.right, kw)
    want = _ref(pair.left, pair.right, kw, "jnp")
    gd, gv = tpipe.host_postprocess(got.disp, got.valid,
                                    tconfig.KITTI_SGM8_128.replace(**kw))
    wd, wv = jpipe.host_postprocess(want.disp, want.valid,
                                    jconfig.KITTI_SGM8_128.replace(**kw))
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > got.valid.sum().item()  # rejected pixels were filled
    assert not np.array_equal(gd, got.disp.numpy())


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
def test_middlebury_preset_matches_reference(backend):
    # D=64, 4 paths: the TPU's d-major cost kernel and 4-path SGM.
    pair = make_pair((37, 100), max_disp=48, kind="shapes", texture="cloud",
                     seed=6)
    preset = "middlebury_census_sgm4_64"
    _assert_same(_port(pair.left, pair.right, {}, preset),
                 _ref(pair.left, pair.right, {}, backend, preset))


@pytest.mark.parametrize(
    "kw", [_KITTI32, dict(num_disparities=16, census_window=(5, 5),
                          min_disparity=2, num_paths=4)],
    ids=["kitti32", "d16_5x5_md2_paths4"],
)
def test_rank_config_matches_reference(kw):
    pair = make_pair((40, 128), max_disp=20, texture="cloud", seed=7)
    kw = dict(kw, cost_fn="rank")
    _assert_same(_port(pair.left, pair.right, kw),
                 _ref(pair.left, pair.right, kw, "jnp"))


@pytest.mark.parametrize("paths", [4, 8])
def test_sad_through_sgm_matches_reference(paths):
    pair = make_pair((40, 128), max_disp=20, texture="cloud", seed=8)
    kw = dict(_KITTI32, cost_fn="sad", num_paths=paths)
    _assert_same(_port(pair.left, pair.right, kw),
                 _ref(pair.left, pair.right, kw, "jnp"))


def _identity(tree):
    return tree


@pytest.mark.parametrize(
    "kw, call_kw",
    [
        ({}, dict(y_offset=2)),
        ({}, dict(valid=torch.ones((8, 40), dtype=torch.bool))),
        ({}, dict(constrain=(_identity, _identity))),
        ({}, dict(image_height=64)),
    ],
)
def test_unported_modes_raise(kw, call_kw):
    """The reference's masking, rectangular-tile and exact-mode arguments
    all run now (tests/test_torch_tiling.py and tests/test_torch_exact.py
    hold them against the reference); here an all-valid mask, identity
    ``constrain`` hooks, an offset without a frame height and a tile that
    lies inside its frame each give the whole frame's result."""
    cfg = tconfig.KITTI_SGM8_128.replace(num_disparities=32, **kw)
    pair = make_pair((8, 40), max_disp=6, seed=3)
    left, right = torch.from_numpy(pair.left), torch.from_numpy(pair.right)
    got = tpipe.compute_disparity(left, right, cfg, **call_kw)
    want = tpipe.compute_disparity(left, right, cfg)
    assert torch.equal(got.disp, want.disp)
    assert torch.equal(got.valid, want.valid)
    if "valid" not in call_kw and "constrain" not in call_kw:
        got = tpipe.compute_patch_parts(left, right, cfg, **call_kw)
        want = tpipe.compute_patch_parts(left, right, cfg)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_cuda_backend_rejects_cpu_tensors():
    cfg = tconfig.KITTI_SGM8_128.replace(num_disparities=32, backend="cuda")
    img = torch.zeros((8, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tpipe.compute_disparity(img, img, cfg)


def test_cli_run_demo(capsys):
    rc = cli.main([
        "run", "--demo", "--demo-shape", "48", "160", "--demo-max-disp",
        "20", "--set", "num_disparities=32", "--device", "cpu",
    ])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["pair"].startswith("synthetic-shapes-cloud-48x160")
    assert rec["bad3"] < 0.05 and rec["density"] > 0.9


@pytest.mark.parametrize(
    "args",
    [
        ["--preset", "kitti_sgm8_128_quality", "--set", "num_disparities=32"],
        ["--preset", "kitti_sgm8_128", "--set", "num_disparities=32",
         "--set", "lr_exact=true"],
        ["--preset", "tsukuba_sad16"],
    ],
    ids=["quality", "lr_exact", "tsukuba_sad16"],
)
def test_cli_run_demo_slice_presets(capsys, args):
    rc = cli.main(["run", "--demo", "--demo-shape", "48", "160",
                   "--demo-max-disp", "14", "--device", "cpu", *args])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bad3"] < 0.1 and rec["density"] > 0.9


@pytest.mark.parametrize(
    "args",
    [
        ["--model", "pyramid", "--set", "num_disparities=32"],
        ["--model", "block_matching", "--preset", "tsukuba_sad16"],
        ["--model", "classic", "--set", "num_disparities=32", "--set",
         "cost_fn=rank"],
        ["--preset", "middlebury_census_sgm4_64", "--set",
         "fill_occlusions=true"],
    ],
    ids=["pyramid", "block_matching", "rank", "middlebury_fill"],
)
def test_cli_run_demo_models(capsys, args):
    rc = cli.main(["run", "--demo", "--demo-shape", "48", "160",
                   "--demo-max-disp", "14", "--device", "cpu", *args])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bad3"] < 0.1 and rec["density"] > 0.9


def test_cli_rejects_unknown_model():
    with pytest.raises(SystemExit):
        cli.main(["run", "--demo", "--model", "learned"])


def _patch(pair, f0, f1, ctx):
    return pair.left[:, f0:f1], pair.right[:, f0 - ctx:f1]


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize(
    "kw, f0, f1, ctx",
    [
        (dict(num_disparities=16, num_paths=8), 142, 250, 15),
        (dict(num_disparities=16, num_paths=8), 142, 250, 0),
        (dict(num_disparities=16, num_paths=4, min_disparity=2,
              uniqueness_ratio=0.05), 0, 120, 0),
        (dict(num_disparities=16, num_paths=8, cost_fn="rank"), 200, 320, 15),
    ],
)
def test_framed_compute_disparity_matches_reference(kw, f0, f1, ctx, backend):
    """A static column patch (x_offset, image_width, right_context) through
    ``compute_disparity``. Against the Pallas kernels the validity is
    compared away from the block's first and last D + md columns, where
    their shifts wrap and the golden lookups clamp."""
    pair = make_pair((32, 320), max_disp=12, kind="shapes", seed=9)
    left, right = _patch(pair, f0, f1, ctx)
    call = dict(x_offset=f0, image_width=320, right_context=ctx)
    want = jpipe.compute_disparity(
        left, right, jconfig.StereoConfig(backend=backend, **kw), **call)
    got = tpipe.compute_disparity(
        torch.from_numpy(left.copy()), torch.from_numpy(right.copy()),
        tconfig.StereoConfig(**kw), **call)
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want.disp))
    cut = 0 if backend == "jnp" else 16 + kw.get("min_disparity", 0)
    w = f1 - f0
    np.testing.assert_array_equal(
        got.valid.numpy()[:, cut:w - cut],
        np.asarray(want.valid)[:, cut:w - cut])


@pytest.mark.parametrize("f0, f1", [(142, 250), (0, 130), (200, 320)])
def test_framed_lr_exact_matches_reference(f0, f1):
    """The exact LR check on a column patch: the flipped pass sits at the
    flipped global origin ``image_width - x_offset - w``."""
    pair = make_pair((32, 320), max_disp=12, kind="shapes", seed=9)
    left, right = _patch(pair, f0, f1, 0)
    kw = dict(num_disparities=16, num_paths=4, lr_exact=True)
    call = dict(x_offset=f0, image_width=320)
    want = jpipe.compute_disparity(
        left, right, jconfig.StereoConfig(backend="jnp", **kw), **call)
    got = tpipe.compute_disparity(
        torch.from_numpy(left.copy()), torch.from_numpy(right.copy()),
        tconfig.StereoConfig(**kw), **call)
    _assert_same(got, want)


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize(
    "kw, f0, f1, x0, x1",
    [
        (dict(num_disparities=16, num_paths=8), 142, 250, 160, 240),
        (dict(num_disparities=16, num_paths=8, min_disparity=3,
              uniqueness_ratio=0.05), 0, 180, 0, 160),
        (dict(num_disparities=32, num_paths=4, cost_fn="rank"), 140, 320,
         160, 320),
    ],
)
def test_compute_patch_parts_matches_reference(kw, f0, f1, x0, x1, backend):
    """``compute_patch_parts`` on an interior, a first and a last patch
    with right context and an owned range: every part equal, the Pallas
    kernel's lr_bit past its wrap region (the first D + md columns)."""
    pair = make_pair((32, 320), max_disp=12, kind="shapes", seed=9)
    d, md = kw["num_disparities"], kw.get("min_disparity", 0)
    ctx = f0 - max(0, f0 - (d - 1 + md))
    left, right = _patch(pair, f0, f1, ctx)
    call = dict(x_offset=f0, image_width=320, right_context=ctx,
                own=(x0 - f0, x1 - f0))
    want = jpipe.compute_patch_parts(
        left, right, jconfig.StereoConfig(backend=backend, **kw), **call)
    got = tpipe.compute_patch_parts(
        torch.from_numpy(left.copy()), torch.from_numpy(right.copy()),
        tconfig.StereoConfig(**kw), **call)
    for name in ("disp", "d0", "qr", "spill"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    np.testing.assert_array_equal(got.ok_nolr.numpy(),
                                  np.asarray(want.ok_nolr).astype(bool))
    cut = 0 if backend == "jnp" else d + md
    np.testing.assert_array_equal(
        got.lr_bit.numpy()[:, cut:],
        np.asarray(want.lr_bit).astype(bool)[:, cut:])


def test_compute_patch_parts_rejects():
    img = torch.zeros((8, 40), dtype=torch.uint8)
    for kw in (dict(lr_check=False), dict(lr_exact=True), dict(num_paths=0)):
        with pytest.raises(ValueError, match="compute_patch_parts"):
            tpipe.compute_patch_parts(
                img, img, tconfig.StereoConfig(num_disparities=16, **kw))
    with pytest.raises(ValueError, match="right_context"):
        tpipe.compute_patch_parts(img, img,
                                  tconfig.StereoConfig(num_disparities=16),
                                  right_context=4)
    with pytest.raises(NotImplementedError, match="lr_exact"):
        tpipe.compute_disparity(
            img, torch.zeros((8, 44), dtype=torch.uint8),
            tconfig.StereoConfig(num_disparities=16, lr_exact=True),
            right_context=4)
