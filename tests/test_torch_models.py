"""The port's model family (classic, block matching, pyramid) against the
reference's models on the golden path, and the pyramid's helpers one by
one. Same numpy inputs through both packages; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from stereo_tpu import config as jconfig
from stereo_tpu import models as jmodels
from stereo_tpu.data import make_pair
from stereo_tpu.models import pyramid as jpyr
from stereo_tpu.ops import census_transform as j_census_transform
from stereo_tpu_torch import config as tconfig
from stereo_tpu_torch import models as tmodels
from stereo_tpu_torch.models import pyramid as tpyr
from stereo_tpu_torch.ops import census_transform

torch.set_num_threads(1)

_QUALITY = dict(adaptive_p2=True, adaptive_grad_floor=12, p2_min=30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want.disp))


def test_registry_matches_reference():
    assert sorted(tmodels.MODELS) == sorted(jmodels.MODELS)
    for name in tmodels.MODELS:
        assert tmodels.get_model(name).describe() == \
            jmodels.get_model(name).describe()
        assert tmodels.get_model(name).name == name
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.get_model("learned")


def test_model_configs_match_reference():
    # BlockMatching drops the paths of any config; PyramidSGM overrides the
    # census window only when one is passed.
    cfg = tconfig.KITTI_SGM8_128
    assert tmodels.get_model("block_matching", cfg=cfg).cfg.num_paths == 0
    assert tmodels.get_model("pyramid", cfg=cfg).cfg == cfg
    assert tmodels.get_model(
        "pyramid", cfg=cfg, census_window=(5, 5)).cfg.census_window == (5, 5)
    with pytest.raises(ValueError, match="even"):
        tmodels.get_model("pyramid", residual_range=7)
    with pytest.raises(NotImplementedError):
        tmodels.StereoModel(cfg).build("cpu")


@pytest.mark.parametrize("d, coarse_d", [(128, 64), (32, 16), (12, 8)])
def test_pyramid_coarse_cfg(d, coarse_d):
    # Half the disparities but never fewer than 8; integer winners, median
    # on, no LR check; every other field is the model's.
    cfg = tconfig.KITTI_SGM8_128_QUALITY.replace(
        num_disparities=d, median_filter=False)
    model = tmodels.get_model("pyramid", cfg=cfg, census_window=(5, 5))
    assert model.coarse_cfg() == model.cfg.replace(
        num_disparities=coarse_d, lr_check=False, median_filter=True,
        subpixel=False)
    assert model.coarse_cfg().census_window == (5, 5)


@pytest.mark.parametrize(
    "name, preset, kw",
    [
        ("classic", "kitti_sgm8_128", dict(num_disparities=32)),
        ("classic", "middlebury_census_sgm4_64", dict(num_disparities=16)),
        ("block_matching", "tsukuba_sad16", {}),
        ("block_matching", "kitti_sgm8_128", dict(num_disparities=32)),
    ],
)
def test_classic_models_match_reference(name, preset, kw):
    pair = make_pair((48, 96), max_disp=14, kind="shapes", texture="cloud",
                     seed=4)
    got = tmodels.get_model(
        name, cfg=tconfig.PRESETS[preset].replace(**kw)).build("cpu")
    want = jmodels.get_model(
        name, cfg=jconfig.PRESETS[preset].replace(backend="jnp", **kw)).build()
    _assert_same(got(pair.left, pair.right), want(pair.left, pair.right))


@pytest.mark.parametrize("shape", [(96, 160), (75, 121)],
                         ids=["even", "odd"])
@pytest.mark.parametrize(
    "kw, mkw",
    [
        ({}, {}),
        ({}, dict(census_window=(5, 5))),
        (_QUALITY, dict(census_window=(5, 5))),
        (dict(median_filter=False, uniqueness_ratio=0.0),
         dict(residual_range=8)),
    ],
    ids=["9x7", "5x5", "quality_5x5", "r8_nomedian"],
)
def test_pyramid_matches_reference(shape, kw, mkw):
    pair = make_pair(shape, max_disp=24, kind="shapes", texture="cloud",
                     seed=1)
    kw = dict(kw, num_disparities=32)
    got = tmodels.get_model(
        "pyramid", cfg=tconfig.KITTI_SGM8_128.replace(**kw), **mkw
    ).build("cpu")(pair.left, pair.right)
    want = jmodels.get_model(
        "pyramid", cfg=jconfig.KITTI_SGM8_128.replace(backend="jnp", **kw),
        **mkw,
    ).build()(pair.left, pair.right)
    _assert_same(got, want)
    assert got.disp.shape == shape and got.valid.float().mean() > 0.8


@pytest.mark.parametrize("shape", [(8, 12), (9, 13), (1, 7)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pool2(shape, dtype):
    img = np.random.default_rng(3).integers(0, 256, size=shape).astype(dtype)
    got = tpyr._pool2(_t(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpyr._pool2(img)))


@pytest.mark.parametrize("h, w", [(8, 12), (7, 11)])
def test_upsample2(h, w):
    base = np.random.default_rng(4).integers(0, 40, size=(4, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tpyr._upsample2(_t(base), h, w).numpy(),
        np.asarray(jpyr._upsample2(base, h, w)))


@pytest.mark.parametrize("k", [3, 5])
def test_local_minmax_center(k):
    # Odd sums give .5 midpoints: rounding is to even in both packages.
    base = np.random.default_rng(5).integers(0, 40, size=(11, 17)).astype(
        np.float32)
    got = tpyr._local_minmax_center(_t(base), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpyr._local_minmax_center(base, k)))
    assert (got == np.round(got)).all()


@pytest.mark.parametrize("window", [(5, 5), (9, 7)])
def test_residual_cost_volume(window):
    rng = np.random.default_rng(6)
    h, w, r = 9, 40, 16
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    base_i = rng.integers(0, 32, size=(h, w)).astype(np.int32)
    want = jpyr._residual_cost_volume(
        j_census_transform(left, window), j_census_transform(right, window),
        base_i, r // 2, r, use_mxu=False)
    got = tpyr._residual_cost_volume(
        census_transform(_t(left), window), census_transform(_t(right), window),
        _t(base_i), r // 2, r)
    assert got.dtype == torch.int32 and got.shape == (h, w, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
