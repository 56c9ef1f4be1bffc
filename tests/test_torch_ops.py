"""Plain torch ops of the port against their stereo_tpu.ops twins.

Same numpy inputs (from default_rng) through both packages; every
comparison is exact (integer costs, and float steps done in the same IEEE
float32 order).
"""

import jax
import numpy as np
import pytest
import torch

from stereo_tpu import ops as jops
from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.ops.census import rank_transform as j_rank_transform
from stereo_tpu.ops.cost import rank_cost_volume as j_rank_cost_volume
from stereo_tpu.ops.sgm import adaptive_p2_map as j_adaptive_p2_map
from stereo_tpu.ops.wta import wta_with_aux as j_wta_with_aux
from stereo_tpu_torch import ops as tops
from stereo_tpu_torch.config import StereoConfig as TCfg

torch.set_num_threads(1)


def _image(rng, h, w):
    return rng.integers(0, 256, size=(h, w)).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("window", [(5, 5), (7, 7), (9, 7)])
def test_census_transform(window):
    img = _image(np.random.default_rng(1), 19, 27)
    want = np.asarray(jops.census_transform(img, window)).astype(np.int64)
    got = tops.census_transform(_t(img), window).numpy()
    np.testing.assert_array_equal(got, want)


def test_census_transform_flat_image_has_no_bits():
    got = tops.census_transform(torch.full((5, 6), 7, dtype=torch.uint8),
                                (5, 5))
    assert not got.any()


def test_hamming_distance():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, size=(7, 5, 2), dtype=np.uint64)
    b = rng.integers(0, 2**32, size=(7, 5, 2), dtype=np.uint64)
    want = np.asarray(jops.hamming_distance(a.astype(np.uint32),
                                            b.astype(np.uint32)))
    got = tops.hamming_distance(_t(a.astype(np.int64)),
                                _t(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("md", [0, 3])
def test_census_cost_volume(md):
    rng = np.random.default_rng(3)
    left, right = _image(rng, 17, 45), _image(rng, 17, 45)
    kw = dict(census_window=(9, 7), num_disparities=24, min_disparity=md)
    want = np.asarray(jops.census_cost_volume(left, right, JCfg(**kw)))
    got = tops.census_cost_volume(_t(left), _t(right), TCfg(**kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


_jit_sgm = jax.jit(jops.sgm_aggregate, static_argnums=1)


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("shape", [(24, 40, 16), (21, 33, 128)])
def test_sgm_aggregate(paths, shape):
    rng = np.random.default_rng(paths)
    cost = rng.integers(0, 64, size=shape).astype(np.int32)
    kw = dict(num_paths=paths, p1=14, p2=120)
    want = np.asarray(_jit_sgm(cost, JCfg(**kw)))
    got = tops.sgm_aggregate(_t(cost), TCfg(**kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sgm_aggregate_zero_paths_is_identity():
    cost = np.random.default_rng(0).integers(0, 9, size=(4, 6, 8))
    got = tops.sgm_aggregate(_t(cost.astype(np.int8)), TCfg(num_paths=0))
    np.testing.assert_array_equal(got.numpy(), cost)


@pytest.mark.parametrize(
    "kw",
    [
        dict(subpixel=True, uniqueness_ratio=0.02),
        dict(subpixel=True, uniqueness_ratio=0.0),
        dict(subpixel=False, uniqueness_ratio=0.05),
        dict(subpixel=True, uniqueness_ratio=0.02, min_disparity=3),
    ],
)
@pytest.mark.parametrize("levels", [4, 400])
def test_wta_with_aux(kw, levels):
    # levels=4 forces many ties (first-min rule, zero curvature, ties at
    # +-1); levels=400 exercises the parabola and the uniqueness product.
    rng = np.random.default_rng(levels)
    s = rng.integers(0, levels, size=(13, 29, 32)).astype(np.int32)
    want = [np.asarray(a) for a in j_wta_with_aux(s, JCfg(**kw))]
    got = [a.numpy() for a in tops.wta_with_aux(_t(s), TCfg(**kw))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("md", [0, 3])
def test_right_disparity_from_volume(md):
    rng = np.random.default_rng(5)
    s = rng.integers(0, 30, size=(9, 40, 16)).astype(np.int32)
    kw = dict(num_disparities=16, min_disparity=md)
    want = np.asarray(jops.right_disparity_from_volume(s, JCfg(**kw)))
    got = tops.right_disparity_from_volume(_t(s), TCfg(**kw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("md", [0, 3])
def test_lr_consistency(md):
    rng = np.random.default_rng(6)
    d = 16
    disp_l = (rng.integers(0, d, size=(11, 37)) + md).astype(np.float32)
    disp_r = (rng.integers(0, d, size=(11, 37)) + md).astype(np.float32)
    kw = dict(num_disparities=d, min_disparity=md, lr_tau=1.0)
    want = np.asarray(jops.lr_consistency(disp_l, disp_r, JCfg(**kw)))
    got = tops.lr_consistency(_t(disp_l), _t(disp_r), TCfg(**kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_median_3x3():
    rng = np.random.default_rng(7)
    disp = (rng.integers(0, 64, size=(15, 23)) / 4).astype(np.float32)
    want = np.asarray(jops.median_3x3(disp))
    np.testing.assert_array_equal(tops.median_3x3(_t(disp)).numpy(), want)


@pytest.mark.parametrize("lr_check", [True, False])
def test_apply_postprocess(lr_check):
    rng = np.random.default_rng(8)
    s = rng.integers(0, 50, size=(12, 30, 16)).astype(np.int32)
    kw = dict(num_disparities=16, lr_check=lr_check, uniqueness_ratio=0.02)
    jd, jv, ji = j_wta_with_aux(s, JCfg(**kw))
    want = jops.apply_postprocess(jd, jv, s, JCfg(**kw), disp_int=ji)
    td, tv, ti = tops.wta_with_aux(_t(s), TCfg(**kw))
    got = tops.apply_postprocess(td, tv, _t(s), TCfg(**kw), disp_int=ti)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("floor", [0, 12])
@pytest.mark.parametrize("dy, dx", [(0, -1), (0, 1), (-1, 0), (1, 0),
                                    (-1, -1), (1, 1), (-1, 1), (1, -1)])
def test_adaptive_p2_map(dy, dx, floor):
    img = _image(np.random.default_rng(10), 13, 21)
    kw = dict(adaptive_p2=True, p2=120, p2_min=30, adaptive_grad_floor=floor)
    want = np.asarray(j_adaptive_p2_map(img, JCfg(**kw), dy, dx))
    got = tops.adaptive_p2_map(_t(img), TCfg(**kw), dy, dx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "paths, kw",
    [
        (4, dict(adaptive_grad_floor=0)),
        (4, dict(adaptive_grad_floor=12)),
        (8, dict(adaptive_grad_floor=0)),
        (8, dict(adaptive_grad_floor=12)),
        (8, dict(adaptive_grad_floor=3, p2_min=200)),   # p2_min > p2
    ],
)
def test_sgm_aggregate_adaptive(paths, kw):
    rng = np.random.default_rng(paths + kw["adaptive_grad_floor"])
    h, w, d = 17, 29, 16
    cost = rng.integers(0, 64, size=(h, w, d)).astype(np.int32)
    # Smooth regions and sharp edges: gradients on both sides of the floor.
    img = (rng.integers(0, 4, size=(h, w)) * 20
           + rng.integers(0, 8, size=(h, w))).astype(np.uint8)
    kw = dict(dict(num_paths=paths, p1=14, p2=120, p2_min=30,
                   adaptive_p2=True), **kw)
    want = np.asarray(_jit_sgm(cost, JCfg(**kw), img))
    got = tops.sgm_aggregate(_t(cost), TCfg(**kw), image=_t(img))
    np.testing.assert_array_equal(got.numpy(), want)
    fixed = tops.sgm_aggregate(_t(cost), TCfg(**kw))
    assert not torch.equal(got, fixed)   # the image changed P2


@pytest.mark.parametrize("window", [(9, 9), (5, 7)])
def test_box_sum(window):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, size=(14, 23, 5)).astype(np.int32)
    want = np.asarray(jops.box_sum(a, window))
    np.testing.assert_array_equal(tops.box_sum(_t(a), window).numpy(), want)
    want2 = np.asarray(jops.box_sum(a[..., 0], window))
    np.testing.assert_array_equal(
        tops.box_sum(_t(a[..., 0]), window).numpy(), want2)


@pytest.mark.parametrize("window", [(9, 9), (5, 7)])
@pytest.mark.parametrize("md", [0, 3])
def test_sad_cost_volume(md, window):
    rng = np.random.default_rng(12)
    left, right = _image(rng, 15, 41), _image(rng, 15, 41)
    kw = dict(cost_fn="sad", sad_window=window, num_disparities=16,
              min_disparity=md)
    want = np.asarray(jops.sad_cost_volume(left, right, JCfg(**kw)))
    got = tops.sad_cost_volume(_t(left), _t(right), TCfg(**kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.cost_volume(_t(left), _t(right), TCfg(**kw)).numpy(), want)


def test_cost_volume_rank_is_not_ported():
    """cost_fn="rank" does not raise: the dispatch gives the reference's
    rank volume."""
    rng = np.random.default_rng(20)
    left, right = _image(rng, 9, 30), _image(rng, 9, 30)
    kw = dict(cost_fn="rank", census_window=(5, 5), num_disparities=8)
    want = np.asarray(jops.cost_volume(left, right, JCfg(**kw)))
    got = tops.cost_volume(_t(left), _t(right), TCfg(**kw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [(3, 3), (5, 5), (9, 7)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rank_transform(window, dtype):
    img = _image(np.random.default_rng(21), 19, 27).astype(dtype)
    want = np.asarray(j_rank_transform(img, window))
    got = tops.rank_transform(_t(img), window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) <= window[0] * window[1] - 1


def test_rank_transform_rejects_even_window():
    with pytest.raises(ValueError, match="odd"):
        tops.rank_transform(torch.zeros((4, 4), dtype=torch.uint8), (4, 5))


@pytest.mark.parametrize("md", [0, 3])
@pytest.mark.parametrize("window, d", [((9, 7), 24), ((5, 5), 1)])
def test_rank_cost_volume(md, window, d):
    rng = np.random.default_rng(22)
    left, right = _image(rng, 17, 45), _image(rng, 17, 45)
    kw = dict(cost_fn="rank", census_window=window, num_disparities=d,
              min_disparity=md)
    want = np.asarray(j_rank_cost_volume(left, right, JCfg(**kw)))
    got = tops.rank_cost_volume(_t(left), _t(right), TCfg(**kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.cost_volume(_t(left), _t(right), TCfg(**kw)).numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(subpixel=False),
                                dict(uniqueness_ratio=0.0)])
def test_select_disparity_negative_origin(kw):
    # The pyramid's residual selection: md = -R/2, no LR check.
    rng = np.random.default_rng(23)
    s = rng.integers(0, 300, size=(12, 50, 16)).astype(np.int32)
    kw = dict(dict(num_disparities=16, min_disparity=-8, lr_check=False,
                   uniqueness_ratio=0.02, subpixel=True), **kw)
    want_disp, want_valid, _ = j_wta_with_aux(s, JCfg(**kw))
    disp, valid = tops.select_disparity(_t(s.astype(np.int16)), TCfg(**kw))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))
    assert float(disp.min()) < 0
