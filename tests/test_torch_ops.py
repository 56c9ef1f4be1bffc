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


def _transform_image(rng, dtype, h, w):
    """uint8 values, or float32 ones with fractional parts (the transforms
    compare them truncated toward zero, the reference's astype(int32))."""
    img = _image(rng, h, w)
    if dtype == np.float32:
        img = (img + rng.random((h, w))).astype(np.float32)
    return img


#: The census / rank windows of the port's configs and the kernel tests,
#: on a frame larger than each and on frames narrower or shorter than the
#: window (every neighbour then replicates an edge pixel).
@pytest.mark.parametrize("window", [(9, 7), (5, 5), (3, 5), (7, 9)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("h, w", [(13, 21), (3, 2), (1, 30)])
def test_public_transforms_match_the_reference(window, dtype, h, w):
    img = _transform_image(np.random.default_rng(h * w), dtype, h, w)
    want = np.asarray(jops.census_transform(img, window)).astype(np.int64)
    got = tops.census_transform(_t(img), window)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    rank = tops.rank_transform(_t(img), window)
    assert rank.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(),
                                  np.asarray(j_rank_transform(img, window)))


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


#: Scanline tails of the CUDA kernel's 16-pixel ring (csrc/sgm_paths.cu):
#: one row, one column, two rows, one disparity, 40 (a partial lane).
_TAIL_SHAPES = [(1, 35, 16), (35, 1, 16), (2, 37, 16), (9, 13, 1),
                (9, 13, 40)]


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("shape", [(24, 40, 16), (21, 33, 128),
                                   *_TAIL_SHAPES])
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
        # the scanline tails of test_sgm_aggregate
        (8, dict(adaptive_grad_floor=12, shape=(1, 35, 16))),
        (8, dict(adaptive_grad_floor=12, shape=(35, 1, 16))),
        (4, dict(adaptive_grad_floor=0, shape=(2, 37, 16))),
        (8, dict(adaptive_grad_floor=0, shape=(9, 13, 40))),
    ],
)
def test_sgm_aggregate_adaptive(paths, kw):
    kw = dict(kw)
    h, w, d = kw.pop("shape", (17, 29, 16))
    rng = np.random.default_rng(paths + kw["adaptive_grad_floor"])
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


# --- framing: a column patch of a larger frame ------------------------------

from stereo_tpu.ops import postprocess as jpost  # noqa: E402
from stereo_tpu_torch.ops import postprocess as tpost  # noqa: E402

#: (min_disparity, x_offset, right_context): whole frame, a legacy patch
#: (origin only), stitched patches (origin and context), odd origins.
_FRAMES = [(0, 0, 0), (0, 24, 0), (2, 24, 17), (3, 7, 7), (0, 40, 15)]


@pytest.mark.parametrize("md, x_offset, ctx", _FRAMES)
@pytest.mark.parametrize("cost_fn", ["census", "rank", "sad"])
def test_framed_cost_volume(cost_fn, md, x_offset, ctx):
    """``x_offset`` / ``right_context`` on all three costs: the right image
    carries ctx leading columns, invalidity is global."""
    rng = np.random.default_rng(31 + md + x_offset)
    h, w, d = 13, 45, 16
    left = _image(rng, h, w)
    right = _image(rng, h, w + ctx)
    kw = dict(cost_fn=cost_fn, census_window=(7, 5), sad_window=(5, 5),
              num_disparities=d, min_disparity=md)
    want = np.asarray(jops.cost_volume(left, right, JCfg(**kw),
                                       x_offset=x_offset, right_context=ctx))
    got = tops.cost_volume(_t(left), _t(right), TCfg(**kw), x_offset=x_offset,
                           right_context=ctx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_descriptor_cost_in_row_chunks(monkeypatch):
    """The row-chunked descriptor cost equals the one-piece volume."""
    from stereo_tpu_torch.ops import cost as tcost

    rng = np.random.default_rng(2)
    left, right = _image(rng, 23, 31), _image(rng, 23, 31 + 9)
    cfg = TCfg(census_window=(9, 7), num_disparities=16, min_disparity=1)
    whole = tops.census_cost_volume(_t(left), _t(right), cfg, 12, 9)
    monkeypatch.setattr(tcost, "_CHUNK_VOXELS", 5 * 31 * 16)
    chunked = tops.census_cost_volume(_t(left), _t(right), cfg, 12, 9)
    assert torch.equal(whole, chunked)


def test_framed_cost_rejects_wrong_context_width():
    cfg = TCfg(num_disparities=16)
    with pytest.raises(ValueError, match="right_context"):
        tops.census_cost_volume(torch.zeros(4, 20), torch.zeros(4, 20), cfg,
                                right_context=3)


@pytest.mark.parametrize("md, x_offset, iw", [(0, 0, None), (0, 30, 200),
                                              (3, 30, 70), (2, 0, 64)])
def test_framed_right_disparity_and_lr(md, x_offset, iw):
    """``x_offset`` / ``image_width`` on the right-view map, the LR compare
    and ``apply_postprocess``."""
    rng = np.random.default_rng(41 + md)
    h, w, d = 9, 40, 16
    s = rng.integers(0, 30, size=(h, w, d)).astype(np.int32)
    kw = dict(num_disparities=d, min_disparity=md, median_filter=False)
    want_r = np.asarray(jops.right_disparity_from_volume(
        s, JCfg(**kw), x_offset, iw))
    got_r = tops.right_disparity_from_volume(_t(s), TCfg(**kw), x_offset, iw)
    np.testing.assert_array_equal(got_r.numpy(), want_r)

    disp_l = (rng.integers(0, d, size=(h, w)) + md).astype(np.float32)
    want = np.asarray(jops.lr_consistency(disp_l, want_r, JCfg(**kw),
                                          x_offset, iw))
    got = tops.lr_consistency(_t(disp_l), got_r, TCfg(**kw), x_offset, iw)
    np.testing.assert_array_equal(got.numpy(), want)

    ok = rng.integers(0, 2, size=(h, w)).astype(bool)
    want_d, want_v = jops.apply_postprocess(disp_l, ok, s, JCfg(**kw),
                                            x_offset, iw, disp_int=disp_l)
    got_d, got_v = tops.apply_postprocess(_t(disp_l), _t(ok), _t(s),
                                          TCfg(**kw), x_offset, iw,
                                          disp_int=_t(disp_l))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("d, md", [(16, 0), (16, 2), (16, 3), (100, 0),
                                   (128, 1), (200, 60)])
def test_spill_width(d, md):
    assert tpost.spill_width(d, md) == jpost.spill_width(d, md)


#: (config keywords, own range, x_offset, image_width): the parameter sets
#: of the reference's emit_qr test, then framed ones.
_PARTIALS = [
    (dict(), None, 0, None),
    (dict(min_disparity=3, uniqueness_ratio=0.05), None, 0, None),
    (dict(), (16, 100), 0, None),
    (dict(min_disparity=2), (8, 120), 0, None),
    (dict(), (20, 124), 60, 400),
    (dict(min_disparity=3), (0, 130), 256, 400),
]


@pytest.mark.parametrize("kw, own, x_offset, iw", _PARTIALS)
def test_right_view_partials(kw, own, x_offset, iw):
    """The packed partial min, its left spill, the unpacked winner lanes
    and the LR gate from them, map for map."""
    rng = np.random.default_rng(5)
    h, w, d = 16, 144, 16
    s = rng.integers(0, 900, size=(h, w, d)).astype(np.int32)
    jc, tc = JCfg(num_disparities=d, **kw), TCfg(num_disparities=d, **kw)
    want_qr = np.asarray(jpost.right_view_partial_min(s, jc, x_offset, iw,
                                                      src=own))
    want_sp = np.asarray(jpost.right_view_spill(s, jc, x_offset, iw, src=own))
    got_qr = tpost.right_view_partial_min(_t(s), tc, x_offset, iw, src=own)
    got_sp = tpost.right_view_spill(_t(s), tc, x_offset, iw, src=own)
    np.testing.assert_array_equal(got_qr.numpy(), want_qr)
    np.testing.assert_array_equal(got_sp.numpy(), want_sp)
    assert got_sp.shape == (h, jpost.spill_width(d, jc.min_disparity))
    assert (want_qr >= 3e38).any() or own is None

    want_dr = np.array(jpost.unpack_partial_min(want_qr, d))
    got_dr = tpost.unpack_partial_min(got_qr, d)
    np.testing.assert_array_equal(got_dr.numpy(), want_dr)
    np.testing.assert_array_equal(
        tpost.unpack_partial_min(got_sp, d).numpy(),
        np.asarray(jpost.unpack_partial_min(want_sp, d)))

    d0 = rng.integers(0, d, size=(h, w)).astype(np.int32)
    gate_iw = iw if iw is not None else w
    for r_offset, d_r in [(x_offset, want_dr), (max(0, x_offset - 40),
                                                 np.tile(want_dr, (1, 2)))]:
        want_g = np.asarray(jpost.lr_gate_from_right_map(
            d0, d_r, jc, x_offset=x_offset, image_width=gate_iw,
            r_offset=r_offset))
        got_g = tpost.lr_gate_from_right_map(
            _t(d0), _t(d_r), tc, x_offset=x_offset, image_width=gate_iw,
            r_offset=r_offset)
        np.testing.assert_array_equal(got_g.numpy(), want_g)


@pytest.mark.parametrize("kw, own, x_offset, iw", _PARTIALS)
def test_select_disparity_emit_qr_composition(kw, own, x_offset, iw):
    """``select_disparity(emit_qr=True)`` is the reference's golden patch
    composition: WTA, the two partial maps, and the gate from the patch's
    own map."""
    rng = np.random.default_rng(8)
    h, w, d = 12, 144, 16
    s = rng.integers(0, 60, size=(h, w, d)).astype(np.int32)
    jc, tc = JCfg(num_disparities=d, **kw), TCfg(num_disparities=d, **kw)
    disp, ok, lr_bit, d0, qr, spill = tpost.select_disparity(
        _t(s), tc, x_offset=x_offset, image_width=iw, emit_qr=True, own=own)
    full_iw = iw if iw is not None else x_offset + w
    j_disp, j_ok, j_dint = j_wta_with_aux(s, jc)
    j_d0 = np.asarray(j_dint) - jc.min_disparity
    j_qr = jpost.right_view_partial_min(s, jc, x_offset, full_iw, src=own)
    j_lr = jpost.lr_gate_from_right_map(
        j_d0, jpost.unpack_partial_min(j_qr, d), jc, x_offset=x_offset,
        image_width=full_iw, r_offset=x_offset)
    assert ok.dtype == lr_bit.dtype == torch.bool and d0.dtype == torch.int32
    np.testing.assert_array_equal(disp.numpy(), np.asarray(j_disp))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(d0.numpy(), j_d0)
    np.testing.assert_array_equal(qr.numpy(), np.asarray(j_qr))
    np.testing.assert_array_equal(lr_bit.numpy(), np.asarray(j_lr))
    np.testing.assert_array_equal(
        spill.numpy(),
        np.asarray(jpost.right_view_spill(s, jc, x_offset, full_iw, src=own)))


def test_select_disparity_emit_qr_needs_cheap_lr():
    s = torch.zeros((4, 40, 16), dtype=torch.int32)
    for kw in (dict(lr_check=False), dict(lr_exact=True)):
        with pytest.raises(ValueError, match="emit_qr"):
            tpost.select_disparity(s, TCfg(num_disparities=16, **kw),
                                   emit_qr=True)
