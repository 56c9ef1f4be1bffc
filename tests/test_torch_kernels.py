"""Kernel wrappers of the port (ops/cuda/*) against the Pallas kernels they
replace, run in interpret mode.

On CPU tensors each wrapper runs its kernel's plain version, so these tests
hold the plain versions against the TPU kernels and check that no launch
was counted; tests/test_torch_cuda.py holds the CUDA kernels against the
plain versions on the card. Every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu import ops as jops
from stereo_tpu.ops.census import rank_transform as j_rank_transform
from stereo_tpu.ops.cost import rank_cost_volume as j_rank_cost_volume
from stereo_tpu.ops.pallas.cost_kernel import (
    census_cost_volume_pallas,
    rank_cost_volume_pallas,
    sad_cost_volume_pallas,
)
from stereo_tpu.ops.pallas.filter_kernel import median_3x3_pallas
from stereo_tpu.ops.pallas.sgm_kernel import (
    sgm_aggregate_pallas,
    sgm_wta_fused_pallas,
)
from stereo_tpu.ops.postprocess import apply_postprocess as j_apply_postprocess
from stereo_tpu.ops.wta import wta_with_aux as j_wta_with_aux
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.ops import census_transform, rank_transform
from stereo_tpu_torch.ops.cuda import (
    census_cost,
    launch_counts,
    launch_forms,
    median3x3,
    rank_cost,
    reset_launch_counts,
    sad_cost,
    sgm_paths,
    sgm_select,
)
from stereo_tpu_torch.ops.cuda import transform_words
from stereo_tpu_torch.ops.cuda.cost_kernel import (
    SAD_MAX_VALUE,
    SAD_MAX_WINDOW,
    sad_divisor,
    sad_reciprocal,
)
from stereo_tpu_torch.ops.cuda.launch import count_launch
from stereo_tpu_torch.pipeline import _kernel_cost

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("md", [0, 3])
def test_census_cost_matches_pallas(md):
    rng = np.random.default_rng(md)
    h, w = 19, 70
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    kw = dict(census_window=(9, 7), num_disparities=128, min_disparity=md)
    want, _ = census_cost_volume_pallas(left, right, JCfg(**kw),
                                        interpret=True, out_dtype=np.int8)
    cfg = TCfg(**kw)
    before = launch_counts()
    got = census_cost(census_transform(_t(left), cfg.census_window),
                      census_transform(_t(right), cfg.census_window), cfg)
    assert launch_counts() == before
    assert got.dtype == torch.int8 and got.shape == (h, w, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:h, :w])


def test_launches_are_counted_by_form():
    """A launch is booked under its wrapper and its form; CPU calls (the
    plain versions) book nothing."""
    reset_launch_counts()
    median3x3(torch.zeros(4, 5))
    assert launch_forms() == {} and not any(launch_counts().values())
    try:
        count_launch(median3x3, 4, 5)
        count_launch(median3x3, 4, 5)
        count_launch(median3x3, 8, 5)
        count_launch(sgm_select, 8, 5, 16, -8, True, False, False, False,
                     False, False)
        assert launch_forms() == {
            ("median3x3", 4, 5): 2, ("median3x3", 8, 5): 1,
            ("sgm_select", 8, 5, 16, -8, True, False, False, False, False,
             False): 1}
        assert launch_counts()["median3x3"] == 3
        assert launch_counts()["sgm_select"] == 1
    finally:
        reset_launch_counts()
    assert launch_forms() == {}


_jit_fused = jax.jit(sgm_wta_fused_pallas, static_argnums=1,
                     static_argnames=("interpret", "emit_d0"))


@pytest.mark.parametrize(
    "shape, kw",
    [
        ((21, 33, 128), dict(num_paths=8, p1=10, p2=120,
                             uniqueness_ratio=0.02)),
        ((24, 40, 32), dict(num_paths=8, p1=14, p2=120, min_disparity=3,
                            uniqueness_ratio=0.02)),
    ],
)
def test_sgm_paths_select_match_fused_pallas(shape, kw):
    rng = np.random.default_rng(shape[2])
    cost = rng.integers(0, 25, size=shape).astype(np.int8)
    kw = dict(kw, num_disparities=shape[2], median_filter=False)
    want_disp, want_valid = _jit_fused(cost, JCfg(**kw), interpret=True)
    cfg = TCfg(**kw)
    before = launch_counts()
    s = sgm_paths(_t(cost), cfg)
    assert s.dtype == torch.int16
    disp, valid = sgm_select(s, cfg)
    assert launch_counts() == before
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))


def test_median3x3_matches_pallas():
    rng = np.random.default_rng(9)
    disp = (rng.integers(0, 512, size=(37, 150)) / 4).astype(np.float32)
    want = median_3x3_pallas(disp, interpret=True)
    before = launch_counts()
    got = median3x3(_t(disp))
    assert launch_counts() == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sgm_paths_rejects_int16_overflow():
    cfg = TCfg(num_paths=8, p2=5000)
    with pytest.raises(ValueError, match="int16"):
        sgm_paths(torch.zeros((2, 3, 32), dtype=torch.int8), cfg)


def test_sgm_paths_int16_bound_counts_p2_min():
    # Adaptive P2 can exceed P2 where p2_min > P2: 8 * (24 + 5000) >= 2^15.
    cost = torch.zeros((2, 3, 32), dtype=torch.int8)
    img = torch.zeros((2, 3), dtype=torch.uint8)
    cfg = TCfg(num_paths=8, p2=120, p2_min=5000)
    assert sgm_paths(cost, cfg).shape == cost.shape   # fixed P2: fits
    with pytest.raises(ValueError, match="int16"):
        sgm_paths(cost, cfg.replace(adaptive_p2=True), image=img)


def test_sgm_paths_adaptive_needs_image():
    cfg = TCfg(num_paths=8, adaptive_p2=True)
    cost = torch.zeros((2, 3, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="image"):
        sgm_paths(cost, cfg)
    with pytest.raises(ValueError, match="image"):
        sgm_paths(cost, cfg, image=torch.zeros((3, 2), dtype=torch.uint8))


@pytest.mark.parametrize(
    "shape, kw",
    [
        ((21, 33, 128), dict(num_paths=8, adaptive_grad_floor=12,
                             uniqueness_ratio=0.02)),
        ((24, 40, 32), dict(num_paths=4, adaptive_grad_floor=0,
                            min_disparity=3)),
    ],
)
def test_sgm_paths_adaptive_match_fused_pallas(shape, kw):
    rng = np.random.default_rng(shape[0])
    h, w, d = shape
    cost = rng.integers(0, 25, size=shape).astype(np.int8)
    img = (rng.integers(0, 4, size=(h, w)) * 30
           + rng.integers(0, 10, size=(h, w))).astype(np.uint8)
    kw = dict(kw, num_disparities=d, p1=14, p2=120, p2_min=30,
              adaptive_p2=True, median_filter=False)
    want_disp, want_valid = _jit_fused(cost, JCfg(**kw), interpret=True,
                                       image=img)
    cfg = TCfg(**kw)
    before = launch_counts()
    disp, valid = sgm_select(sgm_paths(_t(cost), cfg, image=_t(img)), cfg)
    assert launch_counts() == before
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))


@pytest.mark.parametrize("md", [0, 3])
def test_sgm_select_d0_matches_fused_pallas(md):
    rng = np.random.default_rng(13 + md)
    shape = (16, 40, 32)
    cost = rng.integers(0, 25, size=shape).astype(np.int8)
    kw = dict(num_disparities=32, num_paths=8, p1=14, p2=120,
              min_disparity=md, uniqueness_ratio=0.02, lr_check=False,
              median_filter=False)
    want_disp, packed = _jit_fused(cost, JCfg(**kw), interpret=True,
                                   emit_d0=True)
    packed = np.asarray(packed)
    cfg = TCfg(**kw, lr_exact=True)
    before = launch_counts()
    disp, ok, d0 = sgm_select(sgm_paths(_t(cost), cfg), cfg, emit_d0=True)
    assert launch_counts() == before
    assert d0.dtype == torch.int32
    np.testing.assert_array_equal(d0.numpy(), packed >> 1)
    np.testing.assert_array_equal(ok.numpy(), (packed & 1).astype(bool))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))


@pytest.mark.parametrize("kw", [dict(), dict(subpixel=True, min_disparity=2,
                                             uniqueness_ratio=0.05)])
def test_sgm_select_d16_matches_reference(kw):
    # tsukuba_sad16's selection: D=16, S is the raw SAD cost (num_paths=0).
    rng = np.random.default_rng(14)
    s = rng.integers(0, 40, size=(12, 50, 16)).astype(np.int16)
    kw = dict(dict(cost_fn="sad", num_disparities=16, num_paths=0,
                   subpixel=False), **kw)
    jcfg = JCfg(**kw)
    jd, jv, ji = j_wta_with_aux(s.astype(np.int32), jcfg)
    want_disp, want_valid = j_apply_postprocess(
        jd, jv, s.astype(np.int32), jcfg.replace(median_filter=False),
        disp_int=ji)
    cfg = TCfg(**kw)
    disp, valid = sgm_select(_t(s), cfg)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))


@pytest.mark.parametrize("md, d, window", [(0, 16, (9, 9)), (3, 16, (9, 9)),
                                          (0, 64, (9, 9)), (3, 16, (5, 7))])
def test_sad_cost_matches_pallas(md, d, window):
    rng = np.random.default_rng(15 + md)
    h, w = 19, 70
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    kw = dict(cost_fn="sad", sad_window=window, num_disparities=d,
              min_disparity=md)
    want, _ = sad_cost_volume_pallas(left, right, JCfg(**kw), interpret=True)
    before = launch_counts()
    got = sad_cost(_t(left), _t(right), TCfg(**kw))
    assert launch_counts() == before
    assert got.dtype == torch.int16 and got.shape == (h, w, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:h, :w])


@pytest.mark.parametrize("md, x_offset, ctx", [(0, 24, 24), (3, 40, 17)])
def test_sad_cost_right_context_matches_reference(md, x_offset, ctx):
    # The TPU kernel takes no right context: the reference computes SAD
    # with one through its golden volume, and so does K5.
    rng = np.random.default_rng(17 + ctx)
    h, w = 11, 50
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w + ctx)).astype(np.uint8)
    kw = dict(cost_fn="sad", sad_window=(5, 7), num_disparities=16,
              min_disparity=md)
    want = jops.sad_cost_volume(left, right, JCfg(**kw), x_offset, ctx)
    before = launch_counts()
    got = sad_cost(_t(left), _t(right), TCfg(**kw), x_offset, ctx)
    assert launch_counts() == before
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_sad_cost_image_types_match_reference(dtype):
    # K5 reads uint8, int32 and float32 images as they are; the plain
    # version, as the reference, takes them as int32 (float32 truncated
    # toward zero, so the negative and fractional values matter). The
    # int32 values keep |L - R| <= 32767, so every cost fits the int16
    # volume that K5, as the reference's TPU kernel, returns.
    rng = np.random.default_rng(23)
    h, w, ctx = 13, 40, 9
    if dtype == np.uint8:
        left, right = (rng.integers(0, 256, size=(h, n)).astype(dtype)
                       for n in (w, w + ctx))
    elif dtype == np.int32:
        left, right = (rng.integers(-16383, 16384, size=(h, n)).astype(dtype)
                       for n in (w, w + ctx))
    else:
        left, right = (rng.uniform(-300, 300, size=(h, n)).astype(dtype)
                       for n in (w, w + ctx))
    kw = dict(cost_fn="sad", sad_window=(5, 7), num_disparities=24,
              min_disparity=2)
    want = jops.sad_cost_volume(left, right, JCfg(**kw), 11, ctx)
    before = launch_counts()
    got = sad_cost(_t(left), _t(right), TCfg(**kw), 11, ctx)
    assert launch_counts() == before
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wy", range(1, SAD_MAX_WINDOW + 1, 2))
def test_sad_divisor_is_floor_division(wy):
    # K5 divides a window sum by the area as (sum * magic) >> shift. Every
    # sum of a uint8 pair (up to 255 * area) is checked, and up to the
    # largest sum the wrapper admits (2 * SAD_MAX_VALUE * area) the first
    # and the last sum of every quotient: the method's error grows with
    # the sum, so each quotient's ends are where it would first show.
    # The top of the range the kernel's 32-bit sums allow, [2^31 - 2^16,
    # 2^31), is checked whole.
    for wx in range(1, SAD_MAX_WINDOW + 1, 2):
        area = wy * wx
        magic, shift = sad_divisor(area)
        assert 0 < magic < 2**32
        q = np.arange(2 * SAD_MAX_VALUE + 1, dtype=np.uint64)
        sums = np.concatenate([
            np.arange(255 * area + 1, dtype=np.uint64),
            q * area, q * area + area - 1,
            np.arange(2**31 - 2**16, 2**31, dtype=np.uint64)])
        got = (sums * np.uint64(magic)) >> np.uint64(shift)
        np.testing.assert_array_equal(got, sums // np.uint64(area))
    with pytest.raises(ValueError):
        sad_divisor(0)


@pytest.mark.parametrize("wy", range(1, SAD_MAX_WINDOW + 1, 2))
def test_sad_reciprocal_is_floor_division(wy):
    # K5 sums uint8 images in float and divides as floor(fma(sum, inv,
    # bias)): every sum a uint8 pair can give (0 .. 255 * area) is
    # checked. n * inv + bias is exact in float64 (n < 2^17, 24-bit
    # factors), so its rounding to float32 is the fused multiply-add's.
    for wx in range(1, SAD_MAX_WINDOW + 1, 2):
        area = wy * wx
        inv, bias = sad_reciprocal(area)
        assert np.float32(inv) == inv and np.float32(bias) == bias
        sums = np.arange(255 * area + 1, dtype=np.int64)
        y = (sums * np.float64(inv) + np.float64(bias)).astype(np.float32)
        np.testing.assert_array_equal(np.floor(y).astype(np.int64),
                                      sums // area)
    with pytest.raises(ValueError):
        sad_reciprocal(0)


def test_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        census_cost(torch.zeros((2, 3, 2), dtype=torch.int64),
                    torch.zeros((2, 3, 2), dtype=torch.int64,
                                device="meta"), TCfg())


def test_rank_cost_matches_pallas():
    # D=16 takes the TPU's d-major kernel (_cost_kernel), rank combine.
    rng = np.random.default_rng(31)
    h, w = 24, 40
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    kw = dict(cost_fn="rank", census_window=(9, 7), num_disparities=16,
              min_disparity=2)
    want, _ = rank_cost_volume_pallas(left, right, JCfg(**kw), interpret=True)
    cfg = TCfg(**kw)
    before = launch_counts()
    got = rank_cost(rank_transform(_t(left), cfg.census_window),
                    rank_transform(_t(right), cfg.census_window), cfg)
    assert launch_counts() == before
    assert got.dtype == torch.int8 and got.shape == (h, w, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:h, :w])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_rank_cost_volume(left, right, JCfg(**kw))))


def test_rank_cost_rejects_other_cost_fn():
    r = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="rank"):
        rank_cost(r, r, TCfg())
    with pytest.raises(ValueError, match="rank maps"):
        rank_cost(r, r[:, :4], TCfg(cost_fn="rank"))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_sgm_paths_d16_matches_staged_pallas(adaptive):
    # The pyramid's residual aggregation: D=16, min_disparity=-8, 8 paths,
    # against sgm_aggregate_pallas (lane-packed on the TPU) and the golden.
    rng = np.random.default_rng(32)
    h, w, d = 24, 40, 16
    cost = rng.integers(0, 25, size=(h, w, d)).astype(np.int16)
    img = (rng.integers(0, 4, size=(h, w)) * 30
           + rng.integers(0, 10, size=(h, w))).astype(np.uint8)
    kw = dict(num_disparities=d, min_disparity=-8, num_paths=8, p1=14,
              p2=120, lr_check=False)
    if adaptive:
        kw.update(adaptive_p2=True, adaptive_grad_floor=12, p2_min=30)
    want = np.asarray(sgm_aggregate_pallas(cost, JCfg(**kw), interpret=True,
                                           image=img))
    golden = np.asarray(jops.sgm_aggregate(cost.astype(np.int32), JCfg(**kw),
                                           image=img))
    before = launch_counts()
    got = sgm_paths(_t(cost.astype(np.int8)), TCfg(**kw), image=_t(img))
    assert launch_counts() == before
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want[:h, :w])
    np.testing.assert_array_equal(got.numpy(), golden)


@pytest.mark.parametrize("paths", [4, 8])
def test_sgm_paths_int16_sad_costs_match_golden(paths):
    # SAD costs up to 255 in int16 through SGM: 8 * (255 + 120) < 2^15.
    rng = np.random.default_rng(33)
    left = rng.integers(0, 256, size=(20, 48)).astype(np.uint8)
    right = rng.integers(0, 256, size=(20, 48)).astype(np.uint8)
    kw = dict(cost_fn="sad", sad_window=(5, 5), num_disparities=24,
              num_paths=paths, p1=14, p2=120)
    want = np.asarray(jops.sgm_aggregate(
        jops.sad_cost_volume(left, right, JCfg(**kw)), JCfg(**kw)))
    cfg = TCfg(**kw)
    cost = sad_cost(_t(left), _t(right), cfg)
    assert cost.dtype == torch.int16 and int(cost.max()) > 127
    got = sgm_paths(cost, cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_sgm_select_negative_origin_matches_reference():
    rng = np.random.default_rng(34)
    s = rng.integers(0, 300, size=(12, 50, 16)).astype(np.int16)
    kw = dict(num_disparities=16, min_disparity=-8, lr_check=False,
              uniqueness_ratio=0.02, subpixel=True)
    want_disp, want_valid, _ = j_wta_with_aux(s.astype(np.int32), JCfg(**kw))
    before = launch_counts()
    disp, valid = sgm_select(_t(s), TCfg(**kw))
    assert launch_counts() == before
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))


_jit_fused_qr = jax.jit(sgm_wta_fused_pallas, static_argnums=1,
                        static_argnames=("interpret", "emit_qr", "qr_src",
                                         "x_offset", "image_width"))


@pytest.mark.parametrize(
    "kw, own, x_offset, iw",
    [
        (dict(), None, 0, None),
        (dict(min_disparity=3, uniqueness_ratio=0.05), None, 0, None),
        (dict(), (16, 100), 0, None),
        (dict(min_disparity=2), (8, 120), 0, None),
        (dict(), (20, 124), 60, 400),
        (dict(min_disparity=3, uniqueness_ratio=0.05), (0, 130), 256, 400),
    ],
)
def test_sgm_select_emit_qr_matches_fused_pallas(kw, own, x_offset, iw):
    """K3's emit_qr form (its plain version, on the CPU) against the TPU
    kernel in interpret mode at 16x144x16: the TPU packs ok + 2 lr + 4 d0
    into one word; its lr_bit is compared past the first D + md columns
    only, where its mod-W wrap does not reach."""
    rng = np.random.default_rng(5)
    h, w, d = 16, 144, 16
    cost = rng.integers(0, 25, size=(h, w, d)).astype(np.int16)
    ckw = dict(num_disparities=d, num_paths=8, p1=3, p2=20,
               median_filter=False, lr_check=True, **kw)
    want_disp, packed, want_qr, want_spill = _jit_fused_qr(
        cost, JCfg(**ckw), interpret=True, emit_qr=True, qr_src=own,
        x_offset=x_offset, image_width=iw)
    packed = np.asarray(packed)
    cfg = TCfg(**ckw)
    before = launch_counts()
    disp, ok, lr_bit, d0, qr, spill = sgm_select(
        sgm_paths(_t(cost), cfg), cfg, x_offset=x_offset, image_width=iw,
        emit_qr=True, own=own)
    assert launch_counts() == before
    np.testing.assert_array_equal(qr.numpy(), np.asarray(want_qr))
    np.testing.assert_array_equal(spill.numpy(), np.asarray(want_spill))
    np.testing.assert_array_equal(ok.numpy(), (packed & 1).astype(bool))
    np.testing.assert_array_equal(d0.numpy(), packed >> 2)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))
    cut = d + cfg.min_disparity
    np.testing.assert_array_equal(lr_bit.numpy()[:, cut:],
                                  ((packed >> 1) & 1).astype(bool)[:, cut:])


def test_sgm_select_emit_qr_rejects():
    """emit_qr needs the cheap LR check, a block at least D + md wide and
    an own range inside the block; a block must overlap its frame (a tile
    may reach past its edges)."""
    s = torch.zeros((4, 40, 16), dtype=torch.int16)
    cfg = TCfg(num_disparities=16)
    with pytest.raises(ValueError, match="cheap LR"):
        sgm_select(s, cfg.replace(lr_exact=True), emit_qr=True)
    with pytest.raises(ValueError, match="block width"):
        sgm_select(s[:, :12], cfg, emit_qr=True)
    with pytest.raises(ValueError, match="own"):
        sgm_select(s, cfg, emit_qr=True, own=(8, 50))
    with pytest.raises(ValueError, match="leaves the frame"):
        sgm_select(s, cfg, x_offset=60, image_width=60)
    with pytest.raises(ValueError, match="leaves the frame"):
        sgm_select(s, cfg, x_offset=-40, image_width=60)


@pytest.mark.parametrize("x_offset, iw", [(24, 200), (0, 100), (60, 130)])
def test_sgm_select_framed_matches_fused_pallas(x_offset, iw):
    """K3's base form on a column patch (x_offset, image_width), its plain
    version against the TPU kernel in interpret mode. The two differ only
    where the golden lookups clamp into the block and the TPU's shifts wrap
    mod W: the first D + md columns of a block that starts inside the frame
    and the last D + md of one that ends inside it, which every caller
    crops."""
    rng = np.random.default_rng(17)
    h, w, d = 16, 70, 16
    cost = rng.integers(0, 25, size=(h, w, d)).astype(np.int16)
    ckw = dict(num_disparities=d, num_paths=8, p1=3, p2=20,
               uniqueness_ratio=0.05, median_filter=False, lr_check=True)
    want_disp, want_ok = _jit_fused_qr(cost, JCfg(**ckw), interpret=True,
                                       x_offset=x_offset, image_width=iw)
    cfg = TCfg(**ckw)
    disp, ok = sgm_select(sgm_paths(_t(cost), cfg), cfg, x_offset=x_offset,
                          image_width=iw)
    lo = d if x_offset else 0
    hi = w if x_offset + w == iw else w - d
    np.testing.assert_array_equal(disp.numpy(), np.asarray(want_disp))
    np.testing.assert_array_equal(ok.numpy()[:, lo:hi],
                                  np.asarray(want_ok)[:, lo:hi])


@pytest.mark.parametrize("md, x_offset, ctx", [(0, 24, 0), (2, 24, 17),
                                               (0, 40, 15)])
def test_framed_census_cost_matches_pallas(md, x_offset, ctx):
    """K1 with x_offset and right_context (plain version) against the TPU
    kernel in interpret mode, from the same descriptors' images."""
    rng = np.random.default_rng(md + ctx)
    h, w = 19, 70
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w + ctx)).astype(np.uint8)
    kw = dict(census_window=(9, 7), num_disparities=16, min_disparity=md)
    want, _ = census_cost_volume_pallas(
        left, right, JCfg(**kw), interpret=True, out_dtype=np.int8,
        x_offset=x_offset, right_context=ctx)
    cfg = TCfg(**kw)
    got = census_cost(census_transform(_t(left), cfg.census_window),
                      census_transform(_t(right), cfg.census_window), cfg,
                      x_offset=x_offset, right_context=ctx)
    assert got.dtype == torch.int8 and got.shape == (h, w, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:h, :w])


@pytest.mark.parametrize("window", [(9, 7), (5, 5), (3, 5), (7, 9)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("h, w", [(11, 37), (2, 3)])
def test_transform_words_match_reference(window, dtype, h, w):
    """K1's transform stage (plain version): the reference's census bits
    as int32 words, and its rank map; float32 values truncate."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, size=(h, w)).astype(dtype)
    if dtype == np.float32:
        img = img + rng.random((h, w)).astype(np.float32)
    reset_launch_counts()
    words = transform_words(_t(img), window)
    want = np.asarray(jops.census_transform(img, window)).astype(np.uint32)
    assert words.dtype == torch.int32 and words.shape == want.shape
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    rank = transform_words(_t(img), window, rank=True)
    assert rank.dtype == torch.int32 and rank.shape == (h, w)
    np.testing.assert_array_equal(
        rank.numpy(), np.asarray(j_rank_transform(img, window)))
    assert launch_forms() == {}


def test_transform_words_rejects():
    img = torch.zeros((4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd"):
        transform_words(img, (4, 5))
    with pytest.raises(ValueError, match="64 bits"):
        transform_words(img, (9, 9))
    assert transform_words(img, (9, 9), rank=True).shape == (4, 5)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        transform_words(img[None], (5, 5))


@pytest.mark.parametrize(
    "kw, x_offset, ctx",
    [(dict(census_window=(9, 7), num_disparities=24), 0, 0),
     (dict(census_window=(5, 5), num_disparities=17, min_disparity=2), 30,
      11),
     (dict(cost_fn="rank", census_window=(7, 9), num_disparities=9), 0, 0),
     (dict(cost_fn="rank", census_window=(9, 7), num_disparities=20,
           min_disparity=1), 12, 20)],
    ids=["census2", "census1_framed", "rank", "rank_framed"])
def test_kernel_cost_from_images_matches_reference(kw, x_offset, ctx):
    """The main path's K1 (transform stage on each image, then the cost
    stage on the int32 words; plain versions on the CPU) against the
    reference's golden volume on the same images."""
    rng = np.random.default_rng(ctx + kw["num_disparities"])
    h, w = 9, 41
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w + ctx)).astype(np.uint8)
    want = np.asarray(jops.cost_volume(left, right, JCfg(**kw),
                                       x_offset=x_offset, right_context=ctx))
    got = _kernel_cost(_t(left), _t(right), TCfg(**kw), x_offset, ctx)
    assert got.dtype == torch.int8 and got.shape == (h, w, want.shape[2])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cost_fn", ["census", "rank"])
def test_k1_from_images_matches_pallas(cost_fn):
    """Images through K1's two stages (plain versions) against the
    reference's K1 entry point, transforms included, in interpret mode."""
    rng = np.random.default_rng(41)
    h, w = 10, 36
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    kw = dict(cost_fn=cost_fn, census_window=(9, 7), num_disparities=16,
              min_disparity=1)
    pallas = (census_cost_volume_pallas if cost_fn == "census"
              else rank_cost_volume_pallas)
    want, _ = pallas(left, right, JCfg(**kw), interpret=True)
    cfg = TCfg(**kw)
    rank = cost_fn == "rank"
    words = [transform_words(_t(img), cfg.census_window, rank=rank)
             for img in (left, right)]
    got = (rank_cost if rank else census_cost)(*words, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:h, :w])
