"""CUDA kernels of the port against their plain torch versions, on the card.

Marked ``cuda``; every test skips without a CUDA device. On the machine
with the card (which has no jax, so tests/conftest.py cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged (widths not a multiple of the 128-column tile,
odd frame sizes, D from 1 to 256 including counts that fill no whole warp
or lane); every comparison is exact.
"""

import numpy as np
import pytest
import torch

from stereo_tpu_torch import (
    KITTI_SGM8_128,
    KITTI_SGM8_128_QUALITY,
    MIDDLEBURY_CENSUS_SGM4_64,
    TSUKUBA_SAD16,
    build_pipeline,
)
from stereo_tpu_torch.config import StereoConfig
from stereo_tpu_torch.data import make_pair
from stereo_tpu_torch.eval import roofline
from stereo_tpu_torch.models import get_model
from stereo_tpu_torch.ops import (
    census_cost_volume,
    census_transform,
    median_3x3,
    rank_cost_volume,
    rank_transform,
    sad_cost_volume,
    select_disparity,
    sgm_aggregate,
)
from stereo_tpu_torch.ops.cuda import (
    alu_peak,
    census_cost,
    launch_counts,
    launch_forms,
    median3x3,
    rank_cost,
    reset_launch_counts,
    sad_cost,
    sgm_paths,
    sgm_select,
    transform_words,
)
from stereo_tpu_torch.ops.census import (
    census_transform_plain,
    rank_transform_plain,
)
from stereo_tpu_torch.ops.cuda.build import load_kernels
from stereo_tpu_torch.ops.postprocess import spill_width
from stereo_tpu_torch.ops.cuda.peak_kernel import PROGRAMS, alu_peak_plain
from stereo_tpu_torch.parallel import (
    build_banded_pipeline,
    build_halo_pipeline,
    make_tile_mesh,
)
from stereo_tpu_torch.pipeline import (
    compute_disparity,
    compute_patch_parts,
    rect_mask,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, h, w, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, size=(h, w), dtype=np.uint8)
                             ).to(dev) for _ in range(2)]


def _words(left, right, window, rank=False):
    """K1's transform stage on both images."""
    return [transform_words(img, window, rank=rank) for img in (left, right)]


@pytest.mark.parametrize("window", [(9, 7), (5, 5), (3, 5), (7, 9)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.int32])
@pytest.mark.parametrize("h, w", [(13, 21), (3, 2), (1, 30), (2, 1),
                                  (70, 301), (375, 1242)])
def test_transform_kernel(dev, window, dtype, h, w):
    # Frames narrower or shorter than the window (every neighbour then
    # replicates an edge pixel) and ragged 32 x 8 blocks; float32 values
    # with fractional parts truncate toward zero.
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, size=(h, w)).astype(np.float32)
    if dtype == torch.float32:
        img += rng.random((h, w)).astype(np.float32)
    img = torch.from_numpy(img).to(dtype).to(dev)
    reset_launch_counts()
    words = transform_words(img, window)
    rank = transform_words(img, window, rank=True)
    torch.cuda.synchronize()
    assert launch_counts()["transform_words"] == 2
    want = census_transform_plain(img, window)
    assert words.dtype == torch.int32 and words.shape == want.shape
    assert torch.equal(words.to(torch.int64) & 0xFFFFFFFF, want)
    assert torch.equal(census_transform(img, window), want)
    assert torch.equal(rank, rank_transform_plain(img, window))
    assert torch.equal(rank_transform(img, window), rank)
    # uint8 and float32 images of the same integers give the same bits
    assert torch.equal(transform_words(img.to(torch.uint8), window),
                       transform_words(img.to(torch.float32).floor(), window))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_transform_kernel_takes_views_off_alignment(dev, dtype):
    """Frame 1 of a stacked batch of 375 x 1242 uint8 frames starts off a
    16-byte boundary, and a column slice is not contiguous: the wrapper
    copies such an image once and launches on the copy, so whole-frame
    paths take ``batch[i]`` as it is."""
    rng = np.random.default_rng(7)
    batch = torch.from_numpy(rng.integers(0, 256, size=(3, 375, 1242))
                             ).to(dtype).to(dev)
    frame = batch[1]
    if dtype == torch.uint8:
        assert frame.data_ptr() % 16
    for img in (frame, batch[2, :, 3:200]):
        reset_launch_counts()
        got = transform_words(img, (9, 7))
        assert launch_counts()["transform_words"] == 1
        assert torch.equal(got, transform_words(img.clone(), (9, 7)))
    pipe = build_pipeline(KITTI_SGM8_128.replace(num_disparities=32), dev)
    left, right = batch[1].to(torch.uint8), batch[2].to(torch.uint8)
    got = pipe(left, right)
    want = pipe(left.clone(), right.clone())
    assert torch.equal(got.disp, want.disp)
    assert torch.equal(got.valid, want.valid)


def test_transform_kernel_rejects(dev):
    img = torch.zeros((4, 5), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="64 bits"):
        transform_words(img, (9, 9))
    with pytest.raises(ValueError, match="odd"):
        transform_words(img, (3, 4), rank=True)
    # any odd window for rank, and other image types through int32
    assert torch.equal(transform_words(img.to(torch.int16), (9, 9), rank=True),
                       torch.zeros((4, 5), dtype=torch.int32, device=dev))


@pytest.mark.parametrize(
    "d, md, window, h, w",
    [(32, 0, (5, 5), 7, 130), (64, 3, (9, 7), 9, 257),
     (128, 0, (9, 7), 16, 300), (256, 5, (7, 7), 5, 400),
     (16, 0, (5, 5), 47, 155), (64, 0, (9, 7), 47, 155), (1, 0, (9, 7), 5, 131),
     (33, 2, (5, 5), 6, 140), (255, 1, (9, 7), 3, 260),
     (40, 1, (3, 5), 8, 129), (200, 0, (9, 7), 4, 333),
     (256, 0, (9, 7), 3, 520), (128, 2, (5, 5), 5, 127), (16, 3, (7, 9), 3, 17)],
)
def test_census_cost_kernel(dev, d, md, window, h, w):
    cfg = StereoConfig(census_window=window, num_disparities=d,
                       min_disparity=md)
    left, right = _images(d, h, w, dev)
    got = census_cost(*_words(left, right, window), cfg)
    torch.cuda.synchronize()
    want = census_cost_volume(left, right, cfg)
    assert got.dtype == torch.int8
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize(
    "d, md, window, h, w",
    [(128, 0, (9, 7), 16, 300), (16, 0, (5, 5), 47, 155),
     (64, 3, (9, 7), 47, 155), (1, 0, (3, 3), 5, 131), (33, 2, (9, 7), 6, 140),
     (200, 0, (9, 7), 4, 333), (256, 3, (7, 9), 3, 300),
     (40, 0, (5, 9), 5, 140)],
)
def test_rank_cost_kernel(dev, d, md, window, h, w):
    cfg = StereoConfig(cost_fn="rank", census_window=window,
                       num_disparities=d, min_disparity=md)
    left, right = _images(d, h, w, dev)
    got = rank_cost(*_words(left, right, window, rank=True), cfg)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8
    assert torch.equal(got.to(torch.int32), rank_cost_volume(left, right, cfg))


#: K2's ring holds 16 pixels of a scanline (csrc/sgm_paths.cu): frames
#: whose rows, columns and diagonals are 1, 15, 16, 17 and 35 = 2 * 16 + 3
#: pixels long, wider than high and higher than wide.
_TAILS = [(1, 1, 35), (40, 35, 1), (128, 15, 17), (200, 16, 35),
          (256, 17, 16), (16, 35, 15), (128, 1, 1), (40, 2, 37)]


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("d, h, w", [(32, 13, 29), (128, 21, 140),
                                     (256, 6, 300), (96, 40, 7),
                                     (16, 47, 155), (64, 47, 155),
                                     (1, 9, 12), (33, 11, 37), (100, 7, 45),
                                     (250, 5, 33), *_TAILS])
def test_sgm_paths_kernel(dev, paths, d, h, w):
    cfg = StereoConfig(census_window=(9, 7), num_disparities=d,
                       num_paths=paths, p1=14, p2=120)
    rng = np.random.default_rng(paths + d)
    cost = torch.from_numpy(rng.integers(0, 63, size=(h, w, d),
                                         dtype=np.int8)).to(dev)
    got = sgm_paths(cost, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, sgm_aggregate(cost, cfg).to(torch.int16))


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("d, h, w", [(128, 21, 140), (16, 47, 155),
                                     (33, 11, 37), (256, 17, 35),
                                     (200, 15, 16), (40, 35, 1), (1, 16, 17),
                                     (128, 2, 37)])
def test_sgm_paths_int16_cost_kernel(dev, paths, d, h, w):
    # SAD costs reach 255: int16 in, and 8 * (255 + 120) < 2^15.
    cfg = StereoConfig(cost_fn="sad", num_disparities=d, num_paths=paths,
                       p1=14, p2=120)
    rng = np.random.default_rng(paths + d)
    cost = torch.from_numpy(rng.integers(0, 256, size=(h, w, d),
                                         dtype=np.int16)).to(dev)
    got = sgm_paths(cost, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, sgm_aggregate(cost, cfg).to(torch.int16))


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(min_disparity=3),
        dict(subpixel=False, uniqueness_ratio=0.0),
        dict(lr_check=False),
        dict(lr_tau=0.0, uniqueness_ratio=0.1),
    ],
)
@pytest.mark.parametrize("levels", [5, 1400])
def test_sgm_select_kernel(dev, kw, levels):
    cfg = KITTI_SGM8_128.replace(num_disparities=64, **kw)
    rng = np.random.default_rng(levels)
    s = torch.from_numpy(rng.integers(0, levels, size=(11, 150, 64),
                                      dtype=np.int16)).to(dev)
    disp, valid = sgm_select(s, cfg)
    torch.cuda.synchronize()
    want_disp, want_valid = select_disparity(s, cfg)
    assert torch.equal(valid, want_valid)
    assert torch.equal(disp, want_disp)


@pytest.mark.parametrize("h, w", [(1, 1), (1, 9), (9, 1), (3, 2), (37, 150),
                                  (17, 130), (33, 131), (375, 1242),
                                  (1988, 2880)])
def test_median3x3_kernel(dev, h, w):
    # 1 x 1, 1 x N, N x 1, widths that are not a multiple of 4 (scalar
    # staging and stores), ragged tiles, KITTI and config 4's frame.
    rng = np.random.default_rng(h)
    disp = torch.from_numpy((rng.integers(0, 512, size=(h, w)) / 4).astype(
        np.float32)).to(dev)
    got = median3x3(disp)
    torch.cuda.synchronize()
    assert torch.equal(got, median_3x3(disp))


@pytest.mark.parametrize("values", [(-0.0, 0.0), (-0.0, 0.0, 1.5),
                                    (0.25, 0.5)])
@pytest.mark.parametrize("h, w", [(7, 9), (40, 260), (21, 131)])
def test_median3x3_kernel_ties_and_zeros(dev, values, h, w):
    # Two or three values make ties in every window, and -0.0 next to
    # +0.0 in most: the kernel's selection must leave the bits the plain
    # network leaves (compared as int32 words, so a zero's sign counts).
    rng = np.random.default_rng(len(values) * h)
    vals = np.array(values, np.float32)
    disp = torch.from_numpy(vals[rng.integers(0, len(vals), size=(h, w))]
                            ).to(dev)
    got = median3x3(disp)
    torch.cuda.synchronize()
    want = median_3x3(disp)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_pipeline_runs_the_kernels(dev):
    pair = make_pair((48, 160), max_disp=20)
    cfg = KITTI_SGM8_128.replace(num_disparities=32)
    reset_launch_counts()
    got = build_pipeline(cfg, dev)(pair.left, pair.right)
    torch.cuda.synchronize()
    assert launch_counts() == {"transform_words": 2, "census_cost": 1,
                               "rank_cost": 0, "sad_cost": 0, "sgm_paths": 8,
                               "sgm_select": 1, "median3x3": 1,
                               "alu_peak": 0}
    # by form: the shape and what picks the kernel's instantiation or path
    assert launch_forms() == {
        ("transform_words", 48, 160, 9, 7, False, "torch.uint8"): 2,
        ("census_cost", 48, 160, 32, 2, False): 1,
        ("sgm_paths", 48, 160, 32, "torch.int8", 8, False, False): 8,
        ("sgm_select", 48, 160, 32, 0, True, True, True, False, False,
         False): 1,
        ("median3x3", 48, 160): 1,
    }
    want = build_pipeline(cfg.replace(backend="torch"), dev)(
        pair.left, pair.right)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.disp, want.disp)


@pytest.mark.parametrize(
    "paths, floor, p2_min", [(4, 0, 30), (8, 12, 30), (8, 3, 200)]
)
@pytest.mark.parametrize("d, h, w", [(32, 13, 29), (128, 21, 140),
                                     (64, 40, 7), (16, 47, 155), (33, 11, 37),
                                     (16, 1, 35), (40, 35, 16), (128, 17, 35),
                                     (256, 15, 17), (200, 16, 15)])
def test_sgm_paths_adaptive_kernel(dev, paths, floor, p2_min, d, h, w):
    # Every direction of 8 paths on ragged shapes; p2_min=200 > p2.
    cfg = StereoConfig(num_disparities=d, num_paths=paths, p1=14, p2=120,
                       adaptive_p2=True, adaptive_grad_floor=floor,
                       p2_min=p2_min)
    rng = np.random.default_rng(paths + d + floor)
    cost = torch.from_numpy(rng.integers(0, 63, size=(h, w, d),
                                         dtype=np.int8)).to(dev)
    image = torch.from_numpy((rng.integers(0, 4, size=(h, w)) * 20
                              + rng.integers(0, 8, size=(h, w))
                              ).astype(np.uint8)).to(dev)
    got = sgm_paths(cost, cfg, image=image)
    torch.cuda.synchronize()
    want = sgm_aggregate(cost, cfg, image=image).to(torch.int16)
    assert torch.equal(got, want)
    assert not torch.equal(got, sgm_paths(cost, cfg.replace(
        adaptive_p2=False)))


@pytest.mark.parametrize("kw", [dict(), dict(min_disparity=3),
                                dict(subpixel=False, uniqueness_ratio=0.1)])
def test_sgm_select_d0_kernel(dev, kw):
    cfg = KITTI_SGM8_128.replace(num_disparities=128, lr_exact=True, **kw)
    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.integers(0, 300, size=(9, 170, 128),
                                      dtype=np.int16)).to(dev)
    got = sgm_select(s, cfg, emit_d0=True)
    torch.cuda.synchronize()
    want = select_disparity(s, cfg, emit_d0=True)
    assert got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", [1, 16, 40])
@pytest.mark.parametrize(
    "kw", [dict(), dict(subpixel=True, min_disparity=2, uniqueness_ratio=0.05),
           dict(lr_check=False)],
)
def test_sgm_select_partial_disparities(dev, d, kw):
    # tsukuba_sad16's D=16 and other counts below a multiple of 32.
    cfg = TSUKUBA_SAD16.replace(num_disparities=d, **kw)
    rng = np.random.default_rng(d)
    s = torch.from_numpy(rng.integers(0, 40, size=(12, 75, d),
                                      dtype=np.int16)).to(dev)
    disp, valid = sgm_select(s, cfg)
    torch.cuda.synchronize()
    want_disp, want_valid = select_disparity(s, cfg)
    assert torch.equal(valid, want_valid)
    assert torch.equal(disp, want_disp)


@pytest.mark.parametrize("d", [1, 16, 33])
@pytest.mark.parametrize("kw", [dict(), dict(subpixel=False,
                                             uniqueness_ratio=0.0)])
def test_sgm_select_negative_origin(dev, d, kw):
    # The pyramid's residual pass: min_disparity = -R/2, cheap LR off.
    cfg = KITTI_SGM8_128.replace(num_disparities=d, min_disparity=-8,
                                 lr_check=False, **kw)
    rng = np.random.default_rng(d)
    s = torch.from_numpy(rng.integers(0, 300, size=(47, 155, d),
                                      dtype=np.int16)).to(dev)
    disp, valid = sgm_select(s, cfg)
    torch.cuda.synchronize()
    want_disp, want_valid = select_disparity(s, cfg)
    assert torch.equal(valid, want_valid)
    assert torch.equal(disp, want_disp)
    assert float(disp.min()) < 0
    with pytest.raises(ValueError, match="cheap LR"):
        sgm_select(s, cfg.replace(lr_check=True))


@pytest.mark.parametrize("d", [1, 16, 48, 64, 128, 256])
@pytest.mark.parametrize("md", [0, 3])
@pytest.mark.parametrize("window, h, w", [
    ((9, 9), 19, 70), ((5, 7), 6, 33), ((1, 1), 5, 37), ((17, 17), 40, 300),
    ((9, 9), 4, 200), ((17, 17), 21, 9)])
def test_sad_cost_kernel(dev, d, md, window, h, w):
    # Frames that fill no whole tile (tiles are 64 or 32 columns by 4-16
    # rows), H below the window, W below the window and below D.
    cfg = TSUKUBA_SAD16.replace(num_disparities=d, min_disparity=md,
                                sad_window=window)
    left, right = _images(d + md, h, w, dev)
    got = sad_cost(left, right, cfg)
    torch.cuda.synchronize()
    assert got.dtype == torch.int16 and got.shape == (h, w, d)
    assert torch.equal(got.to(torch.int32), sad_cost_volume(left, right, cfg))


def _sad_pair(kind, dtype, h, w, ctx, dev):
    """A SAD pair: right ``ctx`` columns wider; ``kind`` "zeros", "extremes"
    (0 and 255 at random: the largest sums of a uint8 pair, and the most
    the other types' checks admit, +-65535) or "random"."""
    rng = np.random.default_rng(w + ctx)
    top = 255 if dtype == torch.uint8 else 65535
    bottom = 0 if dtype == torch.uint8 else -top
    out = []
    for n in (w, w + ctx):
        if kind == "zeros":
            a = np.zeros((h, n))
        elif kind == "extremes":
            a = np.where(rng.random((h, n)) < 0.5, bottom, top)
        elif dtype == torch.float32:
            a = rng.uniform(bottom, top, size=(h, n))
        else:
            a = rng.integers(bottom, top + 1, size=(h, n))
        out.append(torch.from_numpy(a).to(dtype).to(dev))
    return out


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.float32])
@pytest.mark.parametrize("kind", ["zeros", "extremes", "random"])
@pytest.mark.parametrize("d, window, md, x_offset, ctx", [
    (16, (9, 9), 0, 0, 0), (128, (17, 17), 3, 40, 17),
    (48, (5, 7), 2, 300, 255), (256, (9, 9), 0, 24, 24)])
def test_sad_cost_kernel_image_types(dev, dtype, kind, d, window, md,
                                     x_offset, ctx):
    # K5 reads the images in their own type (float32 truncated toward
    # zero); costs above the int16 range wrap as the wrapper's int16 cast
    # of the plain volume does.
    cfg = TSUKUBA_SAD16.replace(num_disparities=d, min_disparity=md,
                                sad_window=window)
    left, right = _sad_pair(kind, dtype, 23, 141, ctx, dev)
    reset_launch_counts()
    got = sad_cost(left, right, cfg, x_offset, ctx)
    torch.cuda.synchronize()
    assert launch_forms() == {("sad_cost", 23, 141, d, *window,
                               x_offset > 0, ctx > 0, str(dtype)): 1}
    want = sad_cost_volume(left, right, cfg, x_offset, ctx)
    assert torch.equal(got, want.to(torch.int16))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_sad_cost_kernel_row_view(dev, dtype):
    # A band of rows of a larger image is a contiguous view that starts
    # anywhere (row 3 of a 141-column uint8 image is 423 bytes in): K5
    # reads it in place.
    left, right = (img.to(dtype) for img in _images(5, 23, 141, dev))
    cfg = TSUKUBA_SAD16.replace(num_disparities=48, sad_window=(5, 7))
    lv, rv = left[3:], right[3:]
    assert lv.is_contiguous() and lv.data_ptr() % 16
    got = sad_cost(lv, rv, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got.to(torch.int32), sad_cost_volume(lv, rv, cfg))


def test_profiled_ms_times_a_kernel(dev):
    # chip_smoke.py's device_ms and profile_paths.py --forms: the kernel's
    # device time per launch, and nothing else launched by the call.
    disp = torch.rand((375, 1242), device=dev) * 64
    ms, other_ms, other = roofline.profiled_ms(lambda: median3x3(disp),
                                               "median3x3_kernel")
    assert 0 < ms < 1 and other_ms == 0 and other == 0


def test_sad_cost_kernel_rejects(dev):
    left, right = _images(0, 8, 40, dev)
    with pytest.raises(ValueError, match="17x17"):
        sad_cost(left, right, TSUKUBA_SAD16.replace(sad_window=(19, 3)))
    big = left.to(torch.int32) * 300
    with pytest.raises(ValueError, match="65535"):
        sad_cost(big, right.to(torch.int32), TSUKUBA_SAD16)
    nan = left.to(torch.float32)
    nan[3, 4] = float("nan")
    with pytest.raises(ValueError, match="65535"):
        sad_cost(nan, right.to(torch.float32), TSUKUBA_SAD16)


@pytest.mark.parametrize(
    "cfg, counts",
    [
        (KITTI_SGM8_128.replace(num_disparities=32, num_paths=0),
         dict(transform_words=2, census_cost=1, sgm_select=1, median3x3=1)),
        (KITTI_SGM8_128_QUALITY.replace(num_disparities=32),
         dict(transform_words=2, census_cost=1, sgm_paths=8, sgm_select=1,
              median3x3=1)),
        (KITTI_SGM8_128.replace(num_disparities=32, lr_exact=True),
         dict(transform_words=4, census_cost=2, sgm_paths=16, sgm_select=2,
              median3x3=1)),
        (KITTI_SGM8_128_QUALITY.replace(num_disparities=32, lr_exact=True),
         dict(transform_words=4, census_cost=2, sgm_paths=16, sgm_select=2,
              median3x3=1)),
        (TSUKUBA_SAD16, dict(sad_cost=1, sgm_select=1, median3x3=1)),
        (MIDDLEBURY_CENSUS_SGM4_64,
         dict(transform_words=2, census_cost=1, sgm_paths=4, sgm_select=1,
              median3x3=1)),
        (KITTI_SGM8_128.replace(num_disparities=48, cost_fn="rank"),
         dict(transform_words=2, rank_cost=1, sgm_paths=8, sgm_select=1,
              median3x3=1)),
        (KITTI_SGM8_128.replace(num_disparities=16),
         dict(transform_words=2, census_cost=1, sgm_paths=8, sgm_select=1,
              median3x3=1)),
        (KITTI_SGM8_128.replace(num_disparities=32, cost_fn="sad"),
         dict(sad_cost=1, sgm_paths=8, sgm_select=1, median3x3=1)),
    ],
    ids=["paths0", "quality", "lr_exact", "quality_lr_exact", "tsukuba",
         "middlebury", "rank_d48", "d16", "sad_sgm"],
)
def test_slice_paths_run_the_kernels(dev, cfg, counts):
    pair = make_pair((48, 160), max_disp=14, texture="cloud", seed=5)
    reset_launch_counts()
    got = build_pipeline(cfg, dev)(pair.left, pair.right)
    torch.cuda.synchronize()
    want_counts = dict.fromkeys(launch_counts(), 0)
    want_counts.update(counts)
    assert launch_counts() == want_counts
    want = build_pipeline(cfg.replace(backend="torch"), dev)(
        pair.left, pair.right)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.disp, want.disp)


@pytest.mark.parametrize("shape", [(96, 160), (75, 121)])
@pytest.mark.parametrize(
    "cfg, mkw",
    [(KITTI_SGM8_128.replace(num_disparities=32), dict()),
     (KITTI_SGM8_128.replace(num_disparities=32),
      dict(census_window=(5, 5))),
     (KITTI_SGM8_128_QUALITY.replace(num_disparities=32),
      dict(census_window=(5, 5), residual_range=8))],
    ids=["9x7", "5x5", "quality_r8"],
)
def test_pyramid_model_runs_the_kernels(dev, shape, cfg, mkw):
    # Coarse pass K1 (two transforms) K2x8 K3 K4, residual pass: two
    # transforms, K2x8 (D = R, md = -R/2) K3 K4.
    pair = make_pair(shape, max_disp=24, texture="cloud", seed=1)
    reset_launch_counts()
    got = get_model("pyramid", cfg=cfg, **mkw).build(dev)(pair.left,
                                                          pair.right)
    torch.cuda.synchronize()
    want_counts = dict.fromkeys(launch_counts(), 0)
    want_counts.update(transform_words=4, census_cost=1, sgm_paths=16,
                       sgm_select=2, median3x3=2)
    assert launch_counts() == want_counts
    want = get_model("pyramid", cfg=cfg.replace(backend="torch"),
                     **mkw).build(dev)(pair.left, pair.right)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.disp, want.disp)


def test_block_matching_model_runs_the_kernels(dev):
    pair = make_pair((48, 160), max_disp=14, texture="cloud", seed=5)
    reset_launch_counts()
    model = get_model("block_matching")
    got = model.build(dev)(pair.left, pair.right)
    torch.cuda.synchronize()
    want_counts = dict.fromkeys(launch_counts(), 0)
    want_counts.update(sad_cost=1, sgm_select=1, median3x3=1)
    assert launch_counts() == want_counts
    want = build_pipeline(model.cfg.replace(backend="torch"), dev)(
        pair.left, pair.right)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.disp, want.disp)


def test_kernels_reject_unsupported_disparities(dev):
    cfg = StereoConfig(num_disparities=288)
    cost = torch.zeros((4, 8, 288), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match=r"\[1, 256\]"):
        sgm_paths(cost, cfg)
    with pytest.raises(TypeError, match="int8 or int16"):
        sgm_paths(cost[:, :, :32].contiguous().to(torch.int32),
                  cfg.replace(num_disparities=32))


# --- column patches: origins, context, the emit_qr form; D = 256; K6 --------

_ORIGINS = [(0, 24, 0), (2, 24, 17), (3, 7, 7), (0, 300, 255), (5, 130, 0)]


@pytest.mark.parametrize("md, x_offset, ctx", _ORIGINS)
@pytest.mark.parametrize("d, window, h, w", [(16, (5, 5), 9, 150),
                                             (128, (9, 7), 7, 257),
                                             (256, (9, 7), 5, 300),
                                             (33, (7, 7), 6, 131)])
def test_census_cost_kernel_origins(dev, d, window, h, w, md, x_offset, ctx):
    cfg = StereoConfig(census_window=window, num_disparities=d,
                       min_disparity=md)
    left = _images(d + ctx, h, w, dev)[0]
    right = _images(d + md, h, w + ctx, dev)[0]
    got = census_cost(*_words(left, right, window), cfg, x_offset, ctx)
    torch.cuda.synchronize()
    want = census_cost_volume(left, right, cfg, x_offset, ctx)
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("md, x_offset, ctx", _ORIGINS)
def test_rank_cost_kernel_origins(dev, md, x_offset, ctx):
    cfg = StereoConfig(cost_fn="rank", census_window=(9, 7),
                       num_disparities=64, min_disparity=md)
    left = _images(ctx, 9, 140, dev)[0]
    right = _images(md, 9, 140 + ctx, dev)[0]
    got = rank_cost(*_words(left, right, (9, 7), rank=True), cfg, x_offset,
                    ctx)
    torch.cuda.synchronize()
    assert torch.equal(got.to(torch.int32),
                       rank_cost_volume(left, right, cfg, x_offset, ctx))


@pytest.mark.parametrize("md, x_offset", [(0, 24), (3, 7), (2, 300)])
@pytest.mark.parametrize("d", [16, 128])
def test_sad_cost_kernel_origin(dev, d, md, x_offset):
    cfg = TSUKUBA_SAD16.replace(num_disparities=d, min_disparity=md,
                                sad_window=(5, 7))
    left, right = _images(d + md, 11, 70, dev)
    got = sad_cost(left, right, cfg, x_offset)
    torch.cuda.synchronize()
    assert torch.equal(got.to(torch.int32),
                       sad_cost_volume(left, right, cfg, x_offset))


@pytest.mark.parametrize("md, x_offset, ctx", [(0, 24, 24), (3, 40, 17),
                                               (2, 300, 255), (0, 0, 5)])
@pytest.mark.parametrize("d", [16, 128])
def test_sad_cost_kernel_right_context(dev, d, md, x_offset, ctx):
    # The right image carries ctx frame-true columns before the block.
    cfg = TSUKUBA_SAD16.replace(num_disparities=d, min_disparity=md,
                                sad_window=(5, 7))
    left = _images(d + md, 11, 70, dev)[0]
    right = _images(ctx, 11, 70 + ctx, dev)[1]
    reset_launch_counts()
    got = sad_cost(left, right, cfg, x_offset, ctx)
    torch.cuda.synchronize()
    assert launch_forms() == {
        ("sad_cost", 11, 70, d, 5, 7, x_offset > 0, True, "torch.uint8"): 1}
    assert torch.equal(got.to(torch.int32),
                       sad_cost_volume(left, right, cfg, x_offset, ctx))


def test_sad_patch_with_context_runs_the_kernels(dev):
    # A SAD column patch with right context through both entry points:
    # K5 takes the context, as the plain path does.
    pair = make_pair((32, 320), max_disp=12, kind="shapes", seed=4)
    cfg = KITTI_SGM8_128.replace(cost_fn="sad", num_disparities=16)
    f0, f1, ctx = 142, 250, 15
    left = torch.from_numpy(pair.left[:, f0:f1].copy()).to(dev)
    right = torch.from_numpy(pair.right[:, f0 - ctx:f1].copy()).to(dev)
    call = dict(x_offset=f0, image_width=320, right_context=ctx)
    plain = cfg.replace(backend="torch")
    reset_launch_counts()
    got = compute_disparity(left, right, cfg, **call)
    parts = compute_patch_parts(left, right, cfg, own=(18, 98), **call)
    torch.cuda.synchronize()
    assert launch_counts()["sad_cost"] == 2
    assert launch_forms()[("sad_cost", 32, 108, 16, *cfg.sad_window, True,
                           True, "torch.uint8")] == 2
    want = compute_disparity(left, right, plain, **call)
    assert torch.equal(got.disp, want.disp)
    assert torch.equal(got.valid, want.valid)
    want_parts = compute_patch_parts(left, right, plain, own=(18, 98), **call)
    for name in parts._fields:
        assert torch.equal(getattr(parts, name), getattr(want_parts, name)), name


def _sums(seed, h, w, d, levels, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, levels, size=(h, w, d),
                                         dtype=np.int16)).to(dev)


@pytest.mark.parametrize("x_offset, iw", [(0, 150), (24, 400), (0, 400),
                                          (250, 400), (60, 215)])
@pytest.mark.parametrize("d, md", [(64, 0), (64, 3), (16, 2), (40, 0),
                                   (256, 1)])
@pytest.mark.parametrize("levels", [5, 1400])
def test_sgm_select_kernel_framed(dev, d, md, x_offset, iw, levels):
    # Blocks that start and end inside the frame, at its edges, and one
    # that ends a few columns before the edge (a partial right clamp).
    w = 150
    cfg = KITTI_SGM8_128.replace(num_disparities=d, min_disparity=md)
    s = _sums(levels + d, 7, w, d, levels, dev)
    got = sgm_select(s, cfg, x_offset=x_offset, image_width=iw)
    torch.cuda.synchronize()
    want = select_disparity(s, cfg, x_offset=x_offset, image_width=iw)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("own", [None, (16, 100), (8, 120), (0, 144),
                                 (30, 30)])
@pytest.mark.parametrize("x_offset, iw", [(0, None), (60, 400), (256, 400)])
@pytest.mark.parametrize("d, md, kw", [
    (16, 0, dict()), (16, 3, dict(uniqueness_ratio=0.05)), (16, 2, dict()),
    (64, 0, dict(subpixel=False)), (100, 5, dict()), (1, 0, dict()),
    (128, 1, dict(lr_tau=0.0)),
])
@pytest.mark.parametrize("levels", [5, 900])
def test_sgm_select_kernel_emit_qr(dev, d, md, kw, x_offset, iw, own, levels):
    w = 144
    cfg = KITTI_SGM8_128.replace(num_disparities=d, min_disparity=md, **kw)
    s = _sums(levels + d + md, 6, w, d, levels, dev)
    got = sgm_select(s, cfg, x_offset=x_offset, image_width=iw, emit_qr=True,
                     own=own)
    torch.cuda.synchronize()
    want = select_disparity(s, cfg, x_offset=x_offset, image_width=iw,
                            emit_qr=True, own=own)
    assert [g.dtype for g in got] == [w_.dtype for w_ in want]
    for name, g, w_ in zip(("disp", "ok_nolr", "lr_bit", "d0", "qr", "spill"),
                           got, want):
        assert torch.equal(g, w_), name
    assert bool((got[4] >= 3e38).any()) or own in (None, (0, 144))


def _tied_sums(seed, h, w, d, levels, dev):
    """S with many ties: ``levels`` values (1: constant), or with
    ``levels`` None a constant 7."""
    if levels is None:
        return torch.full((h, w, d), 7, dtype=torch.int16, device=dev)
    return _sums(seed, h, w, d, levels, dev)


@pytest.mark.parametrize("levels", [1, 2, 5, None])
@pytest.mark.parametrize("d", [1, 16, 40, 64, 128, 200, 256])
@pytest.mark.parametrize(
    "form",
    [dict(), dict(emit_d0=True), dict(x_offset=24, image_width=300),
     dict(emit_qr=True, own=(10, 150)), dict(emit_qr=True, x_offset=60,
                                             image_width=400),
     dict(md=-8)],
    ids=["base", "d0", "framed", "qr", "qr_framed", "md-8"])
def test_sgm_select_kernel_ties(dev, levels, d, form):
    # Every form on S with many ties: the first argmin, the runner-up and
    # the right view's smallest d among equal costs must not depend on the
    # order in which the kernel folds lanes and columns.
    form = dict(form)
    md = form.pop("md", 2)
    kw = dict(min_disparity=md)
    if md < 0:
        kw.update(lr_check=False)
    if form.get("emit_d0"):
        kw.update(lr_exact=True)
    cfg = KITTI_SGM8_128.replace(num_disparities=d, **kw)
    w = max(166, d + md + 1)
    s = _tied_sums(d + (levels or 0), 5, w, d, levels, dev)
    got = sgm_select(s, cfg, **form)
    torch.cuda.synchronize()
    want = select_disparity(s, cfg, **form)
    assert len(got) == len(want)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert torch.equal(g, w_), i


@pytest.mark.parametrize("d, emit_qr", [(1, False), (16, False), (16, True),
                                        (256, False)])
def test_sgm_select_kernel_widest_row(dev, d, emit_qr):
    # The widest row whose keys fit a block's shared memory, and one more.
    cfg = KITTI_SGM8_128.replace(num_disparities=d)
    sp = spill_width(d) if emit_qr else 0
    fits = load_kernels().stpu_sgm_select_fits
    w = 1
    while fits(2 * w, sp):
        w *= 2
    lo, hi = w, 2 * w
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid, sp) else (lo, mid)
    s = _sums(d, 2, lo, d, 50, dev)
    kw = dict(emit_qr=True) if emit_qr else {}
    got = sgm_select(s, cfg, **kw)
    torch.cuda.synchronize()
    for g, w_ in zip(got, select_disparity(s, cfg, **kw)):
        assert torch.equal(g, w_)
    with pytest.raises(ValueError, match="shared memory"):
        sgm_select(_sums(d, 1, hi, d, 50, dev), cfg, **kw)


def test_sgm_select_kernel_rejects(dev):
    s = torch.zeros((4, 40, 16), dtype=torch.int16, device=dev)
    cfg = StereoConfig(num_disparities=16)
    with pytest.raises(ValueError, match="block width"):
        sgm_select(s[:, :12].contiguous(), cfg, emit_qr=True)
    with pytest.raises(ValueError, match="leaves the frame"):
        sgm_select(s, cfg, x_offset=60, image_width=60)
    with pytest.raises(ValueError, match="leaves the frame"):
        sgm_select(s, cfg, x_offset=-40, image_width=60)
    wide = torch.zeros((1, 20000, 1), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        sgm_select(wide, StereoConfig(num_disparities=1))


@pytest.mark.parametrize("h, w", [(9, 700), (40, 333)])
def test_kernels_at_256_disparities(dev, h, w):
    # Config 4's D: 8 disparities per lane, keys up to 2^23.
    cfg = KITTI_SGM8_128.replace(num_disparities=256)
    left, right = _images(h, h, w, dev)
    cost = census_cost(*_words(left, right, cfg.census_window), cfg)
    s = sgm_paths(cost, cfg)
    got = sgm_select(s, cfg)
    torch.cuda.synchronize()
    cost_plain = census_cost_volume(left, right, cfg)
    assert torch.equal(cost.to(torch.int32), cost_plain)
    s_plain = sgm_aggregate(cost_plain, cfg)
    assert torch.equal(s.to(torch.int32), s_plain)
    for g, w_ in zip(got, select_disparity(s_plain, cfg)):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("k, chains", PROGRAMS)
def test_alu_peak_kernel(dev, dtype, k, chains):
    x = (torch.arange(70001, device=dev) % 256).to(dtype)
    if dtype == torch.float32:
        x = x / 4
    reset_launch_counts()
    got = alu_peak(x, k, chains)
    torch.cuda.synchronize()
    assert launch_forms() == {("alu_peak", 70001, str(dtype), k, chains): 1}
    assert torch.equal(got, alu_peak_plain(x, k, chains))
    # saturation: a chain that starts near BIG stays there
    top = torch.full((64,), 3e38 if dtype == torch.float32 else (1 << 30) - 3,
                     dtype=dtype, device=dev)
    assert torch.equal(alu_peak(top, k, chains), alu_peak_plain(top, k, chains))
    with pytest.raises(ValueError, match="one of"):
        alu_peak(x, 100, 4)


@pytest.mark.parametrize(
    "kw, split, counts",
    [
        (dict(), dict(n_bands=2, n_cols=1),
         dict(transform_words=4, census_cost=2, sgm_paths=16, sgm_select=2,
              median3x3=2)),
        (dict(), dict(n_bands=1, n_cols=2),
         dict(transform_words=4, census_cost=2, sgm_paths=16, sgm_select=2,
              median3x3=2)),
        (dict(min_disparity=2), dict(n_bands=2, n_cols=3),
         dict(transform_words=12, census_cost=6, sgm_paths=48, sgm_select=6,
              median3x3=6)),
        (dict(), dict(n_bands=2, n_cols=2, lr_stitch=False),
         dict(transform_words=8, census_cost=4, sgm_paths=32, sgm_select=4,
              median3x3=4)),
        (dict(cost_fn="rank"), dict(n_bands=1, n_cols=2),
         dict(transform_words=4, rank_cost=2, sgm_paths=16, sgm_select=2,
              median3x3=2)),
        (dict(cost_fn="sad"), dict(n_bands=1, n_cols=2),
         dict(sad_cost=2, sgm_paths=16, sgm_select=2, median3x3=2)),
        (dict(lr_exact=True), dict(n_bands=1, n_cols=2),
         dict(transform_words=8, census_cost=4, sgm_paths=32, sgm_select=4,
              median3x3=2)),
    ],
    ids=["bands", "stitched", "stitched_2x3_md2", "legacy_2x2", "rank",
         "sad_legacy", "lr_exact_legacy"],
)
def test_banded_runner_runs_the_kernels(dev, kw, split, counts):
    pair = make_pair((64, 384), max_disp=20, texture="cloud", seed=5)
    cfg = KITTI_SGM8_128.replace(num_disparities=32, **kw)
    reset_launch_counts()
    got = build_banded_pipeline(cfg, (64, 384), device=dev, **split)(
        pair.left, pair.right)
    torch.cuda.synchronize()
    want_counts = dict.fromkeys(launch_counts(), 0)
    want_counts.update(counts)
    assert launch_counts() == want_counts
    stitched = split.get("lr_stitch") is None and split["n_cols"] > 1 and (
        kw.get("cost_fn", "census") != "sad" and not kw.get("lr_exact"))
    assert stitched == any(form[-1] is True for form in launch_forms()
                           if form[0] == "sgm_select")
    want = build_banded_pipeline(cfg.replace(backend="torch"), (64, 384),
                                 device=dev, **split)(pair.left, pair.right)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.disp, want.disp)


def test_patch_parts_run_the_kernels(dev):
    pair = make_pair((32, 320), max_disp=12, kind="shapes", seed=9)
    cfg = StereoConfig(num_disparities=16, num_paths=8)
    f0, f1, ctx = 142, 250, 15
    left = torch.from_numpy(pair.left[:, f0:f1].copy()).to(dev)
    right = torch.from_numpy(pair.right[:, f0 - ctx:f1].copy()).to(dev)
    call = dict(x_offset=f0, image_width=320, right_context=ctx,
                own=(18, 98))
    reset_launch_counts()
    got = compute_patch_parts(left, right, cfg, **call)
    torch.cuda.synchronize()
    window = cfg.census_window
    assert launch_forms() == {
        ("transform_words", 32, 108, *window, False, "torch.uint8"): 1,
        ("transform_words", 32, 123, *window, False, "torch.uint8"): 1,
        ("census_cost", 32, 108, 16, 1, True): 1,
        ("sgm_paths", 32, 108, 16, "torch.int8", 8, False, False): 8,
        ("sgm_select", 32, 108, 16, 0, True, False, True, False, True,
         True): 1,
        ("median3x3", 32, 108): 1,
    }
    want = compute_patch_parts(left, right, cfg.replace(backend="torch"),
                               **call)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    framed = compute_disparity(left, right, cfg, x_offset=f0, image_width=320,
                               right_context=ctx)
    plain = compute_disparity(left, right, cfg.replace(backend="torch"),
                              x_offset=f0, image_width=320, right_context=ctx)
    assert torch.equal(framed.disp, plain.disp)
    assert torch.equal(framed.valid, plain.valid)


# --- tiles: K2's rectangle form, K1, K3 and K5 at negative origins ---------

#: Rectangles in a 37 x 150 block touching none, one and all four edges;
#: an empty one and a single pixel.
_RECTS = {"inside": (5, 30, 20, 131), "top": (0, 30, 20, 131),
          "left": (5, 30, 0, 131), "bottom": (5, 37, 20, 131),
          "right": (5, 30, 20, 150), "all": (0, 37, 0, 150),
          "empty": (12, 12, 40, 40), "pixel": (36, 37, 149, 150)}


@pytest.mark.parametrize("rect", sorted(_RECTS))
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("paths, adaptive, cost_t", [
    (8, False, torch.int8), (4, True, torch.int8), (8, True, torch.int16)])
def test_sgm_paths_rect_form(dev, rect, d, paths, adaptive, cost_t):
    """L = C wherever the predecessor lies outside the rectangle, over the
    whole block; a rectangle that is the whole block is the whole form."""
    h, w = 37, 150
    cfg = StereoConfig(num_disparities=d, num_paths=paths, p1=14, p2=120,
                       adaptive_p2=adaptive, p2_min=30, adaptive_grad_floor=6)
    rng = np.random.default_rng(d + paths)
    top = 64 if cost_t == torch.int8 else 256
    cost = torch.from_numpy(rng.integers(0, top, size=(h, w, d))).to(
        cost_t).to(dev)
    image = _images(d, h, w, dev)[0]
    box = _RECTS[rect]
    reset_launch_counts()
    got = sgm_paths(cost, cfg, image=image, rect=box)
    torch.cuda.synchronize()
    assert launch_forms() == {("sgm_paths", h, w, d, str(cost_t), paths,
                               adaptive, rect != "all"): paths}
    want = sgm_aggregate(cost, cfg, image=image,
                         valid=rect_mask(box, (h, w), dev))
    assert torch.equal(got, want.to(torch.int16))
    if rect == "all":
        assert torch.equal(got, sgm_paths(cost, cfg, image=image))


_NEG = [-1, -20, -(20 + 64)]  # -1, -halo, -(halo + D)


@pytest.mark.parametrize("x_offset", _NEG)
@pytest.mark.parametrize("form", ["framed", "qr", "d0"])
@pytest.mark.parametrize("levels", [5, 900])
def test_sgm_select_tile_origins(dev, x_offset, form, levels):
    """K3's framed, emit_qr and emit_d0 forms at negative origins, blocks
    that also end past the frame on the right."""
    h, w, d = 6, 240, 64
    cfg = KITTI_SGM8_128.replace(num_disparities=d, min_disparity=2)
    kw = dict(x_offset=x_offset, image_width=200)
    if form == "qr":
        kw.update(emit_qr=True, own=(20, 220))
    if form == "d0":
        cfg = cfg.replace(lr_exact=True)
        kw.update(emit_d0=True)
    s = _sums(levels - x_offset, h, w, d, levels, dev)
    reset_launch_counts()
    got = sgm_select(s, cfg, **kw)
    torch.cuda.synchronize()
    (form_key,) = launch_forms()
    assert form_key[-2] == (False if form == "d0" else -1)
    want = select_disparity(s, cfg, **kw)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("x_offset", _NEG)
@pytest.mark.parametrize("ctx", [0, 63])
@pytest.mark.parametrize("cost_fn, d", [("census", 64), ("census", 16),
                                        ("rank", 64)])
def test_cost_kernels_tile_origins(dev, x_offset, ctx, cost_fn, d):
    cfg = StereoConfig(cost_fn=cost_fn, census_window=(9, 7),
                       num_disparities=d, min_disparity=1)
    left = _images(d + ctx, 9, 200, dev)[0]
    right = _images(-x_offset, 9, 200 + ctx, dev)[0]
    rank = cost_fn == "rank"
    kernel = rank_cost if rank else census_cost
    plain = rank_cost_volume if rank else census_cost_volume
    words = _words(left, right, (9, 7), rank=rank)
    reset_launch_counts()
    got = kernel(*words, cfg, x_offset, ctx)
    torch.cuda.synchronize()
    (form_key,) = launch_forms()
    assert form_key[-1] == -1
    assert torch.equal(got.to(torch.int32),
                       plain(left, right, cfg, x_offset, ctx))


@pytest.mark.parametrize("x_offset", _NEG + [-300])
@pytest.mark.parametrize("d, window", [(16, (9, 9)), (64, (5, 7)),
                                       (256, (17, 17))])
def test_sad_cost_kernel_tile_origins(dev, x_offset, d, window):
    cfg = TSUKUBA_SAD16.replace(num_disparities=d, min_disparity=1,
                                sad_window=window)
    left, right = _images(d - x_offset, 23, 400, dev)
    reset_launch_counts()
    got = sad_cost(left, right, cfg, x_offset)
    torch.cuda.synchronize()
    (form_key,) = launch_forms()
    assert form_key[6] == -1
    assert torch.equal(got.to(torch.int32),
                       sad_cost_volume(left, right, cfg, x_offset))


@pytest.mark.parametrize(
    "kw, shape, grid, lr_stitch",
    [(dict(num_disparities=32), (64, 300), (2, 2), None),
     (dict(num_disparities=32), (61, 290), (2, 2), False),
     (dict(num_disparities=32, **dict(adaptive_p2=True, p2_min=30,
                                      adaptive_grad_floor=12)),
      (50, 260), (4, 2), None),
     (dict(num_disparities=32, lr_exact=True), (48, 240), (1, 2), None),
     (dict(cost_fn="sad", num_disparities=16, num_paths=0,
           sad_window=(9, 9)), (40, 200), (1, 2), None),
     (dict(num_disparities=256), (60, 700), (1, 2), None)],
    ids=["stitched", "legacy_ragged", "adaptive_4x2", "lr_exact", "sad",
         "d256_stitched"],
)
def test_local_grid_runs_the_kernels(dev, kw, shape, grid, lr_stitch):
    """The local grid on the card: the kernel path equals the plain
    composition on the same card, and it launched K2's rectangle form and
    the cost kernel at a negative origin."""
    pair = make_pair(shape, max_disp=20, texture="cloud", seed=9)
    cfg = KITTI_SGM8_128.replace(**kw)
    mesh = make_tile_mesh([dev] * (grid[0] * grid[1]), grid)
    reset_launch_counts()
    got = build_halo_pipeline(cfg, mesh, lr_stitch=lr_stitch, device=dev)(
        pair.left, pair.right)
    torch.cuda.synchronize()
    forms = launch_forms()
    cost = "sad_cost" if cfg.cost_fn == "sad" else "census_cost"
    assert any(f[0] == cost and -1 in f[1:] for f in forms)
    if cfg.num_paths:
        assert any(f[0] == "sgm_paths" and f[-1] is True for f in forms)
    want = build_halo_pipeline(cfg.replace(backend="torch"), mesh,
                               lr_stitch=lr_stitch, device=dev)(
        pair.left, pair.right)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.disp, want.disp)


#: Launches per frame of the whole-frame census path, by wrapper.
_FRAME_LAUNCHES = {"transform_words": 2, "census_cost": 1, "sgm_paths": 8,
                   "sgm_select": 1, "median3x3": 1}


@pytest.mark.parametrize("grid, replicas", [((1, 1), 1), ((1, 2), 2)],
                         ids=["whole_frames", "two_replicas_of_1x2"])
def test_stream_runs_the_kernels(dev, grid, replicas):
    """StreamRunner.run_batches on the card: every frame equals the
    per-frame path on the same grid (build_pipeline, or the halo-tiled
    pipeline), and the whole-frame stream launches 13 kernels a frame."""
    from stereo_tpu_torch.parallel import StreamRunner

    cfg = KITTI_SGM8_128.replace(num_disparities=32)
    shape = (41, 150)  # 6150-byte frames: not on 16-byte boundaries
    pairs = [make_pair(shape, max_disp=24, texture="cloud", seed=40 + i)
             for i in range(4)]
    left = torch.from_numpy(np.stack([p.left for p in pairs])).to(dev)
    right = torch.from_numpy(np.stack([p.right for p in pairs])).to(dev)
    mesh = make_tile_mesh([dev] * (replicas * grid[0] * grid[1]), grid,
                          batch=replicas)
    runner = StreamRunner(cfg, mesh, shape, batch_size=4, device=dev)
    outs = []
    reset_launch_counts()
    stats = runner.run_batches([(left, right)], on_result=outs.append)
    counts = launch_counts()
    assert stats["frames"] == 4 and outs[0].frames == range(4)
    if grid == (1, 1):
        assert {k: v for k, v in counts.items() if v} == {
            k: 4 * v for k, v in _FRAME_LAUNCHES.items()}
        frame = build_pipeline(cfg, dev)
    else:
        assert counts["sgm_paths"] == 4 * 2 * 8
        frame = build_halo_pipeline(
            cfg, make_tile_mesh([dev] * (grid[0] * grid[1]), grid),
            device=dev)
    for i, p in enumerate(pairs):
        want = frame(p.left, p.right)
        assert torch.equal(outs[0].disp[i], want.disp)
        assert torch.equal(outs[0].valid[i], want.valid)


def test_run_batches_refuses_host_batches(dev):
    """run_batches on the card takes batches already there, of the
    runner's batch extent and frame shape."""
    from stereo_tpu_torch.parallel import StreamRunner

    runner = StreamRunner(KITTI_SGM8_128.replace(num_disparities=16),
                          make_tile_mesh([dev], (1, 1)), (24, 64),
                          batch_size=2, device=dev)
    host = np.zeros((2, 24, 64), np.uint8)
    with pytest.raises(ValueError, match="already on"):
        runner.run_batches([(host, host)])
    with pytest.raises(ValueError, match="already on"):
        runner.run_batches([(torch.from_numpy(host),) * 2])
    wrong = torch.zeros((2, 24, 60), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError,
                       match=r"stream pipeline built for 24x64 frames, got "
                             r"\(2, 24, 60\)"):
        runner.run_batches([(wrong, wrong)])
    with pytest.raises(ValueError, match="batch extent 1 != runner batch 2"):
        runner.run_batches([(wrong[:1], wrong[:1])])


def test_native_pnm_library_builds(dev, tmp_path):
    """The host library (speckle filter, occlusion fill, PNM/PFM files)
    builds on the card's machine and reads back what it wrote."""
    from stereo_tpu_torch import native

    native.load()
    img = np.arange(35, dtype=np.uint8).reshape(5, 7)
    assert native.write_pnm_gray(str(tmp_path / "a.pgm"), img)
    np.testing.assert_array_equal(native.read_pnm_gray(str(tmp_path /
                                                           "a.pgm")), img)
