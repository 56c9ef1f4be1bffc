"""The port's KITTI and Middlebury loaders and its native PNM/PFM readers
against the reference's, on files the tests write.

Every loader must give the reference loader's arrays bit for bit
(``assert_array_equal``) on the same file: PNG (grayscale, RGB, 16-bit),
binary PGM and PPM through the native reader, an ASCII PGM through PIL,
PFM in both byte orders and with three channels, KITTI uint16 disparity
files, and the scene and stream layouts.
"""

import os

import numpy as np
import pytest
from PIL import Image

from stereo_tpu.data import kitti as j_kitti
from stereo_tpu.data import middlebury as j_mb
from stereo_tpu_torch import native as t_native
from stereo_tpu_torch.data import kitti as t_kitti
from stereo_tpu_torch.data import middlebury as t_mb


def _rng_image(seed, shape, channels=None):
    rng = np.random.default_rng(seed)
    size = shape if channels is None else (*shape, channels)
    return rng.integers(0, 256, size=size).astype(np.uint8)


def _write_ppm(path, rgb, maxval=255):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n# a comment\n{w} {h}\n{maxval}\n".encode())
        f.write(rgb.tobytes())


def _write_ascii_pgm(path, img):
    h, w = img.shape
    with open(path, "w") as f:
        f.write(f"P2\n{w} {h}\n255\n")
        f.write("\n".join(" ".join(str(v) for v in row) for row in img))


def _same_image(path):
    got = t_mb.load_image_gray(str(path))
    want = j_mb.load_image_gray(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("kind", ["png_gray", "png_rgb", "pgm", "ppm",
                                  "ascii_pgm"])
def test_load_image_gray_matches_reference(tmp_path, kind):
    """Each image kind loads to the reference's array; the native reader
    handles the binary PNM files itself."""
    gray = _rng_image(1, (13, 21))
    rgb = _rng_image(2, (13, 21), 3)
    path = tmp_path / {"png_gray": "a.png", "png_rgb": "a.png", "pgm": "a.pgm",
                       "ppm": "a.ppm", "ascii_pgm": "a.pgm"}[kind]
    if kind == "png_gray":
        Image.fromarray(gray).save(path)
    elif kind == "png_rgb":
        Image.fromarray(rgb).save(path)
    elif kind == "pgm":
        assert t_native.write_pnm_gray(str(path), gray)
    elif kind == "ppm":
        _write_ppm(path, rgb)
    else:
        _write_ascii_pgm(path, gray)
    got = _same_image(path)
    if kind in ("pgm", "ascii_pgm", "png_gray"):
        np.testing.assert_array_equal(got, gray)
    native = t_native.read_pnm_gray(str(path))
    if kind in ("pgm", "ppm"):
        np.testing.assert_array_equal(native, got)
    else:
        assert native is None


def test_write_pnm_gray_writes_the_references_bytes(tmp_path):
    img = _rng_image(3, (7, 9))
    assert t_native.write_pnm_gray(str(tmp_path / "t.pgm"), img)
    from stereo_tpu.native import write_pnm_gray as j_write

    assert j_write(str(tmp_path / "j.pgm"), img)
    assert (tmp_path / "t.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()


def _write_pfm_raw(path, data, header, little):
    """A PFM file written by hand: ``data`` [H, W] or [H, W, 3], rows
    bottom to top, in either byte order."""
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(f"{header}\n{w} {h}\n{-1.0 if little else 1.0}\n".encode())
        f.write(np.ascontiguousarray(
            data[::-1].astype("<f4" if little else ">f4")).tobytes())


@pytest.mark.parametrize("form", ["write_pfm", "big_endian", "three_channel"])
def test_read_pfm_matches_reference(tmp_path, form):
    rng = np.random.default_rng(4)
    data = rng.uniform(0, 100, size=(11, 17)).astype(np.float32)
    data[3, 5] = np.inf
    path = str(tmp_path / "d.pfm")
    if form == "write_pfm":
        t_mb.write_pfm(path, data)
        j_mb.write_pfm(str(tmp_path / "j.pfm"), data)
        assert open(path, "rb").read() == open(tmp_path / "j.pfm", "rb").read()
    elif form == "big_endian":
        _write_pfm_raw(path, data, "Pf", little=False)
    else:
        _write_pfm_raw(path, np.stack([data, data + 1, data + 2], -1), "PF",
                       little=True)
    got = t_mb.read_pfm(path)
    np.testing.assert_array_equal(got, j_mb.read_pfm(path))
    np.testing.assert_array_equal(got, data)
    assert (t_native.read_pfm_native(path) is None) == (form == "three_channel")


def test_kitti_disparity_round_trip_matches_reference(tmp_path):
    """write_kitti_disparity writes the reference's file, and
    read_kitti_disparity reads the reference's arrays; an 8-bit PNG is
    refused by both."""
    rng = np.random.default_rng(5)
    disp = rng.uniform(0, 200, size=(9, 14)).astype(np.float32)
    valid = rng.random((9, 14)) > 0.3
    t_kitti.write_kitti_disparity(str(tmp_path / "t.png"), disp, valid)
    j_kitti.write_kitti_disparity(str(tmp_path / "j.png"), disp, valid)
    got = t_kitti.read_kitti_disparity(str(tmp_path / "t.png"))
    want = j_kitti.read_kitti_disparity(str(tmp_path / "j.png"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], valid)
    Image.fromarray(_rng_image(6, (4, 4))).save(tmp_path / "u8.png")
    for mod in (t_kitti, j_kitti):
        with pytest.raises(ValueError, match="expected uint16"):
            mod.read_kitti_disparity(str(tmp_path / "u8.png"))


def _kitti_root(root):
    """Three ids: 000000 and 000002 have _10 and _11 pairs, 000001 only a
    _10 pair and a _11 left frame; 000000 has ground truth."""
    for sub in ("image_2", "image_3", "disp_noc_0"):
        os.makedirs(root / sub)
    seed = 10
    for fid in ("000000", "000001", "000002"):
        for suffix in ("_10", "_11"):
            for sub in ("image_2", "image_3"):
                if fid == "000001" and suffix == "_11" and sub == "image_3":
                    continue
                seed += 1
                Image.fromarray(_rng_image(seed, (6, 10), 3)).save(
                    root / sub / f"{fid}{suffix}.png")
    disp = np.random.default_rng(9).uniform(0, 50, (6, 10)).astype(np.float32)
    j_kitti.write_kitti_disparity(str(root / "disp_noc_0" / "000000_10.png"),
                                  disp, disp > 10)


def test_kitti_loaders_match_reference(tmp_path):
    _kitti_root(tmp_path)
    root = str(tmp_path)
    assert t_kitti.list_frame_ids(root) == j_kitti.list_frame_ids(root) == [
        "000000_10", "000001_10", "000002_10"]
    for fid in ("000000_10", "000001_10"):
        got = t_kitti.load_kitti_pair(root, fid)
        want = j_kitti.load_kitti_pair(root, fid)
        assert got.name == want.name
        for name in ("left", "right", "gt_disp", "gt_valid"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    for limit in (None, 3, 1):
        got = list(t_kitti.frame_pairs(root, limit=limit))
        want = list(j_kitti.frame_pairs(root, limit=limit))
        assert len(got) == len(want) == {None: 5, 3: 3, 1: 1}[limit]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("layout", ["2014", "2003", "tsukuba", "no_gt"])
def test_middlebury_scenes_match_reference(tmp_path, layout):
    """load_scene on each layout, and discover_scenes over the root."""
    scene = tmp_path / ("tsukuba" if layout == "tsukuba" else "scene")
    scene.mkdir()
    left, right = _rng_image(20, (12, 18), 3), _rng_image(21, (12, 18), 3)
    gt = _rng_image(22, (12, 18))
    if layout == "2014":
        Image.fromarray(left).save(scene / "im0.png")
        Image.fromarray(right).save(scene / "im1.png")
        disp = gt.astype(np.float32) / 3
        disp[0, :4] = np.inf
        t_mb.write_pfm(str(scene / "disp0.pfm"), disp)
    elif layout in ("2003", "tsukuba"):
        _write_ppm(scene / "im2.ppm", left)
        _write_ppm(scene / "im6.ppm", right)
        assert t_native.write_pnm_gray(str(scene / "disp2.pgm"), gt)
    else:
        Image.fromarray(left).save(scene / "im2.png")
        Image.fromarray(right).save(scene / "im6.png")
    got = t_mb.load_scene(str(scene))
    want = j_mb.load_scene(str(scene))
    assert got.name == want.name
    for name in ("left", "right", "gt_disp", "gt_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert list(t_mb.discover_scenes(str(tmp_path))) == list(
        j_mb.discover_scenes(str(tmp_path))) == [str(scene)]
    with pytest.raises(FileNotFoundError):
        t_mb.load_scene(str(tmp_path))
