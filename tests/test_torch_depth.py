"""The port's depth, point-cloud and logging helpers against the reference
on the CPU.

``disparity_to_depth`` and ``reproject`` are held bit for bit
(``assert_array_equal``) against ``stereo_tpu.utils.depth`` on the same
numpy disparities: the reference's jnp rounds each Python constant to
float32 before its op and never fuses a multiply and an add, and the port
keeps that order. ``parse_middlebury_calib`` must give the same rig and
``write_ply`` the same bytes.
"""

import logging
import signal

import numpy as np
import pytest
import torch

from stereo_tpu.utils import depth as jdepth
from stereo_tpu_torch.utils import depth as tdepth
from stereo_tpu_torch.utils import log as tlog

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 60


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


#: (focal_px, baseline, doffs, cx, cy): KITTI-like, Middlebury-like with
#: doffs and a principal point off the centre, odd constants that round in
#: float32, and a negative doffs that pushes disparities through eps.
RIGS = {
    "kitti": (721.5377, 0.5327119, 0.0, None, None),
    "middlebury": (3997.684, 193.001, 131.111, 1176.728, 1011.728),
    "odd": (1000.0 / 3.0, 0.1, 0.3, 17.3, -4.7),
    "negative_doffs": (500.0, 0.2, -12.5, 40.1, 2.0),
}


def _disparities(seed, shape=(37, 91)):
    """Random float32 disparities with exact zeros, values at and around
    eps, negatives and large ones; a valid mask with holes."""
    rng = np.random.default_rng(seed)
    d = (rng.random(shape) * 140.0 - 10.0).astype(np.float32)
    flat = d.reshape(-1)
    flat[::17] = 0.0
    flat[1::19] = np.float32(1e-6)
    flat[2::23] = np.nextafter(np.float32(1e-6), np.float32(1))
    flat[3::29] = np.nextafter(np.float32(1e-6), np.float32(0))
    flat[4::31] = 12.5
    valid = rng.random(shape) < 0.85
    return d, valid


@pytest.mark.parametrize("rig", sorted(RIGS))
@pytest.mark.parametrize("eps", [1e-6, 0.5])
def test_disparity_to_depth_matches_reference(rig, eps):
    d, valid = _disparities(len(rig))
    jr, tr = jdepth.CameraRig(*RIGS[rig]), tdepth.CameraRig(*RIGS[rig])
    want = np.asarray(jdepth.disparity_to_depth(d, valid, jr, eps=eps))
    got = tdepth.disparity_to_depth(d, valid, tr, eps=eps, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # A tensor input computes on its own device and gives the same bits.
    again = tdepth.disparity_to_depth(torch.from_numpy(d),
                                      torch.from_numpy(valid), tr, eps=eps)
    np.testing.assert_array_equal(again.numpy(), want)


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_reproject_matches_reference(rig):
    d, valid = _disparities(7 + len(rig))
    jr, tr = jdepth.CameraRig(*RIGS[rig]), tdepth.CameraRig(*RIGS[rig])
    want = np.asarray(jdepth.reproject(d, valid, jr))
    got = tdepth.reproject(torch.from_numpy(d), valid, tr)
    assert got.shape == (37, 91, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_parse_middlebury_calib_and_ply_match_reference(tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "cam0=[3997.684 0 1176.728; 0 3997.684 1011.728; 0 0 1]\n"
        "cam1=[3997.684 0 1307.839; 0 3997.684 1011.728; 0 0 1]\n"
        "doffs=131.111\nbaseline=193.001\nwidth=2964\nheight=1988\n")
    jr = jdepth.parse_middlebury_calib(str(calib))
    tr = tdepth.parse_middlebury_calib(str(calib))
    assert vars(jr) == vars(tr)
    d, valid = _disparities(3)
    d = np.abs(d) + 150.0
    pts_j = np.asarray(jdepth.reproject(d, valid, jr))
    pts_t = tdepth.reproject(d, valid, tr, device="cpu")
    gray = np.random.default_rng(3).integers(0, 256, d.shape).astype(
        np.uint8)
    for colors, max_depth in ((None, None), (gray, 5000.0)):
        nj = jdepth.write_ply(str(tmp_path / "j.ply"), pts_j, valid,
                              colors=colors, max_depth=max_depth)
        nt = tdepth.write_ply(str(tmp_path / "t.ply"), pts_t, valid,
                              colors=colors, max_depth=max_depth)
        assert nj == nt > 0
        assert (tmp_path / "j.ply").read_bytes() == (
            tmp_path / "t.ply").read_bytes()
    bad = tmp_path / "bad.txt"
    bad.write_text("doffs=1\n")
    with pytest.raises(ValueError, match="cam0"):
        tdepth.parse_middlebury_calib(str(bad))


def test_log_setup_is_idempotent_and_reads_the_environment(monkeypatch):
    root = logging.getLogger("stereo_tpu_torch")
    monkeypatch.setattr(tlog, "_CONFIGURED", False)
    before = list(root.handlers)
    try:
        monkeypatch.setenv("STEREO_TPU_LOG", "WARNING")
        tlog.setup()
        assert root.level == logging.WARNING
        tlog.setup("DEBUG")
        tlog.setup()
        assert root.level == logging.WARNING
        assert len(root.handlers) == len(before) + 1
        assert tlog.get_logger("cli").name == "stereo_tpu_torch.cli"
    finally:
        for h in root.handlers[len(before):]:
            root.removeHandler(h)
        root.setLevel(logging.NOTSET)
