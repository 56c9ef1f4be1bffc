"""The banded run of the reference's golden ops (``torch_golden_bands``)
against the reference's whole golden call, at small sizes.

``golden_banded`` makes the whole config-4 frame's fixture at 1988x2880,
where the reference's ``compute_disparity(backend="jnp")`` does not fit in
a CPU's memory. Here both run on the same seeded pairs, with
``assert_array_equal`` on ``disp`` and ``valid`` (tolerance none: every
value is an integer below 2^24 and the float steps are single IEEE
operations): config 4's fields at D=256 in row bands of 1, 2 and 5 (a
band of one row and bands narrower than the census window's halo) and 1
or 3 column bands, the KITTI presets (8 paths, fixed and adaptive P2) and
the 4-path Middlebury preset. One case holds the port's CPU path to the
harness too.
"""

import functools
import signal

import numpy as np
import pytest
import torch

from stereo_tpu.config import PRESETS
from stereo_tpu.data import make_pair
from stereo_tpu.pipeline.pipeline import build_pipeline
from stereo_tpu_torch import PRESETS as TPRESETS
from stereo_tpu_torch.pipeline import compute_disparity as t_compute
from torch_golden_bands import _bounds, default_bands, golden_banded

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 120

#: preset -> (shape, max_disp of the pair).
FRAMES = {
    "middlebury_full_256_tiled": ((48, 320), 48),
    "kitti_sgm8_128": ((40, 200), 24),
    "kitti_sgm8_128_quality": ((40, 200), 24),
    "middlebury_census_sgm4_64": ((40, 160), 24),
}

#: Config 4's five row bands: one row at each edge of the frame and a band
#: of three rows, narrower than the (9, 7) window's four halo rows.
_CFG4_ROWS = (1, 3, 20, 23, 1)


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _pair(preset):
    shape, max_disp = FRAMES[preset]
    return make_pair(shape, max_disp=max_disp, kind="shapes",
                     texture="cloud", seed=3)


@functools.lru_cache(maxsize=None)
def _reference(preset):
    """The reference's whole golden call on the preset's pair."""
    pair = _pair(preset)
    res = build_pipeline(PRESETS[preset].replace(backend="jnp"))(
        pair.left, pair.right)
    return np.asarray(res.disp), np.asarray(res.valid)


def _assert_reference(preset, row_bands, col_bands):
    pair = _pair(preset)
    disp, valid = golden_banded(pair.left, pair.right, PRESETS[preset],
                                row_bands, col_bands)
    want_disp, want_valid = _reference(preset)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(disp, want_disp)
    assert 0.3 < valid.mean() < 1.0
    return disp, valid


@pytest.mark.parametrize("col_bands", [1, 3], ids=["cols1", "cols3"])
@pytest.mark.parametrize("row_bands", [1, 2, _CFG4_ROWS],
                         ids=["rows1", "rows2", "rows1-3-20-23-1"])
def test_config4_bands_equal_reference(row_bands, col_bands):
    """Config 4's fields at 48x320, D=256: each split of rows and columns
    gives the reference's whole golden result, bit for bit."""
    _assert_reference("middlebury_full_256_tiled", row_bands, col_bands)


@pytest.mark.parametrize("preset, row_bands, col_bands", [
    ("kitti_sgm8_128", 5, 3),
    ("kitti_sgm8_128_quality", (1, 3, 35, 1), 3),
    ("middlebury_census_sgm4_64", 3, 2),
])
def test_presets_bands_equal_reference(preset, row_bands, col_bands):
    """8 paths with fixed and with adaptive P2 (the image passes into
    every family, sheared for the diagonals) at 40x200, D=128, and 4
    paths at 40x160, D=64."""
    _assert_reference(preset, row_bands, col_bands)


def test_port_cpu_path_equals_bands():
    """The port's plain path on the CPU gives the harness's config-4
    result, as the card's run gives the full-size fixture's."""
    preset = "middlebury_full_256_tiled"
    pair = _pair(preset)
    disp, valid = _assert_reference(preset, _CFG4_ROWS, 3)
    got = t_compute(torch.from_numpy(pair.left), torch.from_numpy(pair.right),
                    TPRESETS[preset].replace(backend="torch"))
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.disp.numpy(), disp)


def test_bands_tile_the_frame():
    """Band counts split near-evenly, sizes are taken as given, and the
    default bands keep one call's band within its voxel budget at the
    bench's 1988x2880x256."""
    assert _bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert _bounds(48, _CFG4_ROWS) == [(0, 1), (1, 4), (4, 24), (24, 47),
                                       (47, 48)]
    with pytest.raises(ValueError):
        _bounds(48, (1, 3))
    assert default_bands((1988, 2880), 256) == (22, 22)
    assert default_bands((48, 320), 256) == (1, 1)
