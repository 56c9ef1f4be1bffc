"""The plain reference against fixtures that the JAX package's golden path
made (``stereo_tpu_torch/testdata``), hashes of disp and valid before and
after the host filters, at sizes the CPU reaches; its speckle filter against
the engine's C++ one; and the frame pool's determinism."""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

from benchmark.frames import make_pool
from benchmark.harness import BENCH
from benchmark.reference import census_sgm
from benchmark.reference.speckle import filter_speckles

TESTDATA = BENCH.parent / "stereo_tpu_torch" / "testdata"


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("fixture,shape,max_disp", [
    ("kitti_sgm8_128_seed0", (375, 1242), 96),
    ("middlebury_full_256_tiled_q_seed0", (497, 720), 200),
])
def test_reference_equals_golden_fixture(fixture, shape, max_disp):
    from stereo_tpu_torch.config import PRESETS
    from stereo_tpu_torch.data import make_pair

    fx = json.loads((TESTDATA / f"{fixture}.json").read_text())
    cfg = dataclasses.asdict(PRESETS[fx["preset"]])
    pair = make_pair(shape, max_disp=max_disp, kind="shapes", texture="cloud",
                     seed=0)
    disp, valid = census_sgm.compute_disparity(pair.left, pair.right, cfg)
    assert (digest(disp), digest(valid)) == (fx["disp"], fx["valid"])
    disp, valid = census_sgm.host_postprocess(disp, valid, cfg)
    assert (digest(disp), digest(valid)) == (fx["post_disp"],
                                             fx["post_valid"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speckle_equals_engines(seed):
    from stereo_tpu_torch import native

    rng = np.random.default_rng(seed)
    disp = rng.integers(0, 6, size=(60, 90)).astype(np.float32)
    disp += rng.random(disp.shape, dtype=np.float32) * (seed > 0)
    valid = rng.random(disp.shape) < 0.85
    for size in (1, 4, 30):
        _, want, _ = native.filter_speckles(disp, valid, 2.0, size)
        np.testing.assert_array_equal(filter_speckles(disp, valid, 2.0, size),
                                      want)


def test_reference_refuses_what_it_does_not_compute():
    from stereo_tpu_torch.config import PRESETS

    cfg = dataclasses.asdict(PRESETS["kitti_sgm8_128_quality"])
    with pytest.raises(NotImplementedError, match="adaptive_p2"):
        census_sgm.check_config(cfg)


def test_pool_is_the_seeds():
    a = make_pool(3, (40, 96), 12, 2**31 + 7, "cpu")
    b = make_pool(3, (40, 96), 12, 2**31 + 7, "cpu")
    c = make_pool(3, (40, 96), 12, 2**31 + 8, "cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and a[0].shape == (3, 40, 96)
    assert len({digest(f) for f in a[0]}) == 3
