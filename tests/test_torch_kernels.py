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
from stereo_tpu.ops.pallas.cost_kernel import census_cost_volume_pallas
from stereo_tpu.ops.pallas.filter_kernel import median_3x3_pallas
from stereo_tpu.ops.pallas.sgm_kernel import sgm_wta_fused_pallas
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.ops import census_transform
from stereo_tpu_torch.ops.cuda import (
    census_cost,
    launch_counts,
    median3x3,
    sgm_paths,
    sgm_select,
)

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


_jit_fused = jax.jit(sgm_wta_fused_pallas, static_argnums=1,
                     static_argnames="interpret")


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


def test_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        census_cost(torch.zeros((2, 3, 2), dtype=torch.int64),
                    torch.zeros((2, 3, 2), dtype=torch.int64,
                                device="meta"), TCfg())
