"""The full-size fixtures that the port's GPU run must reproduce, tied to
the reference package, and the port's independence from jax."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_tpu import data as jdata
from stereo_tpu.config import KITTI_SGM8_128, PRESETS
from stereo_tpu.data import kitti_like_pair
from stereo_tpu.eval.metrics import evaluate_disparity
from stereo_tpu.pipeline.pipeline import build_pipeline, host_postprocess
from stereo_tpu_torch import data as tdata

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TESTDATA = ROOT / "stereo_tpu_torch" / "testdata"
FIXTURE = TESTDATA / "kitti_sgm8_128_seed0.json"

#: The slice fixtures: name -> the pair each was made on, from either
#: package's data module (chip_smoke.py builds the same pairs).
SLICE_PAIRS = {
    "kitti_sgm8_128_quality": lambda data: data.kitti_like_pair(seed=0),
    "kitti_sgm8_128_lr_exact": lambda data: data.kitti_like_pair(seed=0),
    "tsukuba_sad16": lambda data: data.make_pair(
        (288, 384), max_disp=14, kind="shapes", texture="cloud", seed=0),
}


def _hash(a) -> str:
    return hashlib.sha256(np.asarray(a).tobytes()).hexdigest()[:16]


def _check_golden(fx: dict, cfg, pair) -> None:
    """The JAX golden path on ``pair`` gives the hashes, counts and
    metrics stored in ``fx``, before and after host_postprocess."""
    assert list(pair.left.shape) == fx["shape"]
    res = build_pipeline(cfg.replace(backend="jnp"))(pair.left, pair.right)
    disp, valid = np.asarray(res.disp), np.asarray(res.valid)
    assert (_hash(disp), _hash(valid)) == (fx["disp"], fx["valid"])
    assert int(valid.sum()) == fx["n_valid"]
    pdisp, pvalid = host_postprocess(disp, valid, cfg)
    assert (_hash(pdisp), _hash(pvalid)) == (fx["post_disp"], fx["post_valid"])
    assert int(pvalid.sum()) == fx["post_n_valid"]
    m = evaluate_disparity(pdisp, pair.gt_disp, pair.gt_valid, pvalid)
    assert m["bad3"] == fx["bad3"] and m["density"] == fx["density"]


def test_reference_reproduces_fixture():
    """The JAX golden path at 375x1242, D=128 gives the stored hashes."""
    _check_golden(json.loads(FIXTURE.read_text()), KITTI_SGM8_128,
                  kitti_like_pair(seed=0))


@pytest.mark.parametrize("name", sorted(SLICE_PAIRS))
def test_reference_reproduces_slice_fixture(name):
    """The quality preset and the exact LR check at 375x1242, D=128, and
    tsukuba_sad16 at 288x384, D=16, give the stored hashes."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    cfg = PRESETS[fx["preset"]].replace(**fx.get("overrides", {}))
    _check_golden(fx, cfg, SLICE_PAIRS[name](jdata))


@pytest.mark.parametrize("name", sorted(SLICE_PAIRS))
def test_port_data_matches_reference(name):
    """The port's synthetic pairs are the reference's, bit for bit."""
    want, got = SLICE_PAIRS[name](jdata), SLICE_PAIRS[name](tdata)
    for field in ("left", "right", "gt_disp", "gt_valid"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_port_imports_no_jax():
    code = (
        "import sys, stereo_tpu_torch\n"
        "stereo_tpu_torch.build_pipeline\n"
        "import stereo_tpu_torch.cli, stereo_tpu_torch.native\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'stereo_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
