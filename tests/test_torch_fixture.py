"""The full-size fixture that the port's GPU run must reproduce, tied to the
reference package, and the port's independence from jax."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from stereo_tpu.config import KITTI_SGM8_128
from stereo_tpu.data import kitti_like_pair
from stereo_tpu.eval.metrics import evaluate_disparity
from stereo_tpu.pipeline.pipeline import build_pipeline, host_postprocess

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "stereo_tpu_torch" / "testdata" / "kitti_sgm8_128_seed0.json"


def _hash(a) -> str:
    return hashlib.sha256(np.asarray(a).tobytes()).hexdigest()[:16]


def test_reference_reproduces_fixture():
    """The JAX golden path at 375x1242, D=128 gives the stored hashes."""
    fx = json.loads(FIXTURE.read_text())
    pair = kitti_like_pair(seed=0)
    assert list(pair.left.shape) == fx["shape"]
    res = build_pipeline(KITTI_SGM8_128.replace(backend="jnp"))(
        pair.left, pair.right
    )
    disp, valid = np.asarray(res.disp), np.asarray(res.valid)
    assert (_hash(disp), _hash(valid)) == (fx["disp"], fx["valid"])
    assert int(valid.sum()) == fx["n_valid"]
    pdisp, pvalid = host_postprocess(disp, valid, KITTI_SGM8_128)
    assert (_hash(pdisp), _hash(pvalid)) == (fx["post_disp"], fx["post_valid"])
    assert int(pvalid.sum()) == fx["post_n_valid"]
    m = evaluate_disparity(pdisp, pair.gt_disp, pair.gt_valid, pvalid)
    assert m["bad3"] == fx["bad3"] and m["density"] == fx["density"]


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
