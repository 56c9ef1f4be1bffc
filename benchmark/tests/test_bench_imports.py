"""What a run loads: nothing whose top-level name is jax, jaxlib, flax or
stereo_tpu (the engine, stereo_tpu_torch, begins with that name, so names are
compared whole), and the reference nothing of the engine."""

import json
import subprocess
import sys

from benchmark.harness import BENCH

ROOT = BENCH.parent

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from benchmark import harness
out = harness.run_cell(tiny_cell({cell!r}), 7, 2.0, False, "cpu", 0.0)
print(json.dumps([out["correct"], sorted({{m.split(".")[0]
                                          for m in sys.modules}})]))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
from benchmark.reference import census_sgm
cfg = json.load(open({config!r}))["stereo"]
cfg["num_disparities"] = 8
img = np.random.default_rng(0).integers(0, 256, (12, 20), dtype=np.uint8)
census_sgm.host_postprocess(*census_sgm.compute_disparity(img, img, cfg), cfg)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax_and_no_reference_package():
    correct, names = top_level(RUN.format(
        root=str(ROOT), tests=str(BENCH / "tests"), cell="kitti-stream-b48"))
    assert correct
    assert "stereo_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "stereo_tpu"} & set(names)


def test_reference_loads_nothing_of_the_engine():
    names = top_level(REFERENCE.format(
        root=str(ROOT),
        config=str(BENCH / "configs" / "kitti2015_sgm8_d128.json")))
    assert "torch" in names
    assert not {"stereo_tpu_torch", "stereo_tpu", "jax", "jaxlib"} & set(names)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "stereo_tpu.x", object())
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    found = harness.forbidden_modules()
    assert "stereo_tpu.x" in found and "jaxfoo" not in found
    assert not any(m.startswith("stereo_tpu_torch") for m in found)
