"""The quality cell's plain reference (``reference/census_sgm_adaptive.py``)
against the JAX package's golden fixture and the engine's plain path, the
comparison of its cell against frames made with fixed P2, and the stream
layer's metrics read in its cell."""

import dataclasses
import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, work
from benchmark.frames import make_pool
from benchmark.harness import BENCH
from benchmark.reference import census_sgm, census_sgm_adaptive

#: One torch thread: several test workers share the CPU, and torch's thread
#: pools contend.
torch.set_num_threads(1)

TESTDATA = BENCH.parent / "stereo_tpu_torch" / "testdata"
CELL = "kitti-quality-stream-b48"
SEED = 2_971_215_073


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def quality(**changes):
    from stereo_tpu_torch.config import PRESETS

    return dataclasses.asdict(
        PRESETS["kitti_sgm8_128_quality"].replace(**changes))


def test_reference_equals_golden_fixture():
    """The JAX package's golden path on the quality preset at 375 x 1242,
    before and after the host filters."""
    from stereo_tpu_torch.data import make_pair

    fx = json.loads((TESTDATA / "kitti_sgm8_128_quality_seed0.json")
                    .read_text())
    cfg = quality()
    pair = make_pair(tuple(fx["shape"]), max_disp=96, kind="shapes",
                     texture="cloud", seed=0)
    disp, valid = census_sgm_adaptive.compute_disparity(pair.left,
                                                        pair.right, cfg)
    assert (digest(disp), digest(valid)) == (fx["disp"], fx["valid"])
    disp, valid = census_sgm_adaptive.host_postprocess(disp, valid, cfg)
    assert (digest(disp), digest(valid)) == (fx["post_disp"],
                                             fx["post_valid"])


@pytest.mark.parametrize("floor", [0, 12])
@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("shape", [(40, 96), (33, 70)])
def test_reference_equals_engines_plain_path(shape, paths, floor):
    """Bit for bit the engine's plain path on seeded pairs, and not the
    fixed-P2 output on the same pairs: the penalty acts."""
    from stereo_tpu_torch.config import from_reference
    from stereo_tpu_torch.pipeline import compute_disparity

    cfg = quality(num_disparities=16, num_paths=paths,
                  adaptive_grad_floor=floor)
    left, right = make_pool(2, shape, 12, SEED + paths + floor, "cpu")
    engine = from_reference(cfg)
    fixed = dict(cfg, adaptive_p2=False)
    for lf, rf in zip(left, right):
        disp, valid = census_sgm_adaptive.compute_disparity(lf, rf, cfg)
        want = compute_disparity(torch.from_numpy(lf), torch.from_numpy(rf),
                                 engine)
        np.testing.assert_array_equal(disp.view(np.int32),
                                      want.disp.numpy().view(np.int32))
        np.testing.assert_array_equal(valid, want.valid.numpy())
        disp_f, _ = census_sgm.compute_disparity(lf, rf, fixed)
        assert (disp.view(np.int32) != disp_f.view(np.int32)).any()


@pytest.mark.parametrize("change, key", [
    (dict(adaptive_p2=False), "adaptive_p2"), (dict(cost_fn="sad"), "cost_fn"),
    (dict(lr_exact=True), "lr_exact"), (dict(num_paths=0), "paths")])
def test_reference_refuses_what_it_does_not_compute(change, key):
    with pytest.raises(NotImplementedError, match=key):
        census_sgm_adaptive.check_config(quality(**change))


@pytest.mark.parametrize("offered", ["adaptive", "fixed"])
def test_check_sees_the_mechanism(tiny, offered):
    """``harness.check`` on a stand-in of the cell: its own reference's
    frames read correct; frames made with fixed P2, offered in every slot,
    do not, and by the disparities they give."""
    cell = tiny(CELL)
    stereo = cell.config["stereo"]
    t = cell.traffic
    left, right = make_pool(t["pool"], tuple(cell.config["image_shape"]),
                            cell.config["scene"]["max_disp"], SEED, "cpu")
    sample = harness.Sample(t["pool"], t["check_pool_pairs"],
                            t["check_frames"], t["batch"],
                            np.random.default_rng([SEED, 1]))
    if offered == "adaptive":
        ref, cfg = census_sgm_adaptive, stereo
    else:
        ref, cfg = census_sgm, dict(stereo, adaptive_p2=False)
    pairs = sorted(sample.pairs)
    for k in range(2 * len(pairs)):
        pair = pairs[k % len(pairs)]
        sample.offer(k, pair, *ref.compute_disparity(left[pair], right[pair],
                                                     cfg),
                     slot=k % t["batch"])
    compared = harness.check(cell, left, right, sample, False, "cpu")
    assert harness.within(compared) == (offered == "adaptive"), compared
    assert (compared["disp_px_differ"]["value"] > 0) == (offered == "fixed")


def test_config_is_the_fixed_cells_with_the_quality_penalty():
    """The configuration file is KITTI's fixed-P2 one field for field but
    for the source (the paper of the penalty), the preset, the penalty and
    the reference."""
    def load(name):
        return json.loads((BENCH / "configs" / f"{name}.json").read_text())

    fixed = load("kitti2015_sgm8_d128")
    mine = load("kitti2015_sgm8_d128_adaptive")
    changed = {k for k in fixed if fixed[k] != mine[k]}
    assert changed == {"name", "source", "deployment", "preset", "stereo",
                       "reference", "assumed"}
    assert "TPAMI" in mine["source"] and "KITTI 2015" in mine["source"]
    stereo = {k for k in fixed["stereo"]
              if fixed["stereo"][k] != mine["stereo"][k]}
    assert stereo == {"adaptive_p2", "adaptive_grad_floor"}
    assert mine["stereo"]["p2_min"] == 30
    assert mine["assumed"]["scene"] == fixed["assumed"]["scene"]


def test_cell_reports_the_stream_layers_metrics():
    """The cell runs the fixed-P2 KITTI cell's path but for K2's penalty,
    so it reports every per-layer metric that cell reports, through the
    same readers; the frozen bound of K2 leaves out the penalty step, which
    is under 0.5% of it at KITTI size (6 operations per pixel and
    direction against 10 per voxel and direction at D=128)."""
    spec = json.loads(harness.SPEC.read_text())
    fixed = {m["name"] for m in harness.load_cell("kitti-stream-b48")
             .per_layer}
    mine = {m["name"] for m in harness.load_cell(CELL).per_layer}
    assert mine == fixed and "sgm_paths_roofline.stream" in mine
    assert all(CELL in m["workloads"] for m in spec["per_layer"])
    h, w, d = 375, 1242, 128
    step_ms = work.bound_ms(0, h * w * 8 * 6)
    assert step_ms / work.paths_bound_ms(h, w, d, 8) < 0.005


def test_traced_run_on_the_kernels_route(tiny, monkeypatch):
    """A traced run of the cell with the engine on its kernels' route
    (forced on the CPU, each wrapper's plain twin) is correct and reports
    the stream layer's spans and the frame's share; the CPU trace names no
    K2 kernel, so K2's share reads nothing here."""
    from stereo_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "use_kernels", lambda cfg, device: True)
    out = harness.run_cell(tiny(CELL), SEED, 3.0, True, "cpu", 0.0)
    assert out["correct"], out["compared"]
    for name in ("stage_ms.stream", "enqueue_ms.stream",
                 "frame_roofline.stream"):
        assert out["metrics"][name]["value"] > 0, name
    assert "sgm_paths_roofline.stream" not in out["metrics"]


def test_reference_loads_nothing_of_the_engine():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "import numpy as np\n"
        "from benchmark.reference import census_sgm_adaptive as r\n"
        f"cfg = json.load(open({str(BENCH / 'configs' / 'kitti2015_sgm8_d128_adaptive.json')!r}))['stereo']\n"
        "cfg['num_disparities'] = 8\n"
        "img = np.random.default_rng(0).integers(0, 256, (12, 20), "
        "dtype=np.uint8)\n"
        "r.host_postprocess(*r.compute_disparity(img, img, cfg), cfg)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not {"stereo_tpu_torch", "stereo_tpu", "jax", "jaxlib"} & names
