"""The port's hard evaluation suite, sweep harness and occlusion fill
against the reference's, on the CPU. Bit-equal disparities give equal
rows, so rows are compared with ``==``.
"""

import json

import numpy as np
import pytest
import torch

from stereo_tpu import config as jconfig
from stereo_tpu import native as jnative
from stereo_tpu.eval import hard_suite as jsuite
from stereo_tpu.eval.harness import EvalHarness as JHarness
from stereo_tpu.utils import viz as jviz
from stereo_tpu_torch import config as tconfig
from stereo_tpu_torch import native as tnative
from stereo_tpu_torch.data import make_pair
from stereo_tpu_torch.eval import hard_suite as tsuite
from stereo_tpu_torch.eval.harness import EvalHarness
from stereo_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

_KW = dict(num_disparities=16)


def test_scenarios_match_reference():
    assert tsuite.SCENARIOS == jsuite.SCENARIOS
    cfg = tconfig.KITTI_SGM8_128.replace(**_KW)
    got = list(tsuite.suite_pairs(cfg, (24, 40), (0, 1), ["noise", "thin"]))
    want = list(jsuite.suite_pairs(jconfig.KITTI_SGM8_128.replace(**_KW),
                                   (24, 40), (0, 1), ["noise", "thin"]))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.left, w.left)
        np.testing.assert_array_equal(g.right, w.right)
        np.testing.assert_array_equal(g.gt_disp, w.gt_disp)


@pytest.mark.parametrize(
    "preset, kw, model",
    [
        ("kitti_sgm8_128_quality", {}, "classic"),
        ("kitti_sgm8_128", dict(fill_occlusions=True), "classic"),
        ("kitti_sgm8_128", {}, "pyramid"),
    ],
    ids=["quality", "fill_occlusions", "pyramid"],
)
def test_run_hard_suite_matches_reference(preset, kw, model):
    kw = dict(_KW, **kw)
    args = dict(shape=(48, 80), seeds=(0,), scenarios=["occlusion", "combo"],
                model=model)
    got = tsuite.run_hard_suite(tconfig.PRESETS[preset].replace(**kw),
                                device="cpu", **args)
    want = jsuite.run_hard_suite(
        jconfig.PRESETS[preset].replace(backend="jnp", **kw), **args)
    assert got == want
    assert [r["scenario"] for r in got] == ["occlusion", "combo"]
    assert all(r["n_pairs"] == 1 and "bad3_all" in r for r in got)


def test_census_vs_sad_robustness_matches_reference():
    args = dict(shape=(48, 80), seeds=(0, 1))
    got = tsuite.census_vs_sad_robustness(
        tconfig.KITTI_SGM8_128.replace(**_KW), device="cpu", **args)
    want = jsuite.census_vs_sad_robustness(
        jconfig.KITTI_SGM8_128.replace(backend="jnp", **_KW), **args)
    assert got == want
    assert set(got) == {"census", "sad"} and "bad3_all" not in got["sad"]
    assert got["census"]["bad3_noc"] < got["sad"]["bad3_noc"]


def _pairs():
    return [make_pair((40, 64), max_disp=10, texture="cloud", seed=s)
            for s in (0, 1, 2)]


@pytest.mark.parametrize("model", ["classic", "pyramid"])
def test_eval_harness_matches_reference(tmp_path, model):
    got = EvalHarness(tconfig.KITTI_SGM8_128.replace(**_KW), model=model,
                      results_path=str(tmp_path / "r.jsonl"),
                      device="cpu").run(_pairs())
    want = JHarness(jconfig.KITTI_SGM8_128.replace(backend="jnp", **_KW),
                    model=model).run(_pairs())
    assert got["n_pairs"] == want["n_pairs"] == 3
    for key in want:
        if key != "sec":
            assert got[key] == want[key], key
    recs = [json.loads(ln) for ln in
            (tmp_path / "r.jsonl").read_text().splitlines()]
    assert [r["pair"] for r in recs] == [p.name for p in _pairs()]
    assert all(r["device"] == "cpu" and r["config"]["model"] == model
               for r in recs)


def test_eval_harness_resumes(tmp_path):
    cfg = tconfig.KITTI_SGM8_128.replace(**_KW)
    manifest = str(tmp_path / "done.json")
    pairs = _pairs()
    first = EvalHarness(cfg, manifest_path=manifest, device="cpu")
    assert first.run(pairs[:2])["n_pairs"] == 2
    assert json.loads((tmp_path / "done.json").read_text())["done"] == \
        sorted(p.name for p in pairs[:2])
    # A new harness on the same manifest skips what is done.
    second = EvalHarness(cfg, manifest_path=manifest, device="cpu")
    assert second.run(pairs)["n_pairs"] == 1
    assert EvalHarness(cfg, manifest_path=manifest,
                       device="cpu").run(pairs) == {"n_pairs": 0}


def test_eval_harness_writes_artifacts(tmp_path):
    pytest.importorskip("PIL")
    cfg = tconfig.KITTI_SGM8_128.replace(**_KW)
    pair = _pairs()[0]
    EvalHarness(cfg, artifacts_dir=str(tmp_path / "art"),
                device="cpu").run([pair])
    assert (tmp_path / "art" / f"{pair.name}_disp.png").stat().st_size > 0
    assert (tmp_path / "art" / f"{pair.name}_err.png").stat().st_size > 0


def test_viz_matches_reference():
    rng = np.random.default_rng(8)
    disp = (rng.integers(0, 512, size=(9, 14)) / 4).astype(np.float32)
    valid = rng.integers(0, 2, size=(9, 14)).astype(bool)
    gt = (rng.integers(0, 512, size=(9, 14)) / 4).astype(np.float32)
    np.testing.assert_array_equal(tviz.colorize_disparity(disp, valid),
                                  jviz.colorize_disparity(disp, valid))
    np.testing.assert_array_equal(tviz.colorize_disparity(disp),
                                  jviz.colorize_disparity(disp))
    np.testing.assert_array_equal(tviz.error_map(disp, gt, valid),
                                  jviz.error_map(disp, gt, valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_invalid_lr_matches_reference(seed):
    rng = np.random.default_rng(seed)
    disp = (rng.integers(0, 512, size=(12, 30)) / 4).astype(np.float32)
    valid = rng.random((12, 30)) > 0.4
    valid[3] = False   # a row with no valid pixel is not fillable
    valid[5, :4] = False
    gd, gf = tnative.fill_invalid_lr(disp, valid)
    wd, wf = jnative.fill_invalid_lr(disp, valid)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gf, wf)
    assert not gf[3].any() and gf[5, :4].all()
    np.testing.assert_array_equal(gd[valid], disp[valid])
