"""The port's scaling harness and timing helper on the CPU.

Rows from repeated CPU devices check the harness (its meshes, batch sizes
and row keys against the reference's ``scaling_report`` on the conftest's
8 fake CPU devices), not the hardware; times are only required positive.
"""

import json

import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.eval.scaling import scaling_report as j_scaling
from stereo_tpu_torch.cli import main as t_cli
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.eval.scaling import scaling_report as t_scaling
from stereo_tpu_torch.utils.timing import chained_seconds_per_call

torch.set_num_threads(1)

#: The reference's scaling tests' configuration
#: (tests/distributed/test_scaling.py:17-20).
CFG = dict(cost_fn="census", num_disparities=8, num_paths=4, subpixel=False,
           lr_check=False, median_filter=False)


@pytest.mark.parametrize(
    "counts, tiles", [([1, 2, 4, 8], (1, 1)), ([4, 8], (2, 2))],
    ids=["batch_axis", "tiles_2x2"])
def test_scaling_rows_match_reference(counts, tiles):
    """The same device counts, batches and row keys as the reference's
    rows, and the devices' name besides; the first row's efficiency is 1
    by definition."""
    want = j_scaling(JCfg(**CFG), image_shape=(32, 48), device_counts=counts,
                     tiles_per_device=tiles, iters=1)
    got = t_scaling(TCfg(**CFG), image_shape=(32, 48), device_counts=counts,
                    tiles_per_device=tiles, iters=1, devices=["cpu"] * 8)
    assert [sorted(r) for r in got] == [sorted([*r, "device"]) for r in want]
    assert all(r["device"] == "cpu" for r in got)
    for key in ("devices", "batch"):
        assert [r[key] for r in got] == [r[key] for r in want]
    assert all(r["fps"] > 0 for r in got)
    assert got[0]["efficiency"] == 1.0
    for r in got:  # both rounded to two decimals
        assert r["fps_per_device"] == pytest.approx(r["fps"] / r["devices"],
                                                    abs=0.01)


def test_scaling_counts_capped_at_the_devices():
    """Counts above the devices given are dropped; the default counts are
    those that fit."""
    cfg = TCfg(**CFG)
    rows = t_scaling(cfg, image_shape=(24, 40), device_counts=[1, 2, 4],
                     iters=1, devices=["cpu"] * 2)
    assert [r["devices"] for r in rows] == [1, 2]
    rows = t_scaling(cfg, image_shape=(24, 40), iters=1, devices=["cpu"] * 3)
    assert [r["devices"] for r in rows] == [1, 2]


def test_scaling_without_devices_needs_a_card(monkeypatch):
    """Without ``devices`` the report takes the CUDA cards; with none it
    raises before timing anything, as the CLI's default ``--device cuda``
    does, rather than measuring the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_scaling(TCfg(**CFG), image_shape=(24, 40), device_counts=[1],
                  iters=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_cli(["scale", "--set", "num_disparities=16", "--demo-shape", "24",
               "40", "--devices", "1", "--iters", "1"])


def test_chained_seconds_per_call_is_positive():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    sec = chained_seconds_per_call(fn, (torch.zeros(8),), iters=4, repeats=3)
    assert sec > 0
    assert len(calls) == 1 + 4 * 3  # a warm-up call, then three trains


def test_cli_scale_on_cpu(capsys):
    """``scale`` with --device cpu: one JSON row per count, naming the
    device."""
    rc = t_cli(["scale", "--preset", "kitti_sgm8_128", "--set",
                "num_disparities=16", "--demo-shape", "48", "80",
                "--devices", "1,2", "--iters", "1", "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["fps"] > 0 and r["device"] == "cpu" for r in rows)
    assert rows[0]["efficiency"] == 1.0
