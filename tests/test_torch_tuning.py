"""The port's tuning sweeps against the reference on the CPU.

``score_rows`` is the same arithmetic on the same rows; ``sweep`` and
``stage_sweep`` run the port's hard suite (its plain path on the CPU) and
must give records equal (``==``) to the reference's, the wall time
(``elapsed_s``) aside, as ``tests/test_torch_eval.py`` compares the suite's
rows.
"""

import signal

import pytest
import torch

from stereo_tpu.config import PRESETS as J_PRESETS
from stereo_tpu.eval import tuning as jtuning
from stereo_tpu_torch.config import PRESETS as T_PRESETS
from stereo_tpu_torch.eval import tuning as ttuning

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 150

SMALL = dict(shape=(48, 80), seeds=(0,), scenarios=("clean", "occlusion"))


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


ROWS = [
    dict(scenario="clean", bad3_noc=0.01, density_noc=0.97, bad3_all=0.04),
    dict(scenario="textureless", bad3_noc=0.02, density_noc=0.59,
         bad3_all=0.30),
    dict(scenario="occlusion", bad3_noc=0.05, density_noc=0.91),
]


@pytest.mark.parametrize("kw", [
    dict(), dict(density_floor=0.95, density_weight=1.0),
    dict(weights={"clean": 0.0, "textureless": 2.0}),
    dict(all_weight=0.25)], ids=["default", "floor", "weights", "all"])
def test_score_rows_matches_reference(kw):
    assert ttuning.score_rows(ROWS, **kw) == jtuning.score_rows(ROWS, **kw)


def _records(recs):
    return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in recs]


def test_sweep_matches_reference(tmp_path):
    """A two-value grid on the hard suite at 48x80, D=16: the same records,
    in the same order, logged the same way; ``format_table`` agrees."""
    base = dict(num_disparities=16)
    grid = {"p2": [60, 120]}
    want = jtuning.sweep(J_PRESETS["kitti_sgm8_128"].replace(**base), grid,
                         **SMALL)
    log = tmp_path / "sweep.jsonl"
    got = ttuning.sweep(T_PRESETS["kitti_sgm8_128"].replace(**base), grid,
                        log_path=str(log), device="cpu", **SMALL)
    assert _records(got) == _records(want)
    assert len(log.read_text().splitlines()) == 2
    assert ttuning.format_table(got) == jtuning.format_table(want)


def test_stage_sweep_matches_reference():
    """Two stages, the best one kept: the same survivors and records."""
    base = dict(num_disparities=16, speckle_max_size=0)
    stages = [{"p1": [8, 14]}, {"uniqueness_ratio": [0.0, 0.1]}]
    want = jtuning.stage_sweep(
        J_PRESETS["kitti_sgm8_128"].replace(**base), stages, keep=1,
        **SMALL)
    got = ttuning.stage_sweep(
        T_PRESETS["kitti_sgm8_128"].replace(**base), stages, keep=1,
        device="cpu", **SMALL)
    assert _records(got) == _records(want)
    assert [r["overrides"]["p1"] for r in got] == [want[0]["overrides"]["p1"]] * 2
