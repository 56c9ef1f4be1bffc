"""Shared helpers of the benchmark's CPU tests: cells cut to a size the CPU
runs in a second, the engine on its plain path."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

#: Per entry, traffic parameters that fit a tiny run.
TINY_TRAFFIC = {
    "stream": dict(batch=2, pool=8, check_pool_pairs=8, check_frames=8,
                   trace_after_batches=1, trace_batches=2),
}


def tiny_cell(name, shape=(40, 96), d=16):
    """The cell ``name`` at ``shape`` with ``d`` disparities and a small
    pool; everything else as the benchmark has it."""
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["image_shape"] = list(shape)
    cell.config["stereo"]["num_disparities"] = d
    cell.config["scene"]["max_disp"] = 12
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["entry"]]}
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
