"""The command's refusals: no card, or a directory that holds the benchmark
alone, give no result line and a non-zero exit."""

import shutil
import subprocess
import sys

import pytest

from benchmark.harness import BENCH

ROOT = BENCH.parent
ARGS = ["--workload", "kitti-stream-b48", "--seed", "5", "--seconds", "1",
        "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import "
            "harness; harness.run_cell(harness.load_cell('kitti-stream-b48'), "
            "5, 1, False, 'cpu', 0.0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "stereo_tpu_torch" in out.stderr
