"""The trace arithmetic: busy time as a union inside the window, kernel time
by name, and idle gaps named by what the host was doing."""

import pytest

from benchmark.devtrace import Span, Trace, kernel_names, merge
from benchmark.harness import BENCH


def trace():
    device = [Span("k1<int>", 10, 30), Span("k2", 20, 40), Span("k3", 60, 70),
              Span("k4", 90, 120), Span("k0", -20, -5)]
    host = [Span("bench.on_result", 45, 58), Span("cudaEventSynchronize", 46, 57),
            Span("aten::copy_", 75, 85)]
    return Trace((0, 100), device, host)


def test_merge():
    assert merge([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]


def test_busy_is_the_union_inside_the_window():
    t = trace()
    assert t.busy == [(10, 40), (60, 70), (90, 100)]
    assert t.busy_s == pytest.approx(50e-9)
    assert t.window_s == pytest.approx(100e-9)


def test_kernel_time_and_ops():
    t = trace()
    assert t.kernel_s(["k1", "k3"]) == pytest.approx(30e-9)
    assert t.device_ops(top=2) == [["k1<int>", 20e-9], ["k2", 20e-9]]


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(trace().idle_gaps())
    assert gaps == pytest.approx({
        "bench.on_result/cudaEventSynchronize": 20e-9,
        "aten::copy_": 20e-9, "no traced op": 10e-9})


def test_roofline_kernel_files_name_the_engines_kernels():
    """Each file under kernels/sgm_paths names a kernel of the engine's K2
    source, so the metric reads what the engine runs."""
    names = kernel_names(BENCH / "kernels" / "sgm_paths")
    src = (BENCH.parent / "stereo_tpu_torch" / "csrc"
           / "sgm_paths.cu").read_text()
    assert names and all(n in src for n in names)
