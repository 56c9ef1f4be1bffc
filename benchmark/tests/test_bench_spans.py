"""The readers of the engine's own spans: each sums the host time of its
span name alone, clipped to the traced window, a traced frame; none reads a
run without a trace or an engine without the spans."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.devtrace import Span, Trace
from benchmark.harness import BENCH

SEED = 2_971_215_073

READERS = {"stage_ms.stream": "stream.stage",
           "enqueue_ms.stream": "stream.enqueue",
           "checkpoint_ms.stream": "stream.checkpoint"}


def reader(name):
    return harness.load_file(BENCH / "metrics" / f"{name}.py",
                             f"benchmark_metric_{name.replace('.', '_')}")


def trace(spans=True):
    """A window of 1 ms; per name, 300 us of host spans inside it, and a
    span of each name partly or wholly outside it and on the device."""
    ms = 1_000_000
    host = [Span("stream.collect", 0, 100_000),
            Span("aten::copy_", 150_000, 250_000)]
    device = [Span("kernel", 0, ms)]
    if spans:
        for k, name in enumerate(READERS.values()):
            at = k * 10 * ms  # each name's spans in a window of their own
            host += [Span(name, at - 50_000, at + 100_000),
                     Span(name, at + 400_000, at + 600_000),
                     Span(name, at + ms - 100_000, at + ms + 900_000)]
            device.append(Span(name, at, at + ms))
    return host, device


@pytest.mark.parametrize("name, span", list(READERS.items()))
def test_reader_sums_its_own_host_spans_in_the_window(name, span):
    host, device = trace()
    k = list(READERS).index(name)
    window = (k * 10_000_000, k * 10_000_000 + 1_000_000)
    run = SimpleNamespace(trace=Trace(window, device, host), traced_frames=4)
    # 100 + 200 + 100 us of stream.* host time inside the window, over 4
    # frames; the device's span of the same name counts for nothing.
    assert reader(name).read(run) == pytest.approx(0.1)


@pytest.mark.parametrize("name", list(READERS))
@pytest.mark.parametrize("case", ["no_trace", "no_frames", "no_spans"])
def test_reader_reads_nothing_without_spans(name, case):
    host, device = trace(spans=case != "no_spans")
    run = SimpleNamespace(
        trace=None if case == "no_trace" else Trace((0, 10**6), device, host),
        traced_frames=0 if case == "no_frames" else 4)
    assert reader(name).read(run) is None


def test_traced_run_reads_the_engines_spans(tiny):
    """A traced run of the engine on the CPU reports every span metric: the
    traced batch, the fourth of two frames, ends in the checkpoint that the
    runner's default ``checkpoint_every=8`` forces."""
    cell = tiny("kitti-stream-b48")
    cell.traffic.update(trace_after_batches=3, trace_batches=1)
    # The trace starts only if the fourth batch does inside the window; one
    # thread keeps the batches before it quick on a CPU shared with other
    # test workers, where torch's thread pools contend.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(cell, SEED, 3.0, True, "cpu", 0.0)
    finally:
        torch.set_num_threads(threads)
    assert out["correct"]
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name
