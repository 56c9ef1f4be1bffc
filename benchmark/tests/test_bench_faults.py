"""A run on the CPU, the engine's plain path under the timed path, at a tiny
size: sound it is correct; with the timed path broken underneath, once for
each fault a one-card cell can have, the comparison calls it incorrect."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control import control_readings

SEED = 2_971_215_073  # above 2**31, as seeds of a check are


def run(cell, seconds=3.0):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", 0.0)


def stream_fault(kind):
    """A ``build_stream_pipeline`` whose batches come out broken."""
    from stereo_tpu_torch.parallel import stream

    real = stream.build_stream_pipeline

    def build(*args, **kwargs):
        pipe = real(*args, **kwargs)
        last = []

        def batched(left, right):
            res = pipe(left, right)
            if kind == "unchanged":        # the previous batch's result
                out = last[0] if last else res
                last[:] = [res]
                return out
            disp, valid = res.disp.clone(), res.valid.clone()
            if kind == "half":             # the second half not computed
                h = disp.shape[0] // 2
                disp[h:], valid[h:] = disp[:h], valid[:h]
            elif kind == "altered":        # one answer changed where made
                disp[:, 0, 0] += 1.0
            elif kind == "slot":           # one slot of the batch altered
                disp[-1, 0, 0] += 1.0
            return stream.StreamResult(disp, valid, res.frames)

        return batched

    return stream, "build_stream_pipeline", build


@pytest.mark.parametrize("name", ["kitti-stream-b48",
                                  "middlebury-full-stream-b4"])
def test_sound_run_is_correct(tiny, name):
    out = run(tiny(name))
    assert out["correct"], out["compared"]
    assert out["compared"]["frames_checked"]["value"] >= 2
    slots = out["compared"]["slots_checked"]
    assert slots["value"] == slots["min"] == 2
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "slot"])
def test_stream_fault_is_incorrect(tiny, monkeypatch, kind):
    monkeypatch.setattr(*stream_fault(kind))
    out = run(tiny("kitti-stream-b48"))
    assert not out["correct"], out["compared"]
    assert out["compared"]["disp_px_differ"]["value"] > 0, out["compared"]


@pytest.mark.parametrize("name", ["kitti-stream-b48",
                                  "middlebury-full-stream-b4"])
def test_control_is_incorrect(tiny, name):
    out = control_readings(tiny(name), SEED, "cpu")
    assert not out["correct"], out["compared"]
    assert out["compared"]["disp_px_differ"]["value"] > 0, out["compared"]


def test_traced_run_reads_its_layers(tiny):
    out = harness.run_cell(tiny("kitti-stream-b48"), SEED, 3.0, True, "cpu",
                           0.0)
    assert out["correct"]
    assert set(out["metrics"]) >= {"device_idle_share.stream",
                                   "frame_roofline.stream"}
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
    torch.testing.assert_close(
        out["metrics"]["device_idle_share.stream"]["value"],
        100 * (1 - out["device"]["busy_s"] / out["device"]["window_s"]))


def test_sample_keeps_its_size_and_a_frame_a_slot():
    sample = harness.Sample(48, 6, 16, 48, np.random.default_rng(SEED))
    rng = np.random.default_rng(1)
    frame = np.zeros((2, 3), np.float32)
    for k in range(200):
        for slot, pair in enumerate(rng.permutation(48)):
            sample.offer(48 * k + slot, int(pair), frame, frame > 0, slot)
    assert len(sample.kept) == 16 and len(sample.by_slot) == 48
    assert {p for _, p, _, _ in sample.frames()} <= sample.pairs
    assert len(sample.frames()) == 64
