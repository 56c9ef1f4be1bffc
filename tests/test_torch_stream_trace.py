"""The port's own spans (``utils/trace.py``) on the CPU: ``span`` off and
on, the ``stream.*`` spans of ``StreamRunner.run`` and ``run_batches``
under ``torch.profiler`` (counts a batch, the checkpoints ``checkpoint_every``
dictates, ``stream.wait`` and ``stream.deliver`` nested where a checkpoint
forces them, the same results as without the profiler), and the CLI's
``--profile`` trace."""

import json
import signal
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from stereo_tpu_torch.cli import main as t_main
from stereo_tpu_torch.config import StereoConfig
from stereo_tpu_torch.data import make_pair
from stereo_tpu_torch.parallel import StreamRunner, make_tile_mesh
from stereo_tpu_torch.utils.trace import span

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 120

PLAIN = dict(cost_fn="census", num_disparities=8, num_paths=0,
             subpixel=False, median_filter=False)
SHAPE = (32, 48)
TOP_LEVEL = ("stream.collect", "stream.stage", "stream.enqueue",
             "stream.checkpoint")


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _spans(prof):
    """The host's ``stream.*`` spans of a finished profile:
    [(name, start ns, end ns)] by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("stream.")
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda sp: sp[1])


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_is_the_shared_null_context():
    """No profiler: the flag ``span`` reads is off, every span is the one
    null context, and a span made before a profiler starts records
    nothing even if the profiler runs when it closes."""
    assert autograd_profiler._is_profiler_enabled is False
    off = span("stream.a")
    assert isinstance(off, nullcontext) and span("stream.b") is off
    with _cpu_profile() as prof:
        with off:
            pass
    with span("stream.off"):
        prof = _cpu_profile()
        prof.start()
    prof.stop()
    assert _spans(prof) == []


@pytest.mark.parametrize("how", ["context", "start_stop"])
def test_span_on_records_on_the_profilers_clock(how):
    """Under ``torch.profiler``, as a context or by ``start``/``stop``, the
    flag is on and a span is one host range around the work inside it."""
    prof = _cpu_profile()
    if how == "context":
        prof.__enter__()
    else:
        prof.start()
    assert autograd_profiler._is_profiler_enabled is True
    with span("stream.outer"):
        with span("stream.inner"):
            torch.ones(4).sum()
    if how == "context":
        prof.__exit__(None, None, None)
    else:
        prof.stop()
    assert autograd_profiler._is_profiler_enabled is False
    (outer, s0, e0), (inner, s1, e1) = _spans(prof)
    assert (outer, inner) == ("stream.outer", "stream.inner")
    assert s0 <= s1 < e1 <= e0


def _frames(n):
    return [(p.left, p.right)
            for p in (make_pair(SHAPE, max_disp=6, kind="constant", seed=i)
                      for i in range(n))]


def _runner():
    return StreamRunner(StereoConfig(**PLAIN), make_tile_mesh(["cpu"], (1, 1)),
                        SHAPE, batch_size=2, device="cpu")


def _drive(entry, every):
    """7 frames through ``run`` (the last batch padded) or 8 stacked ones
    through ``run_batches``, at batch 2: (stats, delivered disp,
    checkpoints written)."""
    runner = _runner()
    outs, ckpts = [], []
    write = runner._checkpoint

    def spy():
        ckpts.append(runner.frames_done)
        write()

    runner._checkpoint = spy
    if entry == "run":
        stats = runner.run(_frames(7), on_result=outs.append,
                           checkpoint_every=every)
    else:
        frames = _frames(8)
        batches = [tuple(torch.from_numpy(np.stack([f[k] for f in
                                                    frames[i:i + 2]]))
                         for k in (0, 1)) for i in range(0, 8, 2)]
        stats = runner.run_batches(batches, on_result=outs.append,
                                   checkpoint_every=every)
    return stats, [o.disp for o in outs], ckpts


def _inside(sp, spans, name):
    return any(n == name and s <= sp[1] and sp[2] <= e for n, s, e in spans)


@pytest.mark.parametrize("entry, every, checkpoints, nested", [
    ("run", 2, 4, 4), ("run", 4, 2, 4), ("run", 0, 1, 2),
    ("run_batches", 2, 5, 4), ("run_batches", 4, 3, 4),
    ("run_batches", 0, 1, 2)],
    ids=lambda v: str(v))
def test_runner_spans(entry, every, checkpoints, nested):
    """Four batches: one ``stream.stage`` and ``stream.enqueue`` a batch
    (and one ``stream.collect`` in ``run``), a ``stream.wait`` and
    ``stream.deliver`` a drained batch, one ``stream.checkpoint`` for each
    manifest write (each batch, every second batch, or only the end), the
    drains a checkpoint forces nested inside it and the top-level spans
    disjoint, and in ``run`` the batch after a checkpoint staged before
    it; the results and frame count are those of an untraced run."""
    want_stats, want, _ = _drive(entry, every)
    with _cpu_profile() as prof:
        stats, got, ckpts = _drive(entry, every)
    spans = _spans(prof)
    assert stats["frames"] == want_stats["frames"]
    assert len(got) == len(want) == 4
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    count = {n: sum(sp[0] == n for sp in spans) for n in
             TOP_LEVEL + ("stream.wait", "stream.deliver")}
    assert count == {
        "stream.collect": 4 if entry == "run" else 0,
        "stream.stage": 4 if entry == "run" else 0,
        "stream.enqueue": 4, "stream.wait": 4, "stream.deliver": 4,
        "stream.checkpoint": checkpoints}
    assert checkpoints == len(ckpts)
    for name in ("stream.wait", "stream.deliver"):
        assert sum(_inside(sp, spans, "stream.checkpoint") for sp in spans
                   if sp[0] == name) == nested
    top = [sp for sp in spans if sp[0] in TOP_LEVEL
           or not _inside(sp, spans, "stream.checkpoint")]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    # run stages the batch after a checkpoint before that checkpoint's drain.
    for c in (sp for sp in spans if sp[0] == "stream.checkpoint"):
        after = [sp[1] for sp in spans
                 if sp[0] == "stream.enqueue" and sp[1] >= c[2]]
        if entry == "run" and after:
            stage = [sp for sp in spans
                     if sp[0] == "stream.stage" and sp[2] <= after[0]][-1]
            assert stage[2] <= c[1]


def test_fault_injection_checkpoints_in_a_span(tmp_path):
    """``fail_after``: the drain and the manifest written before the fault
    are one ``stream.checkpoint``."""
    runner = StreamRunner(StereoConfig(**PLAIN),
                          make_tile_mesh(["cpu"], (1, 1)), SHAPE,
                          batch_size=2, manifest_path=str(tmp_path / "m.json"),
                          device="cpu")
    with _cpu_profile() as prof:
        with pytest.raises(RuntimeError, match="fault injection"):
            runner.run(_frames(6), checkpoint_every=0, fail_after=4)
    names = [sp[0] for sp in _spans(prof)]
    assert names.count("stream.checkpoint") == 1
    assert names.count("stream.wait") == 2 and names[-1] == "stream.wait"
    assert json.loads((tmp_path / "m.json").read_text())["frames_done"] == 4


@pytest.mark.parametrize("command, names", [
    ("run", set()),
    ("stream", {"stream.collect", "stream.stage", "stream.enqueue",
                "stream.wait", "stream.checkpoint"})])
def test_cli_profile_writes_the_trace(tmp_path, capsys, command, names):
    """``--profile DIR`` writes ``DIR/trace.json`` through one exporter:
    the stream's trace holds its spans (no ``stream.deliver``: the CLI's
    stream takes no ``on_result``); ``run``'s holds the pipeline's ops."""
    extra = (["--limit", "4", "--batch", "2"] if command == "stream"
             else ["--demo"])
    assert t_main([command, "--set", "num_disparities=16", "--demo-shape",
                   "32", "48", *extra, "--profile", str(tmp_path),
                   "--device", "cpu"]) == 0
    capsys.readouterr()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    got = {e.get("name", "") for e in events}
    assert {n for n in got if n.startswith("stream.")} == names
    assert any(n.startswith("aten::") for n in got)
