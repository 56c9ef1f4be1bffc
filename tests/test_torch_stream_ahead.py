"""``StreamRunner.run`` stages the next batch before a checkpoint's drain.

On the CPU, with spies on the runner's ``_to_device``, pipeline,
``_settle`` and ``_drain_one``: where a checkpoint is due after a full batch
and frames remain, the next batch is staged before the checkpoint's first
wait; before a ``fail_after`` fault, after a partial batch and at the end of
the stream nothing is. ``staged_ahead`` counts the batches staged ahead, and
the frames done, the manifest at each checkpoint and the deliveries equal
those of the reference's ``StreamRunner`` on the same frames (which pulls one
frame at a time and drains before it pulls the next).
"""

import functools
import json
import signal

import jax
import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.data import make_pair
from stereo_tpu.parallel import StreamRunner as JRunner
from stereo_tpu.parallel import build_stream_pipeline as j_stream
from stereo_tpu.parallel import make_tile_mesh as j_mesh
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.parallel import StreamRunner as TRunner
from stereo_tpu_torch.parallel import make_tile_mesh as t_mesh

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 120

PLAIN = dict(cost_fn="census", num_disparities=8, num_paths=0,
             subpixel=False, median_filter=False)
SHAPE = (32, 48)


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _frames(n):
    return [(p.left, p.right)
            for p in (make_pair(SHAPE, max_disp=6, kind="constant",
                                seed=700 + i) for i in range(n))]


@functools.lru_cache(maxsize=None)
def _j_pipeline():
    """One reference pipeline that every reference runner here shares
    (each runner would compile its own)."""
    return j_stream(JCfg(**PLAIN), j_mesh(jax.devices()[:1], (1, 1)), SHAPE)


def _j_runner(batch, manifest):
    runner = JRunner(JCfg(**PLAIN), j_mesh(jax.devices()[:1], (1, 1)), SHAPE,
                     batch_size=batch, manifest_path=manifest)
    runner.pipeline = _j_pipeline()
    return runner


def _t_runner(batch, manifest):
    return TRunner(TCfg(**PLAIN), t_mesh(["cpu"], (1, 1)), SHAPE,
                   batch_size=batch, manifest_path=manifest, device="cpu")


def _plan(batch, every, n, fail_after):
    """The pipeline empties ``run`` should make, in order: True where the
    next batch is staged before it (a checkpoint due after a full batch,
    with frames left)."""
    plan, done, last = [], 0, 0
    while done < n:
        k = min(batch, n - done)
        done += k
        if k < batch:
            break
        if fail_after is not None and done >= fail_after:
            break
        if every and done - last >= every:
            last = done
            plan.append(done < n)
    return plan + [False]


def _spy_checkpoints(runner):
    """The frames done at each manifest write of ``runner``, as a list that
    grows while it runs."""
    ckpts = []
    write = runner._checkpoint

    def spy():
        ckpts.append(runner.frames_done)
        write()

    runner._checkpoint = spy
    return ckpts


def _drive(runner, frames, every, fail_after):
    """Run ``frames`` through ``runner``: the frames done at each manifest
    write, the frames done after the run (or its fault) and each delivered
    batch's disp."""
    ckpts, outs = _spy_checkpoints(runner), []
    kw = dict(on_result=lambda r: outs.append(np.asarray(r.disp)),
              checkpoint_every=every, fail_after=fail_after)
    if fail_after is None:
        runner.run(frames, **kw)
    else:
        with pytest.raises(RuntimeError, match="fault injection"):
            runner.run(frames, **kw)
    return ckpts, runner.frames_done, outs


def _spy_order(runner):
    """Log each enqueue, and at each pipeline empty and each drain how
    many batches have been staged beyond those enqueued: [(event,
    ahead)]."""
    count = {"stage": 0, "enqueue": 0}
    log = []
    to_device, pipeline = runner._to_device, runner.pipeline
    settle, drain = runner._settle, runner._drain_one

    def staged(frames):
        count["stage"] += 0.5  # left, then right
        return to_device(frames)

    def enqueued(left, right):
        count["enqueue"] += 1
        log.append(("enqueue", 0))
        return pipeline(left, right)

    def mark(event, fn):
        def call(*args):
            log.append((event, count["stage"] - count["enqueue"]))
            return fn(*args)
        return call

    runner._to_device, runner.pipeline = staged, enqueued
    runner._settle = mark("settle", settle)
    runner._drain_one = mark("drain", drain)
    return log


@pytest.mark.parametrize("batch, every, n, fail_after", [
    (2, 2, 8, None), (2, 2, 7, None), (2, 4, 9, None), (3, 4, 12, None),
    (3, 2, 10, None), (2, 0, 6, None), (4, 8, 8, None), (2, 2, 8, 4),
    (3, 3, 10, 6), (2, 4, 8, 4)],
    ids=lambda v: str(v))
def test_stage_ahead_of_the_drain(tmp_path, batch, every, n, fail_after):
    """The batch after a due checkpoint is staged before that checkpoint's
    first wait, and only there; ``staged_ahead`` counts those batches; the
    checkpoints, frames done and deliveries are the reference runner's."""
    frames = _frames(n)
    runner = _t_runner(batch, str(tmp_path / "port.json"))
    log = _spy_order(runner)
    got = _drive(runner, frames, every, fail_after)
    want = _drive(_j_runner(batch, str(tmp_path / "ref.json")), frames, every,
                  fail_after)

    plan = _plan(batch, every, n, fail_after)
    settles = [ahead for event, ahead in log if event == "settle"]
    assert settles == [float(p) for p in plan]
    # An empty that stages ahead does so before its first wait, and every
    # wait inside it follows the staged batch; elsewhere nothing is staged
    # beyond what was enqueued.
    inside = 0
    for i, (event, ahead) in enumerate(log):
        if event == "enqueue":
            inside = 0
        elif event == "settle":
            inside = ahead
            if ahead:
                assert log[i + 1] == ("drain", 1)
        else:
            assert ahead == inside
    assert runner.staged_ahead == sum(plan)

    assert got[:2] == want[:2]
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    with open(tmp_path / "port.json") as f:
        port = json.load(f)["frames_done"]
    with open(tmp_path / "ref.json") as f:
        assert port == json.load(f)["frames_done"] == got[1]


@pytest.mark.parametrize("entry", ["port", "reference"])
def test_a_pull_that_raises_after_a_checkpoint(tmp_path, entry):
    """A frame source that fails while the batch after a checkpoint is
    pulled: the batches before it are still delivered and checkpointed, as
    in the reference runner, and the failed pull is not counted staged
    ahead."""
    frames = _frames(4)

    def source():
        yield from frames
        raise OSError("frame source")

    make = _t_runner if entry == "port" else _j_runner
    runner = make(2, str(tmp_path / "m.json"))
    ckpts, outs = _spy_checkpoints(runner), []
    with pytest.raises(OSError, match="frame source"):
        runner.run(source(), on_result=outs.append, checkpoint_every=2)
    assert ckpts == [2, 4]
    assert [o.disp.shape[0] for o in outs] == [2, 2]
    with open(tmp_path / "m.json") as f:
        assert json.load(f)["frames_done"] == 4
    if entry == "port":
        assert runner.staged_ahead == 1
