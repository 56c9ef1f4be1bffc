"""The port's batched stream and its runner against the reference on the
CPU.

The same numpy frames (``make_pair`` from a seed) go through
``stereo_tpu.parallel.build_stream_pipeline`` on the conftest's 8 fake CPU
devices as a (batch=2, 2 x 2) mesh, and through the port's stream on a
local mesh of the same shape; disp and valid of every frame must be equal
(``assert_array_equal``, tolerance 0: the per-frame pipeline is integer
and the stitch elementwise). The runners of both packages go through the
same sequences (resume, a misaligned cursor, fault injection, checkpoint
cadence) and must report the same frames, manifests and deliveries. Two
tests spawn gloo process groups (one process per tile of each replica):
replicas on different frames, and a killed and restarted stream.
"""

import functools
import json
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.data import make_pair
from stereo_tpu.parallel import StreamRunner as JRunner
from stereo_tpu.parallel import build_stream_pipeline as j_stream
from stereo_tpu.parallel import make_tile_mesh as j_mesh
from stereo_tpu_torch.cli import main as t_cli
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.parallel import StreamRunner as TRunner
from stereo_tpu_torch.parallel import build_halo_pipeline as t_halo
from stereo_tpu_torch.parallel import build_stream_pipeline as t_stream
from stereo_tpu_torch.parallel import make_tile_mesh as t_mesh
from stereo_tpu_torch.pipeline import compute_disparity as t_compute

torch.set_num_threads(1)

#: The reference's stream tests' configurations
#: (tests/distributed/test_stream.py:23-48 and :124-184).
PLAIN = dict(cost_fn="census", num_disparities=8, num_paths=0,
             subpixel=False, median_filter=False)
SGM = dict(cost_fn="census", num_disparities=16, num_paths=8, subpixel=True,
           lr_check=True)
#: The quality preset's penalty (config 3q): adaptive P2 with a noise floor.
ADAPTIVE = dict(SGM, adaptive_p2=True, p2_min=30, adaptive_grad_floor=12)
SHAPE = (32, 48)


@functools.lru_cache(maxsize=None)
def _j_mesh_b2():
    return j_mesh(jax.devices()[:8], mesh_shape=(2, 2), batch=2)


def _t_mesh_b2():
    return t_mesh(["cpu"] * 8, (2, 2), batch=2)


def _stack(pairs):
    return (np.stack([p.left for p in pairs]),
            np.stack([p.right for p in pairs]))


@pytest.mark.parametrize(
    "kw, shape, max_disp",
    [(PLAIN, (32, 48), 6), (SGM, (48, 64), 12), (ADAPTIVE, (48, 64), 12)],
    ids=["wta_32x48_d8", "sgm8_lr_48x64_d16", "sgm8_adaptive_48x64_d16"])
def test_stream_matches_reference(kw, shape, max_disp):
    """Four frames over two replicas of a 2 x 2 grid, every frame equal to
    the reference's stream: the plain WTA case tiles legacy, the SGM ones
    stitched, with fixed and with adaptive P2."""
    pairs = [make_pair(shape, max_disp=max_disp, kind="shapes", seed=i)
             for i in range(4)]
    left, right = _stack(pairs)
    want = j_stream(JCfg(**kw), _j_mesh_b2(), shape)(left, right)
    got = t_stream(TCfg(**kw), _t_mesh_b2(), shape, device="cpu")(left, right)
    assert got.frames == range(4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want.disp))


@pytest.mark.parametrize("kw", [SGM, ADAPTIVE], ids=["fixed", "adaptive"])
def test_stream_kernel_route_matches_reference(monkeypatch, kw):
    """The whole-frame stream on the kernels' route (forced on the CPU,
    where each wrapper runs its plain twin: K2 takes the reference image
    under adaptive P2), two frames a batch, equal to the reference's
    stream on a trivial grid."""
    from stereo_tpu_torch import pipeline

    shape = (48, 64)
    pairs = [make_pair(shape, max_disp=12, kind="shapes", seed=60 + i)
             for i in range(2)]
    left, right = _stack(pairs)
    want = j_stream(JCfg(**kw), j_mesh(jax.devices()[:2], mesh_shape=(1, 1),
                                       batch=2), shape)(left, right)
    monkeypatch.setattr(pipeline, "use_kernels", lambda cfg, device: True)
    got = t_stream(TCfg(**kw), t_mesh(["cpu"] * 2, (1, 1), batch=2), shape,
                   device="cpu")(left, right)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.disp.numpy(), np.asarray(want.disp))


def test_stream_frames_are_the_halo_pipelines():
    """Each frame of a tiled stream is the halo-tiled pipeline's frame on
    the same grid, and a trivial grid's the whole frame's (frames of 3731
    bytes: the whole-frame stream re-aligns them for the kernels)."""
    pairs = [make_pair((41, 91), max_disp=12, kind="shapes", seed=30 + i)
             for i in range(2)]
    left, right = _stack(pairs)
    cfg = TCfg(**SGM)
    got = t_stream(cfg, t_mesh(["cpu"] * 2, (1, 2)), (41, 91),
                   device="cpu")(left, right)
    whole = t_stream(cfg, t_mesh(["cpu"], (1, 1)), (41, 91),
                     device="cpu")(left, right)
    halo = t_halo(cfg, t_mesh(["cpu"] * 2, (1, 2)), device="cpu")
    for i, p in enumerate(pairs):
        want = halo(p.left, p.right)
        assert torch.equal(got.disp[i], want.disp)
        assert torch.equal(got.valid[i], want.valid)
        want = t_compute(torch.from_numpy(p.left), torch.from_numpy(p.right),
                         cfg)
        assert torch.equal(whole.disp[i], want.disp)
        assert torch.equal(whole.valid[i], want.valid)


def test_stream_positional_arguments_in_reference_order():
    """The fifth parameter is ``donate``, as the reference's (no effect
    here), then ``lr_stitch`` and ``device``: a positional call in the
    reference's order gives the keyword call's frames."""
    pairs = [make_pair((32, 96), max_disp=10, kind="shapes", seed=40 + i)
             for i in range(2)]
    left, right = _stack(pairs)
    cfg, mesh = TCfg(**SGM), t_mesh(["cpu"] * 2, (1, 2))
    got = t_stream(cfg, mesh, (32, 96), None, True, False, "cpu")(left, right)
    want = t_stream(cfg, mesh, (32, 96), lr_stitch=False, device="cpu")(
        left, right)
    assert torch.equal(got.disp, want.disp)
    assert torch.equal(got.valid, want.valid)


def test_stream_refusals_match_reference():
    """Frames of another shape, and lr_stitch=True on a trivial grid, raise
    the reference's messages; a batch that does not split over the
    replicas raises."""
    bad = np.zeros((2, 32, 40), np.uint8)
    msg = re.escape("stream pipeline built for 32x48 frames, got (2, 32, 40)")
    with pytest.raises(ValueError, match=msg):
        j_stream(JCfg(**PLAIN), _j_mesh_b2(), SHAPE)(bad, bad)
    with pytest.raises(ValueError, match=msg):
        t_stream(TCfg(**PLAIN), _t_mesh_b2(), SHAPE, device="cpu")(bad, bad)
    odd = np.zeros((3, *SHAPE), np.uint8)
    with pytest.raises(ValueError, match="does not split"):
        t_stream(TCfg(**PLAIN), _t_mesh_b2(), SHAPE, device="cpu")(odd, odd)
    msg = "lr_stitch needs a non-trivial tile grid with tx > 1"
    with pytest.raises(ValueError, match=msg):
        j_stream(JCfg(**SGM), j_mesh(jax.devices()[:1], mesh_shape=(1, 1)),
                 SHAPE, lr_stitch=True)
    with pytest.raises(ValueError, match=msg):
        t_stream(TCfg(**SGM), t_mesh(["cpu"], (1, 1)), SHAPE,
                 lr_stitch=True, device="cpu")


def _frames(n, seed=0):
    return [(p.left, p.right)
            for p in (make_pair(SHAPE, max_disp=6, kind="constant",
                                seed=seed + i) for i in range(n))]


def _batches(frames, batch=2):
    return [(np.stack([f[0] for f in frames[i:i + batch]]),
             np.stack([f[1] for f in frames[i:i + batch]]))
            for i in range(0, len(frames), batch)]


@functools.lru_cache(maxsize=None)
def _j_pipeline():
    """One compiled reference pipeline that every reference runner of these
    tests shares (each runner would compile its own)."""
    return j_stream(JCfg(**PLAIN), _j_mesh_b2(), SHAPE)


def _j_runner(manifest):
    runner = JRunner(JCfg(**PLAIN), _j_mesh_b2(), SHAPE, batch_size=2,
                     manifest_path=manifest)
    runner.pipeline = _j_pipeline()
    return runner


def _t_runner(manifest):
    return TRunner(TCfg(**PLAIN), _t_mesh_b2(), SHAPE, batch_size=2,
                   manifest_path=manifest, device="cpu")


def _manifest(path):
    with open(path) as f:
        return json.load(f)["frames_done"]


def _all_frames(make, tmp):
    """7 frames at batch 2: the last batch is padded."""
    outs = []
    stats = make(str(tmp / "m.json")).run(_frames(7), on_result=outs.append)
    return ({"frames": stats["frames"], "manifest": _manifest(tmp / "m.json"),
             "delivered": [o.disp.shape[0] for o in outs]},
            np.asarray(outs[-1].disp))


def _resume_batches(make, tmp):
    """run_batches skips the batches under the cursor and refuses a cursor
    inside a batch."""
    batches = _batches(_frames(8, seed=50))
    manifest = str(tmp / "m.json")
    r1 = make(manifest)
    r1.run_batches(batches[:2], checkpoint_every=2)
    outs = []
    r2 = make(manifest)
    at_start = r2.frames_done
    stats = r2.run_batches(batches, on_result=outs.append)
    r3 = make(manifest)
    r3.frames_done = 3
    with pytest.raises(ValueError, match="align"):
        r3.run_batches(batches)
    return ({"first": r1.frames_done, "resumed_at": at_start,
             "frames": stats["frames"], "manifest": _manifest(manifest),
             "delivered": [o.disp.shape[0] for o in outs]},
            np.asarray(outs[-1].disp))


def _fault_and_resume(make, tmp):
    """run's fault injection after 4 frames, then a restart."""
    frames = _frames(8, seed=100)
    manifest = str(tmp / "m.json")
    done = []
    with pytest.raises(RuntimeError, match="fault injection"):
        make(manifest).run(frames, on_result=lambda r: done.append(
            r.disp.shape[0]), fail_after=4, checkpoint_every=2)
    at_fault = (_manifest(manifest), sum(done))
    outs = []
    r2 = make(manifest)
    stats = r2.run(frames, on_result=outs.append)
    return ({"at_fault": at_fault, "frames": stats["frames"],
             "delivered": [o.disp.shape[0] for o in outs]},
            np.asarray(outs[-1].disp))


def _cadence(make, tmp):
    """checkpoint_every=3 at batch 2 checkpoints at >= 4 and >= 8 frames
    and at the end."""
    runner = make(str(tmp / "m.json"))
    ckpts = []
    orig = runner._checkpoint

    def spy():
        ckpts.append(runner.frames_done)
        orig()

    runner._checkpoint = spy
    runner.run_batches(_batches(_frames(12, seed=51)), checkpoint_every=3)
    return {"checkpoints": ckpts}, None


def _crash_in_consumer(make, tmp):
    """A consumer that raises on the second batch: the manifest claims no
    more than was delivered, and the restart redelivers the rest."""
    batches = _batches(_frames(8, seed=200))
    manifest = str(tmp / "m.json")
    outs = []

    def fail_second(res):
        outs.append(res)
        if len(outs) == 2:
            raise KeyError("consumer")

    with pytest.raises(KeyError):
        make(manifest).run_batches(batches, on_result=fail_second,
                                   checkpoint_every=2)
    at_crash = _manifest(manifest)
    outs2 = []
    stats = make(manifest).run_batches(batches, on_result=outs2.append)
    return ({"at_crash": at_crash, "frames": stats["frames"],
             "delivered": len(outs2)}, np.asarray(outs2[-1].disp))


@pytest.mark.parametrize(
    "scenario", [_all_frames, _resume_batches, _fault_and_resume, _cadence,
                 _crash_in_consumer],
    ids=lambda f: f.__name__.strip("_"))
def test_runner_matches_reference_runner(tmp_path, scenario):
    """The same sequence through both runners: the same frames done,
    manifests, checkpoints and deliveries, and the last delivered batch's
    maps equal."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want, want_disp = scenario(_j_runner, tmp_path / "ref")
    got, got_disp = scenario(_t_runner, tmp_path / "port")
    assert got == want
    if want_disp is not None:
        np.testing.assert_array_equal(got_disp, want_disp)


def test_runner_delivers_stream_frames(tmp_path):
    """run() on numpy frames: each frame delivered once across a fault and
    a restart, with its stream position, equal to the whole frame."""
    frames = _frames(7, seed=300)
    manifest = str(tmp_path / "m.json")
    got = {}

    def make():
        return TRunner(TCfg(**PLAIN), t_mesh(["cpu"], (1, 1)), SHAPE,
                       batch_size=3, manifest_path=manifest, device="cpu")

    def keep(runner):
        def on_result(res):
            for j, index in enumerate(res.frames):
                fid = runner.frames_done + index
                assert fid not in got
                got[fid] = res.disp[j]
        return on_result

    r1 = make()
    with pytest.raises(RuntimeError, match="fault injection"):
        r1.run(frames, on_result=keep(r1), fail_after=3)
    r2 = make()
    assert r2.run(frames, on_result=keep(r2))["frames"] == 7
    assert sorted(got) == list(range(7))
    for fid, (left, right) in enumerate(frames):
        want = t_compute(torch.from_numpy(left), torch.from_numpy(right),
                         TCfg(**PLAIN))
        assert torch.equal(got[fid], want.disp)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, n, case):
    """Spawn n gloo ranks of tests/torch_stream_worker.py; returns their
    return codes and outputs."""
    worker = os.path.join(os.path.dirname(__file__), "torch_stream_worker.py")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(n), str(port), str(tmp_path),
         json.dumps(case)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("gloo stream worker timed out")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return [p.returncode for p in procs], outs


def _delivered(tmp_path, run_id, rank):
    with open(tmp_path / f"ids_run{run_id}_rank{rank}.json") as f:
        ids = json.load(f)
    return ids, np.load(tmp_path / f"disp_run{run_id}_rank{rank}.npz")


def _assert_own_device(tmp_path, run_id, rank):
    """Rank ``rank`` moved tensors to its own mesh device, cpu:<rank>, and
    to no other rank's (``cpu`` is the runner's result device)."""
    with open(tmp_path / f"devices_run{run_id}_rank{rank}.json") as f:
        moved_to = set(json.load(f))
    assert f"cpu:{rank}" in moved_to
    assert moved_to <= {"cpu", f"cpu:{rank}"}, (rank, sorted(moved_to))


def test_gloo_replicas_hold_their_own_frames(tmp_path):
    """Batch 2 over two replicas of a 1 x 2 grid, four ranks: each replica
    runs its own frames, and both ranks of a replica receive that replica's
    frames, equal to the local stream's; each rank stages its frames on its
    own device, not on its replica's first rank's."""
    cfg = dict(num_disparities=16, num_paths=8)
    case = dict(cfg=cfg, shape=[32, 80], grid=[1, 2], batch_axis=2, batch=2,
                frames=4, max_disp=12, run_id=1, fail_after=None)
    rcs, outs = _run_workers(tmp_path, 4, case)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    pairs = [make_pair((32, 80), max_disp=12, kind="shapes", seed=s)
             for s in range(4)]
    local = t_stream(TCfg(**cfg), t_mesh(["cpu"] * 4, (1, 2), batch=2),
                     (32, 80), device="cpu")
    want = [local(*_stack(pairs[i:i + 2])) for i in (0, 2)]
    for rank in range(4):
        ids, maps = _delivered(tmp_path, 1, rank)
        _assert_own_device(tmp_path, 1, rank)
        replica = rank // 2
        assert ids == [replica, 2 + replica]
        for fid in ids:
            res = want[fid // 2]
            np.testing.assert_array_equal(maps[f"disp{fid}"],
                                          res.disp[fid % 2].numpy())
            np.testing.assert_array_equal(maps[f"valid{fid}"],
                                          res.valid[fid % 2].numpy())


def test_gloo_stream_kill_and_restart(tmp_path):
    """Two ranks, one replica each (the reference's
    tests/distributed/test_multiprocess.py:59-139): fault injection after 8
    of 12 frames kills rank 1 hard; both restart from their manifests and
    finish. Every frame is delivered exactly once across runs and ranks,
    equal to the single-process port's."""
    cfg = dict(num_disparities=8, num_paths=4, subpixel=False)
    case = dict(cfg=cfg, shape=[48, 64], grid=[1, 1], batch_axis=2, batch=4,
                frames=12, max_disp=6, run_id=1, fail_after=8)
    rcs, outs = _run_workers(tmp_path, 2, case)
    assert rcs[0] != 0 and "died after fault injection" in outs[0], outs[0]
    assert rcs[1] == 1, outs[1][-2000:]
    for rank in range(2):
        assert _manifest(tmp_path / f"manifest_rank{rank}.json") == 8

    rcs, outs = _run_workers(tmp_path, 2, dict(case, run_id=2,
                                               fail_after=None))
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert "frames=12" in out
        assert _manifest(tmp_path / f"manifest_rank{rank}.json") == 12

    all_ids = []
    for run_id in (1, 2):
        for rank in range(2):
            ids, maps = _delivered(tmp_path, run_id, rank)
            all_ids.extend(ids)
            for fid in ids:
                p = make_pair((48, 64), max_disp=6, kind="shapes", seed=fid)
                want = t_compute(torch.from_numpy(p.left),
                                 torch.from_numpy(p.right), TCfg(**cfg))
                np.testing.assert_array_equal(maps[f"disp{fid}"],
                                              want.disp.numpy())
                np.testing.assert_array_equal(maps[f"valid{fid}"],
                                              want.valid.numpy())
    assert sorted(all_ids) == list(range(12))


def test_cli_stream_on_cpu(tmp_path, capsys):
    """``stream`` on synthetic frames with --device cpu: one JSON line of
    stats naming the device, and the manifest written."""
    rc = t_cli(["stream", "--preset", "kitti_sgm8_128", "--set",
                "num_disparities=16", "--limit", "4", "--batch", "2",
                "--batch-axis", "2", "--tiles", "1,1", "--demo-shape", "48",
                "80", "--manifest", str(tmp_path / "m.json"), "--device",
                "cpu"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 4 and stats["device"] == "cpu"
    assert _manifest(tmp_path / "m.json") == 4
