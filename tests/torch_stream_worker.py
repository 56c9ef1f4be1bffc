"""One rank of a distributed stream, for tests/test_torch_stream.py.

Each process joins a gloo process group at a localhost address, builds a
distributed mesh (one rank per tile of each 'batch' replica) and drives
the same frame stream through a ``StreamRunner`` with a manifest of its
own. It records the stream ids of the frames its results hold (the
batch's first frame is ``runner.frames_done`` when a result is delivered)
and their maps, in ``<outdir>/ids_run<r>_rank<k>.json`` and
``disp_run<r>_rank<k>.npz``. Rank k's tile lies on the device ``cpu:k``
(one CPU, a distinct index per rank), and every device a tensor is moved
to is recorded in ``devices_run<r>_rank<k>.json``, so the test can check
that a rank works on its own device only. With ``fail_after`` the runner's fault
injection fires: rank 1 then dies as a killed worker (``os._exit(1)``, no
clean-up) and the others exit 3. Imports no jax.

Usage: python torch_stream_worker.py <rank> <nprocs> <port> <outdir> <case>
where <case> is a JSON object: cfg (StereoConfig fields), shape, grid
(ty, tx), batch_axis, batch, frames, max_disp, run_id, fail_after (or
null).
"""

import json
import os
import sys

rank, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
case = json.loads(sys.argv[5])

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stereo_tpu_torch.config import StereoConfig  # noqa: E402
from stereo_tpu_torch.data import make_pair  # noqa: E402
from stereo_tpu_torch.parallel import (  # noqa: E402
    StreamRunner,
    initialize_multihost,
    make_tile_mesh,
)

torch.set_num_threads(1)
moved_to = set()
_tensor_to = torch.Tensor.to


def _recording_to(self, *args, **kwargs):
    for a in (*args, kwargs.get("device")):
        if isinstance(a, (str, torch.device)):
            moved_to.add(str(torch.device(a)))
    return _tensor_to(self, *args, **kwargs)


torch.Tensor.to = _recording_to
initialize_multihost(f"127.0.0.1:{port}", nprocs, rank)  # gloo: no card
shape = tuple(case["shape"])
frames = [
    (p.left, p.right)
    for p in (make_pair(shape, max_disp=case["max_disp"], kind="shapes",
                        seed=s) for s in range(case["frames"]))
]
mesh = make_tile_mesh([f"cpu:{r}" for r in range(nprocs)],
                      mesh_shape=tuple(case["grid"]),
                      batch=case["batch_axis"])
assert mesh.distributed
runner = StreamRunner(
    StereoConfig(**case["cfg"]), mesh, shape, batch_size=case["batch"],
    manifest_path=os.path.join(outdir, f"manifest_rank{rank}.json"),
    device="cpu")

ids, maps = [], {}


def on_result(res):
    for j, index in enumerate(res.frames):
        fid = runner.frames_done + index
        ids.append(fid)
        maps[f"disp{fid}"] = res.disp[j].numpy()
        maps[f"valid{fid}"] = res.valid[j].numpy()


def save():
    tag = f"run{case['run_id']}_rank{rank}"
    with open(os.path.join(outdir, f"ids_{tag}.json"), "w") as f:
        json.dump(ids, f)
    np.savez(os.path.join(outdir, f"disp_{tag}.npz"), **maps)
    with open(os.path.join(outdir, f"devices_{tag}.json"), "w") as f:
        json.dump(sorted(moved_to), f)


try:
    stats = runner.run(frames, on_result=on_result,
                       checkpoint_every=case["batch"],
                       fail_after=case["fail_after"])
except RuntimeError as e:
    if "fault injection" not in str(e):
        raise
    save()
    print(f"rank {rank}: died after fault injection", flush=True)
    os._exit(1 if rank == 1 else 3)

save()
torch.distributed.destroy_process_group()
print(f"rank {rank}: ok frames={stats['frames']}", flush=True)
