"""The ``stream`` entry: ``StreamRunner.run`` on host frames, as the engine's
``cli stream`` calls it on one card (a 1 x 1 grid, batch axis 1, the runner's
defaults), closed loop: the runner takes the next frame when it wants it.

A mix that names this entry (``"entry": "stream"``) gives ``batch``,
``pool``, ``warmup_batches``, ``check_pool_pairs``, ``check_frames``,
``trace_after_batches`` and ``trace_batches``. ``on_result`` copies each
batch's disp and valid into host buffers made once in set-up, pinned on a
card, as a consumer that writes results out would: a fresh pageable tensor a
batch would make the harness's own page faults and staging copies (44-47 ms
of a 121 ms batch at 1242 x 375) a large part of what the cell measures. The
window opens when the first frame is handed over, and the runner takes no
new batch once it has closed.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from benchmark import devtrace

#: Whether the entry's output has been through the host filters.
HOST_POST = False


def pool_order(pool: int, rng):
    """Pool indices forever, each pass a new permutation drawn from the
    seed, so that no two batches repeat the same frames in the same
    order."""
    while True:
        yield from (int(i) for i in rng.permutation(pool))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(cell, cfg, left, right, seconds: float, trace: bool,
          device: torch.device, sample, rng):
    """Run the window; return its record: ``t0``, ``deliveries`` (host
    clock, frames), ``attempted``, ``delivered``, ``trace`` and
    ``traced_frames``. Every delivered frame is offered to ``sample`` with
    its slot in the batch."""
    from stereo_tpu_torch.parallel import StreamRunner, make_tile_mesh

    t = cell.traffic
    batch = t["batch"]
    runner = StreamRunner(cfg, make_tile_mesh([device], mesh_shape=(1, 1)),
                          tuple(cell.config["image_shape"]), batch_size=batch,
                          device=device)
    order = pool_order(t["pool"], rng)
    rec = SimpleNamespace(t0=None, handed=[], deliveries=[], trace=None,
                          traced_frames=0)
    host = []

    def copy_back(res):
        if not host:
            pin = device.type == "cuda"
            host.extend(torch.zeros(x.shape, dtype=x.dtype, pin_memory=pin)
                        for x in (res.disp, res.valid))
        n = res.disp.shape[0]
        host[0][:n].copy_(res.disp)
        host[1][:n].copy_(res.valid)
        return host[0][:n], host[1][:n]

    def warm_frames():
        for _ in range(t["warmup_batches"] * batch):
            i = next(order)
            yield left[i], right[i]

    runner.run(warm_frames(), on_result=copy_back)
    _sync(device)
    runner.frames_done, runner.elapsed = 0, 0.0

    tracer = devtrace.Tracer(device) if trace else None
    traced = SimpleNamespace(start=t["trace_after_batches"],
                             stop=t["trace_after_batches"]
                             + t["trace_batches"], on=False)

    def stop_trace(k):
        _sync(device)
        rec.trace = tracer.stop()
        rec.traced_frames = (k // batch - traced.start) * batch
        traced.on = False

    def frames():
        k = 0
        while True:
            if k % batch == 0:
                now = time.perf_counter()
                if rec.t0 is None:
                    rec.t0 = now
                elif now >= rec.t0 + seconds:
                    if traced.on:
                        stop_trace(k)
                    return
                if tracer is not None:
                    if k // batch == traced.start:
                        tracer.start()
                        traced.on = True
                    elif traced.on and k // batch == traced.stop:
                        stop_trace(k)
            i = next(order)
            rec.handed.append(i)
            k += 1
            yield left[i], right[i]

    def on_result(res):
        with devtrace.annotate("bench.on_result", traced.on):
            disp, valid = copy_back(res)
        now = time.perf_counter()
        first = sum(n for _, n in rec.deliveries)
        rec.deliveries.append((now, disp.shape[0]))
        for j in range(disp.shape[0]):
            sample.offer(first + j, rec.handed[first + j], disp[j].numpy(),
                         valid[j].numpy(), slot=j)

    runner.run(frames(), on_result=on_result)
    rec.attempted = len(rec.handed)
    rec.delivered = sum(n for _, n in rec.deliveries)
    return rec
