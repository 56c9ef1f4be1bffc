"""Seconds per call of a function on the card or on the CPU.

Twin of ``stereo_tpu/utils/timing.py``, keeping its contract (the median
seconds per call over ``repeats`` trains of ``iters`` calls, after a
warm-up call) but not its mechanism. The reference chains the calls inside
one jitted loop with a data dependency and a full-sum scalar, because XLA
eliminates dead computation and a remote TPU link may acknowledge a wait
early. Eager PyTorch eliminates nothing and its events are the card's own,
so here the calls are simply launched back to back, with no host
synchronisation between them, and timed with CUDA events recorded before
the first and after the last (on the CPU: the host clock around the train
and a synchronisation). A train that the host cannot feed fast enough is
timed with the card's idle gaps included: the rate it could sustain.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence

import torch


def chained_seconds_per_call(
    fn: Callable,
    args: Sequence,
    iters: int = 30,
    repeats: int = 3,
) -> float:
    """Median seconds per call of ``fn(*args)`` over ``repeats`` trains of
    ``iters`` calls, after one warm-up call; timed on the card of the first
    argument that is a CUDA tensor, else on the host."""
    dev = next((a.device for a in args
                if isinstance(a, torch.Tensor) and a.is_cuda), None)
    fn(*args)
    times = []
    for _ in range(repeats):
        if dev is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            times.append((time.perf_counter() - t0) / iters)
            continue
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream.synchronize()
        start.record(stream)
        for _ in range(iters):
            fn(*args)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return float(statistics.median(times))
