"""Scaling efficiency of the batched stream over device counts.

Twin of ``stereo_tpu/eval/scaling.py``: the stream pipeline at increasing
device counts, throughput and efficiency against linear scaling of the
first count's rate per device. The meshes are local (one process drives
every device). ``devices`` may repeat one device, as the CPU tests repeat
the CPU: such rows check the harness, not the hardware. Scaling across
processes over NCCL is not measured here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StereoConfig
from ..parallel.mesh import cuda_devices, make_tile_mesh
from ..parallel.stream import build_stream_pipeline
from ..utils.timing import chained_seconds_per_call


def scaling_report(
    cfg: StereoConfig,
    image_shape: Tuple[int, int] = (375, 1242),
    device_counts: Optional[Sequence[int]] = None,
    frames_per_device: int = 1,
    tiles_per_device: Tuple[int, int] = (1, 1),
    iters: int = 10,
    devices: Optional[Sequence] = None,
) -> List[dict]:
    """fps and efficiency per device count.

    Frames split over the 'batch' axis; with ``tiles_per_device`` each
    frame also tiles over ('ty', 'tx'). ``devices`` defaults to every CUDA
    card, and without a card raises (the CPU only where the caller passes
    it). The default counts are those of (1, 2, 4, 8, 16, 32) that the
    devices hold; an explicit count above them raises ValueError from
    ``make_tile_mesh``, as the reference's does. Frames are random, made
    from seed 0, and placed on the first device before timing. Each row
    names the devices it ran on (``device``).
    """
    devs = [torch.device(d) for d in (devices or cuda_devices())]
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    ty, tx = tiles_per_device

    rng = np.random.default_rng(0)
    rows = []
    base_fps = None
    for n in device_counts:
        batch_axis = max(1, n // (ty * tx))
        used = batch_axis * ty * tx
        mesh = make_tile_mesh(devs[:used], mesh_shape=(ty, tx),
                              batch=batch_axis)
        batch = batch_axis * frames_per_device
        frames_l = rng.integers(0, 256, size=(batch, *image_shape)).astype(np.uint8)
        frames_r = rng.integers(0, 256, size=(batch, *image_shape)).astype(np.uint8)
        fn = build_stream_pipeline(cfg, mesh, image_shape, device=devs[0])
        args = (torch.from_numpy(frames_l).to(devs[0]),
                torch.from_numpy(frames_r).to(devs[0]))
        sec = chained_seconds_per_call(fn, args, iters=iters)
        fps = batch / sec
        if base_fps is None:
            base_fps = fps / used
        eff = fps / (base_fps * used)
        rows.append({
            "devices": used,
            "batch": batch,
            "fps": round(fps, 2),
            "fps_per_device": round(fps / used, 2),
            "efficiency": round(eff, 4),
            "device": ", ".join(sorted({_name(d) for d in devs[:used]})),
        })
    return rows


def _name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
