"""Batched video stream: frames over the mesh's 'batch' replicas, each
frame over the ('ty', 'tx') tile grid, and a runner with checkpoint and
resume.

Twin of ``stereo_tpu/parallel/stream.py``. Replica b of the 'batch' axis
takes its contiguous share of a batch and runs it one frame at a time
through the tile body of ``parallel/tiling.py`` (the reference's
``lax.scan`` inside ``shard_map``). Pipelining comes from the host running
ahead of the card: nothing on a frame's path waits for the device, so the
host enqueues the next frames while the card computes, and
``StreamRunner`` waits only on a CUDA event recorded after each batch,
``max_in_flight`` batches behind. One CUDA stream carries everything.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import StereoConfig, TileConfig
from ..pipeline import compute_disparity
from ..utils.trace import span
from .mesh import TileMesh
from .tiling import make_grid, pad_frames, run_tiles, tile_body


class StreamResult(NamedTuple):
    """The frames of a batch that this process holds.

    disp: [n, H, W] float32; valid: [n, H, W] bool; frames: their indices
    in the batch (every frame for a local mesh; on a distributed mesh the
    share of this rank's replica, as the reference's output shards over
    'batch')."""

    disp: torch.Tensor
    valid: torch.Tensor
    frames: range


def _replicas(mesh: TileMesh) -> List[int]:
    """The 'batch' replicas this process runs: all of a local mesh's, or
    the one of this rank on a distributed mesh."""
    if mesh.distributed:
        return [dist.get_rank() // (mesh.ty * mesh.tx)]
    return list(range(mesh.batch))


def build_stream_pipeline(
    cfg: StereoConfig,
    mesh: TileMesh,
    image_shape: Tuple[int, int],
    tile_cfg: Optional[TileConfig] = None,
    donate: bool = False,
    lr_stitch: Optional[bool] = None,
    device="cuda",
):
    """``(left [B, H, W], right [B, H, W]) -> StreamResult``.

    The tile body is built once for ``image_shape`` (stitched or legacy by
    the rule of ``build_halo_pipeline``); frames of another shape raise.
    B must be a multiple of the 'batch' axis nb: replica b takes the
    frames [b * B / nb, (b + 1) * B / nb) and runs them one frame at a
    time, so one frame's [H, W, D] volumes live at a time and no
    [B, H, W, D] tensor exists. The frames are padded to tile multiples
    once and cropped once; the trivial 1 x 1 grid runs
    ``compute_disparity`` on each frame. Inputs may be numpy arrays or
    tensors; the result lies on ``device``.

    ``donate`` stands where the reference's does (its fifth parameter) and
    has no effect: PyTorch's caching allocator already reuses each frame's
    memory for the next.
    """
    del donate  # no effect (see above)
    tile_cfg = tile_cfg or TileConfig(mesh_shape=(mesh.ty, mesh.tx))
    h, w = image_shape
    tile_fn, bh, bw = tile_body(
        cfg, tile_cfg, mesh.ty, mesh.tx, h, w, lr_stitch,
        "lr_stitch needs a non-trivial tile grid with tx > 1, the "
        "cheap-LR re-index, SGM paths, a census/rank cost, tiles at "
        "least D + min_disparity wide, and a halo covering the "
        "descriptor window radius")
    hp, wp = mesh.ty * bh, mesh.tx * bw
    grids = {b: make_grid(mesh, b) for b in _replicas(mesh)}
    device = torch.device(device)

    def chunk(b: int, left: torch.Tensor, right: torch.Tensor):
        """Replica b's frames, one at a time: (disp, valid) [n, H, W].
        The frames are staged on the device of this process's first tile
        of the replica (on a distributed mesh, this rank's own)."""
        grid = grids[b]
        home = grid.devices[grid.tiles[0]]
        left, right = left.to(home), right.to(home)
        if tile_fn is None:
            outs = [compute_disparity(lf, rf, cfg)
                    for lf, rf in zip(left, right)]
        else:
            left, right = pad_frames(left, hp, wp), pad_frames(right, hp, wp)
            outs = [run_tiles(grid, tile_fn, left[i], right[i], bh, bw)
                    for i in range(left.shape[0])]
        return tuple(torch.stack([o[k] for o in outs])[:, :h, :w].to(device)
                     for k in (0, 1))

    def batched(left, right) -> StreamResult:
        left, right = torch.as_tensor(left), torch.as_tensor(right)
        if left.ndim != 3 or tuple(left.shape[1:]) != (h, w):
            raise ValueError(
                f"stream pipeline built for {h}x{w} frames, got "
                f"{tuple(left.shape)}")
        if right.shape != left.shape:
            raise ValueError(f"left frames {tuple(left.shape)} and right "
                             f"frames {tuple(right.shape)} differ")
        n, nb = left.shape[0], mesh.batch
        if n == 0 or n % nb:
            raise ValueError(f"a batch of {n} frames does not split over "
                             f"the {nb} replicas of the 'batch' axis")
        per = n // nb
        replicas = list(grids)
        parts = [chunk(b, left[b * per:(b + 1) * per],
                       right[b * per:(b + 1) * per]) for b in replicas]
        frames = range(replicas[0] * per, (replicas[-1] + 1) * per)
        if len(parts) == 1:
            return StreamResult(*parts[0], frames)
        return StreamResult(torch.cat([p[0] for p in parts]),
                            torch.cat([p[1] for p in parts]), frames)

    return batched


def _head(res: StreamResult, n_real: int) -> StreamResult:
    """``res`` without the frames at batch index ``n_real`` and beyond
    (the padding of a partial batch)."""
    k = max(0, min(res.frames.stop, n_real) - res.frames.start)
    return StreamResult(res.disp[:k], res.valid[:k],
                        range(res.frames.start, res.frames.start + k))


class StreamRunner:
    """Drives a frame stream through the batched pipeline with resume.

    The manifest file (JSON ``{frames_done, elapsed}``, replaced
    atomically) records the next frame of the stream and the time spent,
    so an interrupted run restarts where it left off. ``max_in_flight``
    batches stay enqueued before the oldest is drained. Every entry point
    runs on ``device``, the card unless the caller passes ``"cpu"``. Under
    ``torch.profiler`` each step of the loop is a ``stream.*`` span
    (``utils/trace.py``).
    """

    def __init__(
        self,
        cfg: StereoConfig,
        mesh: TileMesh,
        image_shape: Tuple[int, int],
        batch_size: Optional[int] = None,
        tile_cfg: Optional[TileConfig] = None,
        manifest_path: Optional[str] = None,
        lr_stitch: Optional[bool] = None,
        max_in_flight: int = 2,
        device="cuda",
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.image_shape = image_shape
        self.batch = batch_size or mesh.batch
        self.max_in_flight = max(1, int(max_in_flight))
        if self.batch % mesh.batch:
            raise ValueError("batch_size must divide the 'batch' mesh axis")
        self.manifest_path = manifest_path
        self.device = torch.device(device)
        self.pipeline = build_stream_pipeline(
            cfg, mesh, image_shape, tile_cfg, lr_stitch=lr_stitch,
            device=self.device)
        self.frames_done = 0
        self.elapsed = 0.0
        #: Batches ``run`` staged before a checkpoint's drain (not in the
        #: manifest or the stats).
        self.staged_ahead = 0
        if manifest_path and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                m = json.load(f)
            self.frames_done = int(m.get("frames_done", 0))
            self.elapsed = float(m.get("elapsed", 0.0))

    def _checkpoint(self) -> None:
        if not self.manifest_path:
            return
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"frames_done": self.frames_done, "elapsed": self.elapsed}, f
            )
        os.replace(tmp, self.manifest_path)

    def _done_marker(self) -> Optional[torch.cuda.Event]:
        """The completion proof of the batch just enqueued: a CUDA event
        recorded after its launches (None on the CPU, where the calls have
        finished when they return)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _drain_one(self, pending: list, on_result) -> None:
        """Wait for the oldest enqueued batch (its completion proof), hand
        its result to ``on_result`` and count its frames done."""
        res, n_real, done = pending.pop(0)
        with span("stream.wait"):
            if done is not None:
                done.synchronize()
        if on_result is not None:
            with span("stream.deliver"):
                on_result(res)
        self.frames_done += n_real

    def _settle(self, pending: list, on_result, t0: Optional[float]
                ) -> float:
        """Empty the pipeline, add the time since ``t0`` (if any) to
        ``elapsed`` and write the manifest; returns the time the next
        stretch starts from."""
        with span("stream.checkpoint"):
            while pending:
                self._drain_one(pending, on_result)
            now = time.perf_counter()
            if t0 is not None:
                self.elapsed += now - t0
            self._checkpoint()
        return now

    def _to_device(self, frames: list) -> torch.Tensor:
        """Stack one batch of frames on ``device``: tensors with
        ``torch.stack``, numpy frames on the host and then moved to the
        card once, from pinned memory so the host does not wait."""
        if isinstance(frames[0], torch.Tensor):
            return torch.stack(frames).to(self.device)
        batch = torch.from_numpy(np.stack(frames))
        if self.device.type != "cuda":
            return batch
        return batch.pin_memory().to(self.device, non_blocking=True)

    def _next_batch(self, it) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                                 int]]:
        """Pull the next batch from ``it`` and stage it on ``device``:
        ``(left, right, n_real)``, a partial batch padded with its last
        frame, or None once ``it`` is exhausted."""
        with span("stream.collect"):
            pairs = list(itertools.islice(it, self.batch))
        if not pairs:
            return None
        n_real = len(pairs)
        pairs += pairs[-1:] * (self.batch - n_real)
        with span("stream.stage"):
            left = self._to_device([p[0] for p in pairs])
            right = self._to_device([p[1] for p in pairs])
        return left, right, n_real

    def _stats(self) -> dict:
        fps = self.frames_done / self.elapsed if self.elapsed else 0.0
        return {"frames": self.frames_done, "elapsed": self.elapsed,
                "fps": fps}

    def run_batches(
        self,
        batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
        on_result=None,
        checkpoint_every: int = 64,
    ) -> dict:
        """Process pre-stacked ``(left [B, H, W], right [B, H, W])``
        batches, already on the card when the runner's device is one.

        Batches wholly under the manifest cursor are skipped; a cursor
        inside a batch raises (stacked batches cannot be split). Progress
        is checkpointed once ``checkpoint_every`` frames have been
        processed since the last checkpoint, and at the end. The timer
        starts at the first processed batch.
        """
        pending = []
        to_skip = self.frames_done
        n_this_run = 0
        last_ckpt = 0
        t0 = None
        for left, right in batches:
            if left.shape[0] != self.batch:
                raise ValueError(
                    f"batch extent {left.shape[0]} != runner batch {self.batch}"
                )
            if self.device.type == "cuda" and not all(
                    isinstance(t, torch.Tensor) and t.device.type == "cuda"
                    for t in (left, right)):
                raise ValueError(
                    f"run_batches takes batches already on {self.device}; "
                    f"stream host frames through run()")
            if to_skip >= left.shape[0]:
                to_skip -= left.shape[0]
                continue
            if t0 is None:
                t0 = time.perf_counter()
            if to_skip:
                raise ValueError(
                    f"manifest cursor {self.frames_done} does not align to "
                    f"the {self.batch}-frame batch boundary; resume "
                    "run_batches() with the same batch size it was "
                    "checkpointed with"
                )
            with span("stream.enqueue"):
                pending.append((self.pipeline(left, right), left.shape[0],
                                self._done_marker()))
            n_this_run += left.shape[0]
            while len(pending) > self.max_in_flight:
                self._drain_one(pending, on_result)
            if checkpoint_every and n_this_run - last_ckpt >= checkpoint_every:
                last_ckpt = n_this_run
                t0 = self._settle(pending, on_result, t0)
        self._settle(pending, on_result, t0)
        return self._stats()

    def run(
        self,
        frames: Iterable[Tuple[np.ndarray, np.ndarray]],
        on_result=None,
        checkpoint_every: int = 8,
        fail_after: Optional[int] = None,
    ) -> dict:
        """Process (left, right) frame pairs; returns throughput stats.

        ``on_result`` receives each batch's ``StreamResult`` on the device,
        cut to the real frames; the runner never pulls a batch to the
        host. Frames before the manifest cursor are skipped (resume). A
        partial trailing batch is padded with its last frame and the
        padding's results dropped. ``fail_after`` raises after that many
        frames of this run, once they are delivered and checkpointed
        (fault injection for the restart tests).

        When a checkpoint is due after a full batch, the next batch is
        pulled and staged (its copy in enqueued) before the pipeline is
        emptied, so the host's staging runs while the card still computes
        the batches in flight; ``staged_ahead`` counts such batches. The
        staged batch is enqueued after the checkpoint, which counts only
        the frames delivered before it.
        """
        it = iter(frames)
        skipped = 0
        while skipped < self.frames_done:
            next(it)
            skipped += 1

        pending = []
        t0 = time.perf_counter()
        n_this_run = 0
        last_ckpt = 0
        staged = self._next_batch(it)
        while staged is not None:
            left, right, n_real = staged
            with span("stream.enqueue"):
                res = self.pipeline(left, right)
                pending.append((_head(res, n_real), n_real,
                                self._done_marker()))
            while len(pending) > self.max_in_flight:
                self._drain_one(pending, on_result)
            if n_real < self.batch:
                break
            n_this_run += n_real
            if fail_after is not None and n_this_run >= fail_after:
                self._settle(pending, on_result, t0)
                raise RuntimeError(
                    f"fault injection: failing after {n_this_run} frames"
                )
            if not (checkpoint_every
                    and n_this_run - last_ckpt >= checkpoint_every):
                staged = self._next_batch(it)
                continue
            last_ckpt = n_this_run
            # Stage ahead, then drain; a pull that raises still finds the
            # batches before it delivered and checkpointed.
            try:
                staged = self._next_batch(it)
                if staged is not None:
                    self.staged_ahead += 1
            finally:
                t0 = self._settle(pending, on_result, t0)
        self._settle(pending, on_result, t0)
        return self._stats()
