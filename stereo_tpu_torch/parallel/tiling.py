"""Halo-exchange tile parallelism on a grid of tiles.

Twin of ``stereo_tpu/parallel/tiling.py``. The H x W frame is cut into a
ty x tx grid of blocks; each tile matches its block extended by halo
strips from its neighbours. The halo serves the window support of the cost,
the SGM warm-up (paths enter the block with settled costs) and the
disparity search (the cost at column x reads the right image at x - d, so
the low-side x halo is widened by D, and the high side too when an LR check
reads rightward). Positions outside the frame are remapped to the nearest
in-frame pixel and SGM paths start fresh at the tile's in-frame rectangle
(``compute_disparity``'s rectangular-tile mode), so carries reset at the
true frame edges only. Two regimes, as the reference: the legacy one
(``make_tile_fn``) and the stitched one (``make_stitched_tile_fn``), whose
tiles carry only the warm-up halo and reassemble the cheap LR check from
thin strips of their neighbours' right-view partial minima.

A tile body is written as stages, each a function of the tile index
(iy, ix) and its tensors, with exchanges between them through a grid
object (``LocalGrid``, ``DistributedGrid``):

  * ``permute(vals, axis, k, fill)`` gives each tile the value of the tile
    k steps before it along ``axis`` (``fill`` where there is none): the
    reference's ``ppermute`` with its zero fill for strips with no source;
  * ``gather(blocks)`` assembles the [bh, bw] blocks of every tile into the
    replicated frame, as the reference's replicated ``out_shardings``.

The local grid runs every tile in one process, one after another, a halo
strip being a slice of the neighbour's block (one card). The distributed
grid runs one tile per ``torch.distributed`` rank and exchanges strips
with point-to-point sends and receives, then all-gathers the blocks. Both
give the same bits (``tests/test_torch_tiling.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import StereoConfig, TileConfig
from ..ops.cuda import median3x3
from ..ops.postprocess import (
    BIG,
    lr_gate_from_right_map,
    median_3x3,
    unpack_partial_min,
)
from ..pipeline import (
    PatchParts,
    StereoResult,
    compute_disparity,
    compute_patch_parts,
    use_kernels,
)
from .mesh import TileMesh

Tile = Tuple[int, int]
#: Per-tile values of one stage: tile index (iy, ix) -> tensor.
Vals = Dict[Tile, torch.Tensor]


class LocalGrid:
    """Every tile of batch replica ``b``'s grid in this process; tile
    (iy, ix) runs on ``mesh.device(b, iy, ix)``."""

    def __init__(self, mesh: TileMesh, b: int = 0):
        self.ty, self.tx = mesh.ty, mesh.tx
        self.tiles = [(iy, ix) for iy in range(self.ty)
                      for ix in range(self.tx)]
        self.devices = {t: mesh.device(b, *t) for t in self.tiles}

    def map(self, fn: Callable, *vals: Vals) -> Dict[Tile, object]:
        """``fn((iy, ix), *tensors of that tile)`` for each tile here."""
        return {t: fn(t, *(v[t] for v in vals)) for t in self.tiles}

    def permute(self, vals: Vals, axis: int, k: int, fill: float = 0
                ) -> Vals:
        out = {}
        for t in self.tiles:
            src = _step(t, axis, -k)
            if src in vals:
                out[t] = vals[src].to(self.devices[t])
            else:
                out[t] = torch.full_like(vals[t], fill)
        return out

    def gather(self, blocks: Vals) -> torch.Tensor:
        return torch.cat([
            torch.cat([blocks[(iy, ix)] for ix in range(self.tx)], dim=1)
            for iy in range(self.ty)])


class DistributedGrid:
    """This rank's tile of a grid spread one tile per rank over the
    ``torch.distributed`` process group: rank r is replica r // (ty * tx)
    and tile r % (ty * tx) in row-major order, on ``mesh``'s device r."""

    def __init__(self, mesh: TileMesh):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a distributed tile grid needs the torch.distributed "
                "process group (initialize_multihost)")
        n = mesh.batch * mesh.ty * mesh.tx
        if dist.get_world_size() != n:
            raise RuntimeError(f"a {mesh.batch}x{mesh.ty}x{mesh.tx} grid "
                               f"needs {n} ranks, got {dist.get_world_size()}")
        self.ty, self.tx = mesh.ty, mesh.tx
        rank = dist.get_rank()
        self.base = rank - rank % (self.ty * self.tx)  # replica's rank 0
        t = divmod(rank - self.base, self.tx)
        self.tiles = [t]
        self.device = mesh.devices[rank]
        self.devices = {t: self.device}

    map = LocalGrid.map

    def _rank(self, t: Tile) -> int:
        return self.base + t[0] * self.tx + t[1]

    def permute(self, vals: Vals, axis: int, k: int, fill: float = 0
                ) -> Vals:
        (t, own), = vals.items()
        own = own.contiguous()
        dst, src = _step(t, axis, k), _step(t, axis, -k)
        ops, got = [], torch.full_like(own, fill)
        if self._inside(dst):
            ops.append(dist.isend(own, self._rank(dst)))
        if self._inside(src):
            ops.append(dist.irecv(got, self._rank(src)))
        for op in ops:
            op.wait()
        return {t: got}

    def _inside(self, t: Tile) -> bool:
        return 0 <= t[0] < self.ty and 0 <= t[1] < self.tx

    def gather(self, blocks: Vals) -> torch.Tensor:
        """This replica's frame: one all-gather over the whole process
        group, of which the replica's own ranks' blocks are assembled.
        Every rank of every replica joins each call, in the same order, so
        no process group per replica is needed (those would have to be
        made by every rank, for every replica, before the first frame);
        the price is that each rank receives every replica's blocks."""
        (_, own), = blocks.items()
        dtype = own.dtype
        send = own.to(torch.uint8) if dtype == torch.bool else own
        parts = [torch.empty_like(send) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, send.contiguous())
        full = torch.cat([
            torch.cat([parts[self._rank((iy, ix))] for ix in range(self.tx)],
                      dim=1) for iy in range(self.ty)])
        return full.to(dtype)


def _step(t: Tile, axis: int, k: int) -> Tile:
    """The tile k steps after ``t`` along ``axis``."""
    return (t[0] + k, t[1]) if axis == 0 else (t[0], t[1] + k)


def _halo_exchange(grid, vals: Vals, axis: int, lo: int, hi: int) -> Vals:
    """Extend every tile's block along ``axis`` by ``lo`` / ``hi`` rows or
    columns of its neighbours' blocks.

    A halo wider than a block takes strips from k-hop neighbours, one
    permute per hop. Strips with no source (the frame's edge, or hops past
    the grid) arrive zero-filled; the caller's in-frame test remaps them
    to edge replicas."""
    block = next(iter(vals.values())).shape[axis]

    def strips(total: int, from_prev: bool):
        out, k, remaining = [], 1, total
        while remaining > 0:
            size = min(block, remaining)
            start = block - size if from_prev else 0
            edge = {t: v.narrow(axis, start, size) for t, v in vals.items()}
            out.append(grid.permute(edge, axis, k if from_prev else -k))
            remaining -= size
            k += 1
        return out

    parts = []
    if lo > 0:
        parts.extend(reversed(strips(lo, from_prev=True)))
    parts.append(vals)
    if hi > 0:
        parts.extend(strips(hi, from_prev=False))
    if len(parts) == 1:
        return vals
    return {t: torch.cat([p[t] for p in parts], dim=axis) for t in vals}


def _clamped(extent: int, origin: int, n: int, device) -> torch.Tensor:
    """Block-local indices of ``n`` positions from global ``origin``,
    each clamped into the frame [0, extent)."""
    pos = origin + torch.arange(n, device=device)
    return pos.clamp(0, extent - 1) - origin


def _cropped_median(grid, cfg: StereoConfig, disp: Vals, bh: int, bw: int,
                    h: int, w: int) -> Vals:
    """3x3 median on each CROPPED tile with a 1-px neighbour disparity
    halo, edges replicated at the frame's edges as the whole frame's median
    replicates them (on CUDA tensors K4, ``median3x3``)."""
    e = _halo_exchange(grid, disp, 0, 1, 1)
    e = _halo_exchange(grid, e, 1, 1, 1)

    def body(t, ext):
        iy, ix = t
        ys = _clamped(h, iy * bh - 1, bh + 2, ext.device)
        xs = _clamped(w, ix * bw - 1, bw + 2, ext.device)
        ext = ext[ys][:, xs].contiguous()
        median = median3x3 if use_kernels(cfg, ext.device) else median_3x3
        return median(ext)[1:-1, 1:-1]

    return grid.map(body, e)


def _in_frame(iy: int, ix: int, bh: int, bw: int, h: int, w: int, device
              ) -> torch.Tensor:
    """[bh, bw] bool: the block's pixels inside the h x w frame."""
    ys = iy * bh + torch.arange(bh, device=device)[:, None]
    xs = ix * bw + torch.arange(bw, device=device)[None, :]
    return (ys < h) & (xs < w)


def _halo_widths(cfg: StereoConfig, tile_cfg: TileConfig
                 ) -> Tuple[int, int, int]:
    """(halo_y, halo_x_lo, halo_x_hi) in pixels."""
    halo = tile_cfg.resolved_halo(cfg)
    reach = cfg.num_disparities + int(cfg.min_disparity)
    x_lo = halo + reach                   # cost needs right(x - md - d)
    # Both LR modes read rightward across the tile edge: the cheap re-index
    # restacks S at x + md + d, the exact flipped pass searches left
    # samples at x + md + d.
    x_hi = halo + (reach if cfg.lr_check else 0)
    return halo, x_lo, x_hi


def stitch_supported(cfg: StereoConfig, bw: int,
                     halo: Optional[int] = None) -> bool:
    """Whether the warm-up-only stitched tile regime applies: census or
    rank costs, the cheap LR check, SGM paths, tiles at least D + md wide
    (a right-view position's sources then straddle at most two tiles) and,
    when ``halo`` is given, a halo covering the descriptor window radius
    (the owned columns' partials are then frame-true)."""
    return (
        cfg.lr_check
        and not cfg.lr_exact
        and cfg.num_paths > 0
        and cfg.cost_fn in ("census", "rank")
        and bw >= cfg.num_disparities + int(cfg.min_disparity)
        and (halo is None or halo >= cfg.window_radius)
    )


def padded_extent(size: int, tiles: int) -> int:
    """Smallest multiple of ``tiles`` >= size."""
    return -(-size // tiles) * tiles


def make_tile_fn(cfg: StereoConfig, h: int, w: int, bh: int, bw: int,
                 halo_y: int, halo_x_lo: int, halo_x_hi: int):
    """The legacy tile body: ``(grid, left blocks, right blocks) -> (disp,
    valid)`` blocks. Each tile extends its block by the halos, runs the
    pipeline on it as a rectangular tile of the frame (median off), crops
    its block and takes the median on the crop (``_cropped_median``)."""
    cfg_tile = cfg.replace(median_filter=False)
    ew = bw + halo_x_lo + halo_x_hi

    def tile_fn(grid, left: Vals, right: Vals):
        def extend(vals):
            e = _halo_exchange(grid, vals, 0, halo_y, halo_y)
            return _halo_exchange(grid, e, 1, halo_x_lo, halo_x_hi)

        def body(t, l_ext, r_ext):
            iy, ix = t
            y0, x0 = iy * bh - halo_y, ix * bw - halo_x_lo
            # Out-of-frame halo positions (zero-filled at the frame's
            # edges) are remapped to the nearest in-frame pixel, so window
            # ops see the untiled pipeline's edge-replicated borders.
            ys = _clamped(h, y0, bh + 2 * halo_y, l_ext.device)
            xs = _clamped(w, x0, ew, l_ext.device)
            res = compute_disparity(
                l_ext[ys][:, xs], r_ext[ys][:, xs], cfg_tile, x_offset=x0,
                image_width=w, y_offset=y0, image_height=h)
            rows = slice(halo_y, halo_y + bh)
            cols = slice(halo_x_lo, halo_x_lo + bw)
            valid = res.valid[rows, cols] & _in_frame(
                iy, ix, bh, bw, h, w, l_ext.device)
            return res.disp[rows, cols].contiguous(), valid

        out = grid.map(body, extend(left), extend(right))
        return _finish(grid, cfg, out, bh, bw, h, w)

    return tile_fn


def _finish(grid, cfg, out, bh, bw, h, w):
    """Per-tile (disp, valid) -> (disp, valid) blocks, the median taken on
    the crops."""
    disp = {t: o[0] for t, o in out.items()}
    valid = {t: o[1] for t, o in out.items()}
    if cfg.median_filter:
        disp = _cropped_median(grid, cfg, disp, bh, bw, h, w)
    return disp, valid


def make_stitched_tile_fn(cfg: StereoConfig, h: int, w: int, bh: int,
                          bw: int, halo: int):
    """The stitched tile body: a warm-up-only x overlap.

    The SGM domain carries only the warm-up halo; the cost reads
    ctx = D - 1 + md frame-true right-image columns (exchanged image bytes,
    not volume work). Each tile emits its packed right-view partial min
    over the columns it owns, plus its left spill (``compute_patch_parts``);
    neighbours exchange three thin strips along 'tx' (the previous tile's
    qr tail, the next tile's spill tail and qr head, O(D) columns each) and
    each tile min-assembles the frame-exact right-view map over the
    positions its LR lookups can reach. Pixels within D + md of a tile edge
    get their LR verdict from that map; elsewhere the tile's own verdict is
    already frame-true.
    """
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    ctx = d - 1 + md
    reach = d + md
    cfg_tile = cfg.replace(median_filter=False)
    rows = slice(halo, halo + bh)

    def tile_fn(grid, left: Vals, right: Vals):
        def extend(vals, x_lo):
            e = _halo_exchange(grid, vals, 0, halo, halo)
            return _halo_exchange(grid, e, 1, x_lo, halo)

        def parts(t, l_ext, r_ext):
            iy, ix = t
            y0, x0 = iy * bh - halo, ix * bw - halo
            dev = l_ext.device
            ys = _clamped(h, y0, bh + 2 * halo, dev)
            p = compute_patch_parts(
                l_ext[ys][:, _clamped(w, x0, bw + 2 * halo, dev)],
                r_ext[ys][:, _clamped(w, x0 - ctx, bw + 2 * halo + ctx,
                                      dev)],
                cfg_tile, x_offset=x0, image_width=w, right_context=ctx,
                own=(halo, halo + bw), y_offset=y0, image_height=h)
            return PatchParts(*(m[rows] for m in p))

        got = grid.map(parts, extend(left, halo), extend(right, halo + ctx))
        qr = {t: p.qr for t, p in got.items()}
        spill = {t: p.spill for t, p in got.items()}
        sp = next(iter(spill.values())).shape[1]

        # The assembled right-view packed-min map of a tile covers the
        # positions [ix * bw - reach, (ix + 1) * bw), every frame column
        # counted once by its owning tile. k: positions below the tile's
        # extended block, reachable only through spills. Positions below
        # -SP have no in-tile source, so when k > SP the map's leading
        # k - SP columns come from the previous tile only and start BIG.
        k = reach - halo
        nh = min(halo, bw + reach)
        ke = min(k, sp)
        prev_tail = grid.permute(
            {t: q[:, halo + bw - reach:halo + bw] for t, q in qr.items()},
            1, 1, BIG)
        next_head = grid.permute(
            {t: q[:, halo - nh:halo] for t, q in qr.items()}, 1, -1, BIG)
        next_spill = grid.permute(
            {t: s[:, sp - ke:] for t, s in spill.items()}, 1, -1, BIG
        ) if k > 0 else None

        def stitch(t, p):
            iy, ix = t
            if k > 0:
                lead = torch.full((bh, k - ke), BIG, dtype=torch.float32,
                                  device=p.qr.device)
                emap = torch.cat([lead, p.spill[:, sp - ke:],
                                  p.qr[:, :bw + halo]], dim=1)
                seg = emap[:, bw + k - ke:bw + k]
                emap[:, bw + k - ke:bw + k] = torch.minimum(
                    seg, next_spill[t])
            else:
                emap = p.qr[:, -k:bw + halo].clone()
            emap[:, :reach] = torch.minimum(emap[:, :reach], prev_tail[t])
            tail = emap[:, bw + reach - nh:]
            emap[:, bw + reach - nh:] = torch.minimum(tail, next_head[t])
            d_r = unpack_partial_min(emap, d)
            cols = slice(halo, halo + bw)
            d0, lr_bit = p.d0[:, cols], p.lr_bit[:, cols]

            def regate(lo, hi):
                return lr_gate_from_right_map(
                    d0[:, lo:hi], d_r, cfg, x_offset=ix * bw + lo,
                    image_width=w, r_offset=ix * bw - reach)

            if bw <= 2 * reach:
                gate = regate(0, bw)
            else:
                gate = torch.cat([regate(0, reach),
                                  lr_bit[:, reach:bw - reach],
                                  regate(bw - reach, bw)], dim=1)
            valid = p.ok_nolr[:, cols] & gate & _in_frame(
                iy, ix, bh, bw, h, w, gate.device)
            return p.disp[:, cols].contiguous(), valid

        out = grid.map(stitch, got)
        return _finish(grid, cfg, out, bh, bw, h, w)

    return tile_fn


def make_grid(mesh: TileMesh, b: int = 0):
    """The exchange object of batch replica ``b``'s tile grid: its local
    grid, or on a distributed mesh this rank's tile (whose replica the
    rank fixes)."""
    return DistributedGrid(mesh) if mesh.distributed else LocalGrid(mesh, b)


def tile_body(cfg: StereoConfig, tile_cfg: TileConfig, ty: int, tx: int,
              h: int, w: int, lr_stitch: Optional[bool], refusal: str):
    """``(tile_fn, bh, bw)`` for h x w frames on a ty x tx grid: the block
    shape of the frame padded to tile multiples, and its tile body, None
    on a trivial grid (1 x 1 without padding: the whole frame runs). The
    body is the stitched one where ``lr_stitch`` asks for it (None: where
    tx > 1 and ``stitch_supported``), else the legacy one; ``lr_stitch=True``
    where the stitched body does not apply raises ValueError(refusal)."""
    hp, wp = padded_extent(h, ty), padded_extent(w, tx)
    bh, bw = hp // ty, wp // tx
    halo_y, halo_x_lo, halo_x_hi = _halo_widths(cfg, tile_cfg)
    halo = tile_cfg.resolved_halo(cfg)
    trivial = ty == 1 and tx == 1 and (hp, wp) == (h, w)
    stitch = lr_stitch
    if stitch is None:
        stitch = not trivial and tx > 1 and stitch_supported(cfg, bw, halo)
    elif stitch and (trivial or not stitch_supported(cfg, bw, halo)):
        raise ValueError(refusal)
    if trivial:
        return None, bh, bw
    if stitch:
        return make_stitched_tile_fn(cfg, h, w, bh, bw, halo), bh, bw
    return (make_tile_fn(cfg, h, w, bh, bw, halo_y, halo_x_lo, halo_x_hi),
            bh, bw)


def pad_frames(img: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """``img`` [..., H, W] padded with zeros below and to the right to
    [..., hp, wp] (itself when it has that shape)."""
    h, w = img.shape[-2:]
    if (h, w) == (hp, wp):
        return img
    return torch.nn.functional.pad(img, (0, wp - w, 0, hp - h))


def run_tiles(grid, tile_fn, left: torch.Tensor, right: torch.Tensor,
              bh: int, bw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame padded to the grid, [ty * bh, tx * bw], through ``tile_fn``:
    this process's tiles take their blocks on their devices, and the
    gathered (disp, valid) of the padded frame come back."""
    def blocks(img):
        return {(iy, ix): img[iy * bh:(iy + 1) * bh,
                              ix * bw:(ix + 1) * bw].to(grid.devices[iy, ix])
                for iy, ix in grid.tiles}

    disp, valid = tile_fn(grid, blocks(left), blocks(right))
    return grid.gather(disp), grid.gather(valid)


def build_halo_pipeline(
    cfg: StereoConfig,
    mesh: TileMesh,
    tile_cfg: Optional[TileConfig] = None,
    lr_stitch: Optional[bool] = None,
    device="cuda",
):
    """``(left, right) -> StereoResult`` over the tile grid of ``mesh``.

    Accepts any [H, W] pair (numpy arrays or tensors); the frame is padded
    with zeros to tile multiples, the padding is masked invalid and cropped
    from the output. Batch replica 0's grid runs the frame; on a
    distributed mesh every rank passes the whole pair and gets the whole
    (replicated) frame. The result stays on ``device``.

    ``lr_stitch`` (None = auto): the stitched regime
    (``make_stitched_tile_fn``) where ``tx > 1`` and ``stitch_supported``
    holds; True forces it (and raises where it does not apply), False takes
    the legacy regime.
    """
    tile_cfg = tile_cfg or TileConfig(mesh_shape=(mesh.ty, mesh.tx))
    device = torch.device(device)

    def tiled(left, right) -> StereoResult:
        grid = make_grid(mesh)
        left, right = torch.as_tensor(left), torch.as_tensor(right)
        if left.ndim != 2 or left.shape != right.shape:
            raise ValueError(f"expected two [H, W] images, got "
                             f"{tuple(left.shape)} and {tuple(right.shape)}")
        h, w = left.shape
        tile_fn, bh, bw = tile_body(
            cfg, tile_cfg, mesh.ty, mesh.tx, h, w, lr_stitch,
            "lr_stitch needs a non-trivial tile grid, the cheap-LR "
            "re-index (lr_check without lr_exact), SGM paths, a "
            "census/rank cost, tiles at least D + min_disparity "
            "wide, and a halo covering the descriptor window radius")
        if tile_fn is None:
            dev = grid.devices[(0, 0)]
            res = compute_disparity(left.to(dev), right.to(dev), cfg)
            return StereoResult(res.disp.to(device), res.valid.to(device))
        hp, wp = mesh.ty * bh, mesh.tx * bw
        disp, valid = run_tiles(grid, tile_fn, pad_frames(left, hp, wp),
                                pad_frames(right, hp, wp), bh, bw)
        return StereoResult(disp=disp[:h, :w].to(device),
                            valid=valid[:h, :w].to(device))

    return tiled
