"""Exact multi-tile pipeline: the reference's reshard mode, as an SPMD
program over the tile grid.

Twin of ``stereo_tpu/parallel/exact.py``. SGM's pass families want
conflicting layouts: the horizontals want whole rows on a tile, the
verticals whole columns, the diagonals whole columns of the sheared volume
(``ops.sgm._shear``). The reference annotates the inputs of each family
with a sharding constraint and lets XLA insert the all-to-all between
them. Nothing inserts collectives in PyTorch, so here the program is
written out, over the n = ty * tx tiles of a grid in row-major order
(``LocalGrid`` on one process, ``DistributedGrid`` one rank per tile):

  1. cost on row band i: every tile holds the whole pair; K1's transform
     stage runs on the band's rows plus the window's vertical radius and
     its cost stage on the band's rows of words, or K5 on the band plus
     its radius, cropped (the frame's edge rule holds at a band on the
     frame's edge);
  2. the horizontals: K2 on the row band's two horizontal steps;
  3. the verticals: an all-to-all of C to column bands, K2 on their two
     vertical steps, an all-to-all of the sums back to the row bands;
  4. the diagonals (8 paths), for each shear sign: an all-to-all of C to
     bands of the sheared volume's W + H - 1 columns (each sender cuts its
     rows' windows, source columns clipped as ``_shear`` clips them), K2's
     sheared form on the two vertical steps, the sums back to the row
     bands, unsheared and added;
  5. selection on row band i: K3 (WTA, subpixel, uniqueness and the cheap
     LR re-index all stay within a row); ``lr_exact`` runs steps 1-4 on the
     flipped pair and compares integer winners, as ``pipeline._kernel_path``
     does;
  6. the row bands' disparity and validity gathered to the whole frame on
     every rank, then K4's median on the whole frame.

Every scan runs whole and on one tile, so the result is bit-identical to
the whole frame (the reference's invariant). Bands may be uneven (375 rows
do not split into 4); nothing is padded, since padding would change the
scans. On CUDA tensors every compute step is a kernel (K1 or K5, K2's
subset and sheared forms, K3, K4); plain torch only moves, slices,
concatenates and adds: the all-to-all chunks, the shear windows, the sums
of the families. On CPU tensors the same program runs the wrappers' plain
twins.

``dplane_cost=True`` is the reference's disparity-plane cost: tile i
builds the whole frame's cost over its slab of the D planes (K1's cost
stage or K5 with ``num_disparities`` the slab's and ``min_disparity``
shifted to its first plane; the frame-edge fill depends on the absolute
disparity only, so the planes are the whole volume's), and an all-to-all
turns the slabs into row bands with every plane, after which the program
goes on from step 2. With ``num_paths=0`` the row bands go straight to
selection; the reference keeps D sharded through its WTA there, with the
same bits.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..config import StereoConfig
from ..ops.cuda import (
    census_cost,
    median3x3,
    rank_cost,
    sad_cost,
    sgm_paths,
    sgm_select,
    transform_words,
)
from ..ops.postprocess import lr_consistency
from ..ops.sgm import H_STEPS, V_STEPS, shear_window, unshear_rows
from ..pipeline import StereoResult, compute_disparity, use_kernels
from .mesh import TileMesh
from .tiling import make_grid

def band_bounds(size: int, n: int) -> List[Tuple[int, int]]:
    """``size`` split into ``n`` bands [lo, hi) in order, the first
    ``size % n`` one longer (some empty where ``size < n``)."""
    q, r = divmod(size, n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


class ExactPlan(NamedTuple):
    """The bands of an h x w frame over n tiles: rows, columns, sheared
    columns (of w + h - 1) and disparity slabs of d planes."""

    h: int
    w: int
    rows: List[Tuple[int, int]]
    cols: List[Tuple[int, int]]
    sheared: List[Tuple[int, int]]
    slabs: List[Tuple[int, int]]


def _len(band: Tuple[int, int]) -> int:
    return band[1] - band[0]


def plan_exact(h: int, w: int, d: int, n: int) -> ExactPlan:
    return ExactPlan(h, w, band_bounds(h, n), band_bounds(w, n),
                     band_bounds(w + h - 1, n), band_bounds(d, n))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it is not contiguous or does not start
    on a 16-byte boundary (a kernel's input)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _rows_with_radius(y0: int, y1: int, radius: int, h: int):
    """The rows [e0, e1) a band [y0, y1) reads through a window of
    vertical ``radius``, clipped to the frame."""
    return max(y0 - radius, 0), min(y1 + radius, h)


def band_cost(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
              y0: int, y1: int) -> torch.Tensor:
    """The cost volume's rows [y0, y1) of the whole [H, W] pair: K5 on the
    band plus its window's vertical radius, cropped; or K1's transform
    stage on those rows and its cost stage on the band's rows of words."""
    h = left.shape[0]
    if cfg.cost_fn == "sad":
        e0, e1 = _rows_with_radius(y0, y1, cfg.sad_window[0] // 2, h)
        vol = sad_cost(left[e0:e1], right[e0:e1], cfg)
        return _aligned(vol[y0 - e0:y1 - e0])
    rank = cfg.cost_fn == "rank"
    e0, e1 = _rows_with_radius(y0, y1, cfg.census_window[0] // 2, h)
    wl, wr = (_aligned(transform_words(img[e0:e1], cfg.census_window,
                                       rank=rank)[y0 - e0:y1 - e0])
              for img in (left, right))
    return (rank_cost if rank else census_cost)(wl, wr, cfg)


def slab_cost(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
              d0: int, d1: int) -> torch.Tensor:
    """The whole frame's cost over the disparity planes [d0, d1): K1 (both
    stages) or K5 with D = d1 - d0 and ``min_disparity`` moved to plane
    d0; an empty slab launches nothing."""
    h, w = left.shape
    if d1 == d0:
        return torch.empty((h, w, 0), dtype=cfg.cost_volume_dtype,
                           device=left.device)
    cfg_s = cfg.replace(num_disparities=d1 - d0,
                        min_disparity=cfg.min_disparity + d0)
    if cfg.cost_fn == "sad":
        return sad_cost(left, right, cfg_s)
    rank = cfg.cost_fn == "rank"
    wl, wr = (transform_words(img, cfg.census_window, rank=rank)
              for img in (left, right))
    return (rank_cost if rank else census_cost)(wl, wr, cfg_s)


class _Program:
    """One replica's program over its grid, for one h x w frame."""

    def __init__(self, cfg: StereoConfig, grid, plan: ExactPlan,
                 dplane: bool):
        self.cfg, self.grid, self.plan, self.dplane = cfg, grid, plan, dplane
        self.index = {t: i for i, t in enumerate(grid.order)}

    def _reshard(self, parts, shape):
        """``parts(src, dst)`` is the chunk tile src sends to tile dst, of
        ``shape(i_src, i_dst)`` by the tiles' indices in the plan's bands;
        returns each tile of this process's chunks by source, in order."""
        idx = self.index
        got = self.grid.all_to_all(
            {t: {u: parts(t, u) for u in self.grid.order}
             for t in self.grid.tiles},
            lambda t, u: shape(idx[t], idx[u]))
        return {t: list(got[t].values()) for t in self.grid.tiles}

    def cost(self, ref, tgt) -> Dict:
        """Each tile's row band of the cost volume."""
        p, cfg = self.plan, self.cfg
        if not self.dplane:
            return {t: band_cost(ref[t], tgt[t], cfg,
                                 *p.rows[self.index[t]])
                    for t in self.grid.tiles}
        slab = {t: slab_cost(ref[t], tgt[t], cfg, *p.slabs[self.index[t]])
                for t in self.grid.tiles}
        got = self._reshard(
            lambda t, u: slab[t][slice(*p.rows[self.index[u]])],
            lambda i, j: (_len(p.rows[j]), p.w, _len(p.slabs[i])))
        return {t: torch.cat(parts, dim=2) for t, parts in got.items()}

    def sums(self, ref, tgt) -> Dict:
        """Each tile's row band of S (int16): the cost, then the path
        families (for num_paths=0 the cost itself)."""
        cfg, p, idx = self.cfg, self.plan, self.index
        cost = self.cost(ref, tgt)
        if cfg.num_paths == 0:
            return {t: c.to(torch.int16) for t, c in cost.items()}
        adaptive = cfg.adaptive_p2

        def image(t, rows=slice(None), cols=slice(None)):
            return ref[t][rows, cols] if adaptive else None

        s = {t: sgm_paths(c, cfg, image=image(t, slice(*p.rows[idx[t]])),
                          steps=H_STEPS)
             for t, c in cost.items()}

        # The verticals on column bands, their sums back to the row bands.
        d = cfg.num_disparities
        got = self._reshard(
            lambda t, u: cost[t][:, slice(*p.cols[idx[u]])],
            lambda i, j: (_len(p.rows[i]), _len(p.cols[j]), d))
        vert = {u: sgm_paths(torch.cat(parts), cfg,
                             image=image(u, cols=slice(*p.cols[idx[u]])),
                             steps=V_STEPS)
                for u, parts in got.items()}
        back = self._reshard(
            lambda u, t: vert[u][slice(*p.rows[idx[t]])],
            lambda j, i: (_len(p.rows[i]), _len(p.cols[j]), d))
        for t, parts in back.items():
            s[t] += torch.cat(parts, dim=1)
        if cfg.num_paths == 4:
            return s

        # The diagonals on bands of the sheared volume, for each sign.
        h, w = p.h, p.w
        for sign in (+1, -1):
            def window(x, y0, u):
                """Sheared band u of the rows [y0, y0 + len(x)) in x."""
                x0, x1 = p.sheared[idx[u]]
                return shear_window(x, y0, h, sign, x0, x1 - x0)

            got = self._reshard(
                lambda t, u: window(cost[t], p.rows[idx[t]][0], u),
                lambda i, j: (_len(p.rows[i]), _len(p.sheared[j]), d))
            diag = {}
            for u, parts in got.items():
                img = window(ref[u], 0, u) if adaptive else None
                diag[u] = sgm_paths(torch.cat(parts), cfg, image=img,
                                    steps=V_STEPS,
                                    shear=(sign, p.sheared[idx[u]][0], w))
            back = self._reshard(
                lambda u, t: diag[u][slice(*p.rows[idx[t]])],
                lambda j, i: (_len(p.rows[i]), _len(p.sheared[j]), d))
            for t, parts in back.items():
                s[t] += unshear_rows(torch.cat(parts, dim=1),
                                     p.rows[idx[t]][0], h, sign, w)
        return s

    def __call__(self, left, right) -> Tuple[torch.Tensor, torch.Tensor]:
        """(disp, valid) of the whole frame; ``left`` and ``right`` hold
        the whole pair on each tile's device."""
        cfg, w = self.cfg, self.plan.w
        if cfg.lr_check and cfg.lr_exact:
            s = self.sums(left, right)
            sel = {t: sgm_select(v, cfg.replace(lr_check=False),
                                 emit_d0=True) for t, v in s.items()}
            del s
            s_r = self.sums({t: v.flip(1) for t, v in right.items()},
                            {t: v.flip(1) for t, v in left.items()})
            cfg_r = cfg.replace(lr_check=False, subpixel=False,
                                uniqueness_ratio=0.0)
            disp, valid = {}, {}
            for t, (d_l, ok, d0) in sel.items():
                disp_rf, _ = sgm_select(s_r[t], cfg_r)
                d_int_l = d0.to(torch.float32) + cfg.min_disparity
                disp[t] = d_l
                valid[t] = ok & lr_consistency(d_int_l, disp_rf.flip(1), cfg,
                                               0, w)
        else:
            s = self.sums(left, right)
            out = {t: sgm_select(v, cfg) for t, v in s.items()}
            disp = {t: o[0] for t, o in out.items()}
            valid = {t: o[1] for t, o in out.items()}
        disp = self.grid.gather_rows(disp, self.plan.rows)
        valid = self.grid.gather_rows(valid, self.plan.rows)
        if cfg.median_filter:
            disp = median3x3(disp)
        return disp, valid


def build_exact_pipeline(
    cfg: StereoConfig,
    mesh: TileMesh,
    donate: bool = False,
    dplane_cost: bool = False,
    device="cuda",
):
    """``(left, right) -> StereoResult`` over the tile grid of ``mesh``,
    bit-identical to the whole frame.

    Accepts any [H, W] pair (numpy arrays or tensors). Every tile takes the
    whole pair to its device; the result is replicated: the caller of a
    local grid, or every rank of a distributed one, gets the whole [H, W]
    frame, on ``device``. Batch replica 0's grid runs the frame on a local
    mesh; on a distributed mesh each replica's ranks run it on their own
    grid, as the reference's 'batch' axis does. A 1 x 1 grid reshards
    nothing: the call is ``compute_disparity`` on the whole frame.

    ``dplane_cost``: the disparity-plane cost (module docstring).
    ``donate`` stands where the reference's does and has no effect
    (PyTorch's caching allocator reuses the frames' memory).

    On CUDA tensors the program runs the kernels (``backend`` "auto" or
    "cuda"); its plain twins run on CPU tensors. ``backend="torch"`` on
    CUDA tensors is refused: this mode has no plain path on the card.
    """
    del donate  # no effect (see above)
    device = torch.device(device)

    def exact(left, right) -> StereoResult:
        grid = make_grid(mesh)
        left, right = torch.as_tensor(left), torch.as_tensor(right)
        if left.ndim != 2 or left.shape != right.shape:
            raise ValueError(f"expected two [H, W] images, got "
                             f"{tuple(left.shape)} and {tuple(right.shape)}")
        if mesh.ty * mesh.tx == 1:
            dev = grid.devices[grid.order[0]]
            res = compute_disparity(left.to(dev), right.to(dev), cfg)
            return StereoResult(res.disp.to(device), res.valid.to(device))
        for dev in grid.devices.values():
            if not use_kernels(cfg, dev) and dev.type != "cpu":
                raise ValueError("the exact mode runs the kernels on CUDA "
                                 "tensors; its plain twins on CPU ones")
        h, w = left.shape
        plan = plan_exact(h, w, cfg.num_disparities, mesh.ty * mesh.tx)
        ref = {t: left.to(grid.devices[t]) for t in grid.tiles}
        tgt = {t: right.to(grid.devices[t]) for t in grid.tiles}
        disp, valid = _Program(cfg, grid, plan, dplane_cost)(ref, tgt)
        return StereoResult(disp.to(device), valid.to(device))

    return exact
