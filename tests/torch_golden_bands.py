"""A banded run of the reference's golden ops, for frames whose whole
golden call does not fit in a CPU's memory.

``golden_banded(left, right, cfg, row_bands, col_bands)`` returns
``(disp, valid)`` as numpy arrays, bit for bit those of
``stereo_tpu.pipeline.pipeline.compute_disparity(left, right,
cfg.replace(backend="jnp"))`` for a whole-frame call (no ``valid``,
``constrain`` or offsets): census or rank cost, 4 or 8 paths, fixed or
adaptive P2, the cheap LR check, subpixel, uniqueness and the median.

It computes nothing itself. It calls the reference's own functions on
pieces of the frame and keeps the pieces in numpy, split as
``stereo_tpu.ops.sgm.sgm_aggregate`` splits the paths into families:

- the cost, ``stereo_tpu.ops.cost.cost_volume`` (the golden branch of the
  pipeline's ``_build_cost``), on row bands that carry the census
  window's halo rows (none at the frame's edge: the transform replicates
  the frame's edge, ``stereo_tpu/ops/census.py:33-34``), cropped to the
  band and kept in the narrowest unsigned dtype that holds it;
- the horizontal pair, ``sgm._horizontal`` forward and reverse, on row
  bands; the vertical pair, ``sgm._vertical``, on column bands;
- each diagonal pair: ``sgm._shear`` of the narrow cost, the validity
  (``_shear(v)[0] & v_geom``) and, under adaptive P2, the image, then
  ``_vertical`` both ways on column bands of the sheared volume, then
  ``sgm._unshear`` on row bands of the sheared sum (a row band of the
  unsheared frame reads a row band of the sheared one, shifted by
  ``H - y1`` columns for sign +1 and ``y0`` for sign -1);
- the sum S of every family in one int32 array;
- ``wta.wta_with_aux`` then ``postprocess.apply_postprocess`` without the
  median on row bands of S. The cheap LR check reads along a row only:
  ``right_disparity_from_volume`` shifts each disparity plane along axis 1
  (``stereo_tpu/ops/postprocess.py:55``) and ``lr_consistency`` shifts the
  right map along axis 1 (``stereo_tpu/ops/postprocess.py:262``);
- ``postprocess.median_3x3`` once on the assembled frame, as
  ``apply_postprocess``'s last step, which reads only ``disp``.

Each piece goes through one jitted call of the reference function; every
piece is cast to int32 inside that call, as the golden path's volume is.
Nothing here has to be fast, only to fit: ``default_bands`` sizes the
bands so that one call holds a bounded slice of the volume.

Usage (the fixture script): ``python tests/test_torch_fixture.py
--banded-golden NAME [--bands R C]``.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from stereo_tpu.ops import sgm
from stereo_tpu.ops.cost import cost_volume
from stereo_tpu.ops.postprocess import apply_postprocess, median_3x3
from stereo_tpu.ops.wta import wta_with_aux

#: A count of near-equal bands, or the bands' sizes in order.
Bands = Union[int, Sequence[int]]

#: Voxels of one band that one family's call may hold. The whole golden
#: path holds about 22.2 KiB a pixel at D=256, about 89 bytes a voxel;
#: one family's call holds a fraction of that on a band, so 2^26 voxels
#: keep a call to a few GiB.
BAND_VOXELS = 1 << 26


def default_bands(shape: Tuple[int, int], num_disparities: int
                  ) -> Tuple[int, int]:
    """(row bands, column bands) that keep one call under BAND_VOXELS
    voxels: a row band spans the frame's width, a column band its
    height."""
    h, w = shape
    rows = max(1, BAND_VOXELS // (w * num_disparities))
    cols = max(1, BAND_VOXELS // (h * num_disparities))
    return math.ceil(h / rows), math.ceil(w / cols)


def _bounds(n: int, bands: Bands) -> List[Tuple[int, int]]:
    """[(start, stop)] of ``bands`` over ``n``: a count splits it into
    near-equal bands, a sequence gives the sizes, which sum to ``n``."""
    if isinstance(bands, int):
        sizes = [len(a) for a in np.array_split(np.arange(n), bands)]
    else:
        sizes = list(bands)
    if sum(sizes) != n or min(sizes) < 1:
        raise ValueError(f"band sizes {sizes} do not tile {n}")
    stops = np.cumsum(sizes).tolist()
    return list(zip([0] + stops[:-1], stops))


def _narrow(a, dtype) -> np.ndarray:
    """``a`` in ``dtype``, which must hold each of its values."""
    a = np.asarray(a)
    info = np.iinfo(dtype)
    if a.size and (a.min() < info.min or a.max() > info.max):
        raise ValueError(f"values in [{a.min()}, {a.max()}] overflow {dtype}")
    return a.astype(dtype)


@functools.lru_cache(maxsize=None)
def _calls(cfg):
    """The reference functions on pieces, one jitted call each."""

    def pair(scan):
        def both(c, v, i):
            c = c.astype(jnp.int32)
            return (scan(c, v, i, cfg, reverse=False)
                    + scan(c, v, i, cfg, reverse=True))
        return jax.jit(both)

    def select(s):
        disp, ok, d_int = wta_with_aux(s, cfg)
        return apply_postprocess(disp, ok, s,
                                 cfg.replace(median_filter=False),
                                 disp_int=d_int)

    return dict(
        cost=jax.jit(lambda l, r: cost_volume(l, r, cfg)),
        horizontal=pair(sgm._horizontal),
        vertical=pair(sgm._vertical),
        shear={s: jax.jit(functools.partial(sgm._shear, sign=s))
               for s in (1, -1)},
        unshear={s: jax.jit(lambda x, w, s=s: sgm._unshear(
            x.astype(jnp.int32), s, w), static_argnums=1) for s in (1, -1)},
        select=jax.jit(select),
        median=jax.jit(median_3x3),
    )


def golden_banded(left, right, cfg, row_bands: Bands = 1,
                  col_bands: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's golden whole-frame result on ``(left, right)``,
    computed in bands: ``row_bands`` for the cost, the horizontal paths,
    the unshear and the selection, ``col_bands`` near-equal bands of the
    frame's width for the vertical paths and of the sheared width for the
    diagonal ones. Returns (disp float32 [H, W], valid bool [H, W])."""
    cfg = cfg.replace(backend="jnp")
    if cfg.cost_fn not in ("census", "rank") or cfg.num_paths not in (4, 8):
        raise NotImplementedError("census or rank cost with 4 or 8 paths")
    if cfg.lr_check and cfg.lr_exact:
        raise NotImplementedError("the exact LR check's second pass")
    left, right = np.asarray(left), np.asarray(right)
    h, w = left.shape
    d = cfg.num_disparities
    calls = _calls(cfg)
    rows = _bounds(h, row_bands)
    ry = cfg.census_window[0] // 2
    narrow = np.uint8 if cfg.max_unary_cost <= 255 else np.uint16

    c = np.empty((h, w, d), narrow)
    for y0, y1 in rows:
        a, b = max(0, y0 - ry), min(h, y1 + ry)
        band = calls["cost"](left[a:b], right[a:b])
        c[y0:y1] = _narrow(band[y0 - a:y1 - a], narrow)
        del band

    valid = np.ones((h, w), bool)
    img = left.astype(np.int32) if cfg.adaptive_p2 else None

    def part(x, sl):
        return None if x is None else x[sl]

    s = np.empty((h, w, d), np.int32)
    for y0, y1 in rows:
        rs = np.s_[y0:y1]
        s[rs] = calls["horizontal"](c[rs], valid[rs], part(img, rs))
    for x0, x1 in _bounds(w, col_bands):
        cs = np.s_[:, x0:x1]
        s[cs] += np.asarray(calls["vertical"](c[cs], valid[cs],
                                              part(img, cs)))
    if cfg.num_paths == 8:
        wp = w + h - 1
        for sign in (1, -1):
            c_sh, v_geom = calls["shear"][sign](c)
            c_sh = np.asarray(c_sh)
            v_sh = np.asarray(calls["shear"][sign](valid)[0] & v_geom)
            i_sh = (None if img is None
                    else np.asarray(calls["shear"][sign](img)[0]))
            d_out = np.empty((h, wp, d), np.int16)
            for x0, x1 in _bounds(wp, col_bands):
                cs = np.s_[:, x0:x1]
                d_out[cs] = _narrow(calls["vertical"](
                    c_sh[cs], v_sh[cs], part(i_sh, cs)), np.int16)
            del c_sh
            for y0, y1 in rows:
                x0 = h - y1 if sign > 0 else y0
                band = d_out[y0:y1, x0:x0 + w + (y1 - y0) - 1]
                s[y0:y1] += np.asarray(calls["unshear"][sign](band, w))
            del d_out
    del c

    disp = np.empty((h, w), np.float32)
    ok = np.empty((h, w), bool)
    for y0, y1 in rows:
        disp[y0:y1], ok[y0:y1] = calls["select"](s[y0:y1])
    del s
    if cfg.median_filter:
        disp = np.asarray(calls["median"](disp))
    return disp, ok
