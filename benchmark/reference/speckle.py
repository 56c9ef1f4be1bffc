"""Speckle filter in plain NumPy, for the benchmark's reference.

A speckle is a 4-connected component of valid pixels in which neighbouring
disparities differ by at most ``tau`` (compared in float32); every component
with fewer than ``max_size`` pixels is marked invalid, and the disparities
are left as they are. Components are found by hooking each edge's larger root
under its smaller one and compressing paths until no edge joins two roots.
"""

from __future__ import annotations

import numpy as np


def components(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """[n] root label of each node of the undirected graph with edges
    (u[i], v[i]): the smallest node of its component."""
    parent = np.arange(n)
    while True:
        pu, pv = parent[u], parent[v]
        join = pu != pv
        if not join.any():
            return parent
        lo = np.minimum(pu[join], pv[join])
        hi = np.maximum(pu[join], pv[join])
        np.minimum.at(parent, hi, lo)
        while True:
            up = parent[parent]
            if np.array_equal(up, parent):
                break
            parent = up


def filter_speckles(disp: np.ndarray, valid: np.ndarray, tau: float,
                    max_size: int) -> np.ndarray:
    """The validity after speckle removal ([H, W] bool)."""
    d = np.asarray(disp, dtype=np.float32)
    ok = np.asarray(valid, dtype=bool)
    h, w = d.shape
    t = np.float32(tau)
    node = np.arange(h * w).reshape(h, w)
    across = ok[:, 1:] & ok[:, :-1] & (np.abs(d[:, 1:] - d[:, :-1]) <= t)
    down = ok[1:] & ok[:-1] & (np.abs(d[1:] - d[:-1]) <= t)
    u = np.concatenate([node[:, :-1][across], node[:-1][down]])
    v = np.concatenate([node[:, 1:][across], node[1:][down]])
    root = components(h * w, u, v)
    size = np.bincount(root, minlength=h * w)
    return ok & (size[root] >= max_size).reshape(h, w)
