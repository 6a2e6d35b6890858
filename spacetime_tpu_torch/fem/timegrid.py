"""Dyadic time grids and the banded time matrices.

The port's copy of ``spacetime_tpu/fem/timegrid.py``: a grid is built by
recursive bisection, so every node carries its creation level and its two
creation parents, which is what the wavelet transform needs. Uniform grids
bisect every interval to a level; graded grids bisect the intervals that
touch a critical time further (the singular problems, graded toward t = 0).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class TimeGrid:
    """A dyadically generated time grid on [0, T].

    Attributes:
      t: (N+1,) sorted node coordinates, t[0] = 0, t[-1] = T.
      level: (N+1,) creation level per node (the two endpoints have level 0).
      parent_left/parent_right: (N+1,) indices (into the sorted node order) of
        the interval endpoints whose bisection created each node; -1 for the
        two level-0 endpoints.
    """

    t: np.ndarray
    level: np.ndarray
    parent_left: np.ndarray
    parent_right: np.ndarray

    @property
    def num_intervals(self) -> int:
        return self.t.shape[0] - 1

    @property
    def num_nodes(self) -> int:
        return self.t.shape[0]

    @property
    def max_level(self) -> int:
        return int(self.level.max())

    @property
    def h(self) -> np.ndarray:
        return np.diff(self.t)


def _build(T: float, refine: Callable[[float, float, int], bool]) -> TimeGrid:
    ts = [0.0, T]
    levels = [0, 0]
    parents = [(-1, -1), (-1, -1)]
    # Work queue of intervals as (left_node, right_node, level).
    queue = [(0, 1, 0)]
    while queue:
        ia, ib, lvl = queue.pop()
        a, b = ts[ia], ts[ib]
        if not refine(a, b, lvl):
            continue
        mid = len(ts)
        ts.append(0.5 * (a + b))
        levels.append(lvl + 1)
        parents.append((ia, ib))
        queue.append((ia, mid, lvl + 1))
        queue.append((mid, ib, lvl + 1))

    t = np.asarray(ts)
    order = np.argsort(t)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    pl = np.array([p[0] for p in parents])
    pr = np.array([p[1] for p in parents])
    root = pl < 0
    pl_sorted = np.where(root, -1, rank[np.where(root, 0, pl)])
    pr_sorted = np.where(root, -1, rank[np.where(root, 0, pr)])
    return TimeGrid(
        t=t[order],
        level=np.asarray(levels)[order].astype(np.int32),
        parent_left=pl_sorted[order].astype(np.int32),
        parent_right=pr_sorted[order].astype(np.int32),
    )


def uniform_time_grid(num_levels: int, T: float = 1.0) -> TimeGrid:
    """Uniform dyadic grid with 2**num_levels intervals on [0, T]."""
    return _build(T, lambda a, b, lvl: lvl < num_levels)


def graded_time_grid(
    num_levels: int, extra_levels: int, t_crit: float = 0.0, T: float = 1.0
) -> TimeGrid:
    """Locally refined dyadic grid: uniform to ``num_levels``, plus up to
    ``extra_levels`` further bisections of the intervals touching
    ``t_crit`` (the grid of the singular problems, which need refinement
    toward t = 0 to keep the optimal convergence rate). With
    ``extra_levels = 0`` it is the uniform grid."""

    def refine(a: float, b: float, lvl: int) -> bool:
        if lvl < num_levels:
            return True
        return a <= t_crit <= b and lvl < num_levels + extra_levels

    return _build(T, refine)


def time_matrices(grid: TimeGrid):
    """Banded time matrices of the minimal-residual discretization.

    Returns dict with:
      h:   (N,) interval lengths.
      A_t: (N, N+1) sparse transport matrix, rows [-1, +1].
      M_t: (N, N+1) sparse time mass (trial hats vs test indicators),
           rows [h_j/2, h_j/2].
      G_t: (N+1, N+1) sparse pw-linear mass on the grid.
    """
    N = grid.num_intervals
    h = grid.h
    rows = np.repeat(np.arange(N), 2)
    cols = np.stack([np.arange(N), np.arange(1, N + 1)], axis=1).ravel()
    at_vals = np.tile([-1.0, 1.0], N)
    mt_vals = np.repeat(h / 2.0, 2)
    A_t = sp.csr_matrix((at_vals, (rows, cols)), shape=(N, N + 1))
    M_t = sp.csr_matrix((mt_vals, (rows, cols)), shape=(N, N + 1))

    main = np.zeros(N + 1)
    main[:-1] += h / 3.0
    main[1:] += h / 3.0
    off = h / 6.0
    G_t = sp.diags([off, main, off], offsets=[-1, 0, 1], format="csr")
    return {"h": h, "A_t": A_t, "M_t": M_t, "G_t": G_t}
