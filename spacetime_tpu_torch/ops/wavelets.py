"""The three-point piecewise-linear wavelet transform in time: W (synthesis)
and its transpose W', along axis 0.

``build_wavelet_transform`` and ``WaveletTransform`` are the port's copy of
the host structure in ``spacetime_tpu/ops/wavelets.py``: a node created at
level j by bisecting (pl, pr) carries the wavelet
s_k (wl_k σ_pl + σ_k + wr_k σ_pr) in level-j hats, with one vanishing moment
and an exact L2(0, T) normalization; ``forward_np`` / ``adjoint_np`` apply
it on the host. The device side (``jax_params`` / ``forward_jax`` /
``adjoint_jax`` of the JAX package) is ``wavelet_params``, ``forward`` and
``adjoint`` here:

- float32 (and N+1 ≤ 1025 nodes): the dense (N+1)² synthesis matrix, applied
  as one ``torch.matmul`` over an (N+1, -1) view — a plain product, in full
  float32 (``utils.device`` turns TF32 off);
- float64 (and float32 above 1025 nodes): the lifting pyramid in the JAX
  package's operation order, on strided slices of a uniform dyadic grid,
  and in its gather form (``index_select`` / ``index_add_`` with each
  level's node and parent indices) on a graded grid.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_DENSE_MAX_NODES = 1025


@dataclasses.dataclass(frozen=True)
class _Level:
    idx: np.ndarray  # nodes created at this level
    pl: np.ndarray  # creation parents (left)
    pr: np.ndarray  # creation parents (right)
    wl: np.ndarray  # wavelet weight on sigma_pl
    wr: np.ndarray  # wavelet weight on sigma_pr
    s: np.ndarray  # L2 normalization scale


@dataclasses.dataclass(frozen=True)
class WaveletTransform:
    """Host-precomputed structure of the wavelet transform on a TimeGrid."""

    grid: object  # fem.TimeGrid
    levels: tuple[_Level, ...]  # levels 1..J
    root_idx: np.ndarray  # the two level-0 nodes
    root_s: np.ndarray  # their L2 normalization
    node_level: np.ndarray  # (N+1,) level of each node
    node_omega: np.ndarray  # (N+1,) |psi'|_L2 of the normalized basis function
    level_shift: np.ndarray  # (J+1,) representative omega per level
    perm_by_level: np.ndarray  # stable permutation sorting nodes by level
    level_counts: np.ndarray  # (J+1,) nodes per level

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def forward_np(self, c: np.ndarray) -> np.ndarray:
        """Synthesis W: wavelet coefficients -> nodal (hat) values, axis 0."""
        v = np.zeros_like(c)
        v[self.root_idx] = _bcast(self.root_s, c.ndim) * c[self.root_idx]
        for lev in self.levels:
            interp = 0.5 * (v[lev.pl] + v[lev.pr])
            t = _bcast(lev.s, c.ndim) * c[lev.idx]
            np.add.at(v, lev.pl, _bcast(lev.wl, c.ndim) * t)
            np.add.at(v, lev.pr, _bcast(lev.wr, c.ndim) * t)
            v[lev.idx] = t + interp
        return v

    def adjoint_np(self, v: np.ndarray) -> np.ndarray:
        """Transpose W': nodal-value layout -> wavelet-coefficient layout."""
        y = np.array(v, copy=True)
        for lev in reversed(self.levels):
            t = y[lev.idx].copy()
            pv_l = y[lev.pl].copy()
            pv_r = y[lev.pr].copy()
            np.add.at(y, lev.pl, 0.5 * t)
            np.add.at(y, lev.pr, 0.5 * t)
            y[lev.idx] = _bcast(lev.s, v.ndim) * (
                t + _bcast(lev.wl, v.ndim) * pv_l + _bcast(lev.wr, v.ndim) * pv_r
            )
        y[self.root_idx] = _bcast(self.root_s, v.ndim) * y[self.root_idx]
        return y

    def dense(self) -> np.ndarray:
        """Dense (N+1)x(N+1) synthesis matrix."""
        n = self.grid.num_nodes
        return self.forward_np(np.eye(n))

    @functools.cached_property
    def is_uniform(self) -> bool:
        """True iff the grid is the full uniform dyadic grid (N = 2^J)."""
        N = self.grid.num_intervals
        J = self.num_levels
        if N != (1 << J):
            return False
        for j, lev in enumerate(self.levels, start=1):
            s = N >> j
            if not (
                np.array_equal(lev.idx, np.arange(s, N, 2 * s))
                and np.array_equal(lev.pl, lev.idx - s)
                and np.array_equal(lev.pr, lev.idx + s)
            ):
                return False
        return True


def _bcast(a: np.ndarray, ndim: int):
    return a.reshape(a.shape + (1,) * (ndim - 1))


def _hat_integrals(t_sorted: np.ndarray) -> np.ndarray:
    """∫ sigma_i for hats on the sorted grid: (d_left + d_right) / 2."""
    d = np.diff(t_sorted)
    out = np.zeros_like(t_sorted)
    out[:-1] += d / 2.0
    out[1:] += d / 2.0
    return out


def _pw_linear_norms(t_loc: np.ndarray, v_loc: np.ndarray) -> tuple[float, float]:
    """(L2 norm^2, H1 seminorm^2) of the pw-linear function with nodal values
    ``v_loc`` at sorted nodes ``t_loc`` (zero outside)."""
    d = np.diff(t_loc)
    a, b = v_loc[:-1], v_loc[1:]
    l2 = np.sum(d / 3.0 * (a * a + a * b + b * b))
    h1 = np.sum((b - a) ** 2 / d)
    return float(l2), float(h1)


def build_wavelet_transform(grid) -> WaveletTransform:
    """Precompute the transform structure for a dyadic time grid."""
    t = grid.t
    nlev = grid.max_level
    N1 = grid.num_nodes
    node_omega = np.zeros(N1)

    # Level 0: the two hats on the coarsest grid {0, T}.
    root_idx = np.flatnonzero(grid.level == 0).astype(np.int32)
    assert root_idx.size == 2
    T = t[-1] - t[0]
    l2_root = T / 3.0
    root_s = np.full(2, 1.0 / np.sqrt(l2_root))
    node_omega[root_idx] = root_s * np.sqrt(1.0 / T)

    levels = []
    for j in range(1, nlev + 1):
        present = np.flatnonzero(grid.level <= j)  # already time-sorted
        pos = {int(k): i for i, k in enumerate(present)}
        idx = np.flatnonzero(grid.level == j).astype(np.int32)
        pl = grid.parent_left[idx].astype(np.int32)
        pr = grid.parent_right[idx].astype(np.int32)
        t_present = t[present]
        integ = _hat_integrals(t_present)

        wl = np.empty(idx.size)
        wr = np.empty(idx.size)
        s = np.empty(idx.size)
        for a, (k, l, r) in enumerate(zip(idx, pl, pr)):
            p_k, p_l, p_r = pos[int(k)], pos[int(l)], pos[int(r)]
            assert p_l == p_k - 1 and p_r == p_k + 1, "parents must be grid neighbors"
            wl[a] = -integ[p_k] / (2.0 * integ[p_l])
            wr[a] = -integ[p_k] / (2.0 * integ[p_r])
            # Local support of psi on the level-j grid: [pl-1, pl, k, pr, pr+1].
            lo = max(p_l - 1, 0)
            hi = min(p_r + 1, present.size - 1)
            t_loc = t_present[lo : hi + 1]
            v_loc = np.zeros(t_loc.size)
            v_loc[p_l - lo] = wl[a]
            v_loc[p_k - lo] = 1.0
            v_loc[p_r - lo] = wr[a]
            l2, h1 = _pw_linear_norms(t_loc, v_loc)
            s[a] = 1.0 / np.sqrt(l2)
            node_omega[k] = np.sqrt(h1 / l2)
        levels.append(_Level(idx, pl, pr, wl, wr, s))

    level_shift = np.zeros(nlev + 1)
    for j in range(nlev + 1):
        omj = node_omega[grid.level == j]
        level_shift[j] = float(np.median(omj)) if omj.size else 0.0

    perm = np.argsort(grid.level, kind="stable").astype(np.int32)
    counts = np.bincount(grid.level, minlength=nlev + 1).astype(np.int32)
    return WaveletTransform(
        grid=grid,
        levels=tuple(levels),
        root_idx=root_idx,
        root_s=root_s,
        node_level=grid.level.copy(),
        node_omega=node_omega,
        level_shift=level_shift,
        perm_by_level=perm,
        level_counts=counts,
    )


def _use_dense(wt, dtype) -> bool:
    return dtype != torch.float64 and wt.grid.num_nodes <= _DENSE_MAX_NODES


def wavelet_params(wt, dtype, device) -> dict:
    """The transform's tensors for ``dtype``: {"Wd", "WdT"} (dense) or
    {"levels": [{"wl", "wr", "s"}, ...]} (lifting; (n_j,) per level j); on
    a graded grid the lifting's levels also carry their "idx", "pl", "pr"
    (int64) and the tree its "root_idx" and "root_s" (the gather form, the
    JAX package's ``_lifting_params(gather=True)``)."""
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    ix = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    if _use_dense(wt, dtype):
        Wd = wt.dense()
        return {"Wd": mk(Wd), "WdT": mk(Wd.T)}
    gather = not wt.is_uniform
    levels = []
    for lev in wt.levels:
        d = {"wl": mk(lev.wl), "wr": mk(lev.wr), "s": mk(lev.s)}
        if gather:
            d.update(idx=ix(lev.idx), pl=ix(lev.pl), pr=ix(lev.pr))
        levels.append(d)
    out = {"levels": levels}
    if gather:
        out.update(root_idx=ix(wt.root_idx), root_s=mk(wt.root_s))
    return out


def _gemm_axis0(Wmat, x):
    return torch.matmul(Wmat, x.reshape(x.shape[0], -1)).reshape(x.shape)


def _check_strided(wt) -> None:
    if not wt.is_uniform:
        raise ValueError(
            "a graded time grid needs the gather form of the lifting: "
            "params from wavelet_params on that grid")


def _stride_slices(N: int, j: int):
    s = N >> j
    return (
        slice(s, N, 2 * s),
        slice(0, N - 2 * s + 1, 2 * s),
        slice(2 * s, N + 1, 2 * s),
    )


def forward(wt, c, wp):
    """Synthesis W along axis 0 of ``c`` (N+1, ...)."""
    if "Wd" in wp:
        return _gemm_axis0(wp["Wd"], c)
    r = lambda a: a.reshape(a.shape[:1] + (1,) * (c.ndim - 1))
    if "root_idx" in wp:
        return _forward_gather(c, wp, r)
    _check_strided(wt)
    N = wt.grid.num_intervals
    v = torch.zeros_like(c)
    v[0] = float(wt.root_s[0]) * c[0]
    v[N] = float(wt.root_s[1]) * c[N]
    for j, lw in enumerate(wp["levels"], start=1):
        mid, left, right = _stride_slices(N, j)
        t = r(lw["s"]) * c[mid]
        interp = 0.5 * (v[left] + v[right])
        v[left] += r(lw["wl"]) * t
        v[right] += r(lw["wr"]) * t
        v[mid] = t + interp
    return v


def adjoint(wt, x, wp):
    """Transpose W' along axis 0 of ``x`` (N+1, ...)."""
    if "WdT" in wp:
        return _gemm_axis0(wp["WdT"], x)
    r = lambda a: a.reshape(a.shape[:1] + (1,) * (x.ndim - 1))
    if "root_idx" in wp:
        return _adjoint_gather(x, wp, r)
    _check_strided(wt)
    N = wt.grid.num_intervals
    y = x.clone()
    for j in range(wt.num_levels, 0, -1):
        lw = wp["levels"][j - 1]
        mid, left, right = _stride_slices(N, j)
        t = y[mid].clone()
        a = y[left].clone()
        b = y[right].clone()
        y[left] += 0.5 * t
        y[right] += 0.5 * t
        y[mid] = r(lw["s"]) * (t + r(lw["wl"]) * a + r(lw["wr"]) * b)
    y[0] *= float(wt.root_s[0])
    y[N] *= float(wt.root_s[1])
    return y


# The gather form of the lifting (graded grids), in the JAX package's order
# (``forward_jax`` / ``adjoint_jax`` with "root_idx"): within one level a
# node is the left parent of at most one new node and the right parent of
# at most one, and ``index_add_`` adds as JAX's ``.at[].add`` does.


def _forward_gather(c, wp, r):
    v = torch.zeros_like(c)
    ridx = wp["root_idx"]
    v[ridx] = r(wp["root_s"]) * c.index_select(0, ridx)
    for lw in wp["levels"]:
        t = r(lw["s"]) * c.index_select(0, lw["idx"])
        interp = 0.5 * (v.index_select(0, lw["pl"])
                        + v.index_select(0, lw["pr"]))
        v.index_add_(0, lw["pl"], r(lw["wl"]) * t)
        v.index_add_(0, lw["pr"], r(lw["wr"]) * t)
        v[lw["idx"]] = t + interp
    return v


def _adjoint_gather(x, wp, r):
    y = x.clone()
    for lw in reversed(wp["levels"]):
        t = y.index_select(0, lw["idx"])
        a = y.index_select(0, lw["pl"])
        b = y.index_select(0, lw["pr"])
        y.index_add_(0, lw["pl"], 0.5 * t)
        y.index_add_(0, lw["pr"], 0.5 * t)
        y[lw["idx"]] = r(lw["s"]) * (t + r(lw["wl"]) * a + r(lw["wr"]) * b)
    ridx = wp["root_idx"]
    y[ridx] = y.index_select(0, ridx) * r(wp["root_s"])
    return y
