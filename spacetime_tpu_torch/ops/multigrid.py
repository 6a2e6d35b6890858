"""Multi-shift geometric multigrid for A + ω M on tensors.

The device side of ``spacetime_tpu.ops.multigrid.MultiShiftMultigrid``: the
host ``build`` (levels, stencils, Gershgorin bounds, coarse matrices) is
reused as it is, and this module applies a V-cycle to (T, *gs) tensors with
one shift per time row. The arithmetic follows the JAX package's XLA form
(``pallas=None``): ``_op`` sums the taps of each (wA, wM) weight-pair group
once and multiplies by the per-row weight wa + ω·wm; the smoother is the
Chebyshev–Jacobi recurrence with σ = 5/3; the P1 transfers are the
separated repeat / pair-sum form (``_transfer_fast``).

The fused Pallas smoother and transfer kernels (K3–K7) engage in the JAX
package only on levels of at least 40 000 points; their port is the next
slice (ROADMAP.md queue 2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stencil import grouped_apply, row_scale, tap, weight_groups, zero_pad

_SIGMA = 5.0 / 3.0


@functools.lru_cache(maxsize=None)
def pair_groups(groups_A, groups_M):
    """Regroup two same-support stencils by their (wA, wM) weight pair, in
    the JAX package's order. Copied from
    ``spacetime_tpu.ops.mg_pallas._pair_groups`` (whose module needs
    JAX)."""
    wA = {d: w for w, ds in groups_A for d in ds}
    wM = {d: w for w, ds in groups_M for d in ds}
    pairs: dict[tuple[float, float], list] = {}
    for d in {**wA, **wM}:
        key = (wA.get(d, 0.0), wM.get(d, 0.0))
        if key != (0.0, 0.0):
            pairs.setdefault(key, []).append(d)
    return tuple((k, tuple(ds)) for k, ds in pairs.items())


def row_params(msmg, omega_rows: np.ndarray, dtype, device) -> list[dict]:
    """Per-level Chebyshev–Jacobi columns for a per-row shift vector,
    (T, 1, ..., 1) each — the formulas of ``MultiShiftMultigrid.row_params``."""
    out = []
    for lev in msmg.levels:
        inv_diag = 1.0 / (lev.cA + omega_rows * lev.cM)
        lam_max = 1.1 * (lev.gA + omega_rows * lev.gM) * inv_diag
        theta = 0.625 * lam_max
        delta = 0.375 * lam_max
        col = lambda v: row_scale(v, msmg.dim, dtype, device)
        out.append(
            {
                "omega": col(omega_rows),
                "inv_diag": col(inv_diag),
                "inv_theta": col(1.0 / theta),
                "inv_delta": col(1.0 / delta),
            }
        )
    return out


# ------------------------------------------------------------ transfers


def _pad_axis(X, axis: int, lo: int, hi: int):
    pad = [0, 0] * (X.ndim - axis)
    pad[-2:] = [lo, hi]
    return F.pad(X, pad)


def _repeat2_pad(X, axis: int):
    """G[f] = X[floor(f/2)] along ``axis`` (n -> 2n+1, the last row the
    zero Dirichlet ghost)."""
    return _pad_axis(torch.repeat_interleave(X, 2, dim=axis), axis, 0, 1)


def _shift1_zero(X, axes, sign: int = 1):
    """X translated by ``sign`` along each of ``axes``, zero fill."""
    for a in axes:
        n = X.shape[a]
        if sign > 0:
            X = _pad_axis(X, a, 1, 0).narrow(a, 0, n)
        else:
            X = _pad_axis(X, a, 0, 1).narrow(a, 1, n)
    return X


def _pairsum(X, axis: int):
    """C[c] = X[2c] + X[2c+1] along ``axis`` (2n-1 -> n-1)."""
    Xe = X.narrow(axis, 0, X.shape[axis] - 1)
    shape = list(Xe.shape)
    shape[axis] //= 2
    shape.insert(axis + 1, 2)
    return Xe.reshape(shape).sum(dim=axis + 1)


def transfer(X, dim: int, *, restrict: bool):
    """The P1 transfer in separated form, K = ½(u^⊗dim + w^⊗dim):
    restriction (fine -> coarse) or prolongation (coarse -> fine)."""
    axes = tuple(range(X.ndim - dim, X.ndim))
    if restrict:
        H = X + _shift1_zero(X, axes, sign=-1)
        for a in axes:
            H = _pairsum(H, a)
        return 0.5 * H
    G = X
    for a in axes:
        G = _repeat2_pad(G, a)
    return 0.5 * (G + _shift1_zero(G, axes))


# ------------------------------------------------------------- V-cycle


class MultiShiftMG:
    """V-cycles of a host ``MultiShiftMultigrid`` on tensors."""

    def __init__(self, msmg, nu: int | None = None):
        self.msmg = msmg
        self.dim = msmg.dim
        self.nu = msmg.nu if nu is None else nu
        self.nu_post = msmg.nu_post
        self._pairs = [
            pair_groups(
                weight_groups(lev.A_st.disps, lev.A_st.weights),
                weight_groups(lev.M_st.disps, lev.M_st.weights),
            )
            for lev in msmg.levels
        ]

    def op(self, lvl: int, lp, x):
        """A(x) + ω⊙M(x) on level ``lvl``."""
        gs = tuple(self.msmg.levels[lvl].A_st.grid_shape)
        omega = lp["omega"]
        Up = zero_pad(x, self.dim)
        out = None
        for (wa, wm), ds in self._pairs[lvl]:
            acc = None
            for disp in ds:
                t = tap(x, Up, disp, gs)
                acc = t if acc is None else acc + t
            if wm == 0.0:
                w = wa
            elif wa == 0.0:
                w = omega * wm
            else:
                w = wa + omega * wm
            out = w * acc if out is None else out + w * acc
        return out

    def smooth(self, lvl: int, lp, x, b, nu: int | None = None):
        nu = self.nu if nu is None else nu
        r = lp["inv_diag"] * (b - self.op(lvl, lp, x))
        d = r * lp["inv_theta"]
        x = x + d
        rho = 1.0 / _SIGMA
        for _ in range(nu - 1):
            rho_new = 1.0 / (2.0 * _SIGMA - rho)
            r = r - lp["inv_diag"] * self.op(lvl, lp, d)
            d = rho_new * rho * d + (2.0 * rho_new) * lp["inv_delta"] * r
            x = x + d
            rho = rho_new
        return x

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0):
        if lvl == len(self.msmg.levels):
            return coarse_solve(b)
        lp = lps[lvl]
        x = self.smooth(lvl, lp, b * 0.0, b)
        r = b - self.op(lvl, lp, x)
        ec = self.vcycle(
            transfer(r, self.dim, restrict=True), lps, coarse_solve, lvl + 1
        )
        x = x + transfer(ec, self.dim, restrict=False)
        return self.smooth(lvl, lp, x, b, nu=self.nu_post)

    def solve(self, b, lps, coarse_solve, cycles: int = 2):
        """``cycles`` V-cycles from a zero initial guess."""
        x = self.vcycle(b, lps, coarse_solve)
        for _ in range(cycles - 1):
            r = b - self.op(0, lps[0], x)
            x = x + self.vcycle(r, lps, coarse_solve)
        return x


def chebyshev_stencil_inverse(st, inv_diag: float, lmin: float, lmax: float,
                              degree: int):
    """fn(b) ≈ Op⁻¹ b by degree-``degree`` Chebyshev–Jacobi iteration on a
    constant stencil (``chebyshev_inverse`` / ``chebyshev_generic`` of the
    JAX package, same recurrence)."""
    groups = weight_groups(st.disps, st.weights)
    gs = tuple(st.grid_shape)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def solve(b):
        r = inv_diag * b
        d = r / theta
        x = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - inv_diag * grouped_apply(groups, gs, d)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    return solve
