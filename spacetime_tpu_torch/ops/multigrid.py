"""Multi-shift geometric multigrid for A + ω M.

``MultiShiftMultigrid.build`` and ``mass_spectral_bounds`` are the port's
copy of the host half of ``spacetime_tpu/ops/multigrid.py``: the levels of
the structured hierarchy (re-assembled per level, since nested P1 spaces
make that the Galerkin operator), their stencils, centre weights and
Gershgorin bounds, and the dense coarse matrices.

``MultiShiftMG`` applies a V-cycle to (T, *gs) tensors with one shift per
time row. The arithmetic follows the JAX package's XLA form
(``pallas=None``): ``ms_op`` sums the taps of each (wA, wM) weight-pair
group once and multiplies by the per-row weight wa + ω·wm; the smoother
``cheb_smooth`` is the Chebyshev–Jacobi recurrence with σ = 5/3; the P1
transfers are the separated repeat / pair-sum form (``_transfer_fast``).

``vcycle`` and ``solve`` take an optional per-level list of
``ops.mg_kernels.MSKernelLevel`` and then dispatch as the JAX package does
with its Pallas levels (``spacetime_tpu/ops/multigrid.py:496-549``): the
fused pre/post stages (K6, K7) where the level allows them, else the
semi-fused stages (K3 zero-init sweep, K8 residual + restriction, K9
prolongation + correction, K3 post-sweep); a kernel level that takes
neither (extents not all odd, which no nested hierarchy has) raises. The
residual kernel (K4) starts the second and later cycles of ``solve``.
Without the list the XLA form runs, which is also what the levels' plain
twins compute.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.linalg as sla
import torch
import torch.nn.functional as F

from ..fem import P1System, unit_cube_mesh, unit_square_mesh
from .sparse import DiaMatrix
from .stencil import (StencilOperator, grouped_apply, row_scale, tap,
                      weight_groups, zero_pad)

_SIGMA = 5.0 / 3.0


# ------------------------------------------------------- host hierarchy


@dataclasses.dataclass(frozen=True)
class _MSLevel:
    A_st: StencilOperator
    M_st: StencilOperator
    cA: float  # center weights (constant on-grid)
    cM: float
    gA: float  # Gershgorin row sums  sum|w|
    gM: float
    n: int


@dataclasses.dataclass(frozen=True)
class MultiShiftMultigrid:
    """The static structure of one V-cycle for all shifted operators
    A + ω_r M at once: the levels from the finest down to (not including)
    the coarse grid of ``n_coarse`` cells per side. ``nu_post`` overrides
    the post-smoothing degree (None: ``nu``); asymmetric V(ν, ν_post)
    cycles are not symmetric preconditioners."""

    dim: int
    levels: tuple[_MSLevel, ...]
    nu: int
    n_coarse: int
    nu_post: int | None = None

    @classmethod
    def build(
        cls,
        dim: int,
        n_fine: int,
        nu: int = 2,
        n_coarse: int = 8,
        _system_cache: dict | None = None,
    ) -> tuple["MultiShiftMultigrid", tuple[np.ndarray, np.ndarray]]:
        """Returns (static structure, (A_coarse, M_coarse) dense)."""
        make = unit_square_mesh if dim == 2 else unit_cube_mesh
        levels = []
        n = n_fine
        while n > n_coarse:
            sys_l = None if _system_cache is None else _system_cache.get(n)
            if sys_l is None:
                sys_l = P1System.from_mesh(make(n))
                if _system_cache is not None:
                    _system_cache[n] = sys_l
            gs = sys_l.mesh.grid_shape
            A_st = StencilOperator.from_dia(DiaMatrix.from_csr(sys_l.A), gs)
            M_st = StencilOperator.from_dia(DiaMatrix.from_csr(sys_l.M), gs)
            center = (0,) * dim
            cA = dict(zip(A_st.disps, A_st.weights))[center]
            cM = dict(zip(M_st.disps, M_st.weights))[center]
            gA = sum(abs(w) for w in A_st.weights)
            gM = sum(abs(w) for w in M_st.weights)
            levels.append(_MSLevel(A_st, M_st, cA, cM, gA, gM, n))
            n //= 2
        sys_c = None if _system_cache is None else _system_cache.get(n)
        if sys_c is None:
            sys_c = P1System.from_mesh(make(n))
            if _system_cache is not None:
                _system_cache[n] = sys_c
        return (
            cls(dim, tuple(levels), nu, n),
            (sys_c.A.toarray(), sys_c.M.toarray()),
        )


def mass_spectral_bounds(dim: int) -> tuple[float, float]:
    """(lmin, lmax) of D⁻¹M for the structured P1 mass matrix family —
    h-independent, computed exactly on a small instance with a margin."""
    sys_s = P1System.from_mesh(
        unit_square_mesh(8) if dim == 2 else unit_cube_mesh(6)
    )
    M = sys_s.M.toarray()
    D = np.diag(M).copy()
    w = sla.eigvalsh(M / np.sqrt(D)[:, None] / np.sqrt(D)[None, :])
    # Upper bound: Gershgorin over interior rows (exact for the family since
    # interior rows repeat); lower: small-instance minimum with margin.
    gersh = float((np.abs(M).sum(axis=1) / D).max())
    return float(0.8 * w[0]), gersh


# ------------------------------------------------------- device V-cycle


@functools.lru_cache(maxsize=None)
def pair_groups(groups_A, groups_M):
    """Regroup two same-support stencils by their (wA, wM) weight pair, in
    the JAX package's order (``_pair_groups`` of
    ``spacetime_tpu/ops/mg_pallas.py``)."""
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


def ms_op(pairs, gs, omega, x):
    """A(x) + ω⊙M(x) for the (wA, wM) pair groups ``pairs`` of a level on
    grid ``gs``; ``omega`` is the (T, 1, ..., 1) shift column."""
    Up = zero_pad(x, len(gs))
    out = None
    for (wa, wm), ds in pairs:
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


def cheb_smooth(op, lp, x, b, nu: int):
    """The degree-``nu`` Chebyshev–Jacobi sweep on Op = ``op`` from ``x``,
    with the level's row columns ``lp``."""
    r = lp["inv_diag"] * (b - op(x))
    d = r * lp["inv_theta"]
    x = x + d
    rho = 1.0 / _SIGMA
    for _ in range(nu - 1):
        rho_new = 1.0 / (2.0 * _SIGMA - rho)
        r = r - lp["inv_diag"] * op(d)
        d = rho_new * rho * d + (2.0 * rho_new) * lp["inv_delta"] * r
        x = x + d
        rho = rho_new
    return x


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
        return ms_op(self._pairs[lvl], gs, lp["omega"], x)

    def smooth(self, lvl: int, lp, x, b, nu: int | None = None):
        nu = self.nu if nu is None else nu
        return cheb_smooth(lambda v: self.op(lvl, lp, v), lp, x, b, nu)

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0, kernels=None):
        """One V-cycle from x = 0. ``kernels``: per-level
        ``MSKernelLevel``s, whose row columns are ``lps[lvl]["cols"]``."""
        if lvl == len(self.msmg.levels):
            return coarse_solve(b)
        lp = lps[lvl]
        kl = kernels[lvl] if kernels is not None else None
        if kl is not None and kl.fused_ok:
            x, rc = kl.fused_pre(b, lp["cols"])
            ec = self.vcycle(rc, lps, coarse_solve, lvl + 1, kernels)
            return kl.fused_post(x, b, ec, lp["cols"])
        if kl is not None:
            if not kl.semi_ok:
                raise ValueError(
                    f"level {lvl}, grid {kl.gs}: the P1 transfers need odd "
                    "extents 2n+1 (an even n on every level above the coarse "
                    "grid)"
                )
            # the fine residual and the prolonged correction never reach
            # device memory
            x = kl.smooth(None, b, lp["cols"], zero_init=True)
            rc = kl.residual_restrict(x, b, lp["cols"])
            ec = self.vcycle(rc, lps, coarse_solve, lvl + 1, kernels)
            x = kl.prolong_correct(x, ec)
            return kl.smooth(x, b, lp["cols"], post=True)
        x = self.smooth(lvl, lp, b * 0.0, b)
        r = b - self.op(lvl, lp, x)
        ec = self.vcycle(
            transfer(r, self.dim, restrict=True), lps, coarse_solve, lvl + 1,
            kernels,
        )
        x = x + transfer(ec, self.dim, restrict=False)
        return self.smooth(lvl, lp, x, b, nu=self.nu_post)

    def solve(self, b, lps, coarse_solve, cycles: int = 2, kernels=None):
        """``cycles`` V-cycles from a zero initial guess."""
        x = self.vcycle(b, lps, coarse_solve, kernels=kernels)
        for _ in range(cycles - 1):
            if kernels is not None and kernels[0] is not None:
                r = kernels[0].residual(x, b, lps[0]["cols"])
            else:
                r = b - self.op(0, lps[0], x)
            x = x + self.vcycle(r, lps, coarse_solve, kernels=kernels)
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
