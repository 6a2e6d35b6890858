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

``GalerkinMultiShiftMultigrid.build`` is the host half of the JAX
package's class of that name, for coefficient-weighted forms: per-level
weighted stencils (``VarStencilOperator`` and their weight arrays) from
Galerkin RAP of the assembled fine matrix, the constant mass stencil, and
the diagonals and row sums of the exact per-ω Gershgorin bounds.
``GalerkinMultiShiftMG`` applies its V-cycle to tensors: Op = A_w + ω⊙M,
the Jacobi diagonal per node, and with per-level
``ops.mg_kernels.VarMSKernelLevel``s the same dispatch with the weighted
kernels (``spacetime_tpu/ops/multigrid.py:746-800``): fused K14/K15, else
semi-fused K10 → K13 → K9 → K10, and K11 for the later cycles.

The unstructured hierarchies live in the flat (T, m) dof layout (JAX
``ops/multigrid.py:803-1562``). ``NestedMultiShiftMultigrid.build`` walks a
red-refinement chain (``fem.refine_hierarchy``) with Galerkin RAP through
``fem.nested_interpolation``: DIA level operators, gather-row transfers.
``SAMultiShiftMultigrid.build`` aggregates A's graph (``_sa_aggregate``,
``sa_prolongator``): a banded DIA fine level with factored transfers, ELL
gather rows on the aggregated levels. ``flat_level_arrays`` and
``flat_row_params`` put their tensors on a device. ``NestedMultiShiftMG``
and ``SAMultiShiftMG`` run their V-cycles, with per-level kernel levels:
``ops.dia_kernels.DiaKernelLevel`` (K16 sweeps, K17 residuals, K18 in the
factored transfers) on DIA levels and ``ops.spmv.EllKernelLevel`` (K19
operator pair, K20 transfers) on ELL levels; without them, the JAX
package's XLA form.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..fem import P1System, unit_cube_mesh, unit_square_mesh
from .sparse import DiaMatrix, dia_matvec
from .stencil import (StencilOperator, VarStencilOperator, grouped_apply,
                      row_scale, tap, weight_groups, zero_pad)

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


def p1_interpolation_matrix(dim: int, nc: int) -> sp.csr_matrix:
    """The nested-P1 interpolation over interior nodes, coarse (nc-1)^dim ->
    fine (2nc-1)^dim, as CSR: ½(U^⊗dim + W^⊗dim) with 1-D factors
    U[f, f//2] = 1 and W[f, (f-1)//2] = 1 (the operator ``transfer``
    applies; its transpose is the restriction)."""
    nf = 2 * nc - 1
    f = np.arange(nf)
    U = sp.csr_matrix(
        (np.ones(nf - 1), (f[f // 2 <= nc - 2], (f // 2)[f // 2 <= nc - 2])),
        shape=(nf, nc - 1),
    )
    g = (f - 1) // 2
    keep = (f >= 1) & (g <= nc - 2)
    W = sp.csr_matrix(
        (np.ones(keep.sum()), (f[keep], g[keep])), shape=(nf, nc - 1)
    )
    Ud, Wd = U, W
    for _ in range(dim - 1):
        Ud = sp.kron(Ud, U, format="csr")
        Wd = sp.kron(Wd, W, format="csr")
    return (0.5 * (Ud + Wd)).tocsr()


def galerkin_coarsen(A, dim: int, nc: int) -> sp.csr_matrix:
    """One Galerkin RAP step A -> Pᵀ A P, symmetrised and pruned of the
    rounding noise outside the P1 neighbour pattern."""
    P = p1_interpolation_matrix(dim, nc)
    Ac = (P.T @ A @ P).tocsr()
    Ac = 0.5 * (Ac + Ac.T)
    Ac.data[np.abs(Ac.data) < 1e-13 * np.abs(Ac.data).max()] = 0.0
    Ac.eliminate_zeros()
    return Ac.tocsr()


@dataclasses.dataclass(frozen=True)
class _GMSLevel:
    A_vs: VarStencilOperator  # the weighted form's displacements
    Aw: np.ndarray  # its (ntaps, *gs) weights
    kc: int  # the center tap's index in A_vs.disps (the Jacobi diagonal)
    M_st: StencilOperator  # the mass: a constant stencil on every level
    cM: float  # its center weight
    dA: np.ndarray  # operator diagonals (m_l,), for the Gershgorin bounds
    dM: np.ndarray
    rsA: np.ndarray  # |row| sums
    rsM: np.ndarray
    n: int  # cells per side
    gs: tuple[int, ...]  # interior grid (n-1,)*dim

    @classmethod
    def from_matrices(cls, A, M, gs: tuple[int, ...]) -> "_GMSLevel":
        """The level of the interior CSR matrices A, M on the grid ``gs``
        ((n-1,)*dim)."""
        dim, n = len(gs), gs[0] + 1
        A_vs, Aw = VarStencilOperator.from_dia(DiaMatrix.from_csr(A), gs)
        kc = A_vs.disps.index((0,) * dim)
        M_st = StencilOperator.from_dia(DiaMatrix.from_csr(M), gs)
        cM = dict(zip(M_st.disps, M_st.weights))[(0,) * dim]
        dA = np.asarray(A.diagonal())
        dM = np.asarray(M.diagonal())
        rsA = np.asarray(np.abs(A).sum(axis=1)).ravel()
        rsM = np.asarray(np.abs(M).sum(axis=1)).ravel()
        return cls(A_vs, Aw, kc, M_st, cM, dA, dM, rsA, rsM, n, gs)


@dataclasses.dataclass(frozen=True)
class GalerkinMultiShiftMultigrid:
    """The static structure of the multi-shift V-cycle for a
    coefficient-weighted A: levels from the finest down to (not including)
    the coarse grid of ``n_coarse`` cells per side, each coarser operator
    the Galerkin product Pᵀ A P of the one above. ``nu_post`` as in
    ``MultiShiftMultigrid``."""

    dim: int
    levels: tuple[_GMSLevel, ...]
    nu: int
    n_coarse: int
    nu_post: int | None = None

    @classmethod
    def build(
        cls, dim: int, n_fine: int, A_fine, M_fine, nu: int = 2,
        n_coarse: int = 8,
    ) -> tuple["GalerkinMultiShiftMultigrid", tuple[np.ndarray, np.ndarray]]:
        """``A_fine`` / ``M_fine``: the interior CSR of the finest level.
        Returns (static structure, (A_coarse, M_coarse) dense)."""
        A = sp.csr_matrix(A_fine)
        M = sp.csr_matrix(M_fine)
        levels = []
        n = n_fine
        while n > n_coarse:
            if n % 2:
                raise ValueError(f"level size {n} not even (n_fine={n_fine})")
            levels.append(_GMSLevel.from_matrices(A, M, (n - 1,) * dim))
            A = galerkin_coarsen(A, dim, n // 2)
            M = galerkin_coarsen(M, dim, n // 2)
            n //= 2
        return cls(dim, tuple(levels), nu, n), (A.toarray(), M.toarray())


def var_row_params(gmsmg, omega_rows: np.ndarray, dtype, device,
                   weights=None) -> list[dict]:
    """Per-level row params of a ``GalerkinMultiShiftMultigrid`` for a
    per-row shift vector: the ω, 1/θ, 1/δ columns (T, 1, ..., 1), θ and δ
    from the exact Gershgorin bound of D(ω)⁻¹(A + ωM) evaluated at the
    distinct shifts, and the level's weights "Aw" (``weights[l]`` where
    given, to share one tensor between several shift vectors). The
    diagonal is per node, so there is no 1/D column."""
    omega_rows = np.asarray(omega_rows, np.float64)
    uniq, inv = np.unique(omega_rows, return_inverse=True)
    out = []
    for li, lev in enumerate(gmsmg.levels):
        lam_u = np.empty(uniq.size)
        for k, w in enumerate(uniq):
            lam_u[k] = ((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM)).max()
        lam = 1.1 * lam_u[inv]
        col = lambda v: row_scale(v, gmsmg.dim, dtype, device)
        out.append({
            "omega": col(omega_rows),
            "inv_theta": col(1.0 / (0.625 * lam)),
            "inv_delta": col(1.0 / (0.375 * lam)),
            "Aw": (weights[li] if weights is not None else
                   torch.as_tensor(lev.Aw, dtype=dtype, device=device)),
        })
    return out


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


def _window(R, axis: int, start: int, n: int):
    """R[start : start + n] along ``axis``, zero where the range leaves R."""
    lo = max(0, -start)
    hi = max(0, start + n - R.shape[axis])
    return _pad_axis(R, axis, lo, hi).narrow(axis, start + lo, n)


def restrict_lead(X, dim: int, own: int, h: int):
    """The restriction of a sharded slab (``lead=(own, h)``): X has own + 2h
    planes on its leading grid axis, and coarse plane k of the output sums
    the fine planes h + 2k, h + 2k + 1 (and h + 2k + 2); the other axes as
    ``transfer``. Returns the own/2 owned coarse planes."""
    axes = tuple(range(X.ndim - dim, X.ndim))
    H = (X + _shift1_zero(X, axes, sign=-1)).narrow(axes[0], h, own)
    shape = list(H.shape)
    shape[axes[0]] //= 2
    shape.insert(axes[0] + 1, 2)
    H = H.reshape(shape).sum(dim=axes[0] + 1)
    for a in axes[1:]:
        H = _pairsum(H, a)
    return 0.5 * H


def prolong_lead(E, dim: int, n: int, s: int):
    """The prolongation onto a sharded slab of ``n`` planes on the leading
    grid axis: fine plane l reads the coarse planes ⌊(l + s)/2⌋ and
    ⌊(l + s − 1)/2⌋ of E (zero beyond it), s = 2hc − h for a coarse operand
    with hc halo planes and a fine one with h; the other axes as
    ``transfer``."""
    axes = tuple(range(E.ndim - dim, E.ndim))
    R = torch.repeat_interleave(E, 2, dim=axes[0])
    Gu = _window(R, axes[0], s, n)
    Gw = _window(R, axes[0], s - 1, n)
    for a in axes[1:]:
        Gu = _repeat2_pad(Gu, a)
        Gw = _repeat2_pad(Gw, a)
    return 0.5 * (Gu + _shift1_zero(Gw, axes[1:]))


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


def cheb_smooth(op, lp, x, b, nu: int, vmask=None):
    """The degree-``nu`` Chebyshev–Jacobi sweep on Op = ``op`` from ``x``
    (x = 0 where ``x`` is None), with the level's row columns ``lp``; 1/D
    may be a per-node field. ``vmask``: a sharded slab's 0/1 validity
    field, multiplying every r (``_smooth_call``'s vmask)."""
    r = lp["inv_diag"] * (b if x is None else b - op(x))
    if vmask is not None:
        r = vmask * r
    d = r * lp["inv_theta"]
    x = d if x is None else x + d
    for a, c in chebyshev_steps(_SIGMA, nu):
        r = r - lp["inv_diag"] * op(d)
        if vmask is not None:
            r = vmask * r
        d = a * d + c * lp["inv_delta"] * r
        x = x + d
    return x


class _VCycle:
    """The V-cycle and the cycles of a solve, shared by the constant and
    the weighted hierarchy; a subclass gives ``op``, ``smooth`` and the
    arguments its kernel levels take after the fields (``_kernel_args``)."""

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0, kernels=None):
        """One V-cycle from x = 0. ``kernels``: per-level kernel levels,
        whose row columns are ``lps[lvl]["cols"]``."""
        if lvl == len(self.msmg.levels):
            return coarse_solve(b)
        lp = lps[lvl]
        kl = kernels[lvl] if kernels is not None else None
        if kl is not None and kl.fused_ok:
            args = self._kernel_args(lp)
            x, rc = kl.fused_pre(b, *args)
            ec = self.vcycle(rc, lps, coarse_solve, lvl + 1, kernels)
            return kl.fused_post(x, b, ec, *args)
        if kl is not None:
            if not kl.semi_ok:
                raise ValueError(
                    f"level {lvl}, grid {kl.gs}: the P1 transfers need odd "
                    "extents 2n+1 (an even n on every level above the coarse "
                    "grid)"
                )
            # the fine residual and the prolonged correction never reach
            # device memory
            args = self._kernel_args(lp)
            x = kl.smooth(None, b, *args, zero_init=True)
            rc = kl.residual_restrict(x, b, *args)
            ec = self.vcycle(rc, lps, coarse_solve, lvl + 1, kernels)
            x = kl.prolong_correct(x, ec)
            return kl.smooth(x, b, *args, post=True)
        x = self.smooth(lvl, lp, None, b)
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
                r = kernels[0].residual(x, b, *self._kernel_args(lps[0]))
            else:
                r = b - self.op(0, lps[0], x)
            x = x + self.vcycle(r, lps, coarse_solve, kernels=kernels)
        return x


class MultiShiftMG(_VCycle):
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

    @staticmethod
    def _kernel_args(lp):
        return (lp["cols"],)


def var_op(A_vs, groups_M, lp, x):
    """A_w(x) + ω⊙M(x) for a weighted stencil ``A_vs`` with weights
    ``lp["Aw"]`` and the mass's weight groups (``_op`` of the JAX
    ``GalerkinMultiShiftMultigrid``)."""
    return A_vs.apply(x, lp["Aw"]) + lp["omega"] * grouped_apply(
        groups_M, A_vs.grid_shape, x)


def var_smooth(A_vs, groups_M, kc: int, cM: float, lp, x, b, nu: int):
    """The degree-``nu`` sweep on ``var_op`` from ``x`` (x = 0 where None)
    with the per-node Jacobi diagonal 1/(A_w[kc] + c_M·ω)."""
    invd = 1.0 / (lp["Aw"][kc] + cM * lp["omega"])
    cols = {"inv_diag": invd, "inv_theta": lp["inv_theta"],
            "inv_delta": lp["inv_delta"]}
    return cheb_smooth(lambda v: var_op(A_vs, groups_M, lp, v), cols, x, b,
                       nu)


class GalerkinMultiShiftMG(_VCycle):
    """V-cycles of a host ``GalerkinMultiShiftMultigrid`` on tensors."""

    def __init__(self, gmsmg, nu: int | None = None):
        self.msmg = gmsmg
        self.dim = gmsmg.dim
        self.nu = gmsmg.nu if nu is None else nu
        self.nu_post = gmsmg.nu_post
        self._groups_M = [weight_groups(lev.M_st.disps, lev.M_st.weights)
                          for lev in gmsmg.levels]

    def op(self, lvl: int, lp, x):
        lev = self.msmg.levels[lvl]
        return var_op(lev.A_vs, self._groups_M[lvl], lp, x)

    def smooth(self, lvl: int, lp, x, b, nu: int | None = None):
        lev = self.msmg.levels[lvl]
        return var_smooth(lev.A_vs, self._groups_M[lvl], lev.kc, lev.cM, lp,
                          x, b, self.nu if nu is None else nu)

    @staticmethod
    def _kernel_args(lp):
        return (lp["cols"], lp["Aw"])


def chebyshev_stencil_inverse(st, inv_diag: float, lmin: float, lmax: float,
                              degree: int):
    """fn(b) ≈ Op⁻¹ b by degree-``degree`` Chebyshev–Jacobi iteration on a
    constant stencil (``chebyshev_inverse`` / ``chebyshev_generic`` of the
    JAX package, same recurrence)."""
    groups = weight_groups(st.disps, st.weights)
    gs = tuple(st.grid_shape)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    steps = chebyshev_steps(theta / delta, degree)

    def solve(b):
        r = inv_diag * b
        d = r / theta
        x = d
        for a, c in steps:
            r = r - inv_diag * grouped_apply(groups, gs, d)
            d = a * d + (c / delta) * r
            x = x + d
        return x

    return solve


# ------------------------------------------- generic Chebyshev inner solves


def generic_spectral_bounds(
    Op, safety: float = 0.9, known_lmin: float | None = None
) -> tuple[float, float]:
    """(lmin, lmax) of D⁻¹·Op for an SPD sparse matrix (the calibration of
    the ``inner="cheb"`` solves): lmax the Gershgorin row-sum bound of
    D^-1/2 Op D^-1/2; lmin the smallest eigenvalue of that matrix by one
    loose shift-invert Lanczos solve backed off by its residual (LOBPCG
    where that fails), shrunk by ``safety``. ``known_lmin`` (a certified
    lower bound, ½ for P1 mass matrices) skips the eigensolve, and lmax is
    then max_i rs_i/d_i. The JAX package's function of that name, step for
    step (its deterministic start vector included)."""
    import scipy.sparse.linalg as spla

    d = np.asarray(Op.diagonal())
    if known_lmin is not None:
        rs = np.asarray(np.abs(sp.csr_matrix(Op)).sum(axis=1)).ravel()
        return safety * known_lmin, float((rs / d).max())
    s = 1.0 / np.sqrt(d)
    B = sp.csr_matrix(Op).multiply(s[:, None]).multiply(s[None, :]).tocsc()
    gersh = float(np.abs(B).sum(axis=1).max())
    try:
        v0 = np.random.default_rng(0).standard_normal(B.shape[0])
        lam, V = spla.eigsh(B, k=1, sigma=0.0, which="LM", tol=1e-2, v0=v0)
        v = V[:, 0]
        lam = float(lam[0])
        resid = float(
            np.linalg.norm(B @ v - lam * v) / max(np.linalg.norm(v), 1e-300)
        )
        if resid >= 0.5 * lam:
            # the loose Ritz pair certifies nothing useful: re-run tighter,
            # warm-started from it
            lam, V = spla.eigsh(
                B, k=1, sigma=0.0, which="LM", tol=1e-4, v0=v
            )
            v = V[:, 0]
            lam = float(lam[0])
            resid = float(
                np.linalg.norm(B @ v - lam * v)
                / max(np.linalg.norm(v), 1e-300)
            )
        lmin = lam - resid if resid < 0.5 * lam else 0.1 * lam
    except RuntimeError:  # a singular factorization or no ARPACK convergence
        rng = np.random.default_rng(0)
        X = rng.standard_normal((B.shape[0], 1))
        w, V = spla.lobpcg(B.tocsr(), X, largest=False, maxiter=200, tol=1e-4)
        lam = float(w[0])
        v = V[:, 0]
        resid = float(
            np.linalg.norm(B @ v - lam * v) / max(np.linalg.norm(v), 1e-300)
        )
        lmin = max(lam - resid, 0.1 * lam)
    if not np.isfinite(lmin) or lmin <= 0.0:
        raise ValueError(
            f"spectral lower-bound estimation failed (lmin={lmin}); the "
            "operator may not be SPD"
        )
    return safety * lmin, gersh


def chebyshev_coefficients(lmin: float, lmax: float, degree: int) -> np.ndarray:
    """The data-independent scalars of the Chebyshev recurrence: row k =
    (α_k, β_k) with d ← α_k·d + β_k·r. Shape (degree-1, 2)."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    out = np.empty((max(degree - 1, 0), 2))
    for k, (a, c) in enumerate(chebyshev_steps(theta / delta, degree)):
        out[k] = a, c / delta
    return out


def chebyshev_steps(sigma: float, degree: int) -> list[tuple[float, float]]:
    """The scalars (ρ_{k+1}·ρ_k, 2·ρ_{k+1}) of the Chebyshev recurrence's
    degree − 1 steps, from ρ_0 = 1/σ with σ = θ/δ: each step is
    d ← ρ_{k+1}·ρ_k·d + (2·ρ_{k+1}/δ)·r."""
    rho = 1.0 / sigma
    out = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out.append((rho_new * rho, 2.0 * rho_new))
        rho = rho_new
    return out


def coef_rows(coef, dtype) -> list[tuple[float, float]]:
    """``chebyshev_coefficients`` rows as Python floats rounded to ``dtype``
    (the values JAX's scan reads from its ``dtype`` array)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return [(float(a), float(c)) for a, c in np.asarray(coef).astype(npdt)]


def chebyshev_degree(lmin: float, lmax: float, eps: float) -> int:
    """Smallest degree with error factor 2·((√κ−1)/(√κ+1))^d ≤ eps."""
    kappa = lmax / lmin
    q = (np.sqrt(kappa) - 1.0) / (np.sqrt(kappa) + 1.0)
    if q <= 0:
        return 1
    return max(1, int(np.ceil(np.log(eps / 2.0) / np.log(q))))


def cheb_run(b, invd, spmv, theta: float, coef):
    """The Chebyshev–Jacobi polynomial of ``chebyshev_coefficients`` applied
    to ``b`` (the twin of the JAX solver's ``_cheb_run``, a Python loop over
    the coefficient rows where JAX scans them): ``invd`` the Jacobi vector,
    ``spmv`` the operator, ``coef`` the rows as (α_k, β_k) Python floats
    (already rounded to the working dtype)."""
    r = invd * b
    d = r / theta
    x = d
    for a, c in coef:
        r = r - invd * spmv(d)
        d = a * d + c * r
        x = x + d
    return x


# ---------------------------------------- unstructured hierarchies (host)


def _rap(A, P) -> sp.csr_matrix:
    """Galerkin RAP Pᵀ A P, symmetrised and pruned of the rounding noise
    (for nested P1 spaces it equals coarse re-assembly)."""
    Ac = (P.T @ A @ P).tocsr()
    Ac = 0.5 * (Ac + Ac.T)
    Ac.data[np.abs(Ac.data) < 1e-13 * np.abs(Ac.data).max()] = 0.0
    Ac.eliminate_zeros()
    return Ac


def _ell_rows(P):
    """CSR rows as fixed-width (idx, w) gather arrays, padded with weight 0
    (pad index 0 is harmless under weight 0)."""
    P = P.tocsr()
    n = P.shape[0]
    counts = np.diff(P.indptr)
    K = max(int(counts.max()) if counts.size else 0, 1)
    idx = np.zeros((n, K), np.int32)
    w = np.zeros((n, K), np.float64)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(P.nnz) - np.repeat(P.indptr[:-1], counts)
    idx[rows, pos] = P.indices
    w[rows, pos] = P.data
    return idx, w


def _level_stats(A, M) -> dict:
    """The diagonals and |row| sums of a level's matrices (its Chebyshev
    bounds)."""
    return dict(dA=np.asarray(A.diagonal()), dM=np.asarray(M.diagonal()),
                rsA=np.asarray(np.abs(A).sum(axis=1)).ravel(),
                rsM=np.asarray(np.abs(M).sum(axis=1)).ravel())


@dataclasses.dataclass(frozen=True)
class _NestedLevel:
    offA: tuple[int, ...]
    offM: tuple[int, ...]
    Av: np.ndarray  # (m, ndiagA) DIA values
    Mv: np.ndarray
    dA: np.ndarray  # (m,) diagonals / |row| sums for the Chebyshev bounds
    dM: np.ndarray
    rsA: np.ndarray
    rsM: np.ndarray
    m: int
    Pidx: np.ndarray  # (m, ≤2) prolongation gather (coarse dof ids)
    Pw: np.ndarray
    Ridx: np.ndarray  # (m_c, K) restriction gather (fine dof ids)
    Rw: np.ndarray


@dataclasses.dataclass(frozen=True)
class NestedMultiShiftMultigrid:
    """The multi-shift V-cycle's structure on a nested red-refinement
    hierarchy (a mesh from ``fem.refine_hierarchy``): the P1 spaces are
    nested, so Galerkin RAP through ``fem.nested_interpolation`` is coarse
    re-assembly and geometric multigrid needs no structured grid. Levels
    live in the flat (…, m_l) dof layout: DIA level operators (lex-sorted
    meshes keep them banded), gather-row transfers of P and Pᵀ, the
    Jacobi term 1/(dA + ω·dM) per node. ``nu_post`` as in
    ``MultiShiftMultigrid``."""

    levels: tuple
    nu: int
    nu_post: int | None = None

    @classmethod
    def build(cls, fine_mesh, A_fine, M_fine, nu: int = 2,
              m_coarse: int = 1024):
        """Walk the mesh's ``refined_from`` chain, Galerkin-coarsening the
        fine matrices, until the chain ends or a level has at most
        ``m_coarse`` dofs. Returns (structure, (A_c, M_c) dense)."""
        from ..fem.mesh import nested_interpolation

        A = sp.csr_matrix(A_fine)
        M = sp.csr_matrix(M_fine)
        mesh = fine_mesh
        levels = []
        while mesh.refined_from is not None and A.shape[0] > m_coarse:
            P = nested_interpolation(mesh)
            dia_A = DiaMatrix.from_csr(A)
            dia_M = DiaMatrix.from_csr(M)
            Pidx, Pw = _ell_rows(P)
            Ridx, Rw = _ell_rows(P.T.tocsr())
            st = _level_stats(A, M)
            levels.append(_NestedLevel(
                dia_A.offsets, dia_M.offsets, dia_A.vals, dia_M.vals,
                st["dA"], st["dM"], st["rsA"], st["rsM"], A.shape[0], Pidx,
                Pw, Ridx, Rw))
            A = _rap(A, P)
            M = _rap(M, P)
            mesh = mesh.refined_from[0]
        if not levels:
            raise ValueError(
                "mesh carries no refinement chain above m_coarse — build it "
                "with fem.refine_hierarchy(base, refines)")
        if A.shape[0] > 8192:
            raise ValueError(
                f"coarsest level still has {A.shape[0]} dofs (> 8192): the "
                "dense coarse inverses would not fit — start from a coarser "
                "base mesh or refine more")
        return cls(tuple(levels), nu), (A.toarray(), M.toarray())


def _sa_aggregate(A, theta: float):
    """The strength graph |a_ij| ≥ θ·√(a_ii·a_jj) and its greedy 3-pass
    aggregation: (agg, n_agg). The JAX package's Python reference loop (its
    native core gives the same output bit for bit and is not ported)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    C = A.tocoo()
    off = C.row != C.col
    strong = off & (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    S = sp.csr_matrix(
        (np.ones(int(strong.sum()), np.int8),
         (C.row[strong], C.col[strong])), shape=A.shape)
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    na = 0
    for i in range(n):  # pass 1: roots with untouched neighbourhoods
        nbrs = indices[indptr[i]: indptr[i + 1]]
        if agg[i] == -1 and (agg[nbrs] == -1).all():
            agg[i] = na
            agg[nbrs] = na
            na += 1
    pass1 = agg.copy()
    for i in range(n):  # pass 2: stragglers join a pass-1 aggregate
        if pass1[i] != -1:
            continue
        hit = pass1[indices[indptr[i]: indptr[i + 1]]]
        hit = hit[hit != -1]
        if hit.size:
            agg[i] = hit[0]
    for i in range(n):  # pass 3: leftovers form their own aggregates
        if agg[i] != -1:
            continue
        agg[i] = na
        for j in indices[indptr[i]: indptr[i + 1]]:
            if agg[j] == -1:
                agg[j] = na
        na += 1
    return agg, na


def sa_prolongator(A, theta: float = 0.08, return_parts: bool = False):
    """The smoothed-aggregation prolongator of one coarsening step of an
    SPD A (the JAX package's function, step for step, without its
    aggressive two-pass aggregation, which no solver uses): aggregation
    (``_sa_aggregate``), the tentative prolongator T of unit columns, and one
    damped-Jacobi step P = (I − ω D⁻¹A)·T with ω = 4/(3·λmax(D⁻¹A)), λmax
    by 25 power steps from a fixed seed, times 1.05. ``return_parts``
    also returns the factors of P: (P, agg, tw = 1/√count, wd = ω/diag)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    agg, na = _sa_aggregate(A, theta)
    counts = np.bincount(agg, minlength=na).astype(np.float64)
    T = sp.csr_matrix(
        (1.0 / np.sqrt(counts[agg]), (np.arange(n), agg)), shape=(n, na))
    DinvA = A.multiply((1.0 / d)[:, None]).tocsr()
    v = np.random.default_rng(1).standard_normal(n)
    for _ in range(25):
        v = DinvA @ v
        v /= np.linalg.norm(v)
    lmax = 1.05 * float(v @ (DinvA @ v))
    P = (T - (4.0 / (3.0 * lmax)) * (DinvA @ T)).tocsr()
    P.data[np.abs(P.data) < 1e-13] = 0.0
    P.eliminate_zeros()
    if return_parts:
        tw = 1.0 / np.sqrt(counts[agg])
        wd = (4.0 / (3.0 * lmax)) / d
        return P, agg, tw, wd
    return P


@dataclasses.dataclass(frozen=True)
class _SALevel:
    m: int
    fmt: str  # "dia" | "ell": the level operators' storage
    offA: tuple[int, ...] | None
    offM: tuple[int, ...] | None
    Av: np.ndarray | None  # (m, ndiag) DIA values
    Mv: np.ndarray | None
    eidx: np.ndarray | None  # (m, K) ELL column ids of the A/M union
    ewA: np.ndarray | None  # (m, K) values on eidx
    ewM: np.ndarray | None
    dA: np.ndarray
    dM: np.ndarray
    rsA: np.ndarray
    rsM: np.ndarray
    Pidx: np.ndarray  # (m, Kp) prolongation gather
    Pw: np.ndarray
    Ridx: np.ndarray  # (m_c, Kr) restriction gather
    Rw: np.ndarray
    # the factored transfers of a DIA level, P = (I − ω D⁻¹A)·T
    agg: np.ndarray | None = None  # (m,) parent aggregate
    tw: np.ndarray | None = None  # (m,) 1/√count
    wd: np.ndarray | None = None  # (m,) ω/diag(A)
    mem_idx: np.ndarray | None = None  # (m_c, Kmax) member fine ids
    mem_w: np.ndarray | None = None  # (m_c, Kmax) 0/1 validity


@dataclasses.dataclass(frozen=True)
class SAMultiShiftMultigrid(NestedMultiShiftMultigrid):
    """The multi-shift V-cycle's structure on a smoothed-aggregation
    hierarchy, for meshes without a refinement record: coarse spaces from
    ``sa_prolongator`` on A's graph, A and M both Galerkin-coarsened
    through the same P. A level stays DIA while its diagonals cost at most
    4× its nonzeros (the lex-sorted fine level), else it is stored as ELL
    rows of the A/M union pattern (the aggregated levels)."""

    _DIA_MAX_WASTE = 4.0

    @classmethod
    def build(cls, A_fine, M_fine, nu: int = 2, m_coarse: int = 1024):
        """Aggregate-coarsen (A, M) to at most ``m_coarse`` dofs (or until
        aggregation stops). Returns (structure, (A_c, M_c) dense)."""
        A = sp.csr_matrix(A_fine)
        M = sp.csr_matrix(M_fine)
        levels = []
        while A.shape[0] > m_coarse:
            P, agg, tw, wd = sa_prolongator(A, return_parts=True)
            if P.shape[1] >= A.shape[0]:
                break  # no coarsening progress
            Ac = _rap(A, P)
            Mc = _rap(M, P)
            levels.append(cls._make_level(A, M, P, parts=(agg, tw, wd)))
            A, M = Ac, Mc
        if not levels:
            raise ValueError(
                f"smoothed aggregation built no levels above m_coarse="
                f"{m_coarse} (m={A.shape[0]})")
        if A.shape[0] > 8192:
            raise ValueError(
                f"coarsest level still has {A.shape[0]} dofs (> 8192): "
                "aggregation stalled")
        return cls(tuple(levels), nu), (A.toarray(), M.toarray())

    @classmethod
    def _make_level(cls, A, M, P, parts=None) -> _SALevel:
        m = A.shape[0]
        dia_A = DiaMatrix.from_csr(A)
        dia_M = DiaMatrix.from_csr(M)
        ndiag = max(len(dia_A.offsets), len(dia_M.offsets))
        use_dia = ndiag * m <= cls._DIA_MAX_WASTE * max(A.nnz, M.nnz)
        if use_dia:
            op = dict(offA=dia_A.offsets, offM=dia_M.offsets, Av=dia_A.vals,
                      Mv=dia_M.vals, eidx=None, ewA=None, ewM=None)
        else:
            # the union pattern, so one gather of x serves A and M; the
            # all-ones pattern's weights are the validity mask of the slots
            patt = ((A != 0) + (M != 0)).tocsr()
            eidx, valid = _ell_rows(sp.csr_matrix(
                (np.ones(patt.nnz), patt.indices, patt.indptr),
                shape=patt.shape))
            rows = np.arange(m)[:, None]
            dense = lambda W: (np.asarray(W.todense()) if sp.issparse(W)
                               else np.asarray(W))
            op = dict(offA=None, offM=None, Av=None, Mv=None, eidx=eidx,
                      ewA=dense(A[rows, eidx]) * valid,
                      ewM=dense(M[rows, eidx]) * valid)
        Pidx, Pw = _ell_rows(P)
        Ridx, Rw = _ell_rows(P.T.tocsr())
        fact: dict = {}
        if parts is not None and use_dia:
            agg, tw, wd = parts
            mc = P.shape[1]
            counts = np.bincount(agg, minlength=mc)
            Kmax = max(int(counts.max()), 1)
            order = np.argsort(agg, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(m) - np.repeat(starts, counts)
            mem_idx = np.zeros((mc, Kmax), np.int32)
            mem_w = np.zeros((mc, Kmax), np.float64)
            mem_idx[agg[order], pos] = order
            mem_w[agg[order], pos] = 1.0
            fact = dict(agg=agg.astype(np.int32), tw=tw, wd=wd,
                        mem_idx=mem_idx, mem_w=mem_w)
        st = _level_stats(A, M)
        return _SALevel(m=m, fmt="dia" if use_dia else "ell", Pidx=Pidx,
                        Pw=Pw, Ridx=Ridx, Rw=Rw, **st, **op, **fact)


def flat_level_arrays(msmg, dtype, device, kernels=None) -> list[dict]:
    """The shift-independent tensors of each level of a nested or SA
    hierarchy in ``dtype`` (shared by every shift vector's row params):
    the diagonals, the gather transfers (int64 ids), the DIA values or the
    ELL gather rows, the factored-transfer arrays, and ``kv``, the values
    of the level's kernel level (``kernels[l].values``) where one is
    given."""
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    ids = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    out = []
    for li, lev in enumerate(msmg.levels):
        a = {"dA": cast(lev.dA), "dM": cast(lev.dM), "Pidx": ids(lev.Pidx),
             "Pw": cast(lev.Pw), "Ridx": ids(lev.Ridx), "Rw": cast(lev.Rw)}
        if getattr(lev, "fmt", "dia") == "dia":
            a.update(Av=cast(lev.Av), Mv=cast(lev.Mv))
            if getattr(lev, "agg", None) is not None:
                a.update(agg=ids(lev.agg), tw=cast(lev.tw), wd=cast(lev.wd),
                         mem_idx=ids(lev.mem_idx), mem_w=cast(lev.mem_w))
        else:
            a.update(eidx=ids(lev.eidx), ewA=cast(lev.ewA),
                     ewM=cast(lev.ewM))
        if kernels is not None and kernels[li] is not None:
            a["kv"] = kernels[li].values(lev, dtype, device)
        out.append(a)
    return out


def flat_row_params(msmg, omega_rows: np.ndarray, dtype, device,
                    arrays: list[dict]) -> list[dict]:
    """Per-level row params of a nested or SA hierarchy for a per-row
    shift vector: the ω, 1/θ, 1/δ columns (T, 1) from the exact Gershgorin
    bound of D(ω)⁻¹(A + ωM) at the distinct shifts (the JAX package's
    ``row_params``), their (T,) views ``cols`` for the kernels, and the
    level's ``arrays`` (``flat_level_arrays``)."""
    omega_rows = np.asarray(omega_rows, np.float64)
    uniq, inv = np.unique(omega_rows, return_inverse=True)
    out = []
    for lev, a in zip(msmg.levels, arrays):
        lam_u = np.empty(uniq.size)
        for k, w in enumerate(uniq):
            lam_u[k] = ((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM)).max()
        lam = 1.1 * lam_u[inv]
        col = lambda v: row_scale(v, 1, dtype, device)
        lp = {"omega": col(omega_rows), "inv_theta": col(1.0 / (0.625 * lam)),
              "inv_delta": col(1.0 / (0.375 * lam)), **a}
        lp["cols"] = {"omega": lp["omega"].reshape(-1),
                      "invT": lp["inv_theta"].reshape(-1),
                      "invDel": lp["inv_delta"].reshape(-1)}
        out.append(lp)
    return out


# -------------------------------------- unstructured hierarchies (device)


class NestedMultiShiftMG:
    """V-cycles of a host ``NestedMultiShiftMultigrid`` on (T, m) tensors.
    ``vcycle`` and ``solve`` take an optional per-level list of kernel
    levels: ``ops.dia_kernels.DiaKernelLevel`` (kind "dia": K16 sweeps, K17
    residuals; values under ``lp["kv"]``) and, on the SA hierarchy,
    ``ops.spmv.EllKernelLevel`` (kind "ell"). Without one a level runs the
    JAX package's XLA form (``op``, ``smooth``, the gather transfers)."""

    def __init__(self, msmg, nu: int | None = None):
        self.msmg = msmg
        self.nu = msmg.nu if nu is None else nu
        self.nu_post = msmg.nu_post

    def op(self, lvl: int, lp, x, kl=None):
        """A x + ω⊙M x by the DIA matvecs."""
        lev = self.msmg.levels[lvl]
        return (dia_matvec(lp["Av"], lev.offA, x)
                + lp["omega"] * dia_matvec(lp["Mv"], lev.offM, x))

    def smooth(self, lvl: int, lp, x, b, nu: int | None = None, kl=None):
        """The degree-ν sweep (x = 0 where None) with the per-node Jacobi
        term 1/(dA + ω·dM); ``kl`` an ELL kernel level applies Op."""
        cols = {"inv_diag": 1.0 / (lp["dA"] + lp["omega"] * lp["dM"]),
                "inv_theta": lp["inv_theta"], "inv_delta": lp["inv_delta"]}
        return cheb_smooth(lambda v: self.op(lvl, lp, v, kl), cols, x, b,
                           self.nu if nu is None else nu)

    @staticmethod
    def gather_apply(w, idx, v):
        """(…, n_src) -> (…, n_dst): Σ_k w[:, k]·v[…, idx[:, k]]."""
        out = None
        for k in range(idx.shape[-1]):
            term = w[:, k] * v.index_select(-1, idx[:, k])
            out = term if out is None else out + term
        return out

    def restrict(self, lvl: int, lp, r, kl=None):
        return self.gather_apply(lp["Rw"], lp["Ridx"], r)

    def interp(self, lvl: int, lp, e, kl=None):
        return self.gather_apply(lp["Pw"], lp["Pidx"], e)

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0, kernels=None):
        """One V-cycle from x = 0."""
        if lvl == len(self.msmg.levels):
            return coarse_solve(b)
        lp = lps[lvl]
        kl = kernels[lvl] if kernels is not None else None
        dia = kl is not None and kl.kind == "dia"
        if dia:
            x = kl.smooth(None, b, lp["cols"], lp["kv"], zero_init=True)
            r = kl.residual(x, b, lp["cols"], lp["kv"])
        else:
            x = self.smooth(lvl, lp, None, b, kl=kl)
            r = b - self.op(lvl, lp, x, kl)
        ec = self.vcycle(self.restrict(lvl, lp, r, kl), lps, coarse_solve,
                         lvl + 1, kernels)
        x = x + self.interp(lvl, lp, ec, kl)
        if dia:
            return kl.smooth(x, b, lp["cols"], lp["kv"], post=True)
        return self.smooth(lvl, lp, x, b, nu=self.nu_post, kl=kl)

    def solve(self, b, lps, coarse_solve, cycles: int = 2, kernels=None):
        """``cycles`` V-cycles from a zero initial guess; the later cycles
        start from the residual (K17 on a DIA kernel level)."""
        x = self.vcycle(b, lps, coarse_solve, kernels=kernels)
        kl = kernels[0] if kernels is not None else None
        for _ in range(cycles - 1):
            if kl is not None and kl.kind == "dia":
                r = kl.residual(x, b, lps[0]["cols"], lps[0]["kv"])
            else:
                r = b - self.op(0, lps[0], x, kl)
            x = x + self.vcycle(r, lps, coarse_solve, kernels=kernels)
        return x


class SAMultiShiftMG(NestedMultiShiftMG):
    """V-cycles of a host ``SAMultiShiftMultigrid``: DIA levels as in the
    nested hierarchy, with the factored transfers where the level has them
    (the banded A application by K18 on a kernel level); ELL levels by the
    union-pattern gather form, or with an ``EllKernelLevel`` the operator
    pair by K19 and both transfers by K20."""

    def op(self, lvl: int, lp, x, kl=None):
        if getattr(self.msmg.levels[lvl], "fmt", "dia") == "dia":
            return super().op(lvl, lp, x)
        if kl is not None:
            yA, yM = kl.op_pair(x, lp["kv"])
            return yA + lp["omega"] * yM
        outA = outM = None
        for k in range(lp["eidx"].shape[-1]):
            g = x.index_select(-1, lp["eidx"][:, k])
            tA = lp["ewA"][:, k] * g
            tM = lp["ewM"][:, k] * g
            outA = tA if outA is None else outA + tA
            outM = tM if outM is None else outM + tM
        return outA + lp["omega"] * outM

    def _fact(self, lvl: int, lp) -> bool:
        """Whether level ``lvl`` transfers through the factors of its P: a
        DIA level whose row params carry its aggregates (P·e and Pᵀ·r by
        one banded A application and a parent gather or a member sum, in
        place of the K-wide gathers)."""
        return (getattr(self.msmg.levels[lvl], "fmt", "dia") == "dia"
                and "agg" in lp)

    def apply_A_fact(self, lvl: int, lp, kl, v):
        """A v for the factored transfers: K18 on a kernel level, else the
        DIA matvec."""
        if kl is not None:
            return kl.apply_A(v, lp["kv"])
        return dia_matvec(lp["Av"], self.msmg.levels[lvl].offA, v)

    def restrict_fact(self, lvl: int, lp, kl, r):
        """Pᵀ r = Tᵀ(I − ω A D⁻¹) r: one A application and a member sum."""
        u = r - self.apply_A_fact(lvl, lp, kl, lp["wd"] * r)
        return self.gather_apply(lp["mem_w"], lp["mem_idx"], lp["tw"] * u)

    def interp_fact(self, lvl: int, lp, kl, e):
        """P e = (I − ω D⁻¹A) T e: a parent gather and one A application."""
        g = lp["tw"] * e.index_select(-1, lp["agg"])
        return g - lp["wd"] * self.apply_A_fact(lvl, lp, kl, g)

    def restrict(self, lvl: int, lp, r, kl=None):
        if kl is not None and kl.kind == "ell":
            return kl.restrict(r, lp["kv"])
        if self._fact(lvl, lp):
            return self.restrict_fact(lvl, lp, kl, r)
        return super().restrict(lvl, lp, r)

    def interp(self, lvl: int, lp, e, kl=None):
        if kl is not None and kl.kind == "ell":
            return kl.interp(e, lp["kv"])
        if self._fact(lvl, lp):
            return self.interp_fact(lvl, lp, kl, e)
        return super().interp(lvl, lp, e)
