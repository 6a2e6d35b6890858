"""The space-time heat-equation solver on PyTorch tensors.

The counterpart of ``spacetime_tpu.solver.heateq.HeatSolver`` on uniform
and graded dyadic time grids, with the same stabilized minimal-residual
formulation, the same operator algebra and the same operation order, so
float64 residual histories agree with the JAX package (and the NumPy
oracle) to rounding.
Host setup (assembly, stencils, blocked ELL, the multigrid hierarchy,
spectral bounds, dense inverses, the wavelet structure, the quadrature of
the loads) runs on the port's own copies of the JAX package's host modules;
every per-iteration operation runs on ``device``.

Spatial formats (``spatial_format``; "auto" picks as the JAX package does):

- ``"stencil"``: constant stencils on structured grids (``smooth2d``,
  ``smooth3d``, ``moving_peak2d``). B and Bᵀ run as the stab-fused pair of
  ``ops.kron`` (K1, K2) in ``apply_S`` and as the plain Bᵀ in
  ``rhs_device``.
- ``"vstencil"``: per-node A weights with the constant mass stencil, for
  coefficient-weighted systems on structured grids (``varcoef2d``,
  ``varcoef3d``). A_w runs the weighted stencil kernel (K12); B, Bᵀ and the
  stab term are plain PyTorch around it, as the JAX package computes them
  in XLA.
- ``"dia"`` and ``"ell"``: the flat dof layout ``gs = (m,)`` of meshes
  without a grid (the L-shaped domain), A and M by diagonals
  (``ops.sparse.dia_matvec``, plain PyTorch as the JAX package's XLA form)
  or in blocked ELL (K20, ``ops.spmv``). B, Bᵀ, stab and the inner solves
  run on these. The JAX package falls back to DIA for f64 on ``"ell"``,
  because Pallas on the TPU has no f64; on CUDA the port runs K20 in both
  dtypes, so every SpMV of A and M on this format is K20.

Inner solvers (``inner``; "auto": dense at m ≤ 4096, multigrid on
structured grids and refinement chains, Chebyshev otherwise):

- ``"dense"``: exact inverses precomputed on the host, K_Y = A⁻¹, K_H = M⁻¹
  and one sandwich (A+ω_jM)⁻¹A(A+ω_jM)⁻¹ per wavelet level, applied as
  ``torch.matmul`` (TF32 off, ``utils.device``), as the JAX package leaves
  them to XLA.
- ``"cheb"``: fixed Chebyshev–Jacobi polynomials in the spatial operators
  (degrees from the spectral bounds and ``cheb_eps``; the wavelet
  sandwiches at 30·``cheb_eps``), a Python loop over the coefficient rows
  (``ops.multigrid.cheb_run``) where JAX scans them.
- ``"mg"`` on the flat formats of a mesh with a refinement chain
  (``fem.refine_hierarchy``): the nested hierarchy; ``"amg"``: the
  smoothed-aggregation hierarchy (any flat-format mesh). Every DIA level
  runs K16–K18 (``ops.dia_kernels``), every aggregated ELL level K19 and
  the K20 transfers (``ops.spmv``), in f32 and f64, with no size gate;
  K_X's middle A is K18; K_H ≈ M⁻¹ the Chebyshev polynomial in M of
  ``inner="cheb"`` at 1e-3. ``inner`` then reads "mg" and ``mg_flavor``
  names the hierarchy.
- ``"mg"``: multi-shift multigrid on structured grids. Constant stencils:
  every V-cycle level runs the kernels of ``ops.mg_kernels`` (fused K6/K7
  in 2-D and 3-D where ν = ν_post ∈ {2, 3}, else the semi-fused K3, K8, K9,
  K3), K_X's middle application is K5, K_H ≈ M⁻¹ the degree-30 stencil
  Chebyshev. Weighted: the Galerkin hierarchy with the weighted kernels
  (K14/K15 fused, else K10, K13, K9, K10; K11 starts later cycles; K12 in
  K_X). The sweeps take any ν ≥ 1 (above the tiled kernels' halo they
  chain one-step launches).

All kernels are CUDA kernels for CUDA tensors and their plain twins on the
CPU; on CUDA no level or format falls back to the plain form.

Time grids: uniform (2^J steps) or graded toward t = 0 (``build_solver``'s
``extra_time_levels``, the singular problems). On a graded grid the wavelet
lifting runs in its gather form (``ops.wavelets``), and the per-level
solves of K_X (the coarse-grid solves of its V-cycle, the dense and
Chebyshev sandwiches) take each wavelet level's rows by the permutation
``perm`` that sorts the nodes by level, and put them back by ``inv_perm``;
on a uniform grid the levels are strided slices.

Outside the port so far (raising ``NotImplementedError`` with the ROADMAP.md
queue 1 item that ports it): the Galerkin hierarchy of a weighted
structured grid on the flat formats, on-device load quadrature, the
fused/flexible PCG variants, checkpointing and double-single refinement
legs. Runs on a mesh of ranks (time, or time × space) are the solvers of
``spacetime_tpu_torch.parallel``, built on this one.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from ..fem import (
    P1System,
    TimeGrid,
    domain_mesh,
    graded_time_grid,
    l2_error_spacetime,
    refine_hierarchy,
    spacetime_loads,
    time_matrices,
    uniform_time_grid,
)
from ..models import Problem, get_problem
from ..ops import kron, spmv
from ..ops import wavelets as wav
from ..ops.blocked_ell import BlockedEll
from ..ops.dia_kernels import DiaKernelLevel
from ..ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from ..ops.multigrid import (GalerkinMultiShiftMG, GalerkinMultiShiftMultigrid,
                             MultiShiftMG, MultiShiftMultigrid,
                             NestedMultiShiftMG, NestedMultiShiftMultigrid,
                             SAMultiShiftMG, SAMultiShiftMultigrid, _GMSLevel,
                             cheb_run, chebyshev_coefficients, coef_rows,
                             chebyshev_degree, chebyshev_stencil_inverse,
                             flat_level_arrays, flat_row_params,
                             generic_spectral_bounds, mass_spectral_bounds,
                             row_params, var_row_params)
from ..ops.sparse import DiaMatrix, dia_matvec
from ..ops.stencil import (StencilOperator, grouped_apply, row_scale,
                           weight_groups)
from ..utils.device import resolve_device, synchronize
from .pcg import pcg

_DTYPES = (torch.float32, torch.float64)
_FORMATS = ("auto", "stencil", "vstencil", "dia", "ell")


def _later(what: str, item: int, title: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item {item} ({title})"
    )


@dataclasses.dataclass
class SolveResult:
    U: np.ndarray  # (N_t+1, m) flat interior coefficients
    iterations: int
    residuals: np.ndarray
    precond_residuals: np.ndarray
    converged: bool
    l2_error: float | None = None
    solve_seconds: float = 0.0  # rhs + PCG on the device, synchronised
    transfer_seconds: float = 0.0  # the iterate device -> host
    setup_seconds: float = 0.0
    rhs_seconds: float = 0.0  # host load quadrature (once per solver)


class _LoadsOn:
    """``problem`` with its source evaluated on ``device``: the host
    quadrature (``spacetime_loads``) calls ``g_many`` and ``u0``."""

    def __init__(self, problem: Problem, device: torch.device):
        self._problem = problem
        self._device = device

    def g_many(self, ts, X):
        return self._problem.g_many(ts, X, device=self._device)

    def u0(self, X):
        return self._problem.u0(X)


def _assert_dtype(tree, dtype):
    if isinstance(tree, dict):
        for v in tree.values():
            _assert_dtype(v, dtype)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _assert_dtype(v, dtype)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point() and (
        tree.dtype != dtype
    ):
        raise RuntimeError(f"params tensor of dtype {tree.dtype}, expected {dtype}")


class HeatSolver:
    """Single-device solver. Setup runs once on the host; ``solve`` and
    ``solve_refined`` run on ``device`` ("cuda" unless "cpu" is asked for)."""

    def __init__(
        self,
        problem: Problem,
        system: P1System,
        grid: TimeGrid,
        dtype: torch.dtype = torch.float64,
        spatial_format: str = "auto",
        inner: str = "auto",
        mg_cycles: int = 3,
        mg_cycles_kx: int | None = None,
        mg_nu: int = 2,
        mg_nu_kx: int | None = None,
        mg_nu_post: int | None = None,
        mg_coarse: int | None = None,
        space_n: int | None = None,
        pcg_variant: str = "standard",
        rhs: str = "auto",
        cheb_eps: float = 1e-3,
        device: str | torch.device = "cuda",
    ):
        """``cheb_eps``: relative accuracy of the K_Y / K_H Chebyshev
        polynomials of ``inner="cheb"`` (the wavelet sandwich runs at 30×
        it); the polynomials are fixed at setup."""
        t0 = _time.perf_counter()
        self.device = resolve_device(device)
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be torch.float32 or float64, not {dtype}")
        self.problem = problem
        self.system = system
        self.grid = grid
        self.dtype = dtype
        self.N = grid.num_intervals
        self.m = system.m
        self.wt = wav.build_wavelet_transform(grid)
        # the wavelet levels' rows in ``perm`` order (graded grids)
        self.level_bounds = np.concatenate(
            [[0], np.cumsum(self.wt.level_counts)]).astype(int)

        # --- spatial format ------------------------------------------------
        gs = system.mesh.grid_shape
        weighted = system.weighted
        structured = gs is not None and min(gs) >= 3
        if spatial_format not in _FORMATS:
            raise ValueError(f"unknown spatial_format {spatial_format!r}")
        if spatial_format == "auto":
            spatial_format = ("dia" if not structured
                              else "vstencil" if weighted else "stencil")
        if spatial_format == "stencil" and weighted:
            raise ValueError(
                "spatial_format='stencil' needs a translation-invariant "
                "operator; coefficient-weighted systems use 'vstencil', "
                "'dia' or 'ell'"
            )
        if spatial_format in ("stencil", "vstencil") and not structured:
            raise ValueError(
                f"spatial_format={spatial_format!r} needs a structured grid "
                "(mesh.grid_shape)"
            )
        if spatial_format == "vstencil" and not weighted:
            raise ValueError(
                "spatial_format='vstencil' needs a coefficient-weighted "
                "system (P1System.weighted)"
            )
        self.spatial_format = spatial_format
        self.weighted = weighted
        self.flat = spatial_format in ("dia", "ell")
        self.gs = (self.m,) if self.flat else tuple(gs)
        dim = system.mesh.dim
        self._host = {"h": time_matrices(grid)["h"]}
        self.taps = None
        if spatial_format in ("stencil", "vstencil"):
            M_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.M),
                                            self.gs)
            self._groups_M = weight_groups(M_st.disps, M_st.weights)
        if spatial_format == "stencil":
            A_st = StencilOperator.from_dia(
                DiaMatrix.from_csr(system.A), self.gs)
            self.taps = kron.KronTaps.from_stencils(M_st, A_st)
        if self.flat:
            dia = {"M": DiaMatrix.from_csr(system.M),
                   "A": DiaMatrix.from_csr(system.A)}
            self._dia_off = {k: d.offsets for k, d in dia.items()}
            self._host.update(dia_Mv=dia["M"].vals, dia_Av=dia["A"].vals)
            if spatial_format == "ell":
                self._ell = {
                    k: spmv.EllOperator(BlockedEll.from_csr(mat), dtype,
                                        self.device)
                    for k, mat in (("M", system.M), ("A", system.A))
                }

        # --- inner solver ----------------------------------------------------
        structured_sq = (structured and len(set(gs)) == 1
                         and (gs[0] + 1) % 2 == 0)
        refined = system.mesh.refined_from is not None
        if inner == "auto":
            if self.m <= 4096:
                inner = "dense"
            elif (spatial_format == "stencil" or (weighted and structured_sq)
                  or refined):
                # structured grids, weighted structured grids and meshes
                # with a recorded refinement chain have nested P1 spaces
                inner = "mg"
            else:
                inner = "cheb"
        if inner not in ("dense", "cheb", "mg", "amg"):
            raise ValueError(f"unknown inner solver {inner!r}")
        if inner == "amg" and not self.flat:
            raise ValueError(
                "inner='amg' runs in the flat dof layout (spatial_format "
                "'dia'/'ell'); structured grids already have geometric "
                "multigrid (inner='mg')")
        if inner == "mg" and self.flat and not refined:
            if weighted and structured_sq:
                raise _later(
                    f"inner='mg' on the {spatial_format!r} format of a "
                    "weighted structured grid (the Galerkin hierarchy in the "
                    "flat layout)", 5, "unstructured hierarchies")
            raise ValueError(
                "inner='mg' on the flat formats needs a mesh with a "
                "refinement chain (fem.refine_hierarchy)")
        self.inner = inner
        if mg_cycles < 1 or (mg_cycles_kx is not None and mg_cycles_kx < 1):
            raise ValueError(
                f"mg_cycles={mg_cycles} / mg_cycles_kx={mg_cycles_kx}: "
                "V-cycle counts must be >= 1"
            )
        if mg_nu < 1 or (mg_nu_kx is not None and mg_nu_kx < 1) or (
            mg_nu_post is not None and mg_nu_post < 1
        ):
            raise ValueError(
                f"mg_nu={mg_nu} / mg_nu_kx={mg_nu_kx} / mg_nu_post="
                f"{mg_nu_post}: smoothing step counts must be >= 1"
            )
        omegas = [
            float(self.wt.level_shift[j]) for j in range(self.wt.num_levels + 1)
        ]
        self._kl_A = None  # the finest weighted level's K12 (vstencil)
        self._flat_mg = False
        self.mg_flavor = None
        if inner == "dense":
            A_dense = system.A.toarray()
            M_dense = system.M.toarray()
            self._host["Kx_inv"] = np.linalg.inv(A_dense)
            self._host["Minv"] = np.linalg.inv(M_dense)
            sandwiches = []
            for omega in omegas:
                Sj = np.linalg.inv(A_dense + omega * M_dense)
                sandwiches.append(Sj @ A_dense @ Sj)
            self._host["sandwich"] = sandwiches
        elif inner == "cheb":
            self._setup_cheb(system, omegas, cheb_eps)
        elif self.flat:
            self._setup_flat_mg(system, omegas, inner, mg_cycles,
                                mg_cycles_kx, mg_nu, mg_nu_kx, mg_nu_post,
                                mg_coarse)
        else:
            self._setup_mg(system, dim, omegas, mg_cycles, mg_cycles_kx,
                           mg_nu, mg_nu_kx, mg_nu_post, mg_coarse, space_n)
        if spatial_format == "vstencil" and self._kl_A is None:
            fine = _GMSLevel.from_matrices(system.A, system.M, self.gs)
            self._kl_A = VarMSKernelLevel(fine, 1)
            self._host["Aw"] = fine.Aw

        if pcg_variant != "standard":
            raise _later(f"pcg_variant={pcg_variant!r}", 6,
                         "PCG variants, checkpointing and the rest of the CLI")
        self.pcg_variant = pcg_variant
        if rhs == "device":
            raise _later("rhs='device' (on-device load quadrature)", 3,
                         "on-device loads and L2 error")
        if rhs not in ("auto", "host"):
            raise ValueError(f"unknown rhs mode {rhs!r}")
        self.rhs_mode = "host"
        self._params_cache: dict = {}
        self._rhs_host = None
        self._rhs_dev: dict = {}
        self.rhs_seconds = 0.0
        self.params = self.params_for(dtype)
        self.setup_seconds = _time.perf_counter() - t0

    def _setup_cheb(self, system, omegas, cheb_eps):
        """Spectral bounds, degrees, Jacobi vectors and coefficient rows of
        the Chebyshev inner solves (the JAX package's ``inner="cheb"``
        setup): K_Y and K_H at ``cheb_eps``, the shifted solves of the
        wavelet sandwiches at 30·``cheb_eps``, their bounds from A's and M's
        by the row-wise mediant inequality."""
        dA = np.asarray(system.A.diagonal())
        dM = np.asarray(system.M.diagonal())
        rsA = np.asarray(np.abs(system.A).sum(axis=1)).ravel()
        rsM = np.asarray(np.abs(system.M).sum(axis=1)).ravel()
        laA, _ = generic_spectral_bounds(system.A)
        # P1 mass: λmin(D⁻¹M) ≥ 1/2 on any simplicial mesh
        laM, _ = generic_spectral_bounds(system.M, known_lmin=0.5)
        self._cheb_spec = {
            "A": (laA, float((rsA / dA).max()),
                  chebyshev_degree(laA, (rsA / dA).max(), cheb_eps)),
            "M": (laM, float((rsM / dM).max()),
                  chebyshev_degree(laM, (rsM / dM).max(), cheb_eps)),
        }
        shifts = []
        for omega in omegas:
            d_w = dA + omega * dM
            lmin_w = float(((laA * dA + omega * laM * dM) / d_w).min())
            lmax_w = float(((rsA + omega * rsM) / d_w).max())
            shifts.append(
                (omega, lmin_w, lmax_w,
                 chebyshev_degree(lmin_w, lmax_w, 30.0 * cheb_eps))
            )
        self._cheb_spec["shift"] = shifts
        self._host["cheb_invA"] = 1.0 / dA
        self._host["cheb_invM"] = 1.0 / dM
        self._host["cheb_invS"] = [1.0 / (dA + omega * dM) for omega in omegas]
        self._host["cheb_coefA"] = chebyshev_coefficients(*self._cheb_spec["A"])
        self._host["cheb_coefM"] = chebyshev_coefficients(*self._cheb_spec["M"])
        self._host["cheb_coefS"] = [
            chebyshev_coefficients(lmin_w, lmax_w, deg)
            for (_, lmin_w, lmax_w, deg) in shifts
        ]

    def _setup_flat_mg(self, system, omegas, inner, mg_cycles, mg_cycles_kx,
                       mg_nu, mg_nu_kx, mg_nu_post, mg_coarse):
        """The flat-layout hierarchies: nested red refinement (``mg`` on a
        mesh with a refinement chain) or smoothed aggregation (``amg``);
        their kernel levels (K16–K18 on every DIA level, K19/K20 on every
        ELL level), the dense coarse inverses and K_H ≈ M⁻¹ as a Chebyshev
        polynomial in M (bounds from ``generic_spectral_bounds`` with
        λmin(D⁻¹M) ≥ ½, degree for 1e-3). ``inner`` becomes "mg";
        ``mg_flavor`` names the hierarchy (JAX ``_finish_flat_mg``)."""
        self.mg_cycles = mg_cycles
        self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
        self.mg_nu = mg_nu
        self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
        self.mg_nu_post = mg_nu_post
        # always coarsen at least once where a chain exists
        m_coarse = min(1024 if mg_coarse is None else mg_coarse,
                       max(self.m // 4, 1))
        if inner == "amg":
            msmg, (A_c, M_c) = SAMultiShiftMultigrid.build(
                system.A, system.M, nu=mg_nu, m_coarse=m_coarse)
            mg_cls = SAMultiShiftMG
        else:
            msmg, (A_c, M_c) = NestedMultiShiftMultigrid.build(
                system.mesh, system.A, system.M, nu=mg_nu, m_coarse=m_coarse)
            mg_cls = NestedMultiShiftMG
        if mg_nu_post is not None:
            msmg = dataclasses.replace(msmg, nu_post=mg_nu_post)
        self.inner = "mg"
        self.mg_flavor = type(msmg).__name__
        self._flat_mg = True
        self.msmg = msmg
        self._mg_ky = mg_cls(msmg)
        self._mg_kx = mg_cls(msmg, nu=self.mg_nu_kx)
        # every level runs its kernels: no size gate, no f64 fallback
        ell = {li: spmv.EllKernelLevel(lev)
               for li, lev in enumerate(msmg.levels)
               if getattr(lev, "fmt", "dia") == "ell"}
        mk_levels = lambda nu: [
            ell[li] if li in ell else DiaKernelLevel(lev, nu,
                                                     nu_post=mg_nu_post)
            for li, lev in enumerate(msmg.levels)
        ]
        self._kl_ky = mk_levels(mg_nu)
        self._kl_kx = (self._kl_ky if self.mg_nu_kx == mg_nu
                       else mk_levels(self.mg_nu_kx))
        self._host.update({
            "omega_ky": np.zeros(self.N),
            "omega_kx": np.asarray(
                [float(self.wt.level_shift[j]) for j in self.wt.node_level]
            ),
            "mg_cinv_ky": np.linalg.inv(A_c),
            "mg_cinv": [np.linalg.inv(A_c + w * M_c) for w in omegas],
        })
        dM = np.asarray(system.M.diagonal())
        rsM = np.asarray(np.abs(system.M).sum(axis=1)).ravel()
        laM, _ = generic_spectral_bounds(system.M, known_lmin=0.5)
        lmaxM = float((rsM / dM).max())
        self._cheb_spec = {
            "M": (laM, lmaxM, chebyshev_degree(laM, lmaxM, 1e-3))}
        self._host["cheb_invM"] = 1.0 / dM
        self._host["cheb_coefM"] = chebyshev_coefficients(
            *self._cheb_spec["M"])

    def _setup_mg(self, system, dim, omegas, mg_cycles, mg_cycles_kx, mg_nu,
                  mg_nu_kx, mg_nu_post, mg_coarse, space_n):
        """The multigrid hierarchy (constant or Galerkin), its kernel levels
        per ν and the dense coarse inverses."""
        if space_n is None:
            if len(set(self.gs)) != 1:
                raise ValueError("pass space_n for non-square grids")
            space_n = self.gs[0] + 1
        self.mg_cycles = mg_cycles
        self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
        self.mg_nu = mg_nu
        self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
        self.mg_nu_post = mg_nu_post
        if mg_coarse is None:
            # the coarse level's dense inverses grow as (n-1)^(2·dim): 31³
            # points would take ~3.5 GB each in f32
            mg_coarse = 32 if dim == 2 else 16
        n_coarse = min(mg_coarse, max(space_n // 2, 4))
        if self.weighted:
            # Galerkin RAP off the assembled fine matrices (the coefficients
            # are not re-assembled per level)
            msmg, (A_c, M_c) = GalerkinMultiShiftMultigrid.build(
                dim, space_n, system.A, system.M, nu=mg_nu, n_coarse=n_coarse)
            mg_cls, kl_cls = GalerkinMultiShiftMG, VarMSKernelLevel
            kl_args = lambda lev: (lev,)
        else:
            cache: dict = {}
            if self.gs == (space_n - 1,) * dim:
                cache[space_n] = system
            msmg, (A_c, M_c) = MultiShiftMultigrid.build(
                dim, space_n, nu=mg_nu, n_coarse=n_coarse, _system_cache=cache,
            )
            odd = [lev.n for lev in msmg.levels if lev.n % 2]
            if odd:
                # n → n // 2 is a nested P1 coarsening only for even n
                raise ValueError(
                    f"space_n={space_n}: the multigrid levels {odd} have an "
                    "odd number of cells; every level above the coarse grid "
                    "needs an even one"
                )
            mg_cls, kl_cls = MultiShiftMG, MSKernelLevel
            kl_args = lambda lev: (lev.A_st, lev.M_st)
        if mg_nu_post is not None:
            msmg = dataclasses.replace(msmg, nu_post=mg_nu_post)
        self.msmg = msmg
        self._mg_ky = mg_cls(msmg)
        self._mg_kx = mg_cls(msmg, nu=self.mg_nu_kx)
        # The kernel levels per ν (K_X's own when mg_nu_kx differs), on every
        # level: the dtype enters through the tensors and params_for's
        # columns. The JAX package's 40,000-point gate measured XLA fusion
        # against Mosaic on the TPU and has no counterpart here.
        mk_levels = lambda nu: [
            kl_cls(*kl_args(lev), nu, nu_post=mg_nu_post)
            for lev in msmg.levels
        ]
        self._kl_ky = mk_levels(mg_nu)
        self._kl_kx = (
            self._kl_ky if self.mg_nu_kx == mg_nu else mk_levels(self.mg_nu_kx)
        )
        if self.weighted:
            self._kl_A = self._kl_ky[0]
        self._host.update({
            "omega_ky": np.zeros(self.N),
            "omega_kx": np.asarray(
                [float(self.wt.level_shift[j]) for j in self.wt.node_level]
            ),
            "mg_cinv_ky": np.linalg.inv(A_c),
            "mg_cinv": [np.linalg.inv(A_c + w * M_c) for w in omegas],
        })
        # K_H ≈ M⁻¹: M is the constant mass stencil on both formats, so the
        # JAX package's per-node Jacobi vector of the weighted format holds
        # one value, the stencil's 1/center
        M_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.M), self.gs)
        lmin, lmax = mass_spectral_bounds(dim)
        center = dict(zip(M_st.disps, M_st.weights))[(0,) * dim]
        self._cheb_Minv = chebyshev_stencil_inverse(
            M_st, 1.0 / center, lmin, lmax, 30
        )

    # ------------------------------------------------------------- params

    def params_for(self, dtype: torch.dtype) -> dict:
        """Device tensors of the operators in ``dtype`` (cached). Per-time-row
        scales are (T, 1, ..., 1) columns over the layout's axes. By format:
        ``kron`` (stencil: the (T,) vectors h/2 and h/16 of K1/K2), ``Aw``
        (vstencil: the finest level's weights), ``dia_Mv``/``dia_Av``
        (dia, ell) and ``ell_M``/``ell_A`` (ell: K20's packed layout). By
        inner solver: ``Kx_inv``, ``Minv``, ``sandwich`` (dense); the
        Jacobi vectors ``cheb_inv*`` and coefficient rows ``cheb_coef*``
        (cheb; the rows as Python floats rounded to ``dtype``); the coarse
        inverses and each level's row params with their kernels' ``cols``
        (mg; the weighted levels' weights "Aw" shared between K_Y's and
        K_X's row params)."""
        if dtype in self._params_cache:
            return self._params_cache[dtype]
        dev, nd = self.device, len(self.gs)
        cast = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()
        h = self._host["h"]
        p = {
            "h_half": row_scale(0.5 * h, nd, dtype, dev),
            "h_stab": row_scale(h / 16.0, nd, dtype, dev),
            "inv_h": row_scale(1.0 / h, nd, dtype, dev),
            "wavelet": wav.wavelet_params(self.wt, dtype, dev),
        }
        if not self.wt.is_uniform:
            perm = self.wt.perm_by_level
            inv_perm = np.empty_like(perm)
            inv_perm[perm] = np.arange(self.N + 1)
            p["perm"] = torch.as_tensor(perm, dtype=torch.int64, device=dev)
            p["inv_perm"] = torch.as_tensor(inv_perm, dtype=torch.int64,
                                            device=dev)
        if self.spatial_format == "stencil":
            p["kron"] = {
                "h128": p["h_half"].reshape(self.N),
                "hs128": p["h_stab"].reshape(self.N),
            }
        if self.flat:
            p["dia_Mv"] = cast(self._host["dia_Mv"])
            p["dia_Av"] = cast(self._host["dia_Av"])
        if self.spatial_format == "ell":
            for k, op in self._ell.items():
                p["ell_" + k] = op.params_for(dtype)
        if self.inner == "dense":
            p["Kx_inv"] = cast(self._host["Kx_inv"])
            p["Minv"] = cast(self._host["Minv"])
            p["sandwich"] = [cast(S) for S in self._host["sandwich"]]
        elif self.inner == "cheb":
            gsh = lambda v: cast(v).reshape(self.gs)
            p["cheb_invA"] = gsh(self._host["cheb_invA"])
            p["cheb_invM"] = gsh(self._host["cheb_invM"])
            p["cheb_invS"] = [gsh(v) for v in self._host["cheb_invS"]]
            p["cheb_coefA"] = coef_rows(self._host["cheb_coefA"], dtype)
            p["cheb_coefM"] = coef_rows(self._host["cheb_coefM"], dtype)
            p["cheb_coefS"] = [coef_rows(c, dtype)
                               for c in self._host["cheb_coefS"]]
        if self.inner == "mg":
            p["mg_cinv_ky"] = cast(self._host["mg_cinv_ky"])
            p["mg_cinv"] = [cast(S) for S in self._host["mg_cinv"]]
        if self._flat_mg:
            # the level arrays and kernel values are shift-independent:
            # one copy serves K_Y's and K_X's row params
            arrays = flat_level_arrays(self.msmg, dtype, dev, self._kl_ky)
            for name in ("ky", "kx"):
                p["ms_" + name] = flat_row_params(
                    self.msmg, self._host["omega_" + name], dtype, dev, arrays)
            p["cheb_invM"] = cast(self._host["cheb_invM"]).reshape(self.gs)
            p["cheb_coefM"] = coef_rows(self._host["cheb_coefM"], dtype)
        elif self.inner == "mg":
            if self.weighted:
                Aw = [cast(lev.Aw) for lev in self.msmg.levels]
                rows = lambda om: var_row_params(self.msmg, om, dtype, dev, Aw)
                p["Aw"] = Aw[0]
            else:
                rows = lambda om: row_params(self.msmg, om, dtype, dev)
            p["ms_ky"] = rows(self._host["omega_ky"])
            p["ms_kx"] = rows(self._host["omega_kx"])
            for lp in p["ms_ky"] + p["ms_kx"]:
                lp["cols"] = self._kl_ky[0].columns(lp)
        elif self.spatial_format == "vstencil":
            p["Aw"] = cast(self._host["Aw"])
        self._params_cache[dtype] = p
        return p

    # ---------------------------------------------------------- operators
    # U has shape (N_t+1, *gs); V (test side) has shape (N_t, *gs); gs is
    # (m,) on the flat formats.

    def _spmv_flat(self, which: str, X, p):
        """A or M on the flat formats: K20 on "ell" (``EllOperator.apply``:
        the kernel on CUDA, its twin on the CPU), ``dia_matvec`` on "dia"."""
        if self.spatial_format == "ell":
            Y = self._ell[which].apply(X.reshape(-1, self.m).contiguous(),
                                       p["ell_" + which])
            return Y.reshape(X.shape)
        return dia_matvec(p[f"dia_{which}v"], self._dia_off[which], X)

    def _spmv_M(self, X, p):
        if self.flat:
            return self._spmv_flat("M", X, p)
        return grouped_apply(self._groups_M, self.gs, X)

    def _spmv_A(self, X, p):
        """A X; on the weighted format the finest level's K12 wrapper (the
        kernel on CUDA, ``VarStencilOperator.apply`` on the CPU)."""
        if self.flat:
            return self._spmv_flat("A", X, p)
        if self.weighted:
            return self._kl_A.apply_A(X, p["Aw"])
        return grouped_apply(self.taps.groups_A, self.gs, X)

    def _zrow(self, like):
        return like.new_zeros((1,) + self.gs)

    def apply_B(self, U, p=None):
        p = self.params if p is None else p
        if self.taps is None:
            DU = U[1:] - U[:-1]
            SU = U[1:] + U[:-1]
            return self._spmv_M(DU, p) + p["h_half"] * self._spmv_A(SU, p)
        return kron.apply_B(U, p["kron"]["h128"], self.taps)

    def apply_BT(self, V, p=None):
        p = self.params if p is None else p
        if self.taps is None:
            VM = self._spmv_M(V, p)
            VA = p["h_half"] * self._spmv_A(V, p)
            z = self._zrow(V)
            return torch.cat([-VM + VA, z]) + torch.cat([z, VM + VA])
        return kron.apply_BT(V, p["kron"]["h128"], self.taps)

    def _cheb_theta(self, which: str) -> float:
        lmin, lmax = self._cheb_spec[which][:2]
        return 0.5 * (lmax + lmin)

    def apply_KY(self, V, p=None):
        p = self.params if p is None else p
        if self.inner == "dense":
            flat = V.reshape(-1, self.m)
            sol = (flat @ p["Kx_inv"]).reshape(V.shape)
        elif self.inner == "cheb":
            sol = cheb_run(V, p["cheb_invA"], lambda x: self._spmv_A(x, p),
                           self._cheb_theta("A"), p["cheb_coefA"])
        else:
            def coarse(bc):
                return (bc.reshape(bc.shape[0], -1) @ p["mg_cinv_ky"]
                        ).reshape(bc.shape)

            sol = self._mg_ky.solve(
                V, p["ms_ky"], coarse, self.mg_cycles, kernels=self._kl_ky
            )
        return sol * p["inv_h"]

    def apply_stab(self, U, p=None):
        """The stabilization term on its own (the stab-fused kernels fold it
        into ``apply_S`` on the constant format)."""
        p = self.params if p is None else p
        W = p["h_stab"] * self._spmv_A(U[1:] - U[:-1], p)
        z = self._zrow(U)
        return torch.cat([z, W]) - torch.cat([W, z])

    def _apply_Minv(self, X, p):
        """K_H ≈ M_x⁻¹ on (..., *gs) blocks: the dense inverse, the
        Chebyshev polynomial of ``cheb_eps``, or (mg) the degree-30 stencil
        Chebyshev."""
        if self.inner == "dense":
            return (X.reshape(-1, self.m) @ p["Minv"]).reshape(X.shape)
        if self.inner == "cheb" or self._flat_mg:
            return cheb_run(X, p["cheb_invM"], lambda x: self._spmv_M(x, p),
                            self._cheb_theta("M"), p["cheb_coefM"])
        return self._cheb_Minv(X)

    def _trace_row(self, U, p):
        """Row 0 of the trace term: M·K_H·M·U[0], shape (1, *gs)."""
        return self._spmv_M(self._apply_Minv(self._spmv_M(U[0:1], p), p), p)

    def apply_trace(self, U, p=None):
        p = self.params if p is None else p
        r0 = self._trace_row(U, p)
        return torch.cat([r0, U.new_zeros((self.N,) + self.gs)])

    def apply_S(self, U, p=None):
        """S = Bᵀ K_Y B + stab + trace, with stab fused into B and Bᵀ on the
        constant format."""
        p = self.params if p is None else p
        if self.taps is None:
            out = self.apply_BT(self.apply_KY(self.apply_B(U, p), p), p)
            out = out + self.apply_stab(U, p)
        else:
            kp = p["kron"]
            V, W = kron.apply_B_stab(U, kp["h128"], kp["hs128"], self.taps)
            out = kron.apply_BT_stab(self.apply_KY(V, p), W, kp["h128"],
                                     self.taps)
        out[0] += self._trace_row(U, p)[0]
        return out

    def _by_level(self, C, solve, p):
        """``solve(rows, j)`` on each wavelet level j's rows of C (N+1, ...):
        strided slices in time order on a uniform grid (written into a
        copy, never into C), the rows gathered by ``perm`` and put back by
        ``inv_perm`` on a graded one."""
        if self.wt.is_uniform:
            C = C.clone()
            N = self.N
            C[0::N] = solve(C[0::N], 0)
            for j in range(1, self.wt.num_levels + 1):
                st = N >> j
                sl = slice(st, N, 2 * st)
                C[sl] = solve(C[sl], j)
            return C
        Cs = C.index_select(0, p["perm"])
        b = self.level_bounds
        pieces = [solve(Cs[b[j]:b[j + 1]], j)
                  for j in range(self.wt.num_levels + 1) if b[j] < b[j + 1]]
        return torch.cat(pieces).index_select(0, p["inv_perm"])

    def _coarse_by_level(self, bc, p):
        """Coarsest-grid solve of the K_X V-cycle: each wavelet level's rows
        use their own shifted dense inverse."""
        flat = bc.reshape(bc.shape[0], -1)
        return self._by_level(flat, lambda rows, j: rows @ p["mg_cinv"][j],
                              p).reshape(bc.shape)

    def _ms_solve_kx(self, X, p):
        return self._mg_kx.solve(
            X, p["ms_kx"], lambda bc: self._coarse_by_level(bc, p),
            self.mg_cycles_kx, kernels=self._kl_kx,
        )

    def _cheb_shift_solve(self, b, j, p):
        """≈ (A + ω_j M)⁻¹ b."""
        omega, lmin, lmax, _ = self._cheb_spec["shift"][j]
        spmv_w = lambda x: self._spmv_A(x, p) + omega * self._spmv_M(x, p)
        return cheb_run(b, p["cheb_invS"][j], spmv_w, 0.5 * (lmax + lmin),
                        p["cheb_coefS"][j])

    def _sandwich_rows(self, rows, j, p):
        """K_j = (A+ω_j M)⁻¹ A (A+ω_j M)⁻¹ on (k, m) rows: the precomputed
        dense product, or two Chebyshev shifted solves around A."""
        if self.inner == "cheb":
            X = rows.reshape((rows.shape[0],) + self.gs)
            Y = self._cheb_shift_solve(X, j, p)
            Y = self._cheb_shift_solve(self._spmv_A(Y, p), j, p)
            return Y.reshape(rows.shape)
        return rows @ p["sandwich"][j]

    def apply_KX(self, R, p=None):
        """The wavelet-in-time preconditioner W (K_j)_j W'."""
        p = self.params if p is None else p
        if self.inner == "mg":
            X = wav.adjoint(self.wt, R.reshape((self.N + 1,) + self.gs),
                            p["wavelet"])
            X = self._ms_solve_kx(X, p)
            kl = self._kl_kx[0]
            if self._flat_mg:
                # K18 on a DIA fine level (its union-layout values)
                X = (kl.apply_A(X, p["ms_kx"][0]["kv"]) if kl.kind == "dia"
                     else self._spmv_A(X, p))
            elif self.weighted:
                X = kl.apply_A(X, p["ms_kx"][0]["Aw"])
            else:
                X = kl.apply_A(X)
            X = self._ms_solve_kx(X, p)
            return wav.forward(self.wt, X, p["wavelet"]).reshape(R.shape)
        C = wav.adjoint(self.wt, R.reshape(self.N + 1, self.m), p["wavelet"])
        C = self._by_level(C, lambda rows, j: self._sandwich_rows(rows, j, p),
                           p)
        return wav.forward(self.wt, C, p["wavelet"]).reshape(R.shape)

    # ---------------------------------------------------------------- rhs

    def _rhs_host_arrays(self):
        """Host load quadrature, once per solver; the source is evaluated on
        the solver's device."""
        if self._rhs_host is None:
            t0 = _time.perf_counter()
            self._rhs_host = spacetime_loads(
                _LoadsOn(self.problem, self.device), self.system.mesh, self.grid
            )
            self.rhs_seconds = _time.perf_counter() - t0
        return self._rhs_host

    def assemble_rhs_host(self, dtype=None):
        """(gL, gR, u0_vec) on the device in ``dtype``, cached per dtype."""
        dtype = self.dtype if dtype is None else dtype
        if dtype not in self._rhs_dev:
            gL, gR, u0_vec = self._rhs_host_arrays()
            mk = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
            self._rhs_dev[dtype] = (
                mk(gL).reshape((self.N,) + self.gs),
                mk(gR).reshape((self.N,) + self.gs),
                mk(u0_vec),
            )
        return self._rhs_dev[dtype]

    def rhs_device(self, gL, gR, u0_vec, p=None):
        p = self.params if p is None else p
        f = self.apply_BT(self.apply_KY(gL + gR, p), p)
        corr = 0.25 * (gL - gR)
        z = self._zrow(gL)
        f = f - torch.cat([z, corr]) + torch.cat([corr, z])
        u0g = u0_vec.reshape((1,) + self.gs)
        f0 = self._spmv_M(self._apply_Minv(u0g, p), p)
        f[0] += f0[0]
        return f

    # -------------------------------------------------------------- solve

    def _l2_error(self, U_flat: np.ndarray) -> float:
        return l2_error_spacetime(
            self.problem, self.system.mesh, self.grid,
            np.asarray(U_flat, np.float64),
        )

    # The layout of the solves' fields: the whole (N+1, *gs) array here; the
    # mesh solvers (spacetime_tpu_torch.parallel) hold one rank's block and
    # override these.

    def _loads(self, dtype):
        """(gL, gR, u0_vec) on the device in ``dtype``."""
        return self.assemble_rhs_host(dtype)

    def _x0(self, x0):
        """A global (N+1, m) warm start in the solves' layout."""
        return torch.as_tensor(
            np.asarray(x0), dtype=self.dtype, device=self.device
        ).reshape((self.N + 1,) + self.gs)

    def _dot(self, p):
        """PCG's inner product (None: the dot of the whole field)."""
        return None

    def _norm(self, x, p):
        return torch.linalg.vector_norm(x)

    def _flat(self, U) -> np.ndarray:
        """A solve's field as the global (N+1, m) host array."""
        return U.reshape(self.N + 1, self.m).cpu().numpy()

    def solve(
        self,
        tol: float = 1e-6,
        maxiter: int = 200,
        compute_error: bool = True,
        x0=None,
        checkpoint_path: str | None = None,
        checkpoint_every: int | None = None,
        resume_state: dict | None = None,
    ) -> SolveResult:
        """Standard PCG on S u = f to ||r|| <= tol·||f||. ``x0`` warm-starts
        it ((N+1, m) or device layout)."""
        if (checkpoint_path, checkpoint_every, resume_state) != (None,) * 3:
            raise _later("checkpointing", 6,
                         "PCG variants, checkpointing and the rest of the CLI")
        gL, gR, u0_vec = self._loads(self.dtype)
        x0_dev = None if x0 is None else self._x0(x0)
        p = self.params
        synchronize(self.device)
        t0 = _time.perf_counter()
        f = self.rhs_device(gL, gR, u0_vec, p)
        out = pcg(
            lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
            f, tol, maxiter, x0=x0_dev, dot=self._dot(p),
        )
        residuals = out.residuals.cpu().numpy()
        pres = out.precond_residuals.cpu().numpy()
        solve_seconds = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        U_flat = self._flat(out.U)
        transfer_seconds = _time.perf_counter() - t0
        err = None
        if compute_error and self.problem.exact is not None:
            err = self._l2_error(U_flat)
        it = out.iterations
        return SolveResult(
            U=U_flat,
            iterations=it,
            residuals=residuals[: it + 1],
            precond_residuals=pres[: it + 1],
            converged=out.converged,
            l2_error=err,
            solve_seconds=solve_seconds,
            transfer_seconds=transfer_seconds,
            setup_seconds=self.setup_seconds,
            rhs_seconds=self.rhs_seconds,
        )

    def solve_refined(
        self,
        tol: float = 1e-8,
        inner_tol: float = 1e-5,
        inner_maxiter: int = 60,
        max_rounds: int = 6,
        compute_error: bool = True,
        legs: str = "auto",
    ) -> SolveResult:
        """Mixed-precision iterative refinement: f32 PCG corrections inside
        an f64 residual loop. The residual legs r = f − S·u run in native
        float64 (``legs`` "auto" and "f64"); the double-single legs of the
        JAX package exist because f64 is emulated on the TPU."""
        if legs not in ("auto", "ds", "f64"):
            raise ValueError(f"unknown legs mode {legs!r}")
        if legs == "ds":
            raise NotImplementedError(
                "legs='ds' (double-single residual legs) is not ported "
                "(ROADMAP.md queue 1, 'not ported'): the H100 has native "
                "float64, so the residual legs run in f64"
            )
        p64 = self.params_for(torch.float64)
        p32 = self.params_for(torch.float32)
        _assert_dtype(p64, torch.float64)
        _assert_dtype(p32, torch.float32)
        gL64, gR64, u064 = self._loads(torch.float64)
        _assert_dtype([gL64, gR64, u064], torch.float64)

        S64 = lambda U: self.apply_S(U, p64)
        S32 = lambda U: self.apply_S(U, p32)
        KX32 = lambda R: self.apply_KX(R, p32)

        synchronize(self.device)
        t0 = _time.perf_counter()
        f = self.rhs_device(gL64, gR64, u064, p64)
        fnorm = float(self._norm(f, p64))
        u = torch.zeros_like(f)
        hist = []
        iters_total = 0
        converged = False
        rnorm_prev = None
        f_real = None
        for k in range(max_rounds):
            if k == 0:
                # u = 0 exactly, so r = f − S·0 = f: skip the residual leg.
                r, rnorm = f, fnorm
            else:
                r = f - S64(u)
                rnorm = float(self._norm(r, p64))
                f_real = rnorm / rnorm_prev
            rnorm_prev = rnorm
            hist.append(rnorm)
            if rnorm <= tol * fnorm:
                converged = True
                break
            # Round schedule (the JAX package's, verbatim): solve each
            # correction no tighter than the outer target needs (0.3
            # safety), never more than ~20x past the realized reduction of
            # the previous round, and never looser than 0.3.
            tol_k = max(inner_tol, 0.3 * tol * fnorm / rnorm)
            if f_real is not None and np.isfinite(f_real):
                tol_k = max(tol_k, 0.05 * f_real)
            tol_k = min(tol_k, 0.3)
            r32 = (r / rnorm).to(torch.float32)
            del r
            out = pcg(S32, KX32, r32, tol_k, inner_maxiter,
                      dot=self._dot(p32))
            del r32
            iters_total += out.iterations
            u = u + rnorm * out.U.to(torch.float64)
            del out
        synchronize(self.device)
        solve_seconds = _time.perf_counter() - t0

        U_flat = self._flat(u)
        err = None
        if compute_error and self.problem.exact is not None:
            err = self._l2_error(U_flat)
        hist = np.asarray(hist)
        return SolveResult(
            U=U_flat,
            iterations=iters_total,
            residuals=hist,
            precond_residuals=hist,
            converged=converged,
            l2_error=err,
            solve_seconds=solve_seconds,
            setup_seconds=self.setup_seconds,
            rhs_seconds=self.rhs_seconds,
        )


def build_solver(
    problem_name: str = "smooth2d",
    space_n: int = 16,
    time_levels: int = 4,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device = "cuda",
    refine: int = 0,
    extra_time_levels: int = 0,
    **kwargs,
) -> HeatSolver:
    """A ``HeatSolver`` for a registered problem on its domain's mesh with
    ``space_n`` cells per side, red-refined ``refine`` times with its
    refinement chain recorded (``fem.refine_hierarchy``), and a time grid
    of 2^``time_levels`` uniform timesteps, refined ``extra_time_levels``
    more times toward t = 0 (``fem.graded_time_grid``, the grid of the
    problems with ``graded_time``). The construction half of the JAX
    package's ``solve_heat_equation_tpu``; ``kwargs`` go to
    ``HeatSolver``."""
    if extra_time_levels < 0:
        raise ValueError(f"extra_time_levels={extra_time_levels} < 0")
    problem = get_problem(problem_name)
    mesh = domain_mesh(problem.domain, problem.dim, space_n)
    if refine > 0:
        mesh = refine_hierarchy(mesh, refine)
    system = P1System.from_problem(problem, mesh)
    if extra_time_levels > 0:
        grid = graded_time_grid(time_levels, extra_time_levels, T=problem.T)
    else:
        grid = uniform_time_grid(time_levels, T=problem.T)
    return HeatSolver(problem, system, grid, dtype=dtype, device=device, **kwargs)
