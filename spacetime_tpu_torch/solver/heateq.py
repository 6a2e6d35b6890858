"""The space-time heat-equation solver on PyTorch tensors.

The counterpart of ``spacetime_tpu.solver.heateq.HeatSolver`` for the
structured constant-stencil regime with multi-shift multigrid inner solves
(``inner="mg"``) on uniform dyadic time grids: the same stabilized
minimal-residual formulation, the same operator algebra and the same
operation order, so float64 residual histories agree with the JAX package to
rounding. Host setup (assembly, stencils, the multigrid hierarchy, the
wavelet structure, the quadrature of the loads) is shared with the JAX
package; every per-iteration operation runs on ``device``.

B and Bᵀ run as the stab-fused pair of ``ops.kron`` in ``apply_S`` and as the
plain Bᵀ in ``rhs_device``: CUDA kernels for CUDA tensors, their plain twins
on the CPU.

Outside this slice (raising ``NotImplementedError`` with the ROADMAP.md slice
that ports it): dense and Chebyshev inner solves, non-stencil spatial
formats, 3-D multigrid, graded time grids, on-device load quadrature, the
fused/flexible PCG variants, checkpointing, double-single refinement legs
and multi-device runs.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from spacetime_tpu.fem import (
    P1System,
    TimeGrid,
    domain_mesh,
    spacetime_loads,
    time_matrices,
    uniform_time_grid,
)
from spacetime_tpu.fem.errors import l2_error_spacetime
from spacetime_tpu.ops.multigrid import MultiShiftMultigrid, mass_spectral_bounds
from spacetime_tpu.ops.sparse import DiaMatrix
from spacetime_tpu.ops.stencil import StencilOperator
from spacetime_tpu.ops.wavelets import build_wavelet_transform

from ..models import Problem, get_problem
from ..ops import kron
from ..ops import wavelets as wav
from ..ops.multigrid import MultiShiftMG, chebyshev_stencil_inverse, row_params
from ..ops.stencil import grouped_apply, row_scale
from ..utils.device import resolve_device, synchronize
from .pcg import pcg

_DTYPES = (torch.float32, torch.float64)


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it belongs to the {slice_name} slice of "
        "the port (ROADMAP.md queue 1)"
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
    """``problem`` with its source evaluated on ``device``: the shared host
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
    elif tree.dtype != dtype:
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
        device: str | torch.device = "cuda",
    ):
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
        self.wt = build_wavelet_transform(grid)
        if not self.wt.is_uniform:
            raise _later("a graded or non-dyadic time grid", "graded time-grid")

        # --- spatial operators: constant stencils ---------------------------
        gs = system.mesh.grid_shape
        weighted = getattr(system, "weighted", False)
        if spatial_format not in ("auto", "stencil") or weighted:
            raise _later(
                f"spatial_format={spatial_format!r} (weighted={weighted})",
                "weighted-coefficient / unstructured",
            )
        if gs is None or min(gs) < 3:
            raise _later("an unstructured spatial mesh", "unstructured")
        self.gs = tuple(gs)
        dim = len(self.gs)
        self.spatial_format = "stencil"
        M_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.M), self.gs)
        A_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.A), self.gs)
        self.taps = kron.KronTaps.from_stencils(M_st, A_st)

        # --- inner solver: multi-shift multigrid -----------------------------
        if inner == "auto":
            inner = "dense" if self.m <= 4096 else "mg"
        if inner != "mg":
            raise _later(f"inner={inner!r}", "dense / Chebyshev inner solver")
        if dim != 2:
            raise _later("3-D multigrid", "3-D structured")
        self.inner = inner
        if mg_cycles < 1 or (mg_cycles_kx is not None and mg_cycles_kx < 1):
            raise ValueError(
                f"mg_cycles={mg_cycles} / mg_cycles_kx={mg_cycles_kx}: "
                "V-cycle counts must be >= 1"
            )
        if mg_nu < 1 or (mg_nu_kx is not None and mg_nu_kx < 1):
            raise ValueError(
                f"mg_nu={mg_nu} / mg_nu_kx={mg_nu_kx}: "
                "smoothing step counts must be >= 1"
            )
        if space_n is None:
            if len(set(self.gs)) != 1:
                raise ValueError("pass space_n for non-square grids")
            space_n = self.gs[0] + 1
        self.mg_cycles = mg_cycles
        self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
        self.mg_nu = mg_nu
        self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
        self.mg_nu_post = mg_nu_post
        cache: dict = {}
        if self.gs == (space_n - 1,) * dim:
            cache[space_n] = system
        if mg_coarse is None:
            mg_coarse = 32
        msmg, (A_c, M_c) = MultiShiftMultigrid.build(
            dim, space_n, nu=mg_nu,
            n_coarse=min(mg_coarse, max(space_n // 2, 4)),
            _system_cache=cache,
        )
        if mg_nu_post is not None:
            msmg = dataclasses.replace(msmg, nu_post=mg_nu_post)
        self.msmg = msmg
        self._mg_ky = MultiShiftMG(msmg)
        self._mg_kx = MultiShiftMG(msmg, nu=self.mg_nu_kx)
        omegas = [
            float(self.wt.level_shift[j]) for j in range(self.wt.num_levels + 1)
        ]
        self._host = {
            "h": time_matrices(grid)["h"],
            "omega_ky": np.zeros(self.N),
            "omega_kx": np.asarray(
                [float(self.wt.level_shift[j]) for j in self.wt.node_level]
            ),
            "mg_cinv_ky": np.linalg.inv(A_c),
            "mg_cinv": [np.linalg.inv(A_c + w * M_c) for w in omegas],
        }
        lmin, lmax = mass_spectral_bounds(dim)
        center = dict(zip(M_st.disps, M_st.weights))[(0,) * dim]
        self._cheb_Minv = chebyshev_stencil_inverse(
            M_st, 1.0 / center, lmin, lmax, 30
        )

        if pcg_variant != "standard":
            raise _later(
                f"pcg_variant={pcg_variant!r}", "PCG variants and checkpointing"
            )
        self.pcg_variant = pcg_variant
        if rhs == "device":
            raise _later(
                "rhs='device' (on-device load quadrature)",
                "device_spacetime_loads",
            )
        if rhs not in ("auto", "host"):
            raise ValueError(f"unknown rhs mode {rhs!r}")
        self.rhs_mode = "host"
        self._params_cache: dict = {}
        self._rhs_host = None
        self._rhs_dev: dict = {}
        self.rhs_seconds = 0.0
        self.params = self.params_for(dtype)
        self.setup_seconds = _time.perf_counter() - t0

    # ------------------------------------------------------------- params

    def params_for(self, dtype: torch.dtype) -> dict:
        """Device tensors of the operators in ``dtype`` (cached). Per-time-row
        scales are (T, 1, 1) columns; ``kron`` holds the (T,) vectors h/2 and
        h/16 the B/Bᵀ kernels read."""
        if dtype in self._params_cache:
            return self._params_cache[dtype]
        dev, dim = self.device, len(self.gs)
        cast = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()
        h = self._host["h"]
        p = {
            "h_half": row_scale(0.5 * h, dim, dtype, dev),
            "h_stab": row_scale(h / 16.0, dim, dtype, dev),
            "inv_h": row_scale(1.0 / h, dim, dtype, dev),
            "wavelet": wav.wavelet_params(self.wt, dtype, dev),
        }
        p["kron"] = {
            "h128": p["h_half"].reshape(self.N),
            "hs128": p["h_stab"].reshape(self.N),
        }
        p["mg_cinv_ky"] = cast(self._host["mg_cinv_ky"])
        p["mg_cinv"] = [cast(S) for S in self._host["mg_cinv"]]
        p["ms_ky"] = row_params(self.msmg, self._host["omega_ky"], dtype, dev)
        p["ms_kx"] = row_params(self.msmg, self._host["omega_kx"], dtype, dev)
        self._params_cache[dtype] = p
        return p

    # ---------------------------------------------------------- operators
    # U has shape (N_t+1, *gs); V (test side) has shape (N_t, *gs).

    def _spmv_M(self, X):
        return grouped_apply(self.taps.groups_M, self.gs, X)

    def _spmv_A(self, X):
        return grouped_apply(self.taps.groups_A, self.gs, X)

    def _zrow(self, like):
        return like.new_zeros((1,) + self.gs)

    def apply_B(self, U, p=None):
        p = self.params if p is None else p
        return kron.apply_B(U, p["kron"]["h128"], self.taps)

    def apply_BT(self, V, p=None):
        p = self.params if p is None else p
        return kron.apply_BT(V, p["kron"]["h128"], self.taps)

    def apply_KY(self, V, p=None):
        p = self.params if p is None else p

        def coarse(bc):
            return (bc.reshape(bc.shape[0], -1) @ p["mg_cinv_ky"]).reshape(bc.shape)

        sol = self._mg_ky.solve(V, p["ms_ky"], coarse, self.mg_cycles)
        return sol * p["inv_h"]

    def apply_stab(self, U, p=None):
        """The stabilization term on its own (the stab-fused kernels fold it
        into ``apply_S``)."""
        p = self.params if p is None else p
        W = p["h_stab"] * self._spmv_A(U[1:] - U[:-1])
        z = self._zrow(U)
        return torch.cat([z, W]) - torch.cat([W, z])

    def _apply_Minv(self, X, p=None):
        """K_H ≈ M_x⁻¹ on (..., *gs) blocks (degree-30 Chebyshev)."""
        return self._cheb_Minv(X)

    def _trace_row(self, U, p):
        """Row 0 of the trace term: M·K_H·M·U[0], shape (1, *gs)."""
        return self._spmv_M(self._apply_Minv(self._spmv_M(U[0:1]), p))

    def apply_trace(self, U, p=None):
        p = self.params if p is None else p
        r0 = self._trace_row(U, p)
        return torch.cat([r0, U.new_zeros((self.N,) + self.gs)])

    def apply_S(self, U, p=None):
        """S = Bᵀ K_Y B + stab + trace, with stab fused into B and Bᵀ."""
        p = self.params if p is None else p
        kp = p["kron"]
        V, W = kron.apply_B_stab(U, kp["h128"], kp["hs128"], self.taps)
        out = kron.apply_BT_stab(self.apply_KY(V, p), W, kp["h128"], self.taps)
        out[0] += self._trace_row(U, p)[0]
        return out

    def _coarse_by_level(self, bc, p):
        """Coarsest-grid solve of the K_X V-cycle: each wavelet level's rows
        (strided slices in time order) use their own shifted dense inverse.
        Writes into a copy, never into ``bc``."""
        flat = bc.reshape(bc.shape[0], -1).clone()
        N = self.N
        flat[0::N] = flat[0::N] @ p["mg_cinv"][0]
        for j in range(1, self.wt.num_levels + 1):
            st = N >> j
            sl = slice(st, N, 2 * st)
            flat[sl] = flat[sl] @ p["mg_cinv"][j]
        return flat.reshape(bc.shape)

    def _ms_solve_kx(self, X, p):
        return self._mg_kx.solve(
            X, p["ms_kx"], lambda bc: self._coarse_by_level(bc, p),
            self.mg_cycles_kx,
        )

    def apply_KX(self, R, p=None):
        """The wavelet-in-time preconditioner W (K_j)_j W'."""
        p = self.params if p is None else p
        X = wav.adjoint(self.wt, R.reshape((self.N + 1,) + self.gs), p["wavelet"])
        X = self._ms_solve_kx(X, p)
        X = self._spmv_A(X)
        X = self._ms_solve_kx(X, p)
        return wav.forward(self.wt, X, p["wavelet"]).reshape(R.shape)

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
        f0 = self._spmv_M(self._apply_Minv(u0g, p))
        f[0] += f0[0]
        return f

    # -------------------------------------------------------------- solve

    def _l2_error(self, U_flat: np.ndarray) -> float:
        return l2_error_spacetime(
            self.problem, self.system.mesh, self.grid,
            np.asarray(U_flat, np.float64),
        )

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
            raise _later("checkpointing", "PCG variants and checkpointing")
        gL, gR, u0_vec = self.assemble_rhs_host()
        x0_dev = None
        if x0 is not None:
            x0_dev = torch.as_tensor(
                np.asarray(x0), dtype=self.dtype, device=self.device
            ).reshape((self.N + 1,) + self.gs)
        p = self.params
        synchronize(self.device)
        t0 = _time.perf_counter()
        f = self.rhs_device(gL, gR, u0_vec, p)
        out = pcg(
            lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
            f, tol, maxiter, x0=x0_dev,
        )
        residuals = out.residuals.cpu().numpy()
        pres = out.precond_residuals.cpu().numpy()
        solve_seconds = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        U_flat = out.U.reshape(self.N + 1, self.m).cpu().numpy()
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
        gL64, gR64, u064 = self.assemble_rhs_host(torch.float64)
        _assert_dtype([gL64, gR64, u064], torch.float64)

        S64 = lambda U: self.apply_S(U, p64)
        S32 = lambda U: self.apply_S(U, p32)
        KX32 = lambda R: self.apply_KX(R, p32)

        synchronize(self.device)
        t0 = _time.perf_counter()
        f = self.rhs_device(gL64, gR64, u064, p64)
        fnorm = float(torch.linalg.vector_norm(f))
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
                rnorm = float(torch.linalg.vector_norm(r))
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
            out = pcg(S32, KX32, r32, tol_k, inner_maxiter)
            del r32
            iters_total += out.iterations
            u = u + rnorm * out.U.to(torch.float64)
            del out
        synchronize(self.device)
        solve_seconds = _time.perf_counter() - t0

        U_flat = u.reshape(self.N + 1, self.m).cpu().numpy()
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
    **kwargs,
) -> HeatSolver:
    """A ``HeatSolver`` for a registered problem on its structured mesh with
    ``space_n`` cells per side and a uniform grid of 2^``time_levels``
    timesteps (the construction half of the JAX package's
    ``solve_heat_equation_tpu``). ``kwargs`` go to ``HeatSolver``."""
    problem = get_problem(problem_name)
    mesh = domain_mesh(problem.domain, problem.dim, space_n)
    system = P1System.from_problem(problem, mesh)
    grid = uniform_time_grid(time_levels, T=problem.T)
    return HeatSolver(problem, system, grid, dtype=dtype, device=device, **kwargs)
