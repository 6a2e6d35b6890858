"""The weighted semi-fused V-cycle of the port (weighted V(ν, ν_post) and
ν ∉ {2, 3} cycles in 2-D and 3-D; ``varcoef3d`` at ν = ν_post runs the fused
K14/K15, ``tests/test_torch_fused3d.py``) against the JAX package: the plain
twins of K10 (the weighted sweep from x, from 0 and the post-sweep of degree
ν_post) and K13 (weighted residual + restriction) on 2-D and 3-D grids, of
K11/K12 on 3-D grids, the semi-fused V-cycle with kernel levels against the
JAX one with its Pallas levels on the semi-fused branch, the float64 solves,
and the conversion of a 3-D weighted params tree. Inputs are made with numpy
from a seed; CPU tensors run the twins.

Tolerances, relative to max|JAX|: 1e-12 in float64 against the XLA form (sum
order); in float32 against ``VarMSPallasLevel`` in interpret mode 1e-5, and
1e-4 for K13's r_c, whose Pallas restriction splits f32 data into bf16 hi +
lo parts on the matrix unit (``_dot_last``), as ``tests/test_mg_pallas_var.py``
allows.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetime_tpu.fem as jfem
from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu.ops import multigrid as jmg
from spacetime_tpu.ops.mg_pallas import VarMSPallasLevel
from spacetime_tpu.ops.stencil import row_scale as jax_row_scale
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.ops import mg_kernels
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops.mg_kernels import VarMSKernelLevel
from spacetime_tpu_torch.solver import build_solver

# the coefficients of tests/test_mg_pallas_var.py, as numpy callables
KAPPA = lambda X: 1.0 + X[:, 0] + 0.5 * np.sin(np.pi * X[:, 1])
REACT = lambda X: 1.0 + X[:, -1]
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# the post-sweep's degree beside each ν, so that ``post`` is seen to take it
NU_POST = {1: 2, 2: 3, 3: 1}


def _close(got, want, rel):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.fixture(scope="module")
def hier():
    """Per dimension, the JAX and the port's Galerkin hierarchies from the
    same weighted CSR: 2-D at 32 cells (levels 31², 15²; coarse 8), 3-D at
    16 (levels 15³, 7³; coarse 4)."""
    out = {}
    for dim, n, nc in ((2, 32, 8), (3, 16, 4)):
        system = jfem.P1System.from_mesh(jfem.domain_mesh("unit", dim, n),
                                         kappa=KAPPA, reaction=REACT)
        out[dim] = (
            jmg.GalerkinMultiShiftMultigrid.build(dim, n, system.A, system.M,
                                                  nu=2, n_coarse=nc),
            mg.GalerkinMultiShiftMultigrid.build(dim, n, system.A, system.M,
                                                 nu=2, n_coarse=nc),
        )
    return out


def test_3d_hierarchy_equals_jax(hier):
    (jm, (jAc, jMc)), (pm, (pAc, pMc)) = hier[3]
    assert len(pm.levels) == len(jm.levels) == 2
    for p, j in zip(pm.levels, jm.levels):
        assert p.A_vs.disps == j.A_vs.disps and len(p.A_vs.disps) == 15
        assert (p.kc, p.cM, p.n, p.gs) == (j.kc, j.cM, j.n, j.gs)
        np.testing.assert_array_equal(p.Aw, j.Aw)
    np.testing.assert_array_equal(pAc, jAc)
    np.testing.assert_array_equal(pMc, jMc)


@pytest.fixture(scope="module")
def twin_cases(hier):
    """(JAX results, port results) per (dtype, grid, ν), T = 5, on the
    weights of the finest level cut to the grid: K10 from x, from 0 and the
    post-sweep, K13, and K11/K12."""
    cache = {}

    def run(dt, gs, nu):
        key = (dt, gs, nu)
        if key in cache:
            return cache[key]
        dim = len(gs)
        (jm, _), (pm, _) = hier[dim]
        jlev, plev = jm.levels[0], pm.levels[0]
        jdt, tdt = DTYPES[dt]
        T, nu_post = 5, NU_POST[nu]
        rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
        omega = np.abs(rng.standard_normal(T)) * 20
        x, b = (rng.standard_normal((T,) + gs) for _ in range(2))
        W = np.ascontiguousarray(
            jlev.Aw[(slice(None),) + tuple(slice(0, n) for n in gs)])
        lp0 = jm.row_params(omega, jnp.float64)[0]
        rows = lambda a: np.asarray(a).reshape(T, -1)[:, 0]
        invT, invDel = rows(lp0["inv_theta"]), rows(lp0["inv_delta"])
        J = lambda a: jnp.asarray(a, jdt)
        lev = dataclasses.replace(
            jlev, gs=gs, A_vs=dataclasses.replace(jlev.A_vs, grid_shape=gs),
            M_st=dataclasses.replace(jlev.M_st, grid_shape=gs))
        if dt == "f64":  # the XLA form
            lp = {"omega": jax_row_scale(omega, gs, jdt),
                  "inv_theta": jax_row_scale(invT, gs, jdt),
                  "inv_delta": jax_row_scale(invDel, gs, jdt), "Aw": J(W)}
            want = {
                "smooth": jm._smooth(lev, lp, J(x), J(b), nu=nu),
                "smooth_zero": jm._smooth(lev, lp, None, J(b),
                                          zero_init=True, nu=nu),
                "smooth_post": jm._smooth(lev, lp, J(x), J(b), nu=nu_post),
                "residual_restrict": jmg._transfer_fast(
                    J(b) - jm._op(lev, lp, J(x)), dim, restrict=True),
                "residual": J(b) - jm._op(lev, lp, J(x)),
                "apply_A": lev.A_vs.apply(J(x), J(W)),
            }
        else:  # the Pallas kernels in interpret mode
            pj = VarMSPallasLevel(lev, T, jdt, nu, interpret=True,
                                  nu_post=nu_post)
            pj.TBt, pj.YBt = 2, gs[-2]
            assert pj.semi_ok
            cols = VarMSPallasLevel.columns(jlev, omega, jdt)
            want = {
                "smooth": pj.smooth(J(x), J(b), cols, J(W)),
                "smooth_zero": pj.smooth(None, J(b), cols, J(W),
                                         zero_init=True),
                "smooth_post": pj.smooth(J(x), J(b), cols, J(W), post=True),
                "residual_restrict": pj.residual_restrict(
                    J(x), J(b), cols, pj.transfers(jdt), J(W)),
                "residual": pj.residual(J(x), J(b), cols, J(W)),
                "apply_A": pj.apply_A(J(x), J(W)),
            }
        P = lambda a: torch.tensor(a, dtype=tdt)
        kl = VarMSKernelLevel(plev, nu, nu_post=nu_post, gs=gs)
        assert not kl.fused_ok and kl.semi_ok
        tc = {"omega": P(omega), "invT": P(invT), "invDel": P(invDel)}
        X, B, Wt = P(x), P(b), P(W)
        mg_kernels.reset_launch_counts()
        got = {
            "smooth": kl.smooth(X, B, tc, Wt),
            "smooth_zero": kl.smooth(None, B, tc, Wt, zero_init=True),
            "smooth_post": kl.smooth(X, B, tc, Wt, post=True),
            "residual_restrict": kl.residual_restrict(X, B, tc, Wt),
            "residual": kl.residual(X, B, tc, Wt),
            "apply_A": kl.apply_A(X, Wt),
        }
        assert not any(mg_kernels.launch_counts().values())
        cache[key] = (want, got)
        return cache[key]

    return run


GRIDS = {"15x31": (15, 31), "7^3": (7, 7, 7), "7x9x15": (7, 9, 15)}


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("op", ["smooth", "smooth_zero", "smooth_post",
                                "residual_restrict"])
def test_k10_k13_twins_match_jax(twin_cases, op, dt, grid, nu):
    want, got = twin_cases(dt, GRIDS[grid], nu)
    assert got[op].dtype == DTYPES[dt][1]
    rel = 1e-12 if dt == "f64" else (
        1e-4 if op == "residual_restrict" else 1e-5)
    _close(got[op], want[op], rel)


@pytest.mark.parametrize("grid", ["7^3", "7x9x15"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("op", ["residual", "apply_A"])
def test_k11_k12_3d_twins_match_jax(twin_cases, op, dt, grid):
    want, got = twin_cases(dt, GRIDS[grid], 2)
    _close(got[op], want[op], 1e-12 if dt == "f64" else 1e-5)


class _SemiPallas(VarMSPallasLevel):
    """A JAX Pallas level held to the semi-fused branch."""

    fused_ok = False


class _SemiKernels(VarMSKernelLevel):
    """A kernel level held to the semi-fused branch where ``fused_ok``
    would hold (V(2,2) in 3-D)."""

    fused_ok = False


@pytest.mark.parametrize("dim, nu, nu_post", [(2, 2, 1), (3, 2, 2), (3, 3, 1)],
                         ids=["2d-V(2,1)", "3d-V(2,2)", "3d-V(3,1)"])
def test_weighted_semi_vcycle_matches_jax_pallas_f64(hier, dim, nu, nu_post):
    """Two cycles of the port's weighted V-cycle with kernel levels (K10 →
    K13 → K9 → K10 on every level, K11 starting the second cycle) against
    the JAX one with Pallas levels on the semi-fused branch, and the plain
    V-cycle against both."""
    (jm, (A_c, M_c)), (pm, _) = hier[dim]
    jm = dataclasses.replace(jm, nu=nu, nu_post=nu_post)
    pm = dataclasses.replace(pm, nu=nu, nu_post=nu_post)
    T = 4
    rng = np.random.default_rng(31 + dim)
    omega = np.abs(rng.standard_normal(T)) * 10
    b = rng.standard_normal((T,) + jm.levels[0].gs)
    cinv = np.linalg.inv(A_c + omega.mean() * M_c)

    lps_j = jm.row_params(omega, jnp.float64)
    pallas = [_SemiPallas(lev, T, jnp.float64, nu, interpret=True,
                          nu_post=nu_post) for lev in jm.levels]
    for pj, lp, lev in zip(pallas, lps_j, jm.levels):
        assert pj.semi_ok
        lp["cols"] = VarMSPallasLevel.columns(lev, omega, jnp.float64)
        lp["tx"] = pj.transfers(jnp.float64)
    cj = jnp.asarray(cinv)
    want = jm.solve(jnp.asarray(b), lps_j,
                    lambda bc: jnp.dot(bc.reshape(T, -1), cj).reshape(bc.shape),
                    2, pallas=pallas)

    lps_t = mg.var_row_params(pm, omega, torch.float64, "cpu")
    for lp in lps_t:
        lp["cols"] = VarMSKernelLevel.columns(lp)
    kernels = [_SemiKernels(lev, nu, nu_post=nu_post) for lev in pm.levels]
    assert all(k.semi_ok and not k.fused_ok for k in kernels)
    ct = torch.as_tensor(cinv)
    coarse = lambda bc: (bc.reshape(T, -1) @ ct).reshape(bc.shape)
    vc = mg.GalerkinMultiShiftMG(pm)
    _close(vc.solve(torch.as_tensor(b), lps_t, coarse, 2, kernels=kernels),
           want, 1e-12)
    _close(vc.solve(torch.as_tensor(b), lps_t, coarse, 2), want, 1e-12)


@pytest.mark.parametrize(
    "name, n, J, kw",
    [("varcoef3d", 8, 3, dict(mg_coarse=4)), ("varcoef3d", 16, 3, {}),
     ("varcoef2d", 16, 3, dict(mg_coarse=8, mg_nu_post=1)),
     ("varcoef2d", 16, 3, dict(mg_coarse=8, mg_nu=1))],
    ids=["3d-9^3x8", "3d-17^3x8", "2d-17^2x8-V(2,1)", "2d-17^2x8-V(1,1)"])
def test_weighted_semi_solve_f64_matches_jax(name, n, J, kw):
    jprob = jax_problem(name)
    jsys = jfem.P1System.from_problem(
        jprob, jfem.domain_mesh("unit", jprob.dim, n))
    js = JaxHeatSolver(jprob, jsys, jfem.uniform_time_grid(J),
                       dtype=jnp.float64, rhs="host", inner="mg", **kw)
    ps = build_solver(name, n, J, dtype=torch.float64, device="cpu",
                      inner="mg", **kw)
    assert js.spatial_format == ps.spatial_format == "vstencil"
    assert [lev.n for lev in ps.msmg.levels] == [lev.n for lev in js.msmg.levels]
    # varcoef3d at ν = ν_post = 2 takes the fused K14/K15 twins on every
    # level, the 2-D V(2,1) and V(1,1) the semi-fused ones
    fused = name == "varcoef3d"
    assert all(k.fused_ok == fused for k in ps._kl_ky + ps._kl_kx)
    jr, pr = js.solve(tol=1e-8), ps.solve(tol=1e-8)
    assert jr.converged and pr.converged
    assert pr.iterations == jr.iterations
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
    np.testing.assert_allclose(pr.precond_residuals, jr.precond_residuals,
                               rtol=1e-10)
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)


def _compare(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _compare(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, c) in enumerate(zip(got, want)):
            _compare(a, c, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        torch.testing.assert_close(got, want, rtol=1e-15, atol=0, msg=path)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_params_from_jax_weighted_3d(dtype):
    """The 3-D weighted tree (f32: Pallas levels on every level, with
    ``cols`` and the banded ``tx`` the port drops) in the port's layout."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(inner="mg", mg_coarse=4)
    jprob = jax_problem("varcoef3d")
    jsys = jfem.P1System.from_problem(jprob, jfem.domain_mesh("unit", 3, 8))
    js = JaxHeatSolver(jprob, jsys, jfem.uniform_time_grid(2), dtype=jdt,
                       rhs="host", pallas_kron=dtype == "float32", **kw)
    js.mg_pallas_min_points = 0
    js._params_cache.clear()
    tree = jax.tree_util.tree_map(np.asarray, js.params_for(jdt))
    assert all(("cols" in lp) == (dtype == "float32")
               for lp in tree["ms_ky"] + tree["ms_kx"])
    got = params_from_jax(tree, "cpu", tdt)
    want = build_solver("varcoef3d", 8, 2, dtype=tdt, device="cpu",
                        **kw).params_for(tdt)
    assert got["Aw"].shape == (15, 7, 7, 7)
    _compare(got, want)
