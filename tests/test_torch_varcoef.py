"""The weighted-coefficient path of the port (``varcoef2d``) against the JAX
package: the weighted P1 assembly, the Galerkin hierarchy and the loads
(host copies), the weighted kernels' plain twins (K11, K12, K14, K15)
against the JAX XLA form (float64) and ``VarMSPallasLevel`` in interpret
mode (float32), the weighted V-cycle with kernel levels, the solver, the
conversion of the weighted params, and the paths that still raise (the
semi-fused weighted V-cycle and varcoef3d are held against the JAX package
in ``tests/test_torch_varcoef3d.py``). Inputs are made with numpy from a
seed; CPU tensors run the twins.

Tolerances, relative to max|JAX|: 1e-12 in float64 (sum order); in float32
1e-5, and 1e-4 for r_c and the ``fused_post`` output, whose Pallas
transfers split f32 data into bf16 hi + lo parts on the matrix unit
(``_dot_last``), as ``tests/test_mg_pallas_var.py`` allows.
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
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import mg_kernels
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops.mg_kernels import VarMSKernelLevel
from spacetime_tpu_torch.ops.sparse import DiaMatrix
from spacetime_tpu_torch.ops.stencil import VarStencilOperator
from spacetime_tpu_torch.solver import HeatSolver, build_solver

# the coefficients of tests/test_mg_pallas_var.py, as numpy callables
KAPPA = lambda X: 1.0 + X[:, 0] + 0.5 * np.sin(np.pi * X[:, 1])
REACT = lambda X: 1.0 + X[:, -1]
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
KW = dict(inner="mg", mg_coarse=8)


def _close(got, want, rel):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.mark.parametrize("dim, n", [(2, 16), (3, 6)])
def test_weighted_assembly_equals_jax(dim, n):
    mesh = fem.domain_mesh("unit", dim, n)
    jmesh = jfem.domain_mesh("unit", dim, n)
    got = fem.P1System.from_mesh(mesh, kappa=KAPPA, reaction=REACT)
    want = jfem.P1System.from_mesh(jmesh, kappa=KAPPA, reaction=REACT)
    assert got.weighted and want.weighted
    for g, w in ((got.A, want.A), (got.M, want.M)):
        np.testing.assert_array_equal(g.indptr, w.indptr)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.data, w.data)
    assert not fem.P1System.from_mesh(mesh).weighted


def test_from_problem_matches_jax():
    """κ and c through torch's and XLA's sin: equal to the last bit or so."""
    got = fem.P1System.from_problem(get_problem("varcoef2d"),
                                    fem.unit_square_mesh(16))
    want = jfem.P1System.from_problem(jax_problem("varcoef2d"),
                                      jfem.unit_square_mesh(16))
    assert got.weighted and want.weighted
    assert abs(got.A - want.A).max() <= 1e-14 * abs(want.A).max()
    assert (got.M != want.M).nnz == 0


@pytest.fixture(scope="module")
def hierarchies():
    """The JAX and the port's Galerkin hierarchies (levels 32 and 16, coarse
    8) from the same weighted CSR."""
    system = jfem.P1System.from_mesh(jfem.unit_square_mesh(32), kappa=KAPPA,
                                     reaction=REACT)
    return (jmg.GalerkinMultiShiftMultigrid.build(
                2, 32, system.A, system.M, nu=2, n_coarse=8),
            mg.GalerkinMultiShiftMultigrid.build(
                2, 32, system.A, system.M, nu=2, n_coarse=8))


def test_galerkin_hierarchy_equals_jax(hierarchies):
    (jm, (jAc, jMc)), (pm, (pAc, pMc)) = hierarchies
    assert (pm.dim, pm.nu, pm.n_coarse) == (jm.dim, jm.nu, jm.n_coarse)
    assert len(pm.levels) == len(jm.levels) == 2
    for p, j in zip(pm.levels, jm.levels):
        assert p.A_vs.disps == j.A_vs.disps and len(p.A_vs.disps) == 7
        assert p.A_vs.grid_shape == j.A_vs.grid_shape
        assert (p.kc, p.cM, p.n, p.gs) == (j.kc, j.cM, j.n, j.gs)
        assert (p.M_st.disps, p.M_st.weights) == (j.M_st.disps, j.M_st.weights)
        for name in ("Aw", "dA", "dM", "rsA", "rsM"):
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    np.testing.assert_array_equal(pAc, jAc)
    np.testing.assert_array_equal(pMc, jMc)
    # the stencil from the same DIA, and its application
    from spacetime_tpu.ops.sparse import DiaMatrix as JDia
    from spacetime_tpu.ops.stencil import VarStencilOperator as JVar

    A = jfem.P1System.from_mesh(jfem.unit_square_mesh(16), kappa=KAPPA).A
    vp, Wp = VarStencilOperator.from_dia(DiaMatrix.from_csr(A), (15, 15))
    vj, Wj = JVar.from_dia(JDia.from_csr(A), (15, 15))
    assert vp.disps == vj.disps
    np.testing.assert_array_equal(Wp, Wj)
    U = np.random.default_rng(4).standard_normal((3, 15, 15))
    np.testing.assert_array_equal(
        vp.apply(torch.as_tensor(U), torch.as_tensor(Wp)).numpy(),
        vj.apply_np(U, Wj))


def test_loads_equal_jax():
    """The same host quadrature of sources that agree to rounding."""
    mesh, jmesh = fem.unit_square_mesh(8), jfem.unit_square_mesh(8)
    grid, jgrid = fem.uniform_time_grid(2), jfem.uniform_time_grid(2)
    got = fem.spacetime_loads(get_problem("varcoef2d"), mesh, grid)
    want = jfem.spacetime_loads(jax_problem("varcoef2d"), jmesh, jgrid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * np.abs(w).max())


@pytest.fixture(scope="module")
def twin_cases(hierarchies):
    """(JAX results, port results) of K10 (from x and from 0), K11, K12,
    K14 and K15 per (dtype, grid, ν), T = 5, on the weights of the finest
    level cut to the grid; at ν = 1 (no fused stage) K10, K11 and K12."""
    (jm, _), (pm, _) = hierarchies
    jlev, plev = jm.levels[0], pm.levels[0]
    cache = {}

    def run(dt, gs, nu):
        key = (dt, gs, nu)
        if key in cache:
            return cache[key]
        jdt, tdt = DTYPES[dt]
        T = 5
        rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
        omega = np.abs(rng.standard_normal(T)) * 20
        x, b = (rng.standard_normal((T,) + gs) for _ in range(2))
        ec = rng.standard_normal((T,) + tuple((n - 1) // 2 for n in gs))
        W = np.ascontiguousarray(jlev.Aw[:, : gs[0], : gs[1]])
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
            jx = jm._smooth(lev, lp, None, J(b), zero_init=True, nu=nu)
            want = {
                "residual": J(b) - jm._op(lev, lp, J(x)),
                "apply_A": lev.A_vs.apply(J(x), J(W)),
                "smooth": jm._smooth(lev, lp, J(x), J(b), nu=nu),
                "smooth_zero": jx,
            }
            if nu > 1:
                want.update({
                    "fused_pre_x": jx,
                    "fused_pre_rc": jmg._transfer_fast(
                        J(b) - jm._op(lev, lp, jx), 2, restrict=True),
                    "fused_post": jm._smooth(
                        lev, lp, J(x) + jmg._transfer_fast(J(ec), 2,
                                                           restrict=False),
                        J(b), nu=nu),
                })
        else:  # the Pallas kernels in interpret mode
            pj = VarMSPallasLevel(lev, T, jdt, nu, interpret=True)
            cols = VarMSPallasLevel.columns(jlev, omega, jdt)
            want = {
                "residual": pj.residual(J(x), J(b), cols, J(W)),
                "apply_A": pj.apply_A(J(x), J(W)),
                "smooth": pj.smooth(J(x), J(b), cols, J(W)),
                "smooth_zero": pj.smooth(None, J(b), cols, J(W),
                                         zero_init=True),
            }
            if nu > 1:
                tx = pj.transfers(jdt)
                jx, jrc = pj.fused_pre(J(b), cols, tx, J(W))
                want.update({
                    "fused_pre_x": jx,
                    "fused_pre_rc": jrc,
                    "fused_post": pj.fused_post(J(x), J(b), J(ec), cols, tx,
                                                J(W)),
                })
        P = lambda a: torch.tensor(a, dtype=tdt)
        kl = VarMSKernelLevel(plev, nu, gs=gs)
        assert kl.fused_ok == (nu > 1)
        tc = {"omega": P(omega), "invT": P(invT), "invDel": P(invDel)}
        got = {
            "residual": kl.residual(P(x), P(b), tc, P(W)),
            "apply_A": kl.apply_A(P(x), P(W)),
            "smooth": kl.smooth(P(x), P(b), tc, P(W)),
            "smooth_zero": kl.smooth(None, P(b), tc, P(W), zero_init=True),
        }
        if nu > 1:
            px, prc = kl.fused_pre(P(b), tc, P(W))
            got.update({
                "fused_pre_x": px,
                "fused_pre_rc": prc,
                "fused_post": kl.fused_post(P(x), P(b), P(ec), tc, P(W)),
            })
        cache[key] = (want, got)
        return cache[key]

    return run


TWIN_GRIDS = {"15x15": (15, 15), "15x31": (15, 31), "31x31": (31, 31)}
# (op, dtype, grid, ν): the fused stages' ν ∈ {2, 3} for K11, K12, K14 and
# K15; K10 (the JAX package's ``VarMSPallasLevel.smooth`` in f32, ``_smooth``
# in f64) at ν ∈ {1, 2, 3}
TWIN_CASES = [
    (op, dt, grid, nu)
    for op in ("residual", "apply_A", "fused_pre_x", "fused_pre_rc",
               "fused_post", "smooth", "smooth_zero")
    for dt in ("f64", "f32") for grid in TWIN_GRIDS
    for nu in ((1, 2, 3) if op.startswith("smooth") else (2, 3))]


@pytest.mark.parametrize("op, dt, grid, nu", TWIN_CASES,
                         ids=["-".join(map(str, c)) for c in TWIN_CASES])
def test_var_twin_matches_jax(twin_cases, op, dt, grid, nu):
    want, got = twin_cases(dt, TWIN_GRIDS[grid], nu)
    assert got[op].dtype == DTYPES[dt][1]
    transfer = op in ("fused_pre_rc", "fused_post")
    rel = 1e-12 if dt == "f64" else (1e-4 if transfer else 1e-5)
    _close(got[op], want[op], rel)


@pytest.mark.parametrize("cycles", [1, 2])
def test_weighted_vcycle_matches_jax_pallas_f64(hierarchies, cycles):
    """The port's weighted V-cycle with kernel levels (K14/K15, then K11
    starting the second cycle) against the JAX one with fused Pallas
    levels."""
    (jm, (A_c, M_c)), (pm, _) = hierarchies
    T = 5
    rng = np.random.default_rng(21)
    omega = np.abs(rng.standard_normal(T)) * 10
    b = rng.standard_normal((T, 31, 31))
    cinv = np.linalg.inv(A_c + omega.mean() * M_c)

    lps_j = jm.row_params(omega, jnp.float64)
    pallas = [VarMSPallasLevel(lev, T, jnp.float64, jm.nu, interpret=True)
              for lev in jm.levels]
    for pj, lp, lev in zip(pallas, lps_j, jm.levels):
        assert pj.fused_ok
        lp["cols"] = VarMSPallasLevel.columns(lev, omega, jnp.float64)
        lp["tx"] = pj.transfers(jnp.float64)
    cj = jnp.asarray(cinv)
    want = jm.solve(jnp.asarray(b), lps_j,
                    lambda bc: jnp.dot(bc.reshape(T, -1), cj).reshape(bc.shape),
                    cycles, pallas=pallas)

    lps_t = mg.var_row_params(pm, omega, torch.float64, "cpu")
    for lp in lps_t:
        lp["cols"] = VarMSKernelLevel.columns(lp)
    kernels = [VarMSKernelLevel(lev, pm.nu) for lev in pm.levels]
    ct = torch.as_tensor(cinv)
    coarse = lambda bc: (bc.reshape(T, -1) @ ct).reshape(bc.shape)
    got = mg.GalerkinMultiShiftMG(pm).solve(torch.as_tensor(b), lps_t, coarse,
                                            cycles, kernels=kernels)
    _close(got, want, 1e-12)
    plain = mg.GalerkinMultiShiftMG(pm).solve(torch.as_tensor(b), lps_t,
                                              coarse, cycles)
    _close(plain, want, 1e-12)


def _solvers(n, J, dtype):
    jprob = jax_problem("varcoef2d")
    jsys = jfem.P1System.from_problem(jprob, jfem.unit_square_mesh(n))
    js = JaxHeatSolver(jprob, jsys, jfem.uniform_time_grid(J),
                       dtype=getattr(jnp, dtype), rhs="host", **KW)
    ps = build_solver("varcoef2d", n, J, dtype=getattr(torch, dtype),
                      device="cpu", **KW)
    assert js.spatial_format == ps.spatial_format == "vstencil"
    assert [lev.n for lev in ps.msmg.levels] == [lev.n for lev in js.msmg.levels]
    return js, ps


@pytest.mark.parametrize("n, J", [(16, 3), (32, 4)], ids=["17^2x8", "33^2x16"])
def test_varcoef_solve_f64_matches_jax(n, J):
    js, ps = _solvers(n, J, "float64")
    assert all(k.fused_ok for k in ps._kl_ky)
    jr, pr = js.solve(tol=1e-8), ps.solve(tol=1e-8)
    assert jr.converged and pr.converged
    assert pr.iterations == jr.iterations
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
    np.testing.assert_allclose(pr.precond_residuals, jr.precond_residuals,
                               rtol=1e-10)
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)


def test_varcoef_f32_and_refined():
    """f32 within one PCG iteration of the JAX CPU solver, and the
    mixed-precision refinement to 1e-8 (``tests/test_galerkin_mg.py``)."""
    js, ps = _solvers(16, 4, "float32")
    jr, pr = js.solve(tol=1e-6), ps.solve(tol=1e-6)
    assert jr.converged and pr.converged
    assert abs(pr.iterations - jr.iterations) <= 1
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-3)
    r = ps.solve_refined(tol=1e-8)
    assert r.converged and r.residuals[-1] / r.residuals[0] <= 1e-8


def test_operators_match_jax_f64():
    js, ps = _solvers(16, 3, "float64")
    rng = np.random.default_rng(9)
    U = rng.standard_normal((ps.N + 1,) + ps.gs)
    tU, jU = torch.as_tensor(U), jnp.asarray(U)
    tV, jV = tU[:-1].contiguous(), jU[:-1]
    for got, want in ((ps.apply_B(tU), js.apply_B(jU)),
                      (ps.apply_BT(tV), js.apply_BT(jV)),
                      (ps.apply_stab(tU), js.apply_stab(jU)),
                      (ps.apply_trace(tU), js.apply_trace(jU)),
                      (ps.apply_S(tU), js.apply_S(jU)),
                      (ps.apply_KX(tU), js.apply_KX(jU))):
        _close(got, want, 1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_params_from_jax_weighted(dtype):
    """The weighted tree (f32: Pallas levels on every level, so it carries
    ``cols`` and the banded ``tx`` the port drops) in the port's layout."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jprob = jax_problem("varcoef2d")
    jsys = jfem.P1System.from_problem(jprob, jfem.unit_square_mesh(16))
    js = JaxHeatSolver(jprob, jsys, jfem.uniform_time_grid(3), dtype=jdt,
                       rhs="host", pallas_kron=dtype == "float32", **KW)
    js.mg_pallas_min_points = 0
    js._params_cache.clear()
    tree = jax.tree_util.tree_map(np.asarray, js.params_for(jdt))
    assert all(("cols" in lp) == (dtype == "float32")
               for lp in tree["ms_ky"] + tree["ms_kx"])
    got = params_from_jax(tree, "cpu", tdt)
    want = build_solver("varcoef2d", 16, 3, dtype=tdt, device="cpu",
                        **KW).params_for(tdt)
    np.testing.assert_array_equal(got["Aw"].numpy(), np.asarray(tree["Aw"]))
    # the JAX Chebyshev M⁻¹'s per-node Jacobi vector, dropped by the port,
    # holds one value: M is the constant mass stencil
    invM = np.asarray(tree["cheb_invM"])
    assert invM.min() == invM.max()

    def compare(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), (path, set(g) ^ set(w))
            for k in w:
                compare(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), path
            for i, (a, c) in enumerate(zip(g, w)):
                compare(a, c, f"{path}[{i}]")
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, path
            torch.testing.assert_close(g, w, rtol=1e-15, atol=0, msg=path)

    compare(got, want)


def test_unported_weighted_paths_raise():
    """What raises on the weighted format: multigrid on the DIA / ELL
    formats, the constant-stencil format and transfers on even extents.
    Weighted V(ν, ν_post) cycles and ν ∉ {2, 3} build and solve on the
    semi-fused stages, varcoef3d on the fused ones (2-D and 3-D alike), and
    3-D sweeps of degree above the tiled kernels' 3 take the JAX package's
    iterations."""
    system = fem.P1System.from_problem(get_problem("varcoef2d"),
                                       fem.unit_square_mesh(16))
    grid = fem.uniform_time_grid(2)
    mk = lambda **kw: HeatSolver(get_problem("varcoef2d"), system, grid,
                                 device="cpu", **{**KW, **kw})
    for kw in (dict(mg_nu_post=1), dict(mg_nu=4), dict(mg_nu_kx=1)):
        s = mk(**kw)
        assert not all(k.fused_ok for k in s._kl_ky + s._kl_kx), kw
        assert all(k.semi_ok for k in s._kl_ky + s._kl_kx), kw
        assert s.solve(tol=1e-8, compute_error=False).converged, kw
    assert mk(mg_nu=3, mg_nu_post=3).spatial_format == "vstencil"
    with pytest.raises(ValueError, match="'stencil' needs a translation"):
        mk(spatial_format="stencil")
    for fmt in ("dia", "ell"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mk(spatial_format=fmt)
    with pytest.raises(ValueError, match="coefficient-weighted"):
        build_solver("smooth2d", 16, 2, device="cpu", spatial_format="vstencil",
                     **KW)
    s3 = build_solver("varcoef3d", 8, 2, device="cpu", inner="mg")
    assert s3.spatial_format == "vstencil" and len(s3.gs) == 3
    assert s3.solve(tol=1e-8, compute_error=False).converged
    system3 = jfem.P1System.from_problem(jax_problem("varcoef3d"),
                                         jfem.unit_cube_mesh(8))
    kw = dict(mg_nu=4, mg_nu_post=4, mg_nu_kx=5)
    ps = build_solver("varcoef3d", 8, 2, device="cpu", inner="mg", **kw)
    js = JaxHeatSolver(jax_problem("varcoef3d"), system3,
                       jfem.uniform_time_grid(2), dtype=jnp.float64,
                       rhs="host", inner="mg", **kw)
    pr = ps.solve(tol=1e-8, compute_error=False)
    jr = js.solve(tol=1e-8, compute_error=False)
    assert pr.converged and pr.iterations == jr.iterations
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
    msmg = mk().msmg
    lev = msmg.levels[0]
    kl = VarMSKernelLevel(lev, 2, nu_post=1)
    assert not kl.fused_ok and kl.semi_ok
    even = VarMSKernelLevel(lev, 2, nu_post=1, gs=(14, 15))
    with pytest.raises(ValueError, match="odd extents"):
        mg.GalerkinMultiShiftMG(msmg).vcycle(
            torch.zeros((1, 14, 15), dtype=torch.float64), [None],
            lambda bc: bc, kernels=[even])
    kl3 = VarMSKernelLevel(dataclasses.replace(lev, gs=(7, 7, 7)), 2)
    assert kl3.fused_ok and kl3.semi_ok
    assert all(k.fused_ok and k.dim == 3 for k in s3._kl_ky + s3._kl_kx)
    even3 = VarMSKernelLevel(dataclasses.replace(lev, gs=(8, 7, 7)), 2)
    assert not even3.fused_ok and not even3.semi_ok
    with pytest.raises(ValueError, match="odd extents"):
        mg.GalerkinMultiShiftMG(msmg).vcycle(
            torch.zeros((1, 8, 7, 7), dtype=torch.float64), [None],
            lambda bc: bc, kernels=[even3])


def test_var_levels_dispatch_by_device():
    ps = build_solver("varcoef2d", 16, 2, device="cpu", **KW)
    kl, p = ps._kl_ky[0], ps.params
    meta = torch.empty((3, 15, 15), device="meta")
    cols = {k: torch.empty(3, device="meta") for k in ("omega", "invT",
                                                       "invDel")}
    for call in (lambda: kl.residual(meta, meta, cols, meta[:1]),
                 lambda: kl.apply_A(meta, meta[:1]),
                 lambda: kl.fused_pre(meta, cols, meta[:1]),
                 lambda: kl.fused_post(meta, meta, meta[:, :7, :7], cols,
                                       meta[:1])):
        with pytest.raises(ValueError, match="no mg kernel for device meta"):
            call()
    mg_kernels.reset_launch_counts()
    U = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (ps.N + 1,) + ps.gs))
    ps.apply_S(U, p)
    ps.apply_KX(U, p)
    assert all(n == 0 for n in mg_kernels.launch_counts().values())
