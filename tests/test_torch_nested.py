"""The nested red-refinement multigrid of the port against the JAX package:
``refine_uniform`` / ``sort_vertices_lex`` / ``refine_hierarchy`` and
``nested_interpolation`` bit for bit on triangles and tetrahedra, the
hierarchy's levels bit for bit, one V-cycle in float64 (with the K16–K18
twins, and in the plain form) to 1e-12, and solves on the L-shape of 8
cells refined twice: float64 iteration counts equal and histories to
1e-10, float32 counts within ±1. ``inner="auto"`` takes the nested
hierarchy on a mesh with a refinement chain, and ``convert`` carries the
JAX solver's params over."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spacetime_tpu.fem as jfem
from spacetime_tpu.models import get_problem as jget_problem
from spacetime_tpu.ops.multigrid import NestedMultiShiftMultigrid as JNested
from spacetime_tpu.solver.heateq import HeatSolver as JHeatSolver
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import dia_kernels
from spacetime_tpu_torch.ops.dia_kernels import DiaKernelLevel
from spacetime_tpu_torch.ops.multigrid import (NestedMultiShiftMG,
                                               NestedMultiShiftMultigrid,
                                               flat_level_arrays,
                                               flat_row_params)
from spacetime_tpu_torch.solver import HeatSolver, build_solver

BASES = {"lshape": (fem.l_shape_mesh, jfem.l_shape_mesh, 8),
         "cube": (fem.unit_cube_mesh, jfem.unit_cube_mesh, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch and the host BLAS (see tests/test_torch_ell.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _meshes(base, refines):
    mk, jmk, n = BASES[base]
    return (fem.refine_hierarchy(mk(n), refines),
            jfem.refine_hierarchy(jmk(n), refines))


def _equal_mesh(got, want):
    for f in ("vertices", "elements", "boundary", "interior"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w)
    assert got.grid_shape == want.grid_shape


@pytest.mark.parametrize("base, refines", [("lshape", 1), ("lshape", 2),
                                           ("cube", 1)])
def test_refinement_equal_jax(base, refines):
    got, want = _meshes(base, refines)
    while want.refined_from is not None:
        _equal_mesh(got, want)
        (got, gpe), (want, wpe) = got.refined_from, want.refined_from
        assert gpe.dtype == wpe.dtype
        np.testing.assert_array_equal(gpe, wpe)
    assert got.refined_from is None
    _equal_mesh(got, want)
    raw = fem.refine_uniform(BASES[base][0](BASES[base][2]))
    _equal_mesh(raw, jfem.refine_uniform(BASES[base][1](BASES[base][2])))
    _equal_mesh(fem.sort_vertices_lex(raw),
                jfem.sort_vertices_lex(
                    jfem.refine_uniform(BASES[base][1](BASES[base][2]))))


@pytest.mark.parametrize("base", ["lshape", "cube"])
def test_nested_interpolation_equal_jax(base):
    got, want = _meshes(base, 2)
    P, JP = fem.nested_interpolation(got), jfem.nested_interpolation(want)
    assert P.shape == JP.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(P, f), getattr(JP, f))
    with pytest.raises(ValueError, match="refinement record"):
        fem.nested_interpolation(fem.l_shape_mesh(8))


@pytest.fixture(scope="module", params=["lshape", "cube"])
def hierarchies(request):
    """Both packages' hierarchies of the L-shape of 8 cells refined twice
    (levels of 705 and 161 dofs, coarse 33) and of the cube of 3 cells
    refined twice (tetrahedra: levels of 1,331 and 125, coarse 8)."""
    mesh, jmesh = _meshes(request.param, 2)
    s, js = fem.P1System.from_mesh(mesh), jfem.P1System.from_mesh(jmesh)
    return (NestedMultiShiftMultigrid.build(mesh, s.A, s.M, m_coarse=64),
            JNested.build(jmesh, js.A, js.M, m_coarse=64))


def test_levels_equal_jax(hierarchies):
    (ms, (Ac, Mc)), (jms, (jAc, jMc)) = hierarchies
    assert len(ms.levels) == len(jms.levels) == 2
    for lev, jlev in zip(ms.levels, jms.levels):
        assert (lev.offA, lev.offM, lev.m) == (jlev.offA, jlev.offM, jlev.m)
        for f in ("Av", "Mv", "dA", "dM", "rsA", "rsM", "Pidx", "Pw", "Ridx",
                  "Rw"):
            np.testing.assert_array_equal(getattr(lev, f), getattr(jlev, f))
    np.testing.assert_array_equal(Ac, jAc)
    np.testing.assert_array_equal(Mc, jMc)


@pytest.mark.parametrize("kernels", [True, False])
def test_vcycle_matches_jax_f64(hierarchies, kernels):
    """One V-cycle from x = 0 with per-row shifts and a dense coarse solve,
    through the K16/K17 twins or the plain form, to 1e-12 of JAX's."""
    (ms, (Ac, Mc)), (jms, _) = hierarchies
    T = 5
    omega = np.array([0.0, 3.0, 40.0, 900.0, 2e4])
    rng = np.random.default_rng(3)
    b = rng.standard_normal((T, ms.levels[0].m))
    cinv = np.stack([np.linalg.inv(Ac + w * Mc) for w in omega])
    kl = [DiaKernelLevel(lev, 2) for lev in ms.levels] if kernels else None
    arrays = flat_level_arrays(ms, torch.float64, "cpu", kl)
    lps = flat_row_params(ms, omega, torch.float64, "cpu", arrays)
    ct = torch.as_tensor(cinv)
    coarse = lambda bc: torch.einsum("tij,tj->ti", ct, bc)
    dia_kernels.reset_launch_counts()
    got = NestedMultiShiftMG(ms).solve(torch.as_tensor(b), lps, coarse,
                                       cycles=2, kernels=kl).numpy()
    assert all(n == 0 for n in dia_kernels.launch_counts().values())
    jlps = jms.row_params(omega, jnp.float64)
    jc = jnp.asarray(cinv)
    want = np.asarray(jms.solve(jnp.asarray(b), jlps,
                                lambda bc: jnp.einsum("tij,tj->ti", jc, bc),
                                cycles=2))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _solvers(dtype, jdtype, **kw):
    problem = jget_problem("lshape2d")
    jmesh = jfem.refine_hierarchy(jfem.l_shape_mesh(8), 2)
    js = JHeatSolver(problem, jfem.P1System.from_problem(problem, jmesh),
                     jfem.uniform_time_grid(4), dtype=jdtype, rhs="host",
                     inner="mg", **kw)
    ps = build_solver("lshape2d", 8, 4, dtype=dtype, device="cpu", refine=2,
                      inner="mg", **kw)
    return js, ps


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_nested_solve_matches_jax(dtype):
    f64 = dtype == "f64"
    js, ps = _solvers(torch.float64 if f64 else torch.float32,
                      jnp.float64 if f64 else jnp.float32)
    assert ps.mg_flavor == js.mg_flavor == "NestedMultiShiftMultigrid"
    tol = 1e-8 if f64 else 1e-6
    jr, pr = js.solve(tol=tol), ps.solve(tol=tol)
    assert pr.converged
    if f64:
        assert pr.iterations == jr.iterations
        np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
        np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)
    else:
        assert abs(pr.iterations - jr.iterations) <= 1
        np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-3)


def test_convert_nested_params_match_jax_operators():
    """The JAX solver's f64 params through ``params_from_jax`` give the
    port's S, K_X and rhs the JAX operators' values."""
    js, ps = _solvers(torch.float64, jnp.float64)
    tree = {k: v for k, v in js.params.items()}
    import jax

    tree = jax.tree_util.tree_map(np.asarray, tree)
    p = params_from_jax(tree, "cpu", torch.float64, hierarchy=js.msmg)
    rng = np.random.default_rng(4)
    U = rng.standard_normal((ps.N + 1, ps.m))
    for name in ("apply_S", "apply_KX"):
        got = getattr(ps, name)(torch.as_tensor(U), p).numpy()
        want = np.asarray(getattr(js, name)(jnp.asarray(U)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-11 * np.abs(want).max())


def test_nested_3d_solve_converges():
    """Tetrahedra through the solver: smooth3d on the cube of 3 cells
    refined twice (m = 1,331), float64, 4 steps; the hierarchy is held to
    JAX's in ``test_levels_equal_jax`` and its V-cycle in
    ``test_vcycle_matches_jax_f64``."""
    ps = build_solver("smooth3d", 3, 2, device="cpu", refine=2, inner="mg")
    assert ps.mg_flavor == "NestedMultiShiftMultigrid"
    r = ps.solve(tol=1e-8)
    assert r.converged and r.iterations <= 20
    assert r.l2_error < 0.05


def test_auto_picks_mg_on_a_refinement_chain():
    problem = get_problem("lshape2d")
    grid = fem.uniform_time_grid(2)
    mesh = fem.refine_hierarchy(fem.l_shape_mesh(8), 4)
    s = HeatSolver(problem, fem.P1System.from_problem(problem, mesh), grid,
                   device="cpu")
    assert s.m > 4096
    assert (s.inner, s.mg_flavor) == ("mg", "NestedMultiShiftMultigrid")
    assert [lev.m for lev in s.msmg.levels] == [12033, 2945]
    assert all(k.kind == "dia" for k in s._kl_ky)
    with pytest.raises(ValueError, match="refinement chain"):
        HeatSolver(problem, fem.P1System.from_mesh(fem.l_shape_mesh(8)),
                   grid, device="cpu", inner="mg")
