"""The smoothed-aggregation multigrid of the port against the JAX package:
the aggregation (``_sa_aggregate``, the port's Python loop against the JAX
package's native core) bit for bit on triangles and tetrahedra,
``sa_prolongator`` to 1e-14, the hierarchy's DIA and ELL levels bit for
bit, one V-cycle in float64 with the K16–K20 twins (factored transfers on
the DIA level, K19/K20 on the ELL level) and in the plain form to 1e-12,
and solves: float64 iteration counts equal and histories to 1e-10,
float32 counts within ±1; ``convert`` carries the JAX solver's params
over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

import spacetime_tpu.fem as jfem
from spacetime_tpu.models import get_problem as jget_problem
from spacetime_tpu.ops.multigrid import SAMultiShiftMultigrid as JSA
from spacetime_tpu.ops.multigrid import _sa_aggregate as j_sa_aggregate
from spacetime_tpu.ops.multigrid import sa_prolongator as jsa_prolongator
from spacetime_tpu.solver.heateq import HeatSolver as JHeatSolver
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import dia_kernels, spmv
from spacetime_tpu_torch.ops.dia_kernels import DiaKernelLevel
from spacetime_tpu_torch.ops.multigrid import (SAMultiShiftMG,
                                               SAMultiShiftMultigrid,
                                               _sa_aggregate,
                                               flat_level_arrays,
                                               flat_row_params,
                                               sa_prolongator)
from spacetime_tpu_torch.solver import HeatSolver, build_solver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch and the host BLAS (see tests/test_torch_ell.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


MESHES = {"lshape": lambda: fem.l_shape_mesh(32),
          "cube": lambda: fem.unit_cube_mesh(6)}


@pytest.mark.parametrize("mesh", ["lshape", "cube"])
def test_aggregation_and_prolongator_equal_jax(mesh):
    A = fem.P1System.from_mesh(MESHES[mesh]()).A
    agg, na = _sa_aggregate(A, 0.08)
    jagg, jna = j_sa_aggregate(A, 0.08)
    assert na == jna
    np.testing.assert_array_equal(agg, jagg)
    P, agg, tw, wd = sa_prolongator(A, return_parts=True)
    JP, jagg, jtw, jwd = jsa_prolongator(A, return_parts=True)
    np.testing.assert_array_equal(agg, jagg)
    np.testing.assert_array_equal(tw, jtw)
    np.testing.assert_allclose(wd, jwd, rtol=1e-14)
    assert P.shape == JP.shape
    D = abs(P - JP)
    assert D.max() <= 1e-14 * abs(JP).max()


@pytest.fixture(scope="module")
def hierarchies():
    """Both packages' SA hierarchies of the 64-cell L-shape down to 300
    dofs: a DIA fine level (2,945) and an aggregated ELL level (511)."""
    s = fem.P1System.from_mesh(fem.l_shape_mesh(64))
    A, M = sp.csr_matrix(s.A), sp.csr_matrix(s.M)
    return (SAMultiShiftMultigrid.build(A, M, m_coarse=300),
            JSA.build(A, M, m_coarse=300))


def test_levels_equal_jax(hierarchies):
    (ms, (Ac, Mc)), (jms, (jAc, jMc)) = hierarchies
    assert [(lev.m, lev.fmt) for lev in ms.levels] == [
        (lev.m, lev.fmt) for lev in jms.levels] == [(2945, "dia"),
                                                     (511, "ell")]
    # the port's DIA levels always carry the factored transfers; the JAX
    # package's default uses them too
    assert jms.factored_transfers
    assert ms.levels[0].agg is not None and ms.levels[1].agg is None
    fields = ("Av", "Mv", "eidx", "ewA", "ewM", "dA", "dM", "rsA", "rsM",
              "Pidx", "Ridx", "agg", "tw", "mem_idx", "mem_w")
    for lev, jlev in zip(ms.levels, jms.levels):
        assert (lev.offA, lev.offM) == (jlev.offA, jlev.offM)
        for f in fields:
            g, w = getattr(lev, f), getattr(jlev, f)
            assert (g is None) == (w is None), f
            if g is not None:
                np.testing.assert_array_equal(g, w)
        for f in ("Pw", "Rw", "wd"):
            if getattr(jlev, f) is not None:
                np.testing.assert_allclose(getattr(lev, f), getattr(jlev, f),
                                           rtol=1e-14, atol=1e-300)
    np.testing.assert_allclose(Ac, jAc, rtol=0, atol=1e-13 * abs(jAc).max())
    np.testing.assert_allclose(Mc, jMc, rtol=0, atol=1e-13 * abs(jMc).max())


@pytest.mark.parametrize("kernels", [True, False])
def test_vcycle_matches_jax_f64(hierarchies, kernels):
    """Two V-cycles with per-row shifts and a dense coarse solve: the K16,
    K17, K18 (factored transfers), K19 and K20 twins, or the plain form,
    to 1e-12 of JAX's plain form."""
    (ms, (Ac, Mc)), (jms, _) = hierarchies
    T = 4
    omega = np.array([0.0, 10.0, 300.0, 4000.0])
    rng = np.random.default_rng(5)
    b = rng.standard_normal((T, ms.levels[0].m))
    cinv = np.stack([np.linalg.inv(Ac + w * Mc) for w in omega])
    kl = None
    if kernels:
        kl = [DiaKernelLevel(lev, 2) if lev.fmt == "dia"
              else spmv.EllKernelLevel(lev) for lev in ms.levels]
    arrays = flat_level_arrays(ms, torch.float64, "cpu", kl)
    lps = flat_row_params(ms, omega, torch.float64, "cpu", arrays)
    ct = torch.as_tensor(cinv)
    dia_kernels.reset_launch_counts()
    spmv.reset_launch_counts()
    got = SAMultiShiftMG(ms).solve(
        torch.as_tensor(b), lps, lambda bc: torch.einsum("tij,tj->ti", ct, bc),
        cycles=2, kernels=kl).numpy()
    assert all(n == 0 for n in dia_kernels.launch_counts().values())
    assert all(n == 0 for n in spmv.launch_counts().values())
    jc = jnp.asarray(cinv)
    want = np.asarray(jms.solve(
        jnp.asarray(b), jms.row_params(omega, jnp.float64),
        lambda bc: jnp.einsum("tij,tj->ti", jc, bc), cycles=2))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _solvers(dtype, jdtype):
    problem = jget_problem("lshape2d")
    js = JHeatSolver(problem,
                     jfem.P1System.from_problem(problem, jfem.l_shape_mesh(24)),
                     jfem.uniform_time_grid(3), dtype=jdtype, rhs="host",
                     inner="amg")
    ps = build_solver("lshape2d", 24, 3, dtype=dtype, device="cpu",
                      inner="amg")
    return js, ps


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_amg_solve_matches_jax(dtype):
    """The 24-cell L-shape (one DIA level of 385 dofs with factored
    transfers; coarse 72), 8 steps; the two-level cycle with an ELL level
    is held to JAX's in ``test_vcycle_matches_jax_f64``."""
    f64 = dtype == "f64"
    js, ps = _solvers(torch.float64 if f64 else torch.float32,
                      jnp.float64 if f64 else jnp.float32)
    assert ps.mg_flavor == js.mg_flavor == "SAMultiShiftMultigrid"
    assert [lev.m for lev in ps.msmg.levels] == [385]
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


def test_convert_amg_params_match_jax_operators():
    js, ps = _solvers(torch.float64, jnp.float64)
    tree = jax.tree_util.tree_map(np.asarray, dict(js.params))
    p = params_from_jax(tree, "cpu", torch.float64, hierarchy=js.msmg)
    U = np.random.default_rng(6).standard_normal((ps.N + 1, ps.m))
    for name in ("apply_S", "apply_KX"):
        got = getattr(ps, name)(torch.as_tensor(U), p).numpy()
        want = np.asarray(getattr(js, name)(jnp.asarray(U)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-11 * np.abs(want).max())


def test_amg_with_an_ell_level_solves():
    """The 64-cell L-shape with coarse 300: its ELL level runs K19 and the
    K20 transfers (twins here) inside the solve, f64, 4 steps."""
    s = build_solver("lshape2d", 64, 2, device="cpu", inner="amg",
                     mg_coarse=300)
    assert [k.kind for k in s._kl_ky] == ["dia", "ell"]
    r = s.solve(tol=1e-8)
    assert r.converged and r.iterations <= 25


def test_amg_needs_the_flat_layout():
    problem = get_problem("smooth2d")
    system = fem.P1System.from_mesh(fem.unit_square_mesh(16))
    with pytest.raises(ValueError, match="flat dof layout"):
        HeatSolver(problem, system, fem.uniform_time_grid(2), device="cpu",
                   inner="amg")
    s = HeatSolver(problem, system, fem.uniform_time_grid(2), device="cpu",
                   inner="amg", spatial_format="dia")
    assert s.mg_flavor == "SAMultiShiftMultigrid"
    assert s.solve(tol=1e-8).converged
