"""The Chebyshev inner solver (``inner="cheb"``) against the JAX package: the
copied host helpers (spectral bounds, coefficients, degrees) equal, the
lshape-32-J5 solve on ``"dia"`` and ``"ell"`` with JAX's iteration count
(equal in f64, ±1 in f32), and port solvers built from JAX solvers' params
(``convert.params_from_jax``; dense and Chebyshev inner solves on the
stencil, weighted and flat formats) reproducing their ``apply_S`` and
``apply_KX``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from spacetime_tpu import fem as jfem
from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu.ops import multigrid as jmg
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.solver import HeatSolver

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's many small CPU products, torch's and
    the host BLAS's: with several test workers on one host their thread
    pools contend (tens of times slower), while one thread loses little."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [16, 32])
def test_cheb_helpers_equal_jax(n):
    system = fem.P1System.from_mesh(fem.l_shape_mesh(n))
    for Op, kw in ((system.A, {}), (system.M, {"known_lmin": 0.5})):
        got = mg.generic_spectral_bounds(Op, **kw)
        assert got == jmg.generic_spectral_bounds(Op, **kw)
        for eps in (1e-3, 3e-2):
            deg = mg.chebyshev_degree(*got, eps)
            assert deg == jmg.chebyshev_degree(*got, eps) >= 1
            np.testing.assert_array_equal(
                mg.chebyshev_coefficients(*got, deg),
                jmg.chebyshev_coefficients(*got, deg))


def test_cheb_run_is_the_polynomial():
    """``cheb_run`` over ``chebyshev_coefficients`` rows equals the
    unrolled recurrence of ``chebyshev_generic`` (the JAX package's two
    forms, which it keeps numerically identical)."""
    system = fem.P1System.from_mesh(fem.l_shape_mesh(16))
    A = system.A
    lmin, lmax = mg.generic_spectral_bounds(A)
    deg = mg.chebyshev_degree(lmin, lmax, 1e-6)
    invd = 1.0 / np.asarray(A.diagonal())
    b = np.random.default_rng(0).standard_normal((2, A.shape[0]))
    coef = [tuple(r) for r in mg.chebyshev_coefficients(lmin, lmax, deg)]
    At = torch.as_tensor(A.toarray())
    got = mg.cheb_run(torch.as_tensor(b), torch.as_tensor(invd),
                      lambda x: x @ At.T, 0.5 * (lmax + lmin), coef)
    want = jmg.chebyshev_generic(lambda x: (A @ x.T).T, invd, lmin, lmax,
                                 deg)(b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose((A @ got.numpy().T).T, b, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def lshape32():
    system = jfem.P1System.from_mesh(jfem.l_shape_mesh(32))
    return system, jfem.uniform_time_grid(5), {}


def _jax_run(lshape32, fmt, dt):
    system, grid, cache = lshape32
    if (fmt, dt) not in cache:
        js = JaxHeatSolver(jax_problem("lshape2d"), system, grid,
                           dtype=DTYPES[dt][0], spatial_format=fmt,
                           inner="cheb", rhs="host")
        cache[(fmt, dt)] = js.solve(tol=1e-6)
    return cache[(fmt, dt)]


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_cheb_solve_matches_jax(lshape32, fmt, dt):
    """lshape-32-J5 (m = 705, 33 time nodes), tol 1e-6. The JAX f64 solver
    on ``"ell"`` falls back to DIA, the port runs the K20 twin, so f64 holds
    both to the JAX ``"dia"`` solve; f32 ``"ell"`` holds the port to the
    JAX Pallas kernel in interpret mode."""
    system, grid, _ = lshape32
    ps = HeatSolver(get_problem("lshape2d"), system, grid,
                    dtype=DTYPES[dt][1], spatial_format=fmt, inner="cheb",
                    device="cpu")
    assert ps.gs == (ps.m,) and ps._cheb_spec["A"][2] == 59
    assert [s[3] for s in ps._cheb_spec["shift"]] == [32, 32, 31, 31, 29, 26]
    jr = _jax_run(lshape32, fmt if dt == "f32" else "dia", dt)
    pr = ps.solve(tol=1e-6)
    assert pr.converged and jr.converged
    if dt == "f64":
        assert pr.iterations == jr.iterations
        np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
        np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)
    else:
        assert abs(pr.iterations - jr.iterations) <= 1
        np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-3)


# (problem, cells, levels, spatial format, inner, dtype, tolerance)
CONVERT = [
    ("smooth2d", 8, 3, "stencil", "dense", "f64", 1e-12),
    ("varcoef2d", 8, 3, "vstencil", "dense", "f64", 1e-12),
    ("lshape2d", 16, 3, "dia", "dense", "f64", 1e-12),
    ("lshape2d", 16, 3, "dia", "cheb", "f64", 1e-12),
    ("lshape2d", 16, 3, "ell", "dense", "f32", 1e-5),
    ("lshape2d", 8, 2, "ell", "cheb", "f32", 1e-5),
]


@pytest.mark.parametrize("problem, n, J, fmt, inner, dt, tol", CONVERT,
                         ids=[f"{c[0]}-{c[3]}-{c[4]}-{c[5]}" for c in CONVERT])
def test_params_from_jax_reproduce_operators(problem, n, J, fmt, inner, dt,
                                             tol):
    jp = jax_problem(problem)
    system = jfem.P1System.from_problem(jp, jfem.domain_mesh(jp.domain, 2, n))
    grid = jfem.uniform_time_grid(J)
    jdt, tdt = DTYPES[dt]
    js = JaxHeatSolver(jp, system, grid, dtype=jdt, spatial_format=fmt,
                       inner=inner, rhs="host")
    ps = HeatSolver(get_problem(problem), system, grid, dtype=tdt,
                    spatial_format=fmt, inner=inner, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    assert ("ell_A" in tree) == (fmt == "ell")
    p = params_from_jax(tree, "cpu", tdt)
    assert set(p) == set(ps.params)
    for k in ("ell_A", "ell_M") if fmt == "ell" else ():
        # the JAX blocks packed as the port packs its own
        assert all(torch.equal(p[k][a], ps.params[k][a]) for a in p[k]), k
    rng = np.random.default_rng(n)
    npdt = np.float64 if dt == "f64" else np.float32
    U = rng.standard_normal((ps.N + 1,) + ps.gs).astype(npdt)
    for name in ("apply_S", "apply_KX"):
        want = np.asarray(getattr(js, name)(jnp.asarray(U)))
        got = getattr(ps, name)(torch.as_tensor(U), p).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=name)
