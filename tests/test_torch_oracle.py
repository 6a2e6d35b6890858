"""The port's float64 solves against the oracle's table (``baseline_oracle.json``,
``scripts/record_baseline.py``): all twelve rows, the two singular ones on
time grids graded toward t = 0, each
solved by the port with the inner solver and format ``"auto"`` picks (dense
inverses at these sizes; ``"stencil"``, ``"vstencil"`` or the L-shape's
``"dia"``, and that row again on ``"ell"``). Iteration counts are equal and
the relative residual histories equal the table's 7 significant digits; on
the smallest rows the whole history equals the JAX package's f64
``HeatSolver`` to 1e-11. Also the L-shaped mesh bit for bit and the
``moving_peak2d`` / ``lshape2d`` data against the JAX package's."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from spacetime_tpu import fem as jfem
from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.solver import HeatSolver, build_solver

REPO = Path(__file__).resolve().parent.parent
ORACLE = {r["config"]: r for r in json.loads(
    (REPO / "baseline_oracle.json").read_text())}
# (config, problem, cells, time levels, extra levels toward t = 0, tol,
# spatial format)
ROWS = [
    ("cfg1-2d-65x65x64-tol1e-6", "smooth2d", 64, 6, 0, 1e-6, "auto"),
    ("cfg1b-2d-65x65x64-tol1e-8", "smooth2d", 64, 6, 0, 1e-8, "auto"),
    ("2d-ladder-8x8x8", "smooth2d", 8, 3, 0, 1e-6, "auto"),
    ("2d-ladder-16x16x16", "smooth2d", 16, 4, 0, 1e-6, "auto"),
    ("2d-ladder-32x32x32", "smooth2d", 32, 5, 0, 1e-6, "auto"),
    ("cfg3-3d-17x17x17x16", "smooth3d", 16, 4, 0, 1e-6, "auto"),
    ("cfg4-singular-graded-32-J4+4", "singular2d", 32, 4, 4, 1e-6, "auto"),
    ("singular3d-graded-8-J2+3", "singular3d", 8, 2, 3, 1e-6, "auto"),
    ("moving-peak-32x32x32", "moving_peak2d", 32, 5, 0, 1e-6, "auto"),
    ("lshape-32-J5", "lshape2d", 32, 5, 0, 1e-6, "auto"),
    ("lshape-32-J5", "lshape2d", 32, 5, 0, 1e-6, "ell"),
    ("varcoef-32-J5", "varcoef2d", 32, 5, 0, 1e-6, "auto"),
    ("varcoef3d-8-J3", "varcoef3d", 8, 3, 0, 1e-6, "auto"),
]
FORMATS = {"smooth2d": "stencil", "smooth3d": "stencil",
           "singular2d": "stencil", "singular3d": "stencil",
           "moving_peak2d": "stencil", "lshape2d": "dia",
           "varcoef2d": "vstencil", "varcoef3d": "vstencil"}
# the smallest rows, whose whole history is also held to the JAX f64
# solver (lshape-32-J5 is held to it in tests/test_torch_cheb.py)
SMALL = {"2d-ladder-8x8x8", "2d-ladder-16x16x16", "varcoef3d-8-J3"}


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


@pytest.fixture(scope="module")
def solvers():
    """One port solver per (problem, cells, levels, format): cfg1 and cfg1b
    share theirs."""
    cache = {}

    def get(problem, n, J, extra, fmt):
        key = (problem, n, J, extra, fmt)
        if key not in cache:
            cache[key] = build_solver(problem, n, J, dtype=torch.float64,
                                      device="cpu", spatial_format=fmt,
                                      extra_time_levels=extra)
        return cache[key]

    return get


def _seven_digits(rel):
    """The table's rounding (``record_baseline.py``)."""
    return [float(f"{x:.6e}") for x in rel]


@pytest.mark.parametrize(
    "label, problem, n, J, extra, tol, fmt", ROWS,
    ids=[f"{r[0]}-{r[6]}" for r in ROWS])
def test_row_matches_oracle(solvers, label, problem, n, J, extra, tol, fmt):
    row = ORACLE[label]
    s = solvers(problem, n, J, extra, fmt)
    assert s.inner == "dense" and s.wt.is_uniform == (extra == 0)
    assert s.spatial_format == (FORMATS[problem] if fmt == "auto" else fmt)
    r = s.solve(tol=tol)
    assert r.converged and r.iterations == row["iters"]
    rel = r.residuals / r.residuals[0]
    assert _seven_digits(rel) == row["rel_residuals"]
    np.testing.assert_allclose(r.l2_error, row["l2_error"], rtol=1e-9)
    if label in SMALL and fmt == "auto":
        system = jfem.P1System.from_problem(
            jax_problem(problem), jfem.domain_mesh(s.problem.domain,
                                                   s.problem.dim, n))
        js = JaxHeatSolver(jax_problem(problem), system,
                           jfem.uniform_time_grid(J), dtype=jnp.float64,
                           rhs="host")
        assert (js.inner, js.spatial_format) == (s.inner, s.spatial_format)
        jr = js.solve(tol=tol)
        assert jr.iterations == r.iterations
        np.testing.assert_allclose(r.residuals, jr.residuals, rtol=1e-11)
        np.testing.assert_allclose(r.precond_residuals, jr.precond_residuals,
                                   rtol=1e-11)


@pytest.mark.parametrize("n", [4, 16, 32])
def test_l_shape_mesh_equal_jax(n):
    got, want = fem.l_shape_mesh(n), jfem.l_shape_mesh(n)
    for f in ("vertices", "elements", "boundary", "interior"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, f)
    assert got.grid_shape is want.grid_shape is None
    np.testing.assert_array_equal(
        fem.domain_mesh("lshape", 2, n).elements, want.elements)
    with pytest.raises(ValueError, match="even n"):
        fem.l_shape_mesh(n + 1)


@pytest.mark.parametrize("name", ["moving_peak2d", "lshape2d"])
def test_new_problems_match_jax(name):
    ref, port = jax_problem(name), get_problem(name)
    assert (port.dim, port.T, port.domain) == (ref.dim, ref.T, ref.domain)
    rng = np.random.default_rng(4)
    X = rng.uniform(0.0, 1.0, (257, 2))
    ts = rng.uniform(0.0, 1.0, 5)
    tol = dict(rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(port.u0(X), ref.u0(X), **tol)
    np.testing.assert_allclose(port.exact_np(0.37, X), ref.exact_np(0.37, X),
                               **tol)
    np.testing.assert_allclose(port.g_many(ts, X), ref.g_many(ts, X), **tol)


def test_lshape_loads_equal_jax():
    """The same source (the port's problem) through both quadratures on
    the L-shape."""
    problem = get_problem("lshape2d")
    grid, jgrid = fem.uniform_time_grid(2), jfem.uniform_time_grid(2)
    got = fem.spacetime_loads(problem, fem.l_shape_mesh(8), grid)
    want = jfem.spacetime_loads(problem, jfem.l_shape_mesh(8), jgrid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_flat_formats_refuse_mg():
    problem = get_problem("lshape2d")
    system = fem.P1System.from_mesh(fem.l_shape_mesh(8))
    grid = fem.uniform_time_grid(2)
    # multigrid on the flat formats needs a refinement chain (the nested
    # hierarchy, tests/test_torch_nested.py); smoothed aggregation needs
    # the flat layout (tests/test_torch_amg.py)
    with pytest.raises(ValueError, match="refinement chain"):
        HeatSolver(problem, system, grid, device="cpu", inner="mg")
    with pytest.raises(ValueError, match="flat dof layout"):
        HeatSolver(get_problem("smooth2d"),
                   fem.P1System.from_mesh(fem.unit_square_mesh(8)), grid,
                   device="cpu", inner="amg")
    with pytest.raises(ValueError, match="structured grid"):
        HeatSolver(problem, system, grid, device="cpu",
                   spatial_format="stencil")
