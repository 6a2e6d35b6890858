"""The port's time-mesh solver (``parallel.explicit.ExplicitHeatSolver``,
one spawned process per rank over gloo on the CPU) against the JAX
package's ``ExplicitHeatSolver`` on the same mesh (the conftest's virtual
CPU devices), in float64: identical iterations, residual histories within
rtol 1e-9 and U within atol 1e-10 (the bars of ``tests/test_explicit.py``).
The aligned layout (4 ranks: dense and mg inner solves, a warm start, the
mixed-precision refinement); the general layout (graded grids, odd rank
counts) is ``tests/test_torch_explicit_general.py``'s. The layout
conversions of ``convert`` are held to the JAX solvers' own (``_dup_rows``,
``_pad_tests``, ``_device_iterate_flat``, ``_prepare_x0``), and the
unported combinations raise.

The ranks of one mesh run every configuration of this file in one spawn
(``parallel.launch.solve_specs``): starting four processes costs seconds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.fem import P1System, domain_mesh
from spacetime_tpu.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime_tpu.models import get_problem
from spacetime_tpu.parallel import ExplicitHeatSolver, make_time_mesh
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.parallel import Comm
from spacetime_tpu_torch.parallel import make_time_mesh as port_time_mesh
from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

SOLVE = ("solve", {"tol": 1e-6, "compute_error": False})
# name -> (ranks, spec)
CONFIGS = {
    "dense": (4, {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
                  "kw": {"inner": "dense"}}),
    "mg": (4, {"problem": "smooth2d", "space_n": 16, "time_levels": 4,
               "kw": {"inner": "mg", "space_n": 16}}),
}
WARM = {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
        "kw": {"inner": "dense"},
        "runs": [("solve", {"tol": 1e-10, "compute_error": False}),
                 ("solve", {"tol": 1e-3, "compute_error": False}),
                 ("solve", {"tol": 1e-10, "compute_error": False,
                            "x0": "previous"})]}
REFINED = {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
           "dtype": "f32", "kw": {"inner": "mg", "space_n": 8},
           "runs": [("solve_refined", {"tol": 1e-8, "compute_error": False})]}
# the float64 solve the refinement is held to
REF64 = dict(REFINED, dtype="f64",
             runs=[("solve", {"tol": 1e-10, "compute_error": False})])


@pytest.fixture(scope="module")
def port():
    """Every configuration on its mesh of spawned ranks: name -> result."""
    names = list(CONFIGS) + ["warm", "refined", "ref64"]
    specs = [dict(CONFIGS[n][1], runs=[SOLVE]) for n in CONFIGS]
    specs += [WARM, REFINED, REF64]
    res = spawn_ranks(solve_specs, port_time_mesh(4, "cpu"), "gloo",
                      (specs,))
    return dict(zip(names, res))


def _jax(spec, ranks, dtype=jnp.float64):
    problem = get_problem(spec["problem"])
    system = P1System.from_problem(
        problem, domain_mesh(problem.domain, problem.dim, spec["space_n"]))
    extra = spec.get("extra_time_levels", 0)
    grid = (graded_time_grid(spec["time_levels"], extra, T=problem.T)
            if extra else uniform_time_grid(spec["time_levels"], T=problem.T))
    return ExplicitHeatSolver(problem, system, grid, make_time_mesh(ranks),
                              dtype=dtype, **spec["kw"])


def _pair(run, ref):
    assert run["converged"] and run["iterations"] == ref.iterations
    np.testing.assert_allclose(run["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(run["U"], ref.U, atol=1e-10)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_jax_explicit(port, name):
    ranks, spec = CONFIGS[name]
    ex = _jax(spec, ranks)
    ref = ex.solve(tol=1e-6, compute_error=False)
    got = port[name]
    assert got["info"]["aligned"] == ex.aligned
    assert (got["info"]["R"], got["info"]["P"]) == (ex.R, ex.P)
    assert got["info"]["foreign"] == []  # the ranks ran without JAX
    _pair(got["runs"][0], ref)


def test_warm_start(port):
    """A loose solve, then a warm start from its iterate: converges in fewer
    iterations than the cold solve, to the same solution."""
    full, part, resumed = port["warm"]["runs"]
    assert resumed["converged"]
    assert resumed["iterations"] < full["iterations"]
    assert part["iterations"] < full["iterations"]
    np.testing.assert_allclose(resumed["U"], full["U"], rtol=0, atol=1e-9)


def test_solve_refined(port):
    """f32 PCG rounds inside f64 residual legs on the mesh reach 1e-8 and
    the mesh's float64 solution (as ``tests/test_explicit.py``'s
    ``test_general_refined`` holds the JAX solver)."""
    (r,) = port["refined"]["runs"]
    (ref,) = port["ref64"]["runs"]
    assert r["converged"] and r["residuals"][-1] <= 1e-8 * r["residuals"][0]
    assert ref["converged"]
    np.testing.assert_allclose(r["U"], ref["U"], atol=1e-8)


@pytest.mark.parametrize("name", ["dense", "mg"])
def test_layout_round_trips(name):
    """``convert``'s time layout against the JAX solver's: the duplicated
    rows (``_dup_rows`` / ``_prepare_x0``, the padding slots zeroed), the
    padded test rows (``_pad_tests``) and back (``_device_iterate_flat``)."""
    ranks, spec = CONFIGS[name]
    ex = _jax(spec, ranks)
    N, P, R, m = ex.N, ex.P, ex.R, ex.m
    rng = np.random.default_rng(0)
    U = rng.standard_normal((N + 1, m))
    m_trial = None if ex.aligned else ex.glay.m_trial
    D = convert.to_time_layout(U, N, P, R, m_trial)
    np.testing.assert_array_equal(
        D.reshape((-1,) + ex.gs), np.asarray(ex._prepare_x0(U)))
    np.testing.assert_array_equal(convert.to_time_layout(U, N, P, R),
                                  ex._dup_rows(U))
    np.testing.assert_array_equal(convert.from_time_layout(D, N, P, R), U)
    np.testing.assert_array_equal(
        convert.from_time_layout(D, N, P, R),
        np.asarray(ex._device_iterate_flat(jnp.asarray(D))))
    V = rng.standard_normal((N,) + ex.gs)
    np.testing.assert_array_equal(convert.pad_rows(V, ex.Np),
                                  np.asarray(ex._pad_tests(jnp.asarray(V))))
    Dt = convert.to_time_layout(torch.as_tensor(U), N, P, R, m_trial)
    np.testing.assert_array_equal(Dt.numpy(), D)


def _one_rank():
    return Comm(port_time_mesh(1, "cpu"))


def test_fused_pcg_raises():
    from spacetime_tpu_torch.models import get_problem as port_problem
    from spacetime_tpu_torch.fem import P1System as PortSystem
    from spacetime_tpu_torch.fem import domain_mesh as port_mesh
    from spacetime_tpu_torch.fem import uniform_time_grid as port_grid
    from spacetime_tpu_torch.parallel import ExplicitHeatSolver as Port

    problem = port_problem("smooth2d")
    system = PortSystem.from_problem(problem, port_mesh("unit", 2, 8))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        Port(problem, system, port_grid(3), _one_rank(), pcg_variant="fused")


@pytest.mark.parametrize("fmt, problem, kw", [
    ("dia", "smooth2d", {}), ("ell", "smooth2d", {}),
    ("vstencil", "varcoef2d", {}), ("stencil", "smooth2d",
                                    {"inner": "cheb"})])
def test_unported_formats_raise(fmt, problem, kw):
    """The flat and weighted formats (and inner solvers but dense and mg)
    raise ValueError on the time mesh."""
    from spacetime_tpu_torch.fem import P1System as PortSystem
    from spacetime_tpu_torch.fem import domain_mesh as port_mesh
    from spacetime_tpu_torch.fem import uniform_time_grid as port_grid
    from spacetime_tpu_torch.models import get_problem as port_problem
    from spacetime_tpu_torch.parallel import ExplicitHeatSolver as Port

    p = port_problem(problem)
    system = PortSystem.from_problem(p, port_mesh("unit", 2, 8))
    with pytest.raises(ValueError, match="explicit meshes"):
        Port(p, system, port_grid(3), _one_rank(), spatial_format=fmt, **kw)
