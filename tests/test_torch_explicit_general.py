"""The general time layout of the port's time-mesh solver
(``parallel.general_layout``: graded grids, odd rank counts, N_t not
divisible by P) against the JAX package's ``ExplicitHeatSolver`` on the
same 3-device mesh, in float64 (identical iterations, residual histories
within rtol 1e-9, U within atol 1e-10): singular2d on a graded grid (J3+3)
with dense inner solves, smooth2d with N_t = 8 over 3 ranks, and the graded
grid with multigrid inner solves; one spawn of three CPU ranks over gloo
runs all three. The host layout is the JAX package's, array for array, and
``convert``'s time layout zeroes its padding slots as the JAX solver's
``_prepare_x0`` does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime_tpu.fem import P1System, domain_mesh
from spacetime_tpu.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime_tpu.models import get_problem
from spacetime_tpu.ops.wavelets import build_wavelet_transform
from spacetime_tpu.parallel import ExplicitHeatSolver, make_time_mesh
from spacetime_tpu.parallel.general_layout import build_general_layout
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.fem import graded_time_grid as port_graded
from spacetime_tpu_torch.ops import wavelets as port_wavelets
from spacetime_tpu_torch.parallel import make_time_mesh as port_time_mesh
from spacetime_tpu_torch.parallel.general_layout import \
    build_general_layout as port_layout
from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

CONFIGS = {
    "graded": {"problem": "singular2d", "space_n": 8, "time_levels": 3,
               "extra_time_levels": 3, "kw": {"inner": "dense"}},
    "ragged": {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
               "kw": {"inner": "dense"}},
    "graded_mg": {"problem": "singular2d", "space_n": 16, "time_levels": 3,
                  "extra_time_levels": 2, "kw": {"inner": "mg",
                                                 "space_n": 16}},
}


@pytest.fixture(scope="module")
def port():
    specs = [dict(spec, runs=[("solve", {"tol": 1e-6,
                                         "compute_error": False})])
             for spec in CONFIGS.values()]
    res = spawn_ranks(solve_specs, port_time_mesh(3, "cpu"), "gloo",
                      (specs,))
    return dict(zip(CONFIGS, res))


def _jax(spec):
    problem = get_problem(spec["problem"])
    system = P1System.from_problem(
        problem, domain_mesh(problem.domain, problem.dim, spec["space_n"]))
    extra = spec.get("extra_time_levels", 0)
    grid = (graded_time_grid(spec["time_levels"], extra, T=problem.T)
            if extra else uniform_time_grid(spec["time_levels"], T=problem.T))
    return ExplicitHeatSolver(problem, system, grid, make_time_mesh(3),
                              **spec["kw"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_jax_explicit(port, name):
    ex = _jax(CONFIGS[name])
    ref = ex.solve(tol=1e-6, compute_error=False)
    got = port[name]
    assert not ex.aligned and not got["info"]["aligned"]
    assert (got["info"]["R"], got["info"]["Np"]) == (ex.R, ex.Np)
    assert got["info"]["foreign"] == []
    r = got["runs"][0]
    assert r["converged"] and r["iterations"] == ref.iterations
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(r["U"], ref.U, atol=1e-10)


@pytest.mark.parametrize("P", [3, 5])
def test_host_layout_matches_jax(P):
    """``build_general_layout`` of the port's wavelet structure equals the
    JAX package's, field for field, on a graded grid."""
    want = build_general_layout(
        build_wavelet_transform(graded_time_grid(3, 3)), P)
    got = port_layout(port_wavelets.build_wavelet_transform(
        port_graded(3, 3)), P)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "levels":
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                for g in dataclasses.fields(la):
                    np.testing.assert_array_equal(getattr(lb, g.name),
                                                  getattr(la, g.name))
        elif f.name == "kx_lvl":
            for xa, xb in zip(a, b):
                np.testing.assert_array_equal(xb, xa)
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["graded", "ragged"])
def test_layout_round_trips(name):
    ex = _jax(CONFIGS[name])
    N, P, R, m = ex.N, ex.P, ex.R, ex.m
    U = np.random.default_rng(2).standard_normal((N + 1, m))
    D = convert.to_time_layout(U, N, P, R, ex.glay.m_trial)
    np.testing.assert_array_equal(D.reshape((-1,) + ex.gs),
                                  np.asarray(ex._prepare_x0(U)))
    np.testing.assert_array_equal(convert.from_time_layout(D, N, P, R), U)
    np.testing.assert_array_equal(
        convert.from_time_layout(D, N, P, R),
        np.asarray(ex._device_iterate_flat(jnp.asarray(D))))
