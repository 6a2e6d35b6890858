"""The graded time grids of the port against the JAX package: the grid and
its wavelet structure bit for bit, the gather form of the lifting (forward,
adjoint, and both against the dense synthesis), the loads and the L2 error
on a graded grid, ``convert.params_from_jax`` on graded solvers, and the
singular problems' multigrid solves (singular2d 17²×11, singular3d 9³×7)
against the JAX CPU solver: iterations identical and histories to 1e-12 in
float64, iterations within ±1 in float32 (f32 rounding in a different sum
order moves PCG counts by one). The oracle's two graded rows are held in
``tests/test_torch_oracle.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from spacetime_tpu import fem as jfem
from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu.ops.wavelets import build_wavelet_transform as jwavelets
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import wavelets as wav
from spacetime_tpu_torch.solver import build_solver

GRADED = [(2, 2), (3, 3), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch and the host BLAS (many small products; with
    several test workers their thread pools contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _grids(J, extra):
    return (fem.graded_time_grid(J, extra),
            jfem.timegrid.graded_time_grid(J, extra))


@pytest.mark.parametrize("J, extra", GRADED)
def test_graded_grid_and_wavelets_equal_jax(J, extra):
    grid, jgrid = _grids(J, extra)
    assert grid.num_intervals == 2 ** J + extra
    for f in ("t", "level", "parent_left", "parent_right"):
        np.testing.assert_array_equal(getattr(grid, f), getattr(jgrid, f), f)
    tm, jtm = fem.time_matrices(grid), jfem.time_matrices(jgrid)
    np.testing.assert_array_equal(tm["h"], jtm["h"])
    wt, jwt = wav.build_wavelet_transform(grid), jwavelets(jgrid)
    assert not wt.is_uniform and not jwt.is_uniform
    for f in ("root_idx", "root_s", "node_level", "node_omega", "level_shift",
              "perm_by_level", "level_counts"):
        np.testing.assert_array_equal(getattr(wt, f), getattr(jwt, f), f)
    for lev, jlev in zip(wt.levels, jwt.levels, strict=True):
        for f in dataclasses.fields(jlev):
            np.testing.assert_array_equal(getattr(lev, f.name),
                                          getattr(jlev, f.name), f.name)
    np.testing.assert_array_equal(wt.dense(), jwt.dense())
    assert fem.graded_time_grid(J, 0).num_intervals == 2 ** J


@pytest.mark.parametrize("J, extra", GRADED)
def test_gather_wavelets_match_jax(J, extra):
    """The gather form against the JAX package's (``forward_jax`` /
    ``adjoint_jax`` with its gather params) bit for bit, against the dense
    synthesis W and Wᵀ to 1e-13, and the round trip W⁻¹ W = I."""
    grid, jgrid = _grids(J, extra)
    wt, jwt = wav.build_wavelet_transform(grid), jwavelets(jgrid)
    wp = wav.wavelet_params(wt, torch.float64, "cpu")
    jwp = jwt.jax_params(jnp.float64)
    assert "root_idx" in wp and "root_idx" in jwp
    X = np.random.default_rng(J).standard_normal((grid.num_nodes, 3, 5))
    fwd = wav.forward(wt, torch.as_tensor(X), wp).numpy()
    adj = wav.adjoint(wt, torch.as_tensor(X), wp).numpy()
    np.testing.assert_array_equal(fwd, np.asarray(jwt.forward_jax(X, jwp)))
    np.testing.assert_array_equal(adj, np.asarray(jwt.adjoint_jax(X, jwp)))
    Wd = wt.dense()
    flat = X.reshape(grid.num_nodes, -1)
    np.testing.assert_allclose(fwd.reshape(flat.shape), Wd @ flat,
                               rtol=0, atol=1e-13 * np.abs(Wd @ flat).max())
    np.testing.assert_allclose(adj.reshape(flat.shape), Wd.T @ flat,
                               rtol=0, atol=1e-13 * np.abs(Wd.T @ flat).max())
    back = np.linalg.solve(Wd, fwd.reshape(flat.shape))
    np.testing.assert_allclose(back, flat, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name, mesh", [("singular2d", "unit_square_mesh"),
                                        ("singular3d", "unit_cube_mesh")])
def test_singular_loads_and_error_equal_jax(name, mesh):
    """The port's singular problem against the JAX package's (source and
    exact solution to 1e-13: the two autodiffs round differently), and the
    same source through both quadratures on a graded grid bit for bit, as
    the L2 error of one iterate."""
    ref, port = jax_problem(name), get_problem(name)
    assert (port.dim, port.T, port.graded_time) == (ref.dim, ref.T, True)
    rng = np.random.default_rng(7)
    X = rng.uniform(0.0, 1.0, (129, port.dim))
    ts = rng.uniform(1e-3, 1.0, 4)
    tol = dict(rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(port.g_many(ts, X), ref.g_many(ts, X), **tol)
    np.testing.assert_allclose(port.exact_np(0.3, X), ref.exact_np(0.3, X),
                               **tol)
    np.testing.assert_array_equal(port.u0(X), np.zeros(len(X)))
    grid, jgrid = _grids(2, 3)
    m = getattr(fem, mesh)(4)
    got = fem.spacetime_loads(port, m, grid)
    want = jfem.spacetime_loads(port, getattr(jfem, mesh)(4), jgrid)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    U = rng.standard_normal((grid.num_nodes, len(m.interior)))
    assert fem.l2_error_spacetime(port, m, grid, U) == \
        jfem.errors.l2_error_spacetime(port, getattr(jfem, mesh)(4), jgrid, U)


def _jax_solver(name, n, J, extra, dtype, **kw):
    jprob = jax_problem(name)
    system = jfem.P1System.from_problem(
        jprob, jfem.domain_mesh("unit", jprob.dim, n))
    return JaxHeatSolver(jprob, system,
                         jfem.timegrid.graded_time_grid(J, extra),
                         dtype=dtype, rhs="host", **kw)


def _compare(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _compare(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _compare(a, b, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        torch.testing.assert_close(got, want, rtol=1e-15, atol=0, msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("name, n, inner", [("singular2d", 8, "dense"),
                                           ("singular3d", 8, "mg")],
                         ids=["singular2d-dense", "singular3d-mg"])
def test_params_from_jax_graded(name, n, inner):
    """A graded f64 tree (gather-form wavelet leaves, ``perm``,
    ``inv_perm``) in the port's layout equals the port's own params, and
    K_X on the converted params equals the port's."""
    js = _jax_solver(name, n, 2, 3, jnp.float64, inner=inner, space_n=n)
    tree = jax.tree_util.tree_map(np.asarray, js.params_for(jnp.float64))
    assert "perm" in tree and "root_idx" in tree["wavelet"]
    got = params_from_jax(tree, "cpu", torch.float64)
    ps = build_solver(name, n, 2, extra_time_levels=3, dtype=torch.float64,
                      device="cpu", inner=inner)
    want = ps.params_for(torch.float64)
    _compare(got, want)
    R = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (ps.N + 1,) + ps.gs))
    torch.testing.assert_close(ps.apply_KX(R, got), ps.apply_KX(R, want),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def solves():
    """(JAX result, port result, port solver) per (problem, dtype), each
    solved once."""
    cache = {}
    sizes = {"singular2d": (16, 3, 3), "singular3d": (8, 2, 3)}

    def run(name, dt):
        if (name, dt) not in cache:
            n, J, extra = sizes[name]
            jdt, tdt = {"f64": (jnp.float64, torch.float64),
                        "f32": (jnp.float32, torch.float32)}[dt]
            tol = 1e-8 if dt == "f64" else 1e-6
            jr = _jax_solver(name, n, J, extra, jdt, inner="mg",
                             space_n=n).solve(tol=tol)
            ps = build_solver(name, n, J, extra_time_levels=extra, dtype=tdt,
                              device="cpu", inner="mg")
            cache[(name, dt)] = (jr, ps.solve(tol=tol), ps)
        return cache[(name, dt)]

    return run


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", ["singular2d", "singular3d"])
def test_singular_mg_solve_matches_jax(solves, name, dt):
    jr, pr, ps = solves(name, dt)
    assert not ps.wt.is_uniform and ps.inner == "mg"
    # ν = ν_post = 2: the fused stages' twins on every level, 2-D and 3-D
    assert all(k.fused_ok for k in ps._kl_ky + ps._kl_kx)
    assert jr.converged and pr.converged
    if dt == "f64":
        assert pr.iterations == jr.iterations
        np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-12)
        np.testing.assert_allclose(pr.precond_residuals,
                                   jr.precond_residuals, rtol=1e-12)
        np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)
    else:
        assert abs(pr.iterations - jr.iterations) <= 1
        np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-3)


def test_extra_time_levels_in_build_solver_and_cli(capsys):
    """``build_solver`` grades the time grid when extra levels are asked
    for, of any problem, and only then (a problem with ``graded_time`` at
    0 extra levels has the uniform grid, as the graded grid is then),
    refuses a negative count, and ``run.py --extra-levels`` passes it on."""
    from spacetime_tpu_torch import run

    s = build_solver("singular2d", 8, 2, device="cpu")
    assert s.wt.is_uniform and s.N == 4 and "perm" not in s.params
    s = build_solver("smooth2d", 8, 2, extra_time_levels=2, device="cpu")
    assert not s.wt.is_uniform and s.N == 6 and "perm" in s.params
    with pytest.raises(ValueError, match="extra_time_levels"):
        build_solver("smooth2d", 8, 2, extra_time_levels=-1, device="cpu")
    assert run.main(["--device", "cpu", "--problem", "singular2d",
                     "--space-n", "8", "--time-levels", "2",
                     "--extra-levels", "2"]) == 0
    out = capsys.readouterr().out
    assert "timesteps=6" in out and "converged=True" in out
