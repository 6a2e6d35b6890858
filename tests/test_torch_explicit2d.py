"""The port's time × space mesh solver (``parallel.explicit2d``,
``Explicit2DHeatSolver``: four spawned ranks over gloo on the CPU, time 2 ×
space 2) against the JAX package's ``Explicit2DHeatSolver`` on the same
mesh, in float64: identical iterations, residual histories within rtol
1e-9 and U within atol 1e-10 (``tests/test_explicit2d.py``'s ``_pair``).
Dense inner solves (the slabs gathered for the products) and one sharded
multigrid level (15 planes over two space ranks: one padding plane; the
fused sharded stages K6/K7 on it, their twins on the CPU); in float32, the
per-shard kernel path against the JAX solver with ``pallas=True`` and
``mg_pallas_min_points = 1`` (its Pallas kernels in interpret mode; JAX
builds them for float32 only): the same iterations, histories within rtol
1e-3 (``tests/test_explicit2d.py``'s ``_pallas_ab`` bar). A warm start and
the mixed-precision refinement on the mesh; ``convert``'s space layout
against the JAX solver's ``_pad_all`` / ``_prepare_x0``; the unported
combinations raise. ``tests/test_torch_explicit2d_stages.py`` holds the
deep hierarchy with the semi-fused V(2,1) stages and 3-D.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.fem import P1System, domain_mesh
from spacetime_tpu.fem.timegrid import uniform_time_grid
from spacetime_tpu.models import get_problem
from spacetime_tpu.parallel import Explicit2DHeatSolver, make_spacetime_mesh
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.parallel import Comm
from spacetime_tpu_torch.parallel import \
    make_spacetime_mesh as port_spacetime_mesh
from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

SOLVE = ("solve", {"tol": 1e-6, "compute_error": False})
CONFIGS = {
    "dense": {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
              "kw": {"inner": "dense"}},
    "mg": {"problem": "smooth2d", "space_n": 16, "time_levels": 4,
           "kw": {"inner": "mg", "space_n": 16}},
}
PALLAS = {"problem": "smooth2d", "space_n": 16, "time_levels": 3,
          "dtype": "f32", "kw": {"inner": "mg", "space_n": 16},
          "runs": [("solve", {"tol": 1e-5, "compute_error": False})]}
WARM = {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
        "kw": {"inner": "dense"},
        "runs": [("solve", {"tol": 1e-10, "compute_error": False}),
                 ("solve", {"tol": 1e-3, "compute_error": False}),
                 ("solve", {"tol": 1e-10, "compute_error": False,
                            "x0": "previous"})]}
REFINED = {"problem": "smooth2d", "space_n": 8, "time_levels": 3,
           "dtype": "f32", "kw": {"inner": "mg", "space_n": 8},
           "runs": [("solve_refined", {"tol": 1e-8, "compute_error": False})]}
REF64 = dict(REFINED, dtype="f64",
             runs=[("solve", {"tol": 1e-10, "compute_error": False})])


@pytest.fixture(scope="module")
def port():
    names = list(CONFIGS) + ["pallas", "warm", "refined", "ref64"]
    specs = [dict(CONFIGS[n], runs=[SOLVE]) for n in CONFIGS]
    specs += [PALLAS, WARM, REFINED, REF64]
    res = spawn_ranks(solve_specs, port_spacetime_mesh(2, 2, "cpu"), "gloo",
                      (specs,))
    return dict(zip(names, res))


def _jax(spec, pt=2, ps=2, **kw):
    problem = get_problem(spec["problem"])
    system = P1System.from_problem(
        problem, domain_mesh(problem.domain, problem.dim, spec["space_n"]))
    grid = uniform_time_grid(spec["time_levels"], T=problem.T)
    return Explicit2DHeatSolver(problem, system, grid,
                                make_spacetime_mesh(pt, ps),
                                **{**spec["kw"], **kw})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_jax_explicit2d(port, name):
    ex = _jax(CONFIGS[name])
    ref = ex.solve(tol=1e-6, compute_error=False)
    got = port[name]
    info = got["info"]
    assert (info["Rs"], info["sp_depth"]) == (ex.Rs, ex._sp_depth)
    assert info["foreign"] == []
    if name == "mg":
        assert info["sp_depth"] == 1 and info["kernel_levels"]["ky"] == [True]
    r = got["runs"][0]
    assert r["converged"] and r["iterations"] == ref.iterations
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(r["U"], ref.U, atol=1e-10)


def test_matches_jax_pallas_path(port):
    """float32: the port's sharded kernel forms (their twins here) against
    the JAX solver's per-shard Pallas kernels in interpret mode, the halo
    kw = ν + 1 of both."""
    ex = _jax(PALLAS, dtype=jnp.float32, pallas=True)
    ex.mg_pallas_min_points = 1
    ref = ex.solve(tol=1e-5, compute_error=False)
    pj = ex._e_pl2_for(jnp.float32, "ky")[0]
    assert pj is not None and pj.sh_fused_ready(ex.Rs, ex._sp_kw["ky"])
    got = port["pallas"]
    assert got["info"]["kw"]["ky"] == ex._sp_kw["ky"]
    r = got["runs"][0]
    assert r["converged"] and r["iterations"] == ref.iterations
    k = ref.iterations + 1
    np.testing.assert_allclose(r["residuals"][:k], ref.residuals[:k],
                               rtol=1e-3)


def test_warm_start(port):
    full, part, resumed = port["warm"]["runs"]
    assert resumed["converged"]
    assert resumed["iterations"] < full["iterations"]
    np.testing.assert_allclose(resumed["U"], full["U"], rtol=0, atol=1e-9)


def test_solve_refined(port):
    """The refinement over the (2 × 2) mesh reaches 1e-8 and the mesh's
    float64 solution (``tests/test_explicit2d.py``'s ``test_refined``)."""
    (r,) = port["refined"]["runs"]
    (ref,) = port["ref64"]["runs"]
    assert r["converged"] and r["residuals"][-1] <= 1e-8 * r["residuals"][0]
    np.testing.assert_allclose(r["U"], ref["U"], atol=1e-8)


@pytest.mark.parametrize("name", ["dense", "mg"])
def test_space_layout(name):
    """``convert``'s padded slabs against the JAX solver's: ``_pad_all`` of
    the test rows, ``_prepare_x0`` of a trial iterate (time layout, then the
    plane padding), and the slabs of each space rank."""
    ex = _jax(CONFIGS[name])
    N, P, R, gs = ex.N, ex.P, ex.R, ex.gs
    rng = np.random.default_rng(1)
    V = rng.standard_normal((N,) + gs)
    want = np.asarray(ex._pad_all(jnp.asarray(V)))
    got = convert.pad_planes(convert.pad_rows(V, ex.Np), ex.Ps, ex.Rs)
    np.testing.assert_array_equal(got, want)
    U = rng.standard_normal((N + 1, ex.m))
    D = convert.to_time_layout(U, N, P, R).reshape((-1,) + gs)
    Dp = convert.pad_planes(D, ex.Ps, ex.Rs)
    np.testing.assert_array_equal(Dp, np.asarray(ex._prepare_x0(U)))
    back = np.concatenate(
        [convert.slab(Dp, ds, ex.Rs) for ds in range(ex.Ps)], axis=1)
    np.testing.assert_array_equal(back, Dp)
    flat = np.asarray(ex._device_iterate_flat(jnp.asarray(Dp)))
    np.testing.assert_array_equal(flat, U)
    Dt = convert.pad_planes(torch.as_tensor(D), ex.Ps, ex.Rs)
    np.testing.assert_array_equal(Dt.numpy(), Dp)


@pytest.mark.parametrize("kw, match", [
    ({"spatial_format": "dia"}, "explicit meshes"),
    ({"spatial_format": "ell"}, "explicit meshes"),
    ({"inner": "cheb"}, "dense' or 'mg"),
])
def test_unported_raise(kw, match):
    """The flat formats and inner solvers but dense and mg raise
    ValueError, as the JAX package's 2-D mesh does."""
    from spacetime_tpu_torch.fem import P1System as PortSystem
    from spacetime_tpu_torch.fem import domain_mesh as port_mesh
    from spacetime_tpu_torch.fem import uniform_time_grid as port_grid
    from spacetime_tpu_torch.models import get_problem as port_problem
    from spacetime_tpu_torch.parallel import Explicit2DHeatSolver as Port

    p = port_problem("smooth2d")
    system = PortSystem.from_problem(p, port_mesh("unit", 2, 8))
    comm = Comm(port_spacetime_mesh(1, 1, "cpu"))
    with pytest.raises(ValueError, match=match):
        Port(p, system, port_grid(3), comm, **kw)


def test_weighted_raises():
    from spacetime_tpu_torch.fem import P1System as PortSystem
    from spacetime_tpu_torch.fem import domain_mesh as port_mesh
    from spacetime_tpu_torch.fem import uniform_time_grid as port_grid
    from spacetime_tpu_torch.models import get_problem as port_problem
    from spacetime_tpu_torch.parallel import Explicit2DHeatSolver as Port

    p = port_problem("varcoef2d")
    system = PortSystem.from_problem(p, port_mesh("unit", 2, 8))
    comm = Comm(port_spacetime_mesh(1, 1, "cpu"))
    with pytest.raises(ValueError, match="vstencil"):
        Port(p, system, port_grid(3), comm)
