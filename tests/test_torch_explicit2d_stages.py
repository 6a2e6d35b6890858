"""The port's time × space mesh solver on its deeper paths: a deep, uneven
hierarchy (31 planes over two space ranks: two sharded levels, one
padding plane) with V(2,1) cycles, whose sharded levels run the
semi-fused stages (K3 with ``vmask``, K8 and K9 with ``lead``: their twins
on the CPU), against the JAX package's ``Explicit2DHeatSolver`` on the
same (time 2 × space 2) mesh in float64 (identical iterations, residual
histories within rtol 1e-9, U within atol 1e-10); and a hierarchy whose
second sharded level is thinner than the kernels' halo (ν = 9: halo 10, 8
planes per rank), which runs the halo-exchanged PyTorch stencils there,
against the port's serial solver. Four spawned ranks over gloo on the CPU
run both; ``tests/test_torch_explicit2d_3d.py`` holds 3-D.
"""

import numpy as np
import pytest

from spacetime_tpu.fem import P1System, domain_mesh
from spacetime_tpu.fem.timegrid import uniform_time_grid
from spacetime_tpu.models import get_problem
from spacetime_tpu.parallel import Explicit2DHeatSolver, make_spacetime_mesh
from spacetime_tpu_torch.parallel import \
    make_spacetime_mesh as port_spacetime_mesh
from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

CONFIGS = {
    "deep_v21": {"problem": "smooth2d", "space_n": 32, "time_levels": 3,
                 "kw": {"inner": "mg", "space_n": 32, "mg_coarse": 8,
                        "mg_nu_post": 1}},
}
THIN = {"problem": "smooth2d", "space_n": 32, "time_levels": 2,
        "kw": {"inner": "mg", "mg_coarse": 4, "mg_nu": 9}}


@pytest.fixture(scope="module")
def port():
    names = list(CONFIGS) + ["thin"]
    specs = [dict(spec, runs=[("solve", {"tol": 1e-6,
                                         "compute_error": False})])
             for spec in list(CONFIGS.values()) + [THIN]]
    res = spawn_ranks(solve_specs, port_spacetime_mesh(2, 2, "cpu"), "gloo",
                      (specs,))
    return dict(zip(names, res))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_jax_explicit2d(port, name):
    spec = CONFIGS[name]
    problem = get_problem(spec["problem"])
    system = P1System.from_problem(
        problem, domain_mesh(problem.domain, problem.dim, spec["space_n"]))
    ex = Explicit2DHeatSolver(
        problem, system, uniform_time_grid(spec["time_levels"], T=problem.T),
        make_spacetime_mesh(2, 2), **spec["kw"])
    ref = ex.solve(tol=1e-6, compute_error=False)
    info = port[name]["info"]
    assert (info["Rs"], info["sp_depth"]) == (ex.Rs, ex._sp_depth)
    # every sharded level holds the kernels' halo
    assert info["kernel_levels"]["ky"] == [True] * ex._sp_depth + [False] * (
        len(info["kernel_levels"]["ky"]) - ex._sp_depth)
    assert info["sp_depth"] == 2
    r = port[name]["runs"][0]
    assert r["converged"] and r["iterations"] == ref.iterations
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(r["U"], ref.U, atol=1e-10)


def test_thin_level_matches_serial_port(port):
    """A sharded level thinner than the kernels' halo runs the
    halo-exchanged stencils (the JAX package's non-Pallas branch): the
    mesh's float64 solve equals the port's serial one."""
    from spacetime_tpu_torch.solver import build_solver

    info = port["thin"]["info"]
    assert info["sp_depth"] == 2 and info["kw"]["ky"] == 10
    assert info["kernel_levels"]["ky"] == [True, False, False]
    ref = build_solver("smooth2d", 32, 2, device="cpu", **THIN["kw"]).solve(
        tol=1e-6, compute_error=False)
    r = port["thin"]["runs"][0]
    assert r["converged"] and r["iterations"] == ref.iterations
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(r["U"], ref.U, atol=1e-10)
