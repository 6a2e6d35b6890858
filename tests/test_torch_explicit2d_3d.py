"""3-D on the port's time × space mesh: smooth3d on 17³ (its one sharded
level on the fused sharded stages K6/K7 with ``lead`` on the z axis, their
twins on the CPU) against the JAX package's ``Explicit2DHeatSolver`` on the
same (time 2 × space 2) mesh in float64: identical iterations, residual
histories within rtol 1e-9, U within atol 1e-10. Four spawned ranks over
gloo on the CPU.
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

SPEC = {"problem": "smooth3d", "space_n": 16, "time_levels": 2,
        "kw": {"inner": "mg", "space_n": 16, "mg_coarse": 8}}


@pytest.fixture(scope="module")
def port():
    spec = dict(SPEC, runs=[("solve", {"tol": 1e-6, "compute_error": False})])
    (out,) = spawn_ranks(solve_specs, port_spacetime_mesh(2, 2, "cpu"),
                         "gloo", ([spec],))
    return out


def test_3d_matches_jax_explicit2d(port):
    problem = get_problem("smooth3d")
    system = P1System.from_problem(problem, domain_mesh("unit", 3, 16))
    ex = Explicit2DHeatSolver(problem, system, uniform_time_grid(2, T=problem.T),
                              make_spacetime_mesh(2, 2), **SPEC["kw"])
    ref = ex.solve(tol=1e-6, compute_error=False)
    info = port["info"]
    assert (info["Rs"], info["sp_depth"]) == (ex.Rs, ex._sp_depth) == (8, 1)
    assert info["kernel_levels"]["ky"] == [True]
    r = port["runs"][0]
    assert r["converged"] and r["iterations"] == ref.iterations
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(r["U"], ref.U, atol=1e-10)
