"""The port's HeatSolver against the JAX HeatSolver at 33×33×16 (smooth2d,
``inner="mg"``, ``space_n=32``, ``mg_coarse=8``: multigrid levels 32 and 16
over an 8-cell coarse grid) and at 9³×8 and 17³×8 (smooth3d), with host
loads on both sides."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.fem import (P1System, uniform_time_grid, unit_cube_mesh,
                               unit_square_mesh)
from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.solver import HeatSolver
from spacetime_tpu_torch.solver import heateq

REPO = Path(__file__).resolve().parent.parent
KW = dict(inner="mg", space_n=32, mg_coarse=8)


@pytest.fixture(scope="module")
def case():
    system = P1System.from_mesh(unit_square_mesh(32))
    grid = uniform_time_grid(4)
    mk_jax = lambda dtype, **kw: JaxHeatSolver(
        jax_problem("smooth2d"), system, grid, dtype=dtype, rhs="host", **KW, **kw
    )
    mk_port = lambda dtype: HeatSolver(
        get_problem("smooth2d"), system, grid, dtype=dtype, device="cpu", **KW
    )
    return {
        "jax64": mk_jax(jnp.float64),
        "jax32": mk_jax(jnp.float32, pallas_kron=False),
        # f32 with the Pallas B/Bᵀ kernels: its params carry the kron columns
        "jax32k": mk_jax(jnp.float32, pallas_kron=True),
        "port64": mk_port(torch.float64),
        "port32": mk_port(torch.float32),
    }


def _compare_trees(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _compare_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_trees(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        torch.testing.assert_close(got, want, rtol=1e-15, atol=0, msg=path)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_params_from_jax_equal_params_for(case, dtype):
    js = case["jax64" if dtype == "float64" else "jax32k"]
    tdt = getattr(torch, dtype)
    tree = jax.tree_util.tree_map(np.asarray, js.params_for(getattr(jnp, dtype)))
    assert ("kron" in tree) == (dtype == "float32")
    got = params_from_jax(tree, "cpu", tdt)
    _compare_trees(got, case["port64"].params_for(tdt))


def test_operators_match_jax_f64(case):
    js, ps = case["jax64"], case["port64"]
    N, gs = ps.N, ps.gs
    rng = np.random.default_rng(8)
    U = rng.standard_normal((N + 1,) + gs)
    R = rng.standard_normal((N + 1,) + gs)
    tol = 1e-12

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max()
        )

    tU, jU = torch.as_tensor(U), jnp.asarray(U)
    tV, jV = torch.as_tensor(R[:-1]), jnp.asarray(R[:-1])
    close(ps.apply_B(tU), js.apply_B(jU))
    close(ps.apply_BT(tV), js.apply_BT(jV))
    close(ps.apply_KY(tV), js.apply_KY(jV))
    close(ps.apply_stab(tU), js.apply_stab(jU))
    close(ps.apply_trace(tU), js.apply_trace(jU))
    close(ps.apply_S(tU), js.apply_S(jU))
    close(ps.apply_KX(torch.as_tensor(R)), js.apply_KX(jnp.asarray(R)))
    gL, gR, u0 = ps.assemble_rhs_host(torch.float64)
    jgL, jgR, ju0 = js.assemble_rhs_host(jnp.float64)
    # the same host quadrature of sources that agree to rounding
    for got, want in ((gL, jgL), (gR, jgR), (u0, ju0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    close(ps.rhs_device(gL, gR, u0), js.rhs_device(jgL, jgR, ju0))


def test_solve_f64_histories_match_jax(case):
    jr = case["jax64"].solve(tol=1e-8)
    pr = case["port64"].solve(tol=1e-8)
    assert jr.iterations == pr.iterations == 18
    assert pr.converged and jr.converged
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
    np.testing.assert_allclose(pr.precond_residuals, jr.precond_residuals, rtol=1e-10)
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)
    np.testing.assert_allclose(
        pr.U, jr.U, rtol=0, atol=1e-10 * np.abs(jr.U).max()
    )


def test_solve_refined_f32_matches_jax(case, monkeypatch):
    js, ps = case["jax32"], case["port32"]
    rounds_j, rounds_p = [], []

    # record each inner round's PCG iterations on both sides
    js._ir_key = ("while", 60)
    rhs64, resid64, inner = js._build_refined_jits("while", 1e-5, 60)

    def inner_j(r32, p, tol32):
        out = inner(r32, p, tol32)
        rounds_j.append(int(out.iterations))
        return out

    js._ir_jits = (rhs64, resid64, inner_j)
    pcg = heateq.pcg

    def pcg_p(*args, **kwargs):
        out = pcg(*args, **kwargs)
        rounds_p.append(out.iterations)
        return out

    monkeypatch.setattr(heateq, "pcg", pcg_p)
    jr = js.solve_refined(tol=1e-8, legs="f64")
    pr = ps.solve_refined(tol=1e-8)
    assert jr.converged and pr.converged
    assert jr.residuals[-1] <= 1e-8 * jr.residuals[0]
    assert pr.residuals[-1] <= 1e-8 * pr.residuals[0]
    assert len(rounds_p) == len(rounds_j) >= 1
    assert all(abs(a - b) <= 1 for a, b in zip(rounds_p, rounds_j)), (
        rounds_p, rounds_j)
    assert pr.iterations == sum(rounds_p)
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-3)


def test_solve_refined_needs_f64_tensors(case, monkeypatch):
    ps = case["port32"]
    bad = dict(ps.params_for(torch.float64), inv_h=ps.params["inv_h"])
    monkeypatch.setitem(ps._params_cache, torch.float64, bad)
    with pytest.raises(RuntimeError, match="float64"):
        ps.solve_refined()


@pytest.mark.parametrize("n", [8, 16], ids=["9^3x8", "17^3x8"])
def test_solve_3d_f64_histories_match_jax(n):
    """smooth3d, ``inner="mg"`` (the 3-D coarse default: levels down to 4 /
    8 cells): every V-cycle level runs the fused stages' twins (K6/K7)."""
    system = P1System.from_mesh(unit_cube_mesh(n))
    grid = uniform_time_grid(3)
    kw = dict(inner="mg", space_n=n)
    js = JaxHeatSolver(jax_problem("smooth3d"), system, grid,
                       dtype=jnp.float64, rhs="host", **kw)
    ps = HeatSolver(get_problem("smooth3d"), system, grid,
                    dtype=torch.float64, device="cpu", **kw)
    assert ps.msmg.n_coarse == js.msmg.n_coarse == n // 2
    assert all(k.fused_ok for k in ps._kl_ky + ps._kl_kx)
    jr, pr = js.solve(tol=1e-8), ps.solve(tol=1e-8)
    assert jr.converged and pr.converged
    assert pr.iterations == jr.iterations
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
    np.testing.assert_allclose(pr.precond_residuals, jr.precond_residuals,
                               rtol=1e-10)
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)


def test_solve_v21_semi_branch_matches_jax(case):
    """V(2,1) (``mg_nu_post=1``): the port's levels take the semi-fused
    stages, the JAX CPU solver its plain V-cycle; float64, the same count."""
    system, grid = case["port64"].system, case["port64"].grid
    js = JaxHeatSolver(jax_problem("smooth2d"), system, grid,
                       dtype=jnp.float64, rhs="host", mg_nu_post=1, **KW)
    ps = HeatSolver(get_problem("smooth2d"), system, grid, dtype=torch.float64,
                    device="cpu", mg_nu_post=1, **KW)
    assert all(k.semi_ok and not k.fused_ok for k in ps._kl_ky)
    jr, pr = js.solve(tol=1e-8), ps.solve(tol=1e-8)
    assert jr.converged and pr.converged
    assert pr.iterations == jr.iterations
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)


@pytest.mark.parametrize(
    "name, n, J, kw",
    [("smooth3d", 8, 2, dict(mg_nu=4, mg_nu_kx=5)),
     ("smooth2d", 8, 2, dict(mg_nu=9, mg_coarse=4)),
     ("varcoef2d", 8, 2, dict(mg_nu=9, mg_coarse=4))],
    ids=["smooth3d-nu4-kx5", "smooth2d-nu9", "varcoef2d-nu9"])
def test_sweeps_above_the_tiled_nu_match_jax(name, n, J, kw):
    """ν above the tiled sweeps' halo (3 in 3-D, 8 in 2-D), where the card
    chains one-step launches: the JAX package's iterations and histories in
    float64, on the constant and the weighted formats (the weighted 3-D
    case, ν = 4 and 5, is in ``test_torch_varcoef.py``)."""
    jp = jax_problem(name)
    system = P1System.from_problem(
        jp, (unit_cube_mesh if jp.dim == 3 else unit_square_mesh)(n))
    js = JaxHeatSolver(jp, system, uniform_time_grid(J), dtype=jnp.float64,
                       rhs="host", inner="mg", **kw)
    ps = HeatSolver(get_problem(name), system, uniform_time_grid(J),
                    dtype=torch.float64, device="cpu", inner="mg", **kw)
    assert all(not k.fused_ok for k in ps._kl_ky)
    jr, pr = js.solve(tol=1e-8), ps.solve(tol=1e-8)
    assert jr.converged and pr.converged
    assert pr.iterations == jr.iterations
    np.testing.assert_allclose(pr.residuals, jr.residuals, rtol=1e-10)
    np.testing.assert_allclose(pr.l2_error, jr.l2_error, rtol=1e-9)


def test_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "spacetime_tpu_torch.run", "--device", "cpu",
         "--space-n", "32", "--time-levels", "4", "--inner", "mg"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PCG iterations" in out.stdout and "L2" in out.stdout
