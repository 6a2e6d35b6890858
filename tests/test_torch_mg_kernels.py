"""The multigrid kernels' plain twins (``ops.mg_kernels``, K3–K9) against the
JAX package's Pallas kernels (``MSPallasLevel``, interpret mode), the port's
V-cycle with kernel levels against the JAX V-cycle with Pallas levels (fused
and semi-fused branches, 2-D and 3-D), and the conversion of the JAX
levels' columns. Inputs are made with numpy from a seed; the wrappers are
called on CPU tensors, so they dispatch to the twins.

Tolerances, relative to max|JAX|: 1e-12 in float64; in float32 1e-4 for r_c
and the ``fused_post`` output, whose JAX transfers split f32 data into bf16
hi + lo parts on the matrix unit (~2⁻¹⁶ relative, ``_dot_last``), 2e-5 for
the semi-fused transfer stages K8/K9 (the same split, one transfer each),
and 1e-5 for the rest (f32 sum order).
"""

import dataclasses
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.fem import P1System, uniform_time_grid, unit_square_mesh
from spacetime_tpu.models import get_problem as jax_problem
from spacetime_tpu.ops.mg_pallas import MSPallasLevel
from spacetime_tpu.ops.multigrid import MultiShiftMultigrid
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch.convert import params_from_jax
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import mg_kernels
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops.mg_kernels import MSKernelLevel
from spacetime_tpu_torch.solver import HeatSolver

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
TOL = {"f64": 1e-12, "f32": 1e-5}
TOL_TRANSFER = {"f64": 1e-12, "f32": 1e-4}
TOL_SEMI = {"f64": 1e-12, "f32": 2e-5}


@pytest.fixture(scope="module")
def hierarchy():
    """Levels 32 and 16 over an 8-cell coarse grid."""
    return MultiShiftMultigrid.build(2, 32, nu=2, n_coarse=8)


def _close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.fixture(scope="module")
def level_cases(hierarchy):
    """(JAX results, port results) per (dtype, grid, T, ν), computed once."""
    msmg, _ = hierarchy
    lev = msmg.levels[0]
    cache = {}

    def run(dt, gs, T, nu):
        key = (dt, gs, T, nu)
        if key in cache:
            return cache[key]
        jdt, tdt = DTYPES[dt]
        rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
        omega = np.abs(rng.standard_normal(T)) * 20
        x, b = (rng.standard_normal((T,) + gs) for _ in range(2))
        ec = rng.standard_normal((T,) + tuple((n - 1) // 2 for n in gs))
        J = lambda a: jnp.asarray(a, jdt)
        P = lambda a: torch.as_tensor(a, dtype=tdt)

        stencils = {k: dataclasses.replace(st, grid_shape=gs)
                    for k, st in (("A", lev.A_st), ("M", lev.M_st))}
        pj = MSPallasLevel(stencils["A"], stencils["M"], T, jdt, nu,
                           interpret=True)
        assert pj.fused_ok
        jc, tx = MSPallasLevel.columns(lev, omega, jdt), pj.transfers(jdt)
        jx, jrc = pj.fused_pre(J(b), jc, tx)
        want = {
            "smooth": pj.smooth(J(x), J(b), jc),
            "smooth_zero": pj.smooth(None, J(b), jc, zero_init=True),
            "residual": pj.residual(J(x), J(b), jc),
            "apply_A": pj.apply_A(J(x)),
            "fused_pre_x": jx,
            "fused_pre_rc": jrc,
            "fused_post": pj.fused_post(J(x), J(b), J(ec), jc, tx),
        }

        kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
        tc = MSKernelLevel.columns(mg.row_params(msmg, omega, tdt, "cpu")[0])
        px, prc = kl.fused_pre(P(b), tc)
        got = {
            "smooth": kl.smooth(P(x), P(b), tc),
            "smooth_zero": kl.smooth(None, P(b), tc, zero_init=True),
            "residual": kl.residual(P(x), P(b), tc),
            "apply_A": kl.apply_A(P(x)),
            "fused_pre_x": px,
            "fused_pre_rc": prc,
            "fused_post": kl.fused_post(P(x), P(b), P(ec), tc),
        }
        cache[key] = (want, got)
        return cache[key]

    return run


@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("gs", [(31, 31), (15, 31)], ids=["31x31", "15x31"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("op", ["smooth", "smooth_zero", "residual", "apply_A",
                                "fused_pre_x", "fused_pre_rc", "fused_post"])
def test_twin_matches_pallas(level_cases, op, dt, gs, T, nu):
    want, got = level_cases(dt, gs, T, nu)
    assert got[op].dtype == DTYPES[dt][1]
    assert tuple(got[op].shape) == tuple(np.asarray(want[op]).shape)
    transfer = op in ("fused_pre_rc", "fused_post")
    _close(got[op], want[op], (TOL_TRANSFER if transfer else TOL)[dt])


@pytest.fixture(scope="module")
def hierarchy3d():
    """Levels 16 and 8 over a 4-cell coarse grid: grids 15³ and 7³."""
    return MultiShiftMultigrid.build(3, 16, nu=2, n_coarse=4)


@pytest.fixture(scope="module")
def semi_cases(hierarchy, hierarchy3d):
    """(JAX results, port results) of the kernels K3–K5, K8 and K9 per
    (dtype, grid, ν), T = 3, computed once."""
    cache = {}

    def run(dt, gs, nu):
        key = (dt, gs, nu)
        if key in cache:
            return cache[key]
        msmg = (hierarchy if len(gs) == 2 else hierarchy3d)[0]
        lev = msmg.levels[-1]
        jdt, tdt = DTYPES[dt]
        T = 3
        rng = np.random.default_rng(zlib.crc32(repr(("semi",) + key).encode()))
        omega = np.abs(rng.standard_normal(T)) * 20
        x, b = (rng.standard_normal((T,) + gs) for _ in range(2))
        ec = rng.standard_normal((T,) + tuple((n - 1) // 2 for n in gs))
        J = lambda a: jnp.asarray(a, jdt)
        P = lambda a: torch.as_tensor(a, dtype=tdt)
        stencils = {k: dataclasses.replace(st, grid_shape=gs)
                    for k, st in (("A", lev.A_st), ("M", lev.M_st))}
        pj = MSPallasLevel(stencils["A"], stencils["M"], T, jdt, nu,
                           interpret=True)
        assert pj.semi_ok
        jc, tx = MSPallasLevel.columns(lev, omega, jdt), pj.transfers(jdt)
        want = {
            "smooth": pj.smooth(J(x), J(b), jc),
            "smooth_zero": pj.smooth(None, J(b), jc, zero_init=True),
            "residual": pj.residual(J(x), J(b), jc),
            "apply_A": pj.apply_A(J(x)),
            "residual_restrict": pj.residual_restrict(J(x), J(b), jc, tx),
            "prolong_correct": pj.prolong_correct(J(x), J(ec), tx),
        }
        kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
        assert kl.semi_ok and kl.fused_ok
        tc = MSKernelLevel.columns(mg.row_params(msmg, omega, tdt, "cpu")[-1])
        got = {
            "smooth": kl.smooth(P(x), P(b), tc),
            "smooth_zero": kl.smooth(None, P(b), tc, zero_init=True),
            "residual": kl.residual(P(x), P(b), tc),
            "apply_A": kl.apply_A(P(x)),
            "residual_restrict": kl.residual_restrict(P(x), P(b), tc),
            "prolong_correct": kl.prolong_correct(P(x), P(ec)),
        }
        cache[key] = (want, got)
        return cache[key]

    return run


@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("op", ["smooth", "smooth_zero", "residual", "apply_A",
                                "residual_restrict", "prolong_correct"])
def test_twin_matches_pallas_3d(semi_cases, op, dt, nu):
    want, got = semi_cases(dt, (7, 7, 7), nu)
    assert got[op].dtype == DTYPES[dt][1]
    assert tuple(got[op].shape) == tuple(np.asarray(want[op]).shape)
    semi = op in ("residual_restrict", "prolong_correct")
    _close(got[op], want[op], (TOL_SEMI if semi else TOL)[dt])


@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("gs", [(15, 15), (15, 31)], ids=["15x15", "15x31"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("op", ["residual_restrict", "prolong_correct"])
def test_transfer_twins_match_pallas_2d(semi_cases, op, dt, gs, nu):
    want, got = semi_cases(dt, gs, nu)
    assert tuple(got[op].shape) == tuple(np.asarray(want[op]).shape)
    _close(got[op], want[op], TOL_SEMI[dt])


class _SemiOnly(MSPallasLevel):
    """A JAX level whose V-cycle takes the semi-fused branch."""

    fused_ok = False


class _SemiKernels(MSKernelLevel):
    """A kernel level held to the semi-fused branch where ``fused_ok``
    would hold (ν = ν_post ∈ {2, 3}, 2-D and 3-D alike)."""

    fused_ok = False


def _semi_vcycle_pair(msmg, A_c, M_c, nu_post, cycles):
    """The JAX V-cycle with semi-fused interpret-mode Pallas levels and the
    port's with kernel levels, float64, from one seeded right-hand side."""
    msmg = dataclasses.replace(msmg, nu_post=nu_post)
    T = 3
    rng = np.random.default_rng(13)
    omega = np.abs(rng.standard_normal(T)) * 10
    gs = tuple(msmg.levels[0].A_st.grid_shape)
    b = rng.standard_normal((T,) + gs)
    cinv = np.linalg.inv(A_c + omega.mean() * M_c)

    lps_j = msmg.row_params(omega, jnp.float64)
    pallas = [_SemiOnly(lev.A_st, lev.M_st, T, jnp.float64, msmg.nu,
                        interpret=True, nu_post=nu_post)
              for lev in msmg.levels]
    for pj, lp, lev in zip(pallas, lps_j, msmg.levels):
        lp["cols"] = MSPallasLevel.columns(lev, omega, jnp.float64)
        lp["tx"] = pj.transfers(jnp.float64)
    cj = jnp.asarray(cinv)
    want = msmg.solve(
        jnp.asarray(b), lps_j,
        lambda bc: jnp.dot(bc.reshape(T, -1), cj).reshape(bc.shape),
        cycles, pallas=pallas,
    )
    lps_t = mg.row_params(msmg, omega, torch.float64, "cpu")
    for lp in lps_t:
        lp["cols"] = MSKernelLevel.columns(lp)
    kernels = [_SemiKernels(lev.A_st, lev.M_st, msmg.nu, nu_post=nu_post)
               for lev in msmg.levels]
    ct = torch.as_tensor(cinv)
    got = mg.MultiShiftMG(msmg).solve(
        torch.as_tensor(b), lps_t,
        lambda bc: (bc.reshape(T, -1) @ ct).reshape(bc.shape),
        cycles, kernels=kernels,
    )
    return want, got, kernels


@pytest.mark.parametrize("nu_post", [None, 1])
def test_semi_vcycle_3d_matches_jax_pallas_f64(hierarchy3d, nu_post):
    """3-D: every level runs K3 → K8 → ... → K9 → K3 on both sides (held
    to that branch at V(2,2), where both would take the fused stages;
    tests/test_torch_fused3d.py holds those)."""
    msmg, (A_c, M_c) = hierarchy3d
    want, got, kernels = _semi_vcycle_pair(msmg, A_c, M_c, nu_post, 2)
    assert all(k.semi_ok and not k.fused_ok for k in kernels)
    _close(got, want, 1e-12)


def test_semi_vcycle_2d_nu_post_matches_jax_pallas_f64(hierarchy):
    """2-D V(2,1): the semi-fused stages on both sides."""
    msmg, (A_c, M_c) = hierarchy
    want, got, kernels = _semi_vcycle_pair(msmg, A_c, M_c, 1, 2)
    assert all(k.semi_ok and not k.fused_ok for k in kernels)
    _close(got, want, 1e-12)


def _vcycle_pair(hierarchy, nu_post, cycles):
    """The JAX and the port solve with per-level kernels, float64."""
    msmg, (A_c, M_c) = hierarchy
    msmg = dataclasses.replace(msmg, nu_post=nu_post)
    T = 5
    rng = np.random.default_rng(11)
    omega = np.abs(rng.standard_normal(T)) * 10
    b = rng.standard_normal((T, 31, 31))
    cinv = np.linalg.inv(A_c + omega.mean() * M_c)

    lps_j = msmg.row_params(omega, jnp.float64)
    pallas = [MSPallasLevel(lev.A_st, lev.M_st, T, jnp.float64, msmg.nu,
                            interpret=True, nu_post=nu_post)
              for lev in msmg.levels]
    for pj, lp, lev in zip(pallas, lps_j, msmg.levels):
        lp["cols"] = MSPallasLevel.columns(lev, omega, jnp.float64)
        if pj.fused_ok:  # no "tx" otherwise: the JAX V-cycle then runs K3 + K4
            lp["tx"] = pj.transfers(jnp.float64)
    cj = jnp.asarray(cinv)
    want = msmg.solve(
        jnp.asarray(b), lps_j,
        lambda bc: jnp.dot(bc.reshape(T, -1), cj).reshape(bc.shape),
        cycles, pallas=pallas,
    )

    lps_t = mg.row_params(msmg, omega, torch.float64, "cpu")
    for lp in lps_t:
        lp["cols"] = MSKernelLevel.columns(lp)
    kernels = [MSKernelLevel(lev.A_st, lev.M_st, msmg.nu, nu_post=nu_post)
               for lev in msmg.levels]
    ct = torch.as_tensor(cinv)
    ms = mg.MultiShiftMG(msmg)
    got = ms.solve(
        torch.as_tensor(b), lps_t,
        lambda bc: (bc.reshape(T, -1) @ ct).reshape(bc.shape),
        cycles, kernels=kernels,
    )
    return want, got, kernels


@pytest.mark.parametrize("cycles", [1, 2])
def test_vcycle_with_levels_matches_jax_pallas_f64(hierarchy, cycles):
    want, got, kernels = _vcycle_pair(hierarchy, None, cycles)
    assert all(k.fused_ok for k in kernels)
    _close(got, want, 1e-12)


def test_nu_post_branch_matches_jax_pallas_f64(hierarchy):
    """V(2,1): the JAX side, given no transfer matrices, runs its sweep and
    residual kernels around separate XLA transfers; the port's levels run
    the semi-fused stages. Both compute the same cycle."""
    want, got, kernels = _vcycle_pair(hierarchy, 1, 2)
    assert all(k.semi_ok and not k.fused_ok for k in kernels)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("nu_post", [None, 1])
def test_vcycle_refuses_even_extents(hierarchy, hierarchy3d, nu_post):
    """A kernel level with an even extent takes neither the fused nor the
    semi-fused stages; the V-cycle raises rather than run anything else, in
    2-D and 3-D alike, and the solver refuses such a hierarchy up front."""
    from spacetime_tpu_torch.solver import build_solver

    for (msmg, _), gs in ((hierarchy, (30, 31)), (hierarchy3d, (8, 7, 7))):
        lev = msmg.levels[0]
        lps = mg.row_params(msmg, np.ones(3), torch.float64, "cpu")
        for lp in lps:
            lp["cols"] = MSKernelLevel.columns(lp)
        kl = MSKernelLevel(lev.A_st, lev.M_st, 2, nu_post=nu_post, gs=gs)
        assert not kl.fused_ok and not kl.semi_ok
        b = torch.zeros((3,) + gs, dtype=torch.float64)
        with pytest.raises(ValueError, match="odd extents"):
            mg.MultiShiftMG(msmg).vcycle(b, lps, lambda bc: bc, kernels=[kl])
    with pytest.raises(ValueError, match=r"levels \[25\]"):
        build_solver("smooth2d", 25, 2, device="cpu", inner="mg",
                     mg_nu_post=nu_post)


def test_levels_dispatch_by_device(hierarchy):
    msmg, _ = hierarchy
    lev = msmg.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, 2)
    cols = MSKernelLevel.columns(
        mg.row_params(msmg, np.ones(3), torch.float32, "cpu")[0])
    meta = torch.empty((3, 31, 31), device="meta")
    with pytest.raises(ValueError, match="no mg kernel for device meta"):
        kl.residual(meta, meta, cols)
    with pytest.raises(ValueError, match="no mg kernel for device meta"):
        kl.apply_A(meta)
    kl3 = MSKernelLevel(lev.A_st, lev.M_st, 2, gs=(7, 7, 7))
    assert kl3.semi_ok and kl3.fused_ok
    assert not MSKernelLevel(lev.A_st, lev.M_st, 2, nu_post=1,
                             gs=(7, 7, 7)).fused_ok
    cols3 = MSKernelLevel.columns(
        mg.row_params(msmg, np.ones(3), torch.float64, "cpu")[0])
    meta3 = torch.empty((3, 7, 7, 7), device="meta")
    for call in (lambda: kl3.fused_pre(meta3, cols3),
                 lambda: kl3.fused_post(meta3, meta3, meta3[:, :3, :3, :3],
                                        cols3),
                 lambda: kl3.residual_restrict(meta3, meta3, cols3),
                 lambda: kl3.prolong_correct(meta3, meta3[:, :3, :3, :3])):
        with pytest.raises(ValueError, match="no mg kernel for device meta"):
            call()
    assert not MSKernelLevel(lev.A_st, lev.M_st, 4).fused_ok
    assert not MSKernelLevel(lev.A_st, lev.M_st, 2, nu_post=1).fused_ok
    assert not MSKernelLevel(lev.A_st, lev.M_st, 2, gs=(8, 7)).semi_ok
    names = {(3, "mg_smooth"), (4, "mg_residual"), (5, "mg_apply"),
             (6, "mg_fused_pre"), (7, "mg_fused_post"),
             (8, "mg_residual_restrict"), (9, "mg_prolong_correct"),
             (10, "mg_smooth_var"), (11, "mg_residual_var"),
             (12, "mg_apply_var"), (13, "mg_residual_restrict_var"),
             (14, "mg_fused_pre_var"), (15, "mg_fused_post_var"),
             (3, "mg_cheb_step"),
             (3, "mg_sh_smooth"), (6, "mg_sh_fused_pre"),
             (7, "mg_sh_fused_post"), (8, "mg_sh_residual_restrict"),
             (9, "mg_sh_prolong_correct")}
    assert set(mg_kernels.launch_counts()) == {
        f"K{i} {name}{d} {sfx}" for i, name in names for d in ("", "_3d")
        for sfx in ("f32", "f64")
    }


def test_convert_carries_columns():
    """A JAX solver whose Pallas levels cover every level (its size gate
    lowered) carries ``cols``; the conversion gives the port's params."""
    system = P1System.from_mesh(unit_square_mesh(16))
    grid = uniform_time_grid(3)
    kw = dict(inner="mg", space_n=16, mg_coarse=4)
    js = JaxHeatSolver(jax_problem("smooth2d"), system, grid, dtype=jnp.float32,
                       rhs="host", pallas_kron=True, **kw)
    js.mg_pallas_min_points = 0
    js._params_cache.clear()
    tree = jax.tree_util.tree_map(np.asarray, js.params_for(jnp.float32))
    for name in ("ms_ky", "ms_kx"):
        assert all("cols" in lp for lp in tree[name]), name
    got = params_from_jax(tree, "cpu", torch.float32)
    ps = HeatSolver(get_problem("smooth2d"), system, grid, dtype=torch.float32,
                    device="cpu", **kw)
    want = ps.params_for(torch.float32)
    for name in ("ms_ky", "ms_kx"):
        assert len(got[name]) == len(want[name]) == 2
        for g, w, lp in zip(got[name], want[name], tree[name]):
            for k in ("omega", "invD", "invT", "invDel"):
                assert w["cols"][k].shape == (lp["cols"][k].shape[0],)
                np.testing.assert_array_equal(
                    g["cols"][k].numpy(), lp["cols"][k][:, 0, 0])
                torch.testing.assert_close(g["cols"][k], w["cols"][k],
                                           rtol=0, atol=0)


def test_cli_nu_post_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "spacetime_tpu_torch.run", "--device", "cpu",
         "--space-n", "32", "--time-levels", "4", "--inner", "mg",
         "--mg-nu-post", "1", "--mg-nu-kx", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PCG iterations" in out.stdout and "converged=True" in out.stdout


def test_cpu_solver_runs_twins_without_launch():
    """A CPU solver's V-cycles and K_X stencil go through the kernel levels'
    twins: the same arithmetic as the plain V-cycle, and no launch."""
    from spacetime_tpu_torch.solver import build_solver

    ps = build_solver("smooth2d", 16, 3, device="cpu", inner="mg", mg_coarse=4)
    assert len(ps._kl_ky) == len(ps.msmg.levels) == 2
    V = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (ps.N,) + ps.gs))
    mg_kernels.reset_launch_counts()
    got = ps.apply_KY(V)
    p = ps.params
    coarse = lambda bc: (bc.reshape(bc.shape[0], -1)
                         @ p["mg_cinv_ky"]).reshape(bc.shape)
    want = ps._mg_ky.solve(V, p["ms_ky"], coarse, ps.mg_cycles) * p["inv_h"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ps.apply_KX(torch.cat([V, V[:1]]))
    assert all(n == 0 for n in mg_kernels.launch_counts().values())
