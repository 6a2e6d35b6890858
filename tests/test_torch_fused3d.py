"""The 3-D fused V-cycle stages of the port against the JAX package: the
plain twins of K6/K7 (``MSKernelLevel.fused_pre`` / ``fused_post``) and of
K14/K15 (``VarMSKernelLevel``) on 3-D grids against the Pallas kernels of
``MSPallasLevel`` / ``VarMSPallasLevel`` in interpret mode, and the port's
3-D V-cycle with kernel levels on the fused branch against the JAX V-cycle
with fused Pallas levels. Inputs are made with numpy from a seed; CPU
tensors run the twins.

Tolerances, relative to max|JAX|, those of ``tests/test_torch_mg_kernels.py``:
1e-12 in float64 (``TOL``); in float32 1e-5 for x (f32 sum order, ``TOL``)
and 1e-4 for r_c and the ``fused_post`` output, whose Pallas transfers split
f32 data into bf16 hi + lo parts on the matrix unit (``TOL_TRANSFER``).
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetime_tpu.fem as jfem
from spacetime_tpu.ops import multigrid as jmg
from spacetime_tpu.ops.mg_pallas import MSPallasLevel, VarMSPallasLevel
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops.mg_kernels import MSKernelLevel, VarMSKernelLevel

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
TOL = {"f64": 1e-12, "f32": 1e-5}
TOL_TRANSFER = {"f64": 1e-12, "f32": 1e-4}
# the coefficients of tests/test_mg_pallas_var.py, as numpy callables
KAPPA = lambda X: 1.0 + X[:, 0] + 0.5 * np.sin(np.pi * X[:, 1])
REACT = lambda X: 1.0 + X[:, -1]
GRIDS = {"7^3": (7, 7, 7), "7x9x15": (7, 9, 15)}


def _close(got, want, rel):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.fixture(scope="module")
def hier():
    """The constant 3-D hierarchy (levels 15³, 7³ over a 4-cell coarse
    grid), and the JAX and the port's Galerkin hierarchies of one weighted
    CSR at the same sizes."""
    const = jmg.MultiShiftMultigrid.build(3, 16, nu=2, n_coarse=4)
    system = jfem.P1System.from_mesh(jfem.unit_cube_mesh(16), kappa=KAPPA,
                                     reaction=REACT)
    var = tuple(m.GalerkinMultiShiftMultigrid.build(
        3, 16, system.A, system.M, nu=2, n_coarse=4) for m in (jmg, mg))
    return const, var


@pytest.fixture(scope="module")
def cases(hier):
    """(JAX results, port results) of the fused pre- and post-stages per
    (kind, dtype, grid, ν), T = 3, computed once."""
    cache = {}

    def run(kind, dt, gs, nu):
        key = (kind, dt, gs, nu)
        if key in cache:
            return cache[key]
        jdt, tdt = DTYPES[dt]
        T = 3
        rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
        omega = np.abs(rng.standard_normal(T)) * 20
        x, b = (rng.standard_normal((T,) + gs) for _ in range(2))
        ec = rng.standard_normal((T,) + tuple((n - 1) // 2 for n in gs))
        J = lambda a: jnp.asarray(a, jdt)
        P = lambda a: torch.tensor(np.asarray(a), dtype=tdt)
        if kind == "const":
            msmg = hier[0][0]
            lev = msmg.levels[0]
            st = {k: dataclasses.replace(s, grid_shape=gs)
                  for k, s in (("A", lev.A_st), ("M", lev.M_st))}
            pj = MSPallasLevel(st["A"], st["M"], T, jdt, nu, interpret=True)
            jc, extra_j = MSPallasLevel.columns(lev, omega, jdt), ()
            kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
            tc = MSKernelLevel.columns(
                mg.row_params(msmg, omega, tdt, "cpu")[0])
            extra_t = ()
        else:
            (jm, _), (pm, _) = hier[1]
            jlev = jm.levels[0]
            W = np.ascontiguousarray(
                jlev.Aw[(slice(None),) + tuple(slice(0, n) for n in gs)])
            lev = dataclasses.replace(
                jlev, gs=gs,
                A_vs=dataclasses.replace(jlev.A_vs, grid_shape=gs),
                M_st=dataclasses.replace(jlev.M_st, grid_shape=gs))
            pj = VarMSPallasLevel(lev, T, jdt, nu, interpret=True)
            jc, extra_j = VarMSPallasLevel.columns(jlev, omega, jdt), (J(W),)
            kl = VarMSKernelLevel(pm.levels[0], nu, gs=gs)
            lp0 = jm.row_params(omega, jnp.float64)[0]
            rows = lambda a: P(np.asarray(a).reshape(T, -1)[:, 0])
            tc = {"omega": P(omega), "invT": rows(lp0["inv_theta"]),
                  "invDel": rows(lp0["inv_delta"])}
            extra_t = (P(W),)
        assert pj.fused_ok and kl.fused_ok and kl.dim == 3
        tx = pj.transfers(jdt)
        jx, jrc = pj.fused_pre(J(b), jc, tx, *extra_j)
        want = {"fused_pre_x": jx, "fused_pre_rc": jrc,
                "fused_post": pj.fused_post(J(x), J(b), J(ec), jc, tx,
                                            *extra_j)}
        px, prc = kl.fused_pre(P(b), tc, *extra_t)
        got = {"fused_pre_x": px, "fused_pre_rc": prc,
               "fused_post": kl.fused_post(P(x), P(b), P(ec), tc, *extra_t)}
        cache[key] = (want, got)
        return cache[key]

    return run


@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["const", "var"])
@pytest.mark.parametrize("op", ["fused_pre_x", "fused_pre_rc", "fused_post"])
def test_fused_3d_twin_matches_pallas(cases, op, kind, dt, grid, nu):
    want, got = cases(kind, dt, GRIDS[grid], nu)
    assert got[op].dtype == DTYPES[dt][1]
    transfer = op in ("fused_pre_rc", "fused_post")
    _close(got[op], want[op], (TOL_TRANSFER if transfer else TOL)[dt])


class _Counted:
    """Counts a kernel level's calls of its fused stages."""

    def __init__(self, level):
        self.level = level
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.level, name)

    def fused_pre(self, *args):
        self.calls += 1
        return self.level.fused_pre(*args)


@pytest.mark.parametrize("kind", ["const", "var"])
def test_fused_vcycle_3d_matches_jax_pallas_f64(hier, kind):
    """Two 3-D V-cycles: the port's kernel levels take the fused branch on
    every level (K6/K7, K14/K15; K4/K11 starts the second cycle) and match
    the JAX V-cycle with fused Pallas levels in float64."""
    T = 3
    rng = np.random.default_rng(41)
    omega = np.abs(rng.standard_normal(T)) * 10
    if kind == "const":
        jm = pm = hier[0][0]
        A_c, M_c = hier[0][1]
        jlevels = [MSPallasLevel(lev.A_st, lev.M_st, T, jnp.float64, jm.nu,
                                 interpret=True) for lev in jm.levels]
        jcols, lps_t = MSPallasLevel.columns, mg.row_params(
            pm, omega, torch.float64, "cpu")
        kernels = [MSKernelLevel(lev.A_st, lev.M_st, pm.nu)
                   for lev in pm.levels]
        vc = mg.MultiShiftMG(pm)
    else:
        (jm, (A_c, M_c)), (pm, _) = hier[1]
        jlevels = [VarMSPallasLevel(lev, T, jnp.float64, jm.nu,
                                    interpret=True) for lev in jm.levels]
        jcols, lps_t = VarMSPallasLevel.columns, mg.var_row_params(
            pm, omega, torch.float64, "cpu")
        kernels = [VarMSKernelLevel(lev, pm.nu) for lev in pm.levels]
        vc = mg.GalerkinMultiShiftMG(pm)
    b = rng.standard_normal((T,) + tuple(jm.levels[0].A_st.grid_shape
                                         if kind == "const"
                                         else jm.levels[0].gs))
    cinv = np.linalg.inv(A_c + omega.mean() * M_c)

    lps_j = jm.row_params(omega, jnp.float64)
    for pj, lp, lev in zip(jlevels, lps_j, jm.levels):
        assert pj.fused_ok
        lp["cols"] = jcols(lev, omega, jnp.float64)
        lp["tx"] = pj.transfers(jnp.float64)
    cj = jnp.asarray(cinv)
    want = jm.solve(jnp.asarray(b), lps_j,
                    lambda bc: jnp.dot(bc.reshape(T, -1), cj).reshape(bc.shape),
                    2, pallas=jlevels)

    for lp in lps_t:
        lp["cols"] = type(kernels[0]).columns(lp)
    counted = [_Counted(k) for k in kernels]
    assert all(k.fused_ok and k.dim == 3 for k in kernels)
    ct = torch.as_tensor(cinv)
    got = vc.solve(torch.as_tensor(b), lps_t,
                   lambda bc: (bc.reshape(T, -1) @ ct).reshape(bc.shape), 2,
                   kernels=counted)
    assert [k.calls for k in counted] == [2] * len(kernels)
    _close(got, want, 1e-12)
