"""The plain twins of K1 (B) and K2 (Bᵀ), plain and stab-fused, against the
JAX package: its Pallas kernels in interpret mode (float32) and its XLA
stencil forms (float64).

Tolerances are relative to max|reference|: 1e-6 in float32 (the twins and
the kernels sum the same taps in the same order; interpret mode and PyTorch
may still round a multiply-add differently) and 1e-14 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime_tpu.fem.timegrid import graded_time_grid, time_matrices, uniform_time_grid
from spacetime_tpu.models import get_problem
from spacetime_tpu.ops.kron_pallas import KronPallas
from spacetime_tpu.ops.sparse import DiaMatrix
from spacetime_tpu.ops.stencil import StencilOperator
from spacetime_tpu.solver.heateq import HeatSolver as JaxHeatSolver
from spacetime_tpu_torch.ops import kron
from spacetime_tpu_torch.ops.stencil import grouped_apply


def _setup(system, grid, dtype, seed=0):
    gs = tuple(system.mesh.grid_shape)
    M_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.M), gs)
    A_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.A), gs)
    h = time_matrices(grid)["h"]
    T = grid.num_intervals
    rng = np.random.default_rng(seed)
    arrays = {
        "U": rng.standard_normal((T + 1,) + gs).astype(dtype),
        "V": rng.standard_normal((T,) + gs).astype(dtype),
        "Y": rng.standard_normal((T,) + gs).astype(dtype),
    }
    return M_st, A_st, h, arrays


def _close(got, want, rel):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(
        got.numpy(), want, rtol=rel, atol=rel * scale
    )


@pytest.mark.parametrize(
    "grid", [uniform_time_grid(3), graded_time_grid(3, 2)],
    ids=["T8", "graded-T10"],
)
def test_twins_match_pallas_interpret_f32(grid):
    system = P1System.from_mesh(unit_square_mesh(16))  # 15 x 15 interior
    M_st, A_st, h, a = _setup(system, grid, np.float32)
    kp = KronPallas(M_st, A_st, h, jnp.float32, interpret=True)
    taps = kron.KronTaps.from_stencils(M_st, A_st)
    hh = torch.as_tensor(0.5 * h, dtype=torch.float32)
    hs = torch.as_tensor(h / 16.0, dtype=torch.float32)
    U, V, Y = (torch.as_tensor(a[k]) for k in ("U", "V", "Y"))
    jU, jV, jY = (jnp.asarray(a[k]) for k in ("U", "V", "Y"))

    _close(kron.apply_B(U, hh, taps), kp.apply_B(jU), 1e-6)
    _close(kron.apply_BT(V, hh, taps), kp.apply_BT(jV), 1e-6)
    out, W = kron.apply_B_stab(U, hh, hs, taps)
    ref_out, ref_W = kp.apply_B_stab(jU)
    _close(out, ref_out, 1e-6)
    _close(W, ref_W, 1e-6)
    _close(
        kron.apply_BT_stab(V, Y, hh, taps),
        kp.apply_BT_stab(jV, jY),
        1e-6,
    )


@pytest.mark.parametrize(
    "mesh, grid",
    [
        (unit_square_mesh(16), uniform_time_grid(3)),
        (unit_square_mesh(12), graded_time_grid(2, 2)),
        (unit_cube_mesh(4), uniform_time_grid(2)),
    ],
    ids=["2d-T8", "2d-graded", "3d"],
)
def test_twins_match_xla_forms_f64(mesh, grid):
    system = P1System.from_mesh(mesh)
    M_st, A_st, h, a = _setup(system, grid, np.float64, seed=3)
    js = JaxHeatSolver(
        get_problem("smooth2d" if mesh.dim == 2 else "smooth3d"), system,
        grid, dtype=jnp.float64, inner="dense", pallas_kron=False,
    )
    taps = kron.KronTaps.from_stencils(M_st, A_st)
    hh = torch.as_tensor(0.5 * h)
    hs = torch.as_tensor(h / 16.0)
    U, V = torch.as_tensor(a["U"]), torch.as_tensor(a["V"])
    jU, jV = jnp.asarray(a["U"]), jnp.asarray(a["V"])

    _close(kron.apply_B(U, hh, taps), js.apply_B(jU), 1e-14)
    _close(kron.apply_BT(V, hh, taps), js.apply_BT(jV), 1e-14)
    out, W = kron.apply_B_stab(U, hh, hs, taps)
    _close(out, js.apply_B(jU), 1e-14)
    # Bᵀ·V + stab(U): the stab jump W[i-1] − W[i] of the W that B emitted
    _close(
        kron.apply_BT_stab(V, W, hh, taps),
        js.apply_BT(jV) + js.apply_stab(jU),
        1e-14,
    )


def test_bt_edges_and_stab_jump():
    """Row 0 has no i−1 term, row T no i term; the jump has W[-1] = W[T] = 0."""
    system = P1System.from_mesh(unit_square_mesh(6))
    M_st, A_st, h, a = _setup(system, graded_time_grid(1, 2), np.float64)
    taps = kron.KronTaps.from_stencils(M_st, A_st)
    hh = torch.as_tensor(0.5 * h)
    V, W = torch.as_tensor(a["V"]), torch.as_tensor(a["Y"])
    T = V.shape[0]
    out = kron.apply_BT(V, hh, taps)
    VM = grouped_apply(taps.groups_M, taps.gs, V)
    VA = hh.reshape(-1, 1, 1) * grouped_apply(taps.groups_A, taps.gs, V)
    torch.testing.assert_close(out[0], -VM[0] + VA[0], rtol=0, atol=0)
    torch.testing.assert_close(out[T], VM[T - 1] + VA[T - 1], rtol=0, atol=0)
    jump = kron.apply_BT_stab(V, W, hh, taps) - out
    torch.testing.assert_close(jump[0], -W[0], rtol=0, atol=1e-15)
    torch.testing.assert_close(jump[T], W[T - 1], rtol=0, atol=1e-15)
    torch.testing.assert_close(jump[1:T], W[:-1] - W[1:], rtol=0, atol=1e-15)


def test_tap_table_layout():
    system = P1System.from_mesh(unit_cube_mesh(4))
    M_st, A_st, _, _ = _setup(system, uniform_time_grid(1), np.float64)
    taps = kron.KronTaps.from_stencils(M_st, A_st)
    tM, tA = taps.structs
    for groups, st in ((taps.groups_M, tM), (taps.groups_A, tA)):
        assert st.n_groups == len(groups)
        for g, (w, ds) in enumerate(groups):
            assert st.weight[g] == w
            got = [
                (st.dz[k], st.dy[k], st.dx[k])
                for k in range(st.start[g], st.start[g + 1])
            ]
            assert got == [tuple(d) for d in ds]
    # a 2-D grid gets dz = 0 throughout
    t2 = kron.KronTaps(
        (5, 7), ((2.0, ((0, 0),)),), ((1.0, ((0, 1), (1, 0))),)
    ).structs[1]
    assert [t2.dz[k] for k in range(2)] == [0, 0]
    assert [(t2.dy[k], t2.dx[k]) for k in range(2)] == [(0, 1), (1, 0)]
