"""The port's stencil, wavelet and multigrid operators against the JAX
package's, on seeded inputs (float64 unless stated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime_tpu.fem.timegrid import uniform_time_grid
from spacetime_tpu.ops import multigrid as jmg
from spacetime_tpu.ops.sparse import DiaMatrix
from spacetime_tpu.ops.stencil import StencilOperator
from spacetime_tpu.ops.wavelets import build_wavelet_transform
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops import wavelets as wav
from spacetime_tpu_torch.ops.stencil import row_scale, stencil_apply

T64 = dict(rtol=1e-13, atol=1e-13)


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rel, atol=rel * float(np.abs(want).max())
    )


@pytest.mark.parametrize("mesh", [unit_square_mesh(10), unit_cube_mesh(5)],
                         ids=["2d", "3d"])
def test_stencil_apply(mesh):
    system = P1System.from_mesh(mesh)
    gs = tuple(mesh.grid_shape)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((4,) + gs)
    for mat in (system.M, system.A):
        st = StencilOperator.from_dia(DiaMatrix.from_csr(mat), gs)
        _rel_close(stencil_apply(st, torch.as_tensor(X)), st.apply(jnp.asarray(X)), 1e-13)


def test_row_scale_column():
    col = row_scale(np.array([1.0, 2.0, 3.0]), 2, torch.float32, "cpu")
    assert col.shape == (3, 1, 1) and col.dtype == torch.float32
    assert col.is_contiguous()


@pytest.fixture(scope="module")
def wavelet_case():
    wt = build_wavelet_transform(uniform_time_grid(5))
    X = np.random.default_rng(4).standard_normal((wt.grid.num_nodes, 7, 5))
    return wt, X


def test_wavelet_lifting_f64(wavelet_case):
    wt, X = wavelet_case
    wp = wav.wavelet_params(wt, torch.float64, "cpu")
    assert "levels" in wp
    jwp = wt.jax_params(jnp.float64)
    Xt, Xj = torch.as_tensor(X), jnp.asarray(X)
    _rel_close(wav.forward(wt, Xt, wp), wt.forward_jax(Xj, jwp), 1e-14)
    _rel_close(wav.adjoint(wt, Xt, wp), wt.adjoint_jax(Xj, jwp), 1e-14)
    # the input is left as it was
    np.testing.assert_array_equal(Xt.numpy(), X)


def test_wavelet_dense_f32(wavelet_case):
    wt, X = wavelet_case
    X = X.astype(np.float32)
    wp = wav.wavelet_params(wt, torch.float32, "cpu")
    assert set(wp) == {"Wd", "WdT"}
    jwp = wt.jax_params(jnp.float32)
    Xt, Xj = torch.as_tensor(X), jnp.asarray(X)
    _rel_close(wav.forward(wt, Xt, wp), wt.forward_jax(Xj, jwp), 1e-6)
    _rel_close(wav.adjoint(wt, Xt, wp), wt.adjoint_jax(Xj, jwp), 1e-6)


def test_wavelet_graded_raises():
    from spacetime_tpu.fem.timegrid import graded_time_grid

    wt = build_wavelet_transform(graded_time_grid(2, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wav.wavelet_params(wt, torch.float64, "cpu")


@pytest.mark.parametrize("dim, n, nc", [(2, 16, 8), (3, 8, 4)])
def test_transfers(dim, n, nc):
    rng = np.random.default_rng(5)
    F = rng.standard_normal((3,) + (n - 1,) * dim)
    C = rng.standard_normal((3,) + (nc - 1,) * dim)
    _rel_close(
        mg.transfer(torch.as_tensor(F), dim, restrict=True),
        jmg._transfer_fast(jnp.asarray(F), dim, restrict=True), 1e-14,
    )
    _rel_close(
        mg.transfer(torch.as_tensor(C), dim, restrict=False),
        jmg._transfer_fast(jnp.asarray(C), dim, restrict=False), 1e-14,
    )


@pytest.fixture(scope="module")
def mg_case():
    """Levels 32 and 16 over an 8-cell coarse grid; 9 rows whose shifts mix
    zero (K_Y) with the wavelet-level shifts (K_X)."""
    msmg, (A_c, M_c) = jmg.MultiShiftMultigrid.build(2, 32, nu=2, n_coarse=8)
    omega = np.array([0.0, 0.0, 3.0, 40.0, 0.0, 900.0, 12.0, 0.0, 250.0])
    cinv = np.linalg.inv(A_c + 7.0 * M_c)
    b = np.random.default_rng(6).standard_normal((omega.size, 31, 31))
    return msmg, omega, cinv, b


def test_row_params(mg_case):
    msmg, omega, _, _ = mg_case
    ref = msmg.row_params(omega, jnp.float64)
    got = mg.row_params(msmg, omega, torch.float64, "cpu")
    for lp, rp in zip(got, ref):
        for k in ("omega", "inv_diag", "inv_theta", "inv_delta"):
            want = np.asarray(rp[k])
            assert lp[k].shape == (omega.size, 1, 1)
            np.testing.assert_allclose(
                np.broadcast_to(lp[k].numpy(), want.shape), want, rtol=1e-15
            )


@pytest.mark.parametrize("cycles", [1, 3])
def test_multishift_vcycle_and_solve(mg_case, cycles):
    msmg, omega, cinv, b = mg_case
    lps_j = msmg.row_params(omega, jnp.float64)
    lps_t = mg.row_params(msmg, omega, torch.float64, "cpu")
    cinv_j, cinv_t = jnp.asarray(cinv), torch.as_tensor(cinv)

    def coarse_j(bc):
        return jnp.dot(bc.reshape(bc.shape[0], -1), cinv_j).reshape(bc.shape)

    def coarse_t(bc):
        return (bc.reshape(bc.shape[0], -1) @ cinv_t).reshape(bc.shape)

    ms = mg.MultiShiftMG(msmg)
    want = msmg.solve(jnp.asarray(b), lps_j, coarse_j, cycles)
    got = ms.solve(torch.as_tensor(b), lps_t, coarse_t, cycles)
    _rel_close(got, want, 1e-13)
    _rel_close(
        ms.op(0, lps_t[0], torch.as_tensor(b)),
        msmg._op(msmg.levels[0], lps_j[0], jnp.asarray(b)), 1e-13,
    )


def test_chebyshev_mass_inverse():
    system = P1System.from_mesh(unit_square_mesh(16))
    gs = tuple(system.mesh.grid_shape)
    M_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.M), gs)
    center = dict(zip(M_st.disps, M_st.weights))[(0, 0)]
    lmin, lmax = jmg.mass_spectral_bounds(2)
    b = np.random.default_rng(7).standard_normal((2,) + gs)
    ref = jmg.chebyshev_inverse(M_st, 1.0 / center, lmin, lmax, 30)
    got = mg.chebyshev_stencil_inverse(M_st, 1.0 / center, lmin, lmax, 30)
    x = got(torch.as_tensor(b))
    _rel_close(x, ref(jnp.asarray(b)), 1e-13)
    # and it inverts M to the polynomial's accuracy
    resid = stencil_apply(M_st, x) - torch.as_tensor(b)
    assert float(resid.abs().max()) < 1e-6 * float(np.abs(b).max())
