"""The flat-dof formats against the JAX package: ``BlockedEll`` bit for bit,
the K20 twin (``ops.spmv.spmm_plain``) and ``EllOperator`` against the JAX
``_spmm_call`` in interpret mode, and ``dia_matvec``, in float32 and
float64. The kernel itself runs on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from spacetime_tpu.fem import P1System as JP1System
from spacetime_tpu.fem import l_shape_mesh as jl_shape_mesh
from spacetime_tpu.ops.blocked_ell import BlockedEll as JBlockedEll
from spacetime_tpu.ops.sparse import dia_matvec as jdia_matvec
from spacetime_tpu.ops.spmv_pallas import EllOperator as JEllOperator
from spacetime_tpu.ops.spmv_pallas import _spmm_call
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.ops import spmv
from spacetime_tpu_torch.ops.blocked_ell import BlockedEll
from spacetime_tpu_torch.ops.sparse import DiaMatrix, dia_matvec
from spacetime_tpu_torch.solver import build_solver

# |twin − JAX| ≤ tol · max|JAX|: the same products, summed in another order
TOL = {torch.float32: 1e-6, torch.float64: 1e-14}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's many small CPU products, torch's and
    the host BLAS's: with several test workers on one host their thread
    pools contend (tens of times slower), while one thread loses little."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mats():
    """The L-shape's A and M at n = 32 (m = 705: 6 block rows × 3 slots),
    from the port's assembly (bit-for-bit the JAX package's,
    ``tests/test_torch_oracle.py``), and a random CSR with m = 300 (not a
    multiple of 128)."""
    system = fem.P1System.from_mesh(fem.l_shape_mesh(32))
    R = sp.random(300, 300, density=0.02, random_state=3, format="csr")
    return {"A": system.A, "M": system.M, "random": R}


@pytest.mark.parametrize("name", ["A", "M", "random"])
def test_blocked_ell_equal_jax(mats, name):
    got, want = BlockedEll.from_csr(mats[name]), JBlockedEll.from_csr(mats[name])
    assert got.blocks.dtype == want.blocks.dtype
    np.testing.assert_array_equal(got.blocks, want.blocks)
    assert got.colidx.dtype == want.colidx.dtype == np.int32
    np.testing.assert_array_equal(got.colidx, want.colidx)
    assert (got.shape, got.br, got.bc, got.padded_shape) == (
        want.shape, want.br, want.bc, want.padded_shape)
    X = np.random.default_rng(0).standard_normal((3, got.shape[0]))
    np.testing.assert_array_equal(got.matvec_np(X), want.matvec_np(X))


def test_lshape_system_equal_jax(mats):
    ref = JP1System.from_mesh(jl_shape_mesh(32))
    for k in ("A", "M"):
        for a in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(mats[k], a),
                                          getattr(getattr(ref, k), a))


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("T", [1, 5, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["A", "random"])
def test_spmm_twin_matches_jax_interpret(mats, name, dtype, T):
    ell = BlockedEll.from_csr(mats[name])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    npdt = np.float32 if dtype == torch.float32 else np.float64
    m, mp = ell.shape[0], ell.padded_shape[1]
    nrb, nslots = ell.colidx.shape
    X = np.random.default_rng(T).standard_normal((T, m)).astype(npdt)
    Xp = np.pad(X, ((0, 0), (0, mp - m)))
    want = _spmm_call(jnp.asarray(ell.colidx), jnp.asarray(ell.blocks, jdt),
                      jnp.asarray(Xp), nrb=nrb, nslots=nslots, br=ell.br,
                      bc=ell.bc, interpret=True)
    p = spmv.ell_params(ell, dtype, "cpu")
    spmv.reset_launch_counts()
    got = spmv.spmm_plain(torch.as_tensor(Xp), p["blocks"], p["colidx"],
                          nrb * ell.br)
    assert got.dtype == dtype and got.shape == (T, nrb * ell.br)
    _close(got, want, dtype)
    # the wrapper on a CPU tensor: the twin, unpadded rows in and out
    op, jop = spmv.EllOperator(ell, dtype), JEllOperator(ell, jdt,
                                                         interpret=True)
    _close(op.apply(torch.as_tensor(X)), jop.apply(jnp.asarray(X)), dtype)
    _close(op.apply_padded(torch.as_tensor(Xp)), want, dtype)
    assert all(n == 0 for n in spmv.launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["A", "M"])
def test_dia_matvec_matches_jax(mats, name, dtype):
    dia = DiaMatrix.from_csr(mats[name])
    npdt = np.float32 if dtype == torch.float32 else np.float64
    U = np.random.default_rng(1).standard_normal((4, 3, dia.shape[0]))
    U = U.astype(npdt)
    got = dia_matvec(torch.as_tensor(dia.vals, dtype=dtype), dia.offsets,
                     torch.as_tensor(U))
    want = jdia_matvec(jnp.asarray(dia.vals, npdt), dia.offsets,
                       jnp.asarray(U))
    assert got.dtype == dtype and got.shape == U.shape
    _close(got, want, dtype)
    csr = (mats[name] @ U.reshape(-1, dia.shape[0]).T.astype(np.float64)).T
    _close(got, csr.reshape(U.shape), dtype)


def test_spmm_dispatch_by_device(mats):
    ell = BlockedEll.from_csr(mats["A"])
    op = spmv.EllOperator(ell, torch.float32)
    meta = torch.empty((2, op.m), device="meta")
    with pytest.raises(ValueError, match="no ell kernel for device meta"):
        op.apply(meta, {k: v.to("meta") for k, v in op.params.items()})


def test_ell_solver_runs_the_twin_on_cpu():
    """On CPU tensors the ``"ell"`` solver's every SpMV is the K20 twin:
    the same iterations as ``"dia"`` and no launch."""
    spmv.reset_launch_counts()
    kw = dict(device="cpu", inner="dense")
    ell = build_solver("lshape2d", 16, 3, spatial_format="ell", **kw)
    dia = build_solver("lshape2d", 16, 3, spatial_format="dia", **kw)
    assert ell.gs == dia.gs == (ell.m,)
    r_ell, r_dia = ell.solve(tol=1e-8), dia.solve(tol=1e-8)
    assert r_ell.iterations == r_dia.iterations
    np.testing.assert_allclose(r_ell.residuals, r_dia.residuals, rtol=1e-10)
    assert all(n == 0 for n in spmv.launch_counts().values())
