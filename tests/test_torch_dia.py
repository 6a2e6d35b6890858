"""The twins of K16–K19 against the JAX package's Pallas kernels in
interpret mode: K16 (``_dia_smooth_call``), K17 (``_dia_residual_call``)
and K18 (``_dia_apply_call``) of ``spacetime_tpu/ops/dia_pallas.py`` on the
fine level of a nested L-shape hierarchy, single-block and lane-blocked,
from 0 and from x, pre and post, at T = N and N + 1 time rows; K19
(``_spmm_pair_call``) and the K20 transfers of ``ops/ell_pallas.py`` on an
aggregated level of the smoothed-aggregation hierarchy, and the blocked-ELL
re-layout bit for bit. f32, as the TPU kernels run; 1e-5 of max|JAX|. The
kernels themselves run on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from spacetime_tpu.fem import P1System as JP1System
from spacetime_tpu.fem import l_shape_mesh as jl_shape_mesh
from spacetime_tpu.fem import refine_hierarchy as jrefine_hierarchy
from spacetime_tpu.ops.dia_pallas import DiaPallasLevel
from spacetime_tpu.ops.ell_pallas import EllPallasLevel
from spacetime_tpu.ops.ell_pallas import ell_to_blocked as jell_to_blocked
from spacetime_tpu.ops.multigrid import NestedMultiShiftMultigrid as JNested
from spacetime_tpu.ops.multigrid import SAMultiShiftMultigrid as JSA
from spacetime_tpu_torch.ops import dia_kernels, spmv
from spacetime_tpu_torch.ops.dia_kernels import DiaKernelLevel

RTOL = 1e-5  # max|twin − JAX| ≤ RTOL · max|JAX|, f32
N = 8  # K_Y's rows; K_X's are N + 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch and the host BLAS (see tests/test_torch_ell.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nested():
    """The fine level (m = 705, 11 offsets) of the L-shape of 8 cells
    refined twice, and seeded fields for N + 1 rows."""
    mesh = jrefine_hierarchy(jl_shape_mesh(8), 2)
    s = JP1System.from_mesh(mesh)
    ms, _ = JNested.build(mesh, s.A, s.M, nu=2, m_coarse=64)
    lev = ms.levels[0]
    rng = np.random.default_rng(1)
    omega = np.abs(rng.standard_normal(N + 1)) * 3.0
    x = rng.standard_normal((N + 1, lev.m)).astype(np.float32)
    b = rng.standard_normal((N + 1, lev.m)).astype(np.float32)
    return lev, omega, x, b


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


def _parts(nested, T, blocked, nu, nu_post):
    lev, omega, x, b = nested
    pj = DiaPallasLevel(lev, T, jnp.float32, nu=nu, interpret=True,
                        nu_post=nu_post)
    if blocked:
        # the halo-slab layout on the small level
        pj.MB = 2 * pj.HS if 2 * pj.HS < pj.m else pj.HS
        assert pj.MB < pj.m
    jcols = DiaPallasLevel.columns(lev, omega[:T], jnp.float32)
    kl = DiaKernelLevel(lev, nu, nu_post=nu_post)
    assert kl.offsets == pj.offsets
    np.testing.assert_array_equal(kl._vA, pj._vA_host)
    np.testing.assert_array_equal(kl._vM, pj._vM_host)
    cols = {k: torch.as_tensor(np.array(v)[:, 0, 0]) for k, v in
            jcols.items()}
    vals = kl.values(lev, torch.float32, "cpu")
    return (pj, jcols, pj.values(lev, jnp.float32), kl, cols, vals,
            x[:T], b[:T])


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("T", [N, N + 1])
@pytest.mark.parametrize("nu, nu_post", [(2, None), (2, 3)])
def test_k16_twin_matches_pallas(nested, blocked, T, nu, nu_post):
    pj, jcols, jv, kl, cols, vals, x, b = _parts(nested, T, blocked, nu,
                                                 nu_post)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    xj, bj = jnp.asarray(x), jnp.asarray(b)
    _close(kl.smooth(None, bt, cols, vals, zero_init=True),
           pj.smooth(None, bj, jcols, jv, zero_init=True))
    _close(kl.smooth(xt, bt, cols, vals), pj.smooth(xj, bj, jcols, jv))
    _close(kl.smooth(xt, bt, cols, vals, post=True),
           pj.smooth(xj, bj, jcols, jv, post=True))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("T", [N, N + 1])
def test_k17_k18_twins_match_pallas(nested, blocked, T):
    pj, jcols, jv, kl, cols, vals, x, b = _parts(nested, T, blocked, 2, None)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    xj, bj = jnp.asarray(x), jnp.asarray(b)
    _close(kl.residual(xt, bt, cols, vals), pj.residual(xj, bj, jcols, jv))
    _close(kl.apply_A(xt, vals), pj.apply_A(xj, jv))
    assert all(n == 0 for n in dia_kernels.launch_counts().values())


@pytest.mark.parametrize("op, line", [("smooth", 156), ("residual", 258),
                                      ("apply", 315)])
def test_kernel_registry(op, line):
    """K16–K18 in f32 and f64, each naming the JAX kernel it replaces by
    file and line (the line that defines the Pallas call)."""
    from spacetime_tpu.ops import dia_pallas

    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        k = dia_kernels.KERNELS[(op, dtype)]
        assert k.symbol == f"dia_{op}_{sfx}" and k.name.endswith(sfx)
        assert k.replaces == f"spacetime_tpu/ops/dia_pallas.py:{line}"
    with open(dia_pallas.__file__) as f:
        assert f.read().splitlines()[line - 1].lstrip().startswith(
            f"def _dia_{op}_call")
    assert {o for o, _ in dia_kernels.KERNELS} == {"smooth", "residual",
                                                    "apply"}


@pytest.fixture(scope="module")
def sa_ell():
    """The aggregated (ELL) level of the SA hierarchy of the 64-cell
    L-shape (m = 511 on 2,945)."""
    s = JP1System.from_mesh(jl_shape_mesh(64))
    ms, _ = JSA.build(sp.csr_matrix(s.A), sp.csr_matrix(s.M), m_coarse=300)
    levs = [lev for lev in ms.levels if lev.fmt == "ell"]
    assert levs
    return levs[0]


def test_ell_to_blocked_equal_jax(sa_ell):
    lev = sa_ell
    valid = (lev.ewA != 0) | (lev.ewM != 0)
    got = spmv.ell_to_blocked(lev.eidx, [lev.ewA, lev.ewM], 128, 128, lev.m,
                              valid)
    want = jell_to_blocked(lev.eidx, [lev.ewA, lev.ewM], 128, 128, lev.m,
                           valid)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    mc = lev.Ridx.shape[0]
    got = spmv.ell_to_blocked(lev.Pidx, [lev.Pw], 128, 128, mc)
    want = jell_to_blocked(lev.Pidx, [lev.Pw], 128, 128, mc)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])


@pytest.mark.parametrize("T", [N, N + 1])
def test_k19_and_transfer_twins_match_pallas(sa_ell, T):
    lev = sa_ell
    pj = EllPallasLevel(lev, T, jnp.float32, interpret=True)
    plv = pj.values(lev, jnp.float32)
    ek = spmv.EllKernelLevel(lev)
    ev = ek.values(lev, torch.float32, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, lev.m)).astype(np.float32)
    e = rng.standard_normal((T, ek.mc)).astype(np.float32)
    spmv.reset_launch_counts()
    yA, yM = ek.op_pair(torch.as_tensor(x), ev)
    jA, jM = pj.op_pair(jnp.asarray(x), plv)
    _close(yA, jA)
    _close(yM, jM)
    _close(ek.interp(torch.as_tensor(e), ev), pj.interp(jnp.asarray(e), plv))
    _close(ek.restrict(torch.as_tensor(x), ev),
           pj.restrict(jnp.asarray(x), plv))
    assert all(n == 0 for n in spmv.launch_counts().values())
