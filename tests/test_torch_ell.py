"""The flat-dof formats against the JAX package: ``BlockedEll`` bit for bit,
the K20 blocked twin (``ops.spmv.spmm_plain``) and ``EllOperator`` (the
packed twin on CPU tensors) against the JAX ``_spmm_call`` in interpret
mode, and ``dia_matvec``, in float32 and float64; the row-packed layout
that K19 and K20 read (``pack_blocks``: the nonzeros, their order, the
pads, the widths), the packed twins against the blocked ones and numpy
on the L-shape's A and M, a ragged random matrix and an SA level's pair,
P and R, K19's packed twin against the JAX ``_spmm_pair_call`` in
interpret mode, and ``convert.ell_params_from_jax``. The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

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
    spmv.reset_launch_counts()
    got = spmv.spmm_plain(torch.as_tensor(Xp),
                          torch.as_tensor(ell.blocks, dtype=dtype),
                          torch.as_tensor(ell.colidx), nrb * ell.br)
    assert got.dtype == dtype and got.shape == (T, nrb * ell.br)
    _close(got, want, dtype)
    # the wrapper on a CPU tensor: the packed twin, unpadded rows in and
    # out
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


# ------------------------------------------------ the packed layout (K19/K20)

# max|packed twin − reference| ≤ tol · max|reference|: the same products,
# summed entry by entry where the blocked twin sums block products
PACK_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
LAYOUTS = ["A", "M", "random", "op", "P", "R"]


@pytest.fixture(scope="module")
def layouts(mats):
    """Each matrix of the packing checks as (blocks, colidx, m, ncols, ref):
    the n = 32 L-shape's A and M and the ragged random m = 300 in
    ``BlockedEll``, and the SA hierarchy's aggregated level of the 64-cell
    L-shape (m = 511): the A/M pair on their union pattern, P and R = Pᵀ,
    re-laid by ``ell_to_blocked``. ``ref`` (X (T, ncols) -> [Y (T, m)]) is
    ``matvec_np``, or the level's gather rows summed in numpy."""
    from spacetime_tpu_torch.ops.multigrid import SAMultiShiftMultigrid

    out = {}
    for name in ("A", "M", "random"):
        ell = BlockedEll.from_csr(mats[name])
        out[name] = ([ell.blocks], ell.colidx, ell.shape[0], ell.shape[1],
                     lambda X, ell=ell: [ell.matvec_np(X)])
    s = fem.P1System.from_mesh(fem.l_shape_mesh(64))
    sa, _ = SAMultiShiftMultigrid.build(s.A, s.M, m_coarse=300)
    lev = [lev for lev in sa.levels if lev.fmt == "ell"][0]
    ek = spmv.EllKernelLevel(lev)
    gather = lambda idx, ws: lambda X: [
        np.einsum("tmk,mk->tm", X[:, idx], w) for w in ws]
    refs = {"op": (ek.m, ek.m, gather(lev.eidx, [lev.ewA, lev.ewM])),
            "P": (ek.m, ek.mc, gather(lev.Pidx, [lev.Pw])),
            "R": (ek.mc, ek.m, gather(lev.Ridx, [lev.Rw]))}
    blocked = spmv.level_blocks(lev)
    for name, (m, ncols, ref) in refs.items():
        colidx, blocks = blocked[name]
        out[name] = (blocks, colidx, m, ncols, ref)
    return out


@pytest.mark.parametrize("name", LAYOUTS)
def test_pack_keeps_the_nonzeros(layouts, name):
    """Every entry nonzero in any value array, in slot-then-column order and
    no other, at the front of its row; pads 0 at a valid column; rows ≥ m
    empty; each slice as wide as its longest row."""
    blocks, colidx, m, ncols, _ = layouts[name]
    pk = spmv.pack_blocks(blocks, colidx, m)
    nrb, nslots, br, bc = blocks[0].shape
    rows = spmv.WARP * (pk.slice_ptr.size - 1)
    assert rows == nrb * br and pk.slice_ptr.dtype == np.int32
    assert pk.col.dtype == np.int32 and pk.vals.shape == (len(blocks),
                                                          pk.col.size)
    width = np.diff(pk.slice_ptr) // spmv.WARP
    assert (np.diff(pk.slice_ptr) % spmv.WARP == 0).all()
    count = np.zeros(rows, int)
    for r in range(rows):
        rb, i = divmod(r, br)
        want = [(colidx[rb, s] * bc + k, [b[rb, s, i, k] for b in blocks])
                for s in range(nslots)
                for k in np.flatnonzero(np.any([b[rb, s, i] != 0
                                                for b in blocks], axis=0))]
        sl, lane = divmod(r, spmv.WARP)
        at = pk.slice_ptr[sl] + spmv.WARP * np.arange(width[sl]) + lane
        kept = np.any(pk.vals[:, at] != 0, axis=0)
        count[r] = kept.sum()
        assert not kept[count[r]:].any(), r  # the pads come last
        got = [(c, list(v)) for c, v in zip(pk.col[at][kept],
                                             pk.vals[:, at][:, kept].T)]
        assert got == want, r
        assert (pk.col[at] < ncols).all() and (pk.col[at] >= 0).all()
    assert not count[m:].any()
    np.testing.assert_array_equal(width, count.reshape(-1, spmv.WARP).max(1))


@pytest.mark.parametrize("T", [1, 5, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", LAYOUTS)
def test_packed_twin_matches_blocked_twin(layouts, name, dtype, T):
    """The packed twin (the CPU path of ``spmm`` / ``spmm_pair``) against
    the blocked twin and the numpy reference, no launch."""
    blocks, colidx, m, ncols, ref = layouts[name]
    npdt = np.float32 if dtype == torch.float32 else np.float64
    X = np.random.default_rng(T).standard_normal((T, ncols)).astype(npdt)
    p = spmv.packed_params(spmv.pack_blocks(blocks, colidx, m), dtype, "cpu")
    Xt, ci = torch.as_tensor(X), torch.as_tensor(colidx)
    spmv.reset_launch_counts()
    if len(blocks) == 2:
        got = spmv.spmm_pair(Xt, p, m)
        blk = spmv.spmm_pair_plain(Xt, *(torch.as_tensor(b, dtype=dtype)
                                         for b in blocks), ci, m)
    else:
        got = (spmv.spmm(Xt, p, m),)
        blk = (spmv.spmm_plain(Xt, torch.as_tensor(blocks[0], dtype=dtype),
                               ci, m),)
    assert all(n == 0 for n in spmv.launch_counts().values())
    for g, b, r in zip(got, blk, ref(X.astype(np.float64))):
        assert g.dtype == dtype and g.shape == (T, m)
        for want in (b.numpy(), r):
            np.testing.assert_allclose(
                g.numpy(), want, rtol=0,
                atol=PACK_TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("T", [1, 33])
def test_packed_pair_twin_matches_jax_interpret(layouts, T):
    """K19's packed twin against the JAX ``_spmm_pair_call`` in interpret
    mode (f32, as the TPU ran it) on the SA level's A/M pair."""
    from spacetime_tpu.ops.ell_pallas import _spmm_pair_call

    (bA, bM), colidx, m, ncols, _ = layouts["op"]
    nrb, nslots, br, bc = bA.shape
    X = np.random.default_rng(T).standard_normal((T, ncols)).astype(
        np.float32)
    Xp = np.pad(X, ((0, 0), (0, -(-ncols // bc) * bc - ncols)))
    want = _spmm_pair_call(jnp.asarray(colidx), jnp.asarray(bA, jnp.float32),
                           jnp.asarray(bM, jnp.float32), jnp.asarray(Xp),
                           nrb=nrb, nslots=nslots, br=br, bc=bc,
                           interpret=True)
    p = spmv.packed_params(spmv.pack_blocks([bA, bM], colidx, m),
                           torch.float32, "cpu")
    for g, w in zip(spmv.spmm_pair_packed_plain(torch.as_tensor(X), p, m),
                    want):
        _close(g, np.asarray(w)[:, :m], torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["A", "M"])
def test_ell_params_from_jax_equal_the_ports(mats, name, dtype):
    """``convert.ell_params_from_jax`` on a JAX ``EllOperator``'s params
    gives the port's own ``EllOperator`` params, exactly."""
    from spacetime_tpu_torch.convert import ell_params_from_jax

    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jell = JBlockedEll.from_csr(mats[name])
    tree = {k: np.asarray(v) for k, v in JEllOperator(jell, jdt).params.items()}
    got = ell_params_from_jax(tree, jell.shape[0], dtype, "cpu")
    want = spmv.EllOperator(BlockedEll.from_csr(mats[name]), dtype).params
    assert set(got) == set(want) == {"slice_ptr", "col", "vals",
                                     "twin_col", "twin_vals"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
