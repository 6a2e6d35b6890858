"""The sharded-slab forms of the multigrid kernels (``ops.mg_kernels``: K3
with ``vmask``, K6/K7/K8/K9 with ``lead``) against the JAX package's Pallas
kernels in interpret mode (``MSPallasLevel.smooth(vmask=)`` and its
``sh_*`` stages, the unblocked layout), on a halo-extended slab of the
leading grid axis (own + 2h planes) with a 0/1 validity field that zeroes
the edge planes, as the time×space mesh builds it. Inputs are made with
numpy from a seed; the wrappers get CPU tensors, so they run their twins.

Tolerances, relative to max|JAX|: 1e-12 in float64; in float32 1e-4 for
the transfer outputs (JAX's bf16 hi + lo split on the matrix unit,
``_dot_last``) and 1e-5 for the sweep.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.ops.mg_pallas import MSPallasLevel
from spacetime_tpu.ops.multigrid import MultiShiftMultigrid
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops.mg_kernels import MSKernelLevel

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
TOL = {"f64": 1e-12, "f32": 1e-5}
TOL_TRANSFER = {"f64": 1e-12, "f32": 1e-4}
T = 3
# (dim, own, rest): the owned planes of the leading axis and the other
# (odd) extents of the slab
SLABS = {2: (8, (15,)), 3: (4, (7, 9))}
# (ν, h): odd and even halos at each ν (the fused pre-stage needs h ≥ ν+1)
CASES = [(2, 3), (2, 4), (3, 4), (3, 5)]


@pytest.fixture(scope="module")
def hierarchies():
    return {dim: MultiShiftMultigrid.build(dim, 8, nu=2, n_coarse=4)[0]
            for dim in (2, 3)}


def _vmask(rng, E, rest):
    """A (1, E, *rest) 0/1 field: planes 0 and E-2, E-1 invalid (halo past
    the domain and grid padding), one more at random inside."""
    m = np.ones(E)
    m[[0, E - 2, E - 1]] = 0.0
    m[rng.integers(1, E - 2)] = 0.0
    return np.broadcast_to(m.reshape((1, E) + (1,) * len(rest)),
                           (1, E) + rest).copy()


@pytest.fixture(scope="module")
def slab_cases(hierarchies):
    cache = {}

    def run(dt, dim, nu, h):
        key = (dt, dim, nu, h)
        if key in cache:
            return cache[key]
        lev = hierarchies[dim].levels[0]
        own, rest = SLABS[dim]
        E = own + 2 * h
        gs = (E,) + rest
        hc_post = (h + 2) // 2  # the least hc with 2hc >= h+1
        hc_pc = 1
        jdt, tdt = DTYPES[dt]
        rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
        omega = np.abs(rng.standard_normal(T)) * 20
        x, b = (rng.standard_normal((T,) + gs) for _ in range(2))
        x_own = rng.standard_normal((T, own) + rest)
        crest = tuple((n - 1) // 2 for n in rest)
        ec_post = rng.standard_normal((T, own // 2 + 2 * hc_post) + crest)
        ec_pc = rng.standard_normal((T, own // 2 + 2 * hc_pc) + crest)
        vm = _vmask(rng, E, rest)
        J = lambda a: jnp.asarray(a, jdt)
        P = lambda a: torch.as_tensor(a, dtype=tdt)

        st = {k: dataclasses.replace(s, grid_shape=gs)
              for k, s in (("A", lev.A_st), ("M", lev.M_st))}
        pj = MSPallasLevel(st["A"], st["M"], T, jdt, nu, interpret=True)
        assert not pj._sh_blocked() and pj.sh_fused_ready(own, h)
        jc, tx = MSPallasLevel.columns(lev, omega, jdt), pj.transfers(jdt)
        jx, jrc = pj.sh_fused_pre(J(b), jc, tx, J(vm), own, h)
        want = {
            "smooth": pj.smooth(J(x), J(b), jc, vmask=J(vm)),
            "smooth_zero": pj.smooth(None, J(b), jc, zero_init=True,
                                     vmask=J(vm)),
            "fused_pre_x": jx,
            "fused_pre_rc": jrc,
            "fused_post": pj.sh_fused_post(J(x), J(b), J(ec_post), jc, tx,
                                           J(vm), own, h, hc_post),
            "residual_restrict": pj.sh_residual_restrict(J(x), J(b), jc, tx,
                                                         own, h),
            "prolong_correct": pj.sh_prolong_correct(J(x_own), J(ec_pc), tx,
                                                     own, hc_pc),
        }

        kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
        tc = MSKernelLevel.columns(
            mg.row_params(hierarchies[dim], omega, tdt, "cpu")[0])
        px, prc = kl.sh_fused_pre(P(b), tc, P(vm), own, h)
        got = {
            "smooth": kl.smooth(P(x), P(b), tc, vmask=P(vm)),
            "smooth_zero": kl.smooth(None, P(b), tc, zero_init=True,
                                     vmask=P(vm)),
            "fused_pre_x": px,
            "fused_pre_rc": prc,
            "fused_post": kl.sh_fused_post(P(x), P(b), P(ec_post), tc, P(vm),
                                           own, h, hc_post),
            "residual_restrict": kl.sh_residual_restrict(P(x), P(b), tc, own,
                                                         h),
            "prolong_correct": kl.sh_prolong_correct(P(x_own), P(ec_pc), own,
                                                     hc_pc),
        }
        cache[key] = (want, got)
        return cache[key]

    return run


_OPS = ["smooth", "smooth_zero", "fused_pre_x", "fused_pre_rc", "fused_post",
        "residual_restrict", "prolong_correct"]
_TRANSFER = {"fused_pre_rc", "fused_post", "residual_restrict",
             "prolong_correct"}
_PARAMS = ([("f64", dim, nu, h) for dim in (2, 3) for nu, h in CASES]
           + [("f32", 2, 2, 3), ("f32", 3, 3, 4)])


@pytest.mark.parametrize("dt,dim,nu,h", _PARAMS,
                         ids=[f"{d}-{dim}d-nu{nu}-h{h}"
                              for d, dim, nu, h in _PARAMS])
@pytest.mark.parametrize("op", _OPS)
def test_sharded_twin_matches_pallas(slab_cases, op, dt, dim, nu, h):
    want, got = slab_cases(dt, dim, nu, h)
    w, g = np.asarray(want[op]), got[op]
    assert g.dtype == DTYPES[dt][1]
    assert tuple(g.shape) == w.shape, (g.shape, w.shape)
    tol = (TOL_TRANSFER if op in _TRANSFER else TOL)[dt]
    err = float(np.abs(g.numpy() - w).max())
    assert err <= tol * float(np.abs(w).max()), (err, tol)


def test_vmask_pins_invalid_planes(hierarchies):
    """A zero-init sweep with the validity field leaves exactly 0 on every
    invalid plane (the padding discipline the mesh relies on)."""
    lev = hierarchies[2].levels[0]
    own, rest = SLABS[2]
    gs = (own + 6,) + rest
    rng = np.random.default_rng(7)
    vm = torch.as_tensor(_vmask(rng, gs[0], rest))
    kl = MSKernelLevel(lev.A_st, lev.M_st, 3, gs=gs)
    tc = MSKernelLevel.columns(
        mg.row_params(hierarchies[2], np.full(T, 3.0), torch.float64, "cpu")[0])
    b = torch.as_tensor(rng.standard_normal((T,) + gs))
    x = kl.smooth(None, b, tc, zero_init=True, vmask=vm)
    assert torch.all(x[:, vm[0, :, 0] == 0] == 0)
    assert torch.all(x[:, vm[0, :, 0] == 1] != 0)


def test_lead_checks():
    """The slab forms refuse an odd owned extent, a halo below their
    contract and a coarse halo that does not cover the fine one."""
    msmg = MultiShiftMultigrid.build(2, 8, nu=2, n_coarse=4)[0]
    lev = msmg.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, 2, gs=(14, 15))
    with pytest.raises(ValueError, match="gs\\[0\\] == own"):
        kl._check_lead(7, 3, 3)
    with pytest.raises(ValueError, match="h >= 3"):
        MSKernelLevel(lev.A_st, lev.M_st, 2, gs=(12, 15))._check_lead(8, 2, 3)
