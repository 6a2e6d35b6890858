"""The CUDA kernels K1 (B), K2 (Bᵀ), the multigrid kernels K3–K9 and the
weighted K10–K15 (2-D and 3-D, the fused K6/K7 and K14/K15 at ν 2 and 3,
the 3-D K6/K7/K14/K15 on their z-marching kernels, the 2-D K6/K7 on their
y-marching ones, serial and sharded, at chunks of one row to the whole
column), the chained
sweeps of K3/K10 above the tiled ν, the blocked-ELL SpMM K20, the
banded-DIA K16–K18 (K16 at ν 1, 2, 3, 4), the pair SpMM K19 and the
sharded-slab forms (K3 with ``vmask``, K6/K7/K8/K9 with ``lead``) on the
card, against their plain twins, small solves on the card against the CPU,
and a two-rank (time 1 × space 2) gloo solve on the card against the serial
port. Marked ``cuda``: they skip where
``torch.cuda.is_available()`` is False (the kernels have no CPU mode). This
file imports no JAX, so on a machine with a GPU and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops import kron, mg_kernels, spmv
from spacetime_tpu_torch.ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from spacetime_tpu_torch.ops.multigrid import (GalerkinMultiShiftMultigrid,
                                               row_params, var_row_params)
from spacetime_tpu_torch.solver import build_solver

pytestmark = pytest.mark.cuda

# max|kernel − twin| ≤ tol · max|twin| (FMA contraction and sum order)
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.fixture(scope="module")
def taps():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    solver = build_solver("smooth2d", 8, 2, device="cpu", inner="mg")
    return dataclasses.replace(solver.taps, gs=(9, 13))


def _inputs(taps, T, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    h = rng.uniform(0.5, 1.5, T) / T
    return (mk(rng.standard_normal((T + 1,) + taps.gs)),
            mk(rng.standard_normal((T,) + taps.gs)),
            mk(rng.standard_normal((T,) + taps.gs)),
            mk(0.5 * h), mk(h / 16.0))


def _close(got, want, dtype):
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T", [1, 5])
def test_kernels_match_twins(taps, dtype, T):
    U, V, W, hh, hs = _inputs(taps, T, dtype)
    kron.reset_launch_counts()
    _close(kron.apply_B(U, hh, taps), kron.apply_B_plain(U, hh, taps), dtype)
    out, Wb = kron.apply_B_stab(U, hh, hs, taps)
    ref_out, ref_W = kron.apply_B_stab_plain(U, hh, hs, taps)
    _close(out, ref_out, dtype)
    _close(Wb, ref_W, dtype)
    _close(kron.apply_BT(V, hh, taps), kron.apply_BT_plain(V, hh, taps), dtype)
    _close(kron.apply_BT_stab(V, W, hh, taps),
           kron.apply_BT_stab_plain(V, W, hh, taps), dtype)
    name = "f32" if dtype == torch.float32 else "f64"
    counts = kron.launch_counts()
    assert counts[f"K1 kron_B {name}"] == 2
    assert counts[f"K2 kron_BT {name}"] == 2


def test_wrappers_check_inputs(taps):
    U, V, W, hh, hs = _inputs(taps, 3, torch.float32)
    with pytest.raises(TypeError, match="float32 and float64"):
        kron.apply_B(U.half(), hh.half(), taps)
    with pytest.raises(ValueError, match="contiguous"):
        kron.apply_BT(V.transpose(1, 2).contiguous().transpose(1, 2), hh, taps)
    with pytest.raises(ValueError, match="shape"):
        kron.apply_BT_stab(V, W[:2], hh, taps)
    with pytest.raises(TypeError, match="dtype"):
        kron.apply_B(U, hh.double(), taps)


def test_small_solve_matches_cpu(taps):
    kw = dict(dtype=torch.float64, inner="mg", mg_coarse=4)
    cpu = build_solver("smooth2d", 16, 3, device="cpu", **kw).solve(tol=1e-8)
    gpu = build_solver("smooth2d", 16, 3, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)


@pytest.fixture(scope="module")
def msmg():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return build_solver("smooth2d", 8, 2, device="cpu", inner="mg").msmg


# ragged extents: one tile; a last tile of a single fine row and column;
# several tiles with ragged edges
@pytest.mark.parametrize("gs", [(15, 31), (33, 65), (47, 71)])
@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_kernels_match_twins(msmg, dtype, nu, gs):
    T = 5
    lev = msmg.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, nu_post=1, gs=gs)
    rng = np.random.default_rng(nu)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    omega = np.abs(rng.standard_normal(T)) * 20
    cols = MSKernelLevel.columns(row_params(msmg, omega, dtype, "cuda")[0])
    x, b = mk(rng.standard_normal((T,) + gs)), mk(rng.standard_normal((T,) + gs))
    ec = mk(rng.standard_normal((T,) + kl.coarse_gs))
    mg_kernels.reset_launch_counts()
    _close(kl.smooth(x, b, cols), kl.smooth_plain(x, b, cols), dtype)
    _close(kl.smooth(x, b, cols, post=True),
           kl.smooth_plain(x, b, cols, post=True), dtype)
    _close(kl.smooth(None, b, cols, zero_init=True),
           kl.smooth_plain(None, b, cols, zero_init=True), dtype)
    _close(kl.residual(x, b, cols), kl.residual_plain(x, b, cols), dtype)
    _close(kl.apply_A(x), kl.apply_A_plain(x), dtype)
    for got, want in zip(kl.fused_pre(b, cols), kl.fused_pre_plain(b, cols)):
        _close(got, want, dtype)
    _close(kl.fused_post(x, b, ec, cols), kl.fused_post_plain(x, b, ec, cols),
           dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K3 mg_smooth {sfx}"] == 3
    for name in ("K4 mg_residual", "K5 mg_apply", "K6 mg_fused_pre",
                 "K7 mg_fused_post"):
        assert counts[f"{name} {sfx}"] == 1, (name, counts)


def test_mg_wrappers_check_inputs(msmg):
    lev = msmg.levels[0]
    T, gs = 3, (15, 31)
    kl = MSKernelLevel(lev.A_st, lev.M_st, 2, gs=gs)
    cols = MSKernelLevel.columns(
        row_params(msmg, np.ones(T), torch.float32, "cuda")[0])
    b = torch.zeros((T,) + gs, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        kl.residual(b[:, :-1].contiguous(), b, cols)
    with pytest.raises(TypeError, match="dtype"):
        kl.smooth(b.double(), b.double(), cols)
    with pytest.raises(ValueError, match="odd extents"):
        MSKernelLevel(lev.A_st, lev.M_st, 2, gs=(16, 31)).fused_pre(
            torch.zeros((T, 16, 31), device="cuda"), cols)
    with pytest.raises(ValueError, match="nu=0"):
        MSKernelLevel(lev.A_st, lev.M_st, 0, gs=gs).smooth(b, b, cols)


@pytest.fixture(scope="module")
def msmg3d():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return build_solver("smooth3d", 8, 2, device="cpu", inner="mg").msmg


def _level_inputs(msmg, kl, T, dtype, seed):
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    omega = np.abs(rng.standard_normal(T)) * 20
    cols = MSKernelLevel.columns(row_params(msmg, omega, dtype, "cuda")[0])
    x, b = mk(rng.standard_normal((T,) + kl.gs)), mk(rng.standard_normal((T,) + kl.gs))
    return x, b, mk(rng.standard_normal((T,) + kl.coarse_gs)), cols


# ragged extents: one brick; bricks with a last plane / row / column of one
# point; several bricks in every direction. The 3-D K6 marches through
# chunks of 2 coarse planes at T = 5 (``march_chunk``): a ragged last chunk
# (nz 7, 19), two whole ones (nz 9), one (nz 5 = 2·2 + 1) and a single
# coarse plane (nz 3); ny, nx off the 16 × 32 tile (19 × 35: four tiles).
# The 3-D K7 through chunks of 4 fine planes (nz 3: one chunk of 3; nz
# 9, 13: a last chunk of one plane; 13 × 35 × 67: nine tiles, the last
# row and column of tiles 3 points wide)
@pytest.mark.parametrize("gs", [(7, 9, 15), (9, 17, 33), (19, 21, 45),
                                (3, 17, 33), (5, 19, 35), (13, 35, 67)])
@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_kernels_3d_match_twins(msmg3d, dtype, nu, gs):
    T = 5
    lev = msmg3d.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, nu_post=1, gs=gs)
    x, b, ec, cols = _level_inputs(msmg3d, kl, T, dtype, nu)
    mg_kernels.reset_launch_counts()
    _close(kl.smooth(x, b, cols), kl.smooth_plain(x, b, cols), dtype)
    _close(kl.smooth(x, b, cols, post=True),
           kl.smooth_plain(x, b, cols, post=True), dtype)
    _close(kl.smooth(None, b, cols, zero_init=True),
           kl.smooth_plain(None, b, cols, zero_init=True), dtype)
    _close(kl.residual(x, b, cols), kl.residual_plain(x, b, cols), dtype)
    _close(kl.apply_A(x), kl.apply_A_plain(x), dtype)
    _close(kl.residual_restrict(x, b, cols),
           kl.residual_restrict_plain(x, b, cols), dtype)
    _close(kl.prolong_correct(x, ec), kl.prolong_correct_plain(x, ec), dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K3 mg_smooth_3d {sfx}"] == 3
    for name in ("K4 mg_residual", "K5 mg_apply", "K8 mg_residual_restrict",
                 "K9 mg_prolong_correct"):
        assert counts[f"{name}_3d {sfx}"] == 1, (name, counts)
    assert sum(counts.values()) == 7
    # the fused stages at the same ν (ν_post = ν)
    kf = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
    assert kf.fused_ok
    mg_kernels.reset_launch_counts()
    for got, want in zip(kf.fused_pre(b, cols), kf.fused_pre_plain(b, cols)):
        _close(got, want, dtype)
    _close(kf.fused_post(x, b, ec, cols), kf.fused_post_plain(x, b, ec, cols),
           dtype)
    counts = mg_kernels.launch_counts()
    for name in ("K6 mg_fused_pre", "K7 mg_fused_post"):
        assert counts[f"{name}_3d {sfx}"] == 1, (name, counts)
    assert sum(counts.values()) == 2


@pytest.mark.parametrize("gs", [(15, 31), (33, 65), (47, 71)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transfer_kernels_2d_match_twins(msmg, dtype, gs):
    lev = msmg.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, 2, gs=gs)
    x, b, ec, cols = _level_inputs(msmg, kl, 5, dtype, 7)
    mg_kernels.reset_launch_counts()
    _close(kl.residual_restrict(x, b, cols),
           kl.residual_restrict_plain(x, b, cols), dtype)
    _close(kl.prolong_correct(x, ec), kl.prolong_correct_plain(x, ec), dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K8 mg_residual_restrict {sfx}"] == 1
    assert counts[f"K9 mg_prolong_correct {sfx}"] == 1


@pytest.mark.parametrize("nu_post", [None, 1], ids=["V(2,2)", "V(2,1)"])
def test_small_3d_solve_matches_cpu(msmg3d, nu_post):
    """smooth3d 9³×4 in float64: V(2,2) runs the fused K6/K7 on every
    level, V(2,1) the semi-fused K3, K8, K9."""
    kw = dict(dtype=torch.float64, inner="mg", mg_nu_post=nu_post)
    cpu = build_solver("smooth3d", 8, 2, device="cpu", **kw).solve(tol=1e-8)
    mg_kernels.reset_launch_counts()
    gpu = build_solver("smooth3d", 8, 2, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)
    counts = mg_kernels.launch_counts()
    fused = ("K6 mg_fused_pre_3d", "K7 mg_fused_post_3d")
    semi = ("K3 mg_smooth_3d", "K8 mg_residual_restrict_3d",
            "K9 mg_prolong_correct_3d")
    ran, idle = (fused, semi) if nu_post is None else (semi, fused)
    for name in ran + ("K4 mg_residual_3d", "K5 mg_apply_3d"):
        assert counts[f"{name} f64"] > 0, counts
    for name in idle + ("K6 mg_fused_pre",):
        assert counts[f"{name} f64"] == 0, counts


@pytest.fixture(scope="module")
def var_msmg():
    """The varcoef2d Galerkin hierarchy at 64 cells (finest grid 63²)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.fem import P1System, unit_square_mesh
    from spacetime_tpu_torch.models import get_problem

    system = P1System.from_problem(get_problem("varcoef2d"),
                                   unit_square_mesh(64))
    return GalerkinMultiShiftMultigrid.build(
        2, 64, system.A, system.M, nu=2, n_coarse=32)[0]


# ragged extents: one tile, then several tiles with ragged edges (the
# weights are the finest level's, cut to the test grid)
@pytest.mark.parametrize("gs", [(15, 31), (33, 63)])
@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_var_kernels_match_twins(var_msmg, dtype, nu, gs):
    T = 5
    msmg = var_msmg
    lev = msmg.levels[0]
    kl = VarMSKernelLevel(lev, nu, gs=gs)
    rng = np.random.default_rng(nu)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    W = mk(np.ascontiguousarray(lev.Aw[:, :gs[0], :gs[1]]))
    omega = np.abs(rng.standard_normal(T)) * 20
    cols = kl.columns(var_row_params(msmg, omega, dtype, "cuda")[0])
    x, b = mk(rng.standard_normal((T,) + gs)), mk(rng.standard_normal((T,) + gs))
    ec = mk(rng.standard_normal((T,) + kl.coarse_gs))
    mg_kernels.reset_launch_counts()
    _close(kl.residual(x, b, cols, W), kl.residual_plain(x, b, cols, W), dtype)
    _close(kl.apply_A(x, W), kl.apply_A_plain(x, W), dtype)
    for got, want in zip(kl.fused_pre(b, cols, W),
                         kl.fused_pre_plain(b, cols, W)):
        _close(got, want, dtype)
    _close(kl.fused_post(x, b, ec, cols, W),
           kl.fused_post_plain(x, b, ec, cols, W), dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    for name in ("K11 mg_residual_var", "K12 mg_apply_var",
                 "K14 mg_fused_pre_var", "K15 mg_fused_post_var"):
        assert counts[f"{name} {sfx}"] == 1, (name, counts)
    assert sum(counts.values()) == 4
    with pytest.raises(ValueError, match="shape"):
        kl.apply_A(x, W[:, :-1].contiguous())


def test_small_varcoef_solve_matches_cpu(var_msmg):
    """varcoef2d 33²×16 in float64: the card's weighted kernels and the
    CPU's twins take the same iterations, with every V-cycle level on
    K14/K15 and the later cycles on K11."""
    kw = dict(dtype=torch.float64, inner="mg", mg_coarse=8)
    cpu = build_solver("varcoef2d", 32, 4, device="cpu", **kw).solve(tol=1e-8)
    mg_kernels.reset_launch_counts()
    gpu = build_solver("varcoef2d", 32, 4, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)
    counts = mg_kernels.launch_counts()
    for name in ("K11 mg_residual_var", "K12 mg_apply_var",
                 "K14 mg_fused_pre_var", "K15 mg_fused_post_var"):
        assert counts[f"{name} f64"] > 0, counts
    assert counts["K14 mg_fused_pre_var f64"] == counts[
        "K15 mg_fused_post_var f64"]
    assert counts["K6 mg_fused_pre f64"] == counts["K4 mg_residual f64"] == 0


def _var_inputs(msmg, kl, T, dtype, seed):
    """x, b, e_c, the columns of random shifts and the finest level's
    weights cut (or tiled) to the grid, on the card."""
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    omega = np.abs(rng.standard_normal(T)) * 20
    cols = kl.columns(var_row_params(msmg, omega, dtype, "cuda")[0])
    Aw = msmg.levels[0].Aw
    grow = [(0, 0)] + [(0, max(n - m, 0)) for n, m in zip(kl.gs, Aw.shape[1:])]
    cut = (slice(None),) + tuple(slice(0, n) for n in kl.gs)
    W = mk(np.ascontiguousarray(np.pad(Aw, grow, mode="wrap")[cut]))
    x, b = mk(rng.standard_normal((T,) + kl.gs)), mk(rng.standard_normal((T,) + kl.gs))
    return x, b, mk(rng.standard_normal((T,) + kl.coarse_gs)), cols, W


def _check_semi_var(kl, x, b, ec, cols, W, dtype):
    """K10 (from x, from 0, the post-sweep), K13 and K9 of one weighted
    level against their twins; returns the launch counts."""
    mg_kernels.reset_launch_counts()
    _close(kl.smooth(x, b, cols, W), kl.smooth_plain(x, b, cols, W), dtype)
    _close(kl.smooth(x, b, cols, W, post=True),
           kl.smooth_plain(x, b, cols, W, post=True), dtype)
    _close(kl.smooth(None, b, cols, W, zero_init=True),
           kl.smooth_plain(None, b, cols, W, zero_init=True), dtype)
    _close(kl.residual_restrict(x, b, cols, W),
           kl.residual_restrict_plain(x, b, cols, W), dtype)
    _close(kl.prolong_correct(x, ec), kl.prolong_correct_plain(x, ec), dtype)
    return mg_kernels.launch_counts()


@pytest.mark.parametrize("gs", [(15, 31), (33, 63)])
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_var_semi_kernels_match_twins(var_msmg, dtype, nu, gs):
    """K10 and K13 in 2-D, ν_post = ν % 3 + 1."""
    kl = VarMSKernelLevel(var_msmg.levels[0], nu, nu_post=nu % 3 + 1, gs=gs)
    counts = _check_semi_var(kl, *_var_inputs(var_msmg, kl, 5, dtype, nu),
                             dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert counts[f"K10 mg_smooth_var {sfx}"] == 3
    assert counts[f"K13 mg_residual_restrict_var {sfx}"] == 1
    assert counts[f"K9 mg_prolong_correct {sfx}"] == 1
    assert sum(counts.values()) == 5


@pytest.fixture(scope="module")
def var_msmg3d():
    """The varcoef3d Galerkin hierarchy at 32 cells (finest grid 31³)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.fem import P1System, unit_cube_mesh
    from spacetime_tpu_torch.models import get_problem

    system = P1System.from_problem(get_problem("varcoef3d"),
                                   unit_cube_mesh(32))
    return GalerkinMultiShiftMultigrid.build(
        3, 32, system.A, system.M, nu=2, n_coarse=16)[0]


# ragged extents: one brick; bricks with a last plane / row of one point
# and a partial brick in x; 127³, whose W (123 MB in f32) does not fit in
# the L2, so the kernels take the row fastest (K14's and K15's marches
# too); K14's and K15's chunks as K6's and K7's in
# test_mg_kernels_3d_match_twins (a single coarse plane, nz = 2·2 + 1 with
# tiles cut in y and x, 13 × 35 × 67: ragged chunks and tiles)
@pytest.mark.parametrize("gs", [(7, 9, 15), (17, 25, 31), (127, 127, 127),
                                (3, 17, 33), (5, 19, 35), (13, 35, 67)])
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_var_kernels_3d_match_twins(var_msmg3d, dtype, nu, gs):
    """K10, K11, K12, K13 (and K9) in 3-D, the chained sweep above ν = 3,
    and K14/K15 at ν = 2 and 3."""
    kl = VarMSKernelLevel(var_msmg3d.levels[0], nu, nu_post=nu % 3 + 1, gs=gs)
    x, b, ec, cols, W = _var_inputs(var_msmg3d, kl, 5, dtype, nu)
    _check_semi_var(kl, x, b, ec, cols, W, dtype)
    _close(kl.residual(x, b, cols, W), kl.residual_plain(x, b, cols, W),
           dtype)
    _close(kl.apply_A(x, W), kl.apply_A_plain(x, W), dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K10 mg_smooth_var_3d {sfx}"] == 3
    for name in ("K11 mg_residual_var", "K12 mg_apply_var",
                 "K13 mg_residual_restrict_var", "K9 mg_prolong_correct"):
        assert counts[f"{name}_3d {sfx}"] == 1, (name, counts)
    assert sum(counts.values()) == 7
    # above the tiled sweep's ν ≤ 3 the sweep chains one-step launches
    kl4 = VarMSKernelLevel(var_msmg3d.levels[0], 4, gs=gs)
    mg_kernels.reset_launch_counts()
    _close(kl4.smooth(x, b, cols, W), kl4.smooth_plain(x, b, cols, W), dtype)
    assert mg_kernels.launch_counts()[f"K10 mg_cheb_step_var_3d {sfx}"] == 4
    kf = VarMSKernelLevel(var_msmg3d.levels[0], nu, gs=gs)
    assert kf.fused_ok == (nu > 1)
    if kf.fused_ok:
        mg_kernels.reset_launch_counts()
        for got, want in zip(kf.fused_pre(b, cols, W),
                             kf.fused_pre_plain(b, cols, W)):
            _close(got, want, dtype)
        _close(kf.fused_post(x, b, ec, cols, W),
               kf.fused_post_plain(x, b, ec, cols, W), dtype)
        counts = mg_kernels.launch_counts()
        for name in ("K14 mg_fused_pre_var", "K15 mg_fused_post_var"):
            assert counts[f"{name}_3d {sfx}"] == 1, (name, counts)
        assert sum(counts.values()) == 2


@pytest.mark.parametrize(
    "name, n, J, kw",
    [("varcoef3d", 8, 2, dict(mg_coarse=4)),
     ("varcoef2d", 16, 3, dict(mg_coarse=8, mg_nu_post=1))],
    ids=["varcoef3d-9^3x4", "varcoef2d-17^2x8-V(2,1)"])
def test_small_weighted_semi_solve_matches_cpu(var_msmg, name, n, J, kw):
    """float64 weighted solves: the card's kernels take the CPU twins'
    iterations. varcoef3d (ν = ν_post = 2) runs the fused K14/K15 on every
    level (and K11, K12), the 2-D V(2,1) the semi-fused K10, K13, K9; no
    other V-cycle kernel runs."""
    kw = dict(dtype=torch.float64, inner="mg", **kw)
    cpu = build_solver(name, n, J, device="cpu", **kw).solve(tol=1e-8)
    mg_kernels.reset_launch_counts()
    gpu = build_solver(name, n, J, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)
    counts = mg_kernels.launch_counts()
    if name == "varcoef3d":
        ops = ("K14 mg_fused_pre_var_3d", "K15 mg_fused_post_var_3d",
               "K11 mg_residual_var_3d", "K12 mg_apply_var_3d")
        assert counts["K14 mg_fused_pre_var_3d f64"] == counts[
            "K15 mg_fused_post_var_3d f64"]
    else:
        ops = ("K10 mg_smooth_var", "K11 mg_residual_var", "K12 mg_apply_var",
               "K13 mg_residual_restrict_var", "K9 mg_prolong_correct")
        assert counts["K10 mg_smooth_var f64"] == 2 * counts[
            "K13 mg_residual_restrict_var f64"]
    for op in ops:
        assert counts[f"{op} f64"] > 0, counts
    allowed = {f"{op} f64" for op in ops}
    assert all(c == 0 for k, c in counts.items() if k not in allowed), counts


# ν above the tiled sweeps' halo (8 in 2-D, 3 in 3-D): the K3 and K10
# wrappers chain ν one-step launches
@pytest.mark.parametrize("dim, nu", [(2, 9), (3, 4), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chained_sweeps_match_twins(msmg, msmg3d, var_msmg, var_msmg3d,
                                    dtype, dim, nu):
    T = 5
    gs = (15, 31) if dim == 2 else (7, 9, 15)
    d = "_3d" if dim == 3 else ""
    sfx = "f32" if dtype == torch.float32 else "f64"
    lev = (msmg if dim == 2 else msmg3d).levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
    x, b, _, cols = _level_inputs(msmg if dim == 2 else msmg3d, kl, T,
                                  dtype, nu)
    mg_kernels.reset_launch_counts()
    _close(kl.smooth(x, b, cols), kl.smooth_plain(x, b, cols), dtype)
    _close(kl.smooth(None, b, cols, zero_init=True),
           kl.smooth_plain(None, b, cols, zero_init=True), dtype)
    vk = VarMSKernelLevel((var_msmg if dim == 2 else var_msmg3d).levels[0],
                          nu, gs=gs)
    x, b, _, cols, W = _var_inputs(var_msmg if dim == 2 else var_msmg3d, vk,
                                   T, dtype, nu)
    _close(vk.smooth(x, b, cols, W), vk.smooth_plain(x, b, cols, W), dtype)
    _close(vk.smooth(None, b, cols, W, zero_init=True),
           vk.smooth_plain(None, b, cols, W, zero_init=True), dtype)
    counts = mg_kernels.launch_counts()
    assert counts[f"K3 mg_cheb_step{d} {sfx}"] == 2 * nu
    assert counts[f"K10 mg_cheb_step_var{d} {sfx}"] == 2 * nu
    assert sum(counts.values()) == 4 * nu


def test_small_3d_solve_nu4_matches_cpu(msmg3d):
    """smooth3d 9³×4 in float64 with ``mg_nu=4``: every sweep chains."""
    kw = dict(dtype=torch.float64, inner="mg", mg_nu=4)
    cpu = build_solver("smooth3d", 8, 2, device="cpu", **kw).solve(tol=1e-8)
    mg_kernels.reset_launch_counts()
    gpu = build_solver("smooth3d", 8, 2, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)
    counts = mg_kernels.launch_counts()
    assert counts["K3 mg_cheb_step_3d f64"] > 0
    assert counts["K3 mg_smooth_3d f64"] == 0


@pytest.fixture(scope="module")
def ell_mats():
    """Blocked-ELL matrices: the L-shape's A and M at n = 32 (m = 705, 6
    block rows × 3 slots) and a random one with m = 300 (not a multiple of
    128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import scipy.sparse as sp

    from spacetime_tpu_torch.fem import P1System, l_shape_mesh
    from spacetime_tpu_torch.ops.blocked_ell import BlockedEll

    system = P1System.from_mesh(l_shape_mesh(32))
    R = sp.random(300, 300, density=0.02, random_state=3, format="csr")
    return [BlockedEll.from_csr(A) for A in (system.A, system.M, R)]


# every time-row tile of csrc/ell.cu: 1 row per thread (T ≤ 8), 2 (≤ 16),
# 4 (≤ 32) and 8, at the variants' edges and a ragged last tile
@pytest.mark.parametrize("T", [1, 5, 16, 32, 33, 64, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_spmm_matches_twin(ell_mats, dtype, T):
    """K20 on the packed layout against the blocked twin (the blocks
    uploaded for the check), the packed twin and ``matvec_np``; the rows
    of ``apply_padded`` past the matrix are exactly 0; the operator's
    params hold no 128 × 128 block tensor."""
    rng = np.random.default_rng(T)
    spmv.reset_launch_counts()
    for ell in ell_mats:
        op = spmv.EllOperator(ell, dtype, "cuda")
        assert all(t.dim() < 3 for t in op.params.values())
        X = torch.as_tensor(rng.standard_normal((T, op.m)), dtype=dtype,
                            device="cuda")
        want = spmv.spmm_plain(
            X, torch.as_tensor(ell.blocks, dtype=dtype, device="cuda"),
            torch.as_tensor(ell.colidx, device="cuda"), op.m)
        got = op.apply(X)
        _close(got, want, dtype)
        _close(got, spmv.spmm_packed_plain(X, op.params, op.m), dtype)
        np.testing.assert_allclose(
            want.cpu().numpy(), ell.matvec_np(X.cpu().numpy()),
            rtol=0, atol=TOL[dtype] * float(want.abs().max()))
        Xp = torch.nn.functional.pad(X, (0, op.mp - op.m))
        got = op.apply_padded(Xp)
        assert got.shape == (T, op.nrb * ell.br)
        _close(got[:, :op.m], want, dtype)
        assert bool((got[:, op.m:] == 0).all())
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert spmv.launch_counts()[f"K20 ell_spmm {sfx}"] == 2 * len(ell_mats)


def test_ell_wrapper_checks_inputs(ell_mats):
    op = spmv.EllOperator(ell_mats[0], torch.float32, "cuda")
    X = torch.zeros((3, op.m), device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        op.apply(X.double())
    with pytest.raises(ValueError, match="contiguous"):
        op.apply(torch.zeros((op.m, 3), device="cuda").t())
    with pytest.raises(TypeError, match="float32 and float64"):
        op.apply(X.half())
    with pytest.raises(ValueError, match="n_out"):
        spmv.spmm(X, op.params, op.nrb * ell_mats[0].br + 1)


@pytest.mark.parametrize("inner", ["dense", "cheb"])
def test_small_ell_solve_matches_cpu(ell_mats, inner):
    """lshape2d 17²-cell L-shape, 8 steps, float64 on the "ell" format: the
    card's K20 and the CPU twin take the same iterations; every SpMV of A
    and M is K20 (f64 too, where the JAX package falls back to DIA)."""
    kw = dict(dtype=torch.float64, spatial_format="ell", inner=inner)
    cpu = build_solver("lshape2d", 16, 3, device="cpu", **kw).solve(tol=1e-8)
    spmv.reset_launch_counts()
    gpu = build_solver("lshape2d", 16, 3, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)
    assert spmv.launch_counts()["K20 ell_spmm f64"] > 0


@pytest.fixture(scope="module")
def flat_levels():
    """The fine level of the L-shape of 8 cells refined three times (m =
    2,945, bandwidth 65) and the aggregated ELL level (m = 511) of the
    64-cell L-shape's smoothed-aggregation hierarchy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.fem import (P1System, l_shape_mesh,
                                         refine_hierarchy)
    from spacetime_tpu_torch.ops.multigrid import (NestedMultiShiftMultigrid,
                                                   SAMultiShiftMultigrid)

    mesh = refine_hierarchy(l_shape_mesh(8), 3)
    s = P1System.from_mesh(mesh)
    nested, _ = NestedMultiShiftMultigrid.build(mesh, s.A, s.M, m_coarse=64)
    s = P1System.from_mesh(l_shape_mesh(64))
    sa, _ = SAMultiShiftMultigrid.build(s.A, s.M, m_coarse=300)
    return nested.levels[0], [lev for lev in sa.levels if lev.fmt == "ell"][0]


def _dia_inputs(lev, T, dtype, seed):
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    omega = np.abs(rng.standard_normal(T)) * 50.0
    lam = 1.1 * np.array([((lev.rsA + w * lev.rsM)
                           / (lev.dA + w * lev.dM)).max() for w in omega])
    cols = {"omega": mk(omega), "invT": mk(1.0 / (0.625 * lam)),
            "invDel": mk(1.0 / (0.375 * lam))}
    return (cols, mk(rng.standard_normal((T, lev.m))),
            mk(rng.standard_normal((T, lev.m))))


# K16 from 0 and from x at ν = 2, 1 and 4, and its post-sweep at ν_post =
# 3, 1 and 2
@pytest.mark.parametrize("nu, nu_post", [(2, 3), (1, 1), (4, 2)])
@pytest.mark.parametrize("T", [1, 9, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_kernels_match_twins(flat_levels, dtype, T, nu, nu_post):
    from spacetime_tpu_torch.ops import dia_kernels
    from spacetime_tpu_torch.ops.dia_kernels import DiaKernelLevel

    lev = flat_levels[0]
    kl = DiaKernelLevel(lev, nu, nu_post=nu_post)
    cols, x, b = _dia_inputs(lev, T, dtype, T)
    vals = kl.values(lev, dtype, "cuda")
    dia_kernels.reset_launch_counts()
    for zero_init, post in ((True, False), (False, False), (False, True)):
        _close(kl.smooth(x, b, cols, vals, zero_init=zero_init, post=post),
               kl.smooth_plain(x, b, cols, vals, zero_init, post), dtype)
    _close(kl.residual(x, b, cols, vals), kl.residual_plain(x, b, cols, vals),
           dtype)
    _close(kl.apply_A(x, vals), kl.apply_A_plain(x, vals), dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = dia_kernels.launch_counts()
    assert counts[f"K16 dia_smooth {sfx}"] == nu + nu + nu_post
    assert counts[f"K17 dia_residual {sfx}"] == 1
    assert counts[f"K18 dia_apply {sfx}"] == 1


@pytest.mark.parametrize("T", [1, 5, 16, 32, 33, 64, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_pair_and_transfers_match_twins(flat_levels, dtype, T):
    """K19 and the K20 transfers on an SA level against the blocked twins
    (the level's blocks uploaded for the check) and the packed twins."""
    lev = flat_levels[1]
    ek = spmv.EllKernelLevel(lev)
    v = ek.values(lev, dtype, "cuda")
    assert all(t.dim() < 3 for pv in v.values() for t in pv.values())
    blk = {k: (torch.as_tensor(c, device="cuda"),
               [torch.as_tensor(b, dtype=dtype, device="cuda") for b in bs])
           for k, (c, bs) in spmv.level_blocks(lev).items()}
    rng = np.random.default_rng(T)
    x = torch.as_tensor(rng.standard_normal((T, ek.m)), dtype=dtype,
                        device="cuda")
    e = torch.as_tensor(rng.standard_normal((T, ek.mc)), dtype=dtype,
                        device="cuda")
    spmv.reset_launch_counts()
    got = ek.op_pair(x, v)
    c, (bA, bM) = blk["op"]
    for want in (spmv.spmm_pair_plain(x, bA, bM, c, ek.m),
                 spmv.spmm_pair_packed_plain(x, v["op"], ek.m)):
        for g, w in zip(got, want):
            _close(g, w, dtype)
    got = ek.interp(e, v)
    c, (bP,) = blk["P"]
    _close(got, spmv.spmm_plain(e, bP, c, ek.m), dtype)
    _close(got, spmv.spmm_packed_plain(e, v["P"], ek.m), dtype)
    got = ek.restrict(x, v)
    c, (bR,) = blk["R"]
    _close(got, spmv.spmm_plain(x, bR, c, ek.mc), dtype)
    _close(got, spmv.spmm_packed_plain(x, v["R"], ek.mc), dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert spmv.launch_counts()[f"K19 ell_spmm_pair {sfx}"] == 1
    assert spmv.launch_counts()[f"K20 ell_spmm {sfx}"] == 2


def test_dia_wrappers_check_inputs(flat_levels):
    from spacetime_tpu_torch.ops.dia_kernels import DiaKernelLevel

    lev = flat_levels[0]
    kl = DiaKernelLevel(lev, 2)
    cols, x, b = _dia_inputs(lev, 3, torch.float32, 0)
    vals = kl.values(lev, torch.float32, "cuda")
    with pytest.raises(TypeError, match="dtype"):
        kl.residual(x.double(), b.double(), cols, vals)
    with pytest.raises(ValueError, match="shape"):
        kl.apply_A(x[:, :-1].contiguous(), vals)
    with pytest.raises(TypeError, match="float32 and float64"):
        kl.apply_A(x.half(), vals)


def _slab_vmask(E, rest, dtype):
    """A (1, E, *rest) validity field: the first plane and the last two
    invalid, as a slab at a mesh end with a padding plane has them."""
    m = torch.ones(E, dtype=dtype)
    m[[0, E - 2, E - 1]] = 0.0
    return m.reshape((1, E) + (1,) * len(rest)).expand(
        (1, E) + rest).contiguous().cuda()


# (own, other extents): one brick on the lead axis, and several with a
# ragged last one; in 3-D the sharded K7 marches through chunks of 4 fine
# planes at T = 5, so every slab (10 to 26 planes) crosses chunk edges, at
# odd and even h, and the third cuts its tiles in y and x
SLABS = {2: [(8, (15,)), (40, (33,)), (24, (35,))],
         3: [(4, (7, 9)), (12, (9, 33)), (16, (19, 35))]}


@pytest.mark.parametrize("slab", [0, 1, 2])
@pytest.mark.parametrize("dim, nu, h", [(2, 2, 3), (2, 3, 4), (2, 3, 5),
                                        (3, 2, 3), (3, 2, 4), (3, 3, 4),
                                        (3, 3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_kernels_match_twins(msmg, msmg3d, dtype, dim, nu, h, slab):
    """The sharded-slab forms (K3 with vmask, K6/K7/K8/K9 with lead) at the
    least coarse halos, odd and even h."""
    T = 5
    own, rest = SLABS[dim][slab]
    gs = (own + 2 * h,) + rest
    ms = msmg if dim == 2 else msmg3d
    lev = ms.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
    x, b, _, cols = _level_inputs(ms, kl, T, dtype, 10 * nu + h)
    rng = np.random.default_rng(h)
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    crest = kl.coarse_gs[1:]
    hc = (h + 2) // 2
    ec = mk(rng.standard_normal((T, own // 2 + 2 * hc) + crest))
    ec1 = mk(rng.standard_normal((T, own // 2 + 2) + crest))
    x_own = mk(rng.standard_normal((T, own) + rest))
    vm = _slab_vmask(gs[0], rest, dtype)
    mg_kernels.reset_launch_counts()
    _close(kl.smooth(x, b, cols, vmask=vm),
           kl.smooth_plain(x, b, cols, vmask=vm), dtype)
    _close(kl.smooth(None, b, cols, zero_init=True, vmask=vm),
           kl.smooth_plain(None, b, cols, zero_init=True, vmask=vm), dtype)
    for got, want in zip(kl.sh_fused_pre(b, cols, vm, own, h),
                         kl.sh_fused_pre_plain(b, cols, vm, own, h)):
        _close(got, want, dtype)
    _close(kl.sh_fused_post(x, b, ec, cols, vm, own, h, hc),
           kl.sh_fused_post_plain(x, b, ec, cols, vm, own, h, hc), dtype)
    _close(kl.sh_residual_restrict(x, b, cols, own, h),
           kl.sh_residual_restrict_plain(x, b, cols, own, h), dtype)
    _close(kl.sh_prolong_correct(x_own, ec1, own, 1),
           kl.sh_prolong_correct_plain(x_own, ec1, own, 1), dtype)
    d = "_3d" if dim == 3 else ""
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K3 mg_sh_smooth{d} {sfx}"] == 2
    for name in ("K6 mg_sh_fused_pre", "K7 mg_sh_fused_post",
                 "K8 mg_sh_residual_restrict", "K9 mg_sh_prolong_correct"):
        assert counts[f"{name}{d} {sfx}"] == 1, (name, counts)
    assert sum(counts.values()) == 6


# The 2-D K6 and K7 march in y: the flagship's levels at K_X's rows, a
# ragged grid, one coarse row, and rows wider than one segment of the
# march (two, the second ragged; two, the last 993 columns wide: a column
# left past a multiple of the segment joins the last); each at chunks of
# one row (one coarse row for K6) to the whole column, the wrapper's pick
# among them
ROW_MARCH = [(129, (511, 511)), (129, (255, 255)), (65, (127, 127)),
             (129, (63, 63)), (5, (15, 31)), (3, (3, 17)), (3, (9, 1055)),
             (3, (9, 1985))]


def _chunks_of(kl, b, n, stage, least):
    """{1, least, the wrapper's chunk on field b, the whole column}."""
    return sorted({1, least, kl._chunk(b, n, stage), max(n, 1)})


@pytest.mark.parametrize("shape", ROW_MARCH,
                         ids=lambda s: "x".join(map(str, (s[0],) + s[1])))
@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_march_matches_twins(msmg, dtype, nu, shape):
    T, gs = shape
    lev = msmg.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
    x, b, ec, cols = _level_inputs(msmg, kl, T, dtype, nu)
    pre, post = kl.fused_pre_plain(b, cols), kl.fused_post_plain(x, b, ec,
                                                                 cols)
    chunks = {st: _chunks_of(kl, b, n, st, least)
              for st, n, least in (("pre", kl.coarse_gs[0], 2),
                                   ("post", gs[0], 4))}
    mg_kernels.reset_launch_counts()
    for chunk in chunks["pre"]:
        kl._chunk = lambda *_, c=chunk: c
        for got, want in zip(kl.fused_pre(b, cols), pre):
            _close(got, want, dtype)
    for chunk in chunks["post"]:
        kl._chunk = lambda *_, c=chunk: c
        _close(kl.fused_post(x, b, ec, cols), post, dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K6 mg_fused_pre {sfx}"] == len(chunks["pre"])
    assert counts[f"K7 mg_fused_post {sfx}"] == len(chunks["post"])
    assert sum(counts.values()) == len(chunks["pre"]) + len(chunks["post"])


# (T, own, h, other extents): the (2 × 2) flagship's finest slab (h = ν +
# 1, its mesh's halo) and small ones, the last two rows wider than one
# segment
ROW_SLABS = [(65, 256, 0, (511,)), (5, 4, 3, (15,)), (5, 12, 4, (33,)),
             (5, 6, 5, (1055,)), (5, 6, 5, (1985,))]


@pytest.mark.parametrize("slab", ROW_SLABS,
                         ids=lambda s: f"T{s[0]}-own{s[1]}-h{s[2]}-{s[3][0]}")
@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_row_march_matches_twins(msmg, dtype, nu, slab):
    """The 2-D sharded K6 and K7 (``lead``) at chunks of one row to the
    whole slab; h at least ν + 1."""
    T, own, h, rest = slab
    h = max(h, nu + 1)
    gs = (own + 2 * h,) + rest
    lev = msmg.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
    x, b, _, cols = _level_inputs(msmg, kl, T, dtype, 10 * nu + h)
    rng = np.random.default_rng(h)
    hc = (h + 2) // 2
    ec = torch.as_tensor(
        rng.standard_normal((T, own // 2 + 2 * hc) + kl.coarse_gs[1:]),
        dtype=dtype, device="cuda")
    vm = _slab_vmask(gs[0], rest, dtype)
    pre = kl.sh_fused_pre_plain(b, cols, vm, own, h)
    post = kl.sh_fused_post_plain(x, b, ec, cols, vm, own, h, hc)
    chunks = {st: _chunks_of(kl, b, n, st, least)
              for st, n, least in (("pre", own // 2, 2),
                                   ("post", gs[0], 4))}
    mg_kernels.reset_launch_counts()
    for chunk in chunks["pre"]:
        kl._chunk = lambda *_, c=chunk: c
        for got, want in zip(kl.sh_fused_pre(b, cols, vm, own, h), pre):
            _close(got, want, dtype)
    for chunk in chunks["post"]:
        kl._chunk = lambda *_, c=chunk: c
        _close(kl.sh_fused_post(x, b, ec, cols, vm, own, h, hc), post, dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    counts = mg_kernels.launch_counts()
    assert counts[f"K6 mg_sh_fused_pre {sfx}"] == len(chunks["pre"])
    assert counts[f"K7 mg_sh_fused_post {sfx}"] == len(chunks["post"])


@pytest.mark.parametrize("dim, nu", [(2, 9), (3, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_chained_sweep_matches_twin(msmg, msmg3d, dtype, dim, nu):
    """Above the tiled ν the vmask sweep chains mg_cheb_step with the
    field."""
    T = 5
    own, rest = SLABS[dim][1]
    gs = (own + 2 * (nu + 1),) + rest
    ms = msmg if dim == 2 else msmg3d
    lev = ms.levels[0]
    kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
    x, b, _, cols = _level_inputs(ms, kl, T, dtype, nu)
    vm = _slab_vmask(gs[0], rest, dtype)
    mg_kernels.reset_launch_counts()
    _close(kl.smooth(x, b, cols, vmask=vm),
           kl.smooth_plain(x, b, cols, vmask=vm), dtype)
    _close(kl.smooth(None, b, cols, zero_init=True, vmask=vm),
           kl.smooth_plain(None, b, cols, zero_init=True, vmask=vm), dtype)
    d = "_3d" if dim == 3 else ""
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert mg_kernels.launch_counts()[f"K3 mg_cheb_step{d} {sfx}"] == 2 * nu


@pytest.mark.parametrize("name, kw", [
    ("nested", dict(refine=2, inner="mg")),
    ("amg", dict(inner="amg", mg_coarse=300)),
])
def test_small_flat_mg_solve_matches_cpu(flat_levels, name, kw):
    """float64 L-shape solves with the nested hierarchy (8 cells refined
    twice) and the SA hierarchy (64 cells, an ELL level), 4 steps: the
    card's K16–K20 and the CPU twins take the same iterations."""
    from spacetime_tpu_torch.ops import dia_kernels

    n = 8 if name == "nested" else 64
    cpu = build_solver("lshape2d", n, 2, device="cpu", **kw).solve(tol=1e-8)
    dia_kernels.reset_launch_counts()
    spmv.reset_launch_counts()
    gpu = build_solver("lshape2d", n, 2, device="cuda", **kw).solve(tol=1e-8)
    assert gpu.iterations == cpu.iterations
    np.testing.assert_allclose(gpu.residuals, cpu.residuals, rtol=1e-10)
    counts = {**dia_kernels.launch_counts(), **spmv.launch_counts()}
    for k in ("K16 dia_smooth", "K17 dia_residual", "K18 dia_apply"):
        assert counts[f"{k} f64"] > 0, k
    if name == "amg":
        assert counts["K19 ell_spmm_pair f64"] > 0
        assert counts["K20 ell_spmm f64"] > 0


def test_two_rank_gloo_solve_matches_serial(msmg):
    """A (time 1 × space 2) mesh of two ranks on the card over gloo (the
    halos through host memory): the float64 smooth2d 17² × 16 solve takes
    the serial port's iterations and history, and its one sharded level
    runs the fused sharded stages K6/K7 (lead)."""
    from spacetime_tpu_torch.ops import native
    from spacetime_tpu_torch.parallel import make_spacetime_mesh
    from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

    native.build()  # the ranks load this build
    spec = {"problem": "smooth2d", "space_n": 16, "time_levels": 4,
            "kw": {"inner": "mg", "space_n": 16},
            "runs": [("solve", {"tol": 1e-8, "compute_error": False})]}
    (out,) = spawn_ranks(solve_specs, make_spacetime_mesh(1, 2), "gloo",
                         ([spec],))
    ref = build_solver("smooth2d", 16, 4, device="cuda", inner="mg").solve(
        tol=1e-8, compute_error=False)
    r = out["runs"][0]
    assert out["info"]["sp_depth"] == 1 and out["info"]["device"] == "cuda:0"
    assert r["iterations"] == ref.iterations
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)
    np.testing.assert_allclose(r["U"], ref.U, atol=1e-10)
    assert r["launches"]["K6 mg_sh_fused_pre f64"] > 0
    assert r["launches"]["K7 mg_sh_fused_post f64"] > 0
    assert r["bytes_staged"] > 0
