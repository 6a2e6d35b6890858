"""The CUDA kernels K1 (B) and K2 (Bᵀ) on the card, against their plain
twins. Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is
False (the kernels have no CPU mode). This file imports no JAX, so on a
machine with a GPU and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops import kron
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
