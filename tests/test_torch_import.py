"""The PyTorch port imports without JAX, refuses a missing GPU, and runs the
plain twins (not the kernels) on CPU tensors."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops import kron
from spacetime_tpu_torch.solver import build_solver
from spacetime_tpu_torch.utils import resolve_device

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, BlockJax())
    import spacetime_tpu_torch

    names = ["spacetime_tpu_torch"]
    for mod in pkgutil.walk_packages(
        spacetime_tpu_torch.__path__, "spacetime_tpu_torch."
    ):
        if not mod.name.endswith("__main__"):
            importlib.import_module(mod.name)
            names.append(mod.name)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    assert not loaded, loaded
    print(len(names))
    """
)


def test_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    # the package, its four subpackages and their modules
    assert int(out.stdout.strip()) >= 15


def test_cuda_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_solver("smooth2d", 8, 2, device="cuda", inner="mg")


def test_tf32_off_after_resolve():
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cpu_tensor_runs_twin_without_launch():
    solver = build_solver("smooth2d", 8, 2, device="cpu", inner="mg")
    rng = np.random.default_rng(0)
    T = solver.N
    U = torch.as_tensor(rng.standard_normal((T + 1,) + solver.gs))
    V = torch.as_tensor(rng.standard_normal((T,) + solver.gs))
    kp = solver.params["kron"]
    kron.reset_launch_counts()
    out = kron.apply_B(U, kp["h128"], solver.taps)
    torch.testing.assert_close(
        out, kron.apply_B_plain(U, kp["h128"], solver.taps), rtol=0, atol=0
    )
    Vb, W = kron.apply_B_stab(U, kp["h128"], kp["hs128"], solver.taps)
    kron.apply_BT(V, kp["h128"], solver.taps)
    kron.apply_BT_stab(Vb, W, kp["h128"], solver.taps)
    solver.apply_S(U)
    assert all(n == 0 for n in kron.launch_counts().values())


def test_unsupported_device_and_dtype_raise():
    solver = build_solver("smooth2d", 8, 2, device="cpu", inner="mg")
    U = torch.zeros((solver.N + 1,) + solver.gs, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors launch the kernel"):
        kron.apply_B(U, solver.params["kron"]["h128"], solver.taps)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_solver("smooth2d", 8, 2, device="cpu", inner="dense")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver.solve_refined(legs="ds")
