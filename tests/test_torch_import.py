"""The PyTorch port imports without JAX and without the JAX package, refuses
a missing GPU, and runs the plain twins (not the kernels) on CPU tensors."""

import ast
import os
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


def _imports_of(path: Path) -> list[str]:
    """The modules an ``import`` / ``from ... import`` statement of the file
    names (absolute imports only)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_sources_do_not_import_the_jax_package():
    files = sorted((REPO / "spacetime_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 25
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imports_of(f)
        if name.split(".")[0] in ("spacetime_tpu", "jax", "jaxlib")
    ]
    assert not bad, bad


_NO_JAX_PACKAGE = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "spacetime_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import spacetime_tpu_torch
    from spacetime_tpu_torch.solver import build_solver

    for mod in pkgutil.walk_packages(
        spacetime_tpu_torch.__path__, "spacetime_tpu_torch."
    ):
        if not mod.name.endswith("__main__"):
            importlib.import_module(mod.name)
    its = []
    for name, n, kw in (("smooth2d", 8, {"inner": "mg"}),
                        ("smooth3d", 8, {"inner": "mg"}),
                        ("varcoef2d", 8, {"inner": "mg"}),
                        ("varcoef3d", 8, {"inner": "mg"}),
                        ("smooth2d", 8, {"inner": "dense"}),
                        ("lshape2d", 8, {"spatial_format": "ell",
                                         "inner": "cheb"}),
                        ("lshape2d", 8, {"refine": 2, "inner": "mg"}),
                        ("lshape2d", 24, {"inner": "amg"}),
                        ("singular3d", 8, {"inner": "mg",
                                           "extra_time_levels": 2})):
        res = build_solver(name, n, 2, device="cpu", **kw).solve(tol=1e-8)
        assert res.converged and res.l2_error > 0, name
        its.append(res.iterations)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "spacetime_tpu"))
    assert not loaded, loaded
    print(*its)
    """
)


def test_solves_without_the_jax_package():
    """Every port module imports, and a 2-D, a 3-D and weighted 2-D and
    3-D (varcoef2d, varcoef3d) multigrid solves, a dense one, an L-shape
    solve on the blocked-ELL format with Chebyshev inner solves, and
    L-shape solves with the nested (refined twice) and the smoothed-
    aggregation hierarchies, and a singular3d multigrid solve on a graded
    time grid run, with the JAX package and JAX blocked from import."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PACKAGE],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert all(int(k) > 0 for k in out.stdout.split())


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
        build_solver("lshape2d", 8, 2, device="cpu", rhs="device")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver.solve_refined(legs="ds")


def _c_entry_points() -> dict:
    """{symbol: [ctypes type, ...]} of the C entry points of csrc/*.cu (the
    ``_##SFX`` macros expanded for f32 and f64)."""
    import ctypes
    import re

    kinds = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
             "double": ctypes.c_double}
    out = {}
    for src in sorted((REPO / "spacetime_tpu_torch" / "csrc").glob("*.cu")):
        text = src.read_text().replace("\\\n", " ")
        block = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"\bint\s+([\w#]+)\s*\(([^)]*)\)\s*\{",
                                       block):
            types = []
            for p in filter(None, (q.strip() for q in params.split(","))):
                types.append(ctypes.c_void_p if "*" in p
                             else kinds[p.rsplit(None, 1)[0]])
            for sfx in ("f32", "f64"):
                out[name.replace("##SFX", sfx)] = types
    return out


def test_bound_signatures_match_the_sources():
    """Every symbol ``ops.native`` binds is a C entry point of csrc/ with the
    argument types it is bound with."""
    import ctypes

    from spacetime_tpu_torch.ops import native

    sizes = {"kron_taps_size": native.TapsStruct,
             "mg_pairs_size": native.PairGroupsStruct,
             "mg_var_taps_size": native.VarTapsStruct,
             "dia_offsets_size": native.DiaOffsetsStruct}

    class Fn:
        def __init__(self, name):
            self.name = name

        def __call__(self):
            return ctypes.sizeof(sizes[self.name])

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, Fn(name))

    lib = Lib()
    native._bind(lib)
    entries = _c_entry_points()
    bound = {n: f for n, f in lib.fns.items() if hasattr(f, "argtypes")
             and n not in ("spacetime_error_string",)}
    assert {"dia_smooth_f32", "ell_spmm_pair_f64", "mg_smooth_f32"} <= set(
        bound)
    for name, fn in bound.items():
        assert name in entries, name
        assert fn.argtypes == entries[name], name


_MESH_NO_JAX = textwrap.dedent(
    """
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "spacetime_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    from spacetime_tpu_torch.parallel import make_spacetime_mesh
    from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

    if __name__ == "__main__":
        spec = {"problem": "smooth2d", "space_n": 16, "time_levels": 3,
                "kw": {"inner": "mg", "space_n": 16}}
        (out,) = spawn_ranks(solve_specs, make_spacetime_mesh(2, 2, "cpu"),
                             "gloo", ([spec],))
        r = out["runs"][0]
        assert r["converged"] and out["info"]["foreign"] == [], out["info"]
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib",
                                               "spacetime_tpu"))
        assert not loaded, loaded
        print(r["iterations"])
    """
)


def test_mesh_ranks_solve_without_the_jax_package(tmp_path):
    """A (2 × 2) mesh of spawned CPU ranks solves with the JAX package and
    JAX blocked from import in the parent; the ranks report no JAX loaded
    (they are fresh processes that import the port alone)."""
    script = tmp_path / "mesh_no_jax.py"
    script.write_text(_MESH_NO_JAX)
    out = subprocess.run(
        [sys.executable, str(script)], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 0
