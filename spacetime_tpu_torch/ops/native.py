"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into one shared library
with a plain C interface, ``build/spacetime_tpu_torch/libspacetime_kernels.so``
under the repository root, at first use and again whenever a source is newer
than the library. The library is loaded with ``ctypes``: pointers and the
CUDA stream are passed as ``c_void_p``, and each entry point returns the
launch's ``cudaError_t``. A failed build raises with the compiler's output.

Nothing here touches CUDA at import time, so CPU-only installations import
the module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spacetime_tpu_torch"
LIBRARY = BUILD_DIR / "libspacetime_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

MAX_GROUPS = 16
MAX_TAPS = 32


class TapsStruct(ctypes.Structure):
    """ctypes mirror of ``struct Taps`` in csrc/kron.cu."""

    _fields_ = [
        ("n_groups", ctypes.c_int),
        ("start", ctypes.c_int * (MAX_GROUPS + 1)),
        ("weight", ctypes.c_double * MAX_GROUPS),
        ("dz", ctypes.c_int * MAX_TAPS),
        ("dy", ctypes.c_int * MAX_TAPS),
        ("dx", ctypes.c_int * MAX_TAPS),
    ]


def taps_struct(groups, dim: int) -> TapsStruct:
    """The weight groups of a stencil ((w, (disp, ...)), ...) as a tap
    table; 2-D displacements get dz = 0."""
    ntaps = sum(len(ds) for _, ds in groups)
    if len(groups) > MAX_GROUPS or ntaps > MAX_TAPS:
        raise ValueError(
            f"stencil has {len(groups)} groups / {ntaps} taps; the kernel "
            f"table holds {MAX_GROUPS} / {MAX_TAPS}"
        )
    st = TapsStruct()
    st.n_groups = len(groups)
    k = 0
    for g, (w, ds) in enumerate(groups):
        st.start[g] = k
        st.weight[g] = w
        for d in ds:
            dz, dy, dx = (0,) * (3 - dim) + tuple(d)
            st.dz[k], st.dy[k], st.dx[k] = dz, dy, dx
            k += 1
    st.start[len(groups)] = k
    return st


class _Library:
    """The loaded kernel library and the log and seconds of its build."""

    def __init__(self):
        self.build_seconds = 0.0
        self.build_log = ""
        self.path = None
        self._lib = None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            self.path = build(self)
            self._lib = _bind(ctypes.CDLL(str(self.path)))
        return self._lib


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if home is None or not (Path(home) / "bin" / "nvcc").exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH, in CUDA_HOME/CUDA_PATH and in "
            "torch's CUDA_HOME); the CUDA kernels need the CUDA toolkit"
        )
    return str(Path(home) / "bin" / "nvcc")


def build(state: _Library | None = None) -> Path:
    """Compile csrc/*.cu into LIBRARY unless it is newer than every source;
    returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    inputs = sources + sorted(CSRC.glob("*.cuh"))
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(
        p.stat().st_mtime for p in inputs
    ):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIBRARY.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIBRARY)
    if state is not None:
        state.build_seconds = time.perf_counter() - t0
        state.build_log = proc.stdout + proc.stderr
    return LIBRARY


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kron_taps_size.argtypes = []
    lib.kron_taps_size.restype = I
    lib.kron_error_string.argtypes = [I]
    lib.kron_error_string.restype = ctypes.c_char_p
    for name in ("kron_B_f32", "kron_B_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, P, I64, I64, I64, I64, P, P, I, P]
        fn.restype = I
    for name in ("kron_BT_f32", "kron_BT_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, I64, I64, I64, I64, P, P, I, P]
        fn.restype = I
    if lib.kron_taps_size() != ctypes.sizeof(TapsStruct):
        raise RuntimeError(
            f"struct Taps is {lib.kron_taps_size()} bytes in the library but "
            f"{ctypes.sizeof(TapsStruct)} in TapsStruct"
        )
    return lib


LIB = _Library()


def check(lib: ctypes.CDLL, symbol: str, err: int) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if err != 0:
        msg = lib.kron_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA launch failed: error {err} ({msg})")
