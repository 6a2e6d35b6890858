"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all of
them at once, and the objects are linked into one shared library with a
plain C interface, ``build/spacetime_tpu_torch/libspacetime_kernels.so``
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spacetime_tpu_torch"
LIBRARY = BUILD_DIR / "libspacetime_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

MAX_GROUPS = 16
MAX_TAPS = 32
MAX_VAR_TAPS = 27  # the 3^d neighbourhood
MAX_DIAG = 64  # the union offsets of a DIA level (csrc/dia.cu)


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


class PairGroupsStruct(ctypes.Structure):
    """ctypes mirror of ``struct PairGroups`` in csrc/mg.cu."""

    _fields_ = [
        ("n_groups", ctypes.c_int),
        ("start", ctypes.c_int * (MAX_GROUPS + 1)),
        ("wa", ctypes.c_double * MAX_GROUPS),
        ("wm", ctypes.c_double * MAX_GROUPS),
        ("dz", ctypes.c_int * MAX_TAPS),
        ("dy", ctypes.c_int * MAX_TAPS),
        ("dx", ctypes.c_int * MAX_TAPS),
    ]


def pair_groups_struct(pairs, dim: int) -> PairGroupsStruct:
    """The (wA, wM) pair groups of two stencils
    (((wa, wm), (disp, ...)), ...), in the order of
    ``ops.multigrid.pair_groups``, as a tap table; 2-D displacements get
    dz = 0."""
    ntaps = sum(len(ds) for _, ds in pairs)
    if len(pairs) > MAX_GROUPS or ntaps > MAX_TAPS:
        raise ValueError(
            f"stencil pair has {len(pairs)} groups / {ntaps} taps; the kernel "
            f"table holds {MAX_GROUPS} / {MAX_TAPS}"
        )
    st = PairGroupsStruct()
    st.n_groups = len(pairs)
    k = 0
    for g, ((wa, wm), ds) in enumerate(pairs):
        st.start[g] = k
        st.wa[g], st.wm[g] = wa, wm
        for d in ds:
            st.dz[k], st.dy[k], st.dx[k] = (0,) * (3 - dim) + tuple(d)
            k += 1
    st.start[len(pairs)] = k
    return st


class VarTapsStruct(ctypes.Structure):
    """ctypes mirror of ``struct VarTaps`` in csrc/mg.cu."""

    _fields_ = [
        ("n_taps", ctypes.c_int),
        ("kc", ctypes.c_int),
        ("cm", ctypes.c_double),
        ("dz", ctypes.c_int * MAX_VAR_TAPS),
        ("dy", ctypes.c_int * MAX_VAR_TAPS),
        ("dx", ctypes.c_int * MAX_VAR_TAPS),
    ]


def var_taps_struct(disps, kc: int, cm: float, dim: int) -> VarTapsStruct:
    """The displacements of a weighted stencil, in the order of its weight
    arrays, the index ``kc`` of the center tap and the mass's center weight
    ``cm``; 2-D displacements get dz = 0."""
    if len(disps) > MAX_VAR_TAPS:
        raise ValueError(f"weighted stencil has {len(disps)} taps; the kernel "
                         f"table holds {MAX_VAR_TAPS}")
    st = VarTapsStruct()
    st.n_taps, st.kc, st.cm = len(disps), kc, cm
    for k, d in enumerate(disps):
        st.dz[k], st.dy[k], st.dx[k] = (0,) * (3 - dim) + tuple(d)
    return st


class DiaOffsetsStruct(ctypes.Structure):
    """ctypes mirror of ``struct DiaOffsets`` in csrc/dia.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("off", ctypes.c_int * MAX_DIAG),
    ]


def dia_offsets_struct(offsets) -> DiaOffsetsStruct:
    """The sorted union offsets of a DIA level."""
    if not 1 <= len(offsets) <= MAX_DIAG:
        raise ValueError(f"{len(offsets)} diagonals; the DIA kernels take 1 "
                         f"to {MAX_DIAG}")
    st = DiaOffsetsStruct()
    st.n = len(offsets)
    for k, o in enumerate(offsets):
        st.off[k] = o
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
    returns its path. One nvcc process per source, all started together,
    then one link."""
    sources = sorted(CSRC.glob("*.cu"))
    inputs = sources + sorted(CSRC.glob("*.cuh"))
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(
        p.stat().st_mtime for p in inputs
    ):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objects = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources]
    jobs = [
        (cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)
        )
    ]
    log = []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for _, other in jobs:
                other.kill()
                other.wait()
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{out}"
            )
    tmp = BUILD_DIR / f".{LIBRARY.name}.{tag}"
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objects:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed with exit code {proc.returncode}: "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIBRARY)
    if state is not None:
        state.build_seconds = time.perf_counter() - t0
        state.build_log = "".join(log) + proc.stdout + proc.stderr
    return LIBRARY


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    D = ctypes.c_double
    grid = (I64, I64, I64, I64, I)
    lib.spacetime_error_string.argtypes = [I]
    lib.spacetime_error_string.restype = ctypes.c_char_p
    for sfx in ("f32", "f64"):
        signatures = {
            # kron.cu
            "kron_B": [P, P, P, P, P, I64, I64, I64, I64, P, P, I, P],
            "kron_BT": [P, P, P, P, I64, I64, I64, I64, P, P, I, P],
            # mg.cu
            # (nt, nz, ny, nx, dim): the grid, nz = 1 in 2-D
            "mg_smooth": [P, P, P, P, P, P, P, *grid, P, I, I, P],
            "mg_residual": [P, P, P, P, *grid, P, P],
            "mg_apply": [P, P, *grid, P, P],
            # the fused stages: ν, then the planes (rows in 2-D) a block of
            # the march walks (K6 coarse, K7 fine)
            "mg_fused_pre": [P, P, P, P, P, P, P, *grid, P, I, I, P],
            "mg_fused_post": [P, P, P, P, P, P, P, P, *grid, P, I, I, P],
            "mg_residual_restrict": [P, P, P, P, *grid, P, P],
            "mg_prolong_correct": [P, P, P, *grid, P],
            # the sharded-slab forms: vm after the fields; (own, h[, hc])
            # after the table and ν, then the fused ones' march chunk
            "mg_sh_smooth": [P, P, P, P, P, P, P, P, *grid, P, I, I, P],
            "mg_sh_fused_pre": [P, P, P, P, P, P, P, P, *grid, P, I, I, I, I,
                                P],
            "mg_sh_fused_post": [P, P, P, P, P, P, P, P, P, *grid, P, I, I, I,
                                 I, I, P],
            "mg_sh_residual_restrict": [P, P, P, P, *grid, P, I, I, P],
            "mg_sh_prolong_correct": [P, P, P, *grid, I, I, P],
            # the weighted ones: W after the fields; the A taps and the M
            # groups after the grid
            "mg_smooth_var": [P, P, P, P, P, P, P, *grid, P, P, I, I, P],
            "mg_residual_var": [P, P, P, P, P, *grid, P, P, P],
            "mg_apply_var": [P, P, P, *grid, P, P],
            "mg_residual_restrict_var": [P, P, P, P, P, *grid, P, P, P],
            "mg_fused_pre_var": [P, P, P, P, P, P, P, *grid, P, P, I, I, P],
            "mg_fused_post_var": [P, P, P, P, P, P, P, P, *grid, P, P, I, I,
                                  P],
            # one Chebyshev step of the K3 / K10 chains (ν above MAX_NU):
            # x, b, vm (K3) or W (K10), the columns, r, d_in, d_out, x_out,
            # the grid, the tables, first, c1, c2
            "mg_cheb_step": [P, P, P, P, P, P, P, P, P, P, P, *grid, P, I, D,
                             D, P],
            "mg_cheb_step_var": [P, P, P, P, P, P, P, P, P, P, *grid, P, P, I,
                                 D, D, P],
            # ell.cu: X, nt, n, slice_ptr, col, vals, nslices, Y, n_out
            "ell_spmm": [P, I64, I64, P, P, P, I64, P, I64, P],
            # X, nt, n, slice_ptr, col, valsA, valsM, nslices, YA, YM, n_out
            "ell_spmm_pair": [P, I64, I64, P, P, P, P, I64, P, P, I64, P],
            # dia.cu, one K16 step: x, b, vA, vM, dA, dM, the columns, r,
            # d_in, d_out, x_out, nt, m, the offsets, first, c1, c2
            "dia_smooth": [P, P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, P,
                           I, D, D, P],
            "dia_residual": [P, P, P, P, P, P, I64, I64, P, P],
            "dia_apply": [P, P, P, I64, I64, P, P],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = argtypes
            fn.restype = I
    lib.mg_march_occupancy.argtypes = [I, I, I, I, P, P]
    lib.mg_march_occupancy.restype = I
    # the 2-D march's: post, ν, f64, nx, then blocks, bytes, threads, nseg
    lib.mg_march2_occupancy.argtypes = [I, I, I, I, P, P, P, P]
    lib.mg_march2_occupancy.restype = I
    for size_fn, struct in (("kron_taps_size", TapsStruct),
                            ("mg_pairs_size", PairGroupsStruct),
                            ("mg_var_taps_size", VarTapsStruct),
                            ("dia_offsets_size", DiaOffsetsStruct)):
        fn = getattr(lib, size_fn)
        fn.argtypes = []
        fn.restype = I
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{size_fn}: {fn()} bytes in the library but "
                f"{ctypes.sizeof(struct)} in {struct.__name__}"
            )
    return lib


LIB = _Library()


def check(lib: ctypes.CDLL, symbol: str, err: int) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if err != 0:
        msg = lib.spacetime_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA launch failed: error {err} ({msg})")


class Kernel:
    """One entry point of the library (one kernel and dtype) and its count
    of launches, which ``launch`` alone raises."""

    def __init__(self, name: str, symbol: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0

    def launch(self, device, *args) -> None:
        """Call the entry point with ``args`` and ``device``'s current
        stream; raise on a launch error, else count the launch."""
        lib = LIB.get()
        with torch.cuda.device(device):
            err = getattr(lib, self.symbol)(
                *args, torch.cuda.current_stream(device).cuda_stream
            )
        check(lib, self.symbol, err)
        self.launches += 1


def kernel_for(kernels: dict, family: str, op: str, X, *key) -> Kernel:
    """The ``kernels[(op, X.dtype, *key)]`` that a CUDA tensor X launches;
    raises for any other device (CPU tensors run the plain twins before
    this) and for a dtype without a kernel."""
    if X.device.type != "cuda":
        raise ValueError(
            f"no {family} kernel for device {X.device}; CUDA tensors launch "
            "the kernel and CPU tensors run the plain twin"
        )
    k = kernels.get((op, X.dtype, *key))
    if k is None:
        raise TypeError(
            f"the {family} kernels take float32 and float64, not {X.dtype}")
    return k


def check_tensor(name, t, dtype, device, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of this device, dtype and
    shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
