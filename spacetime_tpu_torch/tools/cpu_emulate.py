"""The CUDA kernels of csrc/ run on the CPU, to check a kernel's logic on a
machine without a GPU or nvcc.

    python -m spacetime_tpu_torch.tools.cpu_emulate [--parent DIR]
        [--only fused|kron|stencil|dia|var_stencil]

Each source of ``spacetime_tpu_torch/csrc`` is translated to C++ (a launch
``k<<<grid, block, smem, stream>>>(args)`` becomes a call that runs the
grid's blocks in order, each block's threads as ``std::thread``s that meet
at a ``std::barrier`` for ``__syncthreads()``, with the block's dynamic
shared memory filled with 0xff bytes, a NaN in either float type) and
compiled with g++ (C++20, ``-ffp-contract=off``: no FMA contraction, so
two sources that sum alike agree bit for bit) into one library under
``build/cpu_emulate/``. The entry points take host pointers (CPU tensors'
``data_ptr()``) and the stream is ignored. Registers, occupancy and
``__launch_bounds__`` have no meaning here, and nothing is timed.

The check it runs: the fused stages K6, K7, K14 and K15 in 2-D and 3-D
and the sharded K6 (2-D) and K7 (2-D and 3-D) on ragged grids and slabs
(ν ∈ {2, 3}, float32 and float64; in 2-D a row wider than one segment of
the march), with the marches' chunks of 1 row (plane) to the whole
column, the 3-D weighted ones in both row orders (the stand-in's L2 is
the H100's 50 MB, or ``EMU_L2_BYTES``: 0 makes every W exceed it), each
held to its plain twin within 1e-5·max|twin| (f32) and 1e-13 (f64); and
K1 and K2 (csrc/kron.cu: B, Bᵀ and their stab forms, float32 and float64)
on ragged 2-D and 3-D grids, T = 1, 2 and 5, a 2-D row wider than one
segment, at both pencils (4, 8) and chunks of 1 row to all of them,
held to their twins the same way; and K4 and K5 (csrc/mg.cu
``mg_residual``, ``mg_apply``, float32 and float64) on ragged 2-D and 3-D
grids and slabs, T = 1, 2 and 5, 2-D rows wider than one segment, at
every chunk from one row (plane) to the whole column, held to their
twins the same way; and K16 and K17 (csrc/dia.cu ``dia_smooth``,
``dia_residual``, float32 and float64) on a nested L-shape level (11
offsets), a nested tetrahedra level (15) and a synthetic level of more
than 16 (held in the shared tile), T = 1, 2 and 5, K16 from 0 and from x
at ν ∈ {2, 3, 4}, at every chunk from one time row to all, held to their
twins the same way; and K11 and K12 (csrc/mg.cu ``mg_residual_var``,
``mg_apply_var``, float32 and float64) on ragged 2-D and 3-D grids, T = 1,
2 and 5, 2-D rows wider than one segment (…×1055, …×1985), the weights in
both homes of the march (the varcoef tables, 7 A taps in 2-D in registers
and 15 in 3-D in the shared tile, and ``OTHER_TAPS``, 9 in 2-D and 7 in
3-D, the other way round), at every chunk from one time row to all, held
to their twins the same way. With
``--parent DIR`` (an unpacked ``git archive`` of an earlier commit) DIR's
csrc/mg.cu, csrc/kron.cu and csrc/dia.cu are emulated too, their entry
points bound as ``tools.fused_ab`` binds them, and each output must equal
DIR's bit for bit. ``--only fused`` (or ``kron``, ``stencil``, ``dia``,
``var_stencil``) runs one of the five checks. A CUDA construct the
runtime stand-in below lacks fails the g++ build.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import native
from ..ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from ..ops.multigrid import row_params, var_row_params
from .fused_ab import (bind_parent, bind_parent_dia, bind_parent_kron,
                       dia_columns, dia_lib_apply, dia_lib_residual,
                       dia_lib_smooth, parent_dia_apply_marches,
                       var_lib_smooth)

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "cpu_emulate"
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
L2 = 50 * 1024 * 1024  # the H100's, which the stand-in reports by default
# (T, grid): one tile and chunk; ragged chunks and tiles; one coarse plane;
# nine tiles with ragged edges
SHAPES = [(2, (7, 9, 15)), (2, (9, 17, 33)), (1, (3, 17, 33)),
          (1, (13, 35, 67))]
# (own, other extents) of the 3-D sharded K7's slabs, at h ∈ {3, 4, 5}
SLABS = [(4, (7, 9)), (12, (9, 33))]
# 2-D (T, grid): ragged; one row (no coarse row); one coarse row; rows
# wider than one segment of the march (two segments, the second ragged;
# two, a column past a multiple of the segment joined to the last)
SHAPES_2D = [(2, (15, 31)), (2, (9, 65)), (1, (1, 9)), (1, (3, 17)),
             (1, (7, 1055)), (1, (7, 1985))]
# (own, other extents) of the 2-D sharded K6's and K7's slabs
SLABS_2D = [(4, (15,)), (12, (33,)), (6, (1055,)), (6, (1985,))]
# (T, grid) of K1/K2: T = 1, 2 and 5 on ragged 2-D grids (one row, rows
# of one pencil's points and past it), a row wider than one segment
# (four), ragged 3-D grids (one plane; several bricks in y and x)
KRON_SHAPES = [(1, (1, 9)), (2, (9, 13)), (5, (10, 7)), (2, (5, 1985)),
               (1, (1, 5, 7)), (2, (5, 9, 33)), (5, (9, 17, 35))]
# (T, grid) of K4/K5: T = 1, 2 and 5 on ragged 2-D grids (one row; an even
# row count, as a rank's halo-extended slab), rows wider than one segment
# (two and a ragged third of one column; two, the second ragged), ragged
# 3-D grids (one plane; one tile; tiles ragged in y and x)
STENCIL_SHAPES = [(1, (1, 9)), (5, (10, 15)), (2, (9, 65)), (2, (4, 1985)),
                  (1, (5, 1055)), (2, (1, 5, 7)), (1, (7, 9, 15)),
                  (5, (3, 17, 33)), (1, (6, 35, 67))]
# (T, grid) of K11/K12: T = 1, 2 and 5 on ragged 2-D grids (one row; rows
# of one pencil and past it), rows wider than one segment (two, the second
# ragged; four), ragged 3-D grids (one plane; tiles ragged in y and x and
# planes past one pencil)
VAR_STENCIL_SHAPES = [(1, (1, 9)), (5, (10, 15)), (2, (9, 65)),
                      (2, (5, 1055)), (1, (3, 1985)), (2, (1, 5, 7)),
                      (5, (3, 9, 15)), (1, (5, 17, 35))]
# K10's ν in the emulation, by dimension: 1 to 4 and 9 in 2-D (8 the most
# the tiled parent held there), 1 to 5 in 3-D (3 there)
VAR_SWEEP_NU = {2: (1, 2, 3, 4, 9), 3: (1, 2, 3, 4, 5)}
# the tables of each dimension whose weights the march holds in the other
# home: 2-D the 3 × 3 neighbourhood (9 taps: the shared tile), 3-D the
# 7-point star (registers)
OTHER_TAPS = {2: tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)),
              3: ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                  (0, 0, -1), (0, 0, 1))}
# (problem, cells, refinements) of the nested levels K16/K17 are emulated
# on: the L-shape's fine level (m = 705, 11 offsets: three segments of the
# register form, the last ragged) and the tetrahedra's (m = 343, 15)
DIA_LEVELS = [("lshape2d", 8, 2), ("smooth3d", 4, 1)]
DIA_T = (1, 2, 5)
# K18 also at the nested solves' K_X rows (every chunk of 129)
DIA_APPLY_T = (129,)

RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
#define __align__(n)
struct emu_uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local emu_uint3 threadIdx, blockIdx;
inline emu_uint3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline unsigned char* emu_smem = nullptr;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrL2CacheSize };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::fma;
using std::max;
using std::min;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// the L2's bytes (the weighted kernels' row order reads them): the
// H100's 50 MB, or EMU_L2_BYTES
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  const char* env = std::getenv("EMU_L2_BYTES");
  *v = env != nullptr ? std::atoi(env) : 50 * 1024 * 1024;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int,
                                                         size_t) {
  *b = 1;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F>
void emu_launch(dim3 grid, int block, size_t smem, cudaStream_t, F f) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {unsigned(block), 1, 1};
  std::vector<unsigned char> buf(smem + 16, 0xff);
  emu_smem = buf.data();
  std::barrier<> bar(block);
  emu_barrier = &bar;
  std::vector<std::thread> threads;
  for (int i = 0; i < block; ++i) {
    threads.emplace_back([&, i] {
      threadIdx = {unsigned(i), 0, 0};
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = {x, y, z};
            f();
            bar.arrive_and_wait();
          }
    });
  }
  for (auto& t : threads) t.join();
}
"""


def translate(src: str) -> str:
    """A .cu source as C++ for the runtime stand-in: each launch a call of
    ``emu_launch`` with the kernel's call in a lambda, dynamic shared
    memory the launch's buffer."""
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_smem;")
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        start = max(src.rfind(c, 0, j) for c in ";{}") + 1
        k = src.index(">>>", j)
        p = src.index("(", k)
        depth, q = 0, p
        while True:
            depth += {"(": 1, ")": -1}.get(src[q], 0)
            if depth == 0:
                break
            q += 1
        out.append(src[i:start])
        out.append(f"emu_launch({src[j + 3:k]}, [&]() {{ "
                   f"{src[start:j].strip()}({src[p + 1:q]}); }})")
        i = q + 1
    out.append(src[i:])
    return "".join(out)


def build(sources, name: str) -> ctypes.CDLL:
    """``sources`` (.cu paths) translated and compiled, each on its own, and
    linked into build/cpu_emulate/``name``.so."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cuda_runtime.h").write_text(RUNTIME)
    objects, jobs = [], []
    for src in sources:
        cpp = OUT / f"{name}.{src.stem}.cpp"
        cpp.write_text(translate(src.read_text()))
        obj = cpp.with_suffix(".o")
        objects.append(str(obj))
        jobs.append(subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-w",
             f"-I{OUT}", "-c", "-o", str(obj), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for job in jobs:
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"g++ failed:\n{log[-4000:]}")
    lib = OUT / f"{name}.so"
    subprocess.run(["g++", "-shared", "-o", str(lib), *objects, "-lpthread"],
                   check=True)
    return ctypes.CDLL(str(lib))


def _call(lib, name, *args) -> None:
    err = getattr(lib, name)(*args, None)
    if err != 0:
        raise RuntimeError(f"{name}: error {err}")


def _close(label, got, want, dtype, ref=None) -> None:
    if want.numel() == 0:  # r_c of a grid without a coarse row
        assert got.shape == want.shape, (label, got.shape)
        return
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (label, err, scale)
    if ref is not None:
        assert torch.equal(got, ref), (label, float((got - ref).abs().max()))


def _pre_and_post(new, old, level, T, gs, x, b, ec, cols_of, pre, tables,
                  twins, dtype, sfx, vsfx, chunks, l2s=(L2,)) -> int:
    """K6 / K14 (vsfx "_var") and K7 / K15 of ``new`` at each chunk (each
    of the L2 sizes ``l2s``) against their twins and, if given, ``old``'s
    launch at the first chunk; returns the launches compared."""
    cols = level.columns(cols_of())
    cp = [cols[k].data_ptr() for k in level._COLS]
    zyx = level._zyx()
    post_twin, pre_twin = twins
    n = 0
    for stage, want in (("post", (post_twin(cols),)),
                        ("pre", pre_twin(cols))):
        ref = None
        for lib, chunk, l2 in ([(old, chunks[stage][0], L2)] if old else []) + [
                (new, c, l2) for c in chunks[stage] for l2 in l2s]:
            os.environ["EMU_L2_BYTES"] = str(l2)
            if stage == "post":
                got = (torch.empty_like(b),)
                _call(lib, f"mg_fused_post{vsfx}_{sfx}", x.data_ptr(),
                      b.data_ptr(), ec.data_ptr(), *pre, *cp,
                      got[0].data_ptr(), T, *zyx, *tables, level.nu, chunk)
            else:
                got = (torch.empty_like(b), b.new_empty((T,) + level.coarse_gs))
                _call(lib, f"mg_fused_pre{vsfx}_{sfx}", b.data_ptr(), *pre,
                      *cp, got[0].data_ptr(), got[1].data_ptr(), T, *zyx,
                      *tables, level.nu, chunk)
            n += 1
            if lib is old:
                ref = got
                continue
            for i, (g, w) in enumerate(zip(got, want)):
                _close((stage, vsfx, sfx, gs, level.nu, chunk, l2), g, w,
                       dtype, None if ref is None else ref[i])
    os.environ["EMU_L2_BYTES"] = str(L2)
    return n


def _sharded(new, old, lev, const, slabs, dtype, sfx, mk, rng) -> int:
    """The sharded K6 (2-D) and K7 (2-D and 3-D) of ``new`` on the slabs at
    h ∈ {3, 4, 5}, chunks of 3 and 4 rows (planes) and the whole slab,
    against their twins and ``old``'s."""
    n = 0
    for (own, rest), h in ((s, h) for s in slabs for h in (3, 4, 5)):
        gs, T, hc = (own + 2 * h,) + rest, 2, (h + 2) // 2
        for nu in (2, 3):
            kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
            x, b = mk((T,) + gs), mk((T,) + gs)
            ec = mk((T, own // 2 + 2 * hc) + kl.coarse_gs[1:])
            vm = torch.ones((1,) + gs, dtype=dtype)
            vm[:, :h - 1] = 0
            vm[:, -1] = 0
            cols = kl.columns(row_params(const, rng.uniform(0, 40, T),
                                         dtype, "cpu")[0])
            cp = [cols[k].data_ptr() for k in kl._COLS]
            want = kl.sh_fused_post_plain(x, b, ec, cols, vm, own, h, hc)
            ref = None
            for lib, chunk in ([(old, 4)] if old else []) + [
                    (new, c) for c in sorted({3, 4, gs[0]})]:
                got = torch.empty_like(b)
                _call(lib, f"mg_sh_fused_post_{sfx}", x.data_ptr(),
                      b.data_ptr(), ec.data_ptr(), vm.data_ptr(), *cp,
                      got.data_ptr(), T, *kl._zyx(), kl._op_table(), nu,
                      own, h, hc, chunk)
                n += 1
                if lib is old:
                    ref = got
                    continue
                _close(("sh post", sfx, gs, nu, chunk), got, want, dtype, ref)
            if len(gs) == 3 or h < nu + 1:
                continue
            want = kl.sh_fused_pre_plain(b, cols, vm, own, h)
            ref = None
            for lib, chunk in ([(old, 2)] if old else []) + [
                    (new, c) for c in sorted({1, 2, own // 2})]:
                got = (torch.empty_like(b),
                       b.new_empty((T,) + kl._coarse_lead(own // 2)))
                _call(lib, f"mg_sh_fused_pre_{sfx}", b.data_ptr(),
                      vm.data_ptr(), *cp, got[0].data_ptr(),
                      got[1].data_ptr(), T, *kl._zyx(), kl._op_table(), nu,
                      own, h, chunk)
                n += 1
                if lib is old:
                    ref = got
                    continue
                for i, (g, w) in enumerate(zip(got, want)):
                    _close(("sh pre", sfx, gs, nu, chunk), g, w, dtype,
                           None if ref is None else ref[i])
    return n


def check(new, old) -> int:
    """The fused stages of ``new`` against the twins and, if given,
    ``old``'s; returns the number of launches compared."""
    from ..solver import build_solver

    n = 0
    for dim, shapes, slabs in ((2, SHAPES_2D, SLABS_2D), (3, SHAPES, SLABS)):
        const = build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 2,
                             device="cpu", inner="mg").msmg
        var = build_solver("varcoef3d" if dim == 3 else "varcoef2d", 8, 2,
                           device="cpu", inner="mg").msmg
        lev, vlev = const.levels[0], var.levels[0]
        rng = np.random.default_rng(dim)
        for dtype in (torch.float32, torch.float64):
            sfx = "f32" if dtype == torch.float32 else "f64"
            mk = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                               dtype=dtype)
            for (T, gs), nu in ((s, nu) for s in shapes for nu in (2, 3)):
                kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
                vl = VarMSKernelLevel(vlev, nu, gs=gs)
                x, b = mk((T,) + gs), mk((T,) + gs)
                ec = mk((T,) + kl.coarse_gs)
                grow = [(0, 0)] + [(0, max(m - w, 0))
                                   for m, w in zip(gs, vlev.Aw.shape[1:])]
                cut = (slice(None),) + tuple(slice(0, m) for m in gs)
                W = torch.as_tensor(np.ascontiguousarray(np.pad(
                    np.asarray(vlev.Aw), grow, mode="wrap")[cut]),
                    dtype=dtype)
                # the fused stages: every chunk of 1, 2, 4 rows (planes) and
                # the whole column
                chunks = {
                    "pre": sorted({1, 2, 4, max(kl.coarse_gs[0], 1)}),
                    "post": sorted({1, 2, 4, gs[0]})}
                n += _pre_and_post(
                    new, old, kl, T, gs, x, b, ec,
                    lambda: row_params(const, rng.uniform(0, 40, T), dtype,
                                       "cpu")[0], (), (kl._op_table(),),
                    (lambda c: kl.fused_post_plain(x, b, ec, c),
                     lambda c: kl.fused_pre_plain(b, c)),
                    dtype, sfx, "", chunks)
                # the weighted ones, in 3-D in both row orders (W in the L2
                # and beyond it: an L2 of 0 bytes)
                n += _pre_and_post(
                    new, old, vl, T, gs, x, b, ec,
                    lambda: var_row_params(var, rng.uniform(0, 40, T),
                                           dtype, "cpu")[0], (W.data_ptr(),),
                    vl._tables(),
                    (lambda c: vl.fused_post_plain(x, b, ec, c, W),
                     lambda c: vl.fused_pre_plain(b, c, W)),
                    dtype, sfx, "_var", chunks,
                    (L2, 0) if dim == 3 else (L2,))
            n += _sharded(new, old, lev, const, slabs, dtype, sfx, mk,
                          rng)
    return n


def check_stencil(new, old, shapes=STENCIL_SHAPES) -> int:
    """K4 (``mg_residual``) and K5 (``mg_apply``) of ``new`` on each (T,
    grid) of ``shapes``, float32 and float64, at every chunk from one
    plane (row in 2-D) to the whole column, against their twins and, if
    given, ``old``'s (an earlier tree's, which take no chunk); returns the
    number of launches compared."""
    from ..solver import build_solver

    n = 0
    msmg = {dim: build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 2,
                              device="cpu", inner="mg").msmg
            for dim in {len(gs) for _, gs in shapes}}
    rng = np.random.default_rng(15)
    for (T, gs), dtype in itertools.product(
            shapes, (torch.float32, torch.float64)):
        sfx = "f32" if dtype == torch.float32 else "f64"
        lev = msmg[len(gs)].levels[0]
        kl = MSKernelLevel(lev.A_st, lev.M_st, 2, gs=gs)
        mk = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                           dtype=dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        cols = kl.columns(row_params(msmg[len(gs)], rng.uniform(0, 40, T),
                                     dtype, "cpu")[0])
        forms = {
            "residual": (kl.residual_plain(x, b, cols),
                         (x.data_ptr(), b.data_ptr(),
                          cols["omega"].data_ptr()), kl._op_table()),
            "apply": (kl.apply_A_plain(x), (x.data_ptr(),),
                      ctypes.addressof(kl.structs[1])),
        }
        for op, (want, fields, table) in forms.items():
            name = f"mg_{op}_{sfx}"
            ref = None
            if old is not None:
                ref = torch.empty_like(x)
                _call(old, name, *fields, ref.data_ptr(), T, *kl._zyx(),
                      table)
                n += 1
            for chunk in range(1, gs[0] + 1):
                got = torch.empty_like(x)
                _call(new, name, *fields, got.data_ptr(), T, *kl._zyx(),
                      table, chunk)
                n += 1
                _close((name, T, gs, chunk), got, want, dtype, ref)
    return n


def build_stencil(name: str = "this_stencil") -> ctypes.CDLL:
    """This tree's mg.cu and common.cu alone, K4 and K5 (``mg_residual``,
    ``mg_apply``) bound with their signatures."""
    so = build([native.CSRC / "mg.cu", native.CSRC / "common.cu"], name)
    signatures = native.entry_signatures()
    for op, sfx in itertools.product(("mg_residual", "mg_apply"),
                                     ("f32", "f64")):
        fn = getattr(so, f"{op}_{sfx}")
        fn.argtypes, fn.restype = signatures[op], ctypes.c_int
    return so


def build_var_stencil(name: str = "this_var_stencil") -> ctypes.CDLL:
    """This tree's mg.cu and common.cu alone, K10, K11 and K12
    (``mg_smooth_var``, ``mg_residual_var``, ``mg_apply_var``) and the
    march's occupancy bound with their signatures."""
    so = build([native.CSRC / "mg.cu", native.CSRC / "common.cu"], name)
    signatures = native.entry_signatures()
    I, I64, P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    so.mg_var_stencil_occupancy.argtypes = [I, I, I, I, I64, I64, I64, P, P,
                                            P, P]
    so.mg_var_stencil_occupancy.restype = I
    for op, sfx in itertools.product(("mg_smooth_var", "mg_residual_var",
                                      "mg_apply_var"), ("f32", "f64")):
        fn = getattr(so, f"{op}_{sfx}")
        fn.argtypes, fn.restype = signatures[op], ctypes.c_int
    return so


@functools.lru_cache(maxsize=None)
def _var_msmg(dim: int):
    """The Galerkin hierarchy of a small varcoef solver of ``dim``."""
    from ..solver import build_solver

    return build_solver("varcoef3d" if dim == 3 else "varcoef2d", 8, 2,
                        device="cpu", inner="mg").msmg


def var_levels(dim: int, gs: tuple):
    """The two weighted levels K11/K12 are emulated on at grid ``gs``: the
    varcoef solver's finest level (7 A taps in 2-D, 15 in 3-D) and one of
    ``OTHER_TAPS`` with its mass, as (level, W of float64 on the grid,
    the level's hierarchy)."""
    import types

    from ..ops.stencil import VarStencilOperator

    var = _var_msmg(dim)
    lev = var.levels[0]
    grow = [(0, 0)] + [(0, max(m - w, 0)) for m, w in zip(gs, lev.Aw.shape[1:])]
    cut = (slice(None),) + tuple(slice(0, m) for m in gs)
    W = np.ascontiguousarray(np.pad(np.asarray(lev.Aw), grow,
                                    mode="wrap")[cut])
    disps = OTHER_TAPS[dim]
    rng = np.random.default_rng(dim)
    other = types.SimpleNamespace(
        A_vs=VarStencilOperator(disps, gs), gs=gs,
        kc=disps.index((0,) * dim), cM=lev.cM, M_st=lev.M_st)
    Wo = rng.uniform(-1.0, 1.0, (len(disps),) + gs)
    return [(lev, W, var), (other, Wo, var)]


def check_var_stencil(new, old, shapes=VAR_STENCIL_SHAPES) -> int:
    """K11 (``mg_residual_var``) and K12 (``mg_apply_var``) of ``new`` on
    each (T, grid) of ``shapes``, float32 and float64, with the weights in
    both homes (``var_levels``), at every chunk from one time row to all of
    them, against their twins and, if given, ``old``'s (bound by
    ``tools.fused_ab.bind_parent``: before the march it takes no chunk);
    returns the number of launches compared."""
    n = 0
    rng = np.random.default_rng(11)
    for (T, gs), dtype in itertools.product(
            shapes, (torch.float32, torch.float64)):
        sfx = "f32" if dtype == torch.float32 else "f64"
        mk = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                           dtype=dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        for lev, Wn, var in var_levels(len(gs), gs):
            kl = VarMSKernelLevel(lev, 2, gs=gs)
            W = torch.as_tensor(Wn, dtype=dtype)
            cols = kl.columns(var_row_params(var, rng.uniform(0, 40, T),
                                             dtype, "cpu")[0])
            vt, pm = kl._tables()
            forms = {
                "residual_var": (kl.residual_plain(x, b, cols, W),
                                 (x.data_ptr(), b.data_ptr(), W.data_ptr(),
                                  cols["omega"].data_ptr()), (vt, pm)),
                "apply_var": (kl.apply_A_plain(x, W),
                              (x.data_ptr(), W.data_ptr()), (vt,)),
            }
            old_chunk = hasattr(old, "mg_var_stencil_occupancy")
            for op, (want, fields, tables) in forms.items():
                name = f"mg_{op}_{sfx}"
                ref = None
                if old is not None:
                    ref = torch.empty_like(x)
                    _call(old, name, *fields, ref.data_ptr(), T, *kl._zyx(),
                          *tables, *((T,) if old_chunk else ()))
                    n += 1
                for chunk in range(1, T + 1):
                    got = torch.empty_like(x)
                    _call(new, name, *fields, got.data_ptr(), T, *kl._zyx(),
                          *tables, chunk)
                    n += 1
                    _close((name, len(lev.A_vs.disps), T, gs, chunk), got,
                           want, dtype, ref)
    return n


def sweep_levels(dim: int, gs: tuple):
    """``var_levels`` for K10's sweep: the other table's W made diagonally
    dominant (its center the sum of |W| over the taps, plus 1/2), so that
    every 1/D is positive, as the twin takes it."""
    out = var_levels(dim, gs)
    lev, Wo, var = out[1]
    Wo = Wo.copy()
    Wo[lev.kc] = np.abs(Wo).sum(0) + 0.5
    out[1] = (lev, Wo, var)
    return out


def check_var_sweep(new, old, shapes=VAR_STENCIL_SHAPES, nus=None,
                    chunks=None) -> int:
    """K10 (``mg_smooth_var``: the sweep's step launches) of ``new`` on each
    (T, grid) of ``shapes``, float32 and float64, from x and from 0 at
    each ν of ``nus`` (``VAR_SWEEP_NU`` by dimension), with the weights in
    both homes (``sweep_levels``), at every chunk from one time row to all
    of them (``chunks``: those only), against the twin
    (``VarMSKernelLevel.smooth_plain``) within 1e-5·max|twin| (f32) and
    1e-13 (f64) and, if given, bit for bit against ``old``'s chained
    steps (``mg_cheb_step_var``); where ``old`` has a tiled sweep for the
    ν (``mg_smooth_var``, ν ≤ ``MAX_NU``) its max|new − old| is printed.
    Returns the number of launches compared."""
    from ..ops.mg_kernels import MAX_NU, k10_launches

    n = 0
    worst = {}
    rng = np.random.default_rng(10)
    for (T, gs), dtype in itertools.product(
            shapes, (torch.float32, torch.float64)):
        sfx = "f32" if dtype == torch.float32 else "f64"
        dim = len(gs)
        mk = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                           dtype=dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        for (lev, Wn, var), nu, zero in itertools.product(
                sweep_levels(dim, gs), (nus or VAR_SWEEP_NU)[dim],
                (True, False)):
            kl = VarMSKernelLevel(lev, nu, gs=gs)
            W = torch.as_tensor(Wn, dtype=dtype)
            cols = kl.columns(var_row_params(var, rng.uniform(0, 40, T),
                                             dtype, "cpu")[0])
            want = kl.smooth_plain(x, b, cols, W, zero_init=zero)
            ref = None
            label = (len(lev.A_vs.disps), T, gs, nu,
                     "from 0" if zero else "from x")
            if old is not None:
                ref = var_lib_smooth(_call, old, kl, x, b, W, cols, nu, zero)
                n += nu
                if nu <= MAX_NU[dim]:
                    tiled = torch.empty_like(b)
                    cp = [cols[k].data_ptr() for k in kl._COLS]
                    _call(old, f"mg_smooth_var_{sfx}",
                          None if zero else x.data_ptr(), b.data_ptr(),
                          W.data_ptr(), *cp, tiled.data_ptr(), T,
                          *kl._zyx(), *kl._tables(), nu, int(zero))
                    n += 1
                    _close(("tiled",) + label, tiled, want, dtype)
                    key = (sfx, dim)
                    worst[key] = max(worst.get(key, 0.0),
                                     float((tiled - ref).abs().max()))
            for chunk in chunks or range(1, T + 1):
                got = var_lib_smooth(_call, new, kl, x, b, W, cols, nu,
                                     zero, min(chunk, T))
                n += k10_launches(nu, zero)
                _close(("mg_smooth_var", sfx) + label + (chunk,), got,
                       want, dtype, ref)
    for (sfx, dim), err in sorted(worst.items()):
        print(f"K10 {dim}-D {sfx}: max|steps - the tiled sweep| {err:.3e} "
              "(the parent's tiled kernel, ν within its halo)")
    return n


def build_kron(csrc: Path = native.CSRC, name: str = "this_kron",
               bind=None) -> ctypes.CDLL:
    """``csrc``'s kron.cu and common.cu alone (K1 and K2), bound with this
    tree's signatures (``bind``: another tree's binder)."""
    so = build([csrc / "kron.cu", csrc / "common.cu"], name)
    if bind is not None:
        return bind(so)
    signatures = native.entry_signatures()
    for op, sfx in itertools.product(("kron_B", "kron_BT"), ("f32", "f64")):
        fn = getattr(so, f"{op}_{sfx}")
        fn.argtypes, fn.restype = signatures[op], ctypes.c_int
    return so


def check_kron(new, old, shapes=KRON_SHAPES, pencils=(4, 8),
               chunks=(1, 2, 3)) -> int:
    """K1 and K2 of ``new`` (every form and dtype, at each of ``pencils``
    and each of ``chunks`` rows and all of them) on each (T, grid) of
    ``shapes`` against their twins and, if given, ``old``'s; returns the
    number of launches compared."""
    import dataclasses

    from ..ops import kron
    from ..solver import build_solver

    n = 0
    taps_of = {dim: build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 2,
                                 device="cpu", inner="mg").taps
               for dim in (2, 3)}
    rng = np.random.default_rng(14)
    for (T, gs), dtype in ((s, d) for s in shapes
                           for d in (torch.float32, torch.float64)):
        sfx = "f32" if dtype == torch.float32 else "f64"
        taps = dataclasses.replace(taps_of[len(gs)], gs=gs)
        tM, tA = (ctypes.addressof(t) for t in taps.structs)
        mk = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                           dtype=dtype)
        U, V, W = mk((T + 1,) + gs), mk((T,) + gs), mk((T,) + gs)
        h = rng.uniform(0.5, 1.5, T) / T
        hh, hs = (torch.as_tensor(v, dtype=dtype) for v in (0.5 * h, h / 16))
        for bt, stab in itertools.product((0, 1), (0, 1)):
            if bt:
                twin = ((kron.apply_BT_stab_plain(V, W, hh, taps),) if stab
                        else (kron.apply_BT_plain(V, hh, taps),))
                outs = lambda: (torch.empty((T + 1,) + gs, dtype=dtype),)
                args = lambda o: (V.data_ptr(), hh.data_ptr(),
                                  W.data_ptr() if stab else None,
                                  o[0].data_ptr(), T, *taps.zyx())
            else:
                twin = (kron.apply_B_stab_plain(U, hh, hs, taps) if stab
                        else (kron.apply_B_plain(U, hh, taps),))
                outs = lambda: tuple(torch.empty((T,) + gs, dtype=dtype)
                                     for _ in range(1 + stab))
                args = lambda o: (U.data_ptr(), hh.data_ptr(),
                                  hs.data_ptr() if stab else None,
                                  o[0].data_ptr(),
                                  o[1].data_ptr() if stab else None, T,
                                  *taps.zyx())
            name = f"kron_{'BT' if bt else 'B'}_{sfx}"
            ref = None
            if old is not None:
                ref = outs()
                _call(old, name, *args(ref), tM, tA, stab)
                n += 1
            rows = T + bt
            for pencil, chunk in itertools.product(
                    pencils, sorted({*chunks, rows})):
                got = outs()
                _call(new, name, *args(got), len(gs), tM, tA, stab, pencil,
                      chunk)
                n += 1
                for i, (g, w) in enumerate(zip(got, twin)):
                    _close((name, stab, T, gs, pencil, chunk), g, w, dtype,
                           None if ref is None else ref[i])
    return n


def synthetic_level(nd: int, m: int, seed: int = 17):
    """A DIA level of ``nd`` union offsets within ±40 on m dofs (A on the
    even-indexed ones and 0, M on the others and 0), diagonally dominant,
    in the attributes ``DiaKernelLevel`` and ``dia_columns`` read."""
    import types

    rng = np.random.default_rng(seed)
    offs = sorted({0, *rng.choice(np.r_[-40:0, 1:41], nd - 1,
                                  replace=False).tolist()})
    offA = [o for i, o in enumerate(offs) if i % 2 == 0 or o == 0]
    offM = [o for i, o in enumerate(offs) if i % 2 == 1 or o == 0]

    def mat(off, scale):
        v = -rng.uniform(0.1, 1.0, (m, len(off))) * scale
        v[:, off.index(0)] = np.abs(v).sum(1) + scale
        return v

    Av, Mv = mat(offA, 1.0), mat(offM, 0.01)
    return types.SimpleNamespace(
        m=m, offA=tuple(offA), Av=Av, offM=tuple(offM), Mv=Mv, fmt="dia",
        dA=Av[:, offA.index(0)].copy(), dM=Mv[:, offM.index(0)].copy(),
        rsA=np.abs(Av).sum(1), rsM=np.abs(Mv).sum(1))


def dia_levels(synthetic: int = 20) -> list:
    """(label, level) of the K16/K17 emulation: ``DIA_LEVELS`` and a
    synthetic level of ``synthetic`` offsets on 300 dofs."""
    from ..solver import build_solver

    out = []
    for problem, n, r in DIA_LEVELS:
        s = build_solver(problem, n, 2, dtype=torch.float64, device="cpu",
                         refine=r, inner="mg")
        out.append((f"{problem} {n} cells refined {r}x", s.msmg.levels[0]))
    out.append((f"{synthetic} offsets", synthetic_level(synthetic, 300)))
    return out


def build_dia(csrc: Path = native.CSRC, name: str = "this_dia",
              bind=None) -> ctypes.CDLL:
    """``csrc``'s dia.cu and common.cu alone (K16–K18), bound with this
    tree's signatures, ``dia_march_occupancy`` too (``bind``: another
    tree's binder)."""
    so = build([csrc / "dia.cu", csrc / "common.cu"], name)
    if bind is not None:
        return bind(so)
    signatures = native.entry_signatures()
    for op, sfx in itertools.product(("dia_smooth", "dia_residual",
                                      "dia_apply"), ("f32", "f64")):
        fn = getattr(so, f"{op}_{sfx}")
        fn.argtypes, fn.restype = signatures[op], ctypes.c_int
    I, P = ctypes.c_int, ctypes.c_void_p
    so.dia_march_occupancy.argtypes = [I, I, I, P, P, P]
    so.dia_march_occupancy.restype = I
    return so


def check_dia(new, old, levels=None, Ts=DIA_T, nus=(2, 3, 4),
              apply_Ts=DIA_APPLY_T) -> int:
    """K17, K16 (from 0 and from x at each of ``nus``) and K18 of ``new``
    on each level of ``levels`` (``dia_levels()``) at T of ``Ts`` (K18
    also at ``apply_Ts``), float32 and float64, at every chunk of 1 to T
    rows (the values in registers up to 16 offsets, else in the shared
    tile), against their twins and, if given, ``old``'s (a march's at the
    chunk of T rows, one from before the march without a chunk); returns
    the number of launches compared."""
    from ..ops import dia_kernels as dk

    n = 0
    rng = np.random.default_rng(16)
    if old is None:
        old_chunk = lambda T, op: None
    else:  # a parent whose K16/K17 (and K18) march takes the chunk
        march = {"smooth": hasattr(old, "dia_march_occupancy"),
                 "residual": hasattr(old, "dia_march_occupancy"),
                 "apply": parent_dia_apply_marches(old)}
        old_chunk = lambda T, op: T if march[op] else None
    for (label, lev), dtype, T in itertools.product(
            levels or dia_levels(), (torch.float32, torch.float64),
            sorted({*Ts, *apply_Ts})):
        kl = dk.DiaKernelLevel(lev, 2)
        vals = kl.values(lev, dtype, "cpu")
        cols = dia_columns(lev, T, dtype, "cpu", rng)
        x, b = (torch.as_tensor(rng.standard_normal((T, lev.m)), dtype=dtype)
                for _ in range(2))
        runs = [(kl.apply_A_plain(x, vals),
                 lambda so, c: dia_lib_apply(_call, so, kl, x, vals, c), 1,
                 "apply", "apply")]
        if T in Ts:
            runs.append((kl.residual_plain(x, b, cols, vals),
                         lambda so, c: dia_lib_residual(
                             _call, so, kl, x, b, cols, vals, c), 1,
                         "residual", "residual"))
            for nu, zero in itertools.product(nus, (True, False)):
                kn = dk.DiaKernelLevel(lev, nu)
                runs.append((
                    kn.smooth_plain(x, b, cols, vals, zero_init=zero),
                    lambda so, c, kn=kn, z=zero: dia_lib_smooth(
                        _call, so, kn, x, b, cols, vals, kn.nu, z, c),
                    nu, "smooth", f"smooth nu={nu} from {'0' if zero else 'x'}"))
        for want, run, launches, op, form in runs:
            ref = None
            if old is not None:
                ref = run(old, old_chunk(T, op))
                n += launches
            for chunk in range(1, T + 1):
                _close((label, form, str(dtype), T, chunk), run(new, chunk),
                       want, dtype, ref)
                n += launches
    return n


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None)
    p.add_argument("--only", choices=["fused", "kron", "stencil", "dia",
                                      "var_stencil"], default=None)
    args = p.parse_args()
    run = ({args.only} if args.only
           else {"fused", "kron", "stencil", "dia", "var_stencil"})
    old = old_kron = old_dia = None
    if args.parent is not None:
        csrc = args.parent.resolve() / "spacetime_tpu_torch" / "csrc"
        if run & {"fused", "stencil", "var_stencil"}:
            old = bind_parent(build([csrc / "mg.cu", csrc / "common.cu"],
                                    "parent"))
        if "kron" in run:
            old_kron = build_kron(csrc, "parent_kron", bind_parent_kron)
        if "dia" in run:
            old_dia = build_dia(csrc, "parent_dia", bind_parent_dia)
    n = 0
    if "fused" in run:
        new = native._bind(build(sorted(native.CSRC.glob("*.cu")), "this"))
        n += check(new, old)
    if "stencil" in run:
        n += check_stencil(new if "fused" in run else build_stencil(), old)
    if "var_stencil" in run:
        lib = new if "fused" in run else build_var_stencil()
        n += check_var_stencil(lib, old)
        n += check_var_sweep(lib, old)
    if "kron" in run:
        n += check_kron(build_kron(), old_kron)
    if "dia" in run:
        n += check_dia(build_dia(), old_dia)
    print(f"{n} emulated launches held to their twins"
          + (" and equal to the parent's bit for bit"
             if args.parent is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
