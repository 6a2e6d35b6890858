"""The CUDA kernels of csrc/ run on the CPU, to check a kernel's logic on a
machine without a GPU or nvcc.

    python -m spacetime_tpu_torch.tools.cpu_emulate [--parent DIR]

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
held to its plain twin within 1e-5·max|twin| (f32) and 1e-13 (f64). With
``--parent DIR`` (an unpacked ``git archive`` of an earlier commit) DIR's
csrc/mg.cu is emulated too, its fused entry points bound as
``tools.fused_ab`` binds them, and each output must equal DIR's bit for
bit. A CUDA construct the runtime stand-in below lacks fails the g++
build.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import native
from ..ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from ..ops.multigrid import row_params, var_row_params
from .fused_ab import bind_parent

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
                # K6/K7: every chunk of 1, 2, 4 rows (planes) and the whole
                # column; the 2-D K14/K15 (bricks) take no chunk
                const_chunks = {
                    "pre": sorted({1, 2, 4, max(kl.coarse_gs[0], 1)}),
                    "post": sorted({1, 2, 4, gs[0]})}
                n += _pre_and_post(
                    new, old, kl, T, gs, x, b, ec,
                    lambda: row_params(const, rng.uniform(0, 40, T), dtype,
                                       "cpu")[0], (), (kl._op_table(),),
                    (lambda c: kl.fused_post_plain(x, b, ec, c),
                     lambda c: kl.fused_pre_plain(b, c)),
                    dtype, sfx, "", const_chunks)
                # the weighted ones in both row orders where they march (W
                # in the L2 and beyond it: an L2 of 0 bytes)
                var_chunks = const_chunks if dim == 3 else {
                    "pre": [1], "post": [1]}
                n += _pre_and_post(
                    new, old, vl, T, gs, x, b, ec,
                    lambda: var_row_params(var, rng.uniform(0, 40, T),
                                           dtype, "cpu")[0], (W.data_ptr(),),
                    vl._tables(),
                    (lambda c: vl.fused_post_plain(x, b, ec, c, W),
                     lambda c: vl.fused_pre_plain(b, c, W)),
                    dtype, sfx, "_var", var_chunks,
                    (L2, 0) if dim == 3 else (L2,))
            n += _sharded(new, old, lev, const, slabs, dtype, sfx, mk,
                          rng)
    return n


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None)
    args = p.parse_args()
    new = native._bind(build(sorted(native.CSRC.glob("*.cu")), "this"))
    old = None
    if args.parent is not None:
        csrc = args.parent.resolve() / "spacetime_tpu_torch" / "csrc"
        old = bind_parent(build([csrc / "mg.cu", csrc / "common.cu"],
                                "parent"))
    n = check(new, old)
    print(f"{n} emulated launches held to their twins"
          + (" and equal to the parent's bit for bit" if old else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
