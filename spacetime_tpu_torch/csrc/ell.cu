// K20: the blocked-ELL SpMM batched over time rows, for sm_90a, in float
// and double (replaces spacetime_tpu/ops/spmv_pallas.py:55 _spmm_call),
// and K19, its pair form (replaces spacetime_tpu/ops/ell_pallas.py:140
// _spmm_pair_call): (A·X, M·X) for two matrices on one pattern, so each
// gather of X feeds both products.
//
// The function is the TPU kernel's. A sparse matrix in blocked ELL
// (spacetime_tpu_torch/ops/blocked_ell.py): block row rb holds nslots
// dense 128×128 blocks, blocks[rb, s] at block column colidx[rb, s]. For
// X (T, n) row-major,
//
//   Y[t, rb·128 + i] = Σ_s Σ_k X[t, colidx[rb, s]·128 + k] · blocks[rb, s, i, k]
//
// with X read as 0 at columns ≥ n (the wrapper passes the unpadded rows,
// so the JAX package's pad copy and slice are not needed) and only the
// columns < n_out of Y (T, n_out) written.
//
// What it reads: the nonzeros, not the blocks. A P1 row has at most 7 of
// the 640 values its blocks store at the L-shape's n = 256, so the host
// (ops/spmv.py pack_blocks) keeps, once at setup, the entries that are
// nonzero in any of the value arrays, in a row-packed (sliced-ELL) layout:
// rows in slices of 32, one warp each; slice s holds w_s entries per row
// (its longest row's count), entry k of row 32s + l at slice_ptr[s] + 32k
// + l, so a warp's load of entry k is one coalesced access. Columns are
// int32, one value array per matrix; a short row is padded with value 0
// at one of its own columns, and the rows past the matrix hold no
// entries. Within a row the entries run slot by slot, k in order within a
// slot: the order of the Pallas body's sums.
//
// What bounds it: bytes, the entries once (at n = 256 A's 242,185
// nonzeros and M's 338,449 with their pads, 1.9 and 2.7 MB in f32), X once
// and Y once; 2 operations per entry and time row are far below them.
// Nothing here is a dense tile: each entry is one gather of X with no
// reuse that staging in shared memory could serve, so TMA and wgmma have
// nothing to do, and the sum needs full f32 products (no tensor cores, no
// TF32; the TPU kernel ran at Precision.HIGHEST).
//
// Design. One thread owns one row and a tile of TR time rows, TR ∈ {1, 2,
// 4, 8} chosen from T so that a T = 1 launch (wavelet level 1 has one
// row) runs no empty rows. For k < w_s it loads the entry's column and
// values (coalesced over the warp's 32 rows), gathers X[t0 + r, col] for
// r < TR and accumulates by FMA in registers, in the entries' order; no
// atomics, so every sum has one fixed order. Threads run along rows, so
// the gathers and the stores of Y are coalesced where neighbouring rows
// have neighbouring columns, as in the L-shape's numbering. Skipping a
// zero drops fma(x, 0, acc) == acc, so for finite X the outputs equal
// those of the blocked kernel this one replaces (which summed every stored
// value in this order) bit for bit, up to the sign of an exact zero. Rows
// ≥ the matrix's (apply_padded's n_out) are written as 0.
//
// K19 is the same kernel with a second value array and a second set of
// accumulators (NMAT = 2) on the union pattern of A and M.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;      // rows per slice of the packed layout
constexpr int kThreads = 128;  // 4 slices per block

// NMAT matrices (1: K20, 2: K19) on one pattern: vals[j] and Y[j], j < NMAT
template <typename T, int NMAT>
struct Mats {
  const T* vals[NMAT];
  T* Y[NMAT];
};

template <typename T, int TR, int NMAT>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const T* __restrict__ X, int64_t nt, int64_t n,
                    const int* __restrict__ slice_ptr,
                    const int* __restrict__ col, Mats<T, NMAT> mats,
                    int64_t n_out) {
  const int64_t row = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n_out) return;
  const int64_t t0 = int64_t(blockIdx.y) * TR;
  const int nr = nt - t0 < TR ? int(nt - t0) : TR;  // this tile's rows
  const T* __restrict__ Xt = X + t0 * n;
  T acc[NMAT][TR];
#pragma unroll
  for (int j = 0; j < NMAT; ++j) {
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[j][r] = T(0);
  }
  const int64_t s = row / kWarp;
  const int end = __ldg(slice_ptr + s + 1);
#pragma unroll 4
  for (int e = __ldg(slice_ptr + s) + int(row % kWarp); e < end;
       e += kWarp) {
    const int c = __ldg(col + e);
    T v[NMAT];
#pragma unroll
    for (int j = 0; j < NMAT; ++j) v[j] = __ldg(mats.vals[j] + e);
    if (c < n) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        if (r < nr) {
          const T x = __ldg(Xt + r * n + c);
#pragma unroll
          for (int j = 0; j < NMAT; ++j) acc[j][r] = fma(x, v[j], acc[j][r]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NMAT; ++j) {
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (r < nr) mats.Y[j][(t0 + r) * n_out + row] = acc[j][r];
    }
  }
}

template <typename T, int TR, int NMAT>
int launch(const T* X, int64_t nt, int64_t n, const int* slice_ptr,
           const int* col, const Mats<T, NMAT>& mats, int64_t n_out,
           void* stream) {
  const dim3 grid(unsigned((n_out + kThreads - 1) / kThreads),
                  unsigned((nt + TR - 1) / TR));
  ell_spmm_kernel<T, TR, NMAT><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      X, nt, n, slice_ptr, col, mats, n_out);
  return int(cudaGetLastError());
}

// The time-row tile TR: 1 row per thread for T ≤ 8, 2 for T ≤ 16, 4 for
// T ≤ 32, else 8 (T = 65 leaves a ragged last tile of one row).
template <typename T, int NMAT>
int launch_spmm(const T* X, int64_t nt, int64_t n, const int* slice_ptr,
                const int* col, const Mats<T, NMAT>& mats, int64_t nslices,
                int64_t n_out, void* stream) {
  if (nt < 1 || nt > int64_t(8) * 65535 || n_out < 1 ||
      n_out > nslices * kWarp || n_out > int64_t(kThreads) * 0x7fffffff) {
    return int(cudaErrorInvalidValue);
  }
  if (nt <= 8) {
    return launch<T, 1>(X, nt, n, slice_ptr, col, mats, n_out, stream);
  }
  if (nt <= 16) {
    return launch<T, 2>(X, nt, n, slice_ptr, col, mats, n_out, stream);
  }
  if (nt <= 32) {
    return launch<T, 4>(X, nt, n, slice_ptr, col, mats, n_out, stream);
  }
  return launch<T, 8>(X, nt, n, slice_ptr, col, mats, n_out, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// the launch. X (nt, n); the packed layout: slice_ptr (nslices + 1) and col
// (E) int32, vals (E) per matrix; Y (nt, n_out) with n_out ≤ 32·nslices;
// all contiguous.
extern "C" {

#define ELL_ENTRY_POINTS(T, SFX)                                              \
  int ell_spmm_##SFX(const T* X, int64_t nt, int64_t n, const int* slice_ptr, \
                     const int* col, const T* vals, int64_t nslices, T* Y,    \
                     int64_t n_out, void* stream) {                           \
    const Mats<T, 1> mats{{vals}, {Y}};                                       \
    return launch_spmm<T, 1>(X, nt, n, slice_ptr, col, mats, nslices, n_out,  \
                             stream);                                         \
  }                                                                           \
  int ell_spmm_pair_##SFX(const T* X, int64_t nt, int64_t n,                  \
                          const int* slice_ptr, const int* col,               \
                          const T* valsA, const T* valsM, int64_t nslices,    \
                          T* YA, T* YM, int64_t n_out, void* stream) {        \
    const Mats<T, 2> mats{{valsA, valsM}, {YA, YM}};                          \
    return launch_spmm<T, 2>(X, nt, n, slice_ptr, col, mats, nslices, n_out,  \
                             stream);                                         \
  }

ELL_ENTRY_POINTS(float, f32)
ELL_ENTRY_POINTS(double, f64)

#undef ELL_ENTRY_POINTS

}  // extern "C"
