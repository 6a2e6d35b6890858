// K20: the blocked-ELL SpMM batched over time rows, for sm_90a, in float
// and double (replaces spacetime_tpu/ops/spmv_pallas.py:55 _spmm_call),
// and K19, its pair form (replaces spacetime_tpu/ops/ell_pallas.py:140
// _spmm_pair_call): (A·X, M·X) for two matrices that share one
// block-column index, so each staged X stripe feeds both products.
//
// A sparse m×m matrix in blocked ELL (spacetime_tpu_torch/ops/
// blocked_ell.py): block row rb holds nslots dense 128×128 blocks,
// blocks[rb, s] at block column colidx[rb, s] (zero blocks at column 0 pad
// short rows). For X (T, n) row-major,
//
//   Y[t, rb·128 + i] = Σ_s Σ_k X[t, colidx[rb, s]·128 + k] · blocks[rb, s, i, k]
//
// with X read as 0 at columns ≥ n (the wrapper passes the unpadded rows,
// so the JAX package's pad copy and slice are not needed) and only the
// columns < n_out of Y (T, n_out) written.
//
// What bounds it: the layout. At the L-shape's n = 256 (m = 48,641; 381
// block rows × 5 slots) the stored blocks are 124.8 MB in f32, read once
// per launch, and their products are 2·T·128²·1,905 FLOPs: at T = 64 the
// FLOPs bind (60 µs at 67 TFLOP/s without tensor cores, against 45 µs for
// the bytes); at T ≤ 32 the blocks' bytes bind (37 µs). The function itself
// needs far less: 338,449 nonzeros, 8.3 µs at T = 64 (PERF.md). No TF32
// and no tensor core: the solve needs full f32 products, as the TPU kernel
// ran at Precision.HIGHEST.
//
// Design, the simple one. One block of 256 threads (32 × 8) owns one block
// row and a tile of TT = 8·RPT time rows, RPT ∈ {1, 2, 4, 8} chosen from T
// so that a T = 1 launch (wavelet level 1 has one row) does not run 63
// empty rows. For each slot in order, it stages the 128-wide k range in
// chunks of K = 32 (f32) or 16 (f64) columns: the X stripe (TT × K) and the
// block (128 × K, stored transposed with one column of padding so that both
// the transposing store and the reads are free of bank conflicts) in shared
// memory, 24.5 KB at TT = 64, then every thread accumulates its RPT × 4
// outputs (rows ty + 8r, columns tx + 32c) by FMA in registers. The sum
// runs slot 0 first, k in order within a slot: the order of the Pallas body
// and of the plain twin up to the blocking of its per-slot product and the
// FMA contraction. The blocks are 99% zeros (a P1 row has ≤ 7 nonzeros on
// 11 diagonals, of the 640 values stored per row at n = 256); skipping
// them, and the tensor cores, are later work.
//
// K19 is the same kernel with a second block tile and a second set of
// accumulators (NMAT = 2): the X stripe is staged once per chunk for both,
// 41 KB of shared memory at TT = 64 in either type. It inherits K20's
// cost, the stored zeros: on the smoothed-aggregation coarse levels the
// pair reads 2·nslots blocks per block row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;  // block rows and columns
constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kThreads = kTx * kTy;
constexpr int kCols = kBlock / kTx;  // output columns per thread

// NMAT matrices (1: K20, 2: K19) on one block-column index: blocks[j]
// and Y[j] for j < NMAT
template <typename T, int NMAT>
struct Mats {
  const T* blocks[NMAT];
  T* Y[NMAT];
};

template <typename T, int RPT, int NMAT>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const T* __restrict__ X, int64_t nt, int64_t n,
                    Mats<T, NMAT> mats, const int* __restrict__ colidx,
                    int nslots, int64_t n_out) {
  constexpr int TT = kTy * RPT;
  // the k range staged at a time: 32 (f32) or 16 (f64) columns, so that
  // the tiles stay under the 48 KB of static shared memory
  constexpr int kChunk = sizeof(T) == 4 ? 32 : 16;
  __shared__ T xs[TT][kChunk];
  __shared__ T bs[NMAT][kChunk][kBlock + 1];
  const int tx = int(threadIdx.x) % kTx;
  const int ty = int(threadIdx.x) / kTx;
  const int64_t rb = blockIdx.x;
  const int64_t t0 = int64_t(blockIdx.y) * TT;
  T acc[NMAT][RPT][kCols];
#pragma unroll
  for (int j = 0; j < NMAT; ++j) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[j][r][c] = T(0);
    }
  }
  for (int s = 0; s < nslots; ++s) {
    const int64_t col0 = int64_t(colidx[rb * nslots + s]) * kBlock;
    const int64_t boff = (rb * nslots + s) * int64_t(kBlock * kBlock);
    for (int k0 = 0; k0 < kBlock; k0 += kChunk) {
      // the X stripe: TT rows × kChunk columns, zero past the rows and
      // columns
      for (int e = threadIdx.x; e < TT * kChunk; e += kThreads) {
        const int t = e / kChunk;
        const int k = e % kChunk;
        const int64_t row = t0 + t;
        const int64_t col = col0 + k0 + k;
        xs[t][k] = (row < nt && col < n) ? X[row * n + col] : T(0);
      }
      // each block's 128 rows × kChunk columns, transposed
#pragma unroll
      for (int j = 0; j < NMAT; ++j) {
        const T* blk = mats.blocks[j] + boff;
        for (int e = threadIdx.x; e < kBlock * kChunk; e += kThreads) {
          const int i = e / kChunk;
          const int k = e % kChunk;
          bs[j][k][i] = blk[int64_t(i) * kBlock + k0 + k];
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
#pragma unroll
        for (int j = 0; j < NMAT; ++j) {
          T b[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) b[c] = bs[j][k][tx + kTx * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const T x = xs[ty + kTy * r][k];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              acc[j][r][c] = fma(x, b[c], acc[j][r][c]);
            }
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < NMAT; ++j) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int64_t row = t0 + ty + kTy * r;
      if (row >= nt) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t col = rb * kBlock + tx + kTx * c;
        if (col < n_out) mats.Y[j][row * n_out + col] = acc[j][r][c];
      }
    }
  }
}

template <typename T, int RPT, int NMAT>
int launch(const T* X, int64_t nt, int64_t n, const Mats<T, NMAT>& mats,
           const int* colidx, int64_t nrb, int64_t nslots, int64_t n_out,
           void* stream) {
  constexpr int TT = kTy * RPT;
  const dim3 grid(unsigned(nrb), unsigned((nt + TT - 1) / TT));
  ell_spmm_kernel<T, RPT, NMAT><<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      X, nt, n, mats, colidx, int(nslots), n_out);
  return int(cudaGetLastError());
}

// The time-row tile: the fewest rows per thread that cover min(T, 64).
template <typename T, int NMAT>
int launch_spmm(const T* X, int64_t nt, int64_t n, const Mats<T, NMAT>& mats,
                const int* colidx, int64_t nrb, int64_t nslots,
                int64_t n_out, void* stream) {
  if (nt > int64_t(kTy) * 8 * 65535 || nrb > 0x7fffffff) {
    return int(cudaErrorInvalidValue);
  }
  if (nt <= kTy) {
    return launch<T, 1>(X, nt, n, mats, colidx, nrb, nslots, n_out, stream);
  }
  if (nt <= 2 * kTy) {
    return launch<T, 2>(X, nt, n, mats, colidx, nrb, nslots, n_out, stream);
  }
  if (nt <= 4 * kTy) {
    return launch<T, 4>(X, nt, n, mats, colidx, nrb, nslots, n_out, stream);
  }
  return launch<T, 8>(X, nt, n, mats, colidx, nrb, nslots, n_out, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// the launch. X (nt, n), blocks (nrb, nslots, 128, 128), colidx (nrb,
// nslots) int32, Y (nt, n_out) with n_out ≤ nrb·128, all contiguous.
extern "C" {

#define ELL_ENTRY_POINTS(T, SFX)                                              \
  int ell_spmm_##SFX(const T* X, int64_t nt, int64_t n, const T* blocks,      \
                     const int* colidx, int64_t nrb, int64_t nslots, T* Y,    \
                     int64_t n_out, void* stream) {                           \
    const Mats<T, 1> mats{{blocks}, {Y}};                                     \
    return launch_spmm<T, 1>(X, nt, n, mats, colidx, nrb, nslots, n_out,      \
                             stream);                                         \
  }                                                                           \
  int ell_spmm_pair_##SFX(const T* X, int64_t nt, int64_t n,                  \
                          const T* blocksA, const T* blocksM,                 \
                          const int* colidx, int64_t nrb, int64_t nslots,     \
                          T* YA, T* YM, int64_t n_out, void* stream) {        \
    const Mats<T, 2> mats{{blocksA, blocksM}, {YA, YM}};                      \
    return launch_spmm<T, 2>(X, nt, n, mats, colidx, nrb, nslots, n_out,      \
                             stream);                                         \
  }

ELL_ENTRY_POINTS(float, f32)
ELL_ENTRY_POINTS(double, f64)

#undef ELL_ENTRY_POINTS

}  // extern "C"
