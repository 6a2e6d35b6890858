// The space-time operator B and its adjoint Bᵀ on structured grids, for
// sm_90a, with the stabilization term optionally fused in.
//
// U has shape (T+1, nz, ny, nx) and V, W have shape (T, nz, ny, nx), all
// contiguous (nz = 1 in 2-D). M and A are constant P1 stencils given as tap
// tables; taps outside the grid read 0, which is the Dirichlet guard.
//
//   kron_B   (replaces spacetime_tpu/ops/kron_pallas.py:290 _apply_B_call):
//     out[j] = M(U[j+1] - U[j]) + h_j/2 · A(U[j+1] + U[j])
//     stab:  W[j] = h_j/16 · A(U[j+1] - U[j])
//   kron_BT  (replaces spacetime_tpu/ops/kron_pallas.py:377 _apply_BT_call):
//     out[i] = [i<T](-M V[i] + h_i/2 A V[i]) + [i>=1](M V[i-1] + h_{i-1}/2 A V[i-1])
//     stab:  out[i] += W[i-1] - W[i]   (W[-1] = W[T] = 0)
//
// What bounds it: memory. One B application reads (T+1)·m and writes T·m
// values (Bᵀ the other way round): about 8.3 MB in f32 at 129²×64, which
// sits inside the H100's 50 MB L2, so at the main-path size the neighbour
// taps and the second time row are L2 hits, and the kernels are bound by
// L2 bandwidth and load-instruction throughput rather than HBM (plain B in
// f32 at 129²×64 measured 0.039 ms on an H100 80GB HBM3 at 700 W, about
// 212 GB/s of useful traffic). The design is the simple one: one thread
// per output point, x fastest so that a warp's loads coalesce, int64
// indexing, the tap table passed by value as a __grid_constant__ kernel
// parameter. Shared-memory tiles that reuse U[j+1] across output rows j
// and j+1, and TMA loads, are later work.
//
// Arithmetic follows the JAX package's order: taps summed within a weight
// group, one multiply per group, groups in order. The only difference is
// the compiler's FMA contraction of the multiply-adds.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxGroups = 16;
constexpr int kMaxTaps = 32;

// Weight groups of one stencil: group g holds taps [start[g], start[g+1]).
// Mirrored by ctypes in spacetime_tpu_torch/ops/native.py. At global scope
// because the C entry points below take it.
struct Taps {
  int n_groups;
  int start[kMaxGroups + 1];
  double weight[kMaxGroups];
  int dz[kMaxTaps];
  int dy[kMaxTaps];
  int dx[kMaxTaps];
};

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

struct Grid {
  int64_t nz, ny, nx;
};

// Σ_groups w_g · Σ_{taps of g} f(point + disp), f read through `load`.
template <typename T, typename Load>
__device__ __forceinline__ T apply_taps(const Taps& tp, const Grid& g,
                                        int64_t z, int64_t y, int64_t x,
                                        Load load) {
  T out = T(0);
  for (int gi = 0; gi < tp.n_groups; ++gi) {
    T acc = T(0);
    for (int k = tp.start[gi]; k < tp.start[gi + 1]; ++k) {
      const int64_t zz = z + tp.dz[k];
      const int64_t yy = y + tp.dy[k];
      const int64_t xx = x + tp.dx[k];
      if (zz >= 0 && zz < g.nz && yy >= 0 && yy < g.ny && xx >= 0 &&
          xx < g.nx) {
        acc += load((zz * g.ny + yy) * g.nx + xx);
      }
    }
    out += static_cast<T>(tp.weight[gi]) * acc;
  }
  return out;
}

template <typename T>
__global__ void kron_B_kernel(const T* __restrict__ U,
                              const T* __restrict__ h_half,
                              const T* __restrict__ h_stab,
                              T* __restrict__ out, T* __restrict__ W,
                              int64_t nt, Grid g,
                              const __grid_constant__ Taps tM,
                              const __grid_constant__ Taps tA, int stab) {
  const int64_t S = g.nz * g.ny * g.nx;
  const int64_t total = nt * S;
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       idx < total; idx += int64_t(gridDim.x) * blockDim.x) {
    const int64_t j = idx / S;
    const int64_t r = idx - j * S;
    const int64_t x = r % g.nx;
    const int64_t zy = r / g.nx;
    const int64_t y = zy % g.ny;
    const int64_t z = zy / g.ny;
    const T* U0 = U + j * S;
    const T* U1 = U0 + S;
    auto diff = [=](int64_t o) { return U1[o] - U0[o]; };
    auto sum = [=](int64_t o) { return U1[o] + U0[o]; };
    const T vm = apply_taps<T>(tM, g, z, y, x, diff);
    const T va = apply_taps<T>(tA, g, z, y, x, sum);
    out[idx] = vm + h_half[j] * va;
    if (stab) {
      W[idx] = h_stab[j] * apply_taps<T>(tA, g, z, y, x, diff);
    }
  }
}

template <typename T>
__global__ void kron_BT_kernel(const T* __restrict__ V,
                               const T* __restrict__ h_half,
                               const T* __restrict__ W,
                               T* __restrict__ out, int64_t nt, Grid g,
                               const __grid_constant__ Taps tM,
                               const __grid_constant__ Taps tA, int stab) {
  const int64_t S = g.nz * g.ny * g.nx;
  const int64_t total = (nt + 1) * S;
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       idx < total; idx += int64_t(gridDim.x) * blockDim.x) {
    const int64_t i = idx / S;
    const int64_t r = idx - i * S;
    const int64_t x = r % g.nx;
    const int64_t zy = r / g.nx;
    const int64_t y = zy % g.ny;
    const int64_t z = zy / g.ny;
    const bool has_cur = i < nt;   // the -M V[i] + h_i/2 A V[i] term
    const bool has_prev = i >= 1;  // the M V[i-1] + h_{i-1}/2 A V[i-1] term
    T a = T(0);
    T b = T(0);
    if (has_cur) {
      const T* Vi = V + i * S;
      auto ld = [=](int64_t o) { return Vi[o]; };
      const T vm = apply_taps<T>(tM, g, z, y, x, ld);
      const T va = h_half[i] * apply_taps<T>(tA, g, z, y, x, ld);
      a = -vm + va;
    }
    if (has_prev) {
      const T* Vp = V + (i - 1) * S;
      auto ld = [=](int64_t o) { return Vp[o]; };
      const T vm = apply_taps<T>(tM, g, z, y, x, ld);
      const T va = h_half[i - 1] * apply_taps<T>(tA, g, z, y, x, ld);
      b = vm + va;
    }
    T o = has_cur ? (has_prev ? a + b : a) : b;
    if (stab) {
      const T wp = has_prev ? W[(i - 1) * S + r] : T(0);
      const T wc = has_cur ? W[i * S + r] : T(0);
      o = o + (wp - wc);
    }
    out[idx] = o;
  }
}

int blocks_for(int64_t total) {
  int64_t b = (total + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return int(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
int launch_B(const T* U, const T* h_half, const T* h_stab, T* out, T* W,
             int64_t nt, int64_t nz, int64_t ny, int64_t nx, const Taps* tM,
             const Taps* tA, int stab, void* stream) {
  const Grid g{nz, ny, nx};
  kron_B_kernel<T><<<blocks_for(nt * nz * ny * nx), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      U, h_half, h_stab, out, W, nt, g, *tM, *tA, stab);
  return int(cudaGetLastError());
}

template <typename T>
int launch_BT(const T* V, const T* h_half, const T* W, T* out, int64_t nt,
              int64_t nz, int64_t ny, int64_t nx, const Taps* tM,
              const Taps* tA, int stab, void* stream) {
  const Grid g{nz, ny, nx};
  kron_BT_kernel<T><<<blocks_for((nt + 1) * nz * ny * nx), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      V, h_half, W, out, nt, g, *tM, *tA, stab);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// the launch; `W` and `h_stab` are ignored unless `stab` is non-zero.
extern "C" {

int kron_taps_size() { return int(sizeof(Taps)); }

const char* kron_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int kron_B_f32(const float* U, const float* h_half, const float* h_stab,
               float* out, float* W, int64_t nt, int64_t nz, int64_t ny,
               int64_t nx, const Taps* tM, const Taps* tA, int stab,
               void* stream) {
  return launch_B<float>(U, h_half, h_stab, out, W, nt, nz, ny, nx, tM, tA,
                         stab, stream);
}

int kron_B_f64(const double* U, const double* h_half, const double* h_stab,
               double* out, double* W, int64_t nt, int64_t nz, int64_t ny,
               int64_t nx, const Taps* tM, const Taps* tA, int stab,
               void* stream) {
  return launch_B<double>(U, h_half, h_stab, out, W, nt, nz, ny, nx, tM, tA,
                          stab, stream);
}

int kron_BT_f32(const float* V, const float* h_half, const float* W,
                float* out, int64_t nt, int64_t nz, int64_t ny, int64_t nx,
                const Taps* tM, const Taps* tA, int stab, void* stream) {
  return launch_BT<float>(V, h_half, W, out, nt, nz, ny, nx, tM, tA, stab,
                          stream);
}

int kron_BT_f64(const double* V, const double* h_half, const double* W,
                double* out, int64_t nt, int64_t nz, int64_t ny, int64_t nx,
                const Taps* tM, const Taps* tA, int stab, void* stream) {
  return launch_BT<double>(V, h_half, W, out, nt, nz, ny, nx, tM, tA, stab,
                           stream);
}

}  // extern "C"
