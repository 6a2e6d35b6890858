// K16–K18: the banded-DIA kernels of the flat-dof multigrid levels (the
// nested red-refinement hierarchy and the smoothed-aggregation fine level),
// for sm_90a, in float and double. They replace spacetime_tpu/ops/
// dia_pallas.py:156 _dia_smooth_call (K16), :258 _dia_residual_call (K17)
// and :315 _dia_apply_call (K18).
//
// A level holds A and M on the union of their diagonal offsets (sorted;
// zero rows where a matrix lacks one): vA[k, i] = A[i, i + off[k]], vM
// likewise, (ndu, m) row-major, and the diagonals dA, dM (m,). Fields are
// (T, m) row-major, one shift ω per time row. With x read as 0 outside
// [0, m) (the DIA matvec's zero extension):
//
//   Op(y)[t, i] = Σ_k vA[k, i]·y[t, i + off_k] + ω_t·Σ_k vM[k, i]·y[t, i + off_k]
//
//   K16 the degree-ν Chebyshev–Jacobi sweep with the per-node Jacobi term
//       1/D = 1/(dA + ω·dM), from x or from x = 0 (ops/multigrid.py
//       cheb_smooth's recurrence, σ = 5/3);
//   K17 b − Op(x);
//   K18 Σ_k vA[k, i]·x[t, i + off_k], A alone.
//
// What bounds them: bytes. At the 25.2 MDoF nested fine level (T = 129, m
// = 195,585, 11 offsets, f32) K16 from x moves 321.5 MB (x, b and the
// output once each, the values and diagonals once): 0.096 ms at 3.35 TB/s;
// K17 0.096 ms, K18 0.063 ms. The values (17 MB there) are read by every
// time row and stay in the 50 MB L2.
//
// Design, the simple one: one thread per (row, dof), the taps read from
// device memory through the L1, 0 outside [0, m). K16 runs as ν launches
// of a one-step kernel (K3's chained design in csrc/mg.cu) with r and d in
// device memory: a sweep's halo of ν bandwidths (~1,030 dofs per side at
// n = 512) would make a shared-memory window half halo, and the chained
// form measured faster than such a window on the nested fine level.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxDiag = 64;

// outside the anonymous namespace: the C entry points take it, and a type
// of internal linkage would hide them from the library's symbol table
struct DiaOffsets {
  int n;   // union offsets
  int off[kMaxDiag];
};

namespace {

constexpr int kThreads = 256;

// (Σ_k vA[k, g]·y[g + off_k], Σ_k vM[k, g]·y[g + off_k]) on a row of
// device memory, reading 0 outside [0, m)
template <typename T>
__device__ __forceinline__ void pair_sums_row(const T* __restrict__ vA,
                                              const T* __restrict__ vM,
                                              int64_t m, int64_t g,
                                              const T* __restrict__ y,
                                              const DiaOffsets& o, T& oA,
                                              T& oM) {
  T sa = T(0), sm = T(0);
  for (int k = 0; k < o.n; ++k) {
    const int64_t j = g + o.off[k];
    const T yv = (j >= 0 && j < m) ? y[j] : T(0);
    sa += vA[k * m + g] * yv;
    sm += vM[k * m + g] * yv;
  }
  oA = sa;
  oM = sm;
}

template <typename T>
__device__ __forceinline__ T inv_diag(const T* __restrict__ dA,
                                      const T* __restrict__ dM, int64_t g,
                                      T om) {
  return T(1) / (dA[g] + om * dM[g]);
}

// K16: one Chebyshev step per launch, one thread per (row, dof).
// first: r = 1/D·(b − Op x) (b with x = null), d_out = r/θ, x_out = x +
// d_out; else r −= 1/D·Op d_in, d_out = c1·d_in + c2/δ·r, x_out += d_out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_smooth_step_kernel(const T* __restrict__ x, const T* __restrict__ b,
                           const T* __restrict__ vA, const T* __restrict__ vM,
                           const T* __restrict__ dA, const T* __restrict__ dM,
                           const T* __restrict__ omega,
                           const T* __restrict__ invT,
                           const T* __restrict__ invDel, T* __restrict__ r,
                           const T* __restrict__ d_in, T* __restrict__ d_out,
                           T* __restrict__ x_out, int64_t m, DiaOffsets o,
                           int first, T c1, T c2) {
  const int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= m) return;
  const int64_t t = blockIdx.y;
  const int64_t tg = t * m + g;
  const T om = omega[t];
  const T invd = inv_diag(dA, dM, g, om);
  if (first) {
    T rhs = b[tg];
    if (x != nullptr) {
      T oA, oM;
      pair_sums_row(vA, vM, m, g, x + t * m, o, oA, oM);
      rhs = rhs - (oA + om * oM);
    }
    const T rr = invd * rhs;
    const T dd = rr * invT[t];
    r[tg] = rr;
    d_out[tg] = dd;
    x_out[tg] = x != nullptr ? x[tg] + dd : dd;
    return;
  }
  T oA, oM;
  pair_sums_row(vA, vM, m, g, d_in + t * m, o, oA, oM);
  const T rr = r[tg] - invd * (oA + om * oM);
  r[tg] = rr;
  const T dd = c1 * d_in[tg] + c2 * invDel[t] * rr;
  d_out[tg] = dd;
  x_out[tg] = x_out[tg] + dd;
}

// K17: b − Op x
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_residual_kernel(const T* __restrict__ x, const T* __restrict__ b,
                        const T* __restrict__ vA, const T* __restrict__ vM,
                        const T* __restrict__ omega, T* __restrict__ out,
                        int64_t m, DiaOffsets o) {
  const int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= m) return;
  const int64_t t = blockIdx.y;
  T oA, oM;
  pair_sums_row(vA, vM, m, g, x + t * m, o, oA, oM);
  out[t * m + g] = b[t * m + g] - (oA + omega[t] * oM);
}

// K18: A x
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_apply_kernel(const T* __restrict__ x, const T* __restrict__ vA,
                     T* __restrict__ out, int64_t m, DiaOffsets o) {
  const int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= m) return;
  const int64_t t = blockIdx.y;
  const T* xrow = x + t * m;
  T s = T(0);
  for (int k = 0; k < o.n; ++k) {
    const int64_t j = g + o.off[k];
    s += vA[k * m + g] * ((j >= 0 && j < m) ? xrow[j] : T(0));
  }
  out[t * m + g] = s;
}

bool bad_shape(int64_t nt, int64_t m, const DiaOffsets* o) {
  return nt < 1 || nt > 65535 || m < 1 || o->n < 1 || o->n > kMaxDiag;
}

dim3 point_grid(int64_t nt, int64_t m) {
  return dim3(unsigned((m + kThreads - 1) / kThreads), unsigned(nt));
}

template <typename T>
int launch_smooth_step(const T* x, const T* b, const T* vA, const T* vM,
                       const T* dA, const T* dM, const T* omega, const T* invT,
                       const T* invDel, T* r, const T* d_in, T* d_out,
                       T* x_out, int64_t nt, int64_t m, const DiaOffsets* o,
                       int first, double c1, double c2, void* stream) {
  if (bad_shape(nt, m, o) || (!first && d_in == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  dia_smooth_step_kernel<T><<<point_grid(nt, m), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, b, vA, vM, dA, dM, omega, invT, invDel, r, d_in, d_out, x_out, m, *o,
      first, T(c1), T(c2));
  return int(cudaGetLastError());
}

template <typename T>
int launch_residual(const T* x, const T* b, const T* vA, const T* vM,
                    const T* omega, T* out, int64_t nt, int64_t m,
                    const DiaOffsets* o, void* stream) {
  if (bad_shape(nt, m, o)) return int(cudaErrorInvalidValue);
  dia_residual_kernel<T><<<point_grid(nt, m), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, b, vA, vM, omega, out, m, *o);
  return int(cudaGetLastError());
}

template <typename T>
int launch_apply(const T* x, const T* vA, T* out, int64_t nt, int64_t m,
                 const DiaOffsets* o, void* stream) {
  if (bad_shape(nt, m, o)) return int(cudaErrorInvalidValue);
  dia_apply_kernel<T><<<point_grid(nt, m), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, vA, out, m,
                                                             *o);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// its launch. Fields (nt, m), values (ndu, m), diagonals (m,), columns
// (nt,), all contiguous; the offsets by pointer.
extern "C" {

int dia_offsets_size() { return int(sizeof(DiaOffsets)); }

#define DIA_ENTRY_POINTS(T, SFX)                                              \
  int dia_smooth_##SFX(const T* x, const T* b, const T* vA, const T* vM,      \
                       const T* dA, const T* dM, const T* omega,              \
                       const T* invT, const T* invDel, T* r, const T* d_in,   \
                       T* d_out, T* x_out, int64_t nt, int64_t m,             \
                       const DiaOffsets* o, int first, double c1, double c2,  \
                       void* stream) {                                        \
    return launch_smooth_step<T>(x, b, vA, vM, dA, dM, omega, invT, invDel,   \
                                 r, d_in, d_out, x_out, nt, m, o, first, c1,  \
                                 c2, stream);                                 \
  }                                                                           \
  int dia_residual_##SFX(const T* x, const T* b, const T* vA, const T* vM,    \
                         const T* omega, T* out, int64_t nt, int64_t m,       \
                         const DiaOffsets* o, void* stream) {                 \
    return launch_residual<T>(x, b, vA, vM, omega, out, nt, m, o, stream);    \
  }                                                                           \
  int dia_apply_##SFX(const T* x, const T* vA, T* out, int64_t nt, int64_t m, \
                      const DiaOffsets* o, void* stream) {                    \
    return launch_apply<T>(x, vA, out, nt, m, o, stream);                     \
  }

DIA_ENTRY_POINTS(float, f32)
DIA_ENTRY_POINTS(double, f64)

#undef DIA_ENTRY_POINTS

}  // extern "C"
