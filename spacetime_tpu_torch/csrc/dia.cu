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
// K17 0.096 ms, K18 0.063 ms. The values (17 MB there) have no time axis.
//
// Design. K16, K17 and K18 march in time (`dia_march_kernel`, one
// template, `Mode` the kernel and the step): a block owns a
// segment of the level's dofs, one thread a dof, and walks a chunk of time
// rows (`chunk`, picked by ops/dia_kernels.py `dia_chunk`). It loads its
// dofs' values vA, vM on the union offsets and dA, dM once (K18 vA
// alone), and holds them
// on chip for the whole chunk: in registers where the offsets number at
// most 16 (every level the repo solves: 11 in 2-D, 15 on tetrahedra), the
// taps unrolled to `NT` ∈ {12, 16} with those past the table's count
// predicated off; else in a shared-memory tile [k][dof] of 128 dofs that
// each thread fills and reads in its own column (no barrier), the taps
// read as they are summed (K18's tile is half of K17's: vA alone). A time
// row then reads only fields: the taps of x (or d) at the offsets, which
// coalesce along the segment and come mostly from the L1 and L2 (whether
// each lies in [0, m) is a mask worked out once a chunk), and the point's
// b (or r and the running x; K18 nothing more). The row
// `kPrefetchRows` ahead is requested into the L2 (no register holds it):
// a row's loads then wait on the L2 and not on HBM, and the bytes in
// flight an SM set the pace of such a march. 1/D is computed per row from
// the held diagonals. The register form asks for 3 blocks an SM in a K16
// step in float (`min_blocks`: 5 spilled, the compiler's own 2 held too
// few loads in flight). K16 is a chain of ν one-step launches (K3's
// chained design in csrc/mg.cu), r and d in device memory: a sweep's halo
// of ν bandwidths (~1,030 dofs per side at the nested fine level) would
// make a fused window half halo, and such a window lost to the chain on
// the H100 (PERF.md §6). The last step of a sweep writes x
// alone: r and d are dead after it. Every sum is a plain DIA matvec's
// (taps in offset order into A's and M's sums apart, then oA + ω·oM; K18
// A's sum alone), so the outputs do not depend on the form or the chunk.

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

constexpr int kThreads = 256;      // the register form's segment
constexpr int kTileThreads = 128;  // the shared form's segment
constexpr int kMaxRegTaps = 16;    // the most offsets the register form holds
constexpr int kPrefetchRows = 2;   // rows ahead whose fields go to the L2
constexpr int kDefaultSmem = 48 * 1024;

// What a march launch computes (`MODE`): K17, K16's first step from x or
// from x = 0, a later step of K16, and K18.
enum Mode { kResidual = 0, kFirst = 1, kFirstZero = 2, kStep = 3, kApply = 4 };

// The register form's least blocks an SM (`__launch_bounds__`): 3 for a
// K16 step in float, else 1 (the compiler's own choice), by timing on the
// H100 (PERF.md §6).
template <typename T, int MODE>
constexpr int min_blocks() {
  return MODE != kResidual && MODE != kApply && sizeof(T) == 4 ? 3 : 1;
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

// The fields one time row of a march reads at its point: the taps of y (x,
// or d for a later K16 step) in registers (NT of them; none for the shared
// form, which reads them as it sums), and the point's own values (K17 and
// a first step: b, x; a later step: r, x_out, d_in; K18: none).
template <typename T, int NT>
struct Row {
  T y[NT > 0 ? NT : 1];
  T p0, p1, p2;
};

// Requests the L2 line of p ahead of its load (no register holds it).
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// The fields of row t that the march reads at the point (tg = t·m + g),
// requested into the L2.
template <typename T, int MODE>
__device__ __forceinline__ void prefetch_row(const T* x, const T* b,
                                             const T* r, const T* d_in,
                                             const T* x_out, int64_t tg) {
  if constexpr (MODE == kStep) {
    prefetch_l2(d_in + tg);
    prefetch_l2(r + tg);
    prefetch_l2(x_out + tg);
  } else if constexpr (MODE == kApply) {
    prefetch_l2(x + tg);
  } else {
    prefetch_l2(b + tg);
    if constexpr (MODE != kFirstZero) prefetch_l2(x + tg);
  }
}

// Bit k: the tap g + off_k lies in [0, m).
__device__ __forceinline__ uint64_t valid_taps(int64_t g, int64_t m,
                                               const DiaOffsets& o) {
  uint64_t v = 0;
  for (int k = 0; k < o.n; ++k) {
    const int64_t j = g + o.off[k];
    if (j >= 0 && j < m) v |= uint64_t(1) << k;
  }
  return v;
}

template <typename T, int MODE, int NT>
__device__ __forceinline__ void load_row(Row<T, NT>& w, const T* __restrict__ x,
                                         const T* __restrict__ b,
                                         const T* __restrict__ r,
                                         const T* __restrict__ d_in,
                                         const T* __restrict__ x_out,
                                         int64_t tg, uint64_t valid,
                                         const DiaOffsets& o) {
  if constexpr (NT > 0 && MODE != kFirstZero) {
    const T* y = (MODE == kStep ? d_in : x) + tg;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      w.y[k] = (valid >> k) & 1 ? y[o.off[k]] : T(0);
    }
  }
  if constexpr (MODE == kStep) {
    w.p0 = r[tg];
    w.p1 = x_out[tg];
    w.p2 = d_in[tg];
  } else if constexpr (MODE != kApply) {
    w.p0 = b[tg];
    if constexpr (MODE == kFirst) w.p1 = x[tg];
  }
}

// K16, K17 and K18, marching over a chunk of time rows with the values
// held on chip: in registers, the taps unrolled to NT (NT > 0), or in the
// shared tile, the taps read as summed (NT = 0). In a K16 step `first`
// chooses the mode (from x, from x = 0 with x null); K17 writes b − Op x
// to x_out, K18 A x (vM, dA, dM, b, ω and the columns unread).
template <typename T, int MODE, int NT>
__global__ void __launch_bounds__(NT > 0 ? kThreads : kTileThreads,
                                  NT > 0 ? min_blocks<T, MODE>() : 1)
    dia_march_kernel(const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ vA, const T* __restrict__ vM,
                     const T* __restrict__ dA, const T* __restrict__ dM,
                     const T* __restrict__ omega, const T* __restrict__ invT,
                     const T* __restrict__ invDel, T* __restrict__ r,
                     const T* __restrict__ d_in, T* __restrict__ d_out,
                     T* __restrict__ x_out, int64_t nt, int64_t m,
                     DiaOffsets o, int chunk, int last, T c1, T c2) {
  constexpr int kSeg = NT > 0 ? kThreads : kTileThreads;
  constexpr bool kOp = MODE != kFirstZero;  // applies Op (K18: A alone)
  constexpr bool kM = kOp && MODE != kApply;  // holds and sums M
  const int64_t g = int64_t(blockIdx.x) * kSeg + threadIdx.x;
  if (g >= m) return;
  const int64_t t0 = int64_t(blockIdx.y) * chunk;
  const int64_t t1 = t0 + chunk < nt ? t0 + chunk : nt;
  const uint64_t valid = kOp ? valid_taps(g, m, o) : 0;
  for (int64_t t = t0; t < t0 + kPrefetchRows && t < t1; ++t) {
    prefetch_row<T, MODE>(x, b, r, d_in, x_out, t * m + g);
  }

  // the values, once for the chunk
  T a[NT > 0 ? NT : 1], mm[NT > 0 ? NT : 1];
  T* sA = nullptr;
  T* sM = nullptr;
  if constexpr (kOp && NT > 0) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      a[k] = k < o.n ? vA[k * m + g] : T(0);
      if constexpr (kM) mm[k] = k < o.n ? vM[k * m + g] : T(0);
    }
  } else if constexpr (kOp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    sA = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
    sM = sA + o.n * kSeg;
    for (int k = 0; k < o.n; ++k) {
      sA[k * kSeg] = vA[k * m + g];
      if constexpr (kM) sM[k * kSeg] = vM[k * m + g];
    }
  }
  T dAg = T(0), dMg = T(0);
  if constexpr (MODE != kResidual && MODE != kApply) {
    dAg = dA[g];
    dMg = dM[g];
  }

  Row<T, NT> w;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t tg = t * m + g;
    if (t + kPrefetchRows < t1) {
      prefetch_row<T, MODE>(x, b, r, d_in, x_out, tg + kPrefetchRows * m);
    }
    load_row<T, MODE>(w, x, b, r, d_in, x_out, tg, valid, o);
    const T om = MODE != kApply ? omega[t] : T(0);
    // (Σ_k vA[k, g]·y[g + off_k], Σ_k vM[k, g]·y[g + off_k]), 0 outside
    // [0, m), the taps in offset order
    T oA = T(0), oM = T(0);
    if constexpr (kOp && NT > 0) {
      T sa = T(0), sm = T(0);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (k < o.n) {
          sa += a[k] * w.y[k];
          if constexpr (kM) sm += mm[k] * w.y[k];
        }
      }
      oA = sa;
      oM = sm;
    } else if constexpr (kOp) {
      const T* y = (MODE == kStep ? d_in : x) + tg;
      T sa = T(0), sm = T(0);
      for (int k = 0; k < o.n; ++k) {
        const T yv = (valid >> k) & 1 ? y[o.off[k]] : T(0);
        sa += sA[k * kSeg] * yv;
        if constexpr (kM) sm += sM[k * kSeg] * yv;
      }
      oA = sa;
      oM = sm;
    }
    if constexpr (MODE == kApply) {
      x_out[tg] = oA;
    } else if constexpr (MODE == kResidual) {
      x_out[tg] = w.p0 - (oA + om * oM);
    } else {
      const T invd = T(1) / (dAg + om * dMg);
      if constexpr (MODE == kStep) {
        const T rr = w.p0 - invd * (oA + om * oM);
        const T dd = c1 * w.p2 + c2 * invDel[t] * rr;
        if (!last) {
          r[tg] = rr;
          d_out[tg] = dd;
        }
        x_out[tg] = w.p1 + dd;
      } else {
        T rhs = w.p0;
        if constexpr (MODE == kFirst) rhs = rhs - (oA + om * oM);
        const T rr = invd * rhs;
        const T dd = rr * invT[t];
        if (!last) {
          r[tg] = rr;
          d_out[tg] = dd;
        }
        if constexpr (MODE == kFirst) {
          x_out[tg] = w.p1 + dd;
        } else {
          x_out[tg] = dd;
        }
      }
    }
  }
}

bool bad_shape(int64_t nt, int64_t m, const DiaOffsets* o) {
  return nt < 1 || nt > 65535 || m < 1 || o->n < 1 || o->n > kMaxDiag;
}

// The march's kernel for (T, MODE) with n offsets, as a call of f(kernel,
// threads a block, dynamic shared bytes): the values in registers up to 16
// offsets, the taps unrolled to 12 or 16, else in the shared tile (vA and
// vM; K18 vA alone); cudaErrorInvalidValue for a table of no offsets or
// more than kMaxDiag.
template <typename T, int MODE, typename F>
int by_form(int n, F f) {
  if (n < 1 || n > kMaxDiag) return int(cudaErrorInvalidValue);
  if constexpr (MODE == kFirstZero) {  // holds no values: one kernel
    return f(dia_march_kernel<T, kFirstZero, 1>, kThreads, size_t(0));
  } else {
    if (n > kMaxRegTaps) {
      return f(dia_march_kernel<T, MODE, 0>, kTileThreads,
               size_t((MODE == kApply ? 1 : 2) * n) * kTileThreads *
                   sizeof(T));
    }
    return n <= 12 ? f(dia_march_kernel<T, MODE, 12>, kThreads, size_t(0))
                   : f(dia_march_kernel<T, MODE, 16>, kThreads, size_t(0));
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > size_t(kDefaultSmem)) {
    return int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
  }
  return 0;
}

template <typename T, int MODE>
int launch_march(const T* x, const T* b, const T* vA, const T* vM,
                 const T* dA, const T* dM, const T* omega, const T* invT,
                 const T* invDel, T* r, const T* d_in, T* d_out, T* x_out,
                 int64_t nt, int64_t m, const DiaOffsets* o, int last,
                 double c1, double c2, int chunk, void* stream) {
  if (bad_shape(nt, m, o) || chunk < 1) return int(cudaErrorInvalidValue);
  return by_form<T, MODE>(o->n, [&](auto kernel, int threads, size_t bytes) {
    const int err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    const dim3 grid(unsigned((m + threads - 1) / threads),
                    unsigned((nt + chunk - 1) / chunk));
    kernel<<<grid, threads, bytes, as_stream(stream)>>>(
        x, b, vA, vM, dA, dM, omega, invT, invDel, r, d_in, d_out, x_out, nt,
        m, *o, chunk, last, T(c1), T(c2));
    return int(cudaGetLastError());
  });
}

template <typename T>
int launch_smooth_step(const T* x, const T* b, const T* vA, const T* vM,
                       const T* dA, const T* dM, const T* omega, const T* invT,
                       const T* invDel, T* r, const T* d_in, T* d_out,
                       T* x_out, int64_t nt, int64_t m, const DiaOffsets* o,
                       int first, double c1, double c2, int last, int chunk,
                       void* stream) {
  if (!first) {
    if (d_in == nullptr) return int(cudaErrorInvalidValue);
    return launch_march<T, kStep>(x, b, vA, vM, dA, dM, omega, invT, invDel,
                                  r, d_in, d_out, x_out, nt, m, o, last, c1,
                                  c2, chunk, stream);
  }
  return (x != nullptr ? launch_march<T, kFirst> : launch_march<T, kFirstZero>)(
      x, b, vA, vM, dA, dM, omega, invT, invDel, r, d_in, d_out, x_out, nt, m,
      o, last, c1, c2, chunk, stream);
}

template <typename T, int MODE>
int march_occupancy(int n, int* blocks, int* bytes, int* threads) {
  return by_form<T, MODE>(n, [&](auto kernel, int nthreads, size_t nbytes) {
    const int err = allow_smem(kernel, nbytes);
    if (err != 0) return err;
    *bytes = int(nbytes);
    *threads = nthreads;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, nthreads, nbytes));
  });
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// its launch. Fields (nt, m), values (ndu, m), diagonals (m,), columns
// (nt,), all contiguous; the offsets by pointer. Each takes the time rows
// a block walks (chunk ≥ 1); a K16 step with `last` writes x_out alone.
extern "C" {

int dia_offsets_size() { return int(sizeof(DiaOffsets)); }

// The march's plan for `mode` (0 K17, 1 a first K16 step from x, 2 from x
// = 0, 3 a later step, 4 K18), the dtype and n offsets: blocks an SM holds,
// dynamic shared bytes (none where the values sit in registers) and
// threads a block (a segment's dofs).
int dia_march_occupancy(int mode, int f64, int n, int* blocks, int* bytes,
                        int* threads) {
  switch (mode * 2 + (f64 ? 1 : 0)) {
#define DIA_OCC(M)                                                         \
  case 2 * M:                                                              \
    return march_occupancy<float, M>(n, blocks, bytes, threads);           \
  case 2 * M + 1:                                                          \
    return march_occupancy<double, M>(n, blocks, bytes, threads);
    DIA_OCC(kResidual)
    DIA_OCC(kFirst)
    DIA_OCC(kFirstZero)
    DIA_OCC(kStep)
    DIA_OCC(kApply)
#undef DIA_OCC
    default:
      return int(cudaErrorInvalidValue);
  }
}

#define DIA_ENTRY_POINTS(T, SFX)                                              \
  int dia_smooth_##SFX(const T* x, const T* b, const T* vA, const T* vM,      \
                       const T* dA, const T* dM, const T* omega,              \
                       const T* invT, const T* invDel, T* r, const T* d_in,   \
                       T* d_out, T* x_out, int64_t nt, int64_t m,             \
                       const DiaOffsets* o, int first, double c1, double c2,  \
                       int last, int chunk, void* stream) {                   \
    return launch_smooth_step<T>(x, b, vA, vM, dA, dM, omega, invT, invDel,   \
                                 r, d_in, d_out, x_out, nt, m, o, first, c1,  \
                                 c2, last, chunk, stream);                    \
  }                                                                           \
  int dia_residual_##SFX(const T* x, const T* b, const T* vA, const T* vM,    \
                         const T* omega, T* out, int64_t nt, int64_t m,       \
                         const DiaOffsets* o, int chunk, void* stream) {      \
    return launch_march<T, kResidual>(x, b, vA, vM, nullptr, nullptr, omega,  \
                                      nullptr, nullptr, nullptr, nullptr,     \
                                      nullptr, out, nt, m, o, 0, 0.0, 0.0,    \
                                      chunk, stream);                         \
  }                                                                           \
  int dia_apply_##SFX(const T* x, const T* vA, T* out, int64_t nt, int64_t m, \
                      const DiaOffsets* o, int chunk, void* stream) {         \
    return launch_march<T, kApply>(x, nullptr, vA, nullptr, nullptr, nullptr, \
                                   nullptr, nullptr, nullptr, nullptr,        \
                                   nullptr, nullptr, out, nt, m, o, 0, 0.0,   \
                                   0.0, chunk, stream);                       \
  }

DIA_ENTRY_POINTS(float, f32)
DIA_ENTRY_POINTS(double, f64)

#undef DIA_ENTRY_POINTS

}  // extern "C"
