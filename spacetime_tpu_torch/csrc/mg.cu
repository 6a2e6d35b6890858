// The multi-shift multigrid V-cycle kernels on 2-D structured grids, for
// sm_90a, in float and double.
//
// Op = A + ω⊙M on a (T, ny, nx) field, one shift ω_t per time row. A and M
// are constant P1 stencils given as one table of (wA, wM) pair groups: the
// taps of a group are summed once and multiplied by the row's weight
// wA + ω_t·wM (wA alone when wM = 0, ω_t·wM alone when wA = 0), and the
// groups are added in order. This is `_op_rows` of
// spacetime_tpu/ops/mg_pallas.py:156. Values outside [0, ny) × [0, nx)
// are the zero Dirichlet ghost. The Chebyshev–Jacobi sweep of degree ν is
//
//   r = D⁻¹(b − Op x),  d = r/θ,  x += d,
//   ν−1 times:  r −= D⁻¹ Op d,  d = ρ'ρ d + 2ρ' r/δ,  x += d
//
// with σ = 5/3, ρ = 1/σ, ρ' = 1/(2σ − ρ) and 1/D, 1/θ, 1/δ per time row.
//
//   mg_smooth    (K3, replaces _smooth_call, mg_pallas.py:190): the sweep,
//                from x or from x = 0 (zero_init).
//   mg_residual  (K4, replaces _residual_call, :316): b − Op x.
//   mg_apply     (K5, replaces _apply_stencil_call, :375): A x, one stencil
//                (the pair table with every wM = 0).
//   mg_fused_pre (K6, replaces _fused_pre_call, :1318): x = the zero-init
//                sweep on b, then r_c = R(b − Op x) on the coarse grid
//                ((ny−1)/2, (nx−1)/2): r_c[c] = ½ Σ_{f ∈ {2c, 2c+1}²}
//                (r[f] + r[f + (1,1)]).
//   mg_fused_post (K7, replaces _fused_post_call, :1475): the sweep from
//                x + P e_c, with P e_c[f] = ½ (e_c[f/2] + e_c[(f−1)/2])
//                per axis (floor division, zero beyond the coarse grid).
//
// What bounds them: memory traffic and instruction count, not arithmetic.
// A sweep applies Op ν times, ~7 taps each, to data that is read once: the
// fused kernels keep every intermediate (r, d, x, the fine residual and the
// prolonged correction) out of device memory, so K6 reads b and writes x
// and r_c, and K7 reads x, b and e_c and writes x: 2–3 fields per V-cycle
// level visit where the plain PyTorch form moves ~15 fields per Op.
//
// Design, the simple one:
// - K4 and K5: one thread per output point, x fastest so that a warp's
//   loads coalesce, int64 indexing, the pair table passed by value as a
//   __grid_constant__ kernel parameter (as kron.cu).
// - K3, K6, K7: one block of 256 threads owns a 32 × 32 tile of one time
//   row (blockIdx.z = row). It loads the tile and a halo into shared
//   memory and runs the recurrence there, each Op application shrinking
//   the valid halo by one cell, with __syncthreads() between the stages.
//   Halo: ν−1 for the zero-init sweep (G of the Pallas kernel, :214), ν
//   for the sweep from x, ν + 1 for K6 (G + E, E = 2 for the residual and
//   the restriction, :1342), ν for K7's prolonged field (:1525). Points of
//   the window outside the grid hold 0 in every buffer, which is the
//   Dirichlet ghost (`_domain_mask`, :122) for tiles on the boundary and
//   for ragged extents. Tiles start at multiples of 32, so fine tiles start
//   at even offsets and a coarse point's four fine pairs lie in its own
//   tile plus one fine row and column of halo.
// - The restriction and the prolongation are exact pair sums; the Pallas
//   kernels' banded 0/1 matrices on the MXU (`_dot_last`, :1253) are a TPU
//   device and are not ported.
//
// Sum order is the plain PyTorch twin's (spacetime_tpu_torch/ops/
// mg_kernels.py): taps in table order within a group, one multiply per
// group, groups in order, the recurrence scalars rounded as the twin
// rounds them. The only difference is the compiler's FMA contraction.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxPairGroups = 16;
constexpr int kMaxPairTaps = 32;

// (wA, wM) pair groups of two stencils on one grid: group g holds taps
// [start[g], start[g+1]). Mirrored by ctypes in
// spacetime_tpu_torch/ops/native.py.
struct PairGroups {
  int n_groups;
  int start[kMaxPairGroups + 1];
  double wa[kMaxPairGroups];
  double wm[kMaxPairGroups];
  int dy[kMaxPairTaps];
  int dx[kMaxPairTaps];
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kHalfTile = kTile / 2;
constexpr int64_t kMaxBlocks = 1 << 16;
constexpr double kSigma = 5.0 / 3.0;
// Above this much dynamic shared memory a kernel needs its limit raised
// (48 KB, less room for the static group weights).
constexpr int kDefaultSmem = 47 * 1024;

// The combined weight of group g on a row with shift om.
template <typename T>
__device__ __forceinline__ T group_weight(const PairGroups& pg, int g, T om) {
  const double wa = pg.wa[g];
  const double wm = pg.wm[g];
  if (wm == 0.0) return T(wa);
  if (wa == 0.0) return om * T(wm);
  return T(wa) + om * T(wm);
}

// Op at grid point (y, x) of one row X in device memory (zero outside).
template <typename T>
__device__ __forceinline__ T op_global(const PairGroups& pg, T om,
                                       const T* __restrict__ X, int64_t ny,
                                       int64_t nx, int64_t y, int64_t x) {
  T out = T(0);
  for (int g = 0; g < pg.n_groups; ++g) {
    T acc = T(0);
    for (int k = pg.start[g]; k < pg.start[g + 1]; ++k) {
      const int64_t yy = y + pg.dy[k];
      const int64_t xx = x + pg.dx[k];
      if (yy >= 0 && yy < ny && xx >= 0 && xx < nx) acc += X[yy * nx + xx];
    }
    out += group_weight(pg, g, om) * acc;
  }
  return out;
}

// Op at window point (ly, lx) of a shared-memory buffer whose out-of-grid
// points hold 0; w holds the row's group weights.
template <typename T>
__device__ __forceinline__ T op_shared(const PairGroups& pg, const T* w,
                                       const T* buf, int pitch, int ly,
                                       int lx) {
  T out = T(0);
  for (int g = 0; g < pg.n_groups; ++g) {
    T acc = T(0);
    for (int k = pg.start[g]; k < pg.start[g + 1]; ++k) {
      acc += buf[(ly + pg.dy[k]) * pitch + lx + pg.dx[k]];
    }
    out += w[g] * acc;
  }
  return out;
}

// A tile of one row and its halo in shared memory: window point (ly, lx)
// is grid point (y0 + ly, x0 + lx).
struct Window {
  int64_t ny, nx;
  int64_t y0, x0;
  int H;      // halo of the window around the kTile × kTile tile
  int pitch;  // kTile + 2H
};

__device__ __forceinline__ Window make_window(int64_t ny, int64_t nx, int H) {
  return Window{ny, nx, int64_t(blockIdx.y) * kTile - H,
                int64_t(blockIdx.x) * kTile - H, H, kTile + 2 * H};
}

// f(offset, ly, lx, row offset in the grid, inside the grid) for every
// point of the tile grown by h cells on each side, spread over the block.
template <typename F>
__device__ __forceinline__ void for_region(const Window& w, int h, F f) {
  const int n = kTile + 2 * h;
  const int s = w.H - h;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int ly = s + i / n;
    const int lx = s + i % n;
    const int64_t gy = w.y0 + ly;
    const int64_t gx = w.x0 + lx;
    const bool inside = gy >= 0 && gy < w.ny && gx >= 0 && gx < w.nx;
    f(ly * w.pitch + lx, ly, lx, gy * w.nx + gx, inside);
  }
}

template <typename T>
struct RowCoef {
  T om, iD, iT, iDel;
};

// The degree-nu sweep on the window. X holds x on the tile grown by hi + 1
// cells (zero outside the grid) unless zero_init; b is the row in device
// memory. On return X holds the smoothed x on the tile grown by
// hi − (nu − 1) cells. Ends with a __syncthreads().
template <typename T>
__device__ void cheb_sweep(const PairGroups& pg, const T* w,
                           const RowCoef<T>& c, const T* __restrict__ b,
                           const Window& win, T* X, T* D, T* R, int nu,
                           bool zero_init, int hi) {
  if (zero_init) {
    for_region(win, hi, [&](int o, int, int, int64_t g, bool in) {
      const T r = in ? c.iD * b[g] : T(0);
      const T d = r * c.iT;
      R[o] = r;
      D[o] = d;
      X[o] = d;
    });
    __syncthreads();
  } else {
    for_region(win, hi, [&](int o, int ly, int lx, int64_t g, bool in) {
      R[o] = in ? c.iD * (b[g] - op_shared(pg, w, X, win.pitch, ly, lx))
                : T(0);
    });
    __syncthreads();
    for_region(win, hi, [&](int o, int, int, int64_t, bool in) {
      const T d = in ? R[o] * c.iT : T(0);
      D[o] = d;
      X[o] = X[o] + d;
    });
    __syncthreads();
  }
  double rho = 1.0 / kSigma;
  for (int k = 1; k < nu; ++k) {
    const double rho_new = 1.0 / (2.0 * kSigma - rho);
    const T c1 = T(rho_new * rho);
    const T c2 = T(2.0 * rho_new) * c.iDel;
    for_region(win, hi - k, [&](int o, int ly, int lx, int64_t, bool in) {
      if (in) R[o] = R[o] - c.iD * op_shared(pg, w, D, win.pitch, ly, lx);
    });
    __syncthreads();
    for_region(win, hi - k, [&](int o, int, int, int64_t, bool in) {
      if (in) {
        const T d = c1 * D[o] + c2 * R[o];
        D[o] = d;
        X[o] = X[o] + d;
      }
    });
    __syncthreads();
    rho = rho_new;
  }
}

// Shared memory of the tiled kernels: X, D and R over the window.
template <typename T>
__device__ __forceinline__ T* window_buffers() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

template <typename T>
__device__ __forceinline__ RowCoef<T> row_coef(const T* omega, const T* invD,
                                               const T* invT,
                                               const T* invDel, int64_t t) {
  return RowCoef<T>{omega[t], invD[t], invT[t], invDel[t]};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mg_smooth_kernel(const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ omega, const T* __restrict__ invD,
                     const T* __restrict__ invT,
                     const T* __restrict__ invDel, T* __restrict__ out,
                     int64_t ny, int64_t nx,
                     const __grid_constant__ PairGroups pg, int nu,
                     int zero_init) {
  __shared__ T wts[kMaxPairGroups];
  const int64_t t = blockIdx.z;
  const int64_t S = ny * nx;
  const RowCoef<T> c = row_coef(omega, invD, invT, invDel, t);
  if (threadIdx.x < pg.n_groups) {
    wts[threadIdx.x] = group_weight(pg, int(threadIdx.x), c.om);
  }
  const int H = zero_init ? nu - 1 : nu;
  const Window win = make_window(ny, nx, H);
  const int area = win.pitch * win.pitch;
  T* X = window_buffers<T>();
  T* D = X + area;
  T* R = D + area;
  if (!zero_init) {
    const T* xt = x + t * S;
    for_region(win, H, [&](int o, int, int, int64_t g, bool in) {
      X[o] = in ? xt[g] : T(0);
    });
  }
  __syncthreads();
  cheb_sweep(pg, wts, c, b + t * S, win, X, D, R, nu, zero_init != 0,
             zero_init ? H : H - 1);
  T* ot = out + t * S;
  for_region(win, 0, [&](int o, int, int, int64_t g, bool in) {
    if (in) ot[g] = X[o];
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mg_fused_pre_kernel(const T* __restrict__ b, const T* __restrict__ omega,
                        const T* __restrict__ invD,
                        const T* __restrict__ invT,
                        const T* __restrict__ invDel, T* __restrict__ xo,
                        T* __restrict__ rco, int64_t ny, int64_t nx,
                        const __grid_constant__ PairGroups pg, int nu) {
  __shared__ T wts[kMaxPairGroups];
  const int64_t t = blockIdx.z;
  const int64_t S = ny * nx;
  const int64_t nyc = (ny - 1) / 2;
  const int64_t nxc = (nx - 1) / 2;
  const RowCoef<T> c = row_coef(omega, invD, invT, invDel, t);
  if (threadIdx.x < pg.n_groups) {
    wts[threadIdx.x] = group_weight(pg, int(threadIdx.x), c.om);
  }
  const int H = nu + 1;
  const Window win = make_window(ny, nx, H);
  const int area = win.pitch * win.pitch;
  T* X = window_buffers<T>();
  T* D = X + area;
  T* R = D + area;
  const T* bt = b + t * S;
  __syncthreads();
  cheb_sweep(pg, wts, c, bt, win, X, D, R, nu, true, H);
  // X is valid on the tile grown by 2; the residual on the tile grown by 1
  // (one fine row and column past the tile is what the restriction reads).
  for_region(win, 1, [&](int o, int ly, int lx, int64_t g, bool in) {
    R[o] = in ? bt[g] - op_shared(pg, wts, X, win.pitch, ly, lx) : T(0);
  });
  T* xt = xo + t * S;
  for_region(win, 0, [&](int o, int, int, int64_t g, bool in) {
    if (in) xt[g] = X[o];
  });
  __syncthreads();
  T* rct = rco + t * nyc * nxc;
  for (int i = threadIdx.x; i < kHalfTile * kHalfTile; i += blockDim.x) {
    const int lcy = i / kHalfTile;
    const int lcx = i % kHalfTile;
    const int64_t cy = int64_t(blockIdx.y) * kHalfTile + lcy;
    const int64_t cx = int64_t(blockIdx.x) * kHalfTile + lcx;
    if (cy >= nyc || cx >= nxc) continue;
    const int o = (H + 2 * lcy) * win.pitch + H + 2 * lcx;  // fine (2cy, 2cx)
    const int p = win.pitch;
    auto h = [&](int dy, int dx) {
      const int q = o + dy * p + dx;
      return R[q] + R[q + p + 1];
    };
    const T p0 = h(0, 0) + h(1, 0);
    const T p1 = h(0, 1) + h(1, 1);
    rct[cy * nxc + cx] = T(0.5) * (p0 + p1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mg_fused_post_kernel(const T* __restrict__ x, const T* __restrict__ b,
                         const T* __restrict__ ec,
                         const T* __restrict__ omega,
                         const T* __restrict__ invD,
                         const T* __restrict__ invT,
                         const T* __restrict__ invDel, T* __restrict__ out,
                         int64_t ny, int64_t nx,
                         const __grid_constant__ PairGroups pg, int nu) {
  __shared__ T wts[kMaxPairGroups];
  const int64_t t = blockIdx.z;
  const int64_t S = ny * nx;
  const int64_t nyc = (ny - 1) / 2;
  const int64_t nxc = (nx - 1) / 2;
  const RowCoef<T> c = row_coef(omega, invD, invT, invDel, t);
  if (threadIdx.x < pg.n_groups) {
    wts[threadIdx.x] = group_weight(pg, int(threadIdx.x), c.om);
  }
  const int H = nu;
  const Window win = make_window(ny, nx, H);
  const int area = win.pitch * win.pitch;
  T* X = window_buffers<T>();
  T* D = X + area;
  T* R = D + area;
  const T* xt = x + t * S;
  const T* et = ec + t * nyc * nxc;
  auto coarse = [&](int64_t cy, int64_t cx) {
    return (cy >= 0 && cy < nyc && cx >= 0 && cx < nxc) ? et[cy * nxc + cx]
                                                        : T(0);
  };
  // x + P e_c on the tile grown by nu
  for_region(win, H, [&](int o, int ly, int lx, int64_t g, bool in) {
    if (!in) {
      X[o] = T(0);
      return;
    }
    const int64_t fy = win.y0 + ly;
    const int64_t fx = win.x0 + lx;
    const T e0 = coarse(fy / 2, fx / 2);
    const T e1 = (fy >= 1 && fx >= 1) ? coarse((fy - 1) / 2, (fx - 1) / 2)
                                      : T(0);
    X[o] = xt[g] + T(0.5) * (e0 + e1);
  });
  __syncthreads();
  cheb_sweep(pg, wts, c, b + t * S, win, X, D, R, nu, false, H - 1);
  T* ot = out + t * S;
  for_region(win, 0, [&](int o, int, int, int64_t g, bool in) {
    if (in) ot[g] = X[o];
  });
}

template <typename T>
__global__ void mg_residual_kernel(const T* __restrict__ x,
                                   const T* __restrict__ b,
                                   const T* __restrict__ omega,
                                   T* __restrict__ out, int64_t nt,
                                   int64_t ny, int64_t nx,
                                   const __grid_constant__ PairGroups pg) {
  const int64_t S = ny * nx;
  const int64_t total = nt * S;
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       idx < total; idx += int64_t(gridDim.x) * blockDim.x) {
    const int64_t t = idx / S;
    const int64_t r = idx - t * S;
    const int64_t y = r / nx;
    const int64_t xx = r - y * nx;
    out[idx] = b[idx] - op_global(pg, omega[t], x + t * S, ny, nx, y, xx);
  }
}

template <typename T>
__global__ void mg_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int64_t nt, int64_t ny, int64_t nx,
                                const __grid_constant__ PairGroups pg) {
  const int64_t S = ny * nx;
  const int64_t total = nt * S;
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       idx < total; idx += int64_t(gridDim.x) * blockDim.x) {
    const int64_t t = idx / S;
    const int64_t r = idx - t * S;
    const int64_t y = r / nx;
    const int64_t xx = r - y * nx;
    out[idx] = op_global(pg, T(0), x + t * S, ny, nx, y, xx);
  }
}

int blocks_for(int64_t total) {
  int64_t b = (total + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return int(b < kMaxBlocks ? b : kMaxBlocks);
}

dim3 tiles(int64_t nt, int64_t ny, int64_t nx) {
  return dim3(unsigned((nx + kTile - 1) / kTile),
              unsigned((ny + kTile - 1) / kTile), unsigned(nt));
}

// Dynamic shared memory of a tiled kernel with halo H; raises the kernel's
// limit above the 48 KB default where needed.
template <typename T, typename K>
int window_bytes(K kernel, int H, size_t* bytes) {
  const size_t pitch = size_t(kTile + 2 * H);
  *bytes = 3 * pitch * pitch * sizeof(T);
  if (*bytes > size_t(kDefaultSmem)) {
    return int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*bytes)));
  }
  return 0;
}

template <typename T>
int launch_smooth(const T* x, const T* b, const T* omega, const T* invD,
                  const T* invT, const T* invDel, T* out, int64_t nt,
                  int64_t ny, int64_t nx, const PairGroups* pg, int nu,
                  int zero_init, void* stream) {
  size_t bytes = 0;
  const int err = window_bytes<T>(mg_smooth_kernel<T>,
                                  zero_init ? nu - 1 : nu, &bytes);
  if (err != 0) return err;
  mg_smooth_kernel<T><<<tiles(nt, ny, nx), kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, b, omega, invD, invT, invDel, out, ny, nx, *pg, nu, zero_init);
  return int(cudaGetLastError());
}

template <typename T>
int launch_fused_pre(const T* b, const T* omega, const T* invD,
                     const T* invT, const T* invDel, T* xo, T* rco,
                     int64_t nt, int64_t ny, int64_t nx,
                     const PairGroups* pg, int nu, void* stream) {
  size_t bytes = 0;
  const int err = window_bytes<T>(mg_fused_pre_kernel<T>, nu + 1, &bytes);
  if (err != 0) return err;
  mg_fused_pre_kernel<T><<<tiles(nt, ny, nx), kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      b, omega, invD, invT, invDel, xo, rco, ny, nx, *pg, nu);
  return int(cudaGetLastError());
}

template <typename T>
int launch_fused_post(const T* x, const T* b, const T* ec, const T* omega,
                      const T* invD, const T* invT, const T* invDel, T* out,
                      int64_t nt, int64_t ny, int64_t nx,
                      const PairGroups* pg, int nu, void* stream) {
  size_t bytes = 0;
  const int err = window_bytes<T>(mg_fused_post_kernel<T>, nu, &bytes);
  if (err != 0) return err;
  mg_fused_post_kernel<T><<<tiles(nt, ny, nx), kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      x, b, ec, omega, invD, invT, invDel, out, ny, nx, *pg, nu);
  return int(cudaGetLastError());
}

template <typename T>
int launch_residual(const T* x, const T* b, const T* omega, T* out,
                    int64_t nt, int64_t ny, int64_t nx, const PairGroups* pg,
                    void* stream) {
  mg_residual_kernel<T><<<blocks_for(nt * ny * nx), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, b, omega, out, nt, ny, nx, *pg);
  return int(cudaGetLastError());
}

template <typename T>
int launch_apply(const T* x, T* out, int64_t nt, int64_t ny, int64_t nx,
                 const PairGroups* pg, void* stream) {
  mg_apply_kernel<T><<<blocks_for(nt * ny * nx), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, nt, ny,
                                                            nx, *pg);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// the launch. The shift and Chebyshev columns are (T,) vectors; nt ≤ 65535
// (the row is blockIdx.z of the tiled kernels).
extern "C" {

int mg_pairs_size() { return int(sizeof(PairGroups)); }

#define MG_ENTRY_POINTS(T, SFX)                                               \
  int mg_smooth_##SFX(const T* x, const T* b, const T* omega, const T* invD,  \
                      const T* invT, const T* invDel, T* out, int64_t nt,     \
                      int64_t ny, int64_t nx, const PairGroups* pg, int nu,   \
                      int zero_init, void* stream) {                          \
    return launch_smooth<T>(x, b, omega, invD, invT, invDel, out, nt, ny, nx, \
                            pg, nu, zero_init, stream);                       \
  }                                                                           \
  int mg_residual_##SFX(const T* x, const T* b, const T* omega, T* out,       \
                        int64_t nt, int64_t ny, int64_t nx,                   \
                        const PairGroups* pg, void* stream) {                 \
    return launch_residual<T>(x, b, omega, out, nt, ny, nx, pg, stream);      \
  }                                                                           \
  int mg_apply_##SFX(const T* x, T* out, int64_t nt, int64_t ny, int64_t nx,  \
                     const PairGroups* pg, void* stream) {                    \
    return launch_apply<T>(x, out, nt, ny, nx, pg, stream);                   \
  }                                                                           \
  int mg_fused_pre_##SFX(const T* b, const T* omega, const T* invD,           \
                         const T* invT, const T* invDel, T* xo, T* rco,       \
                         int64_t nt, int64_t ny, int64_t nx,                  \
                         const PairGroups* pg, int nu, void* stream) {        \
    return launch_fused_pre<T>(b, omega, invD, invT, invDel, xo, rco, nt, ny, \
                               nx, pg, nu, stream);                           \
  }                                                                           \
  int mg_fused_post_##SFX(const T* x, const T* b, const T* ec,                \
                          const T* omega, const T* invD, const T* invT,       \
                          const T* invDel, T* out, int64_t nt, int64_t ny,    \
                          int64_t nx, const PairGroups* pg, int nu,           \
                          void* stream) {                                     \
    return launch_fused_post<T>(x, b, ec, omega, invD, invT, invDel, out, nt, \
                                ny, nx, pg, nu, stream);                      \
  }

MG_ENTRY_POINTS(float, f32)
MG_ENTRY_POINTS(double, f64)

#undef MG_ENTRY_POINTS

}  // extern "C"
