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
// What bounds it: memory. B reads (T+1)·m values and writes T·m (2·T·m with
// W), Bᵀ the other way round: at the 2-D flagship's 128×511² in f32 the
// stab-fused B moves 402 MB, 0.120 ms at the H100's 3.35 TB/s. The first
// kernels (one thread per output point, each tap read from device memory
// and tested against the grid's bounds in a runtime loop over the table)
// took 1.40 ms there for B and 1.71 for Bᵀ on an H100 80GB HBM3 at 700 W,
// whatever the dtype: they were bound by instruction issue, not bytes.
//
// The design: a block owns a spatial tile and marches in time through a
// chunk of consecutive time rows (`kron_B_kernel`, `kron_BT_kernel`).
//   - The tile. In 2-D a band of P rows of y by a segment of x: the whole
//     row up to kMaxSeg columns (every grid the solves run), wider rows in
//     balanced segments. In 3-D a brick of P planes of z by 8 × 32 (y, x).
//     P is 4 or 8, the wrapper's (`ops/kron.py` `PENCIL`, by timing). The
//     window grows the tile by 1 on every side: the pencil axis (y in
//     2-D, z in 3-D) by one point each end, the plane by a frame (x only
//     in 2-D). Each thread loads one window column along the pencil, each
//     time row once, a row ahead (in registers), into shared memory, with
//     0 (the Dirichlet ghost) outside the grid, so no tap is tested against
//     a bound; the tile's columns are computed by the first threads, a
//     3-D warp on one row of x. The window's stride along the pencil is a
//     constant (`kron_stride`), so a column's P points lie at immediate
//     offsets from each tap's address.
//   - B keeps the previous row's column in registers and stores D = U[j+1]
//     − U[j] and S = U[j+1] + U[j] once a row; M·D, A·S and the stab A·D
//     read their taps from them (the first kernel loaded U[j+1] and U[j]
//     from device memory at every tap of each of its three stencils).
//   - Bᵀ stores the row of V and computes M·V[i] and A·V[i] once a row,
//     for output i's term −M V[i] + h_i/2 A V[i] and output i + 1's M V[i]
//     + h_i/2 A V[i] (each multiply-add as the first kernel wrote it); a
//     thread carries the latter and W[i] to output i + 1 in registers. The
//     first kernel applied M and A to both V[i] and V[i−1] at every output.
//   - The taps: the table's tap offsets in the window and, at each tap
//     where a group ends, the group's weight, are resolved once a block in
//     shared memory; the tap loop is unrolled to the most taps of the
//     dimension (9, 27) and reads the groups' ends from a mask, so there
//     is no loop over the groups and no indexed constant load.
//   - Two shared buffers alternate between rows: one barrier a row.
//   - The chunk of time rows is the wrapper's (`ops/kron.py` `kron_plan`):
//     the fewest waves of the blocks an SM holds, as the 2-D V-cycle
//     marches cut theirs.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6, `tools/fused_ab.py
// --kron`), stab-fused, f32: B 0.206 ms and Bᵀ 0.197 at 128×511², 1.71
// and 1.28 at 64×127³ (the first kernels 1.40, 1.71, 8.35 and 10.71).
// They are no longer issue-bound on the per-tap loop but not yet at the
// bytes' bound either (1.7× and 3.6× it in 2-D and 3-D for B).
//
// Arithmetic follows the JAX package's order and the first kernels' exactly:
// taps summed within a weight group, one multiply per group, groups in
// order, each output's multiply-adds written as the first kernels wrote
// them or, where Bᵀ computes a term apart from its sum, contracted as nvcc
// contracted them (`KRON_MADD`): the outputs equal the first kernels' bit
// for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

constexpr int kMaxGroups = 16;
constexpr int kMaxTaps = 32;

// c + a·b as nvcc contracts the first Bᵀ kernel's multiply-adds: one
// rounding on the card. Written out where a term is computed apart from
// the sum it enters; in the CPU emulation, which contracts nothing, it
// rounds twice, as the first kernel does there.
#ifdef __CUDA_ARCH__
#define KRON_MADD(a, b, c) fma((a), (b), (c))
#else
#define KRON_MADD(a, b, c) ((c) + (a) * (b))
#endif

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

constexpr int kMaxSeg = 574;  // the widest 2-D segment: 576 window columns
constexpr int kTileY = 8, kTileX = 32;  // the 3-D brick's plane
constexpr int kDefaultSmem = 48 * 1024;

// The threads a block takes at most: one per window column.
template <int DIM>
__host__ __device__ constexpr int kron_max_threads() {
  return DIM == 2 ? (kMaxSeg + 2 + 31) / 32 * 32
                  : ((kTileY + 2) * (kTileX + 2) + 31) / 32 * 32;
}
// The blocks an SM must hold (the register cap of __launch_bounds__).
template <int DIM, typename T>
__host__ __device__ constexpr int kron_min_blocks() {
  return sizeof(T) == 4 || DIM == 3 ? 2 : 1;
}
// The shared window's stride along the pencil, a constant, so that a
// thread's P points lie at immediate offsets: the widest 2-D window row,
// the 3-D window plane.
template <int DIM>
__host__ __device__ constexpr int kron_stride() {
  return DIM == 2 ? kMaxSeg + 2 : (kTileY + 2) * (kTileX + 2);
}
// The most taps of a stencil of the dimension (its ±1 neighbourhood).
template <int DIM>
__host__ __device__ constexpr int kron_taps() {
  return DIM == 2 ? 9 : 27;
}

struct Grid {
  int nz, ny, nx;
};

// A launch's tiles: the owned plane tile ix × iy (2-D: a segment, iy = 1)
// and its window's row stride wx and plane points wyx; xt × yt plane tiles
// (2-D: the segments), the pencil axis (y in 2-D, z in 3-D) of np points
// at stride pstride cut into pt pencils of P; threads a block.
struct Plan {
  int ix, iy, wx, wyx, xt, yt, np, pstride, pt, threads;
};

template <int DIM>
__host__ __device__ Plan kron_plan(const Grid& g, int P) {
  Plan p{};
  if (DIM == 2) {
    p.xt = (g.nx + kMaxSeg - 1) / kMaxSeg;
    p.ix = (g.nx + p.xt - 1) / p.xt;  // balanced; the last takes the rest
    p.iy = 1;
    p.wx = p.ix + 2;
    p.wyx = p.wx;
    p.yt = 1;
    p.np = g.ny;
    p.pstride = g.nx;
  } else {
    p.ix = kTileX;
    p.iy = kTileY;
    p.wx = kTileX + 2;
    p.wyx = (kTileY + 2) * p.wx;
    p.xt = (g.nx + kTileX - 1) / kTileX;
    p.yt = (g.ny + kTileY - 1) / kTileY;
    p.np = g.nz;
    p.pstride = g.ny * g.nx;
  }
  p.pt = (p.np + P - 1) / P;
  p.threads = (p.wyx + 31) / 32 * 32;
  return p;
}

// A thread's two roles. As a loader, its window column: t its index in
// the window plane (the thread's index), `load` whether it lies in the
// grid, gbase its spatial offset at pencil point 0, [klo, khi) the
// window's pencil points in the grid (window point k is pencil point p0 −
// 1 + k, p0 the block's first owned pencil point). As a computer (threads
// t < iy·ix, whole warps a row of x in 3-D), the tile's column t: `own`
// whether it lies in the grid, oc its window plane position, obase its
// spatial offset at pencil point 0, and kown its owned points in the grid
// (window points 1 … kown).
struct Col {
  int t, gbase, p0, klo, khi, kown, oc, obase;
  bool load, own;
};

template <int DIM>
__device__ __forceinline__ Col column(const Grid& g, const Plan& pl, int P) {
  Col c{};
  c.t = int(threadIdx.x);
  int py = 0, px = c.t, gy = 0, x0 = 0, y0 = 0, ylim = 1;
  if (DIM == 3) {
    const int bx = int(blockIdx.x) % pl.xt, by = int(blockIdx.x) / pl.xt;
    py = c.t / pl.wx;
    px = c.t - py * pl.wx;
    x0 = bx * kTileX;
    y0 = by * kTileY;
    gy = y0 - 1 + py;
    ylim = g.ny;
  } else {
    x0 = int(blockIdx.x) * pl.ix;
  }
  const int gx = x0 - 1 + px;
  c.load = c.t < pl.wyx && gy >= 0 && gy < ylim && gx >= 0 && gx < g.nx;
  c.gbase = (DIM == 3 ? gy * g.nx : 0) + gx;
  // the computed column: 2-D the segment's column t, 3-D (t / 32, t % 32)
  const int qy = DIM == 3 ? c.t / kTileX : 0;
  const int qx = DIM == 3 ? c.t % kTileX : c.t;
  c.own = c.t < pl.iy * pl.ix && y0 + qy < ylim && x0 + qx < g.nx;
  c.oc = (DIM == 3 ? (qy + 1) * pl.wx : 0) + qx + 1;
  c.obase = (DIM == 3 ? (y0 + qy) * g.nx : 0) + x0 + qx;
  c.p0 = int(blockIdx.y) * P;
  c.klo = c.p0 == 0 ? 1 : 0;
  c.khi = min(P + 2, pl.np - c.p0 + 1);
  c.kown = min(P, pl.np - c.p0);
  return c;
}

// The column of one time row (`row`: its first value) into v, 0 outside
// the grid.
template <int WP, typename T>
__device__ __forceinline__ void load_col(const T* __restrict__ row,
                                         const Col& c, const Plan& pl,
                                         T (&v)[WP]) {
  const T* base = row + c.gbase + (c.p0 - 1) * pl.pstride;
#pragma unroll
  for (int k = 0; k < WP; ++k) {
    v[k] = c.load && k >= c.klo && k < c.khi ? __ldg(base + k * pl.pstride)
                                             : T(0);
  }
}

// A stencil resolved for a block's window: toff[k] the window offset of
// tap k, wend[k] the weight of the group that ends at tap k (shared
// memory) and `ends` the mask of those taps.
template <typename T>
struct Stencil {
  const int* toff;
  const T* wend;
  unsigned ends;
};

// Writes tp's offsets and end weights for the window plan pl to toff and
// wend (shared memory; needs a __syncthreads() before they are read) and
// returns the stencil.
template <int DIM, typename T>
__device__ __forceinline__ Stencil<T> resolve(const Taps& tp, const Plan& pl,
                                              int* toff, T* wend) {
  const int n = tp.start[tp.n_groups];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    toff[k] = DIM == 2 ? tp.dy[k] * kron_stride<2>() + tp.dx[k]
                       : tp.dz[k] * kron_stride<3>() + tp.dy[k] * pl.wx +
                             tp.dx[k];
  }
  if (int(threadIdx.x) < tp.n_groups) {
    wend[tp.start[threadIdx.x + 1] - 1] = static_cast<T>(tp.weight[threadIdx.x]);
  }
  unsigned ends = 0;
  for (int g = 0; g < tp.n_groups; ++g) ends |= 1u << (tp.start[g + 1] - 1);
  return Stencil<T>{toff, wend, ends};
}

// The stencil at a column's P owned points of buf (window points 1 … P,
// offsets o): taps in table order within a group, one multiply per group,
// groups in order, as the first kernels summed them. The tap loop is
// unrolled to NT taps, each tap's P values are independent loads, and a
// group ends where its bit of the mask is set.
template <int NT, int P, typename T>
__device__ __forceinline__ void apply(const Stencil<T>& st,
                                      const T* __restrict__ buf,
                                      const int (&o)[P], T (&out)[P]) {
  T acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) out[j] = acc[j] = T(0);
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (st.ends >> k) {  // tap k exists: a group ends at it or after it
      const T* const bk = buf + st.toff[k];
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j] += bk[o[j]];
      if ((st.ends >> k) & 1u) {
        const T w = st.wend[k];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          out[j] += w * acc[j];
          acc[j] = T(0);
        }
      }
    }
  }
}

// The shared memory of a kernel's taps (offsets and end weights, M then A).
template <typename T>
struct TapSmem {
  int toff[2][kMaxTaps];
  T wend[2][kMaxTaps];
};

// B, and with STAB its stab term W, on a march of one block: the tile of
// blockIdx (x: plane tile, y: pencil) and the output rows [j0, j1) of
// chunk blockIdx.z.
template <int DIM, int P, bool STAB, typename T>
__global__ void __launch_bounds__(kron_max_threads<DIM>(),
                                  kron_min_blocks<DIM, T>())
    kron_B_kernel(const T* __restrict__ U, const T* __restrict__ h_half,
                  const T* __restrict__ h_stab, T* __restrict__ out,
                  T* __restrict__ W, int nt, Grid g, Plan pl, int chunk,
                  const __grid_constant__ Taps tM,
                  const __grid_constant__ Taps tA) {
  constexpr int WP = P + 2, NT = kron_taps<DIM>(), ST = kron_stride<DIM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);  // 2 × (D, S) × WP × ST
  __shared__ TapSmem<T> ts;
  const Stencil<T> sM = resolve<DIM, T>(tM, pl, ts.toff[0], ts.wend[0]);
  const Stencil<T> sA = resolve<DIM, T>(tA, pl, ts.toff[1], ts.wend[1]);
  const Col c = column<DIM>(g, pl, P);
  const int64_t S = int64_t(g.nz) * g.ny * g.nx;
  const int j0 = int(blockIdx.z) * chunk, j1 = min(j0 + chunk, nt);
  constexpr int plane = WP * ST;
  int o[P];
#pragma unroll
  for (int j = 0; j < P; ++j) o[j] = (1 + j) * ST + c.oc;
  const int64_t obase = int64_t(c.obase) + int64_t(c.p0) * pl.pstride;
  T u0[WP], u1[WP];  // the column of U[j] and U[j+1]
  load_col<WP>(U + j0 * S, c, pl, u0);
  load_col<WP>(U + (j0 + 1) * S, c, pl, u1);
  for (int j = j0; j < j1; ++j) {
    T* const D = sm + ((j - j0) & 1) * 2 * plane;
    T* const Sm = D + plane;
    if (c.t < pl.wyx) {
#pragma unroll
      for (int k = 0; k < WP; ++k) {
        D[k * ST + c.t] = u1[k] - u0[k];
        Sm[k * ST + c.t] = u1[k] + u0[k];
        u0[k] = u1[k];
      }
    }
    if (j + 1 < j1) load_col<WP>(U + (j + 2) * S, c, pl, u1);
    __syncthreads();
    if (c.own) {
      T vm[P], va[P];
      apply<NT>(sM, D, o, vm);
      apply<NT>(sA, Sm, o, va);
      const T hh = h_half[j];
      T* const orow = out + j * S + obase;
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        if (jj < c.kown) orow[int64_t(jj) * pl.pstride] = vm[jj] + hh * va[jj];
      }
      if (STAB) {
        T vd[P];
        apply<NT>(sA, D, o, vd);
        const T hs = h_stab[j];
        T* const wrow = W + j * S + obase;
#pragma unroll
        for (int jj = 0; jj < P; ++jj) {
          if (jj < c.kown) wrow[int64_t(jj) * pl.pstride] = hs * vd[jj];
        }
      }
    }
  }
}

// Bᵀ, and with STAB its stab jump, on a march of one block: the tile of
// blockIdx and the output rows [i0, i1) of chunk blockIdx.z, from the rows
// [max(i0 − 1, 0), min(i1, T)) of V.
template <int DIM, int P, bool STAB, typename T>
__global__ void __launch_bounds__(kron_max_threads<DIM>(),
                                  kron_min_blocks<DIM, T>())
    kron_BT_kernel(const T* __restrict__ V, const T* __restrict__ h_half,
                   const T* __restrict__ W, T* __restrict__ out, int nt,
                   Grid g, Plan pl, int chunk,
                   const __grid_constant__ Taps tM,
                   const __grid_constant__ Taps tA) {
  constexpr int WP = P + 2, NT = kron_taps<DIM>(), ST = kron_stride<DIM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);  // 2 × WP × ST
  __shared__ TapSmem<T> ts;
  const Stencil<T> sM = resolve<DIM, T>(tM, pl, ts.toff[0], ts.wend[0]);
  const Stencil<T> sA = resolve<DIM, T>(tA, pl, ts.toff[1], ts.wend[1]);
  const Col c = column<DIM>(g, pl, P);
  const int64_t S = int64_t(g.nz) * g.ny * g.nx;
  const int i0 = int(blockIdx.z) * chunk, i1 = min(i0 + chunk, nt + 1);
  const int r0 = max(i0 - 1, 0), r1 = min(i1, nt);
  constexpr int plane = WP * ST;
  int o[P];
#pragma unroll
  for (int j = 0; j < P; ++j) o[j] = (1 + j) * ST + c.oc;
  const int64_t obase = int64_t(c.obase) + int64_t(c.p0) * pl.pstride;
  T v[WP];  // the column of the next row of V
  if (r0 < r1) load_col<WP>(V + r0 * S, c, pl, v);
  // at the owned points, the previous row's term M·V[r−1] + h_{r−1}/2 ·
  // A·V[r−1] of the next output, and W[r−1]
  T pb[P], pw[P];
#pragma unroll
  for (int jj = 0; jj < P; ++jj) pb[jj] = pw[jj] = T(0);
  for (int r = r0; r < r1; ++r) {
    T* const buf = sm + ((r - r0) & 1) * plane;
    if (c.t < pl.wyx) {
#pragma unroll
      for (int k = 0; k < WP; ++k) buf[k * ST + c.t] = v[k];
    }
    if (r + 1 < r1) load_col<WP>(V + (r + 1) * S, c, pl, v);
    T wc[P];
    if (STAB && c.own) {
      const T* const wrow = W + r * S + obase;
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        wc[jj] = jj < c.kown ? __ldg(wrow + int64_t(jj) * pl.pstride) : T(0);
      }
    }
    __syncthreads();
    if (c.own) {
      T m[P], a[P];
      apply<NT>(sM, buf, o, m);
      apply<NT>(sA, buf, o, a);
      const T hc = h_half[r];
      if (r >= i0) {
        T* const orow = out + r * S + obase;
#pragma unroll
        for (int jj = 0; jj < P; ++jj) {
          T oo = KRON_MADD(hc, a[jj], -m[jj]);
          if (r >= 1) oo = oo + pb[jj];
          if (STAB) oo = oo + ((r >= 1 ? pw[jj] : T(0)) - wc[jj]);
          if (jj < c.kown) orow[int64_t(jj) * pl.pstride] = oo;
        }
      }
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        pb[jj] = KRON_MADD(hc, a[jj], m[jj]);
        if (STAB) pw[jj] = wc[jj];
      }
    }
  }
  if (i1 == nt + 1 && c.own) {  // output T: the term of V[T−1] alone
    T* const orow = out + nt * S + obase;
#pragma unroll
    for (int jj = 0; jj < P; ++jj) {
      T oo = pb[jj];
      if (STAB) oo = oo + (pw[jj] - T(0));
      if (jj < c.kown) orow[int64_t(jj) * pl.pstride] = oo;
    }
  }
}

// Whether a table fits the kernels of dimension dim: at most the
// dimension's taps, no empty group (the groups' ends are a mask), every
// displacement in the ±1 neighbourhood (dz = 0 in 2-D).
bool taps_ok(const Taps& tp, int dim) {
  if (tp.n_groups < 0 || tp.n_groups > kMaxGroups || tp.start[0] != 0) {
    return false;
  }
  for (int g = 0; g < tp.n_groups; ++g) {
    if (tp.start[g + 1] <= tp.start[g]) return false;
  }
  const int n = tp.start[tp.n_groups];
  if (n > (dim == 2 ? kron_taps<2>() : kron_taps<3>())) return false;
  for (int k = 0; k < n; ++k) {
    if (tp.dz[k] < -1 || tp.dz[k] > 1 || tp.dy[k] < -1 || tp.dy[k] > 1 ||
        tp.dx[k] < -1 || tp.dx[k] > 1 || (dim == 2 && tp.dz[k] != 0)) {
      return false;
    }
  }
  return true;
}

// Dynamic shared memory of a march: two alternating buffers of `arrays`
// windows (B: D and S; Bᵀ: V) of WP = P + 2 points along the pencil at
// the constant stride.
template <int DIM, typename T>
size_t march_bytes(int P, int arrays) {
  return size_t(2 * arrays) * size_t(P + 2) * size_t(kron_stride<DIM>()) *
         sizeof(T);
}

// Raises a kernel's dynamic shared memory limit to `bytes` where that is
// above the 48 KB default; returns the cudaError_t of that.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > size_t(kDefaultSmem)) {
    return int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
  }
  return 0;
}

// The pencil instantiations: P ∈ {4, 8} (a runtime choice of the
// wrapper), as a call of f with the kernel for that P.
template <typename F>
int by_pencil(int P, F f) {
  switch (P) {
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <int DIM, typename T, int P>
auto B_kernel(bool stab) {
  return stab ? kron_B_kernel<DIM, P, true, T> : kron_B_kernel<DIM, P, false, T>;
}

template <int DIM, typename T, int P>
auto BT_kernel(bool stab) {
  return stab ? kron_BT_kernel<DIM, P, true, T>
              : kron_BT_kernel<DIM, P, false, T>;
}

// The checks shared by the launchers: a grid whose points an int indexes,
// a chunk of at least one row, tables that fit the kernels.
bool launch_ok(int64_t nt, int64_t nz, int64_t ny, int64_t nx, int dim,
               int chunk, const Taps* tM, const Taps* tA) {
  return nt >= 1 && nz >= 1 && ny >= 1 && nx >= 1 && (dim == 3 || nz == 1) &&
         (dim == 2 || dim == 3) && nz * ny * nx <= INT_MAX && nt <= INT_MAX &&
         chunk >= 1 && taps_ok(*tM, dim) && taps_ok(*tA, dim);
}

template <int DIM, typename T>
int launch_B(const T* U, const T* h_half, const T* h_stab, T* out, T* W,
             int nt, const Grid& g, const Taps* tM, const Taps* tA, int stab,
             int P, int chunk, cudaStream_t stream) {
  return by_pencil(P, [&](auto pc) {
    constexpr int PP = decltype(pc)::value;
    const Plan pl = kron_plan<DIM>(g, PP);
    const auto kernel = B_kernel<DIM, T, PP>(stab != 0);
    const size_t bytes = march_bytes<DIM, T>(PP, 2);
    const int err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    const dim3 blocks(unsigned(pl.xt * pl.yt), unsigned(pl.pt),
                      unsigned((nt + chunk - 1) / chunk));
    kernel<<<blocks, pl.threads, bytes, stream>>>(U, h_half, h_stab, out, W,
                                                  nt, g, pl, chunk, *tM, *tA);
    return int(cudaGetLastError());
  });
}

template <int DIM, typename T>
int launch_BT(const T* V, const T* h_half, const T* W, T* out, int nt,
              const Grid& g, const Taps* tM, const Taps* tA, int stab, int P,
              int chunk, cudaStream_t stream) {
  return by_pencil(P, [&](auto pc) {
    constexpr int PP = decltype(pc)::value;
    const Plan pl = kron_plan<DIM>(g, PP);
    const auto kernel = BT_kernel<DIM, T, PP>(stab != 0);
    const size_t bytes = march_bytes<DIM, T>(PP, 1);
    const int err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    const dim3 blocks(unsigned(pl.xt * pl.yt), unsigned(pl.pt),
                      unsigned((nt + 1 + chunk - 1) / chunk));
    kernel<<<blocks, pl.threads, bytes, stream>>>(V, h_half, W, out, nt, g,
                                                  pl, chunk, *tM, *tA);
    return int(cudaGetLastError());
  });
}

// The blocks an SM holds of a march's kernel, its shared bytes, threads a
// block and blocks a chunk of time rows (plane tiles × pencils).
template <int DIM, typename T>
int occupancy(int bt, int stab, int P, const Grid& g, int* blocks, int* bytes,
              int* threads, int* tiles) {
  return by_pencil(P, [&](auto pc) {
    constexpr int PP = decltype(pc)::value;
    const Plan pl = kron_plan<DIM>(g, PP);
    auto of = [&](auto kernel, int arrays) {
      const size_t b = march_bytes<DIM, T>(PP, arrays);
      const int err = allow_smem(kernel, b);
      if (err != 0) return err;
      *bytes = int(b);
      *threads = pl.threads;
      *tiles = pl.xt * pl.yt * pl.pt;
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, kernel, pl.threads, b));
    };
    return bt ? of(BT_kernel<DIM, T, PP>(stab != 0), 1)
              : of(B_kernel<DIM, T, PP>(stab != 0), 2);
  });
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// the launch; `W` and `h_stab` are ignored unless `stab` is non-zero.
// `dim` is the grid's (nz = 1 in 2-D), `pencil` the points a block owns
// along y (2-D) or z (3-D), 4 or 8, and `chunk` the time rows
// of output a block marches through (`ops/kron.py` `kron_plan`).
extern "C" {

int kron_taps_size() { return int(sizeof(Taps)); }

int kron_occupancy(int bt, int stab, int f64, int dim, int pencil,
                   int64_t nz, int64_t ny, int64_t nx, int* blocks,
                   int* bytes, int* threads, int* tiles) {
  if (!(dim == 2 || dim == 3) || nz < 1 || ny < 1 || nx < 1 ||
      nz * ny * nx > INT_MAX || (dim == 2 && nz != 1)) {
    return int(cudaErrorInvalidValue);
  }
  const Grid g{int(nz), int(ny), int(nx)};
  if (f64) {
    return dim == 3 ? occupancy<3, double>(bt, stab, pencil, g, blocks, bytes,
                                           threads, tiles)
                    : occupancy<2, double>(bt, stab, pencil, g, blocks, bytes,
                                           threads, tiles);
  }
  return dim == 3 ? occupancy<3, float>(bt, stab, pencil, g, blocks, bytes,
                                        threads, tiles)
                  : occupancy<2, float>(bt, stab, pencil, g, blocks, bytes,
                                        threads, tiles);
}

#define KRON_ENTRY_POINTS(T, SFX)                                             \
  int kron_B_##SFX(const T* U, const T* h_half, const T* h_stab, T* out,      \
                   T* W, int64_t nt, int64_t nz, int64_t ny, int64_t nx,      \
                   int dim, const Taps* tM, const Taps* tA, int stab,         \
                   int pencil, int chunk, void* stream) {                     \
    if (!launch_ok(nt, nz, ny, nx, dim, chunk, tM, tA)) {                     \
      return int(cudaErrorInvalidValue);                                      \
    }                                                                         \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    const auto s = static_cast<cudaStream_t>(stream);                         \
    return dim == 3 ? launch_B<3, T>(U, h_half, h_stab, out, W, int(nt), g,   \
                                     tM, tA, stab, pencil, chunk, s)          \
                    : launch_B<2, T>(U, h_half, h_stab, out, W, int(nt), g,   \
                                     tM, tA, stab, pencil, chunk, s);         \
  }                                                                           \
  int kron_BT_##SFX(const T* V, const T* h_half, const T* W, T* out,          \
                    int64_t nt, int64_t nz, int64_t ny, int64_t nx, int dim,  \
                    const Taps* tM, const Taps* tA, int stab, int pencil,     \
                    int chunk, void* stream) {                                \
    if (!launch_ok(nt, nz, ny, nx, dim, chunk, tM, tA)) {                     \
      return int(cudaErrorInvalidValue);                                      \
    }                                                                         \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    const auto s = static_cast<cudaStream_t>(stream);                         \
    return dim == 3 ? launch_BT<3, T>(V, h_half, W, out, int(nt), g, tM, tA,  \
                                      stab, pencil, chunk, s)                 \
                    : launch_BT<2, T>(V, h_half, W, out, int(nt), g, tM, tA,  \
                                      stab, pencil, chunk, s);                \
  }

KRON_ENTRY_POINTS(float, f32)
KRON_ENTRY_POINTS(double, f64)

#undef KRON_ENTRY_POINTS

}  // extern "C"
