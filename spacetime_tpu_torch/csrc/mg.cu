// The multi-shift multigrid V-cycle kernels on 2-D and 3-D structured
// grids, for sm_90a, in float and double.
//
// Op = A + ω⊙M on a (T, nz, ny, nx) field (nz = 1 in 2-D), one shift ω_t
// per time row. A and M are constant P1 stencils given as one table of
// (wA, wM) pair groups: the taps of a group are summed once and multiplied
// by the row's weight wA + ω_t·wM (wA alone when wM = 0, ω_t·wM alone when
// wA = 0), and the groups are added in order. This is `_op_rows` of
// spacetime_tpu/ops/mg_pallas.py:156. Values outside the grid are the zero
// Dirichlet ghost. The Chebyshev–Jacobi sweep of degree ν is
//
//   r = D⁻¹(b − Op x),  d = r/θ,  x += d,
//   ν−1 times:  r −= D⁻¹ Op d,  d = ρ'ρ d + 2ρ' r/δ,  x += d
//
// with σ = 5/3, ρ = 1/σ, ρ' = 1/(2σ − ρ) and 1/D, 1/θ, 1/δ per time row.
// R and P are the P1 restriction and prolongation between a fine grid of
// extents 2n+1 and its coarse grid of extents n, per axis:
//
//   R r[c] = ½ Σ_{f ∈ {2c, 2c+1}^d} (r[f] + r[f + 1⃗]),
//   P e[f] = ½ (e[⌊f/2⌋] + e[⌊(f − 1⃗)/2⌋])   (zero beyond the coarse grid).
//
//   mg_smooth    (K3, replaces _smooth_call, mg_pallas.py:190): the sweep,
//                from x or from x = 0 (zero_init). 2-D and 3-D.
//   mg_residual  (K4, replaces _residual_call, :316): b − Op x. 2-D, 3-D.
//   mg_apply     (K5, replaces _apply_stencil_call, :375): A x, one stencil
//                (the pair table with every wM = 0). 2-D and 3-D.
//   mg_fused_pre (K6, replaces _fused_pre_call, :1318): x = the zero-init
//                sweep on b, then r_c = R(b − Op x). 2-D and 3-D.
//   mg_fused_post (K7, replaces _fused_post_call, :1475): the sweep from
//                x + P e_c. 2-D and 3-D.
//   mg_residual_restrict (K8, replaces _residual_restrict_call, :1683):
//                r_c = R(b − Op x); the fine residual is never stored.
//                2-D and 3-D.
//   mg_prolong_correct (K9, replaces _prolong_correct_call, :1913):
//                x + P e_c; the prolonged field is never stored. 2-D, 3-D.
//
// The weighted forms, for the Galerkin hierarchy of a coefficient-weighted
// A (varcoef2d, varcoef3d): Op_w = A_w + ω⊙M, where A_w has per-node
// weights W (ntaps, *grid), one array per tap (7 in 2-D, 15 in 3-D),
// out[p] = Σ_k W[k][p]·x[p + d_k] summed in tap order, M is the constant
// mass stencil (its weight groups, times ω after their sum) and the Jacobi
// diagonal is per node, 1/D[p] = 1/(W[kc][p] + ω_t·c_M) (0 where the
// denominator is ≤ 0, `_inv_diag_var`, mg_pallas.py:842).
//
//   mg_smooth_var     (K10, replaces _smooth_var_call, :856): one step of
//                the sweep with Op_w and the per-node diagonal (the first
//                from x or from 0, or a later one), r and d in device
//                memory; the wrapper launches it ν times. 2-D and 3-D; it
//                marches in time as K11 does.
//   mg_residual_var   (K11, replaces _residual_var_call, :956):
//                b − Op_w x. 2-D and 3-D; it marches in time.
//   mg_apply_var      (K12, replaces _apply_var_call, :1020): A_w x. 2-D
//                and 3-D; K11's march without b and the mass.
//   mg_residual_restrict_var (K13, replaces _residual_restrict_var_call,
//                :1822): r_c = R(b − Op_w x). 2-D and 3-D.
//   mg_fused_pre_var  (K14, replaces _fused_pre_var_call, :2071): K6 with
//                Op_w and the per-node diagonal. 2-D and 3-D.
//   mg_fused_post_var (K15, replaces _fused_post_var_call, :2196): K7 with
//                Op_w and the per-node diagonal. 2-D and 3-D.
//
// The x + P e_c stage of the weighted V-cycle does not depend on the
// coefficients: it is K9.
//
// The sharded-slab forms, for the time×space mesh (spacetime_tpu_torch/
// parallel/explicit2d.py): the grid is a slab of the leading grid axis (y
// in 2-D, z in 3-D) of own + 2h planes, the even own planes a rank owns and
// h planes of halo on each side, received from its neighbours. Points
// outside the slab are the zero ghost, as outside a serial grid. A 0/1
// validity field vm (one row of the slab) zeroes every update of the
// sweep's residual on the planes of grid padding and on the halo planes
// beyond the global domain. On the lead axis the transfers are offset
// (`Lead`): the slab's coarse plane k sums the fine planes h + 2k, h + 2k
// + 1 (and + 2), and a fine plane l reads the coarse planes ⌊(l + s)/2⌋
// and ⌊(l + s − 1)/2⌋ of a coarse operand that carries hc halo planes,
// s = 2hc − h (zero beyond it).
//
//   mg_sh_smooth (K3 with `vmask`, replaces _smooth_call, :190): the sweep
//                with vm. Above the tiled ν, the chained steps
//                (mg_cheb_step) take vm too. 2-D and 3-D.
//   mg_sh_fused_pre (K6 with lead=(own, h), :1318): the zero-init sweep
//                with vm on the whole slab (x at its full extent; the
//                caller crops it), r_c on the own/2 owned coarse planes.
//                The march's chunks of coarse planes (rows in 2-D) start
//                at fine plane h.
//   mg_sh_fused_post (K7 with lead=(own, h, hc), :1475): x + P e_c with
//                the offset prolongation, then the sweep with vm; the
//                output at the slab's full extent. The march's chunks of
//                fine planes (rows) cover the slab from plane 0.
//   mg_sh_residual_restrict (K8 with lead=(own, h), :1683): the owned
//                coarse planes of R(b − Op x).
//   mg_sh_prolong_correct (K9 with lead=(own, hc), :1913): x + P e_c on
//                the own planes, e_c with hc halo planes.
//
// The chained sweep, for ν above what the tiled K3 holds (ν ≤ 8 in 2-D,
// ν ≤ 3 in 3-D; MAX_NU in ops/mg_kernels.py):
//
//   mg_cheb_step     (K3's chain): one step of the recurrence in device
//                memory, Op applied to d, r, d and x updated; the wrapper
//                launches it ν times (the first from b and x or 0). 2-D
//                and 3-D.
//
// One step per launch rather than sweeps of ≤ MAX_NU steps carrying (x, r,
// d, ρ) across launches: a tiled sweep that starts from a stored r and d
// needs two more window buffers, which the 3-D f64 brick has no room for
// (three buffers take 174.6 KB at ν = 3), and each chained launch would
// still recompute its halo. The step kernel is one thread per point like
// K8; a step reads d (its taps), r and x and writes r, d and x. K10 runs
// every sweep as such steps, each a launch of the weighted time march.
//
// What bounds them: memory traffic and instruction count, not arithmetic.
// A sweep applies Op ν times (7 taps in 2-D, 15 in 3-D) to data that is
// read once: the tiled kernels keep every intermediate (r, d, x) in shared
// memory, so K3 reads x and b and writes x, one pass over three fields
// where the plain PyTorch form moves ~15 fields per Op. K8 reads x and b
// and writes the coarse residual (1/8 of a field in 3-D), K9 reads x and
// e_c and writes x: the fine residual and the prolonged correction never
// reach device memory.
//
// Design:
// - K8, K9: one thread per output point (K8: per coarse point), x fastest
//   so that a warp's loads coalesce, 32-bit indices within a time row
//   (64-bit only for the row's offset), the pair table passed by value as
//   a __grid_constant__ kernel parameter (as kron.cu). K8 recomputes the
//   residual at the 2^d · 2 fine points each coarse point sums (2× the
//   fine residuals, as each is shared by up to 2^d coarse points); K9
//   reads its two coarse values from global memory.
// - K4 and K5 are one kernel (`mg_stencil_kernel`; K5 the residual with
//   no b on the table of A alone) that marches along the leading axis: a
//   block owns a segment of one time row's columns (2-D: the whole row up
//   to 1,024 columns, `row_plan` with a halo of 1) or a 16 × 32 (y, x)
//   tile with a frame of one (3-D: 18 · 34 loads for 512 points, 1.20 a
//   point) and walks a chunk of the rows (planes), whose depth the wrapper
//   picks for whole waves of the blocks an SM holds (`stencil_chunk`).
//   x's window planes pass through a ring of four slots in shared memory:
//   a step stores the plane two ahead (from registers loaded D steps
//   before, D = 2 in 2-D but the f64 K4, else 1) while it reads the three
//   around its own, so one barrier a step; the ghost columns (rows, in
//   3-D) outside the grid hold 0 in every slot from the start, and planes
//   off the grid are loaded as 0, so no tap tests a bound. Each thread
//   keeps the same points of the plane for the whole march (no index is
//   divided per point), loads its b a step (D steps) ahead, and applies
//   the operator with the taps unrolled (9 in 2-D, 16 in 3-D) and the
//   groups' ends from a mask (`row_many`), the row's group weights computed
//   once a block: no runtime loop over groups or taps, no bounds test and
//   one load of x a point (1.2 in 3-D), where a thread a point issued
//   them at every tap and was bound by instructions (PERF.md).
// - K3 (2-D and 3-D): one block of 256 threads owns a brick of
//   one time row (blockIdx.z = row): 32 × 32 in 2-D, 8 × 8 × 32 (z, y, x)
//   in 3-D. It loads the brick and a halo into shared memory and runs the
//   recurrence there, each Op application shrinking the valid halo by one
//   cell, with __syncthreads() between the stages. Halo: ν−1 for the
//   zero-init sweep (G of the Pallas kernel, :214), ν for the sweep from
//   x; in 3-D the halo grows in z as well. Points of the window outside
//   the grid hold 0 in every buffer, which is the Dirichlet ghost
//   (`_domain_mask`, :122) for bricks on the boundary and for ragged
//   extents. A 3-D brick with three double buffers takes 174.6 KB of
//   shared memory at halo 3, so the tiled 3-D sweep takes ν ≤ 3 (above
//   it, the chained sweep). The fused stages (below) do in one launch
//   what K3 + K8 (pre) and K9 + K3 (post) do in two: x never makes the
//   round trip through device memory between the sweep and the transfer;
//   their halo is ν + 1 for K6 (G + E, E = 2 for the residual and the
//   restriction, :1342) and ν for K7's prolonged field (:1525).
// - The 3-D fused stages march in z (K6 and K14 `march_fused_pre`, K7 and
//   K15 `march_fused_post`): a block owns a 16 × 32 (y, x) tile of one row
//   and walks a chunk of its planes in order (the whole column where that
//   fills the card), its pipeline's stages a plane apart. Each stage keeps
//   the three planes the next one's Op reads (z − 1, z, z + 1) in a ring
//   in shared memory, three planes of the tile grown by H in y and x. The
//   pre-stage (stages: the sweep's ν steps, the residual, the
//   restriction) keeps ν + 1 rings at H = ν + 1: 30.1 KB in f32 and 60.2
//   KB in f64 at ν = 2, 46.1 and 92.2 KB at ν = 3. The post-stage
//   (stages: x + P e_c, then the sweep's ν steps; no residual, no
//   restriction) keeps ν rings (x + P e_c, then d of steps 1 … ν−1) at H
//   = ν: 17.3 and 34.6 KB at ν = 2, 30.1 and 60.2 KB at ν = 3. So an SM
//   holds several blocks even in f64. The xy halo shrinks by a cell a
//   stage as in the bricks; in z only a chunk's two ends are computed
//   twice, where a brick recomputed ν (+ 1) planes on each side of 8 (its
//   window held 2.5–3.6× the brick). Each thread keeps the same few points
//   of the window plane for the whole march, so no index is divided per
//   point, holds their r and x in registers from one stage to the next,
//   applies Op to all of them tap by tap (`many`: independent sums, each
//   tap's offset read once), and loads b and the diagonal (and in the
//   post-stage x and e_c) a plane ahead, so that no stage waits on device
//   memory between two barriers. The taps' offsets in the ring are
//   resolved once per block for each of its three rotations. The
//   pre-stage's points lie in the window's row order, four a thread; the
//   post-stage's lie deepest first (the tile, then the frames of depth H −
//   1 … 0, `march_post_point`), so that the points of stage k, those of
//   depth ≥ k, are a prefix of them and each stage applies Op to only as
//   many of a thread's points as its region fills (2 of 3 at ν = 2 for
//   the last stage), and a warp's tile points are one aligned row of 32.
//   The blocks an SM holds (`march_min_blocks`) were chosen by timing. The
//   Pallas kernel keeps z and x whole and blocks in y, so it never
//   recomputed a z halo either.
// - The 2-D K6, K7, K14 and K15 march in y (`march2_fused_pre`,
//   `march2_fused_post`): the 3-D stages with a row of x in place of a
//   plane. A block owns a
//   segment of one time row's columns and a chunk of its rows and keeps
//   rings of three window rows in shared memory. The segment is the whole
//   row wherever it fits a block's 1,024 points (every 2-D level the
//   solves run; 511 columns the widest), its two ghost columns zero from
//   the start, so no point is computed twice in x, and a chunk recomputes
//   only its two ends in y, where the 32 × 32 brick recomputed a halo of ν
//   + 1 on every side (38² points for 1,024 owned); a wider row is cut
//   into segments with an x halo that shrinks a cell a stage. K6 keeps ν +
//   1 rings at H = ν + 1 (18.5 KB in f32 at 511 columns and ν = 2, 49.2 KB
//   in f64 at ν = 3), K7 ν rings. A thread keeps 4 points of the row in
//   f32 (a block of 128 threads at 511 columns) and 2 in f64, their r and
//   x in registers, and loads b (and x, e_c) a row ahead. Op is applied
//   with the tap loop unrolled and every tap's values loaded before they
//   are summed, the groups' ends read from a mask (`row_many`): with the
//   runtime loop over the groups of `many`, each tap waited on an indexed
//   constant load and a branch, which took 0.62 ms of K6 at 129×511² f32
//   where the march now takes 0.48 (PERF.md). The bricks went through
//   shared memory for every term, with a runtime division and bounds test
//   per point and window pass. The Pallas kernel keeps x whole and blocks
//   in y. K14 and K15 march on the same plan and apply Op_w the same way
//   (`VarOp::row_many`: the 7 A taps unrolled, their weights at the point
//   read from the L2 through __ldg first, the ring's values as they are
//   summed, the mass's groups ended by a mask); a point's 1/D comes from
//   W[kc] loaded a row ahead with b, at the row's first stage, and rides
//   in registers through its later stages, so the bricks' fourth window
//   buffer (1/D) is gone. Staging each row's W in a shared-memory ring by
//   cp.async instead (a thread's values, ν + 2 rows) was about 2× slower
//   (PERF.md).
// - The restriction and the prolongation are exact pair sums, one device
//   function each (`restrict_at`, `prolong_at`) that K8, K9 and the fused
//   stages share; the Pallas kernels' banded 0/1 matrices on the MXU
//   (`_dot_last`, :1253) are a TPU device and are not ported.
// - K10, K11 and K12 march in time (`mg_var_stencil_kernel`, one
//   template, `VarMode` the kernel and the step; K12 without b and the
//   mass): W has no time axis, so a block owns a
//   spatial tile, loads its points' weights once and walks a chunk of
//   consecutive time rows with them on chip. The tile is K1's
//   (csrc/kron.cu): in 2-D a few rows of y by a segment of the row (K12
//   the whole row up to 574 columns, K11 and K10 segments of up to 254
//   at more blocks an SM; `var_seg`, `var_pencil`), in 3-D 2 planes of z by
//   8 × 32; each thread loads one window column
//   (the tile grown by one on every side) along the pencil a row ahead in
//   registers, 0 past the grid, into one of two alternating shared
//   buffers (one barrier a row), and computes the tile's column of the
//   same index. The weights sit in registers up to kVarRowTaps A taps (the
//   7 of the 2-D stencils), else in a shared tile [tap][point] that each
//   thread fills and reads in its own column (the 15 of 3-D): the choice
//   comes from the tap count alone (`var_form`). The taps' window offsets
//   and the mass's group weights are resolved once a block in shared
//   memory, the tap loops unrolled and the mass's groups ended by a mask
//   (`row_many`'s form); b is loaded a row ahead and ω once a row. The
//   chunk is the wrapper's (`ops/mg_kernels.py` `var_stencil_chunk`).
//   K10 is a sweep of ν such launches, as K16's in csrc/dia.cu: the first
//   step from x (the window holds x; r = D⁻¹(b − Op_w x), d = r/θ, x_out
//   = x + d), the first from 0 (no window and no Op: r = D⁻¹b, d = r/θ,
//   x_out = d) and a later step (the window holds d_in; r −= D⁻¹ Op_w
//   d_in, d_out = c1·d_in + c2/δ·r, x_out += d_out), r and d ping-ponging
//   in device memory, the last step writing x_out alone. A step holds its
//   points' W[kc] beside the weights for 1/D and loads b (r and x_out) a
//   row ahead. It is the chained one-step kernel's recurrence (`cheb_
//   step_at`), bit for bit, at every ν. The brick it replaced recomputed
//   a halo of ν at each of its ν stages behind a barrier a stage and
//   read W through the L1 at each Op of each row (from HBM at 127³); the
//   chain above the brick's ν ran one thread a point with a runtime tap
//   loop (PERF.md §6).
//   The one-thread-a-point form before it re-read each point's weights at
//   every time row (942 MB from the L2 at 129×511², f32; at 127³ W, 123
//   MB, left the L2 and came from HBM a row at a time) behind a runtime
//   tap loop with a bounds test a tap; it took 5–10× the bytes' bound
//   (PERF.md §6).
// - The other weighted kernels are the same designs with the operator
//   swapped (K13 as K8, K14/K15 as K6/K7). W has no
//   time axis: every row of a level reads the same (ntaps, *gs) field,
//   7.3 MB in f32 at 511² and 15.0 MB at 63³, which the 50 MB L2 holds, so
//   the kernels read it through the read-only path (__ldg) at each Op
//   evaluation rather than staging it. Where W does not fit in the L2 (123
//   MB in f32 at 127³), K13 and the 3-D K14/K15 take the row as the
//   fastest-varying block index (`rows_first`): the rows of one chunk of
//   points (K13) then run back to back and share its part of W there (the
//   3-D K14/K15: the rows of one tile and chunk). Where W fits, the rows
//   go slowest, as in the other kernels: that order was 7–20% faster for
//   the brick K10 and the one-thread-a-point K12 at 63³ and 511² on the
//   H100
//   (PERF.md). The 2-D K14/K15 keep the time row slowest at every size: no
//   2-D level of the solves comes near the L2 (W at 511² is 7.3 MB). On a
//   level whose W exceeded it (a 2-D grid past ~1,370² in f32) each wave
//   of resident blocks, the chunks of a few time rows, would read the
//   whole of W from HBM again: up to 7 values a point for every such wave
//   (28 bytes in f32, against the 12 that x, b and r_c move), where the
//   row-first order shares a chunk's W across the time rows. The 3-D
//   K14/K15 recompute 1/D from W[kc] at each use; the 2-D K14/K15 carry
//   it (above). Their bound is their constant twin's bytes plus one read
//   of W.
//
// Sum order is the plain PyTorch twin's (spacetime_tpu_torch/ops/
// mg_kernels.py): taps in table order within a group, one multiply per
// group, groups in order, the recurrence scalars rounded as the twin
// rounds them, the restriction's pair sums over z, then y, then x. The
// only difference is the compiler's FMA contraction.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxPairGroups = 16;
constexpr int kMaxPairTaps = 32;

// c + a·b as nvcc contracted the multiply-adds of the one-thread-a-point
// K11 and K12 that the time march replaced (one rounding on the card),
// written out so that the march's sums round as theirs did; in the CPU
// emulation, which contracts nothing, it rounds twice, as they did there
// (csrc/kron.cu `KRON_MADD`).
#ifdef __CUDA_ARCH__
#define VAR_MADD(a, b, c) fma((a), (b), (c))
#else
#define VAR_MADD(a, b, c) ((c) + (a) * (b))
#endif

// a + b rounded once and never contracted with a product that feeds it
// (where the chained K10 step stored that product, nvcc kept the two
// roundings; the time march's last step stores it not).
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
#else
template <typename T>
__host__ __device__ inline T add_rn(T a, T b) {
  return a + b;
}
#endif

// (wA, wM) pair groups of two stencils on one grid: group g holds taps
// [start[g], start[g+1]); dz = 0 in 2-D. Mirrored by ctypes in
// spacetime_tpu_torch/ops/native.py.
struct PairGroups {
  int n_groups;
  int start[kMaxPairGroups + 1];
  double wa[kMaxPairGroups];
  double wm[kMaxPairGroups];
  int dz[kMaxPairTaps];
  int dy[kMaxPairTaps];
  int dx[kMaxPairTaps];
};

constexpr int kMaxVarTaps = 27;

// The taps of a weighted stencil in the order of its weight arrays, the
// index kc of the center tap and the mass's center weight cm (the Jacobi
// diagonal is W[kc] + ω·cm); dz = 0 in 2-D. Mirrored by ctypes in
// spacetime_tpu_torch/ops/native.py.
struct VarTaps {
  int n_taps;
  int kc;
  double cm;
  int dz[kMaxVarTaps];
  int dy[kMaxVarTaps];
  int dx[kMaxVarTaps];
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // the x (and 2-D y) extent of a brick
constexpr int kHalfTile = kTile / 2;
constexpr int64_t kMaxBlocks = 1 << 16;
constexpr double kSigma = 5.0 / 3.0;
// Above this much dynamic shared memory a kernel needs its limit raised
// (48 KB, less room for the static group weights and tap offsets).
constexpr int kDefaultSmem = 47 * 1024;

// The grid of one time row; nz = 1 in 2-D. A row holds fewer than 2^31
// points (the wrappers check), so in-row indices are 32-bit; only the time
// row's offset t·S is 64-bit. The kernels are instantiated per dimension,
// so the 2-D forms carry no z arithmetic.
struct Grid {
  int nz, ny, nx;
};

// The transfers on the leading grid axis (z in 3-D, y in 2-D): the
// restriction's coarse plane k sums the fine planes off + 2k, off + 2k + 1
// (and off + 2k + 2), a fine plane l of the prolongation reads the coarse
// planes ⌊(l + s)/2⌋ and ⌊(l + s − 1)/2⌋, and the coarse operand holds nc
// planes there. A serial grid of extent 2n + 1 is {0, 0, n}; a slab of
// own + 2h planes is {h, ·, own/2} for the restriction and {·, 2hc − h,
// own/2 + 2hc} for the prolongation (h = 0 for K9).
struct Lead {
  int off, s, nc;
};

// The brick a block of the tiled kernels owns: (z, y, x) extents.
template <int DIM>
struct BrickOf;
template <>
struct BrickOf<2> {
  static constexpr int z = 1, y = kTile, x = kTile;
};
template <>
struct BrickOf<3> {
  static constexpr int z = 8, y = 8, x = kTile;
};

// The combined weight of group g on a row with shift om.
template <typename T>
__device__ __forceinline__ T group_weight(const PairGroups& pg, int g, T om) {
  const double wa = pg.wa[g];
  const double wm = pg.wm[g];
  if (wm == 0.0) return T(wa);
  if (wa == 0.0) return om * T(wm);
  return T(wa) + om * T(wm);
}

template <int DIM>
__device__ __forceinline__ bool in_grid(const Grid& g, int z, int y, int x) {
  return (DIM == 2 || (z >= 0 && z < g.nz)) && y >= 0 && y < g.ny && x >= 0 &&
         x < g.nx;
}

// Op at grid point (z, y, x) of one row X in device memory (zero outside).
template <int DIM, typename T>
__device__ __forceinline__ T op_global(const PairGroups& pg, T om,
                                       const T* __restrict__ X,
                                       const Grid& g, int z, int y, int x) {
  T out = T(0);
  for (int gi = 0; gi < pg.n_groups; ++gi) {
    T acc = T(0);
    for (int k = pg.start[gi]; k < pg.start[gi + 1]; ++k) {
      const int zz = DIM == 3 ? z + pg.dz[k] : 0;
      const int yy = y + pg.dy[k];
      const int xx = x + pg.dx[k];
      if (in_grid<DIM>(g, zz, yy, xx)) acc += X[(zz * g.ny + yy) * g.nx + xx];
    }
    out += group_weight(pg, gi, om) * acc;
  }
  return out;
}

// A brick of one row and its halo in shared memory: window point
// (lz, ly, lx) is grid point (z0 + lz, y0 + ly, x0 + lx), at offset
// lz·sz + ly·sy + lx. The halo is H in y and x, and in z in 3-D.
struct Window {
  Grid g;
  int z0, y0, x0;
  int H;
  int sy, sz;  // x extent of the window; x · y extents
  int volume;  // points in the window
};

// The window of the block's brick: blockIdx.x walks the x bricks,
// blockIdx.y the (z brick, y brick) pairs.
template <int DIM>
__device__ __forceinline__ Window make_window(const Grid& g, int H) {
  const int bx = int(blockIdx.x), byz = int(blockIdx.y);
  using B = BrickOf<DIM>;
  const int hz = DIM == 3 ? H : 0;
  const int nyb = (g.ny + B::y - 1) / B::y;
  const int zb = DIM == 3 ? byz / nyb : 0;
  const int yb = byz - zb * nyb;
  const int sy = B::x + 2 * H;
  const int sz = sy * (B::y + 2 * H);
  return Window{g,  zb * B::z - hz, yb * B::y - H, bx * B::x - H, H,
                sy, sz,             sz * (B::z + 2 * hz)};
}

// f(offset, grid z, grid y, grid x, index in the row, inside the grid) for
// every point of the brick grown by h cells on each side (in z only in
// 3-D), spread over the block.
template <int DIM, typename F>
__device__ __forceinline__ void for_region(const Window& w, int h, F f) {
  using B = BrickOf<DIM>;
  const int nx = B::x + 2 * h;
  const int nyx = (B::y + 2 * h) * nx;
  const int n = DIM == 3 ? (B::z + 2 * h) * nyx : nyx;
  const int s = w.H - h;
  const int sz = DIM == 3 ? s : 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int iz = DIM == 3 ? i / nyx : 0;
    const int r = i - iz * nyx;
    const int lz = sz + iz;
    const int ly = s + r / nx;
    const int lx = s + r % nx;
    const int gz = w.z0 + lz;
    const int gy = w.y0 + ly;
    const int gx = w.x0 + lx;
    const bool inside = (DIM == 2 || (gz >= 0 && gz < w.g.nz)) && gy >= 0 &&
                        gy < w.g.ny && gx >= 0 && gx < w.g.nx;
    f(lz * w.sz + ly * w.sy + lx, gz, gy, gx, (gz * w.g.ny + gy) * w.g.nx + gx,
      inside);
  }
}

template <typename T>
struct RowCoef {
  T om, iT, iDel;
};

template <typename T>
__device__ __forceinline__ RowCoef<T> row_coef(const T* omega, const T* invT,
                                               const T* invDel, int64_t t) {
  return RowCoef<T>{omega[t], invT[t], invDel[t]};
}

// The most taps of a 2-D stencil (its 3 × 3 neighbourhood): the unrolled
// tap loop of the 2-D marches (`row_many`).
constexpr int kRowTaps = 9;
// The most taps of a 3-D stencil K4 and K5 take (`row_many` unrolled to
// it): the P1 stencils of the Kuhn simplices have 15.
constexpr int kCubeTaps = 16;
// The most A taps and mass taps of a 2-D weighted stencil (`VarOp::
// row_many`): the P1 stencils of the triangles have 7, a point and six
// neighbours (unrolled to kRowTaps = 9, the idle taps' registers spilled
// more).
constexpr int kVarRowTaps = 7;

// The operators of the sweep on a shared-memory window: op(buf, o, gi) is
// Op applied to buf at window offset o (grid index gi in the row, valid
// only inside the grid, where alone the kernels evaluate it) and
// inv_diag(o) the Jacobi 1/D there.
//
// ConstOp: the constant pair groups, w the row's group weights and toff
// the taps' window offsets (shared memory); 1/D per row.
template <typename T>
struct ConstOp {
  const PairGroups& pg;
  const T* w;
  const int* toff;
  T iD;
  // the 2-D marches' (`row_many`): the taps where a group ends (bit k),
  // and the weight of that group at each such tap
  unsigned ends = 0;
  const T* wend = nullptr;
  __device__ __forceinline__ T operator()(const T* buf, int o, int gi) const {
    T out[1];
    many<1>(buf, {o}, {gi}, out);
    return out[0];
  }
  // Op at N points at once (offsets o into buf, a shared-memory buffer
  // whose out-of-grid points hold 0, every point's taps inside it), each
  // tap's offset read once for all N: taps in table order within a group,
  // one multiply per group, groups in order.
  template <int N>
  __device__ __forceinline__ void many(const T* buf, const int (&o)[N],
                                       const int (&)[N], T (&out)[N]) const {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = T(0);
    for (int g = 0; g < pg.n_groups; ++g) {
      T acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = T(0);
      for (int k = pg.start[g]; k < pg.start[g + 1]; ++k) {
        const T* const bk = buf + toff[k];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += bk[o[j]];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] += w[g] * acc[j];
    }
  }
  // Op at N points of a 2-D march's ring row, as `many` (its groups not
  // empty), with the tap loop unrolled to K (kRowTaps; K4 and K5 in 3-D
  // kCubeTaps), every tap's values loaded before they are summed (N loads
  // a tap in flight) and the groups' ends read from the mask `ends` (no
  // loop over the groups): the same sums in the same order.
  template <int N, int K = kRowTaps>
  __device__ __forceinline__ void row_many(const T* buf, const int (&o)[N],
                                           const int (&)[N],
                                           T (&out)[N]) const {
    T v[K][N];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ends >> k) {  // tap k exists: a group ends at it or after it
        const T* const bk = buf + toff[k];
#pragma unroll
        for (int j = 0; j < N; ++j) v[k][j] = bk[o[j]];
      }
    }
    T acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = acc[j] = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ends >> k) {
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += v[k][j];
        if ((ends >> k) & 1u) {
          const T wk = wend[k];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            out[j] += wk * acc[j];
            acc[j] = T(0);
          }
        }
      }
    }
  }
  __device__ __forceinline__ T inv_diag(int, int) const { return iD; }
  // 1/D from what diag_at(gi) reads (the 3-D K6 loads it a plane ahead):
  // nothing here, 1/D is the row's
  __device__ __forceinline__ T diag_at(int) const { return T(0); }
  __device__ __forceinline__ T inv_diag_of(T) const { return iD; }
  // 1/D is one per row: the 2-D marches read it where they use it
  static constexpr bool kPerNode = false;
};

// The weighted operator's per-node 1/D from the centre weight w = W[kc] at
// a grid point: 0 where w + ω·cm ≤ 0 (`_inv_diag_var`).
template <typename T>
__device__ __forceinline__ T var_inv_diag_of(const VarTaps& vt, T om, T w) {
  const T den = w + T(vt.cm) * om;
  return den > T(0) ? T(1) / den : T(0);
}

// The same with its multiply-add written out (`VAR_MADD`), as nvcc
// contracted it in the chained K10 step: the time march computes it for
// several points of a row at once, where the product c_M·ω may be shared.
template <typename T>
__device__ __forceinline__ T var_inv_diag_madd(const VarTaps& vt, T om, T w) {
  const T den = VAR_MADD(T(vt.cm), om, w);
  return den > T(0) ? T(1) / den : T(0);
}

// The same at in-row index gi.
template <typename T>
__device__ __forceinline__ T var_inv_diag_at(const VarTaps& vt,
                                             const T* __restrict__ W, int S,
                                             T om, int gi) {
  return var_inv_diag_of(vt, om, __ldg(W + int64_t(vt.kc) * S + gi));
}

// VarOp: Op_w = A_w + ω·M. atoff / mtoff are the A taps' and the M taps'
// window offsets, wm the M group weights (shared memory), W the level's
// weights (device memory, tap k at W + k·S); the per-node 1/D is
// recomputed from W[kc] at each use (`inv_diag`).
template <typename T>
struct VarOp {
  const VarTaps& vt;
  const PairGroups& pm;
  const T* __restrict__ W;
  int S;
  T om;
  const T* wm;
  const int* atoff;
  const int* mtoff;
  // the 2-D marches' (`row_many`): the mass taps where a group ends (bit
  // k), and that group's weight at each such tap
  unsigned mends = 0;
  const T* mwend = nullptr;
  // Op_w at N points at once (offsets o, in-row indices gi; each inside
  // the window and the row), as ConstOp::many: the A taps in weight-array
  // order, the mass's groups as ConstOp's, then a + ω·m.
  template <int N>
  __device__ __forceinline__ void many(const T* buf, const int (&o)[N],
                                       const int (&gi)[N], T (&out)[N]) const {
    T a[N], m[N];
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = m[j] = T(0);
    for (int k = 0; k < vt.n_taps; ++k) {
      const T* const wk = W + int64_t(k) * S;
      const T* const bk = buf + atoff[k];
#pragma unroll
      for (int j = 0; j < N; ++j) a[j] += __ldg(wk + gi[j]) * bk[o[j]];
    }
    for (int g = 0; g < pm.n_groups; ++g) {
      T acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = T(0);
      for (int k = pm.start[g]; k < pm.start[g + 1]; ++k) {
        const T* const bk = buf + mtoff[k];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += bk[o[j]];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) m[j] += wm[g] * acc[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = a[j] + om * m[j];
  }
  // Op_w at N points of a 2-D march's ring row, as `many`, with the tap
  // loops unrolled to kVarRowTaps (at most so many taps in each table,
  // `var_row_table_ok`): the A taps in
  // weight-array order, every tap's weights (read at the point, gi, from
  // the L2) loaded before the first is used and the ring's values read as
  // they are summed; the mass's groups ended by the mask `mends`, each sum
  // times `mwend` at its last tap (ConstOp::row_many's form); then a + ω·m.
  // The same sums in the same order as `many`. (Loading the ring's values
  // before the sums too, as ConstOp::row_many does, holds 7 more values a
  // point in registers: at the march's 128 registers a thread they
  // spilled; PERF.md §6.)
  template <int N>
  __device__ __forceinline__ void row_many(const T* buf, const int (&o)[N],
                                           const int (&gi)[N],
                                           T (&out)[N]) const {
    constexpr int K = kVarRowTaps;
    T a[N], m[N];
    {
      T w[K][N];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < vt.n_taps) {
          const T* const wk = W + int64_t(k) * S;
#pragma unroll
          for (int j = 0; j < N; ++j) w[k][j] = __ldg(wk + gi[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j) a[j] = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < vt.n_taps) {
          const T* const bk = buf + atoff[k];
#pragma unroll
          for (int j = 0; j < N; ++j) a[j] += w[k][j] * bk[o[j]];
        }
      }
    }
    T acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) m[j] = acc[j] = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (mends >> k) {  // tap k exists: a group ends at it or after it
        const T* const bk = buf + mtoff[k];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += bk[o[j]];
        if ((mends >> k) & 1u) {
          const T wk = mwend[k];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            m[j] += wk * acc[j];
            acc[j] = T(0);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = a[j] + om * m[j];
  }
  __device__ __forceinline__ T inv_diag(int, int gi) const {
    return var_inv_diag_at(vt, W, S, om, gi);
  }
  __device__ __forceinline__ T diag_at(int gi) const {
    return __ldg(W + int64_t(vt.kc) * S + gi);
  }
  __device__ __forceinline__ T inv_diag_of(T w) const {
    return var_inv_diag_of(vt, om, w);
  }
  // 1/D is per node: the 2-D marches carry each point's from the stage
  // that read its diagonal to the later stages of that row, in registers
  static constexpr bool kPerNode = true;
};

// The row's group weights and the taps' window offsets, in shared memory.
// Ends with a __syncthreads().
template <typename T>
__device__ __forceinline__ void row_tables(const PairGroups& pg, T om,
                                           const Window& win, T* wts,
                                           int* toff) {
  if (threadIdx.x < pg.n_groups) {
    wts[threadIdx.x] = group_weight(pg, int(threadIdx.x), om);
  }
  for (int k = threadIdx.x; k < pg.start[pg.n_groups]; k += blockDim.x) {
    toff[k] = pg.dz[k] * win.sz + pg.dy[k] * win.sy + pg.dx[k];
  }
  __syncthreads();
}

// The weighted operator's tables (A and M taps' window offsets, the M
// group weights) in shared memory. Ends with a __syncthreads().
template <typename T>
__device__ __forceinline__ void var_tables(const VarTaps& vt,
                                           const PairGroups& pm,
                                           const Window& win, T* wm,
                                           int* atoff, int* mtoff) {
  if (threadIdx.x < pm.n_groups) wm[threadIdx.x] = T(pm.wm[threadIdx.x]);
  for (int k = threadIdx.x; k < vt.n_taps; k += blockDim.x) {
    atoff[k] = vt.dz[k] * win.sz + vt.dy[k] * win.sy + vt.dx[k];
  }
  for (int k = threadIdx.x; k < pm.start[pm.n_groups]; k += blockDim.x) {
    mtoff[k] = pm.dz[k] * win.sz + pm.dy[k] * win.sy + pm.dx[k];
  }
  __syncthreads();
}

// The validity factor of a sharded slab's sweep at in-row index g: vm[g],
// or 1 without a field (the serial grids).
template <typename T>
__device__ __forceinline__ T valid_at(const T* __restrict__ vm, int g) {
  return vm == nullptr ? T(1) : __ldg(vm + g);
}

// The degree-nu sweep on the window. X holds x on the brick grown by hi + 1
// cells (zero outside the grid) unless zero_init; b is the row in device
// memory. On return X holds the smoothed x on the brick grown by
// hi − (nu − 1) cells. vm (null on serial grids) is the slab's validity
// field: every update of r is multiplied by it (`_smooth_call`'s vmask,
// mg_pallas.py:199-205). Ends with a __syncthreads().
template <int DIM, typename T, typename Op>
__device__ void cheb_sweep(const Op& op, const RowCoef<T>& c,
                           const T* __restrict__ b, const Window& win, T* X,
                           T* D, T* R, int nu, bool zero_init, int hi,
                           const T* __restrict__ vm = nullptr) {
  if (zero_init) {
    for_region<DIM>(win, hi, [&](int o, int, int, int, int g, bool in) {
      const T r = in ? valid_at(vm, g) * (op.inv_diag(o, g) * b[g]) : T(0);
      const T d = r * c.iT;
      R[o] = r;
      D[o] = d;
      X[o] = d;
    });
    __syncthreads();
  } else {
    for_region<DIM>(win, hi, [&](int o, int, int, int, int g, bool in) {
      R[o] = in ? valid_at(vm, g) * (op.inv_diag(o, g) * (b[g] - op(X, o, g)))
                : T(0);
    });
    __syncthreads();
    for_region<DIM>(win, hi, [&](int o, int, int, int, int, bool in) {
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
    for_region<DIM>(win, hi - k, [&](int o, int, int, int, int g, bool in) {
      if (in) R[o] = valid_at(vm, g) * (R[o] - op.inv_diag(o, g) * op(D, o, g));
    });
    __syncthreads();
    for_region<DIM>(win, hi - k, [&](int o, int, int, int, int, bool in) {
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

// Shared memory of the tiled kernels: X, D and R (and 1/D for the weighted
// ones) over the window.
template <typename T>
__device__ __forceinline__ T* window_buffers() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

__host__ __device__ __forceinline__ int64_t row_size(const Grid& g) {
  return int64_t(g.nz) * g.ny * g.nx;
}

// K3; with vm (non-null) its sharded-slab form.
template <int DIM, typename T>
__global__ void __launch_bounds__(kThreads)
    mg_smooth_kernel(const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ vm, const T* __restrict__ omega,
                     const T* __restrict__ invD, const T* __restrict__ invT,
                     const T* __restrict__ invDel, T* __restrict__ out,
                     Grid g, const __grid_constant__ PairGroups pg, int nu,
                     int zero_init) {
  __shared__ T wts[kMaxPairGroups];
  __shared__ int toff[kMaxPairTaps];
  const int64_t t = blockIdx.z;
  const int64_t S = row_size(g);
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  const int H = zero_init ? nu - 1 : nu;
  const Window win = make_window<DIM>(g, H);
  T* X = window_buffers<T>();
  T* D = X + win.volume;
  T* R = D + win.volume;
  if (!zero_init) {
    const T* xt = x + t * S;
    for_region<DIM>(win, H, [&](int o, int, int, int, int gi, bool in) {
      X[o] = in ? xt[gi] : T(0);
    });
  }
  row_tables(pg, c.om, win, wts, toff);
  cheb_sweep<DIM>(ConstOp<T>{pg, wts, toff, invD[t]}, c, b + t * S, win, X,
                  D, R, nu, zero_init != 0, zero_init ? H : H - 1, vm);
  T* ot = out + t * S;
  for_region<DIM>(win, 0, [&](int o, int, int, int, int gi, bool in) {
    if (in) ot[gi] = X[o];
  });
}

// (t, z, y, x) of flat index idx of a (nt, nz, ny, nx) field: one 64-bit
// division for the row, 32-bit ones within it.
struct Point {
  int64_t t;
  int z, y, x;
};

// The point at in-row index r of row t.
template <int DIM>
__device__ __forceinline__ Point point_in_row(int64_t t, int r,
                                              const Grid& g) {
  const int z = DIM == 3 ? r / (g.ny * g.nx) : 0;
  const int ryx = r - z * (g.ny * g.nx);
  const int y = ryx / g.nx;
  return Point{t, z, y, ryx - y * g.nx};
}

template <int DIM>
__device__ __forceinline__ Point point_of(int64_t idx, const Grid& g) {
  const int64_t S = row_size(g);
  const int64_t t = idx / S;
  return point_in_row<DIM>(t, int(idx - t * S), g);
}

// f(row t, in-row index r) for every point of an (nt, S) field, one thread
// per point in a grid-stride loop. With rows_first, block k of the loop
// takes chunk k / nt of kThreads points of row k % nt, so the rows of one
// chunk run back to back; else the flat index runs, x fastest.
template <typename F>
__device__ __forceinline__ void for_each_point(int64_t nt, int64_t S,
                                               bool rows_first, F f) {
  if (rows_first) {
    const int64_t blocks = nt * ((S + kThreads - 1) / kThreads);
    for (int64_t k = blockIdx.x; k < blocks; k += gridDim.x) {
      const int64_t t = k % nt;
      const int64_t r = (k / nt) * kThreads + threadIdx.x;
      if (r < S) f(t, int(r));
    }
    return;
  }
  for (int64_t idx = blockIdx.x * int64_t(kThreads) + threadIdx.x;
       idx < nt * S; idx += int64_t(gridDim.x) * kThreads) {
    const int64_t t = idx / S;
    f(t, int(idx - t * S));
  }
}

// The coarse grid of a fine grid with odd extents (nz = 1 stays in 2-D).
template <int DIM>
__host__ __device__ __forceinline__ Grid coarse_grid(const Grid& g) {
  return Grid{DIM == 3 ? (g.nz - 1) / 2 : 1, (g.ny - 1) / 2, (g.nx - 1) / 2};
}

// The serial transfers of a grid: {0, 0, n} on a lead axis of 2n + 1.
template <int DIM>
__host__ __device__ __forceinline__ Lead serial_lead(const Grid& g) {
  return Lead{0, 0, ((DIM == 3 ? g.nz : g.ny) - 1) / 2};
}

// The coarse grid of the transfers `ld` on a fine grid: its lead axis ld.nc
// planes, the others as `coarse_grid`.
template <int DIM>
__host__ __device__ __forceinline__ Grid coarse_grid(const Grid& g,
                                                     const Lead& ld) {
  const Grid c = coarse_grid<DIM>(g);
  return DIM == 3 ? Grid{ld.nc, c.ny, c.nx} : Grid{1, ld.nc, c.nx};
}

// The grid-stride loop of the one-thread-per-point kernels.
#define FOR_EACH_INDEX(idx, total)                                       \
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;     \
       idx < (total); idx += int64_t(gridDim.x) * blockDim.x)

// R r at coarse point c, res(z, y, x) the fine residual: h = r[f] + r[f + 1⃗]
// at fine f = f0 + (a, p, q), f0 = 2c but on the lead axis, where it is
// ld.off + 2c, then pair sums over z (3-D), y and x in turn. Every fine
// point it reads is inside the grid, since 2c + 2 ≤ 2n on extents 2n + 1
// (and off + own ≤ own + 2h − 1 on a slab).
template <int DIM, typename T, typename Res>
__device__ __forceinline__ T restrict_at(const Point& c, const Lead& ld,
                                         const Res& res) {
  const int fz = 2 * c.z + (DIM == 3 ? ld.off : 0);
  const int fy = 2 * c.y + (DIM == 3 ? 0 : ld.off);
  const int fx = 2 * c.x;
  constexpr int dz = DIM == 3 ? 1 : 0;
  auto h = [&](int a, int p, int q) {
    return res(fz + a, fy + p, fx + q) +
           res(fz + a + dz, fy + p + 1, fx + q + 1);
  };
  T py[2];
  for (int q = 0; q < 2; ++q) {
    T pz[2];
    for (int p = 0; p < 2; ++p) {
      pz[p] = DIM == 3 ? h(0, p, q) + h(1, p, q) : h(0, p, q);
    }
    py[q] = pz[0] + pz[1];
  }
  return T(0.5) * (py[0] + py[1]);
}

// K8 (ld serial) and its sharded-slab form (the owned coarse planes).
template <int DIM, typename T>
__global__ void mg_residual_restrict_kernel(
    const T* __restrict__ x, const T* __restrict__ b,
    const T* __restrict__ omega, T* __restrict__ rc, int64_t nt, Grid g,
    const __grid_constant__ PairGroups pg, Lead ld) {
  const int64_t S = row_size(g);
  const Grid gc = coarse_grid<DIM>(g, ld);
  FOR_EACH_INDEX(idx, nt * row_size(gc)) {
    const Point c = point_of<DIM>(idx, gc);
    const T om = omega[c.t];
    const T* xt = x + c.t * S;
    const T* bt = b + c.t * S;
    rc[idx] = restrict_at<DIM, T>(c, ld, [&](int z, int y, int xx) {
      return bt[(z * g.ny + y) * g.nx + xx] -
             op_global<DIM>(pg, om, xt, g, z, y, xx);
    });
  }
}

// P e_c at fine point (z, y, x) of the grid, et the coarse row gc:
// ½(e[⌊f/2⌋] + e[⌊(f − 1⃗)/2⌋]), zero beyond the coarse grid, the lead
// axis's f shifted by ld.s.
template <int DIM, typename T>
__device__ __forceinline__ T prolong_at(const T* __restrict__ et,
                                        const Grid& gc, const Lead& ld, int z,
                                        int y, int x) {
  auto coarse = [&](int cz, int cy, int cx) {
    return (cz >= 0 && cz < gc.nz && cy >= 0 && cy < gc.ny && cx >= 0 &&
            cx < gc.nx)
               ? et[(cz * gc.ny + cy) * gc.nx + cx]
               : T(0);
  };
  const int zs = DIM == 3 ? z + ld.s : 0;
  const int ys = DIM == 3 ? y : y + ld.s;
  const T e0 = coarse(zs >> 1, ys >> 1, x >> 1);
  const T e1 = coarse(DIM == 3 ? (zs - 1) >> 1 : 0, (ys - 1) >> 1,
                      (x - 1) >> 1);
  return T(0.5) * (e0 + e1);
}

// K9 (ld serial) and its sharded-slab form (e_c with halo planes).
template <int DIM, typename T>
__global__ void mg_prolong_correct_kernel(const T* __restrict__ x,
                                          const T* __restrict__ ec,
                                          T* __restrict__ out, int64_t nt,
                                          Grid g, Lead ld) {
  const Grid gc = coarse_grid<DIM>(g, ld);
  const int64_t Sc = row_size(gc);
  FOR_EACH_INDEX(idx, nt * row_size(g)) {
    const Point f = point_of<DIM>(idx, g);
    out[idx] = x[idx] + prolong_at<DIM>(ec + f.t * Sc, gc, ld, f.z, f.y, f.x);
  }
}

// The 3-D fused stages march in z. A block owns a kMarchY × kMarchX (y, x)
// tile of one time row and a chunk of planes (every plane of the row
// where the launch fills the card without cutting it), and walks the fine
// planes in order, one a step. Each stage of the pipeline lags the one
// before by a plane and keeps, in shared memory, a ring of the three
// planes the next stage's Op reads. K6 and K14 (`march_fused_pre`, H = ν
// + 1, chunks of coarse planes):
//
//   stage 0, plane t:       r = vm·D⁻¹b, d = r/θ, x = d        → ring of d
//   stage k, plane t − k:   r = vm·(r − D⁻¹ Op d), d = c1 d + c2 r,
//                           x += d  (k = 1 … ν−1)              → ring of d
//                           (the last stage: x → the ring of x, and out)
//   residual, plane t − ν:  b − Op x                           → ring of r
//   restriction:            coarse plane k once fine planes off + 2k,
//                           + 1, + 2 of the residual are in (`restrict_at`)
//
// K7 and K15 (`march_fused_post`, H = ν, chunks of fine planes):
//
//   stage 0, plane t:       X₀ = x + P e_c                     → ring of X₀
//   stage 1, plane t − 1:   r = vm·D⁻¹(b − Op X₀), d = r/θ, x = X₀ + d
//                                                              → ring of d
//   stage k, plane t − k:   r = vm·(r − D⁻¹ Op d), d = c1 d + c2 r,
//                           x += d  (k = 2 … ν; the last: x → out)
//
// Plane p lies in slot p mod 3 of each ring, so Op reads the taps of plane
// p through the offset table of rotation p mod 3, resolved once per block.
// Every thread keeps the same points of the window plane for the whole
// march, and the pointwise terms of each stage (r and x) in registers;
// only what Op reads at neighbours goes through shared memory. The xy halo
// shrinks by one cell a stage as in the tiled sweep (stage k on the tile
// grown by H − k); in z only the chunk's two ends are computed twice.
constexpr int kMarchY = 16, kMarchX = 32;
constexpr int kMarchSlots = 4;  // the pre-stage's points a thread

// The window plane of a march with halo H: the tile grown by H a side.
template <int HALO>
struct March {
  static constexpr int H = HALO;
  static constexpr int WY = kMarchY + 2 * H, WX = kMarchX + 2 * H;
  static constexpr int P = WY * WX;  // points of a window plane
  // the points of depth ≥ d: the tile grown by H − d
  __host__ __device__ static constexpr int at_depth(int d) {
    return (kMarchY + 2 * (H - d)) * (kMarchX + 2 * (H - d));
  }
  // the slots of kThreads threads that n points take
  __host__ __device__ static constexpr int slots(int n) {
    return (n + kThreads - 1) / kThreads;
  }
};

// The blocks an SM must hold of each march kernel (its register cap),
// chosen by timing on the H100 (PERF.md): in float32 4 for K6 and K7, and
// for K15 where it takes the row first (W beyond the L2; at 2 where W
// fits), else 2.
template <typename T>
__host__ __device__ constexpr int march_min_blocks(bool var, bool post,
                                                   bool rows_first = false) {
  return sizeof(T) == 4 && (!var || (post && rows_first)) ? 4 : 2;
}

template <int N>
struct Int {
  static constexpr int value = N;
};

__device__ __forceinline__ int mod3(int p) { return (p % 3 + 3) % 3; }

// The window offsets of n taps on a ring of three planes of halo H, for
// each rotation r (the tapped point's plane in slot r): off[r·stride + k].
template <int H>
__device__ __forceinline__ void ring_offsets(int n, const int* dz,
                                             const int* dy, const int* dx,
                                             int stride, int* off) {
  using M = March<H>;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
    const int r = i / n, k = i - r * n;
    off[r * stride + k] = mod3(r + dz[k]) * M::P + dy[k] * M::WX + dx[k];
  }
}

// A block's tile (its first grid point) and chunk index c. blockIdx is (x
// tile, (chunk, y tile), row), or with rows_first (row, x tile, (chunk, y
// tile)) (`march_blocks`).
struct MarchTile {
  int y0, x0, c;
};

__device__ __forceinline__ MarchTile march_tile(const Grid& g,
                                                bool rows_first) {
  const int bx = int(rows_first ? blockIdx.y : blockIdx.x);
  const int bcy = int(rows_first ? blockIdx.z : blockIdx.y);
  const int nty = (g.ny + kMarchY - 1) / kMarchY;
  const int c = bcy / nty;
  return MarchTile{(bcy - c * nty) * kMarchY, bx * kMarchX, c};
}

// A block's tile and chunk: the coarse planes [k_lo, k_hi) the pre-stage
// restricts to (none in the post-stage) and the fine planes [f_lo, f_hi)
// of x it writes.
struct MarchChunk {
  int y0, x0;
  int k_lo, k_hi;
  int f_lo, f_hi;
};

// The pre-stage's: chunks of coarse planes, the first from fine plane 0,
// the last to nz.
__device__ __forceinline__ MarchChunk march_chunk(const Grid& g, const Lead& ld,
                                                  int chunk, bool rows_first) {
  const MarchTile mt = march_tile(g, rows_first);
  const int k_lo = mt.c * chunk;
  const int k_hi = min(k_lo + chunk, ld.nc);
  return MarchChunk{mt.y0, mt.x0, k_lo, k_hi,
                    mt.c == 0 ? 0 : ld.off + 2 * k_lo,
                    k_lo + chunk >= ld.nc ? g.nz : ld.off + 2 * k_hi};
}

// The post-stage's: the fine planes [c·chunk, (c + 1)·chunk), cut at nz.
__device__ __forceinline__ MarchChunk march_post_chunk(const Grid& g,
                                                       int chunk,
                                                       bool rows_first) {
  const MarchTile mt = march_tile(g, rows_first);
  const int f_lo = mt.c * chunk;
  return MarchChunk{mt.y0, mt.x0, 0, 0, f_lo, min(f_lo + chunk, g.nz)};
}

// The march of one block: x on its fine planes (xt, the row) and r_c on
// its coarse planes (rct). op_at(r) is the operator on a ring whose
// centre plane lies in slot r (`ConstOp` / `VarOp` with that rotation's
// offsets); vm the slab's validity field, or null.
template <int NU, typename T, typename OpAt>
__device__ void march_fused_pre(const OpAt& op_at, const RowCoef<T>& c,
                                const T* __restrict__ bt,
                                const T* __restrict__ vm, const Grid& g,
                                const Lead& ld, const MarchChunk& mc,
                                T* __restrict__ xt, T* __restrict__ rct) {
  using M = March<NU + 1>;
  constexpr int H = M::H, P = M::P, WX = M::WX, S = kMarchSlots;
  static_assert(P <= S * kThreads, "window plane over the slots");
  constexpr int kCentre = (M::WY / 2) * WX + WX / 2;  // taps stay inside
  T* const ring = window_buffers<T>();  // ring k: 3 planes from ring + 3Pk
  T* const X = ring + 3 * P * (NU - 1);
  T* const RS = X + 3 * P;
  const int plane = g.ny * g.nx;
  // this thread's window points: offset, in-plane grid index, distance to
  // the window's edge (−1 past the plane), inside the grid in y and x,
  // and in the residual's region (the tile and one row and column past it)
  int po[S], pxy[S], depth[S];
  bool inxy[S], inres[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int o = int(threadIdx.x) + j * kThreads;
    const int ly = o / WX, lx = o - ly * WX;
    const int gy = mc.y0 - H + ly, gx = mc.x0 - H + lx;
    po[j] = o;
    pxy[j] = gy * g.nx + gx;
    depth[j] =
        o < P ? min(min(ly, lx), min(M::WY - 1 - ly, WX - 1 - lx)) : -1;
    inxy[j] = o < P && gy >= 0 && gy < g.ny && gx >= 0 && gx < g.nx;
    inres[j] = o < P && ly >= H && ly <= H + kMarchY && lx >= H &&
              lx <= H + kMarchX;
  }
  // this thread's coarse point of the tile, if any
  const Grid gc = coarse_grid<3>(g, ld);
  constexpr int ncx = kMarchX / 2;
  const int cy = mc.y0 / 2 + int(threadIdx.x) / ncx;
  const int cx = mc.x0 / 2 + int(threadIdx.x) % ncx;
  const bool restricts =
      threadIdx.x < kMarchY / 2 * ncx && cy < gc.ny && cx < gc.nx;
  T c1[NU], c2[NU];
  double rho = 1.0 / kSigma;
#pragma unroll
  for (int k = 1; k < NU; ++k) {
    const double rho_new = 1.0 / (2.0 * kSigma - rho);
    c1[k] = T(rho_new * rho);
    c2[k] = T(2.0 * rho_new) * c.iDel;
    rho = rho_new;
  }
  // the planes of each stage: the residual's r_lo … r_hi − 1; x on
  // [x_lo, x_hi) (its own planes and those the residual reads); stage k on
  // that grown by ν − 1 − k planes
  const int r_lo = ld.off + 2 * mc.k_lo, r_hi = ld.off + 2 * mc.k_hi + 1;
  const int x_lo = min(mc.f_lo, r_lo - 1), x_hi = max(mc.f_hi, r_hi + 1);
  T rr[NU - 1][S], xr[NU - 1][S];  // r, x of stages 0 … ν−2, last plane
  // b and the diagonal's entry (`diag_at`) of stage 0's plane, b of the
  // residual's: loaded a step ahead, so that no stage waits on device
  // memory between two barriers
  const auto op0 = op_at(0);
  T b0[S], d0[S], br[S];
  auto load = [&](int p0, T (&b)[S], T (&d)[S], T (&bres)[S]) {
    const bool zin = p0 >= 0 && p0 < g.nz;
    const int pr = p0 - NU;
    const bool rin = pr >= r_lo && pr < r_hi;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int gi = p0 * plane + pxy[j];
      b[j] = zin && inxy[j] ? bt[gi] : T(0);
      d[j] = zin && inxy[j] ? op0.diag_at(gi) : T(0);
      bres[j] = rin && inxy[j] && inres[j] ? bt[pr * plane + pxy[j]] : T(0);
    }
  };
  load(x_lo - (NU - 1), b0, d0, br);
  for (int t = x_lo - (NU - 1); t < x_hi + NU - 1; ++t) {
    T rn[NU - 1][S], xn[NU - 1][S];
    T b0n[S], d0n[S], brn[S];
    load(t + 1, b0n, d0n, brn);
    auto stage = [&](auto K) {
      constexpr int k = decltype(K)::value;
      const int p = t - k;
      if (p < x_lo - (NU - 1 - k)) return;
      const int rot = mod3(p);
      const bool zin = p >= 0 && p < g.nz;
      const auto op = op_at(rot);
      const T* const din = ring + 3 * P * (k > 0 ? k - 1 : 0);
      T* const out = (k < NU - 1 ? ring + 3 * P * k : X) + rot * P;
      // Op d at this stage's points (the others read at the window's centre)
      int oo[S], gg[S];
      T opd[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const bool in = zin && inxy[j] && depth[j] >= k;
        oo[j] = depth[j] >= k ? po[j] : kCentre;
        gg[j] = in ? p * plane + pxy[j] : 0;
      }
      if constexpr (k > 0) op.many(din, oo, gg, opd);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (depth[j] < k) continue;
        const bool in = zin && inxy[j];
        const int gi = gg[j];
        T r = T(0), d = T(0), x = T(0);
        if (in) {
          if constexpr (k == 0) {
            r = valid_at(vm, gi) * (op.inv_diag_of(d0[j]) * b0[j]);
            d = r * c.iT;
            x = d;
          } else {
            r = valid_at(vm, gi) *
                (rr[k - 1][j] - op.inv_diag(po[j], gi) * opd[j]);
            d = c1[k] * din[rot * P + po[j]] + c2[k] * r;
            x = xr[k - 1][j] + d;
          }
        }
        if constexpr (k < NU - 1) {
          out[po[j]] = d;
          rn[k][j] = r;
          xn[k][j] = x;
        } else {
          out[po[j]] = x;
          if (in && depth[j] >= H && p >= mc.f_lo && p < mc.f_hi) {
            xt[gi] = x;
          }
        }
      }
    };
    stage(Int<0>{});
    __syncthreads();
    stage(Int<1>{});
    __syncthreads();
    if constexpr (NU > 2) {
      stage(Int<2>{});
      __syncthreads();
    }
    const int p = t - NU;
    if (p >= r_lo && p < r_hi) {
      const int rot = mod3(p);
      int oo[S], gg[S];
      T opx[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        oo[j] = inres[j] ? po[j] : kCentre;
        gg[j] = inres[j] && inxy[j] ? p * plane + pxy[j] : 0;
      }
      op_at(rot).many(X, oo, gg, opx);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (inres[j]) {
          RS[rot * P + po[j]] = inxy[j] ? br[j] - opx[j] : T(0);
        }
      }
      __syncthreads();
      if (((p - ld.off) & 1) == 0 && p >= r_lo + 2 && restricts) {
        const int kc = (p - ld.off) / 2 - 1;
        const int fz = p - 2, s0 = mod3(fz);
        rct[(kc * gc.ny + cy) * gc.nx + cx] = restrict_at<3, T>(
            Point{0, kc, cy, cx}, ld, [&](int z, int y, int x) {
              const int s = s0 + z - fz;
              return RS[(s < 3 ? s : s - 3) * P +
                        (y - mc.y0 + H) * WX + (x - mc.x0 + H)];
            });
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int k = 0; k < NU - 1; ++k) {
        rr[k][j] = rn[k][j];
        xr[k][j] = xn[k][j];
      }
      b0[j] = b0n[j];
      d0[j] = d0n[j];
      br[j] = brn[j];
    }
  }
}

// The 3-D K6 (ld serial, vm null) and its sharded-slab form.
template <int NU, typename T>
__global__ void __launch_bounds__(kThreads,
                                  march_min_blocks<T>(false, false))
    mg_march_pre_kernel(const T* __restrict__ b, const T* __restrict__ vm,
                        const T* __restrict__ omega,
                        const T* __restrict__ invD,
                        const T* __restrict__ invT,
                        const T* __restrict__ invDel, T* __restrict__ xo,
                        T* __restrict__ rco, Grid g,
                        const __grid_constant__ PairGroups pg, Lead ld,
                        int chunk) {
  __shared__ T wts[kMaxPairGroups];
  __shared__ int toff[3 * kMaxPairTaps];
  const int64_t t = blockIdx.z;
  const int64_t S = row_size(g);
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  if (threadIdx.x < pg.n_groups) {
    wts[threadIdx.x] = group_weight(pg, int(threadIdx.x), c.om);
  }
  ring_offsets<NU + 1>(pg.start[pg.n_groups], pg.dz, pg.dy, pg.dx,
                       kMaxPairTaps, toff);
  __syncthreads();
  const T iD = invD[t];
  march_fused_pre<NU>(
      [&](int r) {
        return ConstOp<T>{pg, wts, toff + r * kMaxPairTaps, iD};
      },
      c, b + t * S, vm, g, ld, march_chunk(g, ld, chunk, false), xo + t * S,
      rco + t * row_size(coarse_grid<3>(g, ld)));
}

// The 3-D K14: 1/D recomputed from W at each use (`VarOp::inv_diag`).
template <int NU, typename T>
__global__ void __launch_bounds__(kThreads,
                                  march_min_blocks<T>(true, false))
    mg_march_pre_var_kernel(const T* __restrict__ b, const T* __restrict__ W,
                            const T* __restrict__ omega,
                            const T* __restrict__ invT,
                            const T* __restrict__ invDel, T* __restrict__ xo,
                            T* __restrict__ rco, Grid g,
                            const __grid_constant__ VarTaps vt,
                            const __grid_constant__ PairGroups pm, int chunk,
                            int rows_first) {
  __shared__ T wm[kMaxPairGroups];
  __shared__ int atoff[3 * kMaxVarTaps];
  __shared__ int mtoff[3 * kMaxPairTaps];
  const int64_t t = rows_first ? blockIdx.x : blockIdx.z;
  const int S = int(row_size(g));
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  if (threadIdx.x < pm.n_groups) wm[threadIdx.x] = T(pm.wm[threadIdx.x]);
  ring_offsets<NU + 1>(vt.n_taps, vt.dz, vt.dy, vt.dx, kMaxVarTaps, atoff);
  ring_offsets<NU + 1>(pm.start[pm.n_groups], pm.dz, pm.dy, pm.dx,
                       kMaxPairTaps, mtoff);
  __syncthreads();
  const Lead ld = serial_lead<3>(g);
  march_fused_pre<NU>(
      [&](int r) {
        return VarOp<T>{vt, pm, W, S, c.om, wm, atoff + r * kMaxVarTaps,
                        mtoff + r * kMaxPairTaps};
      },
      c, b + t * S, static_cast<const T*>(nullptr), g, ld,
      march_chunk(g, ld, chunk, rows_first != 0), xo + t * S,
      rco + t * row_size(coarse_grid<3>(g)));
}

// Window point q of the post-stage's deepest-first order on March<H>'s
// plane: the tile in row order (q < kMarchY·kMarchX: the first
// kTileSlots slots of every thread), then the frames of depth H − 1, …,
// 0, each its top row, its bottom row, then its left and right columns a
// row at a time. Sets the point's window row and column and returns its
// depth (H for the tile), or −1 for q past the plane.
template <int H>
__device__ __forceinline__ int march_post_point(int q, int& ly, int& lx) {
  using M = March<H>;
  ly = lx = 0;
  if (q < kMarchY * kMarchX) {
    ly = H + q / kMarchX;
    lx = H + q % kMarchX;
    return H;
  }
  for (int d = H - 1; d >= 0; --d) {
    if (q >= M::at_depth(d)) continue;
    const int i = q - M::at_depth(d + 1);
    const int ww = M::WX - 2 * d;
    if (i < 2 * ww) {
      ly = i < ww ? d : M::WY - 1 - d;
      lx = d + (i < ww ? i : i - ww);
    } else {
      ly = d + 1 + (i - 2 * ww) / 2;
      lx = (i - 2 * ww) & 1 ? M::WX - 1 - d : d;
    }
    return d;
  }
  return -1;
}

// A thread's slots that hold tile points, for every thread.
constexpr int kTileSlots = kMarchY * kMarchX / kThreads;

// The post-stage's march of one block: x on its fine planes [mc.f_lo,
// mc.f_hi) of the row (ot), from x (xt), b (bt) and e_c (et, the coarse
// row of the transfers ld, read with K9's `prolong_at` arithmetic). op_at
// as in march_fused_pre; vm the slab's validity field, or null.
template <int NU, typename T, typename OpAt>
__device__ void march_fused_post(const OpAt& op_at, const RowCoef<T>& c,
                                 const T* __restrict__ xt,
                                 const T* __restrict__ et,
                                 const T* __restrict__ bt,
                                 const T* __restrict__ vm, const Grid& g,
                                 const Lead& ld, const MarchChunk& mc,
                                 T* __restrict__ ot) {
  using M = March<NU>;
  constexpr int H = M::H, P = M::P, WX = M::WX;
  // a thread's points: S over the window plane, S1 of them stage 1's
  constexpr int S = M::slots(P), S1 = M::slots(M::at_depth(1));
  constexpr int kCentre = (M::WY / 2) * WX + WX / 2;  // taps stay inside
  static_assert(kTileSlots * kThreads == kMarchY * kMarchX, "tile slots");
  T* const ring = window_buffers<T>();  // ring k: 3 planes from ring + 3Pk
  const int plane = g.ny * g.nx;
  const Grid gc = coarse_grid<3>(g, ld);
  const int cplane = gc.ny * gc.nx;
  // this thread's window points: offset, in-plane grid index, depth,
  // inside the grid in y and x, and the in-plane indices of the two coarse
  // points P e_c reads there (−1 beyond the coarse grid)
  int po[S], pxy[S], depth[S], pc0[S], pc1[S];
  bool inxy[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    int ly, lx;
    depth[j] = march_post_point<H>(int(threadIdx.x) + j * kThreads, ly, lx);
    const int gy = mc.y0 - H + ly, gx = mc.x0 - H + lx;
    po[j] = ly * WX + lx;
    pxy[j] = gy * g.nx + gx;
    inxy[j] = depth[j] >= 0 && gy >= 0 && gy < g.ny && gx >= 0 && gx < g.nx;
    auto coarse = [&](int cy, int cx) {
      return cy >= 0 && cy < gc.ny && cx >= 0 && cx < gc.nx ? cy * gc.nx + cx
                                                            : -1;
    };
    pc0[j] = coarse(gy >> 1, gx >> 1);
    pc1[j] = coarse((gy - 1) >> 1, (gx - 1) >> 1);
  }
  // whether slot j's point has depth ≥ k (the tile's slots always do)
  auto deep = [&](int j, int k) { return j < kTileSlots || depth[j] >= k; };
  T c1[NU], c2[NU];
  double rho = 1.0 / kSigma;
#pragma unroll
  for (int k = 1; k < NU; ++k) {
    const double rho_new = 1.0 / (2.0 * kSigma - rho);
    c1[k] = T(rho_new * rho);
    c2[k] = T(2.0 * rho_new) * c.iDel;
    rho = rho_new;
  }
  // stage 0's x and coarse values, and stage 1's b and diagonal entry
  // (`diag_at`): each loaded once its stage has used the last ones, a
  // step before it needs them, so that no stage waits on device memory
  // between two barriers
  const auto op0 = op_at(0);
  T xv[S], e0[S], e1[S], bv[S1], dv[S1];
  auto load0 = [&](int p) {
    const bool zin = p >= 0 && p < g.nz;
    const int z0 = (p + ld.s) >> 1, z1 = (p + ld.s - 1) >> 1;
    const bool in0 = z0 >= 0 && z0 < gc.nz, in1 = z1 >= 0 && z1 < gc.nz;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool in = zin && inxy[j];
      xv[j] = in ? xt[p * plane + pxy[j]] : T(0);
      e0[j] = in && in0 && pc0[j] >= 0 ? et[z0 * cplane + pc0[j]] : T(0);
      e1[j] = in && in1 && pc1[j] >= 0 ? et[z1 * cplane + pc1[j]] : T(0);
    }
  };
  auto load1 = [&](int p) {
    const bool zin = p >= 0 && p < g.nz;
#pragma unroll
    for (int j = 0; j < S1; ++j) {
      const bool in = zin && inxy[j] && deep(j, 1);
      bv[j] = in ? bt[p * plane + pxy[j]] : T(0);
      dv[j] = in ? op0.diag_at(p * plane + pxy[j]) : T(0);
    }
  };
  T rr[NU - 1][S1], xr[NU - 1][S1];  // r, x of stages 1 … ν−1, last plane
  const int t0 = mc.f_lo - NU;
  load0(t0);
  load1(t0 - 1);
  for (int t = t0; t < mc.f_hi + NU; ++t) {
    {  // stage 0: X₀ = x + P e_c on window plane t, 0 outside the grid
      const bool zin = t >= 0 && t < g.nz;
      T* const out = ring + mod3(t) * P;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (deep(j, 0)) {
          out[po[j]] =
              zin && inxy[j] ? xv[j] + T(0.5) * (e0[j] + e1[j]) : T(0);
        }
      }
    }
    load0(t + 1);
    __syncthreads();
    T rn[NU - 1][S1], xn[NU - 1][S1];
    auto stage = [&](auto K) {
      constexpr int k = decltype(K)::value;
      constexpr int NS = M::slots(M::at_depth(k));  // its points a thread
      const int p = t - k;
      if (p < mc.f_lo - (NU - k)) return;
      const int rot = mod3(p);
      const bool zin = p >= 0 && p < g.nz;
      const auto op = op_at(rot);
      const T* const din = ring + 3 * P * (k - 1);  // X₀, then d_{k−1}
      // Op at this stage's points (the others read at the window's centre)
      int oo[NS], gg[NS];
      T opd[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        oo[j] = deep(j, k) ? po[j] : kCentre;
        gg[j] = zin && inxy[j] && deep(j, k) ? p * plane + pxy[j] : 0;
      }
      op.many(din, oo, gg, opd);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (!deep(j, k)) continue;
        const bool in = zin && inxy[j];
        const int gi = gg[j];
        T r = T(0), d = T(0), x = T(0);
        if (in) {
          if constexpr (k == 1) {
            r = valid_at(vm, gi) * (op.inv_diag_of(dv[j]) * (bv[j] - opd[j]));
            d = r * c.iT;
            x = din[rot * P + po[j]] + d;
          } else {
            r = valid_at(vm, gi) *
                (rr[k - 2][j] - op.inv_diag(po[j], gi) * opd[j]);
            d = c1[k - 1] * din[rot * P + po[j]] + c2[k - 1] * r;
            x = xr[k - 2][j] + d;
          }
        }
        if constexpr (k < NU) {
          ring[3 * P * k + rot * P + po[j]] = d;
          rn[k - 1][j] = r;
          xn[k - 1][j] = x;
        } else if (in && p >= mc.f_lo && p < mc.f_hi) {
          ot[gi] = x;
        }
      }
    };
    stage(Int<1>{});
    load1(t);
    __syncthreads();
    stage(Int<2>{});
    if constexpr (NU > 2) {
      __syncthreads();
      stage(Int<3>{});
    }
#pragma unroll
    for (int k = 0; k < NU - 1; ++k) {
#pragma unroll
      for (int j = 0; j < S1; ++j) {
        rr[k][j] = rn[k][j];
        xr[k][j] = xn[k][j];
      }
    }
  }
}

// The 3-D K7 (ld serial, vm null) and its sharded-slab form.
template <int NU, typename T>
__global__ void __launch_bounds__(kThreads,
                                  march_min_blocks<T>(false, true))
    mg_march_post_kernel(const T* __restrict__ x, const T* __restrict__ b,
                         const T* __restrict__ ec, const T* __restrict__ vm,
                         const T* __restrict__ omega,
                         const T* __restrict__ invD,
                         const T* __restrict__ invT,
                         const T* __restrict__ invDel, T* __restrict__ out,
                         Grid g, const __grid_constant__ PairGroups pg,
                         Lead ld, int chunk) {
  __shared__ T wts[kMaxPairGroups];
  __shared__ int toff[3 * kMaxPairTaps];
  const int64_t t = blockIdx.z;
  const int64_t S = row_size(g);
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  if (threadIdx.x < pg.n_groups) {
    wts[threadIdx.x] = group_weight(pg, int(threadIdx.x), c.om);
  }
  ring_offsets<NU>(pg.start[pg.n_groups], pg.dz, pg.dy, pg.dx, kMaxPairTaps,
                   toff);
  __syncthreads();
  const T iD = invD[t];
  march_fused_post<NU>(
      [&](int r) {
        return ConstOp<T>{pg, wts, toff + r * kMaxPairTaps, iD};
      },
      c, x + t * S, ec + t * row_size(coarse_grid<3>(g, ld)), b + t * S, vm,
      g, ld, march_post_chunk(g, chunk, false), out + t * S);
}

// The 3-D K15: 1/D recomputed from W at each use, as in K14; the row
// first with RF, each order with its register cap.
template <int NU, typename T, bool RF>
__global__ void __launch_bounds__(kThreads,
                                  march_min_blocks<T>(true, true, RF))
    mg_march_post_var_kernel(const T* __restrict__ x,
                             const T* __restrict__ b,
                             const T* __restrict__ ec,
                             const T* __restrict__ W,
                             const T* __restrict__ omega,
                             const T* __restrict__ invT,
                             const T* __restrict__ invDel,
                             T* __restrict__ out, Grid g,
                             const __grid_constant__ VarTaps vt,
                             const __grid_constant__ PairGroups pm,
                             int chunk) {
  __shared__ T wm[kMaxPairGroups];
  __shared__ int atoff[3 * kMaxVarTaps];
  __shared__ int mtoff[3 * kMaxPairTaps];
  const int64_t t = RF ? blockIdx.x : blockIdx.z;
  const int S = int(row_size(g));
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  if (threadIdx.x < pm.n_groups) wm[threadIdx.x] = T(pm.wm[threadIdx.x]);
  ring_offsets<NU>(vt.n_taps, vt.dz, vt.dy, vt.dx, kMaxVarTaps, atoff);
  ring_offsets<NU>(pm.start[pm.n_groups], pm.dz, pm.dy, pm.dx, kMaxPairTaps,
                   mtoff);
  __syncthreads();
  const Lead ld = serial_lead<3>(g);
  march_fused_post<NU>(
      [&](int r) {
        return VarOp<T>{vt, pm, W, S, c.om, wm, atoff + r * kMaxVarTaps,
                        mtoff + r * kMaxPairTaps};
      },
      c, x + t * S, ec + t * row_size(coarse_grid<3>(g)), b + t * S,
      static_cast<const T*>(nullptr), g, ld,
      march_post_chunk(g, chunk, RF), out + t * S);
}

// The 2-D fused stages march in y, as the 3-D ones march in z, with a row
// of x in place of a plane: the stages of march_fused_pre and
// march_fused_post above, one row a step, each stage a row behind the one
// before, each keeping the three rows the next stage's Op reads (y − 1, y,
// y + 1) in a ring in shared memory: row p in slot p mod 3, the taps'
// offsets resolved once per block for each rotation. A block owns a
// segment of one time row's columns and a chunk of its rows (coarse rows
// for K6, fine rows for K7; `row_pre_chunk`, `row_post_chunk`). The
// segment is the whole row wherever it fits a block's kMarch2Points
// window points (every level of the 2-D solves and slabs, 511 columns the
// widest): then the window is the row and its two ghost columns, zero in
// every ring row from the start and never computed, no point is computed
// twice in x, and in y only a chunk's two ends are. A wider row is cut
// into segments of a multiple of 32 columns (so that a coarse point's fine
// pairs lie in its segment; the last takes the rest of the row) that
// carry an x halo of H, shrinking by a cell a stage as the 3-D tile's
// does. A thread keeps march2_slots points of
// the window row for the whole march (`row_point`: the segment's columns
// in order, so that a warp's loads coalesce, then the halo outward,
// deepest first), their r and x in registers, and applies Op to all of
// them with every tap's values loaded before they are summed
// (`ConstOp::row_many`); b (and in K7 x and e_c) is loaded a row ahead.
// The block takes as many threads as its widest segment needs
// (`row_plan`).
constexpr int kMarch2Points = 1024;  // the most window points a block computes

// A thread's points of the window row, the most threads a block takes and
// the blocks an SM must hold (the register cap), chosen by timing on the
// H100 (PERF.md): 4 points a thread in float32 at 2 blocks (128 registers
// a thread), 2 in float64 at 1 (128 registers; at 2, 64 spilled). K14 and
// K15 take the same: 2 points a thread in float32, or 1 in float64 at 512
// points a block, were slower for them at 511 columns (PERF.md).
template <typename T>
__host__ __device__ constexpr int march2_slots() {
  return sizeof(T) == 4 ? 4 : 2;
}
template <typename T>
__host__ __device__ constexpr int march2_threads() {
  return kMarch2Points / march2_slots<T>();
}
template <typename T>
__host__ __device__ constexpr int march2_min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

// The segments of a row of nx columns for a march with halo H and S points
// a thread: `seg` columns a block (nx: the whole row), `nseg` of them,
// `wrow` window points a row (the ring's row stride) and `threads` a
// block. A cut row's last segment takes the columns left past the others,
// and fewer than H of them join the segment before it: a segment's right
// halo lies in the grid (the joined segment has no right halo, so its
// window still fits wrow).
struct RowPlan {
  int seg, nseg, wrow, threads;
};

__host__ __device__ __forceinline__ RowPlan row_plan(int nx, int H, int S) {
  RowPlan p{nx, 1, nx + 2, 0};
  int points = nx;
  if (nx > kMarch2Points) {
    p.seg = (kMarch2Points - 2 * H) / 32 * 32;
    p.nseg = nx / p.seg + (nx % p.seg >= H ? 1 : 0);
    p.wrow = p.seg + 2 * H;
    points = p.wrow;
  }
  p.threads = ((points + S - 1) / S + 31) / 32 * 32;
  return p;
}

// A block's segment and chunk: the columns [x0, x1) it owns with hl and hr
// frame columns beside them (1, the zero ghost, at the grid's edge, else
// the halo H), the coarse rows [k_lo, k_hi) the pre-stage restricts to
// (none in the post-stage) and the fine rows [f_lo, f_hi) of x it writes.
// blockIdx is (segment, chunk, time row).
struct RowChunk {
  int x0, x1, hl, hr;
  int k_lo, k_hi;
  int f_lo, f_hi;
};

__device__ __forceinline__ RowChunk row_segment(const Grid& g,
                                                const RowPlan& rp, int H) {
  const int x0 = int(blockIdx.x) * rp.seg;
  const int x1 = int(blockIdx.x) + 1 == rp.nseg ? g.nx : x0 + rp.seg;
  return RowChunk{x0, x1, x0 > 0 ? H : 1, x1 < g.nx ? H : 1, 0, 0, 0, 0};
}

// The pre-stage's: chunks of coarse rows, the first from fine row 0, the
// last to ny (as `march_chunk`).
__device__ __forceinline__ RowChunk row_pre_chunk(const Grid& g,
                                                  const Lead& ld, int chunk,
                                                  const RowPlan& rp, int H) {
  RowChunk rc = row_segment(g, rp, H);
  const int c = int(blockIdx.y);
  rc.k_lo = c * chunk;
  rc.k_hi = min(rc.k_lo + chunk, ld.nc);
  rc.f_lo = c == 0 ? 0 : ld.off + 2 * rc.k_lo;
  rc.f_hi = rc.k_lo + chunk >= ld.nc ? g.ny : ld.off + 2 * rc.k_hi;
  return rc;
}

// The post-stage's: the fine rows [c·chunk, (c + 1)·chunk), cut at ny.
__device__ __forceinline__ RowChunk row_post_chunk(const Grid& g, int chunk,
                                                   const RowPlan& rp, int H) {
  RowChunk rc = row_segment(g, rp, H);
  rc.f_lo = int(blockIdx.y) * chunk;
  rc.f_hi = min(rc.f_lo + chunk, g.ny);
  return rc;
}

// Window point q of a block's row: the segment's columns in order, then
// the left halo outward, then the right one (a frame of H columns; H ≥ 2);
// the ghost columns are no thread's. Sets its grid column gx and returns
// its depth: H on the segment, the distance to the window's edge in a
// halo; −1 for q past the points.
template <int H>
__device__ __forceinline__ int row_point(const RowChunk& rc, int q, int& gx) {
  const int n = rc.x1 - rc.x0;
  gx = 0;
  if (q < n) {
    gx = rc.x0 + q;
    return H;
  }
  q -= n;
  if (rc.hl == H) {
    if (q < H) {
      gx = rc.x0 - 1 - q;
      return H - 1 - q;
    }
    q -= H;
  }
  if (rc.hr == H && q < H) {
    gx = rc.x1 + q;
    return H - 1 - q;
  }
  return -1;
}

// Zero the ghost columns (window columns beside the grid's edges) of the
// `rings` rings of a block's row march: they hold the Dirichlet ghost for
// every stage and no thread writes them. Needs a __syncthreads() before
// they are read.
template <typename T>
__device__ __forceinline__ void zero_ghosts(T* ring, int rings, int wrow,
                                            const RowChunk& rc) {
  const int right = rc.x1 - rc.x0 + rc.hl;  // the right ghost's offset
  for (int i = threadIdx.x; i < 3 * rings; i += blockDim.x) {
    if (rc.hl == 1) ring[i * wrow] = T(0);
    if (rc.hr == 1) ring[i * wrow + right] = T(0);
  }
}

// The group ends of a 2-D march's table of weight groups (`row_many`):
// the mask of the taps where a group ends, returned, and weight(g) of each
// group g at its last tap, written to wend (shared memory; needs a
// __syncthreads() before it is read).
template <typename T, typename Weight>
__device__ __forceinline__ unsigned group_ends(const PairGroups& pg,
                                               Weight weight, T* wend) {
  if (threadIdx.x < pg.n_groups) {
    wend[pg.start[threadIdx.x + 1] - 1] = weight(int(threadIdx.x));
  }
  unsigned ends = 0;
  for (int g = 0; g < pg.n_groups; ++g) ends |= 1u << (pg.start[g + 1] - 1);
  return ends;
}

// The same for a pair table, the weights the row's (`group_weight`).
template <typename T>
__device__ __forceinline__ unsigned row_group_ends(const PairGroups& pg,
                                                   T om, T* wend) {
  return group_ends(pg, [&](int g) { return group_weight(pg, g, om); },
                    wend);
}

// The ring offsets of n 2-D taps for each rotation r (the tapped point's
// row in slot r), rows of wrow points: off[r·stride + k].
__device__ __forceinline__ void row_ring_offsets(int n, const int* dy,
                                                 const int* dx, int wrow,
                                                 int stride, int* off) {
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
    const int r = i / n, k = i - r * n;
    off[r * stride + k] = mod3(r + dy[k]) * wrow + dx[k];
  }
}

// The 2-D pre-stage's march of one block (K6's and K14's stages, see
// march_fused_pre): x on its fine rows (xt, the time row) and r_c on its
// coarse rows (rct). op_at(r) is the operator on a
// ring whose centre row lies in slot r; vm the slab's validity field, or
// null. A per-node 1/D (`kPerNode`) is computed once a point, at stage 0
// from the diagonal loaded a row ahead, and carried in registers to the
// row's later stages.
template <int NU, typename T, typename OpAt>
__device__ void march2_fused_pre(const OpAt& op_at, const RowCoef<T>& c,
                                 const T* __restrict__ bt,
                                 const T* __restrict__ vm, const Grid& g,
                                 const Lead& ld, const RowChunk& mc, int wrow,
                                 T* __restrict__ xt, T* __restrict__ rct) {
  constexpr int H = NU + 1, S = march2_slots<T>();
  constexpr bool kCarry = decltype(op_at(0))::kPerNode;
  constexpr int kCentre = 1;  // a column whose taps stay in the window
  T* const ring = window_buffers<T>();  // ring k: 3 rows from ring + 3·wrow·k
  T* const X = ring + 3 * wrow * (NU - 1);
  T* const RS = X + 3 * wrow;
  const int wx0 = mc.x0 - mc.hl;  // the window's first column
  zero_ghosts(ring, NU + 1, wrow, mc);
  // this thread's window points (all inside the grid in x; depth −1 past
  // the window): offset, grid column, depth, and in the residual's region
  // (the segment and one column past)
  int po[S], px[S], depth[S];
  bool inres[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    int gx;
    depth[j] = row_point<H>(mc, int(threadIdx.x + j * blockDim.x), gx);
    po[j] = depth[j] >= 0 ? gx - wx0 : kCentre;
    px[j] = gx;
    inres[j] = depth[j] >= 0 && gx >= mc.x0 && gx <= mc.x1;
  }
  // the segment's coarse columns
  const Grid gc = coarse_grid<2>(g, ld);
  const int cx_lo = mc.x0 / 2, cx_hi = min((mc.x1 + 1) / 2, gc.nx);
  T c1[NU], c2[NU];
  double rho = 1.0 / kSigma;
#pragma unroll
  for (int k = 1; k < NU; ++k) {
    const double rho_new = 1.0 / (2.0 * kSigma - rho);
    c1[k] = T(rho_new * rho);
    c2[k] = T(2.0 * rho_new) * c.iDel;
    rho = rho_new;
  }
  // the rows of each stage: the residual's r_lo … r_hi − 1; x on [x_lo,
  // x_hi) (its own rows and those the residual reads); stage k on that
  // grown by ν − 1 − k rows
  const int r_lo = ld.off + 2 * mc.k_lo, r_hi = ld.off + 2 * mc.k_hi + 1;
  const int x_lo = min(mc.f_lo, r_lo - 1), x_hi = max(mc.f_hi, r_hi + 1);
  // r, x (and a per-node 1/D) of stages 0 … ν−2, last row
  T rr[NU - 1][S], xr[NU - 1][S], ir[NU - 1][S];
  // b and the diagonal's entry (`diag_at`) of stage 0's row, b of the
  // residual's: loaded a step ahead
  const auto op0 = op_at(0);
  T b0[S], d0[S], br[S];
  auto load = [&](int p0, T (&b)[S], T (&d)[S], T (&bres)[S]) {
    const bool yin = p0 >= 0 && p0 < g.ny;
    const int pr = p0 - NU;
    const bool rin = pr >= r_lo && pr < r_hi;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int gi = p0 * g.nx + px[j];
      b[j] = yin && depth[j] >= 0 ? bt[gi] : T(0);
      d[j] = yin && depth[j] >= 0 ? op0.diag_at(gi) : T(0);
      bres[j] = rin && inres[j] ? bt[pr * g.nx + px[j]] : T(0);
    }
  };
  load(x_lo - (NU - 1), b0, d0, br);
  for (int t = x_lo - (NU - 1); t < x_hi + NU - 1; ++t) {
    T rn[NU - 1][S], xn[NU - 1][S], idn[NU - 1][S];
    T b0n[S], d0n[S], brn[S];
    load(t + 1, b0n, d0n, brn);
    auto stage = [&](auto K) {
      constexpr int k = decltype(K)::value;
      const int p = t - k;
      if (p < x_lo - (NU - 1 - k)) return;
      const int rot = mod3(p);
      const bool yin = p >= 0 && p < g.ny;
      const auto op = op_at(rot);
      const T* const din = ring + 3 * wrow * (k > 0 ? k - 1 : 0);
      T* const out = (k < NU - 1 ? ring + 3 * wrow * k : X) + rot * wrow;
      // Op d at this stage's points inside the grid (the others read at a
      // column whose taps stay in the window)
      int oo[S], gg[S];
      T opd[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const bool in = yin && depth[j] >= k;
        oo[j] = in ? po[j] : kCentre;
        gg[j] = in ? p * g.nx + px[j] : 0;
      }
      if constexpr (k > 0) op.row_many(din, oo, gg, opd);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (depth[j] < k) continue;
        const int gi = gg[j];
        T r = T(0), d = T(0), x = T(0), id = T(0);
        if (yin) {
          if constexpr (k == 0) {
            id = op.inv_diag_of(d0[j]);
            r = valid_at(vm, gi) * (id * b0[j]);
            d = r * c.iT;
            x = d;
          } else {
            id = kCarry ? ir[k - 1][j] : op.inv_diag(po[j], gi);
            r = valid_at(vm, gi) * (rr[k - 1][j] - id * opd[j]);
            d = c1[k] * din[rot * wrow + po[j]] + c2[k] * r;
            x = xr[k - 1][j] + d;
          }
        }
        if constexpr (k < NU - 1) {
          out[po[j]] = d;
          rn[k][j] = r;
          xn[k][j] = x;
          if constexpr (kCarry) idn[k][j] = id;
        } else {
          out[po[j]] = x;
          if (yin && depth[j] >= H && p >= mc.f_lo && p < mc.f_hi) {
            xt[gi] = x;
          }
        }
      }
    };
    stage(Int<0>{});
    __syncthreads();
    stage(Int<1>{});
    __syncthreads();
    if constexpr (NU > 2) {
      stage(Int<2>{});
      __syncthreads();
    }
    const int p = t - NU;
    if (p >= r_lo && p < r_hi) {
      const int rot = mod3(p);
      int oo[S], gg[S];
      T opx[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        oo[j] = inres[j] ? po[j] : kCentre;
        gg[j] = inres[j] ? p * g.nx + px[j] : 0;
      }
      op_at(rot).row_many(X, oo, gg, opx);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (inres[j]) RS[rot * wrow + po[j]] = br[j] - opx[j];
      }
      __syncthreads();
      if (((p - ld.off) & 1) == 0 && p >= r_lo + 2) {
        const int kc = (p - ld.off) / 2 - 1;
        const int fy = p - 2, s0 = mod3(fy);
        for (int cx = cx_lo + int(threadIdx.x); cx < cx_hi;
             cx += int(blockDim.x)) {
          rct[kc * gc.nx + cx] = restrict_at<2, T>(
              Point{0, 0, kc, cx}, ld, [&](int, int y, int x) {
                const int s = s0 + y - fy;
                return RS[(s < 3 ? s : s - 3) * wrow + (x - wx0)];
              });
        }
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int k = 0; k < NU - 1; ++k) {
        rr[k][j] = rn[k][j];
        xr[k][j] = xn[k][j];
        if constexpr (kCarry) ir[k][j] = idn[k][j];
      }
      b0[j] = b0n[j];
      d0[j] = d0n[j];
      br[j] = brn[j];
    }
  }
}

// The 2-D post-stage's march of one block (K7's and K15's stages, see
// march_fused_post): x on its fine rows [mc.f_lo, mc.f_hi) of the time
// row (ot), from x (xt), b (bt) and e_c (et, the
// coarse row of the transfers ld, read with K9's `prolong_at`
// arithmetic). op_at as in march2_fused_pre, a per-node 1/D computed at
// stage 1 and carried to the row's later stages; vm the slab's validity
// field, or null.
template <int NU, typename T, typename OpAt>
__device__ void march2_fused_post(const OpAt& op_at, const RowCoef<T>& c,
                                  const T* __restrict__ xt,
                                  const T* __restrict__ et,
                                  const T* __restrict__ bt,
                                  const T* __restrict__ vm, const Grid& g,
                                  const Lead& ld, const RowChunk& mc,
                                  int wrow, T* __restrict__ ot) {
  constexpr int H = NU, S = march2_slots<T>();
  constexpr bool kCarry = decltype(op_at(0))::kPerNode;
  constexpr int kCentre = 1;  // a column whose taps stay in the window
  T* const ring = window_buffers<T>();  // ring k: 3 rows from ring + 3·wrow·k
  const Grid gc = coarse_grid<2>(g, ld);
  const int wx0 = mc.x0 - mc.hl;
  zero_ghosts(ring, NU, wrow, mc);
  // this thread's window points (all inside the grid in x; depth −1 past
  // the window): offset, grid column, depth, and the columns of the two
  // coarse points P e_c reads there (−1 beyond the coarse grid)
  int po[S], px[S], depth[S], pc0[S], pc1[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    int gx;
    depth[j] = row_point<H>(mc, int(threadIdx.x + j * blockDim.x), gx);
    po[j] = depth[j] >= 0 ? gx - wx0 : kCentre;
    px[j] = gx;
    const int cx0 = gx >> 1, cx1 = (gx - 1) >> 1;
    pc0[j] = cx0 >= 0 && cx0 < gc.nx ? cx0 : -1;
    pc1[j] = cx1 >= 0 && cx1 < gc.nx ? cx1 : -1;
  }
  T c1[NU], c2[NU];
  double rho = 1.0 / kSigma;
#pragma unroll
  for (int k = 1; k < NU; ++k) {
    const double rho_new = 1.0 / (2.0 * kSigma - rho);
    c1[k] = T(rho_new * rho);
    c2[k] = T(2.0 * rho_new) * c.iDel;
    rho = rho_new;
  }
  // stage 0's x and coarse values, and stage 1's b and diagonal entry
  // (`diag_at`): each loaded once its stage has used the last ones, a step
  // before it needs them
  const auto op0 = op_at(0);
  T xv[S], e0[S], e1[S], bv[S], dv[S];
  auto load0 = [&](int p) {
    const bool yin = p >= 0 && p < g.ny;
    const int y0 = (p + ld.s) >> 1, y1 = (p + ld.s - 1) >> 1;
    const bool in0 = y0 >= 0 && y0 < gc.ny, in1 = y1 >= 0 && y1 < gc.ny;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool in = yin && depth[j] >= 0;
      xv[j] = in ? xt[p * g.nx + px[j]] : T(0);
      e0[j] = in && in0 && pc0[j] >= 0 ? et[y0 * gc.nx + pc0[j]] : T(0);
      e1[j] = in && in1 && pc1[j] >= 0 ? et[y1 * gc.nx + pc1[j]] : T(0);
    }
  };
  auto load1 = [&](int p) {
    const bool yin = p >= 0 && p < g.ny;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool in = yin && depth[j] >= 1;
      bv[j] = in ? bt[p * g.nx + px[j]] : T(0);
      dv[j] = in ? op0.diag_at(p * g.nx + px[j]) : T(0);
    }
  };
  // r, x (and a per-node 1/D) of stages 1 … ν−1, last row
  T rr[NU - 1][S], xr[NU - 1][S], ir[NU - 1][S];
  const int t0 = mc.f_lo - NU;
  load0(t0);
  load1(t0 - 1);
  for (int t = t0; t < mc.f_hi + NU; ++t) {
    {  // stage 0: X₀ = x + P e_c on window row t, 0 outside the grid
      const bool yin = t >= 0 && t < g.ny;
      T* const out = ring + mod3(t) * wrow;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (depth[j] >= 0) {
          out[po[j]] =
              yin ? xv[j] + T(0.5) * (e0[j] + e1[j]) : T(0);
        }
      }
    }
    load0(t + 1);
    __syncthreads();
    T rn[NU - 1][S], xn[NU - 1][S], idn[NU - 1][S];
    auto stage = [&](auto K) {
      constexpr int k = decltype(K)::value;
      const int p = t - k;
      if (p < mc.f_lo - (NU - k)) return;
      const int rot = mod3(p);
      const bool yin = p >= 0 && p < g.ny;
      const auto op = op_at(rot);
      const T* const din = ring + 3 * wrow * (k - 1);  // X₀, then d_{k−1}
      // Op at this stage's points inside the grid (the others read at a
      // column whose taps stay in the window)
      int oo[S], gg[S];
      T opd[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const bool in = yin && depth[j] >= k;
        oo[j] = in ? po[j] : kCentre;
        gg[j] = in ? p * g.nx + px[j] : 0;
      }
      op.row_many(din, oo, gg, opd);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (depth[j] < k) continue;
        const int gi = gg[j];
        T r = T(0), d = T(0), x = T(0), id = T(0);
        if (yin) {
          if constexpr (k == 1) {
            id = op.inv_diag_of(dv[j]);
            r = valid_at(vm, gi) * (id * (bv[j] - opd[j]));
            d = r * c.iT;
            x = din[rot * wrow + po[j]] + d;
          } else {
            id = kCarry ? ir[k - 2][j] : op.inv_diag(po[j], gi);
            r = valid_at(vm, gi) * (rr[k - 2][j] - id * opd[j]);
            d = c1[k - 1] * din[rot * wrow + po[j]] + c2[k - 1] * r;
            x = xr[k - 2][j] + d;
          }
        }
        if constexpr (k < NU) {
          ring[3 * wrow * k + rot * wrow + po[j]] = d;
          rn[k - 1][j] = r;
          xn[k - 1][j] = x;
          if constexpr (kCarry) idn[k - 1][j] = id;
        } else if (yin && depth[j] >= H && p >= mc.f_lo && p < mc.f_hi) {
          ot[gi] = x;
        }
      }
    };
    stage(Int<1>{});
    load1(t);
    __syncthreads();
    stage(Int<2>{});
    if constexpr (NU > 2) {
      __syncthreads();
      stage(Int<3>{});
    }
#pragma unroll
    for (int k = 0; k < NU - 1; ++k) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        rr[k][j] = rn[k][j];
        xr[k][j] = xn[k][j];
        if constexpr (kCarry) ir[k][j] = idn[k][j];
      }
    }
  }
}

// The 2-D K6 (ld serial, vm null) and its sharded-slab form.
template <int NU, typename T>
__global__ void __launch_bounds__(march2_threads<T>(),
                                  march2_min_blocks<T>())
    mg_march2_pre_kernel(const T* __restrict__ b, const T* __restrict__ vm,
                         const T* __restrict__ omega,
                         const T* __restrict__ invD,
                         const T* __restrict__ invT,
                         const T* __restrict__ invDel, T* __restrict__ xo,
                         T* __restrict__ rco, Grid g,
                         const __grid_constant__ PairGroups pg, Lead ld,
                         int chunk, RowPlan rp) {
  __shared__ T wend[kRowTaps];
  __shared__ int toff[3 * kMaxPairTaps];
  const int64_t t = blockIdx.z;
  const int64_t S = row_size(g);
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  const unsigned ends = row_group_ends(pg, c.om, wend);
  row_ring_offsets(pg.start[pg.n_groups], pg.dy, pg.dx, rp.wrow,
                   kMaxPairTaps, toff);
  __syncthreads();
  const T iD = invD[t];
  march2_fused_pre<NU>(
      [&](int r) {
        return ConstOp<T>{pg, nullptr, toff + r * kMaxPairTaps, iD, ends,
                          wend};
      },
      c, b + t * S, vm, g, ld, row_pre_chunk(g, ld, chunk, rp, NU + 1),
      rp.wrow, xo + t * S, rco + t * row_size(coarse_grid<2>(g, ld)));
}

// The 2-D K7 (ld serial, vm null) and its sharded-slab form.
template <int NU, typename T>
__global__ void __launch_bounds__(march2_threads<T>(),
                                  march2_min_blocks<T>())
    mg_march2_post_kernel(const T* __restrict__ x, const T* __restrict__ b,
                          const T* __restrict__ ec, const T* __restrict__ vm,
                          const T* __restrict__ omega,
                          const T* __restrict__ invD,
                          const T* __restrict__ invT,
                          const T* __restrict__ invDel, T* __restrict__ out,
                          Grid g, const __grid_constant__ PairGroups pg,
                          Lead ld, int chunk, RowPlan rp) {
  __shared__ T wend[kRowTaps];
  __shared__ int toff[3 * kMaxPairTaps];
  const int64_t t = blockIdx.z;
  const int64_t S = row_size(g);
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  const unsigned ends = row_group_ends(pg, c.om, wend);
  row_ring_offsets(pg.start[pg.n_groups], pg.dy, pg.dx, rp.wrow,
                   kMaxPairTaps, toff);
  __syncthreads();
  const T iD = invD[t];
  march2_fused_post<NU>(
      [&](int r) {
        return ConstOp<T>{pg, nullptr, toff + r * kMaxPairTaps, iD, ends,
                          wend};
      },
      c, x + t * S, ec + t * row_size(coarse_grid<2>(g, ld)), b + t * S, vm,
      g, ld, row_post_chunk(g, chunk, rp, NU), rp.wrow, out + t * S);
}

// The weighted 2-D marches' tables in shared memory (K14, K15): the mass
// groups' weights at their last taps, the A and M taps' ring offsets per
// rotation.
template <typename T>
struct Var2Tables {
  T mwend[kRowTaps];
  int atoff[3 * kMaxVarTaps];
  int mtoff[3 * kMaxPairTaps];
};

// Fills tb for rows of wrow points and returns the mass's group-end mask.
// Ends with a __syncthreads().
template <typename T>
__device__ __forceinline__ unsigned var2_tables(const VarTaps& vt,
                                                const PairGroups& pm,
                                                int wrow, Var2Tables<T>& tb) {
  const unsigned mends =
      group_ends(pm, [&](int g) { return T(pm.wm[g]); }, tb.mwend);
  row_ring_offsets(vt.n_taps, vt.dy, vt.dx, wrow, kMaxVarTaps, tb.atoff);
  row_ring_offsets(pm.start[pm.n_groups], pm.dy, pm.dx, wrow, kMaxPairTaps,
                   tb.mtoff);
  __syncthreads();
  return mends;
}

// The 2-D K14: K6's march with Op_w (`VarOp::row_many`), 1/D from W[kc]
// read a row ahead and carried through the row's stages; the time row is
// the slowest block index (see the header).
template <int NU, typename T>
__global__ void __launch_bounds__(march2_threads<T>(),
                                  march2_min_blocks<T>())
    mg_march2_pre_var_kernel(const T* __restrict__ b,
                             const T* __restrict__ W,
                             const T* __restrict__ omega,
                             const T* __restrict__ invT,
                             const T* __restrict__ invDel,
                             T* __restrict__ xo, T* __restrict__ rco, Grid g,
                             const __grid_constant__ VarTaps vt,
                             const __grid_constant__ PairGroups pm,
                             int chunk, RowPlan rp) {
  __shared__ Var2Tables<T> tb;
  const int64_t t = blockIdx.z;
  const int S = int(row_size(g));
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  const unsigned mends = var2_tables(vt, pm, rp.wrow, tb);
  const Lead ld = serial_lead<2>(g);
  march2_fused_pre<NU>(
      [&](int r) {
        return VarOp<T>{vt, pm, W, S, c.om, nullptr,
                        tb.atoff + r * kMaxVarTaps,
                        tb.mtoff + r * kMaxPairTaps, mends, tb.mwend};
      },
      c, b + t * S, static_cast<const T*>(nullptr), g, ld,
      row_pre_chunk(g, ld, chunk, rp, NU + 1), rp.wrow, xo + t * S,
      rco + t * row_size(coarse_grid<2>(g)));
}

// The 2-D K15: K7's march with Op_w, as K14.
template <int NU, typename T>
__global__ void __launch_bounds__(march2_threads<T>(),
                                  march2_min_blocks<T>())
    mg_march2_post_var_kernel(const T* __restrict__ x,
                              const T* __restrict__ b,
                              const T* __restrict__ ec,
                              const T* __restrict__ W,
                              const T* __restrict__ omega,
                              const T* __restrict__ invT,
                              const T* __restrict__ invDel,
                              T* __restrict__ out, Grid g,
                              const __grid_constant__ VarTaps vt,
                              const __grid_constant__ PairGroups pm,
                              int chunk, RowPlan rp) {
  __shared__ Var2Tables<T> tb;
  const int64_t t = blockIdx.z;
  const int S = int(row_size(g));
  const RowCoef<T> c = row_coef(omega, invT, invDel, t);
  const unsigned mends = var2_tables(vt, pm, rp.wrow, tb);
  const Lead ld = serial_lead<2>(g);
  march2_fused_post<NU>(
      [&](int r) {
        return VarOp<T>{vt, pm, W, S, c.om, nullptr,
                        tb.atoff + r * kMaxVarTaps,
                        tb.mtoff + r * kMaxPairTaps, mends, tb.mwend};
      },
      c, x + t * S, ec + t * row_size(coarse_grid<2>(g)), b + t * S,
      static_cast<const T*>(nullptr), g, ld, row_post_chunk(g, chunk, rp, NU),
      rp.wrow, out + t * S);
}

// K4 and K5 march along the leading grid axis (y in 2-D, z in 3-D; see
// the header): a ring of kStencilRing window planes (rows) of x in shared
// memory, the plane two ahead written while the step reads the three
// around its own, one barrier a step. (Copies by cp.async into deeper
// rings of x and b were slower on the H100: PERF.md.)
constexpr int kStencilRing = 4;
// The 3-D window plane: the 16 × 32 tile with a frame of one.
constexpr int kStencilWX = kMarchX + 2;
constexpr int kStencilPlane = (kMarchY + 2) * kStencilWX;

// A thread's tile points (a row's in 2-D) and window points it loads, the
// most threads a block takes, the blocks an SM must hold (the register
// cap) and the steps ahead its loads are issued, chosen by timing on the
// H100 (PERF.md): 2-D as the 2-D marches, 4 points a thread in float32 and
// 2 in float64, at least 3 blocks an SM in float32, 1 (K4) and 2 (K5) in
// float64, loads two steps ahead but the float64 K4's one; 3-D kThreads
// threads, two tile points and three window points a thread, 4 blocks an
// SM in float32 and 2 in float64, loads one step ahead.
template <int DIM, typename T>
__host__ __device__ constexpr int stencil_slots() {
  return DIM == 2 ? march2_slots<T>() : kMarchY * kMarchX / kThreads;
}
template <int DIM, typename T>
__host__ __device__ constexpr int stencil_loads() {
  return DIM == 2 ? march2_slots<T>()
                  : (kStencilPlane + kThreads - 1) / kThreads;
}
template <int DIM, typename T>
__host__ __device__ constexpr int stencil_threads() {
  return DIM == 2 ? march2_threads<T>() : kThreads;
}
template <int DIM, typename T, bool RES>
__host__ __device__ constexpr int stencil_min_blocks() {
  return sizeof(T) == 4 ? (DIM == 2 ? 3 : 4) : (DIM == 2 && RES ? 1 : 2);
}
template <int DIM, typename T, bool RES>
__host__ __device__ constexpr int stencil_ahead() {
  return DIM == 2 && (sizeof(T) == 4 || !RES) ? 2 : 1;
}

// A launch of K4 or K5 on grid g: `tiles` blocks a chunk of the leading
// axis (2-D: the segments of a row, `row_plan` with a halo of 1; 3-D: the
// 16 × 32 tiles of a plane), threads a block, window points a ring plane.
struct StencilPlan {
  int tiles, threads, plane;
};

template <int DIM, typename T>
__host__ __device__ __forceinline__ StencilPlan stencil_plan(const Grid& g) {
  if constexpr (DIM == 2) {
    const RowPlan rp = row_plan(g.nx, 1, stencil_slots<2, T>());
    return StencilPlan{rp.nseg, rp.threads, rp.wrow};
  } else {
    return StencilPlan{((g.ny + kMarchY - 1) / kMarchY) *
                           ((g.nx + kMarchX - 1) / kMarchX),
                       kThreads, kStencilPlane};
  }
}

// K4 (RES: out = b − Op x, Op = A + ω⊙M of the pair table) and K5 (out =
// A x, the table of A alone, every wM = 0) on a block's segment (2-D) or
// tile (3-D) of time row blockIdx.z, planes [c·chunk, (c + 1)·chunk) of
// the leading axis, c = blockIdx.y. Sums as `op_global`: the ring holds 0
// at the zero ghost, and adding it to a tap sum changes no value.
template <int DIM, typename T, bool RES>
__global__ void __launch_bounds__(stencil_threads<DIM, T>(),
                                  stencil_min_blocks<DIM, T, RES>())
    mg_stencil_kernel(const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ omega, T* __restrict__ out,
                      Grid g, const __grid_constant__ PairGroups pg,
                      int chunk) {
  constexpr int L = stencil_loads<DIM, T>(), N = stencil_slots<DIM, T>();
  constexpr int K = DIM == 2 ? kRowTaps : kCubeTaps;
  __shared__ T wend[kMaxPairTaps];
  __shared__ int toff[kStencilRing * kMaxPairTaps];
  T* const ring = window_buffers<T>();  // slot s: ring + s·P
  const int64_t t = blockIdx.z;
  const int64_t S = row_size(g);
  const int P = stencil_plan<DIM, T>(g).plane;
  const int n = DIM == 3 ? g.nz : g.ny;  // the planes (rows) the march cuts
  const int plane = DIM == 3 ? g.ny * g.nx : g.nx;
  const unsigned ends = row_group_ends(pg, RES ? omega[t] : T(0), wend);
  // each tap's offset in the ring for each rotation r (the tapped point's
  // plane in slot r)
  const int ntaps = pg.start[pg.n_groups];
  for (int i = threadIdx.x; i < kStencilRing * ntaps; i += blockDim.x) {
    const int r = i / ntaps, k = i - r * ntaps;
    const int lead = DIM == 3 ? pg.dz[k] : pg.dy[k];
    const int in_plane =
        DIM == 3 ? pg.dy[k] * kStencilWX + pg.dx[k] : pg.dx[k];
    toff[r * kMaxPairTaps + k] =
        ((r + lead) & (kStencilRing - 1)) * P + in_plane;
  }
  // this thread's window points of x, loaded in every plane: offset in the
  // plane (−1: none) and in-plane grid index; and its output points: the
  // offset (one whose taps stay in the window where it has none), the
  // in-plane grid index and whether it lies in the grid
  int lo[L], li[L], co[N], ci[N];
  bool cin[N];
  if constexpr (DIM == 2) {
    // the segment's columns [x0, x1) at window columns 1 … n, then the
    // halo columns past a cut (window 0 and n + 1); the ghost columns of
    // the grid's edges hold 0 in every slot and are no thread's
    const RowPlan rp = row_plan(g.nx, 1, N);
    const int x0 = int(blockIdx.x) * rp.seg;
    const int x1 = int(blockIdx.x) + 1 == rp.nseg ? g.nx : x0 + rp.seg;
    const int w = x1 - x0;
    const bool hl = x0 > 0, hr = x1 < g.nx;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int q = int(threadIdx.x) + j * int(blockDim.x);
      lo[j] = -1;
      li[j] = 0;
      if (q < w) {
        lo[j] = q + 1;
        li[j] = x0 + q;
      } else if (hl && q == w) {
        lo[j] = 0;
        li[j] = x0 - 1;
      } else if (hr && q == w + int(hl)) {
        lo[j] = w + 1;
        li[j] = x1;
      }
      cin[j] = q < w;
      co[j] = cin[j] ? q + 1 : 1;
      ci[j] = li[j];
    }
    for (int s = threadIdx.x; s < kStencilRing; s += blockDim.x) {
      if (!hl) ring[s * P] = T(0);
      if (!hr) ring[s * P + w + 1] = T(0);
    }
  } else {
    // the tile (y0, x0); window point q at (q / WX − 1, q % WX − 1) from
    // it, tile point q at (q / 32, q % 32): a warp on one row of 32. The
    // window points outside the grid in y and x hold 0 in every slot.
    const int ntx = (g.nx + kMarchX - 1) / kMarchX;
    const int ty = int(blockIdx.x) / ntx;
    const int y0 = ty * kMarchY, x0 = (int(blockIdx.x) - ty * ntx) * kMarchX;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = int(threadIdx.x) + j * kThreads;
      const int wy = q / kStencilWX, wx = q - wy * kStencilWX;
      const int gy = y0 - 1 + wy, gx = x0 - 1 + wx;
      const bool in = q < P && gy >= 0 && gy < g.ny && gx >= 0 && gx < g.nx;
      lo[j] = in ? q : -1;
      li[j] = gy * g.nx + gx;
      if (q < P && !in) {
#pragma unroll
        for (int s = 0; s < kStencilRing; ++s) ring[s * P + q] = T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int q = int(threadIdx.x) + j * kThreads;
      const int ly = q / kMarchX, lx = q - ly * kMarchX;
      co[j] = (ly + 1) * kStencilWX + lx + 1;
      ci[j] = (y0 + ly) * g.nx + x0 + lx;
      cin[j] = y0 + ly < g.ny && x0 + lx < g.nx;
    }
  }
  const int f_lo = int(blockIdx.y) * chunk, f_hi = min(f_lo + chunk, n);
  const T* const xt = x + t * S;
  const T* const bt = RES ? b + t * S : nullptr;
  T* const ot = out + t * S;
  // x of plane p (0 off the grid and past the chunk's last tapped plane)
  auto load = [&](int p, T (&v)[L]) {
    const bool in = p >= 0 && p < n && p <= f_hi;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      v[j] = in && lo[j] >= 0 ? xt[p * plane + li[j]] : T(0);
    }
  };
  auto put = [&](int p, const T (&v)[L]) {
    T* const s = ring + (p & (kStencilRing - 1)) * P;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (lo[j] >= 0) s[lo[j]] = v[j];
    }
  };
  auto load_b = [&](int p, T (&v)[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = RES && p < f_hi && cin[j] ? bt[p * plane + ci[j]] : T(0);
    }
  };
  // x's planes D ahead of the ring and b's D ahead of the step, in D sets
  // of registers: a step's loads consumed D steps later
  constexpr int D = stencil_ahead<DIM, T, RES>();
  T xs[D][L], bs[D][N];
  for (int p = f_lo - 1; p <= f_lo + 1; ++p) {
    load(p, xs[0]);
    put(p, xs[0]);
  }
#pragma unroll
  for (int u = 0; u < D; ++u) {
    load(f_lo + 2 + u, xs[u]);
    load_b(f_lo + u, bs[u]);
  }
  __syncthreads();
  // step p: x's plane p + 2 from xv into slot (p − 2) mod 4, last read a
  // step before; the loads of x's plane p + 2 + D into xv and of b's p + D;
  // out's plane p; b's p + D into bv
  auto step = [&](int p, T (&xv)[L], T (&bv)[N]) {
    put(p + 2, xv);
    load(p + 2 + D, xv);
    T bn[N], opx[N];
    load_b(p + D, bn);
    const ConstOp<T> op{pg, nullptr,
                        toff + (p & (kStencilRing - 1)) * kMaxPairTaps, T(0),
                        ends, wend};
    op.template row_many<N, K>(ring, co, ci, opx);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (cin[j]) ot[p * plane + ci[j]] = RES ? bv[j] - opx[j] : opx[j];
      bv[j] = bn[j];
    }
    __syncthreads();
  };
  for (int p = f_lo; p < f_hi; p += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (p + u < f_hi) step(p + u, xs[u], bs[u]);
    }
  }
}

// A_w x at grid point (z, y, x) of one row X in device memory (zero outside
// the grid): the taps in weight-array order.
template <int DIM, typename T>
__device__ __forceinline__ T var_apply_global(const VarTaps& vt,
                                              const T* __restrict__ W,
                                              const T* __restrict__ X,
                                              const Grid& g, int z, int y,
                                              int x) {
  const int S = int(row_size(g));
  const int p = (z * g.ny + y) * g.nx + x;
  T a = T(0);
  for (int k = 0; k < vt.n_taps; ++k) {
    const int zz = DIM == 3 ? z + vt.dz[k] : 0;
    const int yy = y + vt.dy[k];
    const int xx = x + vt.dx[k];
    if (in_grid<DIM>(g, zz, yy, xx)) {
      a += __ldg(W + int64_t(k) * S + p) * X[(zz * g.ny + yy) * g.nx + xx];
    }
  }
  return a;
}

// M x at grid point (z, y, x) of one row X in device memory (zero outside
// the grid): the mass's weight groups, each tap sum times its weight.
template <int DIM, typename T>
__device__ __forceinline__ T mass_global(const PairGroups& pm,
                                         const T* __restrict__ X,
                                         const Grid& g, int z, int y, int x) {
  T m = T(0);
  for (int gi = 0; gi < pm.n_groups; ++gi) {
    T acc = T(0);
    for (int k = pm.start[gi]; k < pm.start[gi + 1]; ++k) {
      const int zz = DIM == 3 ? z + pm.dz[k] : 0;
      const int yy = y + pm.dy[k];
      const int xx = x + pm.dx[k];
      if (in_grid<DIM>(g, zz, yy, xx)) acc += X[(zz * g.ny + yy) * g.nx + xx];
    }
    m += T(pm.wm[gi]) * acc;
  }
  return m;
}

// Op_w x = A_w x + ω·M x at grid point (z, y, x) of one row X.
template <int DIM, typename T>
__device__ __forceinline__ T var_op_global(const VarTaps& vt,
                                           const PairGroups& pm,
                                           const T* __restrict__ W, T om,
                                           const T* __restrict__ X,
                                           const Grid& g, int z, int y,
                                           int x) {
  const T a = var_apply_global<DIM>(vt, W, X, g, z, y, x);
  return a + om * mass_global<DIM>(pm, X, g, z, y, x);
}

// K10, K11 and K12 march in time (`mg_var_stencil_kernel`, see the
// header). A block owns a spatial tile and its window, the tile grown by
// one on every side: in 2-D var_pencil rows of y by a segment of the row
// (the whole row up to var_seg columns, wider rows in balanced segments),
// in 3-D var_pencil planes of z by a kVarTileY × kVarTileX (y, x) tile.
constexpr int kVarTileY = 8, kVarTileX = 32;

// What a launch of the march computes (`MODE`): K12 (A_w x), K11 (b −
// Op_w x), and the steps of K10's sweep: the first from x, the first from
// x = 0 (no Op), a later one (Op_w applied to d), and the first two from
// x = 0 in one launch (ν ≥ 2: the window holds the first step's d =
// D⁻¹b/θ, made from b as it is stored).
enum VarMode {
  kVarApply = 0,
  kVarResidual = 1,
  kVarFirst = 2,
  kVarFirstZero = 3,
  kVarStep = 4,
  kVarFirstTwo = 5
};

// The plan of each kernel, by timing on the H100 (PERF.md §6,
// `tools.var_tune`): the widest 2-D segment (K11 and K10 254 columns,
// K12 574), the points a block owns along the pencil axis (y in 2-D, z in
// 3-D) and the blocks an SM must hold (the register cap). K11 holds b and
// the mass's sums beside the weights, and ran fastest on narrow segments
// at three or more blocks an SM: in 2-D 4 rows in float32, 2 in float64.
// K10's steps take K11's tiles; they hold a point's 1/D and a second own
// field (x_out) beside b or r, and take two blocks an SM in 2-D. K12 ran
// fastest on whole rows: 4 rows at two blocks an SM (float64 one). In
// 3-D all take 2 planes at two blocks (the shared tile of 15 weights a
// point and x's buffers: 41.6 KB in float32, 83.2 KB in float64).
template <int MODE>
__host__ __device__ constexpr int var_seg() {
  return MODE == kVarApply ? 574 : 254;
}
template <int DIM, typename T, int MODE>
__host__ __device__ constexpr int var_pencil() {
  return DIM == 3 || (MODE != kVarApply && sizeof(T) == 8) ? 2 : 4;
}
constexpr int kVarStepBlocks = 2;  // K10's steps in 2-D
template <int DIM, typename T, int MODE>
__host__ __device__ constexpr int var_min_blocks() {
  if (DIM == 3) return 2;
  if (MODE == kVarApply) return sizeof(T) == 4 ? 2 : 1;
  return MODE == kVarResidual ? 3 : kVarStepBlocks;
}
// The window's stride along the pencil, a constant, so that a column's
// points lie at immediate offsets: the widest 2-D window row, the 3-D
// window plane.
template <int DIM, int MODE>
__host__ __device__ constexpr int var_stride() {
  return DIM == 2 ? var_seg<MODE>() + 2 : (kVarTileY + 2) * (kVarTileX + 2);
}
// The threads a block takes at most: one per window column.
template <int DIM, int MODE>
__host__ __device__ constexpr int var_max_threads() {
  return (var_stride<DIM, MODE>() + 31) / 32 * 32;
}
// The most A taps (and mass taps) of a table the march takes: the ±1
// neighbourhood in 2-D, the 15 of the Kuhn simplices' stencils in 3-D
// (kCubeTaps).
template <int DIM>
__host__ __device__ constexpr int var_taps() {
  return DIM == 2 ? kRowTaps : kCubeTaps;
}

// A launch of the march on grid g: the owned plane tile ix × iy (2-D: a
// segment, iy = 1) and its window's row stride wx and plane points wyx;
// xt × yt plane tiles (2-D: the segments), the pencil axis of np points at
// stride pstride cut into pt pencils; threads a block.
struct VarPlan {
  int ix, iy, wx, wyx, xt, yt, np, pstride, pt, threads;
};

template <int DIM, typename T, int MODE>
__host__ __device__ __forceinline__ VarPlan var_plan(const Grid& g) {
  constexpr int P = var_pencil<DIM, T, MODE>();
  VarPlan p{};
  if constexpr (DIM == 2) {
    p.xt = (g.nx + var_seg<MODE>() - 1) / var_seg<MODE>();
    p.ix = (g.nx + p.xt - 1) / p.xt;  // balanced; the last takes the rest
    p.iy = 1;
    p.wx = p.ix + 2;
    p.wyx = p.wx;
    p.yt = 1;
    p.np = g.ny;
    p.pstride = g.nx;
  } else {
    p.ix = kVarTileX;
    p.iy = kVarTileY;
    p.wx = kVarTileX + 2;
    p.wyx = (kVarTileY + 2) * p.wx;
    p.xt = (g.nx + kVarTileX - 1) / kVarTileX;
    p.yt = (g.ny + kVarTileY - 1) / kVarTileY;
    p.np = g.nz;
    p.pstride = g.ny * g.nx;
  }
  p.pt = (p.np + P - 1) / P;
  p.threads = (p.wyx + 31) / 32 * 32;
  return p;
}

// A thread's two roles (csrc/kron.cu `Col`). As a loader, its window
// column: `load` whether it lies in the grid, gbase its in-row index at
// pencil point 0, [klo, khi) the window's pencil points in the grid
// (window point k is pencil point p0 − 1 + k, p0 the block's first owned
// one). As a computer (threads t < iy·ix, a 3-D warp on one row of x),
// the tile's column t: `own` whether it lies in the grid, oc its window
// plane position, obase its in-row index at pencil point p0, and kown its
// owned points in the grid (window points 1 … kown).
struct VarCol {
  int t, gbase, p0, klo, khi, kown, oc, obase;
  bool load, own;
};

template <int DIM>
__device__ __forceinline__ VarCol var_column(const Grid& g, const VarPlan& pl,
                                             int P) {
  VarCol c{};
  c.t = int(threadIdx.x);
  int py = 0, px = c.t, gy = 0, x0 = 0, y0 = 0, ylim = 1;
  if (DIM == 3) {
    const int bx = int(blockIdx.x) % pl.xt, by = int(blockIdx.x) / pl.xt;
    py = c.t / pl.wx;
    px = c.t - py * pl.wx;
    x0 = bx * kVarTileX;
    y0 = by * kVarTileY;
    gy = y0 - 1 + py;
    ylim = g.ny;
  } else {
    x0 = int(blockIdx.x) * pl.ix;
  }
  const int gx = x0 - 1 + px;
  c.load = c.t < pl.wyx && gy >= 0 && gy < ylim && gx >= 0 && gx < g.nx;
  c.gbase = (DIM == 3 ? gy * g.nx : 0) + gx;
  const int qy = DIM == 3 ? c.t / kVarTileX : 0;
  const int qx = DIM == 3 ? c.t % kVarTileX : c.t;
  c.own = c.t < pl.iy * pl.ix && y0 + qy < ylim && x0 + qx < g.nx;
  c.oc = (DIM == 3 ? (qy + 1) * pl.wx : 0) + qx + 1;
  c.p0 = int(blockIdx.y) * P;
  c.obase = (DIM == 3 ? (y0 + qy) * g.nx : 0) + x0 + qx + c.p0 * pl.pstride;
  c.klo = c.p0 == 0 ? 1 : 0;
  c.khi = min(P + 2, pl.np - c.p0 + 1);
  c.kown = min(P, pl.np - c.p0);
  return c;
}

// The window column of one time row (`row`: its first value) into v, 0
// outside the grid.
template <int WP, typename T>
__device__ __forceinline__ void var_load_col(const T* __restrict__ row,
                                             const VarCol& c,
                                             const VarPlan& pl, T (&v)[WP]) {
  const T* base = row + c.gbase + (c.p0 - 1) * pl.pstride;
#pragma unroll
  for (int k = 0; k < WP; ++k) {
    v[k] = c.load && k >= c.klo && k < c.khi ? __ldg(base + k * pl.pstride)
                                             : T(0);
  }
}

// The values of one time row at a column's owned points (`row`: its first
// value), 0 past the grid; through the read-only path (NC) or, for a field
// the launch writes back in place, plain loads.
template <int P, bool NC = true, typename T>
__device__ __forceinline__ void var_load_own(const T* __restrict__ row,
                                             const VarCol& c,
                                             const VarPlan& pl, T (&v)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const T* p = row + c.obase + j * pl.pstride;
    v[j] = c.own && j < c.kown ? (NC ? __ldg(p) : *p) : T(0);
  }
}

// The Chebyshev step's fields and scalars of a K10 launch (the chained
// form of the sweep, `cheb_step_at`'s): the columns 1/θ and 1/δ, r (read
// and written in place by a later step), d_in (the field Op reads in a
// later step) and d_out, `last` (the sweep's last step writes x_out
// alone) and the recurrence's c1, c2. K11 and K12 pass none.
template <typename T>
struct VarSweep {
  const T* invT;
  const T* invDel;
  T* r;
  const T* d_in;
  T* d_out;
  int last;
  double c1, c2;
};

// K12 (kVarApply: out = A_w x), K11 (kVarResidual: out = b − (A_w x + ω·M
// x)) and the steps of K10 (`MODE`, with `sw`) on the tile of blockIdx (x:
// plane tile, y: pencil) for the time rows [t0, t1) of chunk blockIdx.z.
// The weights of the tile's points are loaded once: in registers (REG, at
// most kVarRowTaps taps) or in a shared tile [tap][pencil point][column]
// after the field's buffers, each thread's column its own; K10's steps
// also hold W[kc] (its 1/D) in registers (the first two from 0 along the
// loaded window column too), and the first step from 0, which applies no
// Op, holds that alone. Sums as `var_apply_global` and
// `mass_global`: the A taps in weight-array order, the mass's groups in
// order, each group's sum times its weight, then a + ω·m; a tap past the
// grid reads the window's 0, which changes no sum (w·0 added to a sum that
// is never −0), where those kernels skipped it. A step's recurrence is
// `cheb_step_at`'s, its scalars rounded as there (T(c1), T(c2)·1/δ), and
// the contractions nvcc made in the chained step written out: 1/D's
// denominator W[kc] + c_M·ω (`var_inv_diag_madd`), r − D⁻¹·Op d and
// (c2/δ)·r + c1·d_in one fma each (c1·d_in rounded first), x + r/θ two
// roundings (`add_rn`). The window of a later step holds d_in, the first
// from x's x and the first two from 0's the first step's d, and each
// reads its point's own value there.
template <int DIM, typename T, int MODE, bool REG>
__global__ void __launch_bounds__(var_max_threads<DIM, MODE>(),
                                  var_min_blocks<DIM, T, MODE>())
    mg_var_stencil_kernel(const T* __restrict__ x, const T* __restrict__ b,
                          const T* __restrict__ W,
                          const T* __restrict__ omega, T* __restrict__ out,
                          int nt, Grid g, VarPlan pl, int chunk,
                          const __grid_constant__ VarTaps vt,
                          const __grid_constant__ PairGroups pm,
                          VarSweep<T> sw) {
  constexpr bool kOp = MODE != kVarFirstZero;        // applies A_w
  constexpr bool kMass = kOp && MODE != kVarApply;    // and ω·M
  constexpr bool kSweep = MODE >= kVarFirst;          // a step of K10
  constexpr bool kOwn = MODE != kVarApply;            // b (or r) at a point
  constexpr bool kTwo = MODE == kVarFirstTwo;         // the window: D⁻¹b/θ
  constexpr int P = var_pencil<DIM, T, MODE>(), WP = P + 2;
  constexpr int ST = var_stride<DIM, MODE>();
  constexpr int KA = REG ? kVarRowTaps : var_taps<DIM>();
  constexpr int KM = var_taps<DIM>();
  T* const xs = window_buffers<T>();  // 2 × WP × ST, then the shared tile
  __shared__ int atoff[kMaxVarTaps];
  __shared__ int mtoff[kMaxPairTaps];
  __shared__ T mwend[kMaxPairTaps];
  const VarCol c = var_column<DIM>(g, pl, P);
  const int na = vt.n_taps;
  auto window_offset = [&](int dz, int dy, int dx) {
    return DIM == 2 ? dy * ST + dx : dz * ST + dy * pl.wx + dx;
  };
  unsigned mends = 0;
  if constexpr (kOp) {
    for (int k = threadIdx.x; k < na; k += blockDim.x) {
      atoff[k] = window_offset(vt.dz[k], vt.dy[k], vt.dx[k]);
    }
  }
  if constexpr (kMass) {
    for (int k = threadIdx.x; k < pm.start[pm.n_groups]; k += blockDim.x) {
      mtoff[k] = window_offset(pm.dz[k], pm.dy[k], pm.dx[k]);
    }
    mends = group_ends(pm, [&](int gi) { return T(pm.wm[gi]); }, mwend);
  }
  const int64_t S = row_size(g);
  // the weights of the column's points, once for the chunk
  const int nc = pl.iy * pl.ix;  // the shared tile's stride
  T* const ws = xs + 2 * WP * ST + c.t;
  T w[REG ? KA : 1][P];
  if constexpr (kOp && REG) {
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      if (k < na) {
        var_load_own<P>(W + int64_t(k) * S, c, pl, w[k]);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) w[k][j] = T(0);
      }
    }
  } else if (kOp && c.own) {
    for (int k = 0; k < na; ++k) {
      T v[P];
      var_load_own<P>(W + int64_t(k) * S, c, pl, v);
#pragma unroll
      for (int j = 0; j < P; ++j) ws[(k * P + j) * nc] = v[j];
    }
  }
  T wc[kSweep ? P : 1];  // W[kc], the Jacobi diagonal's weight
  if constexpr (kSweep) var_load_own<P>(W + int64_t(vt.kc) * S, c, pl, wc);
  T wcol[kTwo ? WP : 1];  // W[kc] along the loaded window column
  if constexpr (kTwo) var_load_col<WP>(W + int64_t(vt.kc) * S, c, pl, wcol);
  const int t0 = int(blockIdx.z) * chunk, t1 = min(t0 + chunk, nt);
  int o[P];
#pragma unroll
  for (int j = 0; j < P; ++j) o[j] = (1 + j) * ST + c.oc;
  // the field Op reads: x, or d_in in a later step; b in the first two
  // steps from 0 (their window holds the first step's d, made from it)
  const T* const y = MODE == kVarStep ? sw.d_in : kTwo ? b : x;
  // the row's own fields at the column's points: b, or r and x_out in a
  // later step (written back in place: plain loads)
  auto load_own = [&](int t, T(&p0)[P], T(&p1)[P]) {
    if constexpr (MODE == kVarStep) {
      var_load_own<P, false>(sw.r + int64_t(t) * S, c, pl, p0);
      var_load_own<P, false>(out + int64_t(t) * S, c, pl, p1);
    } else if constexpr (kOwn) {
      var_load_own<P>(b + int64_t(t) * S, c, pl, p0);
    }
  };
  T u[kOp ? WP : 1];  // the window column of y
  T p0[P], p1[P];     // the own fields
  if constexpr (kOp) var_load_col<WP>(y + int64_t(t0) * S, c, pl, u);
  load_own(t0, p0, p1);
  for (int t = t0; t < t1; ++t) {
    T* const buf = xs + ((t - t0) & 1) * WP * ST;
    if constexpr (kTwo) {  // the first step's d = (D⁻¹·b)·(1/θ)
      const T om = omega[t], iT = sw.invT[t];
      if (c.t < pl.wyx) {
#pragma unroll
        for (int k = 0; k < WP; ++k) {
          buf[k * ST + c.t] = var_inv_diag_madd(vt, om, wcol[k]) * u[k] * iT;
        }
      }
    } else if constexpr (kOp) {
      if (c.t < pl.wyx) {
#pragma unroll
        for (int k = 0; k < WP; ++k) buf[k * ST + c.t] = u[k];
      }
    }
    // the next row's window and own fields, in flight across the barrier
    // and the sums
    T n0[P], n1[P];
    if (t + 1 < t1) {
      if constexpr (kOp) var_load_col<WP>(y + int64_t(t + 1) * S, c, pl, u);
      load_own(t + 1, n0, n1);
    }
    if constexpr (kOp) __syncthreads();
    if (c.own) {
      T a[P], m[P];
#pragma unroll
      for (int j = 0; j < P; ++j) a[j] = m[j] = T(0);
      if constexpr (kOp) {
#pragma unroll
        for (int k = 0; k < KA; ++k) {
          if (k < na) {
            const T* const bk = buf + atoff[k];
#pragma unroll
            for (int j = 0; j < P; ++j) {
              T wkj;
              if constexpr (REG) {
                wkj = w[k][j];
              } else {
                wkj = ws[(k * P + j) * nc];
              }
              a[j] = VAR_MADD(wkj, bk[o[j]], a[j]);
            }
          }
        }
      }
      if constexpr (kMass) {
        T acc[P];
#pragma unroll
        for (int j = 0; j < P; ++j) acc[j] = T(0);
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (mends >> k) {  // tap k exists: a group ends at it or after it
            const T* const bk = buf + mtoff[k];
#pragma unroll
            for (int j = 0; j < P; ++j) acc[j] += bk[o[j]];
            if ((mends >> k) & 1u) {
              const T wk = mwend[k];
#pragma unroll
              for (int j = 0; j < P; ++j) {
                m[j] = VAR_MADD(wk, acc[j], m[j]);
                acc[j] = T(0);
              }
            }
          }
        }
      }
      const int64_t base = int64_t(t) * S + c.obase;
      const T om = kMass || kSweep ? omega[t] : T(0);
      if constexpr (kSweep) {
        const T iT = sw.invT[t];
        const T c1 = T(sw.c1);
        const T c2d = T(sw.c2) * sw.invDel[t];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (j < c.kown) {
            const T iD = var_inv_diag_madd(vt, om, wc[j]);
            T ri, d, xo;
            if constexpr (MODE == kVarStep) {
              ri = VAR_MADD(-iD, VAR_MADD(om, m[j], a[j]), p0[j]);
              d = VAR_MADD(c2d, ri, c1 * buf[o[j]]);
              xo = p1[j] + d;
            } else if constexpr (MODE == kVarFirst) {
              ri = iD * (p0[j] - VAR_MADD(om, m[j], a[j]));
              d = ri * iT;
              xo = add_rn(buf[o[j]], d);
            } else if constexpr (kTwo) {
              // step 1 from 0: r = D⁻¹b, d = x = the window's value here;
              // step 2 on them (c1, c2 its scalars)
              const T r1 = iD * p0[j], d1 = buf[o[j]];
              ri = VAR_MADD(-iD, VAR_MADD(om, m[j], a[j]), r1);
              d = VAR_MADD(c2d, ri, c1 * d1);
              xo = d1 + d;
            } else {
              ri = iD * p0[j];
              d = ri * iT;
              xo = d;
            }
            const int64_t q = base + j * pl.pstride;
            if (!sw.last) {
              sw.r[q] = ri;
              sw.d_out[q] = d;
            }
            out[q] = xo;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (j < c.kown) {
            out[base + j * pl.pstride] =
                kMass ? p0[j] - VAR_MADD(om, m[j], a[j]) : a[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      p0[j] = n0[j];
      p1[j] = n1[j];
    }
  }
}

// K13: K8 with Op_w, 2^d · 2 weighted fine residuals per coarse point.
template <int DIM, typename T>
__global__ void mg_residual_restrict_var_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ W,
    const T* __restrict__ omega, T* __restrict__ rc, int64_t nt, Grid g,
    const __grid_constant__ VarTaps vt,
    const __grid_constant__ PairGroups pm, int rows_first) {
  const int64_t S = row_size(g);
  const Grid gc = coarse_grid<DIM>(g);
  const int64_t Sc = row_size(gc);
  for_each_point(nt, Sc, rows_first, [&](int64_t t, int r) {
    const T om = omega[t];
    const T* xt = x + t * S;
    const T* bt = b + t * S;
    rc[t * Sc + r] = restrict_at<DIM, T>(
        point_in_row<DIM>(t, r, gc), serial_lead<DIM>(g),
        [&](int z, int y, int xx) {
          return bt[(z * g.ny + y) * g.nx + xx] -
                 var_op_global<DIM>(vt, pm, W, om, xt, g, z, y, xx);
        });
  });
}

// One step of the degree-ν Chebyshev–Jacobi recurrence at flat index idx,
// in device memory (the chained sweeps, see mg_cheb_step_kernel): the
// first step takes x (null: x = 0) and b and writes r = D⁻¹(b − Op x),
// d_out = r/θ and x_out = x + d_out; a later one reads d_in and r and
// writes r −= D⁻¹ Op d_in, d_out = c1·d_in + c2/δ·r, x_out += d_out.
// op_at(f) is Op applied to field f at this point; v the validity factor
// of a sharded slab (1 on serial grids) multiplies each r.
template <typename T, typename OpAt>
__device__ __forceinline__ void cheb_step_at(
    int64_t idx, int first, const T* __restrict__ x, const T* __restrict__ b,
    T iD, T iT, T iDel, T v, T* __restrict__ r, const T* __restrict__ d_in,
    T* __restrict__ d_out, T* __restrict__ xo, double c1, double c2,
    const OpAt& op_at) {
  if (first) {
    const T ri = v * (iD * (x == nullptr ? b[idx] : b[idx] - op_at(x)));
    const T d = ri * iT;
    r[idx] = ri;
    d_out[idx] = d;
    xo[idx] = x == nullptr ? d : x[idx] + d;
  } else {
    const T ri = v * (r[idx] - iD * op_at(d_in));
    const T d = T(c1) * d_in[idx] + (T(c2) * iDel) * ri;
    r[idx] = ri;
    d_out[idx] = d;
    xo[idx] = xo[idx] + d;
  }
}

// K3's chained sweep: one Chebyshev step with the constant pair groups,
// one thread per point. Op reads d_in's neighbours, so d ping-pongs between
// two buffers across the chain; r and x_out are read and written by their
// own point's thread only. vm: the sharded slab's validity field, or null.
template <int DIM, typename T>
__global__ void mg_cheb_step_kernel(
    const T* __restrict__ x, const T* __restrict__ b,
    const T* __restrict__ vm, const T* __restrict__ omega,
    const T* __restrict__ invD,
    const T* __restrict__ invT, const T* __restrict__ invDel,
    T* __restrict__ r, const T* __restrict__ d_in, T* __restrict__ d_out,
    T* __restrict__ xo, int64_t nt, Grid g,
    const __grid_constant__ PairGroups pg, int first, double c1,
    double c2) {
  const int64_t S = row_size(g);
  FOR_EACH_INDEX(idx, nt * S) {
    const Point p = point_of<DIM>(idx, g);
    const T om = omega[p.t];
    cheb_step_at(idx, first, x, b, invD[p.t], invT[p.t], invDel[p.t],
                 valid_at(vm, int(idx - p.t * S)), r, d_in, d_out, xo, c1,
                 c2, [&](const T* f) {
                   return op_global<DIM>(pg, om, f + p.t * S, g, p.z, p.y,
                                         p.x);
                 });
  }
}

#undef FOR_EACH_INDEX

int blocks_for(int64_t total) {
  int64_t b = (total + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return int(b < kMaxBlocks ? b : kMaxBlocks);
}

// The blocks of a tiled kernel: x bricks, (z brick, y brick) pairs, rows.
template <int DIM>
dim3 bricks(int64_t nt, const Grid& g) {
  using B = BrickOf<DIM>;
  return dim3(unsigned((g.nx + B::x - 1) / B::x),
              unsigned(((g.nz + B::z - 1) / B::z) *
                       ((g.ny + B::y - 1) / B::y)),
              unsigned(nt));
}

// Whether the weighted kernels take the row fastest: where a level's
// weights (ntaps, S) do not fit in the device's L2 (see the header).
bool rows_first(const VarTaps* vt, int64_t S, size_t elem) {
  int dev = 0, l2 = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  return int64_t(vt->n_taps) * S * int64_t(elem) > int64_t(l2);
}

// The blocks of `for_each_point` over (nt, S).
int point_blocks(int64_t nt, int64_t S, bool rows_first) {
  return blocks_for(rows_first ? nt * ((S + kThreads - 1) / kThreads) * kThreads
                               : nt * S);
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

// Dynamic shared memory of a tiled kernel with halo H: three buffers over
// the window, its limit raised (`allow_smem`).
template <int DIM, typename T, typename K>
int window_bytes(K kernel, int H, size_t* bytes) {
  using B = BrickOf<DIM>;
  const size_t hz = DIM == 3 ? size_t(H) : 0;
  *bytes = 3 * sizeof(T) * (B::x + 2 * size_t(H)) *
           (B::y + 2 * size_t(H)) * (B::z + 2 * hz);
  return allow_smem(kernel, *bytes);
}

// Dynamic shared memory of a march with halo H: `rings` rings of three
// window planes (`March`; 3-D K6/K14 ν + 1 at H = ν + 1, K7/K15 ν at H =
// ν), its limit raised (tests/test_torch_march.py checks the sum).
template <int H, typename T, typename K>
int march_bytes(K kernel, int rings, size_t* bytes) {
  *bytes = size_t(3 * rings * March<H>::P) * sizeof(T);
  return allow_smem(kernel, *bytes);
}

// Dynamic shared memory of a 2-D march: `rings` rings of three window
// rows of rp.wrow points (K6 ν + 1 at H = ν + 1, K7 ν at H = ν), its limit
// raised (tests/test_torch_march.py checks the sum).
template <typename T, typename K>
int march2_bytes(K kernel, int rings, const RowPlan& rp, size_t* bytes) {
  *bytes = size_t(3 * rings) * size_t(rp.wrow) * sizeof(T);
  return allow_smem(kernel, *bytes);
}

// The blocks of a 2-D march: segments, chunks of `chunk` of the n rows
// the chunks cut (K6 coarse, K7 fine; at least one chunk), time rows.
dim3 row_blocks(int64_t nt, const RowPlan& rp, int n, int chunk) {
  return dim3(unsigned(rp.nseg), unsigned(n > 0 ? (n + chunk - 1) / chunk : 1),
              unsigned(nt));
}

// The blocks of a march: x tiles, (chunk, y tile) pairs of `chunk` of the
// n planes the chunks cut (K6/K14 coarse, K7/K15 fine; at least one
// chunk), rows; with rows_first, the row fastest (`march_tile`).
dim3 march_blocks(bool rows_first, int64_t nt, const Grid& g, int n,
                  int chunk) {
  const unsigned tx = unsigned((g.nx + kMarchX - 1) / kMarchX);
  const unsigned tyc = unsigned((g.ny + kMarchY - 1) / kMarchY) *
                       unsigned(n > 0 ? (n + chunk - 1) / chunk : 1);
  return rows_first ? dim3(unsigned(nt), tx, tyc) : dim3(tx, tyc, unsigned(nt));
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

template <int DIM, typename T>
int launch_smooth(const T* x, const T* b, const T* vm, const T* omega,
                  const T* invD, const T* invT, const T* invDel, T* out,
                  int64_t nt, Grid g, const PairGroups* pg, int nu,
                  int zero_init, void* stream) {
  size_t bytes = 0;
  const int err = window_bytes<DIM, T>(mg_smooth_kernel<DIM, T>,
                                       zero_init ? nu - 1 : nu, &bytes);
  if (err != 0) return err;
  mg_smooth_kernel<DIM, T><<<bricks<DIM>(nt, g), kThreads, bytes,
                             as_stream(stream)>>>(
      x, b, vm, omega, invD, invT, invDel, out, g, *pg, nu, zero_init);
  return int(cudaGetLastError());
}

template <int NU, typename T>
int launch_march_pre(const T* b, const T* vm, const T* omega, const T* invD,
                     const T* invT, const T* invDel, T* xo, T* rco,
                     int64_t nt, Grid g, const PairGroups* pg, Lead ld,
                     int chunk, void* stream) {
  size_t bytes = 0;
  const int err =
      march_bytes<NU + 1, T>(mg_march_pre_kernel<NU, T>, NU + 1, &bytes);
  if (err != 0) return err;
  mg_march_pre_kernel<NU, T><<<march_blocks(false, nt, g, ld.nc, chunk),
                               kThreads, bytes, as_stream(stream)>>>(
      b, vm, omega, invD, invT, invDel, xo, rco, g, *pg, ld, chunk);
  return int(cudaGetLastError());
}

// Whether a pair table suits the masked tap loop (`ConstOp::row_many`) of
// the 2-D marches and of K4/K5: at most `taps` taps, no empty group, every
// tap within one cell of its point.
bool row_table_ok(const PairGroups& pg, int taps = kRowTaps) {
  if (pg.n_groups < 1 || pg.start[pg.n_groups] > taps) return false;
  for (int g = 0; g < pg.n_groups; ++g) {
    if (pg.start[g + 1] <= pg.start[g]) return false;
  }
  auto far = [](int d) { return d < -1 || d > 1; };
  for (int k = 0; k < pg.start[pg.n_groups]; ++k) {
    if (far(pg.dz[k]) || far(pg.dy[k]) || far(pg.dx[k])) return false;
  }
  return true;
}

template <int NU, typename T>
int launch_march2_pre(const T* b, const T* vm, const T* omega, const T* invD,
                      const T* invT, const T* invDel, T* xo, T* rco,
                      int64_t nt, Grid g, const PairGroups* pg, Lead ld,
                      int chunk, void* stream) {
  if (!row_table_ok(*pg)) return int(cudaErrorInvalidValue);
  const RowPlan rp = row_plan(g.nx, NU + 1, march2_slots<T>());
  size_t bytes = 0;
  const int err =
      march2_bytes<T>(mg_march2_pre_kernel<NU, T>, NU + 1, rp, &bytes);
  if (err != 0) return err;
  mg_march2_pre_kernel<NU, T><<<row_blocks(nt, rp, ld.nc, chunk), rp.threads,
                                bytes, as_stream(stream)>>>(
      b, vm, omega, invD, invT, invDel, xo, rco, g, *pg, ld, chunk, rp);
  return int(cudaGetLastError());
}

// K6: the march in z in 3-D (chunk ≥ 1 coarse planes), in y in 2-D (chunk
// ≥ 1 coarse rows); ν ∈ {2, 3}.
template <int DIM, typename T>
int launch_fused_pre(const T* b, const T* vm, const T* omega, const T* invD,
                     const T* invT, const T* invDel, T* xo, T* rco,
                     int64_t nt, Grid g, const PairGroups* pg, int nu,
                     Lead ld, int chunk, void* stream) {
  if (chunk < 1 || nu < 2 || nu > 3) return int(cudaErrorInvalidValue);
  if constexpr (DIM == 3) {
    return (nu == 2 ? launch_march_pre<2, T> : launch_march_pre<3, T>)(
        b, vm, omega, invD, invT, invDel, xo, rco, nt, g, pg, ld, chunk,
        stream);
  } else {
    return (nu == 2 ? launch_march2_pre<2, T> : launch_march2_pre<3, T>)(
        b, vm, omega, invD, invT, invDel, xo, rco, nt, g, pg, ld, chunk,
        stream);
  }
}

template <int NU, typename T>
int launch_march_post(const T* x, const T* b, const T* ec, const T* vm,
                      const T* omega, const T* invD, const T* invT,
                      const T* invDel, T* out, int64_t nt, Grid g,
                      const PairGroups* pg, Lead ld, int chunk,
                      void* stream) {
  size_t bytes = 0;
  const int err = march_bytes<NU, T>(mg_march_post_kernel<NU, T>, NU, &bytes);
  if (err != 0) return err;
  mg_march_post_kernel<NU, T><<<march_blocks(false, nt, g, g.nz, chunk),
                                kThreads, bytes, as_stream(stream)>>>(
      x, b, ec, vm, omega, invD, invT, invDel, out, g, *pg, ld, chunk);
  return int(cudaGetLastError());
}

template <int NU, typename T>
int launch_march2_post(const T* x, const T* b, const T* ec, const T* vm,
                       const T* omega, const T* invD, const T* invT,
                       const T* invDel, T* out, int64_t nt, Grid g,
                       const PairGroups* pg, Lead ld, int chunk,
                       void* stream) {
  if (!row_table_ok(*pg)) return int(cudaErrorInvalidValue);
  const RowPlan rp = row_plan(g.nx, NU, march2_slots<T>());
  size_t bytes = 0;
  const int err =
      march2_bytes<T>(mg_march2_post_kernel<NU, T>, NU, rp, &bytes);
  if (err != 0) return err;
  mg_march2_post_kernel<NU, T><<<row_blocks(nt, rp, g.ny, chunk),
                                 rp.threads, bytes, as_stream(stream)>>>(
      x, b, ec, vm, omega, invD, invT, invDel, out, g, *pg, ld, chunk, rp);
  return int(cudaGetLastError());
}

// K7: the march in z in 3-D (chunk ≥ 1 fine planes), in y in 2-D (chunk ≥
// 1 fine rows); ν ∈ {2, 3}.
template <int DIM, typename T>
int launch_fused_post(const T* x, const T* b, const T* ec, const T* vm,
                      const T* omega, const T* invD, const T* invT,
                      const T* invDel, T* out, int64_t nt, Grid g,
                      const PairGroups* pg, int nu, Lead ld, int chunk,
                      void* stream) {
  if (chunk < 1 || nu < 2 || nu > 3) return int(cudaErrorInvalidValue);
  if constexpr (DIM == 3) {
    return (nu == 2 ? launch_march_post<2, T> : launch_march_post<3, T>)(
        x, b, ec, vm, omega, invD, invT, invDel, out, nt, g, pg, ld, chunk,
        stream);
  } else {
    return (nu == 2 ? launch_march2_post<2, T> : launch_march2_post<3, T>)(
        x, b, ec, vm, omega, invD, invT, invDel, out, nt, g, pg, ld, chunk,
        stream);
  }
}

template <int NU, typename T>
int launch_march_pre_var(const T* b, const T* W, const T* omega,
                         const T* invT, const T* invDel, T* xo, T* rco,
                         int64_t nt, Grid g, const VarTaps* vt,
                         const PairGroups* pm, int chunk, void* stream) {
  size_t bytes = 0;
  const int err = march_bytes<NU + 1, T>(mg_march_pre_var_kernel<NU, T>,
                                          NU + 1, &bytes);
  if (err != 0) return err;
  const bool rf = rows_first(vt, row_size(g), sizeof(T));
  mg_march_pre_var_kernel<NU, T><<<
      march_blocks(rf, nt, g, serial_lead<3>(g).nc, chunk), kThreads, bytes,
      as_stream(stream)>>>(b, W, omega, invT, invDel, xo, rco, g, *vt, *pm,
                           chunk, rf);
  return int(cudaGetLastError());
}

// Whether a weighted table suits the 2-D marches' `VarOp::row_many`: at
// most kVarRowTaps A taps, the centre among them, every tap within one
// cell of its point, and a mass table of at most kVarRowTaps taps as
// `row_table_ok` takes it.
bool var_row_table_ok(const VarTaps& vt, const PairGroups& pm) {
  if (vt.n_taps < 1 || vt.n_taps > kVarRowTaps || vt.kc < 0 ||
      vt.kc >= vt.n_taps) {
    return false;
  }
  auto far = [](int d) { return d < -1 || d > 1; };
  for (int k = 0; k < vt.n_taps; ++k) {
    if (far(vt.dz[k]) || far(vt.dy[k]) || far(vt.dx[k])) return false;
  }
  return row_table_ok(pm, kVarRowTaps);
}

template <int NU, typename T>
int launch_march2_pre_var(const T* b, const T* W, const T* omega,
                          const T* invT, const T* invDel, T* xo, T* rco,
                          int64_t nt, Grid g, const VarTaps* vt,
                          const PairGroups* pm, int chunk, void* stream) {
  if (!var_row_table_ok(*vt, *pm)) return int(cudaErrorInvalidValue);
  const RowPlan rp = row_plan(g.nx, NU + 1, march2_slots<T>());
  size_t bytes = 0;
  const int err =
      march2_bytes<T>(mg_march2_pre_var_kernel<NU, T>, NU + 1, rp, &bytes);
  if (err != 0) return err;
  mg_march2_pre_var_kernel<NU, T><<<
      row_blocks(nt, rp, serial_lead<2>(g).nc, chunk), rp.threads, bytes,
      as_stream(stream)>>>(b, W, omega, invT, invDel, xo, rco, g, *vt, *pm,
                           chunk, rp);
  return int(cudaGetLastError());
}

// K14: the march in z in 3-D (chunk ≥ 1 coarse planes), in y in 2-D
// (chunk ≥ 1 coarse rows); ν ∈ {2, 3}.
template <int DIM, typename T>
int launch_fused_pre_var(const T* b, const T* W, const T* omega,
                         const T* invT, const T* invDel, T* xo, T* rco,
                         int64_t nt, Grid g, const VarTaps* vt,
                         const PairGroups* pm, int nu, int chunk,
                         void* stream) {
  if (chunk < 1 || nu < 2 || nu > 3) return int(cudaErrorInvalidValue);
  if constexpr (DIM == 3) {
    return (nu == 2 ? launch_march_pre_var<2, T>
                    : launch_march_pre_var<3, T>)(
        b, W, omega, invT, invDel, xo, rco, nt, g, vt, pm, chunk, stream);
  } else {
    return (nu == 2 ? launch_march2_pre_var<2, T>
                    : launch_march2_pre_var<3, T>)(
        b, W, omega, invT, invDel, xo, rco, nt, g, vt, pm, chunk, stream);
  }
}

template <int NU, typename T, bool RF>
int launch_march_post_var(const T* x, const T* b, const T* ec, const T* W,
                          const T* omega, const T* invT, const T* invDel,
                          T* out, int64_t nt, Grid g, const VarTaps* vt,
                          const PairGroups* pm, int chunk, void* stream) {
  size_t bytes = 0;
  const int err =
      march_bytes<NU, T>(mg_march_post_var_kernel<NU, T, RF>, NU, &bytes);
  if (err != 0) return err;
  mg_march_post_var_kernel<NU, T, RF><<<march_blocks(RF, nt, g, g.nz, chunk),
                                        kThreads, bytes,
                                        as_stream(stream)>>>(
      x, b, ec, W, omega, invT, invDel, out, g, *vt, *pm, chunk);
  return int(cudaGetLastError());
}

template <int NU, typename T>
int launch_march2_post_var(const T* x, const T* b, const T* ec, const T* W,
                           const T* omega, const T* invT, const T* invDel,
                           T* out, int64_t nt, Grid g, const VarTaps* vt,
                           const PairGroups* pm, int chunk, void* stream) {
  if (!var_row_table_ok(*vt, *pm)) return int(cudaErrorInvalidValue);
  const RowPlan rp = row_plan(g.nx, NU, march2_slots<T>());
  size_t bytes = 0;
  const int err =
      march2_bytes<T>(mg_march2_post_var_kernel<NU, T>, NU, rp, &bytes);
  if (err != 0) return err;
  mg_march2_post_var_kernel<NU, T><<<row_blocks(nt, rp, g.ny, chunk),
                                     rp.threads, bytes,
                                     as_stream(stream)>>>(
      x, b, ec, W, omega, invT, invDel, out, g, *vt, *pm, chunk, rp);
  return int(cudaGetLastError());
}

// K15: the march in z in 3-D (chunk ≥ 1 fine planes), in y in 2-D (chunk
// ≥ 1 fine rows); ν ∈ {2, 3}.
template <int DIM, typename T>
int launch_fused_post_var(const T* x, const T* b, const T* ec, const T* W,
                          const T* omega, const T* invT, const T* invDel,
                          T* out, int64_t nt, Grid g, const VarTaps* vt,
                          const PairGroups* pm, int nu, int chunk,
                          void* stream) {
  if (chunk < 1 || nu < 2 || nu > 3) return int(cudaErrorInvalidValue);
  if constexpr (DIM == 3) {
    const bool rf = rows_first(vt, row_size(g), sizeof(T));
    return (nu == 2 ? (rf ? launch_march_post_var<2, T, true>
                          : launch_march_post_var<2, T, false>)
                    : (rf ? launch_march_post_var<3, T, true>
                          : launch_march_post_var<3, T, false>))(
        x, b, ec, W, omega, invT, invDel, out, nt, g, vt, pm, chunk, stream);
  } else {
    return (nu == 2 ? launch_march2_post_var<2, T>
                    : launch_march2_post_var<3, T>)(
        x, b, ec, W, omega, invT, invDel, out, nt, g, vt, pm, chunk, stream);
  }
}

int64_t points(int64_t nt, const Grid& g) {
  return nt * int64_t(g.nz) * g.ny * g.nx;
}

// K4 (RES) or K5: the march (chunk ≥ 1 planes, rows in 2-D) on a table of
// at most kRowTaps (2-D) or kCubeTaps (3-D) taps.
template <int DIM, typename T, bool RES>
int launch_stencil(const T* x, const T* b, const T* omega, T* out,
                   int64_t nt, Grid g, const PairGroups* pg, int chunk,
                   void* stream) {
  if (chunk < 1 || !row_table_ok(*pg, DIM == 2 ? kRowTaps : kCubeTaps)) {
    return int(cudaErrorInvalidValue);
  }
  const StencilPlan sp = stencil_plan<DIM, T>(g);
  const size_t bytes = size_t(kStencilRing) * sp.plane * sizeof(T);
  const int err = allow_smem(mg_stencil_kernel<DIM, T, RES>, bytes);
  if (err != 0) return err;
  const int n = DIM == 3 ? g.nz : g.ny;
  mg_stencil_kernel<DIM, T, RES><<<
      dim3(unsigned(sp.tiles), unsigned((n + chunk - 1) / chunk),
           unsigned(nt)),
      sp.threads, bytes, as_stream(stream)>>>(x, b, omega, out, g, *pg,
                                              chunk);
  return int(cudaGetLastError());
}

template <int DIM, typename T>
int launch_residual(const T* x, const T* b, const T* omega, T* out,
                    int64_t nt, Grid g, const PairGroups* pg, int chunk,
                    void* stream) {
  return launch_stencil<DIM, T, true>(x, b, omega, out, nt, g, pg, chunk,
                                      stream);
}

template <int DIM, typename T>
int launch_apply(const T* x, T* out, int64_t nt, Grid g,
                 const PairGroups* pg, int chunk, void* stream) {
  return launch_stencil<DIM, T, false>(x, nullptr, nullptr, out, nt, g, pg,
                                       chunk, stream);
}

template <int DIM, typename T>
int launch_residual_restrict(const T* x, const T* b, const T* omega, T* rc,
                             int64_t nt, Grid g, const PairGroups* pg,
                             Lead ld, void* stream) {
  mg_residual_restrict_kernel<DIM, T><<<
      blocks_for(points(nt, coarse_grid<DIM>(g, ld))), kThreads, 0,
      as_stream(stream)>>>(x, b, omega, rc, nt, g, *pg, ld);
  return int(cudaGetLastError());
}

template <int DIM, typename T>
int launch_prolong_correct(const T* x, const T* ec, T* out, int64_t nt,
                           Grid g, Lead ld, void* stream) {
  mg_prolong_correct_kernel<DIM, T><<<blocks_for(points(nt, g)), kThreads, 0,
                                      as_stream(stream)>>>(x, ec, out, nt, g,
                                                           ld);
  return int(cudaGetLastError());
}

// Whether a weighted table suits the march of K10, K11 and K12: 1 to
// var_taps A taps, every one within one cell of its point (dz = 0 in
// 2-D), and for K10 and K11 (pm) a mass table as `row_table_ok` takes it.
bool var_stencil_table_ok(const VarTaps& vt, const PairGroups* pm, int dim) {
  const int cap = dim == 2 ? kRowTaps : kCubeTaps;
  if (vt.n_taps < 1 || vt.n_taps > cap) return false;
  auto far = [](int d) { return d < -1 || d > 1; };
  for (int k = 0; k < vt.n_taps; ++k) {
    if (far(vt.dz[k]) || far(vt.dy[k]) || far(vt.dx[k]) ||
        (dim == 2 && vt.dz[k] != 0)) {
      return false;
    }
  }
  return pm == nullptr || row_table_ok(*pm, cap);
}

// The march's kernel for `MODE` with n A taps, as a call of f(kernel,
// taps of its shared tile): the weights in registers up to kVarRowTaps
// taps, else in the shared tile; the first step from 0 holds W[kc] alone.
template <int DIM, typename T, int MODE, typename F>
int var_form(int n, F f) {
  if constexpr (MODE == kVarFirstZero) {
    return f(mg_var_stencil_kernel<DIM, T, MODE, true>, 0);
  } else {
    return n <= kVarRowTaps ? f(mg_var_stencil_kernel<DIM, T, MODE, true>, 0)
                            : f(mg_var_stencil_kernel<DIM, T, MODE, false>, n);
  }
}

// Dynamic shared memory of the march: the field's two window buffers and
// the shared tile of `tile` taps (none in registers; the first step from
// 0 takes none).
template <int DIM, typename T, int MODE>
size_t var_stencil_bytes(const VarPlan& pl, int tile) {
  if (MODE == kVarFirstZero) return 0;
  constexpr int P = var_pencil<DIM, T, MODE>();
  return (size_t(2 * (P + 2)) * var_stride<DIM, MODE>() +
          size_t(tile) * P * pl.iy * pl.ix) *
         sizeof(T);
}

// The mass table K12 passes (it reads none).
constexpr PairGroups kNoPairs{};

// The march in `MODE` (chunk ≥ 1 time rows); `sw` the K10 step's.
template <int DIM, typename T, int MODE>
int launch_var_stencil(const T* x, const T* b, const T* W, const T* omega,
                       T* out, int64_t nt, Grid g, const VarTaps* vt,
                       const PairGroups* pm, int chunk, void* stream,
                       const VarSweep<T>& sw = VarSweep<T>{}) {
  constexpr bool kMass = MODE != kVarApply;
  if (chunk < 1 || !var_stencil_table_ok(*vt, kMass ? pm : nullptr, DIM)) {
    return int(cudaErrorInvalidValue);
  }
  const VarPlan pl = var_plan<DIM, T, MODE>(g);
  return var_form<DIM, T, MODE>(vt->n_taps, [&](auto kernel, int tile) {
    const size_t bytes = var_stencil_bytes<DIM, T, MODE>(pl, tile);
    const int err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    kernel<<<dim3(unsigned(pl.xt * pl.yt), unsigned(pl.pt),
                  unsigned((nt + chunk - 1) / chunk)),
             pl.threads, bytes, as_stream(stream)>>>(
        x, b, W, omega, out, int(nt), g, pl, chunk, *vt,
        kMass ? *pm : kNoPairs, sw);
    return int(cudaGetLastError());
  });
}

template <int DIM, typename T>
int launch_residual_var(const T* x, const T* b, const T* W, const T* omega,
                        T* out, int64_t nt, Grid g, const VarTaps* vt,
                        const PairGroups* pm, int chunk, void* stream) {
  return launch_var_stencil<DIM, T, kVarResidual>(x, b, W, omega, out, nt, g,
                                                  vt, pm, chunk, stream);
}

template <int DIM, typename T>
int launch_apply_var(const T* x, const T* W, T* out, int64_t nt, Grid g,
                     const VarTaps* vt, int chunk, void* stream) {
  return launch_var_stencil<DIM, T, kVarApply>(x, nullptr, W, nullptr, out,
                                               nt, g, vt, nullptr, chunk,
                                               stream);
}

// One step of K10's sweep: with first = 1 the first from x (x non-null)
// or from x = 0, with first = 2 the first two from x = 0 (x null; c1, c2
// the second's), else a later one (d_in non-null); with `last` it writes
// x_out alone.
template <int DIM, typename T>
int launch_smooth_var(const T* x, const T* b, const T* W, const T* omega,
                      const T* invT, const T* invDel, T* r, const T* d_in,
                      T* d_out, T* xo, int64_t nt, Grid g, const VarTaps* vt,
                      const PairGroups* pm, int first, double c1, double c2,
                      int last, int chunk, void* stream) {
  const VarSweep<T> sw{invT, invDel, r, d_in, d_out, last, c1, c2};
  if (!first) {
    if (d_in == nullptr) return int(cudaErrorInvalidValue);
    return launch_var_stencil<DIM, T, kVarStep>(
        nullptr, nullptr, W, omega, xo, nt, g, vt, pm, chunk, stream, sw);
  }
  if (first == 2) {
    if (x != nullptr) return int(cudaErrorInvalidValue);
    return launch_var_stencil<DIM, T, kVarFirstTwo>(
        nullptr, b, W, omega, xo, nt, g, vt, pm, chunk, stream, sw);
  }
  return (x != nullptr ? launch_var_stencil<DIM, T, kVarFirst>
                       : launch_var_stencil<DIM, T, kVarFirstZero>)(
      x, b, W, omega, xo, nt, g, vt, pm, chunk, stream, sw);
}

template <int DIM, typename T>
int launch_residual_restrict_var(const T* x, const T* b, const T* W,
                                 const T* omega, T* rc, int64_t nt, Grid g,
                                 const VarTaps* vt, const PairGroups* pm,
                                 void* stream) {
  const bool rf = rows_first(vt, row_size(g), sizeof(T));
  mg_residual_restrict_var_kernel<DIM, T><<<
      point_blocks(nt, row_size(coarse_grid<DIM>(g)), rf), kThreads, 0,
      as_stream(stream)>>>(x, b, W, omega, rc, nt, g, *vt, *pm, rf);
  return int(cudaGetLastError());
}

template <int DIM, typename T>
int launch_cheb_step(const T* x, const T* b, const T* vm, const T* omega,
                     const T* invD, const T* invT, const T* invDel, T* r,
                     const T* d_in, T* d_out, T* xo, int64_t nt, Grid g,
                     const PairGroups* pg, int first, double c1, double c2,
                     void* stream) {
  mg_cheb_step_kernel<DIM, T><<<blocks_for(points(nt, g)), kThreads, 0,
                                as_stream(stream)>>>(
      x, b, vm, omega, invD, invT, invDel, r, d_in, d_out, xo, nt, g, *pg,
      first, c1, c2);
  return int(cudaGetLastError());
}

// Blocks per SM and dynamic shared bytes of march kernel k with halo H and
// `rings` rings, 256 threads a block.
template <int H, typename T, typename K>
int occupancy_of(K kernel, int rings, int* blocks, int* bytes) {
  size_t b = 0;
  const int err = march_bytes<H, T>(kernel, rings, &b);
  if (err != 0) return err;
  *bytes = int(b);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kThreads, b));
}

// The same for the 3-D K6 (post = 0, var = 0), K14 (0, 1), K7 (1, 0) or
// K15 (1, 1; 1, 2 its row-first instantiation) at ν = NU.
template <int NU, typename T>
int march_occupancy(int post, int var, int* blocks, int* bytes) {
  if (post) {
    if (var == 2) {
      return occupancy_of<NU, T>(mg_march_post_var_kernel<NU, T, true>, NU,
                                 blocks, bytes);
    }
    return var ? occupancy_of<NU, T>(mg_march_post_var_kernel<NU, T, false>,
                                     NU, blocks, bytes)
               : occupancy_of<NU, T>(mg_march_post_kernel<NU, T>, NU, blocks,
                                     bytes);
  }
  return var ? occupancy_of<NU + 1, T>(mg_march_pre_var_kernel<NU, T>,
                                       NU + 1, blocks, bytes)
             : occupancy_of<NU + 1, T>(mg_march_pre_kernel<NU, T>, NU + 1,
                                       blocks, bytes);
}

// Blocks per SM, dynamic shared bytes, threads a block and segments a row
// of the 2-D K6 (post = 0, var = 0), K14 (0, 1), K7 (1, 0) or K15 (1, 1)
// at ν = NU on rows of nx columns.
template <int NU, typename T>
int march2_occupancy(int post, int var, int nx, int* blocks, int* bytes,
                     int* threads, int* nseg) {
  const RowPlan rp = row_plan(nx, post ? NU : NU + 1, march2_slots<T>());
  auto of = [&](auto kernel, int rings) {
    size_t b = 0;
    const int err = march2_bytes<T>(kernel, rings, rp, &b);
    if (err != 0) return err;
    *bytes = int(b);
    *threads = rp.threads;
    *nseg = rp.nseg;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, rp.threads, b));
  };
  if (var) {
    return post ? of(mg_march2_post_var_kernel<NU, T>, NU)
                : of(mg_march2_pre_var_kernel<NU, T>, NU + 1);
  }
  return post ? of(mg_march2_post_kernel<NU, T>, NU)
              : of(mg_march2_pre_kernel<NU, T>, NU + 1);
}

// Blocks per SM, dynamic shared bytes, threads a block and blocks a chunk
// of the leading axis (`stencil_plan`) of K4 (res) or K5 on grid g.
template <int DIM, typename T>
int stencil_occupancy(int res, const Grid& g, int* blocks, int* bytes,
                      int* threads, int* tiles) {
  const StencilPlan sp = stencil_plan<DIM, T>(g);
  const size_t b = size_t(kStencilRing) * sp.plane * sizeof(T);
  auto of = [&](auto kernel) {
    const int err = allow_smem(kernel, b);
    if (err != 0) return err;
    *bytes = int(b);
    *threads = sp.threads;
    *tiles = sp.tiles;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, sp.threads, b));
  };
  return res ? of(mg_stencil_kernel<DIM, T, true>)
             : of(mg_stencil_kernel<DIM, T, false>);
}

// Blocks per SM, dynamic shared bytes, threads a block and blocks a chunk
// of time rows (tiles × pencils) of the march in `MODE` with n A taps on
// grid g.
template <int DIM, typename T, int MODE>
int var_stencil_occupancy_of(int n, const Grid& g, int* blocks, int* bytes,
                             int* threads, int* tiles) {
  const VarPlan pl = var_plan<DIM, T, MODE>(g);
  return var_form<DIM, T, MODE>(n, [&](auto kernel, int tile) {
    const size_t b = var_stencil_bytes<DIM, T, MODE>(pl, tile);
    const int err = allow_smem(kernel, b);
    if (err != 0) return err;
    *bytes = int(b);
    *threads = pl.threads;
    *tiles = pl.xt * pl.yt * pl.pt;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, pl.threads, b));
  });
}

template <int DIM, typename T>
int var_stencil_occupancy(int mode, int n, const Grid& g, int* blocks,
                          int* bytes, int* threads, int* tiles) {
  if (n < 1 || n > var_taps<DIM>()) return int(cudaErrorInvalidValue);
  switch (mode) {
#define VAR_OCC(M)                                                           \
  case M:                                                                    \
    return var_stencil_occupancy_of<DIM, T, M>(n, g, blocks, bytes, threads, \
                                               tiles);
    VAR_OCC(kVarApply)
    VAR_OCC(kVarResidual)
    VAR_OCC(kVarFirst)
    VAR_OCC(kVarFirstZero)
    VAR_OCC(kVarStep)
    VAR_OCC(kVarFirstTwo)
#undef VAR_OCC
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The 2-D or 3-D instantiation of launcher L for a runtime dim.
#define BY_DIM(L, T, ...) \
  (dim == 3 ? L<3, T>(__VA_ARGS__) : L<2, T>(__VA_ARGS__))

// The serial transfers of a grid with a runtime dim (`serial_lead`).
Lead serial_lead_of(const Grid& g, int dim) {
  return Lead{0, 0, ((dim == 3 ? g.nz : g.ny) - 1) / 2};
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// the launch. The shift and Chebyshev columns are (T,) vectors; nt ≤ 65535
// (the row is blockIdx.z of the tiled kernels). (nz, ny, nx, dim) is the
// grid of one row, nz = 1 and dim = 2 in 2-D, with fewer than 2^31 points;
// in the sharded-slab forms (mg_sh_*) it is the slab, the lead axis own +
// 2h planes (own for mg_sh_prolong_correct), and vm one row of it.
// The weighted ones take W
// (ntaps, *grid), the A taps (VarTaps) and the mass's weight groups
// (PairGroups, wa = 0).
extern "C" {

int mg_pairs_size() { return int(sizeof(PairGroups)); }
int mg_var_taps_size() { return int(sizeof(VarTaps)); }

// Blocks per SM and dynamic shared bytes of the 3-D K6 (post = 0, var =
// 0), K14 (0, 1), K7 (1, 0) or K15 (1, 1; row first 1, 2) at ν ∈ {2, 3},
// in float64 if f64 (else float32).
int mg_march_occupancy(int post, int var, int nu, int f64, int* blocks,
                       int* bytes) {
  if (nu < 2 || nu > 3) return int(cudaErrorInvalidValue);
  if (f64) {
    return (nu == 2 ? march_occupancy<2, double>
                    : march_occupancy<3, double>)(post, var, blocks, bytes);
  }
  return (nu == 2 ? march_occupancy<2, float> : march_occupancy<3, float>)(
      post, var, blocks, bytes);
}

// The same for the 2-D K6 (post = 0, var = 0), K14 (0, 1), K7 (1, 0) or
// K15 (1, 1) at ν ∈ {2, 3} on rows of nx columns, and the threads of its
// blocks and the segments of a row there (`row_plan`).
int mg_march2_occupancy(int post, int var, int nu, int f64, int nx,
                        int* blocks, int* bytes, int* threads, int* nseg) {
  if (nu < 2 || nu > 3 || nx < 1) return int(cudaErrorInvalidValue);
  if (f64) {
    return (nu == 2 ? march2_occupancy<2, double>
                    : march2_occupancy<3, double>)(post, var, nx, blocks,
                                                   bytes, threads, nseg);
  }
  return (nu == 2 ? march2_occupancy<2, float> : march2_occupancy<3, float>)(
      post, var, nx, blocks, bytes, threads, nseg);
}

// The same for K4 (res = 1) or K5 (res = 0) of dim on planes (rows in
// 2-D) of ny × nx points: blocks per SM, dynamic shared bytes, threads a
// block and blocks a chunk of the leading axis (`stencil_plan`).
int mg_stencil_occupancy(int res, int dim, int f64, int64_t ny, int64_t nx,
                         int* blocks, int* bytes, int* threads, int* tiles) {
  if (ny < 1 || nx < 1) return int(cudaErrorInvalidValue);
  const Grid g{1, int(ny), int(nx)};
  if (f64) {
    return BY_DIM(stencil_occupancy, double, res, g, blocks, bytes, threads,
                  tiles);
  }
  return BY_DIM(stencil_occupancy, float, res, g, blocks, bytes, threads,
                tiles);
}

// The same for the weighted march of dim in `mode` (0 K12, 1 K11, 2 a
// first K10 step from x, 3 from x = 0, 4 a later step, 5 the first two
// from x = 0) with n A taps on a
// grid of nz × ny × nx points (nz = 1 in 2-D): blocks per SM, dynamic
// shared bytes, threads a block and blocks a chunk of time rows.
int mg_var_stencil_occupancy(int mode, int dim, int f64, int n, int64_t nz,
                             int64_t ny, int64_t nx, int* blocks, int* bytes,
                             int* threads, int* tiles) {
  if (nz < 1 || ny < 1 || nx < 1 || nz * ny * nx >= (int64_t(1) << 31) ||
      (dim == 2 && nz != 1)) {
    return int(cudaErrorInvalidValue);
  }
  const Grid g{int(nz), int(ny), int(nx)};
  if (f64) {
    return BY_DIM(var_stencil_occupancy, double, mode, n, g, blocks, bytes,
                  threads, tiles);
  }
  return BY_DIM(var_stencil_occupancy, float, mode, n, g, blocks, bytes,
                threads, tiles);
}

#define MG_ENTRY_POINTS(T, SFX)                                               \
  int mg_smooth_##SFX(const T* x, const T* b, const T* omega, const T* invD,  \
                      const T* invT, const T* invDel, T* out, int64_t nt,     \
                      int64_t nz, int64_t ny, int64_t nx, int dim,            \
                      const PairGroups* pg, int nu, int zero_init,            \
                      void* stream) {                                         \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_smooth, T, x, b, nullptr, omega, invD, invT, invDel, \
                  out, nt, g, pg, nu, zero_init, stream);                     \
  }                                                                           \
  int mg_sh_smooth_##SFX(const T* x, const T* b, const T* vm, const T* omega, \
                         const T* invD, const T* invT, const T* invDel,       \
                         T* out, int64_t nt, int64_t nz, int64_t ny,          \
                         int64_t nx, int dim, const PairGroups* pg, int nu,   \
                         int zero_init, void* stream) {                       \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_smooth, T, x, b, vm, omega, invD, invT, invDel, out, \
                  nt, g, pg, nu, zero_init, stream);                          \
  }                                                                           \
  int mg_residual_##SFX(const T* x, const T* b, const T* omega, T* out,       \
                        int64_t nt, int64_t nz, int64_t ny, int64_t nx,       \
                        int dim, const PairGroups* pg, int chunk,             \
                        void* stream) {                                       \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_residual, T, x, b, omega, out, nt, g, pg, chunk,     \
                  stream);                                                    \
  }                                                                           \
  int mg_apply_##SFX(const T* x, T* out, int64_t nt, int64_t nz, int64_t ny,  \
                     int64_t nx, int dim, const PairGroups* pg, int chunk,    \
                     void* stream) {                                          \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_apply, T, x, out, nt, g, pg, chunk, stream);         \
  }                                                                           \
  int mg_fused_pre_##SFX(const T* b, const T* omega, const T* invD,           \
                         const T* invT, const T* invDel, T* xo, T* rco,       \
                         int64_t nt, int64_t nz, int64_t ny, int64_t nx,      \
                         int dim, const PairGroups* pg, int nu, int chunk,    \
                         void* stream) {                                      \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_fused_pre, T, b, nullptr, omega, invD, invT, invDel, \
                  xo, rco, nt, g, pg, nu, serial_lead_of(g, dim), chunk,      \
                  stream);                                                    \
  }                                                                           \
  int mg_sh_fused_pre_##SFX(const T* b, const T* vm, const T* omega,          \
                            const T* invD, const T* invT, const T* invDel,    \
                            T* xo, T* rco, int64_t nt, int64_t nz,            \
                            int64_t ny, int64_t nx, int dim,                  \
                            const PairGroups* pg, int nu, int own, int h,     \
                            int chunk, void* stream) {                        \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_fused_pre, T, b, vm, omega, invD, invT, invDel, xo,  \
                  rco, nt, g, pg, nu, Lead{h, 0, own / 2}, chunk, stream);    \
  }                                                                           \
  int mg_fused_post_##SFX(const T* x, const T* b, const T* ec,                \
                          const T* omega, const T* invD, const T* invT,       \
                          const T* invDel, T* out, int64_t nt, int64_t nz,    \
                          int64_t ny, int64_t nx, int dim,                    \
                          const PairGroups* pg, int nu, int chunk,            \
                          void* stream) {                                     \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_fused_post, T, x, b, ec, nullptr, omega, invD, invT, \
                  invDel, out, nt, g, pg, nu, serial_lead_of(g, dim), chunk,  \
                  stream);                                                    \
  }                                                                           \
  int mg_sh_fused_post_##SFX(const T* x, const T* b, const T* ec,             \
                             const T* vm, const T* omega, const T* invD,      \
                             const T* invT, const T* invDel, T* out,          \
                             int64_t nt, int64_t nz, int64_t ny, int64_t nx,  \
                             int dim, const PairGroups* pg, int nu, int own,  \
                             int h, int hc, int chunk, void* stream) {        \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_fused_post, T, x, b, ec, vm, omega, invD, invT,      \
                  invDel, out, nt, g, pg, nu,                                 \
                  Lead{0, 2 * hc - h, own / 2 + 2 * hc}, chunk, stream);      \
  }                                                                           \
  int mg_residual_restrict_##SFX(const T* x, const T* b, const T* omega,      \
                                 T* rc, int64_t nt, int64_t nz, int64_t ny,   \
                                 int64_t nx, int dim, const PairGroups* pg,   \
                                 void* stream) {                              \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_residual_restrict, T, x, b, omega, rc, nt, g, pg,    \
                  serial_lead_of(g, dim), stream);                            \
  }                                                                           \
  int mg_sh_residual_restrict_##SFX(const T* x, const T* b, const T* omega,   \
                                    T* rc, int64_t nt, int64_t nz,            \
                                    int64_t ny, int64_t nx, int dim,          \
                                    const PairGroups* pg, int own, int h,     \
                                    void* stream) {                           \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_residual_restrict, T, x, b, omega, rc, nt, g, pg,    \
                  Lead{h, 0, own / 2}, stream);                               \
  }                                                                           \
  int mg_prolong_correct_##SFX(const T* x, const T* ec, T* out, int64_t nt,   \
                               int64_t nz, int64_t ny, int64_t nx, int dim,   \
                               void* stream) {                                \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_prolong_correct, T, x, ec, out, nt, g,               \
                  serial_lead_of(g, dim), stream);                            \
  }                                                                           \
  int mg_sh_prolong_correct_##SFX(const T* x, const T* ec, T* out,            \
                                  int64_t nt, int64_t nz, int64_t ny,         \
                                  int64_t nx, int dim, int own, int hc,       \
                                  void* stream) {                             \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_prolong_correct, T, x, ec, out, nt, g,               \
                  Lead{0, 2 * hc, own / 2 + 2 * hc}, stream);                 \
  }                                                                           \
  int mg_smooth_var_##SFX(                                                    \
      const T* x, const T* b, const T* W, const T* omega, const T* invT,      \
      const T* invDel, T* r, const T* d_in, T* d_out, T* xo, int64_t nt,      \
      int64_t nz, int64_t ny, int64_t nx, int dim, const VarTaps* vt,         \
      const PairGroups* pm, int first, double c1, double c2, int last,        \
      int chunk, void* stream) {                                              \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_smooth_var, T, x, b, W, omega, invT, invDel, r,      \
                  d_in, d_out, xo, nt, g, vt, pm, first, c1, c2, last, chunk, \
                  stream);                                                    \
  }                                                                           \
  int mg_residual_var_##SFX(const T* x, const T* b, const T* W,               \
                            const T* omega, T* out, int64_t nt, int64_t nz,   \
                            int64_t ny, int64_t nx, int dim,                  \
                            const VarTaps* vt, const PairGroups* pm,          \
                            int chunk, void* stream) {                        \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_residual_var, T, x, b, W, omega, out, nt, g, vt, pm, \
                  chunk, stream);                                             \
  }                                                                           \
  int mg_apply_var_##SFX(const T* x, const T* W, T* out, int64_t nt,          \
                         int64_t nz, int64_t ny, int64_t nx, int dim,         \
                         const VarTaps* vt, int chunk, void* stream) {        \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_apply_var, T, x, W, out, nt, g, vt, chunk, stream);  \
  }                                                                           \
  int mg_residual_restrict_var_##SFX(                                         \
      const T* x, const T* b, const T* W, const T* omega, T* rc, int64_t nt,  \
      int64_t nz, int64_t ny, int64_t nx, int dim, const VarTaps* vt,         \
      const PairGroups* pm, void* stream) {                                   \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_residual_restrict_var, T, x, b, W, omega, rc, nt, g, \
                  vt, pm, stream);                                            \
  }                                                                           \
  int mg_fused_pre_var_##SFX(                                                 \
      const T* b, const T* W, const T* omega, const T* invT, const T* invDel, \
      T* xo, T* rco, int64_t nt, int64_t nz, int64_t ny, int64_t nx, int dim, \
      const VarTaps* vt, const PairGroups* pm, int nu, int chunk,             \
      void* stream) {                                                         \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_fused_pre_var, T, b, W, omega, invT, invDel, xo,     \
                  rco, nt, g, vt, pm, nu, chunk, stream);                     \
  }                                                                           \
  int mg_fused_post_var_##SFX(                                                \
      const T* x, const T* b, const T* ec, const T* W, const T* omega,        \
      const T* invT, const T* invDel, T* out, int64_t nt, int64_t nz,         \
      int64_t ny, int64_t nx, int dim, const VarTaps* vt,                     \
      const PairGroups* pm, int nu, int chunk, void* stream) {                \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_fused_post_var, T, x, b, ec, W, omega, invT, invDel, \
                  out, nt, g, vt, pm, nu, chunk, stream);                     \
  }                                                                           \
  int mg_cheb_step_##SFX(const T* x, const T* b, const T* vm,                \
                         const T* omega, const T* invD, const T* invT,        \
                         const T* invDel, T* r, const T* d_in, T* d_out,      \
                         T* xo, int64_t nt, int64_t nz, int64_t ny,           \
                         int64_t nx, int dim, const PairGroups* pg,           \
                         int first, double c1, double c2, void* stream) {     \
    const Grid g{int(nz), int(ny), int(nx)};                                  \
    return BY_DIM(launch_cheb_step, T, x, b, vm, omega, invD, invT, invDel,   \
                  r, d_in, d_out, xo, nt, g, pg, first, c1, c2, stream);      \
  }

MG_ENTRY_POINTS(float, f32)
MG_ENTRY_POINTS(double, f64)

#undef MG_ENTRY_POINTS
#undef BY_DIM

}  // extern "C"
