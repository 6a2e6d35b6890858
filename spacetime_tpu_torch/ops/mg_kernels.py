"""The multigrid V-cycle kernels: K3–K9 and the weighted K10–K15, on 2-D
and 3-D grids.

The counterpart of ``spacetime_tpu/ops/mg_pallas.py``. ``MSKernelLevel``
mirrors its ``MSPallasLevel`` for one multigrid level, Op = A + ω⊙M with one
shift per time row:

    K3 ``smooth``            degree-ν Chebyshev–Jacobi sweep
                             (``_smooth_call``), from x or from x = 0
                             (``zero_init``)
    K4 ``residual``          b − Op x (``_residual_call``)
    K5 ``apply_A``           A x, the stiffness stencil alone
                             (``_apply_stencil_call``)
    K6 ``fused_pre``         x = zero-init sweep on b, r_c = R(b − Op x)
                             (``_fused_pre_call``): returns (x, r_c)
    K7 ``fused_post``        smooth(x + P e_c, b) (``_fused_post_call``)
    K8 ``residual_restrict`` r_c = R(b − Op x) (``_residual_restrict_call``)
    K9 ``prolong_correct``   x + P e_c (``_prolong_correct_call``)

Every kernel takes 2-D and 3-D grids. The V-cycle runs the fused stages K6
→ (coarser levels) → K7 wherever ``fused_ok`` holds (ν = ν_post ∈ {2, 3}
and odd extents, as ``MSPallasLevel.fused_ok``), in 2-D and 3-D alike, and
the semi-fused stages K3 → K8 → (coarser levels) → K9 → K3 elsewhere
(V(ν, ν_post ≠ ν) cycles, ν ∉ {2, 3}). The tiled K3 holds ν ≤ 8 in 2-D
and ν ≤ 3 in 3-D (``MAX_NU``, its halo in shared memory); above that its
wrapper chains ν launches of a one-step kernel (``mg_cheb_step``) that
keeps r and d in device memory, so every ν ≥ 1 runs, as in the JAX
package. The fused stages keep ν ∈ {2, 3}, as JAX's do. In 3-D the fused
stages K6, K7, K14 and K15 march in z: a block owns a
``MARCH_TILE`` (y, x) tile of one row and a chunk of planes (coarse for
K6/K14, fine for K7/K15), whose depth the wrapper picks (``march_chunk``)
so that the launch fills the card. In 2-D K6, K7, K14 and K15 march in
y: a block owns a segment of a row's columns (the whole row where it
fits, csrc/mg.cu ``row_plan``) and a chunk of its rows (``march2_chunk``,
the same wave rule for the weighted pair with its own blocks an SM). K4
and K5 march too, in y (2-D: a segment of a row) and in z (3-D: a
``MARCH_TILE`` tile), with chunks by the same wave rule
(``stencil_chunk``). The weighted K10, K11 and K12 march in time: a
block owns a tile of rows (planes in 3-D) of the grid, holds its points'
weights on chip and walks a chunk of the time rows (``var_stencil_chunk``);
K10 runs a sweep as one-step launches of that march at every ν
(``chebyshev_launches``; from 0 the first two steps are one launch), r and
d in device memory.

For a CUDA tensor each wrapper launches the CUDA kernel of csrc/mg.cu
(float32 and float64) and counts the launch, with one count per kernel,
dtype and dimension; a CPU tensor goes to the plain PyTorch twin
``*_plain``, built from ``ops.multigrid``'s ``ms_op``, ``cheb_smooth`` and
``transfer`` (the XLA form of the JAX package); any other device raises. The
twins are also what the kernels are checked against. The per-row columns
(ω, 1/D, 1/θ, 1/δ) are (T,) vectors, ``MSKernelLevel.columns`` of a level's
row params.

``VarMSKernelLevel`` mirrors ``VarMSPallasLevel`` for one level of the
weighted (Galerkin) hierarchy, Op = A_w + ω⊙M with per-node A weights W
(ntaps, *gs) and the constant mass stencil; its Jacobi diagonal is per
node, 1/(W[center] + ω·c_M):

    K10 ``smooth``            degree-ν sweep (``_smooth_var_call``), from
                              x or from x = 0, as step launches
    K11 ``residual``          b − Op_w x (``_residual_var_call``)
    K12 ``apply_A``           A_w x (``_apply_var_call``)
    K13 ``residual_restrict`` r_c = R(b − Op_w x)
                              (``_residual_restrict_var_call``)
    K14 ``fused_pre``         x = zero-init sweep on b, r_c = R(b − Op_w x)
                              (``_fused_pre_var_call``)
    K15 ``fused_post``        smooth(x + P e_c, b)
                              (``_fused_post_var_call``)
    K9  ``prolong_correct``   x + P e_c, which does not depend on the
                              coefficients: the constant level's kernel

V(ν, ν_post ≠ ν) cycles and ν ∉ {2, 3} run the semi-fused stages K10 → K13
→ (coarser levels) → K9 → K10, every other level the fused K14/K15, in 2-D
and 3-D.

The sharded-slab forms, for a slab of the time×space mesh
(``parallel.explicit2d``): ``MSKernelLevel`` on the halo-extended slab's
grid (own + 2h planes on the leading axis, the other extents odd) holds

    K3 ``smooth(..., vmask=)``   the sweep with the slab's 0/1 validity
                                 field zeroing every update of r on padding
                                 and out-of-domain halo planes
    K6 ``sh_fused_pre``          ``lead=(own, h)``: x on the whole slab,
                                 r_c on the own/2 owned coarse planes
    K7 ``sh_fused_post``         ``lead=(own, h, hc)``: e_c with hc coarse
                                 halo planes, the output on the whole slab
    K8 ``sh_residual_restrict``  ``lead=(own, h)``: the owned coarse planes
    K9 ``sh_prolong_correct``    ``lead=(own, hc)``: x on the own planes

with the signatures of ``MSPallasLevel``'s (mg_pallas.py:544, 694-760) less
the banded transfer matrices (``Ux``/``Wx``, a device of the TPU's matrix
unit, not ported: the transfers are the pair sums of the serial forms, on
the lead axis offset as ``ops.multigrid.restrict_lead`` / ``prolong_lead``
say). The port has one layout, the unblocked one. Each is its own CUDA
entry point (``mg_sh_*``) with its own launch count; above the tiled ν the
vmask sweep chains ``mg_cheb_step`` with the field, counted there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import native
from .native import check_tensor
from .multigrid import (_SIGMA, cheb_smooth, chebyshev_steps, ms_op,
                        pair_groups, prolong_lead, restrict_lead, transfer,
                        var_op, var_smooth)
from .stencil import grouped_apply, weight_groups

SOURCE = "spacetime_tpu_torch/csrc/mg.cu"
# The tiled K3's halo: a tile grows by ν cells per side. 2-D tiles are
# 32 × 32; a 3-D brick of 8 × 8 × 32 with three float64 buffers fits the
# 227 KB of shared memory up to ν = 3. Above it the sweep is chained.
MAX_NU = {2: 8, 3: 3}
# The (y, x) tile of a block of the 3-D fused stages (csrc/mg.cu
# ``March``): its window plane grows by H cells a side, and it keeps 3R such
# planes in shared memory (K6/K14: H = R = ν + 1; K7/K15: H = R = ν).
MARCH_TILE = (16, 32)
# The fewest planes a block of the march walks: 2 coarse for K6/K14, 4
# fine for K7/K15 (4 fine planes either way; a chunk's ends are computed
# twice).
MARCH_LEAST = {"pre": 2, "post": 4}
MAX_ROWS = 65535  # the time row is blockIdx.z of the tiled kernels
MAX_ROW_POINTS = 2 ** 31  # in-row indices are 32-bit
_MG = "spacetime_tpu/ops/mg_pallas.py"
_OPS = {
    "smooth": ("K3 mg_smooth", f"{_MG}:190", (2, 3)),
    "residual": ("K4 mg_residual", f"{_MG}:316", (2, 3)),
    "apply": ("K5 mg_apply", f"{_MG}:375", (2, 3)),
    "fused_pre": ("K6 mg_fused_pre", f"{_MG}:1318", (2, 3)),
    "fused_post": ("K7 mg_fused_post", f"{_MG}:1475", (2, 3)),
    "residual_restrict": ("K8 mg_residual_restrict", f"{_MG}:1683", (2, 3)),
    "prolong_correct": ("K9 mg_prolong_correct", f"{_MG}:1913", (2, 3)),
    "smooth_var": ("K10 mg_smooth_var", f"{_MG}:856", (2, 3)),
    "residual_var": ("K11 mg_residual_var", f"{_MG}:956", (2, 3)),
    "apply_var": ("K12 mg_apply_var", f"{_MG}:1020", (2, 3)),
    "residual_restrict_var": ("K13 mg_residual_restrict_var", f"{_MG}:1822",
                              (2, 3)),
    "fused_pre_var": ("K14 mg_fused_pre_var", f"{_MG}:2071", (2, 3)),
    "fused_post_var": ("K15 mg_fused_post_var", f"{_MG}:2196", (2, 3)),
    # K3's chained sweep above MAX_NU, one Chebyshev step per launch
    "cheb_step": ("K3 mg_cheb_step", f"{_MG}:190", (2, 3)),
    # the sharded-slab forms (vmask, lead)
    "sh_smooth": ("K3 mg_sh_smooth", f"{_MG}:190", (2, 3)),
    "sh_fused_pre": ("K6 mg_sh_fused_pre", f"{_MG}:1318", (2, 3)),
    "sh_fused_post": ("K7 mg_sh_fused_post", f"{_MG}:1475", (2, 3)),
    "sh_residual_restrict": ("K8 mg_sh_residual_restrict", f"{_MG}:1683",
                             (2, 3)),
    "sh_prolong_correct": ("K9 mg_sh_prolong_correct", f"{_MG}:1913",
                           (2, 3)),
}
SHARDED_OPS = ("sh_smooth", "sh_fused_pre", "sh_fused_post",
               "sh_residual_restrict", "sh_prolong_correct")
KERNELS = {
    (op, dtype, dim): native.Kernel(
        f"{name}{'_3d' if dim == 3 else ''} {sfx}", f"mg_{op}_{sfx}", replaces)
    for op, (name, replaces, dims) in _OPS.items()
    for dim in dims
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64"))
}
# the row params' names of the kernels' columns
_LP_NAMES = {"omega": "omega", "invD": "inv_diag", "invT": "inv_theta",
             "invDel": "inv_delta"}
_VAR_LP_NAMES = {k: v for k, v in _LP_NAMES.items() if k != "invD"}


@functools.lru_cache(maxsize=None)
def march_chunk(T: int, gs: tuple, n: int, sms: int, least: int = 2) -> int:
    """Planes per block of the 3-D march on a (T, *gs) field whose lead
    axis its chunks cut into n planes (K6/K14: the nc coarse planes, K7/K15:
    the fine ones): every plane of the column, halved while the launch
    gives fewer than two blocks to each of the card's ``sms`` SMs, down to
    ``least`` (``MARCH_LEAST``: a block marches through ≥ 4 fine planes)."""
    tiles = -(-gs[1] // MARCH_TILE[0]) * -(-gs[2] // MARCH_TILE[1])
    chunk = max(n, 1)
    while chunk > least and T * tiles * -(-n // chunk) < 2 * sms:
        chunk = max(-(-chunk // 2), least)
    return chunk


@functools.lru_cache(maxsize=None)
def march2_chunk(blocks_per_chunk: int, n: int, least: int, resident: int,
                 sms: int, fine: int, extra: int) -> int:
    """Rows per block of the 2-D march whose chunks cut a column of n rows
    (K6: the nc coarse rows, ``fine`` = 2 fine rows each; K7: the fine
    rows, 1), ``blocks_per_chunk`` blocks (T times the segments) for each
    chunk: of the chunks down to ``least`` rows, the one whose launch
    takes least time when its blocks run in waves of ``resident`` an SM
    on ``sms`` SMs and a block walks fine·chunk + ``extra`` rows (K6 2ν +
    1, K7 2ν), among those that give each SM two blocks where any do.
    Timed on the H100 against half and twice its chunk (PERF.md §6,
    ``tools.fused_ab --chunks``)."""
    cap = resident * sms
    best = None
    for chunks in range(1, max(-(-n // least), 1) + 1):
        chunk = -(-max(n, 1) // chunks)
        blocks = blocks_per_chunk * -(-n // chunk) if n > 0 else blocks_per_chunk
        cost = -(-blocks // cap) * (fine * chunk + extra)
        key = (blocks < 2 * sms, cost, -chunk)
        best = min(best, (key, chunk)) if best else (key, chunk)
    return best[1]


@functools.lru_cache(maxsize=None)
def march2_plan(post: bool, var: bool, nu: int, dtype, nx: int,
                index: int) -> tuple[int, int]:
    """(blocks an SM of device ``index`` holds, segments a row) of the 2-D
    K6 (K7 with ``post``; K14 and K15 with ``var``) on rows of nx columns
    (csrc/mg.cu ``mg_march2_occupancy``: registers and shared memory,
    ``row_plan``)."""
    lib = native.LIB.get()
    out = [ctypes.c_int() for _ in range(4)]  # blocks, bytes, threads, nseg
    with torch.cuda.device(index):
        err = lib.mg_march2_occupancy(int(post), int(var), nu,
                                      int(dtype == torch.float64), nx,
                                      *map(ctypes.byref, out))
    native.check(lib, "mg_march2_occupancy", err)
    return max(out[0].value, 1), out[3].value


@functools.lru_cache(maxsize=None)
def stencil_plan(res: bool, dim: int, dtype, plane: tuple,
                 index: int) -> tuple[int, int]:
    """(blocks an SM of device ``index`` holds, blocks a chunk) of K4
    (K5 without ``res``) on planes (rows in 2-D) of ``plane`` = (ny, nx)
    points: the segments of a row in 2-D, the ``MARCH_TILE`` tiles of a
    plane in 3-D (csrc/mg.cu ``mg_stencil_occupancy``)."""
    lib = native.LIB.get()
    out = [ctypes.c_int() for _ in range(4)]  # blocks, bytes, threads, tiles
    with torch.cuda.device(index):
        err = lib.mg_stencil_occupancy(int(res), dim,
                                       int(dtype == torch.float64), *plane,
                                       *map(ctypes.byref, out))
    native.check(lib, "mg_stencil_occupancy", err)
    return max(out[0].value, 1), out[3].value


def stencil_chunk(T: int, n: int, resident: int, tiles: int,
                  sms: int) -> int:
    """Planes (rows in 2-D) per block of the K4 / K5 march on T rows of n
    planes, ``tiles`` blocks a chunk, ``resident`` blocks an SM: the wave
    rule of ``march2_chunk``, a block walking its chunk and the two planes
    around it."""
    return march2_chunk(T * tiles, n, 1, resident, sms, 1, 2)


# What a launch of the weighted time march computes (csrc/mg.cu
# ``VarMode``): K12, K11, K10's first step from x and from x = 0, a later
# K10 step, K10's first two steps from x = 0 in one launch
VAR_MODES = {"apply": 0, "residual": 1, "first": 2, "first_zero": 3,
             "step": 4, "first_two": 5}
# the ``first`` argument of K10's entry point for each of its modes
_VAR_FIRST = {"first": 1, "first_zero": 1, "first_two": 2, "step": 0}


def var_row_fields(mode: str, last: bool = False) -> int:
    """The fields a point moves in one time row of the march in ``mode``
    (each read or written once): K12 x and the output, K11 x, b and the
    output; a K10 step as ``dia_kernels.ROW_FIELDS`` counts K16's (from x
    5, from 0 4, a later step 6; the first two from 0 4: b, r, d and x),
    two fewer (r and d_out unwritten) in a sweep's ``last`` step."""
    fields = {"apply": 2, "residual": 3, "first": 5, "first_zero": 4,
              "step": 6, "first_two": 4}[mode]
    return fields - 2 * (last and mode not in ("apply", "residual"))


def var_held(mode: str, ntaps: int) -> int:
    """The values a point of the march holds for a chunk: its ``ntaps``
    weights, and W[kc] beside them in a K10 step (that alone from 0; at
    its own points and along its window column in the first two from
    0)."""
    return {"apply": ntaps, "residual": ntaps, "first_zero": 1,
            "first_two": ntaps + 2}.get(mode, ntaps + 1)


@functools.lru_cache(maxsize=None)
def var_stencil_plan(mode: str, dim: int, dtype, ntaps: int, gs: tuple,
                     index: int) -> tuple[int, int, int, int]:
    """(blocks an SM of device ``index`` holds, blocks a chunk of time
    rows, dynamic shared bytes, threads a block) of the weighted march in
    ``mode`` (``VAR_MODES``) with ``ntaps`` A taps on grid ``gs``: its
    tiles and pencils, the weights held in registers or in the shared tile
    by the tap count (csrc/mg.cu ``mg_var_stencil_occupancy``)."""
    lib = native.LIB.get()
    out = [ctypes.c_int() for _ in range(4)]  # blocks, bytes, threads, tiles
    zyx = (1,) * (3 - len(gs)) + tuple(gs)
    with torch.cuda.device(index):
        err = lib.mg_var_stencil_occupancy(VAR_MODES[mode], len(gs),
                                           int(dtype == torch.float64), ntaps,
                                           *zyx, *map(ctypes.byref, out))
    native.check(lib, "mg_var_stencil_occupancy", err)
    return max(out[0].value, 1), out[3].value, out[1].value, out[2].value


def var_stencil_chunk(T: int, mode: str, ntaps: int, resident: int,
                      tiles: int, sms: int, last: bool = False) -> int:
    """Time rows per block of the weighted march in ``mode`` on T rows,
    ``tiles`` blocks a chunk, ``resident`` blocks an SM: the wave rule of
    ``march2_chunk``, the held values' load (``var_held``, once a chunk)
    counted as the rows whose fields (``var_row_fields``) move as many
    bytes, as ``dia_kernels.dia_chunk`` counts the DIA values."""
    return march2_chunk(tiles, T, 1, resident, sms, 1,
                        -(-var_held(mode, ntaps)
                          // var_row_fields(mode, last)))


def chebyshev_launches(step, nu: int, zero_init: bool,
                       first_two: bool = False) -> None:
    """A sweep's one-step launches (K10, K16) as calls ``step(mode, d_in,
    d_out, c1, c2, last)``: the first step (``mode`` "first" or
    "first_zero") and ν − 1 later ones ("step"), each reading d from slot
    ``d_in`` of two (None for the first) and writing slot ``d_out``, the
    recurrence's scalars c1, c2, ``last`` on the sweep's last launch. With
    ``first_two`` a sweep from 0 of ν ≥ 2 starts with one launch of its
    first two steps ("first_two", the second's scalars), then ν − 2 later
    ones."""
    if nu < 1:
        raise ValueError(f"nu={nu}: a sweep takes at least one step")
    steps = chebyshev_steps(_SIGMA, nu)
    start = 1
    if zero_init and first_two and steps:
        step("first_two", None, 1, *steps[0], len(steps) == 1)
        start = 2
    else:
        step("first_zero" if zero_init else "first", None, 0, 0.0, 0.0,
             not steps)
    for s in range(start, len(steps) + 1):
        step("step", (s - 1) % 2, s % 2, *steps[s - 1], s == len(steps))


def k10_launches(nu: int, zero_init: bool) -> int:
    """K10's launches for a sweep of ν steps (``chebyshev_launches`` with
    its first two steps from 0 in one launch)."""
    return nu - 1 if zero_init and nu >= 2 else nu


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


class _KernelLevel:
    """What the constant and the weighted kernel levels share: the grid,
    ν, the stage gates and the checks before a launch."""

    _COLS: dict  # the kernels' columns -> the row params' names
    _VAR = False  # the weighted kernels (K10–K15)

    def __init__(self, gs, nu: int, nu_post: int | None):
        self.gs = tuple(gs)
        self.dim = len(self.gs)
        if self.dim not in (2, 3):
            raise ValueError(f"grid {self.gs}: the kernels take 2-D and 3-D")
        self.nu = nu
        self.nu_post = nu if nu_post is None else nu_post

    @classmethod
    def columns(cls, lp) -> dict:
        """The per-row columns of a level's row params as (T,) views."""
        return {k: lp[name].reshape(-1) for k, name in cls._COLS.items()}

    @property
    def fused_ok(self) -> bool:
        """The fused stages bake one ν ∈ {2, 3} (as
        ``MSPallasLevel.fused_ok``; the Pallas slab-alignment clause has no
        counterpart here) and need odd extents, as the semi-fused ones do;
        2-D and 3-D."""
        return self.semi_ok and self.nu_post == self.nu and 2 <= self.nu <= 3

    @property
    def semi_ok(self) -> bool:
        """The transfer stages need odd extents 2n+1."""
        return all(n % 2 for n in self.gs)

    @property
    def coarse_gs(self):
        return tuple((n - 1) // 2 for n in self.gs)

    def _lp(self, cols):
        """The (T,) columns as the (T, 1, ..., 1) row params of
        ``ops.multigrid``."""
        col = (-1,) + (1,) * self.dim
        return {self._COLS[k]: v.reshape(col) for k, v in cols.items()}

    def _prepare(self, op, X, cols, odd=False, gs=None):
        """Check the main field (on ``gs``, else the level's grid) and the
        columns; returns the kernel, T and the columns' pointers in
        ``_COLS`` order. ``odd``: the transfers' odd extents, "lead" for a
        slab's (every axis but the leading one)."""
        gs = self.gs if gs is None else gs
        k = native.kernel_for(KERNELS, "mg", op, X, self.dim)
        T = X.shape[0]
        if not 1 <= T <= MAX_ROWS:
            raise ValueError(f"{T} time rows; the kernels take 1 to {MAX_ROWS}")
        check_tensor("field", X, X.dtype, X.device, (T,) + gs)
        if math.prod(gs) >= MAX_ROW_POINTS:
            raise ValueError(f"grid {gs}: a time row of the kernels "
                             f"holds fewer than {MAX_ROW_POINTS} points")
        if odd == "lead" and not all(n % 2 for n in gs[1:]):
            raise ValueError(f"slab {gs}: the sharded transfer stages need "
                             "odd extents 2n+1 off the leading axis")
        if odd is True and not self.semi_ok:
            raise ValueError(f"grid {self.gs}: the transfer stages need odd "
                             "extents 2n+1")
        if cols is None:
            return k, T, ()
        for name in self._COLS:
            check_tensor(name, cols[name], X.dtype, X.device, (T,))
        return k, T, tuple(cols[name].data_ptr() for name in self._COLS)

    def residual_restrict_plain(self, x, b, *args):
        """R(b − Op x); ``args`` are the level's own after ``b``."""
        return transfer(self.residual_plain(x, b, *args), self.dim,
                        restrict=True)

    def prolong_correct_plain(self, x, ec):
        return x + transfer(ec, self.dim, restrict=False)

    def prolong_correct(self, x, ec):
        """K9: x + P e_c; the prolonged correction is never stored."""
        if x.device.type == "cpu":
            return self.prolong_correct_plain(x, ec)
        k, T, _ = self._prepare("prolong_correct", x, None, odd=True)
        check_tensor("ec", ec, x.dtype, x.device, (T,) + self.coarse_gs)
        out = torch.empty_like(x)
        k.launch(x.device, x.data_ptr(), ec.data_ptr(), out.data_ptr(), T,
                 *self._zyx())
        return out

    def _zyx(self):
        """(nz, ny, nx, dim): the grid as the kernels take it (nz = 1 in
        2-D)."""
        return (1,) * (3 - self.dim) + self.gs + (self.dim,)

    def _chunk(self, b, n: int, stage: str = "pre") -> int:
        """The planes (rows in 2-D) a block of the march of the fused
        stages on field ``b`` walks through: of the nc coarse ones on the
        lead axis (K6/K14, ``stage="pre"``) or of the fine ones (K7/K15,
        "post"); in 3-D by ``march_chunk``, in 2-D by ``march2_chunk``."""
        index = b.device.index
        if self.dim == 3:
            return march_chunk(b.shape[0], self.gs, n, _sm_count(index),
                               MARCH_LEAST[stage])
        pre = stage == "pre"
        resident, nseg = march2_plan(not pre, self._VAR, self.nu, b.dtype,
                                     self.gs[1], index)
        return march2_chunk(b.shape[0] * nseg, n, MARCH_LEAST[stage],
                            resident, _sm_count(index), 2 if pre else 1,
                            2 * self.nu + pre)


class MSKernelLevel(_KernelLevel):
    """K3–K9 for one multigrid level on a 2-D or 3-D grid; ``gs``
    overrides the stencils' grid (the weights are translation invariant).
    Its columns are ω, 1/D, 1/θ, 1/δ (``ops.multigrid.row_params``)."""

    _COLS = _LP_NAMES

    def __init__(self, A_st, M_st, nu: int, nu_post: int | None = None,
                 gs=None):
        super().__init__(gs if gs is not None else A_st.grid_shape, nu,
                         nu_post)
        self.groups_A = weight_groups(A_st.disps, A_st.weights)
        self.pairs = pair_groups(
            self.groups_A, weight_groups(M_st.disps, M_st.weights)
        )

    @functools.cached_property
    def structs(self):
        """The pair tables of Op and of A alone (every wM = 0)."""
        return (
            native.pair_groups_struct(self.pairs, self.dim),
            native.pair_groups_struct(pair_groups(self.groups_A, ()), self.dim),
        )

    # ------------------------------------------------------------ twins

    def op_plain(self, x, cols):
        return ms_op(self.pairs, self.gs, self._lp(cols)["omega"], x)

    def smooth_plain(self, x, b, cols, zero_init=False, post=False,
                     vmask=None):
        lp = self._lp(cols)
        return cheb_smooth(
            lambda v: ms_op(self.pairs, self.gs, lp["omega"], v), lp,
            b * 0.0 if zero_init else x, b, self.nu_post if post else self.nu,
            vmask,
        )

    def residual_plain(self, x, b, cols):
        return b - self.op_plain(x, cols)

    def apply_A_plain(self, x):
        return grouped_apply(self.groups_A, self.gs, x)

    def fused_pre_plain(self, b, cols):
        x = self.smooth_plain(None, b, cols, zero_init=True)
        return x, self.residual_restrict_plain(x, b, cols)

    def fused_post_plain(self, x, b, ec, cols):
        return self.smooth_plain(self.prolong_correct_plain(x, ec), b, cols)

    # the sharded-slab forms: the level's grid is the slab, own + 2h planes
    # on the leading axis

    def sh_residual_restrict_plain(self, x, b, cols, own, h):
        return restrict_lead(self.residual_plain(x, b, cols), self.dim, own,
                             h)

    def sh_prolong_correct_plain(self, x, ec, own, hc):
        return x + prolong_lead(ec, self.dim, own, 2 * hc)

    def sh_fused_pre_plain(self, b, cols, vmask, own, h):
        x = self.smooth_plain(None, b, cols, zero_init=True, vmask=vmask)
        return x, self.sh_residual_restrict_plain(x, b, cols, own, h)

    def sh_fused_post_plain(self, x, b, ec, cols, vmask, own, h, hc):
        xc = x + prolong_lead(ec, self.dim, self.gs[0], 2 * hc - h)
        return self.smooth_plain(xc, b, cols, vmask=vmask)

    # --------------------------------------------------------- wrappers

    def _sweep(self, op, x, b, nu, zero_init, pre, cols, tables, step):
        """K3: the tiled sweep ``op`` for ν ≤ MAX_NU, else ν chained
        launches of the one-step kernel ``step`` (op, fields). ``pre`` are
        the fields between b and the columns (the validity field of the
        slab form), ``tables`` the kernel's tables."""
        if nu < 1:
            raise ValueError(f"nu={nu}: a sweep takes at least one step")
        chained = nu > MAX_NU[self.dim]
        if chained:
            op, pre = step
        k, T, cp = self._prepare(op, b, cols)
        if not zero_init:
            check_tensor("x", x, b.dtype, b.device, b.shape)
        xp = None if zero_init else x.data_ptr()
        out = torch.empty_like(b)
        if not chained:
            k.launch(b.device, xp, b.data_ptr(), *pre, *cp, out.data_ptr(),
                     T, *self._zyx(), *tables, nu, int(zero_init))
            return out
        r, d = torch.empty_like(b), (torch.empty_like(b), torch.empty_like(b))

        def chain(mode, d_in, d_out, c1, c2, last):
            first = mode != "step"
            k.launch(b.device, xp if first else None, b.data_ptr(), *pre,
                     *cp, r.data_ptr(),
                     None if d_in is None else d[d_in].data_ptr(),
                     d[d_out].data_ptr(), out.data_ptr(), T, *self._zyx(),
                     *tables, int(first), c1, c2)

        chebyshev_launches(chain, nu, zero_init)
        return out

    def smooth(self, x, b, cols, zero_init=False, post=False, vmask=None):
        """K3: the degree-ν sweep (ν_post with ``post``); x is ignored with
        ``zero_init``. ``vmask``: a slab's (1, *gs) 0/1 validity field (the
        sharded form, ``mg_sh_smooth``)."""
        if b.device.type == "cpu":
            return self.smooth_plain(x, b, cols, zero_init, post, vmask)
        nu = self.nu_post if post else self.nu
        if vmask is None:
            return self._sweep("smooth", x, b, nu, zero_init, (), cols,
                               (self._op_table(),),
                               step=("cheb_step", (None,)))
        self._check_vmask(vmask, b)
        vm = (vmask.data_ptr(),)
        return self._sweep("sh_smooth", x, b, nu, zero_init, vm, cols,
                           (self._op_table(),), step=("cheb_step", vm))

    def residual(self, x, b, cols):
        """K4: b − Op x."""
        if b.device.type == "cpu":
            return self.residual_plain(x, b, cols)
        k, T, cp = self._prepare("residual", b, cols)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), cp[0],
                 out.data_ptr(), T, *self._zyx(), self._op_table(),
                 self._stencil_chunk(b, True))
        return out

    def apply_A(self, x):
        """K5: the stiffness stencil A x (the middle of the K_X sandwich)."""
        if x.device.type == "cpu":
            return self.apply_A_plain(x)
        k, T, _ = self._prepare("apply", x, None)
        out = torch.empty_like(x)
        k.launch(x.device, x.data_ptr(), out.data_ptr(), T, *self._zyx(),
                 ctypes.addressof(self.structs[1]),
                 self._stencil_chunk(x, False))
        return out

    def _stencil_chunk(self, X, res: bool) -> int:
        """The planes (rows in 2-D) a block of K4 (``res``) or K5 on field
        X walks through (``stencil_chunk``)."""
        index = X.device.index
        resident, tiles = stencil_plan(res, self.dim, X.dtype, self.gs[-2:],
                                       index)
        return stencil_chunk(X.shape[0], self.gs[0], resident, tiles,
                             _sm_count(index))

    def fused_pre(self, b, cols):
        """K6: (x, r_c), x the zero-init sweep on b and r_c = R(b − Op x)."""
        if b.device.type == "cpu":
            return self.fused_pre_plain(b, cols)
        k, T, cp = self._prepare("fused_pre", b, cols, odd=True)
        x = torch.empty_like(b)
        rc = b.new_empty((T,) + self.coarse_gs)
        k.launch(b.device, b.data_ptr(), *cp, x.data_ptr(),
                 rc.data_ptr(), T, *self._zyx(), self._op_table(), self.nu,
                 self._chunk(b, self.coarse_gs[0]))
        return x, rc

    def fused_post(self, x, b, ec, cols):
        """K7: smooth(x + P e_c, b)."""
        if b.device.type == "cpu":
            return self.fused_post_plain(x, b, ec, cols)
        k, T, cp = self._prepare("fused_post", b, cols, odd=True)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        check_tensor("ec", ec, b.dtype, b.device, (T,) + self.coarse_gs)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), ec.data_ptr(),
                 *cp, out.data_ptr(), T, *self._zyx(), self._op_table(),
                 self.nu, self._chunk(b, self.gs[0], "post"))
        return out

    def residual_restrict(self, x, b, cols):
        """K8: r_c = R(b − Op x); the fine residual is never stored."""
        if b.device.type == "cpu":
            return self.residual_restrict_plain(x, b, cols)
        k, T, cp = self._prepare("residual_restrict", b, cols, odd=True)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        rc = b.new_empty((T,) + self.coarse_gs)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), cp[0], rc.data_ptr(),
                 T, *self._zyx(), self._op_table())
        return rc

    def _op_table(self):
        return ctypes.addressof(self.structs[0])

    def _check_vmask(self, vmask, X) -> None:
        check_tensor("vmask", vmask, X.dtype, X.device, (1,) + self.gs)

    def _check_lead(self, own: int, h: int, min_h: int) -> None:
        if own % 2 or own < 2 or self.gs[0] != own + 2 * h or h < min_h:
            raise ValueError(
                f"slab {self.gs}, lead=(own={own}, h={h}): the sharded "
                f"forms take an even own >= 2, h >= {min_h} and "
                "gs[0] == own + 2h")

    def _coarse_lead(self, nc: int):
        return (nc,) + self.coarse_gs[1:]

    def sh_fused_pre(self, b, cols, vmask, own: int, h: int):
        """K6, ``lead=(own, h)``: (x, r_c) with x the zero-init sweep on the
        whole slab (its edge planes are the caller's to crop) and r_c the
        own/2 owned coarse planes of R(b − Op x); h ≥ ν + 1."""
        if b.device.type == "cpu":
            return self.sh_fused_pre_plain(b, cols, vmask, own, h)
        self._check_lead(own, h, self.nu + 1)
        self._check_fused()
        k, T, cp = self._prepare("sh_fused_pre", b, cols, odd="lead")
        self._check_vmask(vmask, b)
        x = torch.empty_like(b)
        rc = b.new_empty((T,) + self._coarse_lead(own // 2))
        k.launch(b.device, b.data_ptr(), vmask.data_ptr(), *cp, x.data_ptr(),
                 rc.data_ptr(), T, *self._zyx(), self._op_table(), self.nu,
                 own, h, self._chunk(b, own // 2))
        return x, rc

    def sh_fused_post(self, x, b, ec, cols, vmask, own: int, h: int,
                      hc: int):
        """K7, ``lead=(own, h, hc)``: smooth(x + P e_c, b) on the whole
        slab, e_c with hc coarse halo planes (2hc ≥ h + 1); h ≥ ν."""
        if b.device.type == "cpu":
            return self.sh_fused_post_plain(x, b, ec, cols, vmask, own, h, hc)
        self._check_lead(own, h, self.nu)
        self._check_fused()
        if 2 * hc < h + 1:
            raise ValueError(f"hc={hc}: the coarse halo needs 2hc >= h + 1")
        k, T, cp = self._prepare("sh_fused_post", b, cols, odd="lead")
        check_tensor("x", x, b.dtype, b.device, b.shape)
        check_tensor("ec", ec, b.dtype, b.device,
                     (T,) + self._coarse_lead(own // 2 + 2 * hc))
        self._check_vmask(vmask, b)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), ec.data_ptr(),
                 vmask.data_ptr(), *cp, out.data_ptr(), T, *self._zyx(),
                 self._op_table(), self.nu, own, h, hc,
                 self._chunk(b, self.gs[0], "post"))
        return out

    def sh_residual_restrict(self, x, b, cols, own: int, h: int):
        """K8, ``lead=(own, h)``: the own/2 owned coarse planes of
        R(b − Op x) on the slab; h ≥ 2."""
        if b.device.type == "cpu":
            return self.sh_residual_restrict_plain(x, b, cols, own, h)
        self._check_lead(own, h, 2)
        k, T, cp = self._prepare("sh_residual_restrict", b, cols, odd="lead")
        check_tensor("x", x, b.dtype, b.device, b.shape)
        rc = b.new_empty((T,) + self._coarse_lead(own // 2))
        k.launch(b.device, x.data_ptr(), b.data_ptr(), cp[0], rc.data_ptr(),
                 T, *self._zyx(), self._op_table(), own, h)
        return rc

    def sh_prolong_correct(self, x, ec, own: int, hc: int):
        """K9, ``lead=(own, hc)``: x + P e_c on the own planes (x unhaloed),
        e_c with hc ≥ 1 coarse halo planes."""
        if x.device.type == "cpu":
            return self.sh_prolong_correct_plain(x, ec, own, hc)
        gs = (own,) + self.gs[1:]
        if own % 2 or own < 2 or hc < 1:
            raise ValueError(f"lead=(own={own}, hc={hc}): the sharded K9 "
                             "takes an even own >= 2 and hc >= 1")
        k, T, _ = self._prepare("sh_prolong_correct", x, None, odd="lead",
                                gs=gs)
        check_tensor("ec", ec, x.dtype, x.device,
                     (T,) + self._coarse_lead(own // 2 + 2 * hc))
        out = torch.empty_like(x)
        k.launch(x.device, x.data_ptr(), ec.data_ptr(), out.data_ptr(), T,
                 *((1,) * (3 - self.dim) + gs + (self.dim,)), own, hc)
        return out

    def _check_fused(self) -> None:
        if not (self.nu_post == self.nu and 2 <= self.nu <= 3):
            raise ValueError(f"nu={self.nu}, nu_post={self.nu_post}: the "
                             "fused stages bake one nu in {2, 3}")


class VarMSKernelLevel(_KernelLevel):
    """K10–K15 (and K9) for one level ``lev`` of a
    ``GalerkinMultiShiftMultigrid`` on a 2-D or 3-D grid; ``gs`` overrides
    the level's grid (the kernels take the weights W per call, of shape
    (ntaps, *gs)). Its columns are ω, 1/θ, 1/δ (``var_row_params``, the
    exact per-ω Gershgorin bounds of ``mg_pallas.py:1128-1148``)."""

    _COLS = _VAR_LP_NAMES
    _VAR = True

    def __init__(self, lev, nu: int, nu_post: int | None = None, gs=None):
        super().__init__(gs if gs is not None else lev.gs, nu, nu_post)
        self.A_vs = dataclasses.replace(lev.A_vs, grid_shape=self.gs)
        self.kc = lev.kc
        self.cM = lev.cM
        self.groups_M = weight_groups(lev.M_st.disps, lev.M_st.weights)

    @functools.cached_property
    def structs(self):
        """The A taps' table and the mass's weight groups (as pair groups
        with every wA = 0)."""
        return (
            native.var_taps_struct(self.A_vs.disps, self.kc, self.cM,
                                   self.dim),
            native.pair_groups_struct(
                tuple(((0.0, w), ds) for w, ds in self.groups_M), self.dim),
        )

    # ------------------------------------------------------------ twins

    def _vlp(self, cols, W):
        return dict(self._lp(cols), Aw=W)

    def op_plain(self, x, cols, W):
        return var_op(self.A_vs, self.groups_M, self._vlp(cols, W), x)

    def smooth_plain(self, x, b, cols, W, zero_init=False, post=False):
        return var_smooth(self.A_vs, self.groups_M, self.kc, self.cM,
                          self._vlp(cols, W), None if zero_init else x, b,
                          self.nu_post if post else self.nu)

    def residual_plain(self, x, b, cols, W):
        return b - self.op_plain(x, cols, W)

    def apply_A_plain(self, x, W):
        return self.A_vs.apply(x, W)

    def fused_pre_plain(self, b, cols, W):
        x = self.smooth_plain(None, b, cols, W, zero_init=True)
        return x, self.residual_restrict_plain(x, b, cols, W)

    def fused_post_plain(self, x, b, ec, cols, W):
        return self.smooth_plain(self.prolong_correct_plain(x, ec), b, cols,
                                 W)

    # --------------------------------------------------------- wrappers

    def smooth(self, x, b, cols, W, zero_init=False, post=False):
        """K10: the degree-ν sweep (ν_post with ``post``) as one-step
        launches of the time march (``chebyshev_launches``; from 0 the
        first two steps are one launch); x is ignored with ``zero_init``.
        The last launch writes the output alone."""
        if b.device.type == "cpu":
            return self.smooth_plain(x, b, cols, W, zero_init, post)
        nu = self.nu_post if post else self.nu
        k, T, cp = self._prepare("smooth_var", b, cols)
        self._check_W(W, b)
        if not zero_init:
            check_tensor("x", x, b.dtype, b.device, b.shape)
        out, r = torch.empty_like(b), torch.empty_like(b)
        d = (torch.empty_like(b), torch.empty_like(b))

        def step(mode, d_in, d_out, c1, c2, last):
            k.launch(b.device, x.data_ptr() if mode == "first" else None,
                     b.data_ptr(), W.data_ptr(), *cp, r.data_ptr(),
                     None if d_in is None else d[d_in].data_ptr(),
                     d[d_out].data_ptr(), out.data_ptr(), T, *self._zyx(),
                     *self._tables(), _VAR_FIRST[mode], c1, c2, int(last),
                     self._var_stencil_chunk(b, mode, last))

        chebyshev_launches(step, nu, zero_init, first_two=True)
        return out

    def residual(self, x, b, cols, W):
        """K11: b − (A_w x + ω⊙M x)."""
        if b.device.type == "cpu":
            return self.residual_plain(x, b, cols, W)
        k, T, cp = self._prepare("residual_var", b, cols)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        self._check_W(W, b)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), W.data_ptr(), cp[0],
                 out.data_ptr(), T, *self._zyx(), *self._tables(),
                 self._var_stencil_chunk(b, "residual"))
        return out

    def apply_A(self, x, W):
        """K12: A_w x (the middle of the K_X sandwich, and the A_w of B,
        Bᵀ and the stab term)."""
        if x.device.type == "cpu":
            return self.apply_A_plain(x, W)
        k, T, _ = self._prepare("apply_var", x, None)
        self._check_W(W, x)
        out = torch.empty_like(x)
        k.launch(x.device, x.data_ptr(), W.data_ptr(), out.data_ptr(), T,
                 *self._zyx(), self._tables()[0],
                 self._var_stencil_chunk(x, "apply"))
        return out

    def _var_stencil_chunk(self, X, mode: str, last: bool = False) -> int:
        """The time rows a block of the weighted march in ``mode`` (K10's
        ``last`` step) on field X walks through (``var_stencil_chunk``)."""
        index, ntaps = X.device.index, len(self.A_vs.disps)
        resident, tiles, _, _ = var_stencil_plan(mode, self.dim, X.dtype,
                                                 ntaps, self.gs, index)
        return var_stencil_chunk(X.shape[0], mode, ntaps, resident, tiles,
                                 _sm_count(index), last)

    def residual_restrict(self, x, b, cols, W):
        """K13: r_c = R(b − Op_w x); the fine residual is never stored."""
        if b.device.type == "cpu":
            return self.residual_restrict_plain(x, b, cols, W)
        k, T, cp = self._prepare("residual_restrict_var", b, cols, odd=True)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        self._check_W(W, b)
        rc = b.new_empty((T,) + self.coarse_gs)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), W.data_ptr(), cp[0],
                 rc.data_ptr(), T, *self._zyx(), *self._tables())
        return rc

    def fused_pre(self, b, cols, W):
        """K14: (x, r_c), x the zero-init sweep on b and
        r_c = R(b − Op_w x)."""
        if b.device.type == "cpu":
            return self.fused_pre_plain(b, cols, W)
        k, T, cp = self._prepare("fused_pre_var", b, cols, odd=True)
        self._check_W(W, b)
        x = torch.empty_like(b)
        rc = b.new_empty((T,) + self.coarse_gs)
        k.launch(b.device, b.data_ptr(), W.data_ptr(), *cp, x.data_ptr(),
                 rc.data_ptr(), T, *self._zyx(), *self._tables(), self.nu,
                 self._chunk(b, self.coarse_gs[0]))
        return x, rc

    def fused_post(self, x, b, ec, cols, W):
        """K15: smooth(x + P e_c, b)."""
        if b.device.type == "cpu":
            return self.fused_post_plain(x, b, ec, cols, W)
        k, T, cp = self._prepare("fused_post_var", b, cols, odd=True)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        check_tensor("ec", ec, b.dtype, b.device, (T,) + self.coarse_gs)
        self._check_W(W, b)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), ec.data_ptr(),
                 W.data_ptr(), *cp, out.data_ptr(), T, *self._zyx(),
                 *self._tables(), self.nu,
                 self._chunk(b, self.gs[0], "post"))
        return out

    def _check_W(self, W, X) -> None:
        check_tensor("W", W, X.dtype, X.device,
                     (len(self.A_vs.disps),) + self.gs)

    def _tables(self):
        return tuple(ctypes.addressof(st) for st in self.structs)
