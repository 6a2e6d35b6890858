"""The space-time operator B, its adjoint Bᵀ and their stab-fused forms.

K1 ``apply_B`` / ``apply_B_stab`` and K2 ``apply_BT`` / ``apply_BT_stab``
replace the Pallas kernels ``_apply_B_call`` and ``_apply_BT_call`` of
``spacetime_tpu/ops/kron_pallas.py``:

    B:   out[j] = M(U[j+1]-U[j]) + h_j/2 · A(U[j+1]+U[j])          (T+1 -> T)
         stab: W[j] = h_j/16 · A(U[j+1]-U[j])
    Bᵀ:  out[i] = [i<T](-M V[i] + h_i/2 A V[i])
                + [i≥1](M V[i-1] + h_{i-1}/2 A V[i-1])               (T -> T+1)
         stab: out[i] += W[i-1] - W[i]   (W[-1] = W[T] = 0)

For a CUDA tensor each wrapper launches the CUDA kernel of csrc/kron.cu
(float32 and float64: the H100 has native f64, so the f64 residual legs of
the mixed-precision solve run the same kernels) and counts the launch; a
CPU tensor goes to the plain PyTorch twin of the same arithmetic; any other
device raises. The twins are also what the kernels are checked against.

The kernels march in time: a block owns a spatial tile (in 2-D ``PENCIL``
rows of y by the row, or a segment of it; in 3-D ``PENCIL`` planes of z by
8 × 32) and a chunk of consecutive output rows, which ``kron_plan`` picks
so that the launch takes the fewest waves of the blocks an SM holds.

``h_half`` and ``h_stab`` are the (T,) vectors h/2 and h/16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import native
from .mg_kernels import _sm_count, march2_chunk
from .stencil import grouped_apply, weight_groups


@dataclasses.dataclass(frozen=True)
class KronTaps:
    """The M and A stencils of one spatial grid, as weight groups."""

    gs: tuple[int, ...]
    groups_M: tuple
    groups_A: tuple

    @classmethod
    def from_stencils(cls, M_st, A_st, gs=None) -> "KronTaps":
        """From two ``ops.stencil.StencilOperator``s; ``gs``
        overrides the grid (the weights are translation invariant)."""
        if M_st.grid_shape != A_st.grid_shape:
            raise ValueError("M/A grid mismatch")
        return cls(
            tuple(gs if gs is not None else M_st.grid_shape),
            weight_groups(M_st.disps, M_st.weights),
            weight_groups(A_st.disps, A_st.weights),
        )

    @functools.cached_property
    def structs(self):
        dim = len(self.gs)
        if dim not in (2, 3):
            raise ValueError(f"grid {self.gs}: the kernels take 2-D and 3-D")
        return (
            native.taps_struct(self.groups_M, dim),
            native.taps_struct(self.groups_A, dim),
        )

    def zyx(self):
        return (1,) * (3 - len(self.gs)) + tuple(self.gs)


SOURCE = "spacetime_tpu_torch/csrc/kron.cu"
_B_REPLACES = "spacetime_tpu/ops/kron_pallas.py:290"
_BT_REPLACES = "spacetime_tpu/ops/kron_pallas.py:377"
Kernel = native.Kernel
KERNELS = {
    ("B", torch.float32): Kernel("K1 kron_B f32", "kron_B_f32", _B_REPLACES),
    ("B", torch.float64): Kernel("K1 kron_B f64", "kron_B_f64", _B_REPLACES),
    ("BT", torch.float32): Kernel("K2 kron_BT f32", "kron_BT_f32", _BT_REPLACES),
    ("BT", torch.float64): Kernel("K2 kron_BT f64", "kron_BT_f64", _BT_REPLACES),
}


# The points a block owns along the pencil axis (y in 2-D, z in 3-D), by
# kernel (Bᵀ or not), dimension and dtype: 4 or 8 (csrc/kron.cu
# instantiates those), chosen by timing on the H100 (PERF.md §6,
# ``tools.fused_ab --kron --pencils``).
PENCIL = {(False, 2, torch.float32): 8, (True, 2, torch.float32): 4,
          (False, 2, torch.float64): 4, (True, 2, torch.float64): 4,
          (False, 3, torch.float32): 8, (True, 3, torch.float32): 8,
          (False, 3, torch.float64): 4, (True, 3, torch.float64): 4}


@functools.lru_cache(maxsize=None)
def kron_occupancy(bt: bool, stab: bool, dtype, gs: tuple, pencil: int,
                   index: int) -> tuple[int, int, int, int]:
    """(blocks an SM of device ``index`` holds, shared bytes a block,
    threads a block, blocks a chunk of time rows) of K1 (K2 with ``bt``)
    on grid ``gs`` (csrc/kron.cu ``kron_occupancy``)."""
    lib = native.LIB.get()
    out = [ctypes.c_int() for _ in range(4)]
    zyx = (1,) * (3 - len(gs)) + tuple(gs)
    with torch.cuda.device(index):
        err = lib.kron_occupancy(int(bt), int(stab),
                                 int(dtype == torch.float64), len(gs),
                                 pencil, *zyx, *map(ctypes.byref, out))
    native.check(lib, "kron_occupancy", err)
    return tuple(o.value for o in out)


def kron_plan(bt: bool, stab: bool, dtype, gs: tuple, T: int,
              index: int) -> tuple[int, int]:
    """(pencil, chunk) of a K1 (K2 with ``bt``) launch on a (T, *gs)
    field: its ``PENCIL`` and the output rows a block marches
    through, of T (K1) or T + 1 (K2), by ``march2_chunk``'s rule (the
    fewest waves of the blocks an SM holds, a block walking chunk + 1
    rows, two blocks an SM where the rows allow it)."""
    pencil = PENCIL[(bool(bt), len(gs), dtype)]
    resident, _, _, tiles = kron_occupancy(bt, stab, dtype, tuple(gs), pencil,
                                           index)
    chunk = march2_chunk(tiles, T + int(bt), 1, max(resident, 1),
                         _sm_count(index), 1, 1)
    return pencil, chunk


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


# ------------------------------------------------------------ plain twins


def _col(h, dim):
    return h.reshape((h.shape[0],) + (1,) * dim)


def apply_B_plain(U, h_half, taps: KronTaps):
    gs, dim = taps.gs, len(taps.gs)
    DU = U[1:] - U[:-1]
    SU = U[1:] + U[:-1]
    return grouped_apply(taps.groups_M, gs, DU) + _col(h_half, dim) * (
        grouped_apply(taps.groups_A, gs, SU)
    )


def apply_B_stab_plain(U, h_half, h_stab, taps: KronTaps):
    gs, dim = taps.gs, len(taps.gs)
    DU = U[1:] - U[:-1]
    SU = U[1:] + U[:-1]
    out = grouped_apply(taps.groups_M, gs, DU) + _col(h_half, dim) * (
        grouped_apply(taps.groups_A, gs, SU)
    )
    W = _col(h_stab, dim) * grouped_apply(taps.groups_A, gs, DU)
    return out, W


def apply_BT_plain(V, h_half, taps: KronTaps):
    gs, dim = taps.gs, len(taps.gs)
    VM = grouped_apply(taps.groups_M, gs, V)
    VA = _col(h_half, dim) * grouped_apply(taps.groups_A, gs, V)
    out = V.new_zeros((V.shape[0] + 1,) + tuple(V.shape[1:]))
    out[:-1] = -VM + VA
    out[1:] += VM + VA
    return out


def apply_BT_stab_plain(V, W, h_half, taps: KronTaps):
    jump = W.new_zeros((W.shape[0] + 1,) + tuple(W.shape[1:]))
    jump[1:] = W
    jump[:-1] -= W
    return apply_BT_plain(V, h_half, taps) + jump


# ---------------------------------------------------------------- wrappers


def _launch_B(U, h_half, h_stab, taps: KronTaps, stab: bool):
    k = native.kernel_for(KERNELS, "kron", "B", U)
    T = U.shape[0] - 1
    if T < 1:
        raise ValueError("U needs at least two time rows")
    native.check_tensor("U", U, U.dtype, U.device, (T + 1,) + taps.gs)
    native.check_tensor("h_half", h_half, U.dtype, U.device, (T,))
    if stab:
        native.check_tensor("h_stab", h_stab, U.dtype, U.device, (T,))
    out = torch.empty((T,) + taps.gs, dtype=U.dtype, device=U.device)
    W = torch.empty_like(out) if stab else None
    tM, tA = taps.structs
    plan = kron_plan(False, stab, U.dtype, taps.gs, T, U.device.index)
    k.launch(
        U.device, U.data_ptr(), h_half.data_ptr(),
        h_stab.data_ptr() if stab else None,
        out.data_ptr(), W.data_ptr() if stab else None,
        T, *taps.zyx(), len(taps.gs), ctypes.addressof(tM),
        ctypes.addressof(tA), int(stab), *plan,
    )
    return (out, W) if stab else out


def _launch_BT(V, W, h_half, taps: KronTaps, stab: bool):
    k = native.kernel_for(KERNELS, "kron", "BT", V)
    T = V.shape[0]
    if T < 1:
        raise ValueError("V needs at least one time row")
    native.check_tensor("V", V, V.dtype, V.device, (T,) + taps.gs)
    native.check_tensor("h_half", h_half, V.dtype, V.device, (T,))
    if stab:
        native.check_tensor("W", W, V.dtype, V.device, (T,) + taps.gs)
    out = torch.empty((T + 1,) + taps.gs, dtype=V.dtype, device=V.device)
    tM, tA = taps.structs
    plan = kron_plan(True, stab, V.dtype, taps.gs, T, V.device.index)
    k.launch(
        V.device, V.data_ptr(), h_half.data_ptr(),
        W.data_ptr() if stab else None,
        out.data_ptr(), T, *taps.zyx(), len(taps.gs), ctypes.addressof(tM),
        ctypes.addressof(tA), int(stab), *plan,
    )
    return out


def apply_B(U, h_half, taps: KronTaps):
    """B·U: (T+1, *gs) -> (T, *gs)."""
    if U.device.type == "cpu":
        return apply_B_plain(U, h_half, taps)
    return _launch_B(U, h_half, None, taps, stab=False)


def apply_B_stab(U, h_half, h_stab, taps: KronTaps):
    """(B·U, W) with W[j] = h_j/16 · A(U[j+1]-U[j])."""
    if U.device.type == "cpu":
        return apply_B_stab_plain(U, h_half, h_stab, taps)
    return _launch_B(U, h_half, h_stab, taps, stab=True)


def apply_BT(V, h_half, taps: KronTaps):
    """Bᵀ·V: (T, *gs) -> (T+1, *gs)."""
    if V.device.type == "cpu":
        return apply_BT_plain(V, h_half, taps)
    return _launch_BT(V, None, h_half, taps, stab=False)


def apply_BT_stab(V, W, h_half, taps: KronTaps):
    """Bᵀ·V plus the stabilization jump W[i-1] - W[i]."""
    if V.device.type == "cpu":
        return apply_BT_stab_plain(V, W, h_half, taps)
    return _launch_BT(V, W, h_half, taps, stab=True)
