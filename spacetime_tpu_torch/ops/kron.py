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

``h_half`` and ``h_stab`` are the (T,) vectors h/2 and h/16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import native
from .stencil import grouped_apply, weight_groups


@dataclasses.dataclass(frozen=True)
class KronTaps:
    """The M and A stencils of one spatial grid, as weight groups."""

    gs: tuple[int, ...]
    groups_M: tuple
    groups_A: tuple

    @classmethod
    def from_stencils(cls, M_st, A_st, gs=None) -> "KronTaps":
        """From two ``spacetime_tpu.ops.stencil.StencilOperator``s; ``gs``
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


class Kernel:
    """One compiled kernel instantiation and its count of launches."""

    def __init__(self, name: str, symbol: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0


SOURCE = "spacetime_tpu_torch/csrc/kron.cu"
_B_REPLACES = "spacetime_tpu/ops/kron_pallas.py:290"
_BT_REPLACES = "spacetime_tpu/ops/kron_pallas.py:377"
KERNELS = {
    ("B", torch.float32): Kernel("K1 kron_B f32", "kron_B_f32", _B_REPLACES),
    ("B", torch.float64): Kernel("K1 kron_B f64", "kron_B_f64", _B_REPLACES),
    ("BT", torch.float32): Kernel("K2 kron_BT f32", "kron_BT_f32", _BT_REPLACES),
    ("BT", torch.float64): Kernel("K2 kron_BT f64", "kron_BT_f64", _BT_REPLACES),
}


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


def _check(name, t, dtype, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel(op, X):
    if X.device.type != "cuda":
        raise ValueError(
            f"no kron kernel for device {X.device}; CUDA tensors launch the "
            "kernel and CPU tensors run the plain twin"
        )
    k = KERNELS.get((op, X.dtype))
    if k is None:
        raise TypeError(f"the kron kernels take float32 and float64, not {X.dtype}")
    return k


def _launch_B(U, h_half, h_stab, taps: KronTaps, stab: bool):
    k = _kernel("B", U)
    T = U.shape[0] - 1
    if T < 1:
        raise ValueError("U needs at least two time rows")
    _check("U", U, U.dtype, U.device, (T + 1,) + taps.gs)
    _check("h_half", h_half, U.dtype, U.device, (T,))
    if stab:
        _check("h_stab", h_stab, U.dtype, U.device, (T,))
    out = torch.empty((T,) + taps.gs, dtype=U.dtype, device=U.device)
    W = torch.empty_like(out) if stab else None
    tM, tA = taps.structs
    lib = native.LIB.get()
    with torch.cuda.device(U.device):
        err = getattr(lib, k.symbol)(
            U.data_ptr(), h_half.data_ptr(),
            h_stab.data_ptr() if stab else None,
            out.data_ptr(), W.data_ptr() if stab else None,
            T, *taps.zyx(), ctypes.addressof(tM), ctypes.addressof(tA), int(stab),
            torch.cuda.current_stream(U.device).cuda_stream,
        )
    native.check(lib, k.symbol, err)
    k.launches += 1
    return (out, W) if stab else out


def _launch_BT(V, W, h_half, taps: KronTaps, stab: bool):
    k = _kernel("BT", V)
    T = V.shape[0]
    if T < 1:
        raise ValueError("V needs at least one time row")
    _check("V", V, V.dtype, V.device, (T,) + taps.gs)
    _check("h_half", h_half, V.dtype, V.device, (T,))
    if stab:
        _check("W", W, V.dtype, V.device, (T,) + taps.gs)
    out = torch.empty((T + 1,) + taps.gs, dtype=V.dtype, device=V.device)
    tM, tA = taps.structs
    lib = native.LIB.get()
    with torch.cuda.device(V.device):
        err = getattr(lib, k.symbol)(
            V.data_ptr(), h_half.data_ptr(), W.data_ptr() if stab else None,
            out.data_ptr(), T, *taps.zyx(), ctypes.addressof(tM),
            ctypes.addressof(tA), int(stab),
            torch.cuda.current_stream(V.device).cuda_stream,
        )
    native.check(lib, k.symbol, err)
    k.launches += 1
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
