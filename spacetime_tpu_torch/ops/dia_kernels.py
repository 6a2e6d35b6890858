"""The banded-DIA kernels K16–K18 of the flat-dof multigrid levels.

The counterpart of ``spacetime_tpu/ops/dia_pallas.py``. ``DiaKernelLevel``
mirrors its ``DiaPallasLevel`` for one DIA-format level of the nested
red-refinement hierarchy or of the smoothed-aggregation hierarchy
(``ops.multigrid.NestedMultiShiftMultigrid``, ``SAMultiShiftMultigrid``),
Op = A + ω⊙M with one shift per time row on the flat (T, m) layout:

    K16 ``smooth``    degree-ν Chebyshev–Jacobi sweep with the per-node
                      Jacobi term 1/(dA + ω·dM) (``_dia_smooth_call``),
                      from x or from x = 0
    K17 ``residual``  b − Op x (``_dia_residual_call``)
    K18 ``apply_A``   A x (``_dia_apply_call``): K_X's middle application
                      and the factored SA transfers

A and M are held on the union of their diagonal offsets
(``union_offsets``, the JAX package's ``_union_offsets``) as (ndu, m)
values, so one tap of x serves both. K16 runs a sweep as ν launches of
its one-step kernel, as K3 does above its tiled ν (``mg_cheb_step``).

For a CUDA tensor each wrapper launches the kernel of csrc/dia.cu (float32
and float64) and counts the launch; a CPU tensor goes to the plain PyTorch
twin ``*_plain`` (the JAX package's XLA form: ``dia_matvec`` sums and the
``cheb_smooth`` recurrence); any other device raises. None of the TPU's
gates carries over: the size gate, ``dia_hardware_gate`` and the f64
fallback worked around the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import native
from .multigrid import cheb_smooth, chebyshev_steps, _SIGMA
from .native import check_tensor

SOURCE = "spacetime_tpu_torch/csrc/dia.cu"
_DIA = "spacetime_tpu/ops/dia_pallas.py"
_OPS = {
    "smooth": ("K16 dia_smooth", f"{_DIA}:156"),
    "residual": ("K17 dia_residual", f"{_DIA}:258"),
    "apply": ("K18 dia_apply", f"{_DIA}:315"),
}
KERNELS = {
    (op, dtype): native.Kernel(f"{name} {sfx}", f"dia_{op}_{sfx}", replaces)
    for op, (name, replaces) in _OPS.items()
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64"))
}
MAX_ROWS = 65535  # the time row is blockIdx.y


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


def union_offsets(offA, valsA, offM, valsM):
    """The sorted union of A's and M's offsets and the (ndu, m) values of
    each on it (zero rows where a matrix lacks the diagonal); ``vals*``
    are ``DiaMatrix`` (m, ndiag) arrays."""
    union = tuple(sorted(set(offA) | set(offM)))
    m = valsA.shape[0]
    vA = np.zeros((len(union), m))
    vM = np.zeros((len(union), m))
    offA, offM = tuple(offA), tuple(offM)
    for k, off in enumerate(union):
        if off in offA:
            vA[k] = valsA[:, offA.index(off)]
        if off in offM:
            vM[k] = valsM[:, offM.index(off)]
    return union, vA, vM


def _taps(offsets, y):
    """y shifted by each offset along the last axis, zero outside."""
    m = y.shape[-1]
    mo = max(max(offsets), -min(offsets))
    yp = F.pad(y, (mo, mo))
    return [yp[..., mo + o: mo + o + m] for o in offsets]


def dia_pair_plain(vA, vM, offsets, y):
    """(Σ_k vA[k]·y(· + off_k), Σ_k vM[k]·y(· + off_k)), each summed from
    zero in offset order as ``ops.sparse.dia_matvec`` sums."""
    outA = torch.zeros_like(y)
    outM = torch.zeros_like(y)
    for k, tap in enumerate(_taps(offsets, y)):
        outA = outA + vA[k] * tap
        outM = outM + vM[k] * tap
    return outA, outM


def dia_apply_plain(vA, offsets, x):
    out = torch.zeros_like(x)
    for k, tap in enumerate(_taps(offsets, x)):
        out = out + vA[k] * tap
    return out


class DiaKernelLevel:
    """K16–K18 for one DIA-format level ``lev`` (a ``_NestedLevel`` or a
    DIA ``_SALevel``). Its columns are ω, 1/θ, 1/δ (``columns`` of the
    level's row params); its values ``values(lev, dtype, device)``:
    vA, vM on the union offsets and the diagonals dA, dM."""

    kind = "dia"

    def __init__(self, lev, nu: int, nu_post: int | None = None):
        if getattr(lev, "fmt", "dia") != "dia":
            raise ValueError("DiaKernelLevel needs DIA level storage")
        self.m = int(lev.m)
        self.offsets, self._vA, self._vM = union_offsets(
            lev.offA, lev.Av, lev.offM, lev.Mv)
        self.nu = nu
        self.nu_post = nu if nu_post is None else nu_post

    @functools.cached_property
    def struct(self):
        return native.dia_offsets_struct(self.offsets)

    @staticmethod
    def columns(lp) -> dict:
        """The per-row columns of a level's row params as (T,) views."""
        return {"omega": lp["omega"].reshape(-1),
                "invT": lp["inv_theta"].reshape(-1),
                "invDel": lp["inv_delta"].reshape(-1)}

    def values(self, lev, dtype, device) -> dict:
        cast = lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        return {"vA": cast(self._vA), "vM": cast(self._vM),
                "dA": cast(lev.dA), "dM": cast(lev.dM)}

    # ------------------------------------------------------------ twins

    def _cols(self, cols):
        c = lambda v: v.reshape(-1, 1)
        return c(cols["omega"]), c(cols["invT"]), c(cols["invDel"])

    def op_plain(self, x, cols, vals):
        om = cols["omega"].reshape(-1, 1)
        oA, oM = dia_pair_plain(vals["vA"], vals["vM"], self.offsets, x)
        return oA + om * oM

    def smooth_plain(self, x, b, cols, vals, zero_init=False, post=False):
        om, iT, iDel = self._cols(cols)
        lp = {"inv_diag": 1.0 / (vals["dA"] + om * vals["dM"]),
              "inv_theta": iT, "inv_delta": iDel}
        return cheb_smooth(lambda v: self.op_plain(v, cols, vals), lp,
                           None if zero_init else x, b,
                           self.nu_post if post else self.nu)

    def residual_plain(self, x, b, cols, vals):
        return b - self.op_plain(x, cols, vals)

    def apply_A_plain(self, x, vals):
        return dia_apply_plain(vals["vA"], self.offsets, x)

    # --------------------------------------------------------- wrappers

    def _prepare(self, op, X, cols, vals, with_m=True):
        k = native.kernel_for(KERNELS, "dia", op, X)
        T = X.shape[0]
        if not 1 <= T <= MAX_ROWS:
            raise ValueError(f"{T} time rows; the kernels take 1 to {MAX_ROWS}")
        check_tensor("field", X, X.dtype, X.device, (T, self.m))
        nd = len(self.offsets)
        check_tensor("vA", vals["vA"], X.dtype, X.device, (nd, self.m))
        if with_m:
            check_tensor("vM", vals["vM"], X.dtype, X.device, (nd, self.m))
        if cols is None:
            return k, T, ()
        for name in ("omega", "invT", "invDel"):
            check_tensor(name, cols[name], X.dtype, X.device, (T,))
        return k, T, tuple(cols[n].data_ptr() for n in ("omega", "invT",
                                                          "invDel"))

    def smooth(self, x, b, cols, vals, zero_init=False, post=False):
        """K16: the degree-ν sweep (ν_post with ``post``) as ν one-step
        launches; x is ignored with ``zero_init``."""
        if b.device.type == "cpu":
            return self.smooth_plain(x, b, cols, vals, zero_init, post)
        nu = self.nu_post if post else self.nu
        k, T, cp = self._prepare("smooth", b, cols, vals)
        for name in ("dA", "dM"):
            check_tensor(name, vals[name], b.dtype, b.device, (self.m,))
        if not zero_init:
            check_tensor("x", x, b.dtype, b.device, b.shape)
        fields = (b.data_ptr(), vals["vA"].data_ptr(), vals["vM"].data_ptr(),
                  vals["dA"].data_ptr(), vals["dM"].data_ptr(), *cp)
        offs = ctypes.addressof(self.struct)
        out, r = torch.empty_like(b), torch.empty_like(b)
        d = (torch.empty_like(b), torch.empty_like(b))
        step = lambda x_in, d_in, d_out, first, c1, c2: k.launch(
            b.device, x_in, *fields, r.data_ptr(), d_in, d_out.data_ptr(),
            out.data_ptr(), T, self.m, offs, first, c1, c2)
        step(None if zero_init else x.data_ptr(), None, d[0], 1, 0.0, 0.0)
        for s, (c1, c2) in enumerate(chebyshev_steps(_SIGMA, nu), 1):
            step(None, d[(s - 1) % 2].data_ptr(), d[s % 2], 0, c1, c2)
        return out

    def residual(self, x, b, cols, vals):
        """K17: b − Op x."""
        if b.device.type == "cpu":
            return self.residual_plain(x, b, cols, vals)
        k, T, cp = self._prepare("residual", b, cols, vals)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), vals["vA"].data_ptr(),
                 vals["vM"].data_ptr(), cp[0], out.data_ptr(), T, self.m,
                 ctypes.addressof(self.struct))
        return out

    def apply_A(self, x, vals):
        """K18: A x."""
        if x.device.type == "cpu":
            return self.apply_A_plain(x, vals)
        k, T, _ = self._prepare("apply", x, None, vals, with_m=False)
        out = torch.empty_like(x)
        k.launch(x.device, x.data_ptr(), vals["vA"].data_ptr(),
                 out.data_ptr(), T, self.m,
                 ctypes.addressof(self.struct))
        return out
