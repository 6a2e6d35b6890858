"""The multigrid V-cycle kernels K3–K7 on 2-D grids.

The counterpart of the constant-stencil half of
``spacetime_tpu/ops/mg_pallas.py``. ``MSKernelLevel`` mirrors its
``MSPallasLevel`` for one multigrid level, Op = A + ω⊙M with one shift per
time row:

    K3 ``smooth``      degree-ν Chebyshev–Jacobi sweep (``_smooth_call``),
                       from x or from x = 0 (``zero_init``)
    K4 ``residual``    b − Op x (``_residual_call``)
    K5 ``apply_A``     A x, the stiffness stencil alone
                       (``_apply_stencil_call``)
    K6 ``fused_pre``   x = zero-init sweep on b, r_c = R(b − Op x)
                       (``_fused_pre_call``): returns (x, r_c)
    K7 ``fused_post``  smooth(x + P e_c, b) (``_fused_post_call``)

For a CUDA tensor each wrapper launches the CUDA kernel of csrc/mg.cu
(float32 and float64) and counts the launch; a CPU tensor goes to the plain
PyTorch twin ``*_plain``, built from ``ops.multigrid``'s ``ms_op``,
``cheb_smooth`` and ``transfer`` (the XLA form of the JAX package); any
other device raises. The twins are also what the kernels are checked
against. The per-row columns (ω, 1/D, 1/θ, 1/δ) are (T,) vectors,
``MSKernelLevel.columns`` of a level's row params.

The sharded-slab forms of the Pallas kernels (``vmask``, ``lead``), the
banded transfer matrices (``Ux``/``Wx``, a device of the TPU's matrix unit)
and the 3-D forms are not ported here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import native
from .native import check_tensor
from .multigrid import cheb_smooth, ms_op, pair_groups, transfer
from .stencil import grouped_apply, weight_groups

SOURCE = "spacetime_tpu_torch/csrc/mg.cu"
MAX_NU = 8  # the sweep's halo: a 32-wide tile grows by ν cells per side
MAX_ROWS = 65535  # the time row is blockIdx.z of the tiled kernels
_MG = "spacetime_tpu/ops/mg_pallas.py"
_OPS = {
    "smooth": ("K3 mg_smooth", f"{_MG}:190"),
    "residual": ("K4 mg_residual", f"{_MG}:316"),
    "apply": ("K5 mg_apply", f"{_MG}:375"),
    "fused_pre": ("K6 mg_fused_pre", f"{_MG}:1318"),
    "fused_post": ("K7 mg_fused_post", f"{_MG}:1475"),
}
KERNELS = {
    (op, dtype): native.Kernel(f"{name} {sfx}", f"mg_{op}_{sfx}", replaces)
    for op, (name, replaces) in _OPS.items()
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64"))
}
# the row params' names of the kernels' columns
_LP_NAMES = {"omega": "omega", "invD": "inv_diag", "invT": "inv_theta",
             "invDel": "inv_delta"}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


def _lp(cols):
    """The (T,) columns as the (T, 1, 1) row params of ``ops.multigrid``."""
    return {_LP_NAMES[k]: v.reshape(-1, 1, 1) for k, v in cols.items()}


class MSKernelLevel:
    """K3–K7 for one 2-D multigrid level; ``gs`` overrides the stencils'
    grid (the weights are translation invariant)."""

    def __init__(self, A_st, M_st, nu: int, nu_post: int | None = None,
                 gs=None):
        self.gs = tuple(gs if gs is not None else A_st.grid_shape)
        if len(self.gs) != 2:
            raise NotImplementedError(
                f"grid {self.gs}: the 3-D forms of K3–K7 are not ported yet "
                "(ROADMAP.md queue 1, item 4)"
            )
        self.groups_A = weight_groups(A_st.disps, A_st.weights)
        self.pairs = pair_groups(
            self.groups_A, weight_groups(M_st.disps, M_st.weights)
        )
        self.nu = nu
        self.nu_post = nu if nu_post is None else nu_post

    @staticmethod
    def columns(lp) -> dict:
        """The per-row columns of a level's row params
        (``ops.multigrid.row_params``) as (T,) views: ω, 1/D, 1/θ, 1/δ."""
        return {k: lp[name].reshape(-1) for k, name in _LP_NAMES.items()}

    @property
    def fused_ok(self) -> bool:
        """The fused stages bake one ν (as ``MSPallasLevel.fused_ok``; the
        Pallas slab-alignment clause has no counterpart here)."""
        return self.nu_post == self.nu and 2 <= self.nu <= 3

    @functools.cached_property
    def structs(self):
        """The pair tables of Op and of A alone (every wM = 0)."""
        return (
            native.pair_groups_struct(self.pairs),
            native.pair_groups_struct(pair_groups(self.groups_A, ())),
        )

    # ------------------------------------------------------------ twins

    def op_plain(self, x, cols):
        return ms_op(self.pairs, self.gs, cols["omega"].reshape(-1, 1, 1), x)

    def smooth_plain(self, x, b, cols, zero_init=False, post=False):
        lp = _lp(cols)
        return cheb_smooth(
            lambda v: ms_op(self.pairs, self.gs, lp["omega"], v), lp,
            b * 0.0 if zero_init else x, b, self.nu_post if post else self.nu,
        )

    def residual_plain(self, x, b, cols):
        return b - self.op_plain(x, cols)

    def apply_A_plain(self, x):
        return grouped_apply(self.groups_A, self.gs, x)

    def fused_pre_plain(self, b, cols):
        x = self.smooth_plain(None, b, cols, zero_init=True)
        return x, transfer(self.residual_plain(x, b, cols), 2, restrict=True)

    def fused_post_plain(self, x, b, ec, cols):
        return self.smooth_plain(x + transfer(ec, 2, restrict=False), b, cols)

    # --------------------------------------------------------- wrappers

    def smooth(self, x, b, cols, zero_init=False, post=False):
        """K3: the degree-ν sweep (ν_post with ``post``); x is ignored with
        ``zero_init``."""
        if b.device.type == "cpu":
            return self.smooth_plain(x, b, cols, zero_init, post)
        nu = self.nu_post if post else self.nu
        k, T, cp = self._prepare("smooth", b, cols, nu=nu)
        if not zero_init:
            check_tensor("x", x, b.dtype, b.device, b.shape)
        out = torch.empty_like(b)
        k.launch(
            b.device, None if zero_init else x.data_ptr(), b.data_ptr(),
            *cp, out.data_ptr(), T, *self.gs, self._op_table(), nu,
            int(zero_init),
        )
        return out

    def residual(self, x, b, cols):
        """K4: b − Op x."""
        if b.device.type == "cpu":
            return self.residual_plain(x, b, cols)
        k, T, cp = self._prepare("residual", b, cols)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), cp[0],
                 out.data_ptr(), T, *self.gs, self._op_table())
        return out

    def apply_A(self, x):
        """K5: the stiffness stencil A x (the middle of the K_X sandwich)."""
        if x.device.type == "cpu":
            return self.apply_A_plain(x)
        k, T, _ = self._prepare("apply", x, None)
        out = torch.empty_like(x)
        k.launch(x.device, x.data_ptr(), out.data_ptr(), T, *self.gs,
                 ctypes.addressof(self.structs[1]))
        return out

    def fused_pre(self, b, cols):
        """K6: (x, r_c), x the zero-init sweep on b and r_c = R(b − Op x)."""
        if b.device.type == "cpu":
            return self.fused_pre_plain(b, cols)
        k, T, cp = self._prepare("fused_pre", b, cols, nu=self.nu, odd=True)
        x = torch.empty_like(b)
        rc = b.new_empty((T,) + self.coarse_gs)
        k.launch(b.device, b.data_ptr(), *cp, x.data_ptr(),
                 rc.data_ptr(), T, *self.gs, self._op_table(), self.nu)
        return x, rc

    def fused_post(self, x, b, ec, cols):
        """K7: smooth(x + P e_c, b)."""
        if b.device.type == "cpu":
            return self.fused_post_plain(x, b, ec, cols)
        k, T, cp = self._prepare("fused_post", b, cols, nu=self.nu, odd=True)
        check_tensor("x", x, b.dtype, b.device, b.shape)
        check_tensor("ec", ec, b.dtype, b.device, (T,) + self.coarse_gs)
        out = torch.empty_like(b)
        k.launch(b.device, x.data_ptr(), b.data_ptr(), ec.data_ptr(),
                 *cp, out.data_ptr(), T, *self.gs, self._op_table(),
                 self.nu)
        return out

    @property
    def coarse_gs(self):
        return tuple((n - 1) // 2 for n in self.gs)

    def _op_table(self):
        return ctypes.addressof(self.structs[0])

    def _prepare(self, op, X, cols, nu=None, odd=False):
        """Check the main field and the columns; returns the kernel, T and
        the columns' pointers in (ω, 1/D, 1/θ, 1/δ) order."""
        k = native.kernel_for(KERNELS, "mg", op, X)
        T = X.shape[0]
        if not 1 <= T <= MAX_ROWS:
            raise ValueError(f"{T} time rows; the kernels take 1 to {MAX_ROWS}")
        check_tensor("field", X, X.dtype, X.device, (T,) + self.gs)
        if nu is not None and not 1 <= nu <= MAX_NU:
            raise ValueError(f"nu={nu}: the sweep kernels take 1 to {MAX_NU}")
        if odd and any(n % 2 == 0 for n in self.gs):
            raise ValueError(f"grid {self.gs}: the transfer stages need odd "
                             "extents 2n+1")
        if cols is None:
            return k, T, ()
        for name in _LP_NAMES:
            check_tensor(name, cols[name], X.dtype, X.device, (T,))
        return k, T, tuple(cols[name].data_ptr() for name in _LP_NAMES)
