"""The blocked-ELL SpMM, K20, and its pair form K19, batched over time rows.

The counterpart of ``spacetime_tpu/ops/spmv_pallas.py``: for every block
row rb of a ``BlockedEll`` matrix,

    Y[:, rb·br : (rb+1)·br] = Σ_s X[:, colidx[rb, s]·bc : +bc] · blocks[rb, s]ᵀ,

the slots summed in order from slot 0 (``_spmm_call``, spmv_pallas.py:55).
``spmm`` launches the CUDA kernel of csrc/ell.cu for a CUDA tensor (float32
and float64; the TPU ran it at ``Precision.HIGHEST`` in f32 only, and the
JAX solver's f64 applications fall back to DIA, which the H100 does not
need) and counts the launch; a CPU tensor goes to the plain twin
``spmm_plain``, ``BlockedEll.matvec_np``'s loop in torch (slot by slot, one
product per slot batched over the block rows); any other device raises.
The kernel reads X unpadded, columns ≥ its width as 0, and writes only the
first ``n_out`` columns of Y, so ``EllOperator.apply`` needs neither the
pad copy nor the slice of the JAX package.

K19 (``spmm_pair``, the counterpart of ``spacetime_tpu/ops/ell_pallas.py``
``_spmm_pair_call``) computes (A·X, M·X) for two matrices stored on one
block-column index, so each staged X stripe feeds both; its twin
``spmm_pair_plain`` is two ``spmm_plain``. ``ell_to_blocked`` re-lays the
smoothed-aggregation coarse levels' ELL gather rows (the A/M union pattern,
P and Pᵀ) in that layout, and ``EllKernelLevel`` applies a level with them:
``op_pair`` by K19, ``interp`` and ``restrict`` by K20. As for K20, the
TPU's size gate (``ell_pallas_min_m``) has no counterpart: every ELL level
launches them, in f32 and f64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import native
from .blocked_ell import BlockedEll
from .native import check_tensor

SOURCE = "spacetime_tpu_torch/csrc/ell.cu"
BLOCK = 128  # the kernel's block rows and columns (the format's default)
_OPS = {
    "spmm": ("K20 ell_spmm", "spacetime_tpu/ops/spmv_pallas.py:55"),
    "spmm_pair": ("K19 ell_spmm_pair", "spacetime_tpu/ops/ell_pallas.py:140"),
}
KERNELS = {
    (op, dtype): native.Kernel(f"{name} {sfx}", f"ell_{op}_{sfx}", replaces)
    for op, (name, replaces) in _OPS.items()
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64"))
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


def spmm_plain(X, blocks, colidx, n_out: int):
    """The twin: X (T, n) -> Y (T, n_out); ``colidx`` (nrb, nslots) int."""
    nrb, nslots, br, bc = blocks.shape
    T = X.shape[0]
    ncb = -(-max(X.shape[1], int(colidx.max()) * bc + bc) // bc)
    Xb = F.pad(X, (0, ncb * bc - X.shape[1])).reshape(T, ncb, bc)
    idx = colidx.long()
    acc = None
    for s in range(nslots):
        xs = Xb[:, idx[:, s]].transpose(0, 1)  # (nrb, T, bc)
        term = torch.bmm(xs, blocks[:, s].transpose(1, 2))  # (nrb, T, br)
        acc = term if acc is None else acc + term
    return acc.transpose(0, 1).reshape(T, nrb * br)[:, :n_out].contiguous()


def spmm_pair_plain(X, blocksA, blocksM, colidx, n_out: int):
    """K19's twin: (A·X, M·X), each as ``spmm_plain``."""
    return (spmm_plain(X, blocksA, colidx, n_out),
            spmm_plain(X, blocksM, colidx, n_out))


def _check(op, X, blocks, colidx, n_out):
    k = native.kernel_for(KERNELS, "ell", op, X)
    T, n = X.shape
    nrb, nslots, br, bc = blocks[0].shape
    if (br, bc) != (BLOCK, BLOCK):
        raise ValueError(f"blocks of {br}x{bc}; the kernel takes "
                         f"{BLOCK}x{BLOCK}")
    if not 1 <= n_out <= nrb * br:
        raise ValueError(f"n_out={n_out} outside 1..{nrb * br}")
    check_tensor("X", X, X.dtype, X.device, (T, n))
    for b in blocks:
        check_tensor("blocks", b, X.dtype, X.device, (nrb, nslots, br, bc))
    check_tensor("colidx", colidx, torch.int32, X.device, (nrb, nslots))
    return k, T, n, nrb, nslots


def spmm(X, blocks, colidx, n_out: int):
    """K20: X (T, n) -> Y (T, n_out), columns of X at or past n read as 0."""
    if X.device.type == "cpu":
        return spmm_plain(X, blocks, colidx, n_out)
    k, T, n, nrb, nslots = _check("spmm", X, (blocks,), colidx, n_out)
    Y = X.new_empty((T, n_out))
    k.launch(X.device, X.data_ptr(), T, n, blocks.data_ptr(),
             colidx.data_ptr(), nrb, nslots, Y.data_ptr(), n_out)
    return Y


def spmm_pair(X, blocksA, blocksM, colidx, n_out: int):
    """K19: (A·X, M·X) for A and M on one block-column index ``colidx``."""
    if X.device.type == "cpu":
        return spmm_pair_plain(X, blocksA, blocksM, colidx, n_out)
    k, T, n, nrb, nslots = _check("spmm_pair", X, (blocksA, blocksM), colidx,
                                  n_out)
    YA, YM = X.new_empty((T, n_out)), X.new_empty((T, n_out))
    k.launch(X.device, X.data_ptr(), T, n, blocksA.data_ptr(),
             blocksM.data_ptr(), colidx.data_ptr(), nrb, nslots,
             YA.data_ptr(), YM.data_ptr(), n_out)
    return YA, YM


class EllOperator:
    """A ``BlockedEll`` matrix on a device: ``apply`` (T, m) -> (T, m) and
    ``apply_padded`` (T, mp) -> (T, nrb·br), both K20. The tensors live in
    ``params`` ({"blocks", "colidx"}) in ``dtype``; ``params_for`` gives
    them in another dtype, which the solver keeps in its params per dtype
    and passes as ``p``."""

    def __init__(self, ell: BlockedEll, dtype=torch.float32, device="cpu"):
        self.ell = ell
        self.m = ell.shape[0]
        self.mp = ell.padded_shape[1]
        self.nrb, self.nslots = ell.colidx.shape
        self.dtype, self.device = dtype, device
        self.params = ell_params(ell, dtype, device)

    def params_for(self, dtype) -> dict:
        if dtype == self.dtype:
            return self.params
        return ell_params(self.ell, dtype, self.device)

    def apply(self, U, p=None):
        """A·U[t] for every row of U (T, m), on the unpadded rows."""
        p = self.params if p is None else p
        return spmm(U, p["blocks"], p["colidx"], self.m)

    def apply_padded(self, Xp, p=None):
        p = self.params if p is None else p
        return spmm(Xp, p["blocks"], p["colidx"], self.nrb * self.ell.br)


def ell_params(ell: BlockedEll, dtype, device) -> dict:
    """The blocks in ``dtype`` and the block-column indices (int32)."""
    return {
        "blocks": torch.as_tensor(ell.blocks, dtype=dtype,
                                  device=device).contiguous(),
        "colidx": torch.as_tensor(ell.colidx, dtype=torch.int32,
                                  device=device).contiguous(),
    }


def ell_to_blocked(eidx, vals, br: int, bc: int, ncols: int, valid=None):
    """Fixed-width ELL gather rows as blocked ELL with one block-column index
    shared by every value array (the JAX package's ``ell_to_blocked``):
    ``eidx`` (m, K) column ids, ``vals`` a list of (m, K) arrays on that
    pattern, ``ncols`` the column count; ``valid`` (m, K) marks the live
    entries (default: nonzero in any of ``vals``; pad slots alias column 0
    and must not pull block column 0 in). Returns (colidx (nrb, nslots)
    int32, [blocks (nrb, nslots, br, bc)])."""
    eidx = np.asarray(eidx)
    m, K = eidx.shape
    if valid is None:
        valid = np.zeros((m, K), bool)
        for v in vals:
            valid |= np.asarray(v) != 0
    nrb = -(-m // br)
    ncb = max(1, -(-ncols // bc))
    rows, ks = np.nonzero(valid)
    cols = eidx[rows, ks]
    rb = rows // br
    bcol = cols // bc
    keys = rb.astype(np.int64) * ncb + bcol
    uk = np.unique(keys)
    urb = uk // ncb
    counts = np.bincount(urb, minlength=nrb)
    nslots = max(1, int(counts.max()))
    base = np.zeros(nrb + 1, np.int64)
    base[1:] = np.cumsum(counts)
    colidx = np.zeros((nrb, nslots), np.int32)
    colidx[urb, np.arange(uk.size) - base[urb]] = (uk % ncb).astype(np.int32)
    slot = np.searchsorted(uk, keys) - base[rb]
    out = []
    for v in vals:
        v = np.asarray(v)
        blocks = np.zeros((nrb, nslots, br, bc), v.dtype)
        # ELL rows have unique column ids (CSR provenance): plain scatter
        blocks[rb, slot, rows % br, cols % bc] = v[rows, ks]
        out.append(blocks)
    return colidx, out


class EllKernelLevel:
    """K19 and K20 for one aggregated (ELL-format) level ``lev`` of an
    ``SAMultiShiftMultigrid`` (the JAX package's ``EllPallasLevel``): the
    operator pair on the A/M union pattern, P (m × m_c) and R = Pᵀ in
    blocked ELL. The host blocks stay in float64; ``values`` casts them."""

    kind = "ell"

    def __init__(self, lev):
        if getattr(lev, "fmt", None) != "ell":
            raise ValueError("EllKernelLevel needs ELL level storage")
        self.m = int(lev.eidx.shape[0])
        self.mc = int(lev.Ridx.shape[0])
        valid = (np.asarray(lev.ewA) != 0) | (np.asarray(lev.ewM) != 0)
        self._colop, (self._bA, self._bM) = ell_to_blocked(
            lev.eidx, [lev.ewA, lev.ewM], BLOCK, BLOCK, self.m, valid)
        self._colP, (self._bP,) = ell_to_blocked(lev.Pidx, [lev.Pw], BLOCK,
                                                 BLOCK, self.mc)
        self._colR, (self._bR,) = ell_to_blocked(lev.Ridx, [lev.Rw], BLOCK,
                                                 BLOCK, self.m)

    def values(self, lev, dtype, device) -> dict:
        cast = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        idx = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        return {"colop": idx(self._colop), "bA": cast(self._bA),
                "bM": cast(self._bM), "colP": idx(self._colP),
                "bP": cast(self._bP), "colR": idx(self._colR),
                "bR": cast(self._bR)}

    def op_pair(self, x, v):
        """K19: (A·x, M·x) on (T, m)."""
        return spmm_pair(x, v["bA"], v["bM"], v["colop"], self.m)

    def interp(self, e, v):
        """K20: P·e, (T, m_c) -> (T, m)."""
        return spmm(e, v["bP"], v["colP"], self.m)

    def restrict(self, r, v):
        """K20: Pᵀ·r, (T, m) -> (T, m_c)."""
        return spmm(r, v["bR"], v["colR"], self.mc)
