"""The blocked-ELL SpMM, K20, batched over time rows.

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native
from .blocked_ell import BlockedEll
from .native import check_tensor

SOURCE = "spacetime_tpu_torch/csrc/ell.cu"
BLOCK = 128  # the kernel's block rows and columns (the format's default)
KERNELS = {
    ("spmm", dtype): native.Kernel(
        f"K20 ell_spmm {sfx}", f"ell_spmm_{sfx}",
        "spacetime_tpu/ops/spmv_pallas.py:55")
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


def spmm(X, blocks, colidx, n_out: int):
    """K20: X (T, n) -> Y (T, n_out), columns of X at or past n read as 0."""
    if X.device.type == "cpu":
        return spmm_plain(X, blocks, colidx, n_out)
    k = native.kernel_for(KERNELS, "ell", "spmm", X)
    T, n = X.shape
    nrb, nslots, br, bc = blocks.shape
    if (br, bc) != (BLOCK, BLOCK):
        raise ValueError(f"blocks of {br}x{bc}; the kernel takes "
                         f"{BLOCK}x{BLOCK}")
    if not 1 <= n_out <= nrb * br:
        raise ValueError(f"n_out={n_out} outside 1..{nrb * br}")
    check_tensor("X", X, X.dtype, X.device, (T, n))
    check_tensor("blocks", blocks, X.dtype, X.device, (nrb, nslots, br, bc))
    check_tensor("colidx", colidx, torch.int32, X.device, (nrb, nslots))
    Y = X.new_empty((T, n_out))
    k.launch(X.device, X.data_ptr(), T, n, blocks.data_ptr(),
             colidx.data_ptr(), nrb, nslots, Y.data_ptr(), n_out)
    return Y


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
