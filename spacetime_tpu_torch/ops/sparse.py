"""Diagonal (DIA) storage of a square sparse matrix.

The port's copy of ``spacetime_tpu/ops/sparse.py``: ``DiaMatrix`` on the
host (the structured P1 operators live on a handful of diagonals, 7 in 2-D
and 15 in 3-D, from which ``ops.stencil.StencilOperator.from_dia`` reads the
stencil), and ``dia_matvec``, the batched DIA SpMV of the flat-dof
``"dia"`` format on tensors: ndiag shifted multiply-adds in plain PyTorch,
as the JAX package computes it in XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """A square sparse matrix stored by diagonals.

    vals[i, d] = A[i, i + offsets[d]]  (zero where out of range).
    """

    offsets: tuple[int, ...]
    vals: np.ndarray  # (m, ndiag) float64
    shape: tuple[int, int]

    @classmethod
    def from_csr(cls, A: sp.spmatrix) -> "DiaMatrix":
        coo = A.tocoo()
        coo.sum_duplicates()
        m = A.shape[0]
        d = coo.col - coo.row
        offs = np.unique(d)
        vals = np.zeros((m, offs.size))
        # sum_duplicates leaves unique (row, col) pairs: plain assignment
        vals[coo.row, np.searchsorted(offs, d)] = coo.data
        return cls(tuple(int(x) for x in offs), vals, (m, m))

    @property
    def ndiag(self) -> int:
        return len(self.offsets)


def dia_matvec(vals: torch.Tensor, offsets: tuple[int, ...],
               U: torch.Tensor) -> torch.Tensor:
    """Batched DIA SpMV along the last axis of ``U``: ``vals`` is the
    (m, ndiag) tensor, ``offsets`` the host tuple;
    Y[..., i] = Σ_d vals[i, d] · U[..., i + d], the diagonals added in
    order from zero."""
    m = vals.shape[0]
    mo = max(max(offsets), -min(offsets))
    Up = F.pad(U, (mo, mo))
    Y = torch.zeros_like(U)
    for k, d in enumerate(offsets):
        Y = Y + vals[:, k] * Up[..., mo + d : mo + d + m]
    return Y
