"""Diagonal (DIA) storage of a square sparse matrix, on the host.

The port's copy of ``DiaMatrix`` in ``spacetime_tpu/ops/sparse.py``: the
structured P1 operators live on a handful of diagonals (7 in 2-D, 15 in
3-D), from which ``ops.stencil.StencilOperator.from_dia`` reads the stencil.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


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
