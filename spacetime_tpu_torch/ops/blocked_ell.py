"""Blocked-ELL storage of a sparse matrix, on the host.

The port's copy of ``spacetime_tpu/ops/blocked_ell.py``: rows are cut into
Br-row blocks, each holding a fixed number of (Br × Bc) dense blocks with
their block-column indices (short block rows padded with zero blocks at
block column 0). The batched application Y[t] = A·U[t] over all time rows is
then one dense (T × Bc)·(Bc × Br) product per slot, which is what K20
(``ops.spmv``) computes. A pure re-layout of the CSR matrix, so it keeps
exact parity with it; the blocks and colidx equal the JAX package's bit for
bit (``tests/test_torch_ell.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class BlockedEll:
    """Blocked-ELL matrix: blocks[rb, s] is the (Br, Bc) dense block at
    block-row rb, block-column colidx[rb, s] (zero blocks pad short rows)."""

    blocks: np.ndarray  # (nrb, nslots, Br, Bc)
    colidx: np.ndarray  # (nrb, nslots) int32
    shape: tuple[int, int]  # original (m, m)
    br: int
    bc: int

    @classmethod
    def from_csr(cls, A: sp.spmatrix, br: int = 128, bc: int = 128) -> "BlockedEll":
        A = A.tocsr()
        m, n = A.shape
        mp, np_ = _round_up(m, br), _round_up(n, bc)
        Ap = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(m, np_))
        Ap.resize((mp, np_))
        nrb = mp // br
        bsr = Ap.tobsr(blocksize=(br, bc))
        counts = np.diff(bsr.indptr)
        nslots = max(1, int(counts.max()))
        blocks = np.zeros((nrb, nslots, br, bc), dtype=np.float64)
        colidx = np.zeros((nrb, nslots), dtype=np.int32)
        for rb in range(nrb):
            lo, hi = bsr.indptr[rb], bsr.indptr[rb + 1]
            for s, ptr in enumerate(range(lo, hi)):
                blocks[rb, s] = bsr.data[ptr]
                colidx[rb, s] = bsr.indices[ptr]
        return cls(blocks, colidx, (m, n), br, bc)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (
            self.blocks.shape[0] * self.br,
            _round_up(self.shape[1], self.bc),
        )

    def matvec_np(self, X: np.ndarray) -> np.ndarray:
        """Reference batched apply: X (..., m) -> (..., m)."""
        m, n = self.shape
        lead = X.shape[:-1]
        np_ = _round_up(n, self.bc)
        Xp = np.zeros(lead + (np_,), X.dtype)
        Xp[..., :n] = X
        nrb, nslots = self.colidx.shape
        Y = np.zeros(lead + (nrb * self.br,), X.dtype)
        for rb in range(nrb):
            acc = 0
            for s in range(nslots):
                cb = self.colidx[rb, s]
                xblk = Xp[..., cb * self.bc : (cb + 1) * self.bc]
                acc = acc + xblk @ self.blocks[rb, s].T
            Y[..., rb * self.br : (rb + 1) * self.br] = acc
        return Y[..., :m]
