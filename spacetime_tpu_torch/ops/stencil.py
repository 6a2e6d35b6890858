"""Stencil spatial operators on structured grids.

``StencilOperator`` is the port's copy of the host half of
``spacetime_tpu.ops.stencil.StencilOperator``: the displacements and weights
read off the assembled matrix and checked constant over interior rows.
``VarStencilOperator`` is the weighted (per-node) form of the JAX package's
class of that name: displacements on the host, one weight array per tap.
The rest of this module applies a stencil to tensors in the JAX package's
arithmetic order: the center tap reads the unpadded input, zero taps are
dropped, taps that share a weight are summed first and multiplied once, and
the group terms are added in the order of first appearance; a weighted
stencil sums its taps in ``disps`` order. Zero padding is the Dirichlet
guard.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .sparse import DiaMatrix


def _offset_candidates(grid_shape: tuple[int, ...]) -> dict:
    """flat DIA offset -> list of ±1-neighborhood grid displacements."""
    dim = len(grid_shape)
    strides = tuple(
        int(np.prod(grid_shape[i + 1 :], dtype=int)) for i in range(dim)
    )
    cand: dict[int, list] = {}
    for disp in itertools.product((-1, 0, 1), repeat=dim):
        off = sum(d * s for d, s in zip(disp, strides))
        cand.setdefault(off, []).append(disp)
    return cand


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """A constant-coefficient stencil on a structured grid.

    disps: tuple of displacement tuples (dy, dx) / (dz, dy, dx).
    weights: matching coefficients.
    grid_shape: interior grid extents.
    """

    disps: tuple[tuple[int, ...], ...]
    weights: tuple[float, ...]
    grid_shape: tuple[int, ...]

    @classmethod
    def from_dia(cls, dia: DiaMatrix, grid_shape: tuple[int, ...]) -> "StencilOperator":
        """Decode DIA offsets into grid displacements and verify the weights
        are constant over interior rows."""
        cand = _offset_candidates(grid_shape)

        # Interior-of-interior rows: all grid coords in [1, n-2].
        coords = np.unravel_index(np.arange(dia.shape[0]), grid_shape)
        interior = np.ones(dia.shape[0], dtype=bool)
        for c, n in zip(coords, grid_shape):
            interior &= (c >= 1) & (c <= n - 2)
        if not interior.any():
            raise ValueError("grid too small for stencil extraction")

        disps, weights = [], []
        # Taps that cancel exactly in exact arithmetic carry ~1e-17
        # row-dependent residue from assembly: snap relative to the scale.
        scale = float(np.abs(dia.vals).max())
        for k, off in enumerate(dia.offsets):
            if off not in cand:
                raise ValueError(f"offset {off} is not a +/-1 neighborhood move")
            col = np.where(np.abs(dia.vals[:, k]) < 1e-12 * scale, 0.0, dia.vals[:, k])
            w = col[interior]
            if w.size and not np.allclose(w, w[0], rtol=1e-10, atol=1e-12 * scale):
                raise ValueError(f"non-constant stencil weight at offset {off}")
            matches = cand[off]
            if len(matches) > 1:
                raise ValueError(
                    f"ambiguous offset {off} for grid {grid_shape}; "
                    "grid extents too small"
                )
            disps.append(matches[0])
            weights.append(float(w[0]))
        return cls(tuple(disps), tuple(weights), tuple(grid_shape))


@dataclasses.dataclass(frozen=True)
class VarStencilOperator:
    """A variable-coefficient stencil on a structured grid:
    out[p] = Σ_k W[k][p] · U[p + disps[k]], the weights W (ntaps, *gs) a
    tensor beside the host structure (displacements and grid)."""

    disps: tuple[tuple[int, ...], ...]
    grid_shape: tuple[int, ...]

    @classmethod
    def from_dia(
        cls, dia: DiaMatrix, grid_shape: tuple[int, ...]
    ) -> tuple["VarStencilOperator", np.ndarray]:
        """(the operator, its weights (ntaps, *grid_shape) float64)."""
        cand = _offset_candidates(grid_shape)
        disps = []
        for off in dia.offsets:
            matches = cand.get(off)
            if matches is None:
                raise ValueError(f"offset {off} is not a +/-1 neighborhood move")
            if len(matches) > 1:
                raise ValueError(
                    f"ambiguous offset {off} for grid {grid_shape}; "
                    "grid extents too small"
                )
            disps.append(matches[0])
        W = np.ascontiguousarray(
            dia.vals.T.reshape((len(disps),) + tuple(grid_shape))
        )
        return cls(tuple(disps), tuple(grid_shape)), W

    def apply(self, U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """U (..., *grid_shape), W (ntaps, *grid_shape) -> U.shape."""
        gs = self.grid_shape
        Up = zero_pad(U, len(gs))
        out = None
        for k, disp in enumerate(self.disps):
            term = W[k] * tap(U, Up, disp, gs)
            out = term if out is None else out + term
        return out


def weight_groups(disps, weights):
    """Drop zero taps and group displacements by weight, in order of first
    appearance: ((w, (disp, ...)), ...), as ``_weight_groups`` of
    ``spacetime_tpu/ops/kron_pallas.py``; the B/Bᵀ kernels and the stencil
    share this grouping."""
    groups: dict[float, list] = {}
    for d, w in zip(disps, weights):
        if w != 0.0:
            groups.setdefault(float(w), []).append(tuple(d))
    return tuple((w, tuple(ds)) for w, ds in groups.items())


def zero_pad(U: torch.Tensor, dim: int) -> torch.Tensor:
    """U (..., *gs) with one zero layer on each side of the last ``dim``
    axes."""
    return F.pad(U, (1, 1) * dim)


def tap(U, Up, disp, gs):
    """The field U translated by ``disp`` over the grid axes (zero fill).
    ``Up`` is ``zero_pad(U)``; the center tap is U itself."""
    if not any(disp):
        return U
    idx = (Ellipsis,) + tuple(
        slice(1 + d, 1 + d + n) for d, n in zip(disp, gs)
    )
    return Up[idx]


def stencil_apply(op, U: torch.Tensor) -> torch.Tensor:
    """Batched stencil matvec: U (..., *op.grid_shape) -> same shape, for a
    ``StencilOperator`` ``op``."""
    return grouped_apply(
        weight_groups(op.disps, op.weights), tuple(op.grid_shape), U
    )


def grouped_apply(groups, gs, U: torch.Tensor) -> torch.Tensor:
    """Σ_groups w · Σ_taps U(· + disp), in the order of ``groups``."""
    Up = zero_pad(U, len(gs)) if any(any(d) for _, ds in groups for d in ds) \
        else None
    out = None
    for w, ds in groups:
        acc = None
        for disp in ds:
            t = tap(U, Up, disp, gs)
            acc = t if acc is None else acc + t
        term = w * acc
        out = term if out is None else out + term
    return out


def row_scale(v, dim: int, dtype, device) -> torch.Tensor:
    """A per-time-row vector (T,) as a (T, 1, ..., 1) column that broadcasts
    over ``dim`` grid axes."""
    t = torch.as_tensor(v, dtype=dtype, device=device)
    return t.reshape((t.shape[0],) + (1,) * dim).contiguous()
