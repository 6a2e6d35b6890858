"""Constant-stencil spatial operators on tensors.

``spacetime_tpu.ops.stencil.StencilOperator`` (host structure: displacements
and weights read off the assembled matrix) is reused as it is; this module
applies it to tensors. The arithmetic order is the JAX package's: the center
tap reads the unpadded input, zero taps are dropped, taps that share a
weight are summed first and multiplied once, and the group terms are added
in the order of first appearance. Zero padding is the Dirichlet guard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weight_groups(disps, weights):
    """Drop zero taps and group displacements by weight, in order of first
    appearance: ((w, (disp, ...)), ...). Copied from
    ``spacetime_tpu.ops.kron_pallas._weight_groups`` (whose module needs
    JAX); the B/Bᵀ kernels and the stencil share this grouping."""
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
    ``spacetime_tpu.ops.stencil.StencilOperator`` ``op``."""
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
