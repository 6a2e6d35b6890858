"""Preconditioned conjugate gradients as a Python loop over tensors.

The standard PCG of ``spacetime_tpu.solver.pcg.pcg`` with the same
operation order, the same NaN-padded ``residuals`` / ``precond_residuals``
histories and the same already-converged entry guard. The stopping test is
read on the host once per iteration (one device synchronisation each).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGResult(NamedTuple):
    U: torch.Tensor
    iterations: int
    residuals: torch.Tensor  # (maxiter+1,) 2-norm history, NaN beyond last
    precond_residuals: torch.Tensor  # sqrt(r·z) history
    converged: bool


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def pcg(
    apply_S: Callable,
    apply_KX: Callable,
    f: torch.Tensor,
    tol: float,
    maxiter: int,
    x0: torch.Tensor | None = None,
    dot: Callable | None = None,
) -> PCGResult:
    """Solve S u = f with preconditioner K_X; stops at ||r|| <= tol*||f||.

    ``dot``: the global inner product of the caller's local blocks (the
    mesh solvers: a masked local dot summed over the ranks); norms are then
    sqrt(dot(x, x)), as in the JAX package's ``pcg(dot=)``."""
    if dot is None:
        dot, norm = _dot, torch.linalg.vector_norm
    else:
        norm = lambda x: torch.sqrt(dot(x, x))
    U = torch.zeros_like(f) if x0 is None else x0
    R = f - apply_S(U)
    Z = apply_KX(R)
    P = Z
    rz = dot(R, Z)
    fnorm = norm(f)
    rnorm = norm(R)
    res = torch.full((maxiter + 1,), float("nan"), dtype=f.dtype, device=f.device)
    pres = torch.full_like(res, float("nan"))
    res[0] = rnorm
    pres[0] = torch.sqrt(torch.clamp(rz, min=0.0))
    # Already-converged entry (f = 0, or an exact warm start): the first
    # trip would compute alpha = 0/0 and poison U with NaN.
    done = bool(rnorm <= tol * fnorm)
    it = 0
    while it < maxiter and not done:
        SP = apply_S(P)
        alpha = rz / dot(P, SP)
        U = U + alpha * P
        R = R - alpha * SP
        rnorm = norm(R)
        res[it + 1] = rnorm
        Z = apply_KX(R)
        rz_new = dot(R, Z)
        pres[it + 1] = torch.sqrt(torch.clamp(rz_new, min=0.0))
        P = Z + (rz_new / rz) * P
        rz = rz_new
        it += 1
        done = bool(rnorm <= tol * fnorm)
    return PCGResult(
        U=U, iterations=it, residuals=res, precond_residuals=pres,
        converged=done,
    )
