"""Parabolic benchmark problems with exact solutions written in torch.

The counterpart of ``spacetime_tpu.models.problems``: a manufactured problem
is its exact solution u(t, x) alone, and the source g = ∂t u − Δu follows by
automatic differentiation — ∂t through ``torch.func.grad``, Δ as the trace
of ``torch.func.hessian`` in x, batched with ``torch.func.vmap``. The
numpy-facing methods (``u0``, ``g``, ``g_many``, ``exact_np``) evaluate in
float64 and return numpy arrays, which is what the host quadrature
(``fem.spacetime_loads``, ``fem.l2_error_spacetime``) calls.

This slice carries the smooth family; the singular, moving-peak, L-shape
and variable-coefficient problems come with the slices that need them
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

# Space-time points per batched source evaluation: bounds the float64
# intermediates of the vmapped hessian to a few hundred MB.
_G_CHUNK = 1 << 21


@dataclasses.dataclass(frozen=True)
class Problem:
    """A parabolic benchmark problem on the unit square/cube.

    Fields as in the JAX package: ``exact`` is the scalar exact solution
    u(t, x) for a 0-dim ``t`` and an x of shape (dim,), written in torch, or
    None for data-driven problems, which give ``g_override`` and
    ``u0_override`` as numpy callables instead. ``kappa`` and ``reaction``
    (variable coefficients) belong to a later slice and must stay None.
    """

    name: str
    dim: int
    exact: Callable | None
    T: float = 1.0
    g_override: Callable | None = None
    u0_override: Callable | None = None
    graded_time: bool = False
    domain: str = "unit"
    kappa: Callable | None = None
    reaction: Callable | None = None

    def u0(self, X: np.ndarray) -> np.ndarray:
        """Initial datum at points X (n, dim) -> (n,)."""
        if self.exact is None:
            return np.asarray(self.u0_override(X))
        return self.exact_np(0.0, X)

    def g(self, t: float, X: np.ndarray) -> np.ndarray:
        """Source g(t, ·) at points X (n, dim) -> (n,)."""
        if self.exact is None:
            return np.asarray(self.g_override(t, X))
        return self.g_many(np.asarray([float(t)]), X)[0]

    def g_many(
        self, ts: np.ndarray, X: np.ndarray, device: str | torch.device = "cpu"
    ) -> np.ndarray:
        """Source at many times: (nt,), (n, dim) -> (nt, n), evaluated in
        float64 on ``device`` in chunks of whole time rows."""
        if self.exact is None:
            return np.stack([np.asarray(self.g_override(t, X)) for t in ts])
        ts = np.asarray(ts, np.float64)
        X = np.asarray(X, np.float64)
        fn = torch.func.vmap(
            torch.func.vmap(self._g_scalar(), in_dims=(None, 0)),
            in_dims=(0, None),
        )
        Xd = torch.as_tensor(X, dtype=torch.float64, device=device)
        out = np.empty((ts.size, X.shape[0]))
        step = max(1, _G_CHUNK // max(X.shape[0], 1))
        for lo in range(0, ts.size, step):
            td = torch.as_tensor(
                ts[lo : lo + step], dtype=torch.float64, device=device
            )
            out[lo : lo + td.numel()] = fn(td, Xd).cpu().numpy()
        return out

    def exact_np(self, t: float, X: np.ndarray) -> np.ndarray:
        """Exact solution u(t, ·) at points X (n, dim) -> (n,), float64."""
        fn = torch.func.vmap(self.exact, in_dims=(None, 0))
        t_ = torch.tensor(float(t), dtype=torch.float64)
        X_ = torch.as_tensor(np.asarray(X, np.float64))
        return fn(t_, X_).numpy()

    def _g_scalar(self):
        if self.kappa is not None or self.reaction is not None:
            raise NotImplementedError(
                "variable coefficients belong to the weighted-coefficient "
                "slice of the port (ROADMAP.md queue 1)"
            )
        u = self.exact

        def g(t, x):
            du_dt = torch.func.grad(u, argnums=0)(t, x)
            lap = torch.diagonal(torch.func.hessian(u, argnums=1)(t, x)).sum()
            return du_dt - lap

        return g


def _prod(v):
    """Product of the entries of a (dim,) tensor, left to right."""
    out = v[0]
    for k in range(1, v.shape[0]):
        out = out * v[k]
    return out


def _smooth(dim):
    def u(t, x):
        return torch.exp(-t) * _prod(torch.sin(math.pi * x))

    return Problem(name=f"smooth{dim}d", dim=dim, exact=u)


PROBLEMS = {p.name: p for p in [_smooth(2), _smooth(3)]}


def get_problem(name: str) -> Problem:
    try:
        return PROBLEMS[name]
    except KeyError:
        raise KeyError(
            f"unknown problem {name!r}; available: {sorted(PROBLEMS)} (the "
            "other problems of the JAX package come with later slices of "
            "the port, ROADMAP.md queue 1)"
        ) from None


def register_problem(problem: Problem, overwrite: bool = False) -> Problem:
    """Add a user-defined :class:`Problem` to the registry (and thus to the
    CLI's ``--problem`` and ``get_problem``)."""
    if problem.exact is None and (
        problem.g_override is None or problem.u0_override is None
    ):
        raise ValueError(
            "a Problem needs either an exact solution (manufactured) or "
            "both g_override and u0_override (data-driven)"
        )
    if problem.name in PROBLEMS and not overwrite:
        raise ValueError(
            f"problem {problem.name!r} already registered "
            "(pass overwrite=True to replace)"
        )
    PROBLEMS[problem.name] = problem
    return problem
