"""Parabolic benchmark problems with exact solutions written in torch.

The counterpart of ``spacetime_tpu.models.problems``: a manufactured problem
is its exact solution u(t, x) alone, and the source
g = ∂t u − ∇·(κ∇u) + c·u follows by automatic differentiation — ∂t through
``torch.func.grad``; for κ ≡ 1 the divergence is the trace of
``torch.func.hessian`` in x, else the trace of ``torch.func.jacfwd`` of the
flux κ∇u; batched with ``torch.func.vmap``. The numpy-facing methods
(``u0``, ``g``, ``g_many``, ``exact_np``, ``kappa_np``, ``reaction_np``)
evaluate in float64 and return numpy arrays, which is what the host
assembly and quadrature (``fem.assemble_p1``, ``fem.spacetime_loads``,
``fem.l2_error_spacetime``) call.

The port carries every problem of the JAX package: the smooth family, the
singular family (``singular2d``, ``singular3d``: u = t^¾ ∏ sin(πx), whose
u_t blows up at t = 0, solved on time grids graded toward it,
``graded_time``), the variable-coefficient family (``varcoef2d``,
``varcoef3d``), ``moving_peak2d`` and ``lshape2d`` (on the L-shaped domain,
``domain="lshape"``).
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
    ``u0_override`` as numpy callables instead. ``kappa`` is the scalar
    diffusion coefficient κ(x) > 0 and ``reaction`` the reaction
    coefficient c(x) ≥ 0, torch functions of an x of shape (dim,), or None
    for κ ≡ 1, c ≡ 0.
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

    def kappa_np(self, X: np.ndarray) -> np.ndarray:
        """Diffusion coefficient at points X (n, dim) -> (n,), float64 on the
        host (κ ≡ 1 when unset)."""
        if self.kappa is None:
            return np.ones(X.shape[0])
        return _eval_x(self.kappa, X)

    def reaction_np(self, X: np.ndarray) -> np.ndarray:
        """Reaction coefficient at points X (n, dim) -> (n,), float64 on the
        host (c ≡ 0 when unset)."""
        if self.reaction is None:
            return np.zeros(X.shape[0])
        return _eval_x(self.reaction, X)

    def _g_scalar(self):
        u, kap, rea = self.exact, self.kappa, self.reaction

        def g(t, x):
            du_dt = torch.func.grad(u, argnums=0)(t, x)
            if kap is None:
                diff = torch.diagonal(
                    torch.func.hessian(u, argnums=1)(t, x)).sum()
            else:
                # ∇·(κ∇u) = tr ∂x [κ(x) ∇u(t, x)]
                flux = lambda y: kap(y) * torch.func.grad(u, argnums=1)(t, y)
                diff = torch.diagonal(torch.func.jacfwd(flux)(x)).sum()
            out = du_dt - diff
            if rea is not None:
                out = out + rea(x) * u(t, x)
            return out

        return g


def _eval_x(fn, X: np.ndarray) -> np.ndarray:
    """A scalar torch function of x (dim,) at points X (n, dim), float64 on
    the CPU."""
    X_ = torch.as_tensor(np.asarray(X, np.float64))
    return torch.func.vmap(fn)(X_).numpy()


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


def _singular(dim, alpha=0.75):
    def u(t, x):
        # u_t ~ t^(α−1) blows up as t → 0: uniform time grids lose the
        # optimal rate, grids graded toward t = 0 restore it
        return t ** alpha * _prod(torch.sin(math.pi * x))

    return Problem(name=f"singular{dim}d", dim=dim, exact=u, graded_time=True)


def _varcoef(dim):
    """Smooth positive diffusion κ and nonnegative reaction c around the
    smooth family's exact solution: the weighted spatial form
    ∫κ∇u·∇v + c·uv (``fem.assemble_p1``)."""

    def kappa(x):
        return 1.0 + 0.5 * _prod(torch.sin(math.pi * x))

    def reaction(x):
        return 1.0 + x[0]

    def u(t, x):
        return torch.exp(-t) * _prod(torch.sin(math.pi * x))

    return Problem(name=f"varcoef{dim}d", dim=dim, exact=u, kappa=kappa,
                   reaction=reaction)


def _moving_peak2d():
    def u(t, x):
        cx = 0.25 + 0.5 * t
        cy = 0.5
        r2 = (x[0] - cx) ** 2 + (x[1] - cy) ** 2
        return 16.0 * _prod(x * (1.0 - x)) * torch.exp(-50.0 * r2)

    return Problem(name="moving_peak2d", dim=2, exact=u)


def _lshape2d():
    def u(t, x):
        # sin(2πx)·sin(2πy) vanishes on x, y ∈ {0, ½, 1}: on the whole
        # boundary of the L-shaped domain, reentrant edges included
        return torch.exp(-t) * _prod(torch.sin(2.0 * math.pi * x))

    return Problem(name="lshape2d", dim=2, exact=u, domain="lshape")


PROBLEMS = {p.name: p for p in [_smooth(2), _smooth(3), _singular(2),
                                _singular(3), _moving_peak2d(), _lshape2d(),
                                _varcoef(2), _varcoef(3)]}


def get_problem(name: str) -> Problem:
    try:
        return PROBLEMS[name]
    except KeyError:
        raise KeyError(
            f"unknown problem {name!r}; available: {sorted(PROBLEMS)}"
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
