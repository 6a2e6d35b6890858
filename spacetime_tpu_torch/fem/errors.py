"""The space-time L2 error on the host (the port's copy of
``l2_error_spacetime`` in ``spacetime_tpu/fem/errors.py``)."""

from __future__ import annotations

import numpy as np

from .assembly import _geometry, _quad_rule
from .mesh import Mesh
from .timegrid import TimeGrid


def l2_error_spacetime(problem, mesh: Mesh, grid: TimeGrid, U: np.ndarray) -> float:
    """L2(I×Ω) error of the discrete solution against ``problem.exact_np``.

    ``U`` holds interior-vertex coefficients, shape (N_t+1, m). Quadrature:
    2-point Gauss per time interval × degree-2 rule per element.
    """
    bary, w = _quad_rule(mesh.dim)
    measure = _geometry(mesh)[0]
    v = mesh.vertices[mesh.elements]
    pts = np.einsum("qi,eid->eqd", bary, v)
    flat = pts.reshape(-1, mesh.dim)

    N = grid.num_intervals
    Ufull = np.zeros((N + 1, mesh.num_vertices))
    Ufull[:, mesh.interior] = U

    def uq_row(j):
        # one row at a time: all rows at once is gigabytes at large sizes
        return np.einsum("ei,qi->eq", Ufull[j][mesh.elements], bary)

    t = grid.t
    h = grid.h
    gq = 0.5 / np.sqrt(3.0)
    total = 0.0
    uq_j = uq_row(0)
    for j in range(N):
        uq_j1 = uq_row(j + 1)
        mid = 0.5 * (t[j] + t[j + 1])
        for tq in (mid - gq * h[j], mid + gq * h[j]):
            lam = (tq - t[j]) / h[j]
            uh = (1 - lam) * uq_j + lam * uq_j1
            ue = problem.exact_np(tq, flat).reshape(uh.shape)
            total += 0.5 * h[j] * np.einsum("eq,q,e->", (uh - ue) ** 2, w, measure)
        uq_j = uq_j1
    return float(np.sqrt(total))
