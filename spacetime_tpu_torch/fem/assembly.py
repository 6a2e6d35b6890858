"""P1 finite-element assembly and load quadrature on the host.

The port's copy of the numpy engine of ``spacetime_tpu/fem/assembly.py``:
element loops vectorised over all simplices, scipy CSR out, the same
operations in the same order, so the matrices and the loads equal the JAX
package's bit for bit, the weighted spatial form ∫κ∇u·∇v + c·uv included.
It runs once per solver; no iteration touches it. On-device load
quadrature is queue 1 item 3 (ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

from .mesh import Mesh


def host_map(fn, items):
    """``fn`` over ``items`` on ``torch.get_num_threads()`` host threads (a
    mesh rank's share of the cores), results in order: numpy's and scipy's
    kernels release the GIL, so the quadratures' rows overlap. At most one
    call a thread is in flight."""
    workers = max(1, torch.get_num_threads())
    if workers == 1:
        yield from map(fn, items)
        return
    with ThreadPoolExecutor(workers) as pool:
        pending = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def _check_nondegenerate(det: np.ndarray, what: str) -> None:
    """Zero-measure elements make the barycentric gradients inf/NaN: fail
    with the element ids instead."""
    bad = np.flatnonzero(det == 0.0)
    if bad.size:
        raise ValueError(
            f"{bad.size} degenerate (zero-{what}) element(s), e.g. ids "
            f"{bad[:5].tolist()}"
        )


def _tri_geometry(mesh: Mesh):
    v = mesh.vertices[mesh.elements]  # (ne, 3, 2)
    d1 = v[:, 1] - v[:, 0]
    d2 = v[:, 2] - v[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    _check_nondegenerate(det, "area")
    area = np.abs(det) / 2.0
    # Gradients of the barycentric basis functions.
    g1 = np.stack([d2[:, 1], -d2[:, 0]], axis=1) / det[:, None]
    g2 = np.stack([-d1[:, 1], d1[:, 0]], axis=1) / det[:, None]
    g0 = -g1 - g2
    grads = np.stack([g0, g1, g2], axis=1)  # (ne, 3, 2)
    return area, grads


def _tet_geometry(mesh: Mesh):
    v = mesh.vertices[mesh.elements]  # (ne, 4, 3)
    D = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], axis=1)
    det = np.linalg.det(D)
    _check_nondegenerate(det, "volume")
    vol = np.abs(det) / 6.0
    Dinv = np.linalg.inv(D)  # rows of Dinv^T are gradients of bary 1..3
    g = np.transpose(Dinv, (0, 2, 1))  # (ne, 3, 3): g[:, i] = grad lambda_{i+1}
    g0 = -g.sum(axis=1)
    grads = np.concatenate([g0[:, None, :], g], axis=1)  # (ne, 4, 3)
    return vol, grads


def _geometry(mesh: Mesh):
    return _tri_geometry(mesh) if mesh.dim == 2 else _tet_geometry(mesh)


def assemble_p1(
    mesh: Mesh, kappa=None, reaction=None
) -> tuple[sp.csr_matrix, sp.csr_matrix]:
    """Full (all-vertex) P1 mass and spatial-form matrices (M, A) as CSR;
    ``P1System.from_mesh`` keeps the Dirichlet-interior block. With the
    optional coefficients (callables (n, d) -> (n,), evaluated at element
    centroids), A is the weighted form ∫κ∇u·∇v + c·uv; M is always the
    plain mass matrix."""
    d = mesh.dim
    nloc = d + 1
    kv = cv = None
    if kappa is not None or reaction is not None:
        centroids = mesh.vertices[mesh.elements].mean(axis=1)
        if kappa is not None:
            kv = np.asarray(kappa(centroids), np.float64)
            if kv.min() <= 0.0:
                raise ValueError("diffusion coefficient must be positive")
        if reaction is not None:
            cv = np.asarray(reaction(centroids), np.float64)
            if cv.min() < 0.0:
                raise ValueError("reaction coefficient must be nonnegative")
    if d == 2:
        mass_scale = 1.0 / 12.0  # int lam_i lam_j = area/12 * (1 + delta_ij)
    elif d == 3:
        mass_scale = 1.0 / 20.0
    else:
        raise ValueError(f"unsupported dim {d}")
    measure, grads = _geometry(mesh)

    # Local matrices, vectorized over elements.
    K = measure[:, None, None] * np.einsum("eid,ejd->eij", grads, grads)
    Mloc = (np.ones((nloc, nloc)) + np.eye(nloc)) * mass_scale
    Mel = measure[:, None, None] * Mloc[None]
    if kv is not None:
        K = kv[:, None, None] * K
    if cv is not None:
        K = K + cv[:, None, None] * Mel

    rows = np.repeat(mesh.elements, nloc, axis=1).ravel()
    cols = np.tile(mesh.elements, (1, nloc)).ravel()
    nv = mesh.num_vertices
    # coo -> csr conversion already sums duplicate entries
    A = sp.coo_matrix((K.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    M = sp.coo_matrix((Mel.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    return M, A


def _quad_rule(dim: int):
    """Degree-2-exact quadrature in barycentric coordinates: (bary, weights)."""
    if dim == 2:
        # Edge-midpoint rule, exact for quadratics.
        bary = np.array(
            [[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]], dtype=np.float64
        )
        w = np.full(3, 1.0 / 3.0)
    elif dim == 3:
        a = (5.0 - np.sqrt(5.0)) / 20.0
        b = 1.0 - 3.0 * a
        bary = np.full((4, 4), a)
        np.fill_diagonal(bary, b)
        w = np.full(4, 0.25)
    else:
        raise ValueError(f"unsupported dim {dim}")
    return bary, w


def load_vector(mesh: Mesh, f) -> np.ndarray:
    """The load vector f_k = ∫_Ω f φ_k dx over all vertices; ``f`` maps an
    (nq, d) array of points to (nq,) values (degree-2-exact rule)."""
    bary, w = _quad_rule(mesh.dim)
    v = mesh.vertices[mesh.elements]  # (ne, nloc, d)
    measure, _ = _geometry(mesh)
    pts = np.einsum("qi,eid->eqd", bary, v)  # (ne, nq, d)
    fvals = np.asarray(f(pts.reshape(-1, mesh.dim))).reshape(pts.shape[:2])
    # phi_k at quad point q equals bary[q, local_index(k)].
    contrib = np.einsum("eq,q,qi->ei", fvals, w, bary) * measure[:, None]
    out = np.zeros(mesh.num_vertices)
    np.add.at(out, mesh.elements.ravel(), contrib.ravel())
    return out


def spacetime_loads(problem, mesh: Mesh, grid, rows: slice | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Half-interval space-time loads of the stabilized formulation.

    Returns (gL, gR, u0_vec): gL/gR (N, m_interior) with
    gL[j,k] = ∫_{left half of interval j} ∫_Ω g φ_k (2-point Gauss per
    half), and u0_vec[k] = ∫_Ω u0 φ_k, all on interior vertices.
    ``problem`` gives ``g_many(ts, X)`` and ``u0(X)``. ``rows``: only these
    intervals' rows of gL/gR (a time shard's), each equal to the full
    computation's (every interval's loads are computed on their own).
    """
    idx = mesh.interior
    t = grid.t
    h = grid.h
    if rows is not None:
        t = t[rows.start: rows.stop + 1]
        h = h[rows]
    N = h.size
    gq = 0.5 / np.sqrt(3.0)

    # Quadrature times: per interval, 2-point Gauss on each half.
    hh = 0.5 * h
    mids = np.stack([t[:-1] + 0.5 * hh, t[:-1] + 1.5 * hh], axis=1)  # (N, 2)
    tq = np.stack(
        [mids - gq * hh[:, None], mids + gq * hh[:, None]], axis=2
    ).reshape(N, 2, 2)  # (interval, half, gauss point)

    # Spatial quadrature structures, built once.
    bary, w = _quad_rule(mesh.dim)
    measure = _geometry(mesh)[0]
    v = mesh.vertices[mesh.elements]
    pts = np.einsum("qi,eid->eqd", bary, v).reshape(-1, mesh.dim)
    nq = bary.shape[0]
    nloc = mesh.elements.shape[1]
    ne = mesh.elements.shape[0]
    inv = -np.ones(mesh.num_vertices, dtype=np.int64)
    inv[idx] = np.arange(idx.size)
    # One sparse matrix (m_interior, ne·nq) folds quadrature weights, basis
    # values and element measures: loads = S2 · g(points), with no
    # (times, elements, nloc) intermediate.
    row_q = (np.arange(ne)[:, None] * nq + np.arange(nq)[None, :])  # (ne, nq)
    WB = w[:, None] * bary  # (nq, nloc)
    rows, cols, data = [], [], []
    for l in range(nloc):
        c = inv[mesh.elements[:, l]]  # (ne,)
        keep = c >= 0
        rows.append(np.repeat(c[keep], nq))
        cols.append(row_q[keep].ravel())
        data.append((measure[keep, None] * WB[None, :, l]).ravel())
    S2 = sp.csr_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(idx.size, ne * nq),
    )

    def half_loads(times_flat: np.ndarray) -> np.ndarray:
        """(k,) times -> (k, m) interior loads, one g evaluation per chunk
        (the chunk bounds the g-values buffer to ~1 GB), S2 applied to each
        time's row on the host's threads (``host_map``): a row's sums are
        those of S2 on the whole chunk, with no transposed copy of it."""
        out = np.empty((times_flat.size, idx.size))
        chunk = max(1, int(1.2e8 // max(pts.shape[0], 1)))
        for lo in range(0, times_flat.size, chunk):
            ts = times_flat[lo : lo + chunk]
            fvals = problem.g_many(ts, pts)  # (k, ne*nq)

            def fold(i):
                out[lo + i] = S2.dot(fvals[i])

            for _ in host_map(fold, range(ts.size)):
                pass
        return out

    loads = half_loads(tq.reshape(-1)).reshape(N, 2, 2, idx.size)
    weights = 0.5 * hh  # per Gauss point on each half
    gL = weights[:, None] * loads[:, 0].sum(axis=1)
    gR = weights[:, None] * loads[:, 1].sum(axis=1)

    u0_vec = load_vector(mesh, problem.u0)[idx]
    return gL, gR, u0_vec


@dataclasses.dataclass(frozen=True)
class P1System:
    """Interior-block spatial operators of a Dirichlet problem: the mesh,
    the interior mass matrix M and spatial-form matrix A (m×m CSR: the
    stiffness matrix, or the weighted form ∫κ∇u·∇v + c·uv). ``weighted``
    is True when A carries non-constant coefficients: it is then not a
    constant stencil, and the solver takes the ``"vstencil"`` format."""

    mesh: Mesh
    M: sp.csr_matrix
    A: sp.csr_matrix
    weighted: bool = False

    @classmethod
    def from_mesh(cls, mesh: Mesh, kappa=None, reaction=None) -> "P1System":
        """``kappa`` / ``reaction``: optional coefficient callables
        (n, d) -> (n,) (see :func:`assemble_p1`)."""
        Mfull, Afull = assemble_p1(mesh, kappa=kappa, reaction=reaction)
        idx = mesh.interior
        return cls(
            mesh,
            Mfull[idx][:, idx].tocsr(),
            Afull[idx][:, idx].tocsr(),
            weighted=kappa is not None or reaction is not None,
        )

    @classmethod
    def from_problem(cls, problem, mesh: Mesh) -> "P1System":
        """The spatial form a problem prescribes: the plain heat operator,
        or the κ/c-weighted form."""
        kap = problem.kappa_np if problem.kappa is not None else None
        rea = problem.reaction_np if problem.reaction is not None else None
        return cls.from_mesh(mesh, kappa=kap, reaction=rea)

    @property
    def m(self) -> int:
        return self.mesh.num_interior
