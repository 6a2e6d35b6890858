"""Simplicial meshes: the structured unit square and unit cube, and the
L-shaped domain.

The port's copy of ``spacetime_tpu/fem/mesh.py`` as far as the port runs
it: the same vertex order, elements, boundary mask and interior indices, so
the assembled operators are the JAX package's bit for bit. Structured meshes
carry a ``grid_shape``, which makes the interior P1 operators constant
stencils; the L-shaped domain has none and runs the flat-dof formats
(``"dia"``, ``"ell"``). ``refine_uniform`` red-refines any triangle or
tetrahedron mesh and records the parent edges (``Mesh.refined_from``);
``refine_hierarchy`` lex-sorts each level to keep the matrices banded, and
``nested_interpolation`` is the exact nested-P1 embedding the unstructured
multigrid hierarchy (``ops.multigrid.NestedMultiShiftMultigrid``) is built
from. Imported meshes belong to queue 1 item 5 of ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A simplicial mesh with Dirichlet boundary bookkeeping.

    Attributes:
      vertices: (nv, d) float64 vertex coordinates.
      elements: (ne, d+1) int32 vertex indices per simplex.
      boundary: (nv,) bool mask of Dirichlet-boundary vertices.
      interior: (m,) int32 indices of interior (free) vertices.
      grid_shape: per-axis interior node counts (z, y, x order).
      refined_from: for meshes made by ``refine_uniform``, the tuple
        (coarse_mesh, parent_edges): parent_edges[i] = (a, b) are the
        coarse vertices whose midpoint is fine vertex i (a == b for
        inherited vertices).
    """

    vertices: np.ndarray
    elements: np.ndarray
    boundary: np.ndarray
    interior: np.ndarray
    grid_shape: tuple[int, ...] | None = None
    refined_from: tuple | None = None

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_interior(self) -> int:
        return self.interior.shape[0]


def _unit_boundary(vertices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(boundary mask, interior indices) of vertices of the unit square or
    cube: a vertex is on the boundary where any coordinate is 0 or 1."""
    on_bdry = np.zeros(vertices.shape[0], dtype=bool)
    for d in range(vertices.shape[1]):
        on_bdry |= np.isclose(vertices[:, d], 0.0) | np.isclose(vertices[:, d], 1.0)
    return on_bdry, np.flatnonzero(~on_bdry).astype(np.int32)


def unit_square_mesh(n: int) -> Mesh:
    """Structured triangulation of (0,1)^2 with n×n cells, SW–NE diagonals.

    Vertices are ordered lexicographically (y-major, x-fastest); interior
    vertices form an (n-1)×(n-1) grid.
    """
    if n < 2:
        raise ValueError("need n >= 2 for a nonempty interior")
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")  # X[iy, ix]
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    v00 = (iy * (n + 1) + ix).ravel()
    v10 = v00 + 1
    v01 = v00 + (n + 1)
    v11 = v01 + 1
    # Split every cell along the SW–NE diagonal (v00–v11).
    tris = np.concatenate(
        [
            np.stack([v00, v10, v11], axis=1),
            np.stack([v00, v11, v01], axis=1),
        ],
        axis=0,
    ).astype(np.int32)
    on_bdry, interior = _unit_boundary(vertices)
    return Mesh(vertices, tris, on_bdry, interior, grid_shape=(n - 1, n - 1))


_KUHN_PERMS = [
    (0, 1, 2),
    (0, 2, 1),
    (1, 0, 2),
    (1, 2, 0),
    (2, 0, 1),
    (2, 1, 0),
]


def unit_cube_mesh(n: int) -> Mesh:
    """Kuhn triangulation of (0,1)^3: each of the n^3 cells splits into 6
    tets, one per axis ordering of the walk from the cell's origin corner to
    the opposite corner."""
    if n < 2:
        raise ValueError("need n >= 2 for a nonempty interior")
    xs = np.linspace(0.0, 1.0, n + 1)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):  # x-index i, y-index j, z-index k
        return (k * (n + 1) + j) * (n + 1) + i

    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    strides = np.array([1, n + 1, (n + 1) ** 2], dtype=np.int64)
    base = vid(i, j, k)
    tets = []
    for perm in _KUHN_PERMS:
        p0 = base
        p1 = p0 + strides[perm[0]]
        p2 = p1 + strides[perm[1]]
        p3 = p2 + strides[perm[2]]
        tets.append(np.stack([p0, p1, p2, p3], axis=1))
    tets = np.concatenate(tets, axis=0).astype(np.int32)
    on_bdry, interior = _unit_boundary(vertices)
    return Mesh(vertices, tets, on_bdry, interior, grid_shape=(n - 1, n - 1, n - 1))


def _boundary_vertex_mask(num_vertices: int, elements: np.ndarray) -> np.ndarray:
    """Topological boundary detection: a facet (edge in 2D, face in 3D) is on
    the boundary iff it belongs to exactly one element; boundary vertices are
    the vertices of boundary facets (the whole boundary is Dirichlet)."""
    k = elements.shape[1]  # d+1 vertices per simplex
    d = k - 1
    facets = np.concatenate(
        [elements[:, list(c)] for c in itertools.combinations(range(k), d)],
        axis=0,
    )
    F = np.sort(facets.astype(np.int64), axis=1)
    order = np.lexsort(F.T[::-1])
    Fs = F[order]
    new = np.ones(len(Fs), dtype=bool)
    new[1:] = (Fs[1:] != Fs[:-1]).any(axis=1)
    grp = np.cumsum(new) - 1
    counts = np.bincount(grp)
    bdry = Fs[new][counts == 1]
    mask = np.zeros(num_vertices, dtype=bool)
    mask[bdry.ravel()] = True
    return mask


def l_shape_mesh(n: int) -> Mesh:
    """L-shaped domain (0,1)² minus the closed quadrant [½,1]², n×n base cells
    (n even), SW–NE diagonals; no ``grid_shape``."""
    if n < 4 or n % 2:
        raise ValueError("need even n >= 4")
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    vertices_full = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    keep = ~((ix >= n // 2) & (iy >= n // 2))
    ix, iy = ix[keep].ravel(), iy[keep].ravel()
    v00 = iy * (n + 1) + ix
    v10 = v00 + 1
    v01 = v00 + (n + 1)
    v11 = v01 + 1
    tris = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)],
        axis=0,
    )
    used = np.unique(tris)
    remap = np.full(vertices_full.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    vertices = vertices_full[used]
    tris = remap[tris].astype(np.int32)

    on_bdry = _boundary_vertex_mask(vertices.shape[0], tris)
    interior = np.flatnonzero(~on_bdry).astype(np.int32)
    return Mesh(vertices, tris, on_bdry, interior, grid_shape=None)


_TET_CHILDREN_CORNERS = [(0, 4, 5, 6), (4, 1, 7, 8), (5, 7, 2, 9), (6, 8, 9, 3)]
# Bey's red refinement of the inner octahedron along the m02–m13 diagonal
# (local ids: 4=m01, 5=m02, 6=m03, 7=m12, 8=m13, 9=m23).
_TET_CHILDREN_OCTA = [(4, 5, 6, 8), (4, 5, 7, 8), (5, 6, 8, 9), (5, 7, 8, 9)]


def refine_uniform(mesh: Mesh) -> Mesh:
    """Red uniform refinement of a triangle or tetrahedron mesh: every edge
    is bisected; a triangle splits into 4 similar children, a tetrahedron
    into 4 corner tets and 4 octahedron tets (Bey's rule). The result has
    no ``grid_shape`` and records its parents in ``refined_from``."""
    V, E = mesh.vertices, mesh.elements.astype(np.int64)
    k = E.shape[1]
    pair_ids = list(itertools.combinations(range(k), 2))
    edges = np.sort(
        np.concatenate([E[:, list(c)] for c in pair_ids], axis=0), axis=1
    )
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid_ids = V.shape[0] + inv.reshape(len(pair_ids), -1)  # (npairs, ne)
    midpoints = 0.5 * (V[uniq[:, 0]] + V[uniq[:, 1]])
    vertices = np.concatenate([V, midpoints], axis=0)

    if k == 3:  # triangles: local ids 3=m01, 4=m02, 5=m12
        loc = np.stack([E[:, 0], E[:, 1], E[:, 2], *mid_ids], axis=1)
        children = [(0, 3, 4), (1, 5, 3), (2, 4, 5), (3, 5, 4)]
    elif k == 4:  # tets: pair order (01,02,03,12,13,23) -> local ids 4..9
        loc = np.stack([E[:, 0], E[:, 1], E[:, 2], E[:, 3], *mid_ids], axis=1)
        children = _TET_CHILDREN_CORNERS + _TET_CHILDREN_OCTA
    else:
        raise ValueError(f"unsupported element arity {k}")
    elements = np.concatenate([loc[:, list(c)] for c in children], axis=0)
    elements = elements.astype(np.int32)

    on_bdry = _boundary_vertex_mask(vertices.shape[0], elements)
    interior = np.flatnonzero(~on_bdry).astype(np.int32)
    # inherited vertices are their own parents; new ones are midpoints of
    # the unique coarse edges
    nv = V.shape[0]
    own = np.stack([np.arange(nv), np.arange(nv)], axis=1)
    parent_edges = np.concatenate([own, uniq], axis=0).astype(np.int32)
    return Mesh(vertices, elements, on_bdry, interior, grid_shape=None,
                refined_from=(mesh, parent_edges))


def sort_vertices_lex(mesh: Mesh) -> Mesh:
    """Reorder the vertices lexicographically (last coordinate major, first
    fastest), which makes a refined grid-like mesh's matrices banded again
    (``refine_uniform`` appends the midpoints after the inherited
    vertices); the parent links are row-permuted along."""
    key = tuple(mesh.vertices[:, d] for d in range(mesh.dim))
    order = np.lexsort(key)
    inv = np.empty(order.size, dtype=np.int64)
    inv[order] = np.arange(order.size)
    boundary = mesh.boundary[order]
    refined_from = mesh.refined_from
    if refined_from is not None:
        coarse, pe = refined_from
        refined_from = (coarse, pe[order])
    return Mesh(
        mesh.vertices[order],
        inv[mesh.elements.astype(np.int64)].astype(np.int32),
        boundary,
        np.flatnonzero(~boundary).astype(np.int32),
        grid_shape=None,
        refined_from=refined_from,
    )


def refine_hierarchy(base: Mesh, refines: int, sort: bool = True) -> Mesh:
    """``refines`` red refinements of ``base``, each level lex-sorted
    (``sort``), with the parent chain recorded in ``refined_from``."""
    mesh = base
    for _ in range(refines):
        mesh = refine_uniform(mesh)
        if sort:
            mesh = sort_vertices_lex(mesh)
    return mesh


def nested_interpolation(fine: Mesh) -> sp.csr_matrix:
    """The nested-P1 embedding P (interior fine × interior coarse, CSR) of
    a mesh made by ``refine_uniform``: an inherited vertex takes its
    parent's value (weight 1), a midpoint the mean of its edge's ends
    (½, ½); Dirichlet parents are dropped. Restriction is Pᵀ."""
    if fine.refined_from is None:
        raise ValueError("mesh carries no refinement record (refined_from)")
    coarse, pe = fine.refined_from
    c2i = np.full(coarse.num_vertices, -1, dtype=np.int64)
    c2i[coarse.interior] = np.arange(coarse.num_interior)
    fi = fine.interior.astype(np.int64)
    rows, cols, vals = [], [], []
    for side in (0, 1):
        parent = pe[fi, side].astype(np.int64)
        # ½ per edge end; an inherited vertex lists itself twice, and the
        # duplicate sum restores its weight 1
        w = np.full(fi.size, 0.5)
        ci = c2i[parent]
        keep = ci >= 0
        rows.append(np.arange(fi.size)[keep])
        cols.append(ci[keep])
        vals.append(w[keep])
    P = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(fine.num_interior, coarse.num_interior),
    )
    P.sum_duplicates()
    return P


def domain_mesh(domain: str, dim: int, n: int) -> Mesh:
    """Mesh factory keyed by a problem's domain tag."""
    if domain == "unit":
        return unit_square_mesh(n) if dim == 2 else unit_cube_mesh(n)
    if domain == "lshape":
        if dim != 2:
            raise ValueError("lshape domain is 2D")
        return l_shape_mesh(n)
    raise ValueError(f"unknown domain {domain!r}")
