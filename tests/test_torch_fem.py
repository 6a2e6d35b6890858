"""The port's own host modules (``spacetime_tpu_torch.fem``, ``ops.sparse``,
``ops.stencil``, ``ops.wavelets``, ``ops.multigrid``) against the JAX
package's, bit for bit: meshes, CSR matrices, stencils, wavelet structure,
multigrid levels, the mass spectral bounds and the space-time loads, in 2-D
and 3-D."""

import dataclasses

import numpy as np
import pytest

from spacetime_tpu import fem as jfem
from spacetime_tpu.ops import multigrid as jmg
from spacetime_tpu.ops.sparse import DiaMatrix as JDia
from spacetime_tpu.ops.stencil import StencilOperator as JStencil
from spacetime_tpu.ops.wavelets import build_wavelet_transform as jwavelets
from spacetime_tpu_torch import fem
from spacetime_tpu_torch.models import get_problem
from spacetime_tpu_torch.ops import multigrid as mg
from spacetime_tpu_torch.ops import wavelets as wav
from spacetime_tpu_torch.ops.sparse import DiaMatrix
from spacetime_tpu_torch.ops.stencil import StencilOperator

MESHES = {2: ("unit_square_mesh", 8), 3: ("unit_cube_mesh", 8)}


def _equal(got, want, path=""):
    """Exact equality of numpy arrays, scipy matrices, numbers and nested
    tuples / dataclasses."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _equal(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif hasattr(want, "tocsr"):
        g, w = got.tocsr(), want.tocsr()
        assert g.shape == w.shape, path
        for a in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(g, a), getattr(w, a), path)
            assert getattr(g, a).dtype == getattr(w, a).dtype, path
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, path)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    else:
        assert got == want and type(got) is type(want), (path, got, want)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def systems(request):
    name, n = MESHES[request.param]
    port = fem.P1System.from_mesh(getattr(fem, name)(n))
    ref = jfem.P1System.from_mesh(getattr(jfem, name)(n))
    return port, ref


def test_mesh_equal(systems):
    port, ref = systems
    for f in ("vertices", "elements", "boundary", "interior", "grid_shape"):
        _equal(getattr(port.mesh, f), getattr(ref.mesh, f), f)
    assert port.m == ref.m


def test_csr_matrices_equal(systems):
    port, ref = systems
    _equal(port.M, ref.M, "M")
    _equal(port.A, ref.A, "A")
    Mf, Af = fem.assemble_p1(port.mesh)
    jMf, jAf = jfem.assemble_p1(ref.mesh, engine="numpy")
    _equal(Mf, jMf, "M full")
    _equal(Af, jAf, "A full")


def test_dia_and_stencils_equal(systems):
    port, ref = systems
    gs = tuple(port.mesh.grid_shape)
    for mat in ("M", "A"):
        dia, jdia = (DiaMatrix.from_csr(getattr(port, mat)),
                     JDia.from_csr(getattr(ref, mat)))
        _equal(dia.offsets, jdia.offsets, mat)
        _equal(dia.vals, jdia.vals, mat)
        st, jst = StencilOperator.from_dia(dia, gs), JStencil.from_dia(jdia, gs)
        _equal(st.disps, jst.disps, mat)
        _equal(st.weights, jst.weights, mat)
        assert st.grid_shape == jst.grid_shape


@pytest.mark.parametrize("J", [2, 5])
def test_time_grid_and_wavelets_equal(J):
    grid, jgrid = fem.uniform_time_grid(J), jfem.uniform_time_grid(J)
    for f in ("t", "level", "parent_left", "parent_right"):
        _equal(getattr(grid, f), getattr(jgrid, f), f)
    tm, jtm = fem.time_matrices(grid), jfem.time_matrices(jgrid)
    for k in ("h", "A_t", "M_t", "G_t"):
        _equal(tm[k], jtm[k], k)
    wt, jwt = wav.build_wavelet_transform(grid), jwavelets(jgrid)
    for f in ("root_idx", "root_s", "node_level", "node_omega", "level_shift",
              "perm_by_level", "level_counts"):
        _equal(getattr(wt, f), getattr(jwt, f), f)
    _equal(wt.levels, jwt.levels, "levels")
    assert wt.is_uniform and jwt.is_uniform
    _equal(wt.dense(), jwt.dense(), "dense")
    x = np.random.default_rng(J).standard_normal((grid.num_nodes, 3))
    _equal(wt.adjoint_np(x), jwt.adjoint_np(x), "adjoint_np")


@pytest.mark.parametrize("dim, n, n_coarse", [(2, 32, 8), (3, 16, 4)])
def test_multigrid_levels_equal(dim, n, n_coarse):
    msmg, (A_c, M_c) = mg.MultiShiftMultigrid.build(dim, n, nu=2,
                                                    n_coarse=n_coarse)
    jmsmg, (jA_c, jM_c) = jmg.MultiShiftMultigrid.build(dim, n, nu=2,
                                                        n_coarse=n_coarse)
    assert (msmg.dim, msmg.nu, msmg.n_coarse, msmg.nu_post) == (
        jmsmg.dim, jmsmg.nu, jmsmg.n_coarse, jmsmg.nu_post)
    assert len(msmg.levels) == len(jmsmg.levels) >= 2
    for lev, jlev in zip(msmg.levels, jmsmg.levels):
        for f in ("cA", "cM", "gA", "gM", "n"):
            _equal(getattr(lev, f), getattr(jlev, f), f)
        for st in ("A_st", "M_st"):
            _equal(getattr(lev, st).disps, getattr(jlev, st).disps, st)
            _equal(getattr(lev, st).weights, getattr(jlev, st).weights, st)
    _equal(A_c, jA_c, "A_c")
    _equal(M_c, jM_c, "M_c")


@pytest.mark.parametrize("dim", [2, 3])
def test_mass_spectral_bounds_equal(dim):
    assert mg.mass_spectral_bounds(dim) == jmg.mass_spectral_bounds(dim)


@pytest.mark.parametrize("dim, n", [(2, 8), (3, 4)], ids=["9x9x4", "5x5x5x4"])
def test_spacetime_loads_equal(dim, n):
    """The same source (the port's problem) through both quadratures."""
    problem = get_problem(f"smooth{dim}d")
    mesh = fem.domain_mesh("unit", dim, n)
    jmesh = jfem.domain_mesh("unit", dim, n)
    grid, jgrid = fem.uniform_time_grid(2), jfem.uniform_time_grid(2)
    got = fem.spacetime_loads(problem, mesh, grid)
    want = jfem.spacetime_loads(problem, jmesh, jgrid)
    for g, w, name in zip(got, want, ("gL", "gR", "u0")):
        _equal(g, w, name)
    U = np.random.default_rng(dim).standard_normal((grid.num_nodes, mesh.num_interior))
    from spacetime_tpu.fem.errors import l2_error_spacetime as jl2

    assert fem.l2_error_spacetime(problem, mesh, grid, U) == jl2(
        problem, jmesh, jgrid, U)


def test_lshape_is_later():
    """The L-shaped domain is ported (``tests/test_torch_oracle.py`` holds
    it bit for bit; its red refinement ``tests/test_torch_nested.py``); it
    carries no grid and no refinement record, and is 2-D only, as in the
    JAX package."""
    mesh = fem.domain_mesh("lshape", 2, 8)
    assert mesh.grid_shape is None and mesh.refined_from is None
    _equal(mesh.interior, jfem.domain_mesh("lshape", 2, 8).interior)
    with pytest.raises(ValueError, match="2D"):
        fem.domain_mesh("lshape", 3, 8)
