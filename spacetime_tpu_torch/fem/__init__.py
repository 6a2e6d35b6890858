"""Host-side P1 finite-element substrate of the port: structured meshes,
the L-shaped domain and red refinement, P1 assembly, load quadrature, time grids and the
space-time L2 error. Copies of the parts of ``spacetime_tpu.fem`` the port
runs, kept bit-for-bit equal to it (``tests/test_torch_fem.py``,
``tests/test_torch_oracle.py``)."""

from .assembly import P1System, assemble_p1, load_vector, spacetime_loads
from .errors import l2_error_spacetime
from .mesh import (Mesh, domain_mesh, l_shape_mesh, nested_interpolation,
                   refine_hierarchy, refine_uniform, sort_vertices_lex,
                   unit_cube_mesh, unit_square_mesh)
from .timegrid import (TimeGrid, graded_time_grid, time_matrices,
                       uniform_time_grid)

__all__ = [
    "Mesh",
    "unit_square_mesh",
    "unit_cube_mesh",
    "l_shape_mesh",
    "refine_uniform",
    "sort_vertices_lex",
    "refine_hierarchy",
    "nested_interpolation",
    "domain_mesh",
    "assemble_p1",
    "load_vector",
    "spacetime_loads",
    "P1System",
    "l2_error_spacetime",
    "TimeGrid",
    "uniform_time_grid",
    "graded_time_grid",
    "time_matrices",
]
