"""Meshes of ranks: the explicit time-sharded and time × space solvers on
``torch.distributed``, one process per shard.

- ``mesh``      — ``RankMesh``, ``make_time_mesh``, ``make_spacetime_mesh``;
- ``comm``      — ``Comm``: the collectives of one rank (gloo or nccl);
- ``launch``    — ``spawn_ranks`` and the rank entry functions;
- ``explicit``  — ``ExplicitHeatSolver`` (the time mesh);
- ``explicit2d`` — ``Explicit2DHeatSolver`` (the time × space mesh);
- ``general_layout`` — the general time layout (graded grids, odd P).
"""

from .comm import Comm
from .explicit import ExplicitHeatSolver
from .explicit2d import Explicit2DHeatSolver
from .launch import spawn_ranks
from .mesh import RankMesh, make_spacetime_mesh, make_time_mesh

__all__ = ["Comm", "ExplicitHeatSolver", "Explicit2DHeatSolver", "RankMesh",
           "make_spacetime_mesh", "make_time_mesh", "spawn_ranks"]
