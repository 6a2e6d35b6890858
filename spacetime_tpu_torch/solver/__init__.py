"""PCG and the space-time heat-equation solver."""

from .heateq import HeatSolver, SolveResult, build_solver

__all__ = ["HeatSolver", "SolveResult", "build_solver"]
