"""Problem definitions (exact solutions in torch)."""

from .problems import PROBLEMS, Problem, get_problem, register_problem

__all__ = ["Problem", "get_problem", "register_problem", "PROBLEMS"]
