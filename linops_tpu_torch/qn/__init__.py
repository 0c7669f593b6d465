"""Quasi-Newton operators: limited-memory BFGS, forward and inverse, and the
shifted solves (B + σI) x = b on a forward L-BFGS operator."""

from .lbfgs import LBFGSState, LBFGSOperator, InverseLBFGSOperator
from .shifted_solve import solve_shifted_system, solve_shifted_systems, ldiv

__all__ = ["LBFGSState", "LBFGSOperator", "InverseLBFGSOperator", "solve_shifted_system",
           "solve_shifted_systems", "ldiv"]
