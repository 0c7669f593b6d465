"""Quasi-Newton operators: limited-memory BFGS, forward and inverse, with the
shifted solves (B + σI) x = b on a forward L-BFGS operator; limited-memory
SR1; and the diagonal quasi-Newton family."""

from .lbfgs import LBFGSState, LBFGSOperator, InverseLBFGSOperator
from .lsr1 import LSR1State, LSR1Operator
from .diagonal import (DiagonalQNOperator, DiagonalPSB, DiagonalAndrei, SpectralGradient,
                       DiagonalBFGS)
from .shifted_solve import solve_shifted_system, solve_shifted_systems, ldiv

__all__ = ["LBFGSState", "LBFGSOperator", "InverseLBFGSOperator", "LSR1State", "LSR1Operator",
           "DiagonalQNOperator", "DiagonalPSB", "DiagonalAndrei", "SpectralGradient",
           "DiagonalBFGS", "solve_shifted_system", "solve_shifted_systems", "ldiv"]
