"""Quasi-Newton operators: limited-memory BFGS, forward and inverse."""

from .lbfgs import LBFGSState, LBFGSOperator, InverseLBFGSOperator

__all__ = ["LBFGSState", "LBFGSOperator", "InverseLBFGSOperator"]
