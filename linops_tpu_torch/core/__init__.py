"""Operator core: base class, algebra, adjoint wrappers, apply engine, precision policy."""
