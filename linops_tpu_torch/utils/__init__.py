"""Iterative methods: the matvec chain and the Krylov solvers."""
