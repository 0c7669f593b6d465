"""Iterative methods and estimators: the matvec chain and the Krylov
solvers, norm, trace, diagonal and spectral-sum estimators, the LOBPCG
eigensolver and randomized SVD, property checks, checkpointing, timing and
probe entropy."""
