"""Iterative methods: the matvec chain and conjugate gradients."""
