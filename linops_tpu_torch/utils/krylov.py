"""Krylov methods: the matvec chain and preconditioned conjugate gradients.

Counterpart of ``linops_tpu/utils/krylov.py`` (``matvec_chain`` and
single-RHS ``cg``; the other solvers come with a later slice). PyTorch runs
eagerly, so the loops are host loops that enqueue device work; ``cg``
reads one scalar back per iteration (its stopping test). The reference's
TPU residency hint (``chain_resident``) has no counterpart.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException
from ..core.precision import pvdot

__all__ = ["matvec_chain", "cg"]


def matvec_chain(op: LinearOperator, v, iters: int = 100, mode: str = "N",
                 normalize: bool = True):
    """Apply ``op`` ``iters`` times (normalizing each step by default to keep
    magnitudes bounded). Returns the final vector."""
    x = v
    for _ in range(iters):
        x = op.apply(x, mode)
        if normalize:
            x = x / torch.linalg.vector_norm(x)
    return x


def cg(op: LinearOperator, b, x0=None, *, tol: float = 1e-8, maxiter: int = 100,
       M: LinearOperator = None):
    """Conjugate gradients on a symmetric positive-definite operator, with an
    optional preconditioner ``M ≈ A⁻¹`` (e.g. an ``InverseLBFGSOperator``).
    Stops when ‖r‖ ≤ tol·‖b‖ or after ``maxiter`` iterations. Returns
    (x, iterations, final residual norm as a 0-dim tensor)."""
    if b.ndim != 1:
        raise LinearOperatorException("cg takes a vector b (multi-RHS cg is not ported yet)")
    dt = torch.promote_types(b.dtype, op.dtype)
    b = b.to(dt)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    r = b - op.apply(x, "N")
    # the preconditioner's output is cast to the solver dtype so the
    # recurrence stays in one dtype even for a mixed-precision M
    z = M.apply(r, "N").to(dt) if M is not None else r
    p = z
    rz = pvdot(r, z)
    tol2 = (tol * torch.linalg.vector_norm(b)) ** 2
    rr = pvdot(r, r).real
    k = 0
    while k < maxiter and bool(rr > tol2):
        Ap = op.apply(p, "N")
        alpha = rz / pvdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M.apply(r, "N").to(dt) if M is not None else r
        rz_new = pvdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rr = pvdot(r, r).real
        k += 1
    return x, k, torch.sqrt(rr)
