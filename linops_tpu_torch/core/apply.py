"""The apply engine: eager entry points and 5-arg ``mul`` semantics.

Counterpart of ``linops_tpu/core/apply.py``. PyTorch runs eagerly, so an
apply compiles nothing; what the port does compile is a solve's captured
CUDA graph, and ``apply_cache_sizes`` counts those (``utils/loop.py``). What
stays:
the shape checks, the eltype check on what an operator returns, and the
5-arg ``mul`` with the NaN-safe β == 0 rule: a β that is statically zero
(None or 0) never reads ``res``, and a tensor β that is zero selects
``alpha·op(v)`` without ``0·res`` (so a NaN in ``res`` cannot leak).
``matvec``, ``matmat`` and ``mul`` (and so ``op * v``) follow the rule for
distributed calls (``parallel/comm.py::dtensor_entry``), placing nothing:
a plain operator given a DTensor returns a DTensor, a partial sum reduced
to a replicated one, and a distributed operator given a plain vector
returns a DTensor in the reference's placement.
"""

from __future__ import annotations

import torch

from ..parallel.comm import dtensor_entry
from .base import LinearOperator, LinearOperatorException

__all__ = ["matvec", "matmat", "mul", "to_dense", "apply_cache_sizes"]


def _checked(op: LinearOperator, v, y):
    """Eltype check + cast: an operator whose result does not fit its
    declared dtype raises. A lazily conjugated result is materialized."""
    expected = torch.promote_types(op.dtype, v.dtype)
    if torch.promote_types(y.dtype, expected) != expected:
        raise LinearOperatorException(
            f"operator produced dtype {y.dtype} incompatible with declared "
            f"eltype {op.dtype} (expected {expected})"
        )
    return y.to(expected).resolve_conj()


def _as_tensor(op: LinearOperator, v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=op.device)


def _check_vec_shape(op: LinearOperator, v, mode: str):
    if v.ndim != 1 or v.shape[0] != op.in_dim(mode):
        raise LinearOperatorException("shape mismatch")


@dtensor_entry(place=False)
def matvec(op: LinearOperator, v, mode: str = "N"):
    """``op * v`` (mode N), ``transpose(op) * v`` (T), ``op' * v`` (H),
    ``conj(op) * v`` (C). Result dtype follows ``promote(op, v)``."""
    v = _as_tensor(op, v)
    _check_vec_shape(op, v, mode)
    op.bump(mode)
    return _checked(op, v, op.apply(v, mode))


@dtensor_entry(place=False)
def matmat(op: LinearOperator, M, mode: str = "N"):
    """Apply to a matrix column-block (SpMM / multi-RHS)."""
    M = _as_tensor(op, M)
    if M.ndim != 2 or M.shape[0] != op.in_dim(mode):
        raise LinearOperatorException("shape mismatch")
    op.bump(mode)
    return _checked(op, M, op.apply_matrix(M, mode))


def _static_zero(x) -> bool:
    return x is None or (isinstance(x, (int, float, complex)) and x == 0)


def _static_one(x) -> bool:
    return x is None or (isinstance(x, (int, float, complex)) and x == 1)


@dtensor_entry(place=False)
def mul(op: LinearOperator, v, alpha=None, beta=None, res=None, mode: str = "N",
        donate: bool = False):
    """Functional 5-arg ``mul!``: returns ``alpha * op(v) + beta * res``.

    ``v`` may be a vector or a matrix column-block; ``res`` matches its rank.

    - ``beta`` statically zero (None/0): ``res`` is never read.
    - ``beta`` a tensor: ``torch.where(beta == 0, y, y + beta·res)``.
    - ``donate=True`` writes the result into ``res`` in place and returns it
      (the reference's preallocated-``res`` semantics).
    """
    v = _as_tensor(op, v)
    if v.ndim == 2:
        if v.shape[0] != op.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        out_shape = (op.out_dim(mode), v.shape[1])
    else:
        _check_vec_shape(op, v, mode)
        out_shape = (op.out_dim(mode),)
    op.bump(mode)
    y = _checked(op, v, op.apply_matrix(v, mode) if v.ndim == 2 else op.apply(v, mode))
    if not _static_one(alpha):
        y = alpha * y
    if _static_zero(beta):
        out = y
    else:
        if res is None:
            raise LinearOperatorException("5-arg mul with nonzero beta requires res")
        if tuple(res.shape) != out_shape:
            raise LinearOperatorException(
                f"mul: res shape {tuple(res.shape)} != {out_shape}")
        if isinstance(beta, torch.Tensor):
            out = torch.where(beta == 0, y, y + beta * res)
        else:
            out = y + beta * res
    if donate and res is not None:
        res.copy_(out)
        return res
    return out


def to_dense(op: LinearOperator, block_size: int = 4096):
    """Materialize as dense by applying to identity column blocks."""
    n = op.ncol
    kw = dict(dtype=op.dtype, device=op.device)
    if n <= block_size:
        return _checked(op, torch.empty(0, **kw), op.apply_matrix(torch.eye(n, **kw), "N"))
    blocks = []
    for j0 in range(0, n, block_size):
        bs = min(block_size, n - j0)
        eye_blk = torch.zeros((n, bs), **kw)
        eye_blk[j0:j0 + bs] = torch.eye(bs, **kw)
        blocks.append(op.apply_matrix(eye_blk, "N"))
    return _checked(op, torch.empty(0, **kw), torch.cat(blocks, dim=1))


def apply_cache_sizes() -> dict:
    """What the port has compiled, for no-recompile checks (the
    reference's counts its jit caches; an apply here compiles nothing):
    ``{"signatures": solve-loop cache entries, "graphs": captured blocks
    kept, "captures": captures so far}`` from ``utils/loop.py``'s cache. A
    signature is a solve's structure (operators by identity, state fields
    such as an L-BFGS state or a shift σ by layout), recorded on the CPU as
    on the card, so none of the three grows over repeated solves of one
    structure, pushes and new shifts between them included."""
    from ..utils import loop

    return loop.cache_sizes()
