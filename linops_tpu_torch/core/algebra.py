"""Lazy operator algebra nodes: Scale, Sum, Compose.

Counterpart of ``linops_tpu/core/algebra.py``: explicit graph nodes whose
``apply`` pushes the mode down to their children.
"""

from __future__ import annotations

import torch

from .base import LinearOperator, LinearOperatorException, mode_conjugated

__all__ = ["Scale", "Sum", "Compose"]


def _scalar_is_real(x) -> bool:
    """Value-based 'is this scalar real' (Julia's ``isreal``)."""
    if isinstance(x, (bool, int, float)):
        return True
    if isinstance(x, complex):
        return x.imag == 0
    if isinstance(x, torch.Tensor):
        return not x.is_complex() or bool(x.imag == 0)
    return True


def _scalar_dtype(alpha, dtype):
    """``promote(alpha, dtype)``, Python numbers weakly typed (2.0 * an f32
    operator stays f32), tensors strongly typed (as JAX arrays are)."""
    if isinstance(alpha, torch.Tensor):
        return torch.promote_types(alpha.dtype, dtype)
    return torch.result_type(torch.empty(0, dtype=dtype), alpha)


def _resolve(op: LinearOperator, mode: str) -> str:
    """Short-circuit T/H on symmetric/hermitian nodes so counters and math
    agree with the reference dispatch."""
    if mode == "T" and op.symmetric:
        return "N"
    if mode == "H" and op.hermitian:
        return "N"
    return mode


class Scale(LinearOperator):
    """``alpha * op``. Folds nested scales; H/C modes conjugate the scalar."""

    _fields_tensors = ("alpha", "op")
    _fields_static = ("_alpha_real",)

    def __init__(self, alpha, op: LinearOperator, *, alpha_real=None):
        super().__init__()
        if isinstance(op, Scale):
            # fold: a * (b * A) -> (a*b) * A
            outer_real = _scalar_is_real(alpha) if alpha_real is None else alpha_real
            self.alpha = alpha * op.alpha
            self.op = op.op
            self._alpha_real = op._alpha_real and outer_real
        else:
            self.alpha = alpha
            self.op = op
            self._alpha_real = _scalar_is_real(alpha) if alpha_real is None else alpha_real

    @property
    def nrow(self):
        return self.op.nrow

    @property
    def ncol(self):
        return self.op.ncol

    @property
    def dtype(self):
        return _scalar_dtype(self.alpha, self.op.dtype)

    @property
    def symmetric(self):
        return self.op.symmetric

    @property
    def hermitian(self):
        return self.op.hermitian and self._alpha_real

    def _alpha_for(self, mode: str):
        a = self.alpha
        if (mode_conjugated(mode) or mode == "H") and not self._alpha_real:
            a = a.conjugate() if not isinstance(a, torch.Tensor) else a.conj()
        return a

    def apply(self, v, mode: str = "N"):
        mode = _resolve(self, mode)
        return self._alpha_for(mode) * self.op.apply(v, mode)

    def apply_matrix(self, M, mode: str = "N"):
        mode = _resolve(self, mode)
        return self._alpha_for(mode) * self.op.apply_matrix(M, mode)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        self.op.bump(_resolve(self, mode), n)

    def _name(self):
        return "Scaled operator"


class Sum(LinearOperator):
    """``op1 + op2`` with ANDed flags. Structural symmetry (``x + x^H`` /
    ``x + x^T`` on the same object) is detected once, at construction."""

    _fields_tensors = ("op1", "op2")
    _fields_static = ("_struct_herm", "_struct_symm")

    def __init__(self, op1: LinearOperator, op2: LinearOperator):
        super().__init__()
        if op1.shape != op2.shape:
            raise LinearOperatorException("shape mismatch")
        self.op1 = op1
        self.op2 = op2
        from .adjoint import AdjointOperator, TransposeOperator

        adj = self._is_structural_pair(AdjointOperator)
        trans = self._is_structural_pair(TransposeOperator)
        real = not self.dtype.is_complex
        self._struct_herm = adj or (real and trans)
        self._struct_symm = trans or (real and adj)

    def _is_structural_pair(self, cls) -> bool:
        return (isinstance(self.op2, cls) and self.op2.parent is self.op1) or (
            isinstance(self.op1, cls) and self.op1.parent is self.op2
        )

    @property
    def nrow(self):
        return self.op1.nrow

    @property
    def ncol(self):
        return self.op1.ncol

    @property
    def dtype(self):
        return torch.promote_types(self.op1.dtype, self.op2.dtype)

    @property
    def symmetric(self):
        return self._struct_symm or (self.op1.symmetric and self.op2.symmetric)

    @property
    def hermitian(self):
        return self._struct_herm or (self.op1.hermitian and self.op2.hermitian)

    def apply(self, v, mode: str = "N"):
        mode = _resolve(self, mode)
        return self.op1.apply(v, mode) + self.op2.apply(v, mode)

    def apply_matrix(self, M, mode: str = "N"):
        mode = _resolve(self, mode)
        return self.op1.apply_matrix(M, mode) + self.op2.apply_matrix(M, mode)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        mode = _resolve(self, mode)
        self.op1.bump(mode, n)
        self.op2.bump(mode, n)

    def _name(self):
        return "Sum of operators"


class Compose(LinearOperator):
    """``op1 @ op2``: flags are always (False, False); (AB)ᵀ = BᵀAᵀ, so T/H
    modes reverse the traversal order."""

    _fields_tensors = ("op1", "op2")
    _fields_static = ()

    def __init__(self, op1: LinearOperator, op2: LinearOperator):
        super().__init__()
        if op1.ncol != op2.nrow:
            raise LinearOperatorException("shape mismatch")
        self.op1 = op1
        self.op2 = op2

    @property
    def nrow(self):
        return self.op1.nrow

    @property
    def ncol(self):
        return self.op2.ncol

    @property
    def dtype(self):
        return torch.promote_types(self.op1.dtype, self.op2.dtype)

    def apply(self, v, mode: str = "N"):
        if mode in ("N", "C"):
            return self.op1.apply(self.op2.apply(v, mode), mode)
        return self.op2.apply(self.op1.apply(v, mode), mode)

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "C"):
            return self.op1.apply_matrix(self.op2.apply_matrix(M, mode), mode)
        return self.op2.apply_matrix(self.op1.apply_matrix(M, mode), mode)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        self.op1.bump(mode, n)
        self.op2.bump(mode, n)

    def _name(self):
        return "Composition of operators"
