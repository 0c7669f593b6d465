"""Matrix-backed and function-backed leaf operators + the user-facing factory.

Counterpart of ``linops_tpu/core/dense.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .base import LinearOperator, LinearOperatorException
from .precision import pmatmul

__all__ = ["MatrixOperator", "FunctionOperator", "make_operator", "aslinearoperator"]


class MatrixOperator(LinearOperator):
    """Dense-matrix-backed operator; transpose/adjoint modes contract on the
    other side instead of materializing Aᵀ."""

    _fields_tensors = ("A",)
    _fields_static = ("_symmetric", "_hermitian")

    def __init__(self, A, *, symmetric: Optional[bool] = None, hermitian: Optional[bool] = None):
        super().__init__()
        A = torch.as_tensor(A)
        if A.ndim != 2:
            raise LinearOperatorException("MatrixOperator requires a 2-D array")
        self.A = A
        self._symmetric = bool(symmetric) if symmetric is not None else False
        self._hermitian = bool(hermitian) if hermitian is not None else False

    @property
    def nrow(self):
        return self.A.shape[0]

    @property
    def ncol(self):
        return self.A.shape[1]

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _prod(self, v):
        return pmatmul(self.A, v)

    def _tprod(self, u):
        return pmatmul(u, self.A)  # u @ A == Aᵀ u without a transpose copy

    def _ctprod(self, w):
        if self.A.is_complex() or w.is_complex():
            return pmatmul(w.conj(), self.A).conj()
        return pmatmul(w, self.A)

    def apply_matrix(self, M, mode: str = "N"):
        if mode == "N":
            return pmatmul(self.A, M)
        if mode == "T":
            return pmatmul(self.A.T, M)
        if mode == "H":
            return pmatmul(self.A.conj().T, M)
        return pmatmul(self.A.conj(), M)

    def _name(self):
        return "Matrix operator"


class FunctionOperator(LinearOperator):
    """Operator backed by product functions on tensors.

    ``prod(v) -> y`` is required; ``tprod``/``ctprod`` are optional and the
    inference lattice fills the gaps (or raises 'unable to infer ...')."""

    _fields_tensors = ()
    _fields_static = ("_nrow", "_ncol", "_symmetric", "_hermitian", "_dtype",
                      "_prod_fn", "_tprod_fn", "_ctprod_fn")

    def __init__(
        self,
        nrow: int,
        ncol: int,
        prod: Callable,
        tprod: Optional[Callable] = None,
        ctprod: Optional[Callable] = None,
        *,
        symmetric: bool = False,
        hermitian: bool = False,
        dtype=None,
    ):
        super().__init__()
        self._nrow = int(nrow)
        self._ncol = int(ncol)
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)
        self._dtype = torch.float64 if dtype is None else dtype
        self._prod_fn = prod
        self._tprod_fn = tprod
        self._ctprod_fn = ctprod

    @property
    def nrow(self):
        return self._nrow

    @property
    def ncol(self):
        return self._ncol

    @property
    def dtype(self):
        return self._dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _prod(self, v):
        return self._prod_fn(v)

    def _tprod(self, u):
        if self._tprod_fn is None:
            return NotImplemented
        return self._tprod_fn(u)

    def _ctprod(self, w):
        if self._ctprod_fn is None:
            return NotImplemented
        return self._ctprod_fn(w)

    def _has_tprod(self):
        return self._tprod_fn is not None

    def _has_ctprod(self):
        return self._ctprod_fn is not None

    def _name(self):
        return "Function operator"


def make_operator(*args, **kwargs) -> LinearOperator:
    """User-facing polymorphic constructor, exported as ``LinearOperator``.

    Forms:
      - ``LinearOperator(M, symmetric=..., hermitian=...)`` for a 2-D array
      - ``LinearOperator(dtype, nrow, ncol, symmetric, hermitian, prod,
        tprod=None, ctprod=None)`` for function-backed operators
    """
    if len(args) >= 1 and getattr(args[0], "ndim", None) == 2:
        if len(args) > 1:
            raise TypeError("LinearOperator(M): extra positional args not allowed")
        return MatrixOperator(args[0], **kwargs)
    if len(args) >= 6:
        dtype, nrow, ncol, symmetric, hermitian, prod = args[:6]
        tprod = args[6] if len(args) > 6 else kwargs.pop("tprod", None)
        ctprod = args[7] if len(args) > 7 else kwargs.pop("ctprod", None)
        return FunctionOperator(nrow, ncol, prod, tprod, ctprod, symmetric=symmetric,
                                hermitian=hermitian, dtype=dtype, **kwargs)
    raise TypeError(
        "LinearOperator(...) expects a 2-D array or "
        "(dtype, nrow, ncol, symmetric, hermitian, prod[, tprod, ctprod])"
    )


def aslinearoperator(obj) -> LinearOperator:
    """Coerce an array or operator to a LinearOperator."""
    if isinstance(obj, LinearOperator):
        return obj
    if getattr(obj, "ndim", None) == 2:
        return MatrixOperator(obj)
    raise TypeError(f"cannot interpret {type(obj)} as a linear operator")
