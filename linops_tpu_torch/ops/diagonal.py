"""Diagonal operators, square and rectangular.

Counterpart of ``linops_tpu/ops/diagonal.py``. Square: ``d ⊙ v``, H/C modes
conjugating a complex d; rectangular: min-dim slice with a zero tail.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException

__all__ = ["DiagonalOperator", "opDiagonal"]


class DiagonalOperator(LinearOperator):
    _fields_tensors = ("d",)
    _fields_static = ("_nrow", "_ncol")

    def __init__(self, d, nrow: int = None, ncol: int = None):
        super().__init__()
        d = torch.as_tensor(d)
        if d.ndim != 1:
            raise LinearOperatorException("diagonal must be a vector")
        n = d.shape[0]
        if nrow is None and ncol is None:
            nrow = ncol = n
        elif nrow is None or ncol is None:
            raise LinearOperatorException("provide both nrow and ncol or neither")
        nrow, ncol = int(nrow), int(ncol)
        # square rect-form with a longer d truncates
        if nrow == ncol and nrow <= n:
            d = d[:nrow]
        elif min(nrow, ncol) > n:
            raise LinearOperatorException("diagonal too short for operator size")
        self.d = d
        self._nrow = nrow
        self._ncol = ncol

    @property
    def nrow(self):
        return self._nrow

    @property
    def ncol(self):
        return self._ncol

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def _square(self):
        return self._nrow == self._ncol

    @property
    def symmetric(self):
        return self._square

    @property
    def hermitian(self):
        return self._square and not self.d.is_complex()

    def _diag_for_mode(self, mode: str):
        if mode in ("H", "C") and self.d.is_complex():
            return self.d.conj()
        return self.d

    def apply(self, v, mode: str = "N"):
        return self.apply_matrix(v, mode)

    def apply_matrix(self, M, mode: str = "N"):
        # works for vectors (n,) and column blocks (n, k) alike
        d = self._diag_for_mode(mode)
        if M.ndim == 2:
            d = d[:, None]
        if self._square:
            return d * M
        out_dim = self.out_dim(mode)
        n_min = min(self._nrow, self._ncol)
        Y = d[:n_min] * M[:n_min]
        if out_dim == n_min:
            return Y
        out = torch.zeros((out_dim, *Y.shape[1:]), dtype=Y.dtype, device=Y.device)
        out[:n_min] = Y
        return out

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return "Diagonal operator"


def opDiagonal(*args):
    """``opDiagonal(d)`` or ``opDiagonal(nrow, ncol, d)``."""
    if len(args) == 1:
        return DiagonalOperator(args[0])
    if len(args) == 3:
        nrow, ncol, d = args
        return DiagonalOperator(d, nrow, ncol)
    raise TypeError("opDiagonal(d) or opDiagonal(nrow, ncol, d)")
