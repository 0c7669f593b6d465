"""Shifted operator: ``H + σI`` with a shift that can change after
construction.

Counterpart of ``linops_tpu/ops/shifted.py``. σ is a 0-dim tensor in the
operator's dtype on the operator's device, read at every apply, so
``set_sigma`` (or assigning ``op.sigma``) changes the applied value and
rebuilds nothing. The hermitian flag follows the current σ (a complex σ
breaks it); T and H applies shift by σ and conj(σ).
"""

from __future__ import annotations

import torch

from ..core.algebra import _scalar_dtype, _scalar_is_real
from ..core.base import LinearOperator, LinearOperatorException
from ..core.dense import aslinearoperator

__all__ = ["ShiftedOperator"]


class ShiftedOperator(LinearOperator):
    _fields_tensors = ("op", "sigma")

    def __init__(self, op, sigma=0.0):
        super().__init__()
        op = aslinearoperator(op)
        if op.nrow != op.ncol:
            raise LinearOperatorException("Operator H must be square.")
        self.op = op
        self.set_sigma(sigma)

    @property
    def nrow(self):
        return self.op.nrow

    @property
    def ncol(self):
        return self.op.ncol

    @property
    def dtype(self):
        return _scalar_dtype(self.sigma, self.op.dtype)

    @property
    def symmetric(self):
        return self.op.symmetric

    @property
    def hermitian(self):
        return self.op.hermitian and _scalar_is_real(self.sigma)

    def _sigma_for(self, mode: str):
        s = self.sigma
        if mode in ("H", "C") and isinstance(s, torch.Tensor) and s.is_complex():
            s = s.conj()
        return s

    def apply(self, v, mode: str = "N"):
        return self.op.apply(v, mode) + self._sigma_for(mode) * v

    def apply_matrix(self, M, mode: str = "N"):
        return self.op.apply_matrix(M, mode) + self._sigma_for(mode) * M

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        self.op.bump(mode, n)

    def set_sigma(self, sigma):
        """Set the shift in place: a 0-dim tensor in the operator's dtype, on
        the operator's device. Nothing else is rebuilt."""
        self.sigma = torch.as_tensor(sigma, dtype=self.op.dtype, device=self.op.device)
        return self

    def _name(self):
        return "Shifted operator"
