"""Shifted operator: ``H + σI`` with a shift that can change after
construction.

Counterpart of ``linops_tpu/ops/shifted.py``. σ is a 0-dim tensor in the
operator's dtype on the operator's device, read at every apply, so
``set_sigma`` (or assigning ``op.sigma``, which moves a number or a tensor
from elsewhere there) changes the applied value and rebuilds nothing. σ is a state field: a capture key sees it by layout, so a
captured solve replays across new σ (``utils/loop.py`` copies the new value
into the graph's own σ). The hermitian flag follows the current σ (a complex
σ breaks it): whether σ is real is found when σ is set, so reading the flag
never reads the device (inside a capture it could not); T and H applies
shift by σ and conj(σ).
"""

from __future__ import annotations

import torch

from ..core.algebra import _scalar_dtype, _scalar_is_real
from ..core.base import LinearOperator, LinearOperatorException
from ..core.dense import aslinearoperator

__all__ = ["ShiftedOperator"]


class ShiftedOperator(LinearOperator):
    _fields_tensors = ("op", "sigma")
    _fields_static = ("_sigma_real",)
    _fields_state = ("sigma",)

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
        return self.op.hermitian and self._sigma_real

    def __setattr__(self, name, value):
        if name == "sigma":
            # σ goes to the operator's device, at least in its dtype: a host
            # scalar would be read on the host in an apply, so a captured
            # solve would keep the value it was captured with
            device = self.op.device
            if isinstance(value, torch.Tensor):
                value = value.to(device=device,
                                 dtype=torch.promote_types(value.dtype, self.op.dtype))
            else:
                value = torch.as_tensor(value, dtype=_scalar_dtype(value, self.op.dtype),
                                        device=device)
        object.__setattr__(self, name, value)
        if name == "sigma":
            # the one read of a complex σ on the card, where it is set: never
            # in an apply (a captured solve swaps σ past this hook)
            object.__setattr__(self, "_sigma_real", _scalar_is_real(value))

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
        """Set the shift: a new 0-dim tensor in the operator's dtype, on the
        operator's device (a tensor the caller holds is not written). Nothing
        else is rebuilt, and the capture key is unchanged."""
        self.sigma = torch.as_tensor(sigma, dtype=self.op.dtype, device=self.op.device)
        return self

    def _name(self):
        return "Shifted operator"
