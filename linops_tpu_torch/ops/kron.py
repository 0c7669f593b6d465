"""Lazy Kronecker product operator.

Counterpart of ``linops_tpu/ops/kron.py``. With x laid out row-major as
X = x.reshape(nA_cols, nB_cols),

    (A ⊗ B) x  =  vec_row(A · (B · Xᵀ)ᵀ),

both factors applied through their matrix applies and nothing
materialized. A column block goes through the same identity at once:
its k columns ride as a batch of k right-hand sides of each factor's
matrix apply, not as a loop over columns.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, default_device
from ..core.dense import MatrixOperator, aslinearoperator

__all__ = ["KronOperator", "kron"]


def _as_factor(M, device):
    if isinstance(M, LinearOperator):
        return M
    if isinstance(M, torch.Tensor):
        return aslinearoperator(M)
    return MatrixOperator(M, device=default_device(device, "kron"))


class KronOperator(LinearOperator):
    _fields_tensors = ("A", "B")
    _fields_static = ()

    def __init__(self, A, B, *, device=None):
        """Operators and tensors keep their devices; host matrices go to
        ``device``, the CUDA device by default (``device="cpu"`` for the
        CPU)."""
        super().__init__()
        self.A = _as_factor(A, device)
        self.B = _as_factor(B, device)

    @property
    def nrow(self):
        return self.A.nrow * self.B.nrow

    @property
    def ncol(self):
        return self.A.ncol * self.B.ncol

    @property
    def dtype(self):
        return torch.promote_types(self.A.dtype, self.B.dtype)

    @property
    def symmetric(self):
        return self.A.symmetric and self.B.symmetric

    @property
    def hermitian(self):
        return self.A.hermitian and self.B.hermitian

    def _in_dims(self, mode):
        if mode in ("T", "H"):
            return self.A.nrow, self.B.nrow
        return self.A.ncol, self.B.ncol

    def apply(self, v, mode: str = "N"):
        a_in, b_in = self._in_dims(mode)
        X = v.reshape(a_in, b_in)
        W = self.B.apply_matrix(X.T, mode)  # (B.out, a_in)
        Y = self.A.apply_matrix(W.T, mode)  # (A.out, B.out)
        return Y.reshape(-1)

    def apply_matrix(self, M, mode: str = "N"):
        a_in, b_in = self._in_dims(mode)
        k = M.shape[1]
        # column j of M is X_j (a_in, b_in); B acts on the b axis of every
        # X_j at once, then A on the a axis
        X = M.reshape(a_in, b_in, k)
        W = self.B.apply_matrix(X.permute(1, 0, 2).reshape(b_in, a_in * k), mode)
        b_out = W.shape[0]
        W = W.reshape(b_out, a_in, k).permute(1, 0, 2).reshape(a_in, b_out * k)
        Y = self.A.apply_matrix(W, mode)  # (A.out, b_out·k)
        return Y.reshape(-1, k)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        self.A.bump(mode, n)
        self.B.bump(mode, n)

    def _name(self):
        return "Kronecker product operator"


def kron(A, B, *, device=None):
    """Kronecker product: a dense tensor if neither argument is an operator,
    else a ``KronOperator``. Host arrays go to ``device`` (the CUDA device by
    default)."""
    if not isinstance(A, LinearOperator) and not isinstance(B, LinearOperator):
        dev = None
        if not (isinstance(A, torch.Tensor) and isinstance(B, torch.Tensor)):
            dev = default_device(device, "kron")
        A = torch.as_tensor(A, device=dev if not isinstance(A, torch.Tensor) else None)
        B = torch.as_tensor(B, device=dev if not isinstance(B, torch.Tensor) else None)
        return torch.kron(A, B)
    return KronOperator(A, B, device=device)
