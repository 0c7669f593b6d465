"""Sparse factorization operators: a host factor, solves on the host.

Counterpart of ``linops_tpu/ops/sparse_factor.py``: a sparse direct
factorization is sequential pointer-chasing, so the factor (scipy SuperLU)
and its triangular solves stay on the host, as in the reference. An apply
copies its vector to the host, solves, and copies the result back to the
vector's device (the reference's ``pure_callback``). For solves on the
device use ``opCholesky`` on a dense matrix, or iterate with ``cg`` and a
preconditioner.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.base import LinearOperator, LinearOperatorException

__all__ = ["SparseInverseOperator", "opSparseInverse", "opSparseLDL"]


class SparseInverseOperator(LinearOperator):
    """``A⁻¹`` of a scipy sparse matrix, factored once (SuperLU) at
    construction. The operator holds no tensor: it works on the device of
    whatever it is applied to."""

    _fields_tensors = ()
    _fields_static = ("_n", "_np_dtype", "_symmetric", "_hermitian", "_lu")
    # each apply copies v to the host for SuperLU and the result back
    capture_safe = False

    def __init__(self, A, *, symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        import scipy.sparse as sps
        import scipy.sparse.linalg as spla

        A = sps.csc_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise LinearOperatorException("sparse inverse requires a square matrix")
        self._n = A.shape[0]
        self._np_dtype = np.dtype(A.dtype)
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)
        self._lu = spla.splu(A)

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return torch.from_numpy(np.zeros(0, self._np_dtype)).dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _solve(self, v, trans: str):
        host = v.detach().cpu().resolve_conj().numpy().astype(self._np_dtype, copy=False)
        x = self._lu.solve(np.ascontiguousarray(host), trans=trans).astype(self._np_dtype)
        return torch.from_numpy(x).to(v.device)

    def _prod(self, v):
        return self._solve(v, "N")

    def _tprod(self, u):
        return self._solve(u, "T")

    def _ctprod(self, w):
        return self._solve(w, "H")

    def apply_matrix(self, M, mode: str = "N"):
        if mode == "C":
            return self._solve(M.conj(), "N").conj()
        return self._solve(M, mode)

    def _name(self):
        return "Sparse inverse operator (host SuperLU)"


def opSparseInverse(A, *, symm: bool = False, herm: bool = False):
    """Inverse of a scipy sparse matrix as an operator (factor once, host
    solves per apply)."""
    return SparseInverseOperator(A, symmetric=symm, hermitian=herm)


def opSparseLDL(A, check: bool = False):
    """The inverse of a sparse symmetric quasi-definite matrix: ``op * v ≈
    A \\ v``. ``check`` verifies symmetry up to 1e-10."""
    import scipy.sparse as sps

    A = sps.csc_matrix(A)
    if check:
        d = abs(A - A.T)
        if d.nnz and d.max() > 1e-10:
            raise LinearOperatorException("matrix is not symmetric")
    return SparseInverseOperator(A, symmetric=True, hermitian=True)
