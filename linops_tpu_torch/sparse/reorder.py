"""Bandwidth-reducing reordering: ``opSparse(..., reorder="rcm")``.

Counterpart of ``linops_tpu/sparse/reorder.py``. Many "unstructured"
matrices are bandable: a reverse-Cuthill-McKee permutation of the
symmetrized pattern concentrates the nonzeros near the diagonal, where they
pack into BSR blocks (the kernels K1-K6) instead of the routed scattered
path.

``ReorderedOperator`` is the sandwich ``A = Pᵀ · A_r · P`` where
``A_r = A[perm][:, perm]`` (built as a normal sparse operator) and ``P`` is a
Clos-routed ``PermutationOperator`` (``(P x)[i] = x[perm[i]]``). Every mode
is the same sandwich with the inner mode pushed through (P is real and
orthogonal):

    A  x = Pᵀ A_r  P x      Aᵀ u = Pᵀ A_rᵀ P u      Aᴴ w = Pᵀ A_rᴴ P w

so symmetry and hermitianness of the inner operator carry over.
"""

from __future__ import annotations

import numpy as np

from ..core.base import LinearOperator, LinearOperatorException

__all__ = ["ReorderedOperator", "rcm_reordered_operator"]


class ReorderedOperator(LinearOperator):
    """``Pᵀ · inner · P`` with a permutation P (module docstring). Flags,
    dtype and shape are the inner operator's."""

    _fields_tensors = ("inner", "P")
    _fields_static = ()

    def __init__(self, inner, P):
        super().__init__()
        if inner.nrow != inner.ncol or inner.nrow != P.nrow:
            raise LinearOperatorException(
                "ReorderedOperator requires a square inner operator matching "
                f"the permutation size (got {inner.shape} vs {P.nrow})")
        self.inner = inner
        self.P = P
        # every mode applies Pᵀ on the way out: pack the inverse routing
        # program now (n=0: no counter effect)
        P.bump("T", 0)

    @property
    def nrow(self):
        return self.inner.nrow

    @property
    def ncol(self):
        return self.inner.ncol

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def symmetric(self):
        return self.inner.symmetric

    @property
    def hermitian(self):
        return self.inner.hermitian

    def _sandwich(self, v, mode):
        z = self.P.apply(v, "N")
        z = self.inner.apply(z, mode)
        return self.P.apply(z, "T")

    def _prod(self, v):
        return self._sandwich(v, "N")

    def _tprod(self, u):
        return self._sandwich(u, "T")

    def _ctprod(self, w):
        return self._sandwich(w, "H")

    def _check_mat(self, M, axis: int):
        if M.ndim != 2 or M.shape[axis] != self.nrow:
            raise LinearOperatorException("shape mismatch")

    def apply_matrix(self, M, mode: str = "N"):
        # P on a matrix is a whole-row gather; the inner operator runs its
        # own matrix path
        self._check_mat(M, axis=0)
        Z = self.P.apply_matrix(M, "N")
        Z = self.inner.apply_matrix(Z, mode)
        return self.P.apply_matrix(Z, "T")

    def apply_matrix_t(self, Mt, mode: str = "N"):
        # row panels: the permutation acts along axis 1, through the row
        # gather on the transposed panel
        self._check_mat(Mt, axis=1)
        Z = self.P.apply_matrix(Mt.t(), "N").t()
        Z = self.inner.apply_matrix_t(Z, mode)
        return self.P.apply_matrix(Z.t(), "T").t()

    def _bump_children(self, mode: str, n: int = 1):
        # every mode's sandwich applies P in both directions
        self.inner.bump(mode, n)
        self.P.bump("N", n)
        self.P.bump("T", n)

    def _name(self):
        return f"Reordered operator (RCM → {self.inner._name()})"


def rcm_reordered_operator(sp, opsparse_kwargs: dict, device=None):
    """``ReorderedOperator`` from a scipy CSR matrix: RCM on the symmetrized
    pattern (the native ``rcm_order``), reorder, the inner operator through
    ``opSparse``, and the Clos-routed permutation sandwich, all on
    ``device``. Called by ``opSparse(reorder="rcm")``."""
    import scipy.sparse as sps

    from ..native import rcm_permutation
    from ..ops.permutation import opPermutation
    from .ops import opSparse

    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise LinearOperatorException(
            f"reorder='rcm' requires a square matrix (similarity permutation PᵀAP); got {sp.shape}")
    # symmetrized pattern (RCM walks an undirected adjacency)
    pat = sps.csr_matrix((np.ones(sp.nnz, np.int8), sp.indices, sp.indptr), shape=sp.shape)
    pat = (pat + pat.T).tocsr()
    perm = rcm_permutation(pat.indices.astype(np.int32), pat.indptr.astype(np.int32), n)
    A_r = sp[perm][:, perm].tocsr()
    inner = opSparse(A_r, **opsparse_kwargs, device=device)
    return ReorderedOperator(inner, opPermutation(perm, device=device))
