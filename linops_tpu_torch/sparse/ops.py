"""Sparse linear operators over BSR storage.

Counterpart of ``linops_tpu/sparse/ops.py`` (BSR only; COO/CSR/ELL, the
Clos-routed operator and ``opSparse`` come with later slices). Transpose and
adjoint products reuse the same storage; no transposed copy is made.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException
from ..kernels.bsr_spmv import (
    bsr_column_index,
    bsr_matmat_plain as bsr_matmat,
    bsr_matvec_kernel,
    bsr_matvec_plain as bsr_matvec,
    bsr_rmatvec_kernel,
    bsr_rmatvec_plain as bsr_rmatvec,
    kernel_dtypes,
)
from .formats import BSR

__all__ = ["BSROperator", "bsr_matvec", "bsr_rmatvec", "bsr_matmat"]


class _SparseBase(LinearOperator):
    _fields_tensors = ("data",)
    _fields_static = ("_symmetric", "_hermitian")

    def __init__(self, data, symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        self.data = data
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    def apply(self, v, mode: str = "N"):
        # sparse applies pad to block multiples, so a wrong-length vector
        # would be accepted silently: validate the true dims up front
        if getattr(v, "ndim", 1) != 1 or v.shape[0] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        return super().apply(v, mode)

    def _check_mat(self, M, mode: str):
        if getattr(M, "ndim", 2) != 2 or M.shape[0] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")

    @property
    def nrow(self):
        return self.data.shape[0]

    @property
    def ncol(self):
        return self.data.shape[1]

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian


# reference backend names, so reference call sites port unchanged
_BACKEND_ALIASES = {"pallas": "kernel", "pallas_fast": "kernel", "xla": "torch"}


class BSROperator(_SparseBase):
    """Block-sparse-row operator.

    Backends (``backend=``):

    - ``"auto"`` (default): f32 or bf16 blocks on a CUDA device, with an f32
      or bf16 result, run the hand-written kernels K1 (forward) and K2
      (transpose, deterministic); anything else (CPU tensors, f64, complex)
      runs the plain PyTorch versions.
    - ``"kernel"`` (aliases ``"pallas"``, ``"pallas_fast"``): always the
      kernels; raises where they cannot run (off CUDA, other dtypes).
    - ``"torch"`` (alias ``"xla"``): always the plain versions.

    Construction builds K2's block-column index (``bsr_column_index``) on
    the data's device, once. Data padded by the reference (extra zero block
    rows pointing at block column 0) is accepted: applies truncate to
    ``shape``.
    """

    _fields_tensors = ("data", "col_perm", "col_ptr")
    _fields_static = ("_symmetric", "_hermitian", "_backend")

    def __init__(self, data: BSR, symmetric: bool = False, hermitian: bool = False,
                 backend: str = "auto"):
        # the kernels take contiguous storage; a no-op for contiguous data
        data = data._replace(blocks=data.blocks.contiguous(),
                             block_cols=data.block_cols.contiguous())
        super().__init__(data, symmetric, hermitian)
        backend = _BACKEND_ALIASES.get(backend, backend)
        if backend not in ("auto", "kernel", "torch"):
            raise ValueError(f"unknown BSR backend {backend!r}")
        self._backend = backend
        blocks, cols = data.blocks, data.block_cols
        if blocks.ndim != 4 or tuple(cols.shape) != tuple(blocks.shape[:2]):
            raise LinearOperatorException(
                f"BSR blocks must be (nbrow, kmax, bm, bn) and block_cols "
                f"(nbrow, kmax); got {tuple(blocks.shape)}, {tuple(cols.shape)}")
        if cols.dtype != torch.int32:
            raise LinearOperatorException(f"BSR block_cols must be int32, got {cols.dtype}")
        nrow, ncol = data.shape
        bm, bn = data.block_shape
        if blocks.shape[0] * bm < nrow:
            raise LinearOperatorException(f"BSR has {blocks.shape[0]} block rows of {bm}, "
                                          f"fewer than shape[0]={nrow}")
        nbcol = self._nbcol
        if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= nbcol):
            raise LinearOperatorException(f"BSR block_cols must lie in [0, {nbcol})")
        self.col_perm, self.col_ptr = bsr_column_index(cols, nbcol)

    @property
    def _nbcol(self) -> int:
        return -(-self.data.shape[1] // self.data.block_shape[1])

    @property
    def dtype(self):
        return self.data.blocks.dtype

    @property
    def nnz(self) -> int:
        """Stored (padded) values."""
        return self.data.blocks.numel()

    def _use_kernel(self, vec) -> bool:
        if self._backend == "torch":
            return False
        on_cuda = self.data.blocks.is_cuda and vec.is_cuda
        fits = kernel_dtypes(self.data.blocks.dtype, vec.dtype) is not None
        if self._backend == "kernel" and not (on_cuda and fits):
            raise LinearOperatorException(
                f"backend='kernel' needs f32/bf16 blocks and vectors on a CUDA "
                f"device; got blocks {self.data.blocks.dtype} on "
                f"{self.data.blocks.device}, vector {vec.dtype} on {vec.device}")
        return on_cuda and fits

    @staticmethod
    def _pad_to(v, need: int):
        if v.shape[0] < need:
            v = torch.nn.functional.pad(v, (0, need - v.shape[0]))
        return v

    def _prod(self, v):
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = d.blocks.shape[0], self._nbcol
        xb = self._pad_to(v, nbcol * bn).reshape(nbcol, bn)
        if self._use_kernel(v):
            y = bsr_matvec_kernel(d.blocks, d.block_cols, xb)
        else:
            y = bsr_matvec(d.blocks, d.block_cols, xb)
        return y.reshape(nbrow * bm)[: d.shape[0]]

    def _tprod_impl(self, blocks, u):
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = blocks.shape[0], self._nbcol
        ub = self._pad_to(u, nbrow * bm).reshape(nbrow, bm)
        if not blocks.is_complex() and self._use_kernel(u):
            x = bsr_rmatvec_kernel(blocks, d.block_cols, ub, nbcol,
                                   perm=self.col_perm, colptr=self.col_ptr)
        else:
            x = bsr_rmatvec(blocks, d.block_cols, ub, nbcol)
        return x.reshape(nbcol * bn)[: d.shape[1]]

    def _tprod(self, u):
        return self._tprod_impl(self.data.blocks, u)

    def _ctprod(self, w):
        if not self.data.blocks.is_complex():
            return self._tprod(w)
        return self._tprod_impl(self.data.blocks.conj(), w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        if mode != "N":
            return super().apply_matrix(M, mode)
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = d.blocks.shape[0], self._nbcol
        k = M.shape[1]
        M = torch.nn.functional.pad(M, (0, 0, 0, nbcol * bn - M.shape[0]))
        Y = bsr_matmat(d.blocks, d.block_cols, M.reshape(nbcol, bn, k))
        return Y.reshape(nbrow * bm, k)[: d.shape[0]]

    def _name(self):
        return "BSR sparse operator"
