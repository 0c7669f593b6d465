"""Sparse storage formats: COO, CSR, ELL and BSR.

Counterpart of ``linops_tpu/sparse/formats.py``. The ``*_from_dense`` and
``*_from_parts`` functions pack on the host (numpy) and return tensors on
``device``: the CUDA device by default, ``device="cpu"`` for the CPU;
without a card and without ``device`` they raise
(``core/base.py::default_device``). Index arrays are int32, as on the
reference's device.

- COO/CSR carry an explicit per-entry ``rows`` vector (CSR keeps ``indptr``
  too), so a product is a gather plus an ``index_add_``.
- ELL pads every row to one slot count (pads: column 0, value 0).
- BSR holds dense (bm, bn) blocks, the same number per block row; padding
  blocks are zero and point at block column 0, so they add nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.base import default_device

__all__ = [
    "COO",
    "CSR",
    "BSR",
    "ELL",
    "coo_from_dense",
    "csr_from_dense",
    "csr_from_parts",
    "bsr_from_dense",
    "check_int32_range",
    "ell_from_csr_parts",
    "ell_from_dense",
]


class COO(NamedTuple):
    """Coordinate format: ``vals[k] = A[rows[k], cols[k]]``."""

    vals: torch.Tensor  # (nnz,)
    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]


class CSR(NamedTuple):
    """Compressed sparse rows, with the ``rows`` vector expanded from
    ``indptr`` at build time."""

    vals: torch.Tensor  # (nnz,)
    cols: torch.Tensor  # (nnz,) int32
    indptr: torch.Tensor  # (nrow+1,) int32
    rows: torch.Tensor  # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]


class BSR(NamedTuple):
    """``blocks[i, j]`` is the dense (bm, bn) block at block row i, block
    column ``block_cols[i, j]``. ``shape`` is the logical (unpadded) shape."""

    blocks: torch.Tensor  # (nbrow, kmax, bm, bn)
    block_cols: torch.Tensor  # (nbrow, kmax) int32
    shape: Tuple[int, int]

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.blocks.shape[2], self.blocks.shape[3])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        bn = self.blocks.shape[3]
        return (self.blocks.shape[0] * self.blocks.shape[2], -(-self.shape[1] // bn) * bn)


class ELL(NamedTuple):
    """ELLPACK: every row padded to ``kmax`` slots; pads carry column 0 and
    value 0 and add nothing."""

    vals: torch.Tensor  # (nrow, kmax)
    cols: torch.Tensor  # (nrow, kmax) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        """Stored (padded) entries."""
        return self.vals.numel()


def _t(a, device, dtype=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (copied)."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def _nonzero(A, tol: float):
    return np.nonzero(np.abs(A) > tol) if tol > 0 else np.nonzero(A)


def coo_from_dense(A, tol: float = 0.0, *, device=None) -> COO:
    dev = default_device(device, "coo_from_dense")
    A = np.asarray(A)
    rows, cols = _nonzero(A, tol)
    return COO(vals=_t(A[rows, cols], dev), rows=_t(rows, dev, np.int32),
               cols=_t(cols, dev, np.int32), shape=tuple(A.shape))


def csr_from_dense(A, tol: float = 0.0, *, device=None) -> CSR:
    dev = default_device(device, "csr_from_dense")
    A = np.asarray(A)
    rows, cols = _nonzero(A, tol)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=A.shape[0]))])
    return CSR(vals=_t(A[rows, cols], dev), cols=_t(cols, dev, np.int32),
               indptr=_t(indptr, dev, np.int32), rows=_t(rows, dev, np.int32),
               shape=tuple(A.shape))


_I32_MAX = np.iinfo(np.int32).max


def check_int32_range(shape, nnz: int) -> None:
    """Index arrays are int32: dims or nnz beyond 2^31-1 would wrap."""
    if max(int(shape[0]), int(shape[1]), int(nnz)) > _I32_MAX:
        raise OverflowError(
            f"sparse dims/nnz {tuple(shape)}/{nnz} exceed int32 range "
            "(2^31-1); int64 sparse indexing is not supported")


def csr_from_parts(vals, cols, indptr, shape, *, device=None) -> CSR:
    """Build from standard CSR arrays (e.g. a scipy ``csr_matrix``'s parts)."""
    dev = default_device(device, "csr_from_parts")
    indptr = np.asarray(indptr)
    check_int32_range(shape, len(np.asarray(vals)))
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return CSR(vals=_t(vals, dev), cols=_t(cols, dev, np.int32),
               indptr=_t(indptr, dev, np.int32), rows=_t(rows, dev, np.int32),
               shape=(int(shape[0]), int(shape[1])))


def bsr_from_dense(A, block_shape: Tuple[int, int] = (8, 128), tol: float = 0.0, *,
                   device=None) -> BSR:
    """Tile A (numpy) into (bm, bn) blocks, keep the nonzero ones, pad each
    block row to the largest block count."""
    dev = default_device(device, "bsr_from_dense")
    A = np.asarray(A)
    nrow, ncol = A.shape
    bm, bn = block_shape
    nbrow = -(-nrow // bm)
    nbcol = -(-ncol // bn)
    Ap = np.zeros((nbrow * bm, nbcol * bn), dtype=A.dtype)
    Ap[:nrow, :ncol] = A

    tiles = Ap.reshape(nbrow, bm, nbcol, bn).transpose(0, 2, 1, 3)  # (nbrow, nbcol, bm, bn)
    nz_mask = (np.abs(tiles) > tol).any(axis=(2, 3))

    kmax = max(int(nz_mask.sum(axis=1).max()), 1)
    blocks = np.zeros((nbrow, kmax, bm, bn), dtype=A.dtype)
    block_cols = np.zeros((nbrow, kmax), dtype=np.int32)
    for i in range(nbrow):
        js = np.nonzero(nz_mask[i])[0]
        blocks[i, : len(js)] = tiles[i, js]
        block_cols[i, : len(js)] = js
    return BSR(blocks=torch.from_numpy(blocks).to(dev),
               block_cols=torch.from_numpy(block_cols).to(dev), shape=(nrow, ncol))


def ell_from_csr_parts(vals, cols, indptr, shape, *, device=None) -> ELL:
    """Pack CSR arrays into ELL (every row padded to the largest degree)."""
    dev = default_device(device, "ell_from_csr_parts")
    vals = np.asarray(vals)
    indptr = np.asarray(indptr)
    check_int32_range(shape, len(vals))
    counts = np.diff(indptr)
    nrow = len(counts)
    kmax = max(int(counts.max()) if nrow else 0, 1)
    out_v = np.zeros((nrow, kmax), vals.dtype)
    out_c = np.zeros((nrow, kmax), np.int32)
    pos = np.arange(len(vals)) - np.repeat(indptr[:-1], counts)
    rows = np.repeat(np.arange(nrow), counts)
    out_v[rows, pos] = vals
    out_c[rows, pos] = np.asarray(cols)
    return ELL(vals=torch.from_numpy(out_v).to(dev), cols=torch.from_numpy(out_c).to(dev),
               shape=(int(shape[0]), int(shape[1])))


def ell_from_dense(A, tol: float = 0.0, *, device=None) -> ELL:
    dev = default_device(device, "ell_from_dense")
    A = np.asarray(A)
    rows, cols = _nonzero(A, tol)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=A.shape[0]))])
    return ell_from_csr_parts(A[rows, cols], cols, indptr, A.shape, device=dev)
