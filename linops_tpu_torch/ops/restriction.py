"""Restriction / extension operators and operator slicing.

Counterpart of ``linops_tpu/ops/restriction.py``. ``R = opRestriction(I,
ncol)`` gives ``R @ v == v[I]`` (a gather); its transpose scatters with
addition, the true adjoint of a gather when indices repeat, as a segment
sum in index order (``core/segsum.py``), so a rerun gives the same bits. ``opExtension``
is the adjoint. ``op[rows, cols] == R @ op @ E``, so slices are always
operators. Indices are 0-based; an index outside ``[0, ncol)`` raises.

Index arrays given as host data (ints, lists, numpy arrays, slices) go to
``device=``, the CUDA device by default (``device="cpu"`` for the CPU); an
index tensor keeps its device. Slicing an operator puts the indices on the
operator's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.base import LinearOperator, LinearOperatorException, default_device
from ..core.segsum import segment_plan, segment_sum

__all__ = ["RestrictionOperator", "opRestriction", "opExtension", "op_getindex"]


class RestrictionOperator(LinearOperator):
    """Gather the entries ``idx`` of a length-``ncol`` vector. The transpose
    sums the entries of each target in index order, through a plan built at
    its first use."""

    _fields_tensors = ("idx",)
    _fields_static = ("_ncol",)
    _fields_derived = ("sum_t",)

    def __init__(self, idx, ncol: int, *, device=None):
        super().__init__()
        if isinstance(idx, torch.Tensor) and device is None:
            idx_t = idx.reshape(-1) if idx.ndim == 0 else idx
        else:
            host = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
            if host.ndim == 0:
                host = host.reshape(1)
            if host.ndim != 1 or not np.issubdtype(host.dtype, np.integer):
                raise LinearOperatorException("indices must be an integer vector")
            idx_t = torch.from_numpy(host.astype(np.int64)).to(
                default_device(device, "opRestriction"))
        if idx_t.ndim != 1 or idx_t.dtype.is_floating_point or idx_t.dtype.is_complex:
            raise LinearOperatorException("indices must be an integer vector")
        if idx_t.numel() and (int(idx_t.min()) < 0 or int(idx_t.max()) >= ncol):
            raise LinearOperatorException(f"indices should be between 0 and {ncol - 1}")
        self.idx = idx_t.long()
        self._ncol = int(ncol)
        self.sum_t = None

    def _build_derived(self):
        if self.sum_t is None:
            self.sum_t = segment_plan(self.idx, self._ncol)

    def _scatter(self, u):
        self._build_derived()
        return segment_sum(u, self.sum_t)

    @property
    def nrow(self):
        return self.idx.shape[0]

    @property
    def ncol(self):
        return self._ncol

    @property
    def dtype(self):
        # the index type, as the reference; promotion with the vector's dtype
        # gives the result type
        return self.idx.dtype

    def _prod(self, v):
        return v.index_select(0, self.idx)

    def _tprod(self, u):
        return self._scatter(u)

    def _ctprod(self, w):
        return self._tprod(w)

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "C"):
            return M.index_select(0, self.idx)
        return self._scatter(M)

    def _name(self):
        return "Restriction operator"


def opRestriction(idx, ncol: int, *, device=None):
    """Restriction to ``idx`` (an int, an integer vector or a slice);
    ``opRestriction(slice(None), n)`` is the identity."""
    if isinstance(idx, slice):
        if idx == slice(None):
            from .eye import Eye

            return Eye(ncol, dtype=torch.int64)
        idx = np.arange(*idx.indices(ncol))
    return RestrictionOperator(idx, ncol, device=device)


def opExtension(idx, ncol: int, *, device=None):
    """Extension: place a short vector at positions ``idx`` of a length-``ncol``
    vector; the adjoint of the restriction."""
    if isinstance(idx, slice) and idx == slice(None):
        from .eye import Eye

        return Eye(ncol, dtype=torch.int64)
    return opRestriction(idx, ncol, device=device).H


def _normalize_index(key, dim: int):
    """None for ``:``, else an index vector (numpy)."""
    if isinstance(key, slice):
        if key == slice(None):
            return None
        return np.arange(*key.indices(dim))
    if isinstance(key, (int, np.integer)):
        return np.asarray([key])
    if isinstance(key, torch.Tensor):
        return key.reshape(-1).cpu().numpy()
    return np.asarray(key)


def op_getindex(op: LinearOperator, rows, cols) -> LinearOperator:
    """``op[rows, cols] = R @ op @ E``; the indices live on ``op``'s device."""
    r = _normalize_index(rows, op.nrow)
    c = _normalize_index(cols, op.ncol)
    dev = op.device
    out = op
    if c is not None:
        out = out @ opExtension(c, op.ncol, device=dev)
    if r is not None:
        out = opRestriction(r, op.nrow, device=dev) @ out
    return out
