"""N-D grid stencil operator: shifts in grid layout, not vector layout.

Counterpart of ``linops_tpu/sparse/stencil.py``. The operator's interface is
1-D (vectors of length prod(grid), row-major); an apply views the vector as
the grid and, for each stencil point, adds the scaled neighbour slice into
the slice of y it reaches (``_shift_slices``: a shift by slicing, zero
beyond the edge), in place. A column block (n, k) or a row panel
(k, n) rides along as one batch: the same slices over the grid axes,
not a loop over columns.

Coefficients are scalars per offset (a constant stencil: x read, y written)
or full grid arrays (spatially varying). Beyond the grid edge the stencil
reads zero (Dirichlet-style coupling), matching ``laplacian_2d``.
Coefficients given as host data go to ``device=``, the CUDA device by
default (``device="cpu"`` for the CPU); a tensor keeps its device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..core.base import LinearOperator, LinearOperatorException, default_device

__all__ = ["StencilOperator", "Stencil2DOperator", "opStencil2D", "opStencil"]


def _shift_slices(offset: Tuple[int, ...], shape, start: int = 0):
    """(dst, src) index tuples for the shift x[i + offset] over the grid axes
    ``start``, ``start + 1``, ... of an array of ``shape``: dst picks the
    points i whose neighbour i + offset lies inside the grid, src those
    neighbours (axes before and after the grid ride along); None when no
    point has one. Points outside dst read zero."""
    dst = [slice(None)] * len(shape)
    src = [slice(None)] * len(shape)
    for j, o in enumerate(offset):
        ax = start + j
        n = shape[ax]
        if abs(o) >= n:
            return None
        if o > 0:
            dst[ax], src[ax] = slice(0, n - o), slice(o, None)
        elif o < 0:
            dst[ax], src[ax] = slice(-o, None), slice(0, n + o)
    return tuple(dst), tuple(src)


class StencilOperator(LinearOperator):
    """Square operator on a d-dimensional grid from offset/coefficient
    pairs: ``(A x)[i] = Σ_k c_k[i] · x[i + off_k]`` (zero beyond the edges)."""

    _fields_tensors = ("coeffs",)
    _fields_static = ("_grid", "_offsets", "_scalar_coeffs", "_is_sym")

    def __init__(self, grid_shape: Sequence[int], offsets, coeffs, *, device=None):
        super().__init__()
        self._grid = tuple(int(g) for g in grid_shape)
        d = len(self._grid)
        offs = []
        for off in offsets:
            off = tuple(int(o) for o in (off if isinstance(off, (tuple, list)) else (off,)))
            if len(off) != d:
                raise LinearOperatorException(f"offset {off} does not match grid rank {d}")
            offs.append(off)
        self._offsets = tuple(offs)
        if device is not None or not isinstance(coeffs, torch.Tensor):
            coeffs = torch.as_tensor(coeffs, device=default_device(device, "opStencil"))
        if coeffs.ndim == 1:
            if coeffs.shape[0] != len(self._offsets):
                raise LinearOperatorException("need one coefficient per offset")
            self._scalar_coeffs = True
        elif tuple(coeffs.shape) == (len(self._offsets),) + self._grid:
            self._scalar_coeffs = False
        else:
            raise LinearOperatorException("coeffs must be (k,) scalars or (k, *grid) arrays")
        self.coeffs = coeffs
        self._is_sym = self._compute_sym()

    @property
    def nrow(self):
        return math.prod(self._grid)

    @property
    def ncol(self):
        return math.prod(self._grid)

    @property
    def grid_shape(self):
        return self._grid

    @property
    def offsets(self):
        return self._offsets

    @property
    def dtype(self):
        return self.coeffs.dtype

    def _compute_sym(self) -> bool:
        """Symmetric when every offset's mirror carries the same scalar
        coefficient (varying coefficients: False)."""
        if not self._scalar_coeffs:
            return False
        vals = self.coeffs.cpu().tolist()
        table = {o: i for i, o in enumerate(self._offsets)}
        for off, i in table.items():
            j = table.get(tuple(-o for o in off))
            if j is None or vals[i] != vals[j]:
                return False
        return True

    @property
    def symmetric(self):
        return self._is_sym

    @property
    def hermitian(self):
        return self._is_sym and not self.coeffs.is_complex()

    def _grid_apply(self, X, start: int, transpose: bool, conj: bool):
        """The stencil (or its transpose) over grid axes ``start``.. of X:
        each point's term added in place into the slice of y it reaches, in
        offset order (y[i] += c_k[i]·x[i + off_k]; the transpose adds
        c_k[i]·x[i] into y[i + off_k])."""
        nd = len(self._grid)
        trail = X.ndim - start - nd
        y = torch.zeros_like(X, dtype=torch.promote_types(X.dtype, self.coeffs.dtype))
        for i, off in enumerate(self._offsets):
            sl = _shift_slices(off, X.shape, start)
            if sl is None:
                continue
            dst, src = sl
            c = self.coeffs[i]
            if conj and c.is_complex():
                c = c.conj()
            if not self._scalar_coeffs:
                c = c[dst[start:start + nd]].reshape(c[dst[start:start + nd]].shape
                                                     + (1,) * trail)
            if transpose:
                y[src].addcmul_(X[dst], c)
            else:
                y[dst].addcmul_(X[src], c)
        return y

    def _vec_apply(self, v, transpose: bool, conj: bool = False):
        X = v.reshape(self._grid + tuple(v.shape[1:]))
        return self._grid_apply(X, 0, transpose, conj).reshape(v.shape)

    def _prod(self, v):
        return self._vec_apply(v, False)

    def _tprod(self, u):
        return self._vec_apply(u, True)

    def _ctprod(self, w):
        return self._vec_apply(w, True, conj=True)

    def apply_matrix(self, M, mode: str = "N"):
        # the slot methods take an (n, k) block as they take a vector
        return self.apply(M, mode)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row-panel apply, (k, n) in and out: the shifts run over the grid
        axes behind the panel's row axis."""
        if mode != "N":
            return super().apply_matrix_t(Mt, mode)
        X = Mt.reshape((Mt.shape[0],) + self._grid)
        return self._grid_apply(X, 1, False, False).reshape(Mt.shape[0], -1)

    def _name(self):
        return (f"Stencil operator ({len(self._offsets)} points, "
                f"{'x'.join(map(str, self._grid))})")


class Stencil2DOperator(StencilOperator):
    """2-D convenience wrapper: ``Stencil2DOperator(nx, ny, offsets, coeffs)``."""

    def __init__(self, nx: int, ny: int, offsets, coeffs, *, device=None):
        super().__init__((nx, ny), offsets, coeffs, device=device)


def opStencil2D(nx, ny, offsets, coeffs, *, device=None) -> Stencil2DOperator:
    return Stencil2DOperator(nx, ny, offsets, coeffs, device=device)


def opStencil(grid_shape, offsets, coeffs, *, device=None) -> StencilOperator:
    return StencilOperator(grid_shape, offsets, coeffs, device=device)
