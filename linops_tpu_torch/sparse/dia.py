"""DIA (diagonal-offset) sparse operator and the Laplacian builders.

Counterpart of ``linops_tpu/sparse/dia.py``. A banded matrix is stored as
its diagonals, ``diags[i, r] = A[r, r + offsets[i]]`` (zero where out of
range), so ``(A x)[r] = Σ_i diags[i, r] · x[r + offsets[i]]``. The forward
pads x once and multiplies the stacked shifted views; the transpose adds
each shifted product into one padded buffer by slice, an order fixed by the
offsets (no scatter, so a rerun gives the same bits). No index arrays, no
gathers.

Diagonals given as host data go to ``device=``, the CUDA device by default
(``device="cpu"`` for the CPU); a tensor keeps its device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.base import LinearOperator, LinearOperatorException, default_device

__all__ = ["DIAOperator", "opDIA", "dia_from_dense", "laplacian_1d", "laplacian_2d",
           "laplacian_2d_dia"]


def _pad_rows(x, lo: int, hi: int):
    """x zero-padded by lo/hi entries along its first axis."""
    return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (lo, hi))


class DIAOperator(LinearOperator):
    """Square operator stored as (k, n) diagonals with static offsets."""

    _fields_tensors = ("diags",)
    _fields_static = ("_offsets", "_symmetric", "_hermitian")

    def __init__(self, diags, offsets: Sequence[int], *, symmetric: bool = False,
                 hermitian: bool = False, device=None):
        super().__init__()
        if device is not None or not isinstance(diags, torch.Tensor):
            diags = torch.as_tensor(diags, device=default_device(device, "opDIA"))
        if diags.ndim != 2 or len(offsets) != diags.shape[0]:
            raise LinearOperatorException("diags must be (k, n) with k offsets")
        self.diags = diags
        self._offsets = tuple(int(o) for o in offsets)
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    @property
    def nrow(self):
        return self.diags.shape[1]

    @property
    def ncol(self):
        return self.diags.shape[1]

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self._offsets

    @property
    def _max_off(self) -> int:
        return max(max(self._offsets), -min(self._offsets), 0)

    def _forward(self, X, diags):
        """Σ_i diags[i] ⊙ X[r + o_i] over rows (X is (n,) or (n, k))."""
        mo, n = self._max_off, self.nrow
        Xp = _pad_rows(X, mo, mo)
        shifts = torch.stack([Xp[mo + o: mo + o + n] for o in self._offsets])
        D = diags.reshape(diags.shape + (1,) * (X.ndim - 1))
        return torch.sum(D * shifts, dim=0)

    def _transpose(self, U, diags):
        """(Aᵀu)[c] = Σ_i (diags_i ⊙ u)[c − o_i]: each term added by slice into
        one shared padded buffer, in offset order."""
        mo, n = self._max_off, self.ncol
        D = diags.reshape(diags.shape + (1,) * (U.ndim - 1))
        prods = D * U[None]
        acc = torch.zeros((n + 2 * mo,) + tuple(U.shape[1:]), dtype=prods.dtype,
                          device=prods.device)
        for i, o in enumerate(self._offsets):
            acc[mo + o: mo + o + n] += prods[i]
        return acc[mo: mo + n]

    def _conj_diags(self):
        return self.diags.conj() if self.diags.is_complex() else self.diags

    def _prod(self, v):
        return self._forward(v, self.diags)

    def _tprod(self, u):
        return self._transpose(u, self.diags)

    def _ctprod(self, w):
        return self._transpose(w, self._conj_diags())

    def apply_matrix(self, M, mode: str = "N"):
        # the slot methods take an (n, k) block as they take a vector
        return self.apply(M, mode)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row-panel apply, (k, n) in and out: the shifts move along the
        panel's rows, no transposes."""
        if mode != "N":
            return super().apply_matrix_t(Mt, mode)
        mo, n = self._max_off, self.nrow
        Xp = torch.nn.functional.pad(Mt, (mo, mo))
        Y = torch.zeros_like(Mt, dtype=torch.promote_types(Mt.dtype, self.diags.dtype))
        for i, o in enumerate(self._offsets):
            Y = Y + self.diags[i][None, :] * Xp[:, mo + o: mo + o + n]
        return Y

    @property
    def nnz(self):
        return int(torch.sum(self.diags != 0))

    def _name(self):
        return f"DIA operator ({len(self._offsets)} diagonals)"


def opDIA(diags, offsets, **kw) -> DIAOperator:
    return DIAOperator(diags, offsets, **kw)


def dia_from_dense(A, tol: float = 0.0, *, device=None) -> DIAOperator:
    """The diagonals of a square dense matrix with an entry above ``tol``."""
    A = np.asarray(A)
    n = A.shape[0]
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise LinearOperatorException("DIA requires a square matrix")
    offsets, rows = [], []
    for o in range(-(n - 1), n):
        d = np.diagonal(A, o)
        if np.any(np.abs(d) > tol):
            offsets.append(o)
            row = np.zeros(n, A.dtype)
            if o >= 0:
                row[: n - o] = d  # diag_o[r] = A[r, r+o], valid r < n-o
            else:
                row[-o:] = d  # valid r >= -o
            rows.append(row)
    sym = bool(np.allclose(A, A.T))
    diags = np.stack(rows) if rows else np.zeros((1, n), A.dtype)
    return DIAOperator(torch.from_numpy(diags).to(default_device(device, "dia_from_dense")),
                       offsets or [0], symmetric=sym, hermitian=sym and np.isrealobj(A))


def laplacian_1d(n: int, dtype=torch.float32, *, device=None) -> DIAOperator:
    """Tridiagonal [-1, 2, -1] operator."""
    dev = default_device(device, "laplacian_1d")
    main = torch.full((n,), 2.0, dtype=dtype, device=dev)
    lo = torch.full((n,), -1.0, dtype=dtype, device=dev)
    up = lo.clone()
    up[n - 1] = 0.0
    lo[0] = 0.0
    return DIAOperator(torch.stack([lo, main, up]), (-1, 0, 1), symmetric=True, hermitian=True)


def laplacian_2d(nx: int, ny: int, dtype=torch.float32, *, device=None):
    """5-point Laplacian on an nx × ny grid (row-major), n = nx·ny, as a
    ``Stencil2DOperator`` (grid-layout shifts); ``laplacian_2d_dia`` keeps
    the DIA form."""
    from .stencil import Stencil2DOperator

    offsets = [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]
    coeffs = torch.tensor([-1.0, -1.0, 4.0, -1.0, -1.0], dtype=dtype,
                          device=default_device(device, "laplacian_2d"))
    return Stencil2DOperator(nx, ny, offsets, coeffs)


def laplacian_2d_dia(nx: int, ny: int, dtype=torch.float32, *, device=None) -> DIAOperator:
    """5-point Laplacian in DIA form (flattened diagonals)."""
    dev = default_device(device, "laplacian_2d_dia")
    n = nx * ny
    kw = dict(dtype=dtype, device=dev)
    main = torch.full((n,), 4.0, **kw)
    ew = torch.full((n,), -1.0, **kw)
    ew[ny - 1:: ny] = 0.0  # no east coupling at row ends
    zero = torch.zeros(1, **kw)
    east = torch.cat([ew[: n - 1], zero])
    west = torch.cat([zero, ew[: n - 1]])
    north = torch.full((n,), -1.0, **kw)
    north[n - ny:] = 0.0
    south = torch.full((n,), -1.0, **kw)
    south[:ny] = 0.0
    return DIAOperator(torch.stack([south, west, main, east, north]), (-ny, -1, 0, 1, ny),
                       symmetric=True, hermitian=True)
