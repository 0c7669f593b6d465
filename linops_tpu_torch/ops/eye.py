"""Identity, ones and zeros operators: the sizeless ``opEye()``, the sized,
possibly rectangular ``opEye(n[, m])``, ``opOnes`` and ``opZeros``.

Counterpart of ``linops_tpu/ops/eye.py``. These operators hold no tensor:
their results land on the device of the vector they are applied to.
``opOnes``/``opZeros`` take ``device=`` as the other factories do (the CUDA
device by default), and report it as the operator's ``device``.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException, default_device

__all__ = ["Eye", "UniversalEye", "Ones", "Zeros", "opEye", "opOnes", "opZeros"]


class UniversalEye(LinearOperator):
    """Typeless identity ``opEye()``: ``I * x is x`` and ``I * op is op``."""

    _is_universal_eye = True

    @property
    def nrow(self):
        raise LinearOperatorException("opEye() has no fixed size")

    @property
    def ncol(self):
        raise LinearOperatorException("opEye() has no fixed size")

    @property
    def dtype(self):
        return torch.float64

    @property
    def symmetric(self):
        return True

    @property
    def hermitian(self):
        return True

    def apply(self, v, mode: str = "N"):
        return v

    def apply_matrix(self, M, mode: str = "N"):
        return M

    def matvec(self, v, mode: str = "N"):
        return v

    @staticmethod
    def _passthrough(other):
        # operators and arrays pass through; a scalar times the sizeless
        # identity needs a size, so it raises instead of returning the scalar
        if isinstance(other, LinearOperator) or getattr(other, "ndim", 0) >= 1:
            return other
        raise LinearOperatorException(
            "the sizeless opEye() cannot be combined with scalars; use "
            "opEye(n) for a sized identity"
        )

    def __mul__(self, other):
        return self._passthrough(other)

    def __rmul__(self, other):
        return self._passthrough(other)

    def __matmul__(self, other):
        return self._passthrough(other)

    def __rmatmul__(self, other):
        return self._passthrough(other)

    @property
    def T(self):
        return self

    @property
    def H(self):
        return self

    def conj(self):
        return self

    def _name(self):
        return "Identity operator"


class Eye(LinearOperator):
    """Sized identity, possibly rectangular: copies the leading min-dim
    entries and zero-fills the tail."""

    _fields_static = ("_nrow", "_ncol", "_dtype")

    def __init__(self, nrow: int, ncol: int = None, *, dtype=torch.float64):
        super().__init__()
        self._nrow = int(nrow)
        self._ncol = int(nrow if ncol is None else ncol)
        self._dtype = dtype

    @property
    def nrow(self):
        return self._nrow

    @property
    def ncol(self):
        return self._ncol

    @property
    def dtype(self):
        return self._dtype

    @property
    def symmetric(self):
        return self._nrow == self._ncol

    @property
    def hermitian(self):
        return self._nrow == self._ncol

    def apply(self, v, mode: str = "N"):
        return self.apply_matrix(v, mode)

    def apply_matrix(self, M, mode: str = "N"):
        # works for vectors (n,) and column blocks (n, k) alike
        out_dim = self.out_dim(mode)
        if out_dim == M.shape[0]:
            return M
        if out_dim < M.shape[0]:
            return M[:out_dim]
        n_min = min(self._nrow, self._ncol)
        out = torch.zeros((out_dim, *M.shape[1:]), dtype=M.dtype, device=M.device)
        out[:n_min] = M[:n_min]
        return out

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return "Identity operator"


class _Constant(LinearOperator):
    """Shared metadata of ``Ones`` and ``Zeros``: size, dtype, and the device
    the operator reports (None: it follows its input)."""

    _fields_static = ("_nrow", "_ncol", "_dtype", "_device")

    def __init__(self, nrow: int, ncol: int, *, dtype=torch.float64, device=None):
        super().__init__()
        self._nrow = int(nrow)
        self._ncol = int(ncol)
        self._dtype = dtype
        self._device = None if device is None else torch.device(device)

    def to(self, device):
        new = super().to(device)
        new._device = torch.device(device)
        return new

    @property
    def device(self):
        return self._device

    @property
    def nrow(self):
        return self._nrow

    @property
    def ncol(self):
        return self._ncol

    @property
    def dtype(self):
        return self._dtype

    @property
    def symmetric(self):
        return self._nrow == self._ncol

    @property
    def hermitian(self):
        return self._nrow == self._ncol

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True


class Ones(_Constant):
    """All-ones operator: ``y = sum(v) * ones(out_dim)`` in every mode."""

    def apply(self, v, mode: str = "N"):
        return v.sum().expand(self.out_dim(mode)).clone()

    def apply_matrix(self, M, mode: str = "N"):
        return M.sum(dim=0, keepdim=True).expand(self.out_dim(mode), M.shape[1]).clone()

    def _name(self):
        return "Ones operator"


class Zeros(_Constant):
    """Zero operator."""

    def apply(self, v, mode: str = "N"):
        return torch.zeros((self.out_dim(mode),), dtype=v.dtype, device=v.device)

    def apply_matrix(self, M, mode: str = "N"):
        return torch.zeros((self.out_dim(mode), M.shape[1]), dtype=M.dtype, device=M.device)

    def _name(self):
        return "Zeros operator"


def opEye(*args, dtype=torch.float64):
    """``opEye()`` | ``opEye(n)`` | ``opEye(nrow, ncol)`` with ``dtype=``."""
    if len(args) == 0:
        return UniversalEye()
    if len(args) == 1:
        return Eye(args[0], dtype=dtype)
    return Eye(args[0], args[1], dtype=dtype)


def opOnes(nrow, ncol, *, dtype=torch.float64, device=None):
    """The (nrow, ncol) all-ones operator, on ``device`` (the CUDA device by
    default; ``device="cpu"`` for the CPU)."""
    return Ones(nrow, ncol, dtype=dtype, device=default_device(device, "opOnes"))


def opZeros(nrow, ncol, *, dtype=torch.float64, device=None):
    """The (nrow, ncol) zero operator, on ``device`` as ``opOnes``."""
    return Zeros(nrow, ncol, dtype=dtype, device=default_device(device, "opZeros"))
