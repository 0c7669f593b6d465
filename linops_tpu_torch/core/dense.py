"""Matrix-backed and function-backed leaf operators + the user-facing factory.

Counterpart of ``linops_tpu/core/dense.py``.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from .base import LinearOperator, LinearOperatorException, _is_dtensor, default_device
from .precision import pmatmul

__all__ = ["MatrixOperator", "FunctionOperator", "make_operator", "aslinearoperator"]


class MatrixOperator(LinearOperator):
    """Dense-matrix-backed operator; transpose/adjoint modes contract on the
    other side instead of materializing Aᵀ."""

    _fields_tensors = ("A",)
    _fields_static = ("_symmetric", "_hermitian")

    def __init__(self, A, *, symmetric: Optional[bool] = None, hermitian: Optional[bool] = None,
                 device=None):
        """A tensor A keeps its device unless ``device`` is given; host data
        goes to ``device``, the CUDA device by default (``device="cpu"`` for
        the CPU)."""
        super().__init__()
        if device is not None or not isinstance(A, torch.Tensor):
            A = torch.as_tensor(A, device=default_device(device, "LinearOperator"))
        if A.ndim != 2:
            raise LinearOperatorException("MatrixOperator requires a 2-D array")
        self.A = A
        self._symmetric = bool(symmetric) if symmetric is not None else False
        self._hermitian = bool(hermitian) if hermitian is not None else False

    @property
    def nrow(self):
        return self.A.shape[0]

    @property
    def ncol(self):
        return self.A.shape[1]

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _prod(self, v):
        return pmatmul(self.A, v)

    def _tprod(self, u):
        # Aᵀ as a view: no transpose copy. Not u @ A: for a row-split DTensor A
        # and u, DTensor gives that product a partial sum it cannot reduce.
        return pmatmul(self.A.T, u)

    def _ctprod(self, w):
        if self.A.is_complex() or w.is_complex():
            return pmatmul(self.A.T, w.conj()).conj()
        return pmatmul(self.A.T, w)

    def apply_matrix(self, M, mode: str = "N"):
        if mode == "N":
            return pmatmul(self.A, M)
        if mode == "T":
            return pmatmul(self.A.T, M)
        if mode == "H":
            return pmatmul(self.A.conj().T, M)
        return pmatmul(self.A.conj(), M)

    def _name(self):
        return "Matrix operator"


class FunctionOperator(LinearOperator):
    """Operator backed by product functions on tensors.

    ``prod(v) -> y`` is required; ``tprod``/``ctprod`` are optional and the
    inference lattice fills the gaps (or raises 'unable to infer ...').

    ``capture_safe=True`` declares that the functions may be captured in a
    CUDA graph and replayed by the solve loops (``utils/loop.py``): they read
    nothing back to the host, their result depends on their argument and on
    tensors they hold that stay alive and change only in place (a replay
    reads those at the addresses it captured), and on no Python value that
    changes between calls (a capture bakes it in). The default, False, runs
    solves over the operator in the per-iteration loop.

    A block apply (``apply_matrix`` of an (n, k) block, ``apply_matrix_t``
    of a (k, n) one) is one ``torch.func.vmap`` of the vector apply over
    the k vectors, in every mode the vector apply infers: one call of the
    function for the block, as the reference's ``jax.vmap``. The fallback:
    a function ``torch.func.vmap`` cannot batch (one that calls ``.item()``
    or builds a tensor from a number it reads, branches on a tensor's value,
    or reads a tensor's storage, as ``.numpy()`` does) takes the column
    loop, one call per vector. Its first block warns once, with a
    ``UserWarning`` that names the operator and the error, and the operator
    remembers it, so later blocks go straight to the loop. Only the errors
    vmap raises for what it cannot batch are caught; any other propagates.
    The function runs on the device it was given either way.

    A DTensor block is vmapped as it is, as the reference vmaps the
    function over a sharded array: the function gets a batched wrapper of
    the DTensor block, on which DTensor's own operations (pointwise ones,
    products with DTensor operands, reductions) run with the block's
    placements, in one call, and the result keeps the placements they
    propagate (a column loop's stack of the vectors' placements). A DTensor
    method called on the vector (``full_tensor``, ``redistribute``) finds a
    plain tensor there, and vmap refuses ``DTensor.from_local`` and
    ``to_local`` (autograd Functions without ``setup_context``) and DTensor
    operations on a batched local tensor: such a function takes the column
    loop, with the same warning (ROADMAP §3, fault 25)."""

    _fields_tensors = ()
    _fields_static = ("_nrow", "_ncol", "_symmetric", "_hermitian", "_dtype",
                      "_prod_fn", "_tprod_fn", "_ctprod_fn", "_capture_safe")

    def __init__(
        self,
        nrow: int,
        ncol: int,
        prod: Callable,
        tprod: Optional[Callable] = None,
        ctprod: Optional[Callable] = None,
        *,
        symmetric: bool = False,
        hermitian: bool = False,
        dtype=None,
        capture_safe: bool = False,
    ):
        super().__init__()
        self._capture_safe = bool(capture_safe)
        self._nrow = int(nrow)
        self._ncol = int(ncol)
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)
        self._dtype = torch.float64 if dtype is None else dtype
        self._prod_fn = prod
        self._tprod_fn = tprod
        self._ctprod_fn = ctprod
        self._unbatchable = None  # the vmap error of the first block that fell back

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
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def capture_safe(self) -> bool:
        return self._capture_safe

    def _prod(self, v):
        return self._prod_fn(v)

    def _tprod(self, u):
        if self._tprod_fn is None:
            return NotImplemented
        return self._tprod_fn(u)

    def _ctprod(self, w):
        if self._ctprod_fn is None:
            return NotImplemented
        return self._ctprod_fn(w)

    def _has_tprod(self):
        return self._tprod_fn is not None

    def apply_matrix(self, M, mode: str = "N"):
        """Column block (n, k) → (m, k): one vmapped vector apply (see the
        class docstring)."""
        return self._block_apply(M, mode, 1)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row panel (k, n) → (k, m): one vmapped vector apply over its rows
        (through a subclass's own ``apply_matrix`` where it has one)."""
        if type(self).apply_matrix is not FunctionOperator.apply_matrix:
            return super().apply_matrix_t(Mt, mode)
        return self._block_apply(Mt, mode, 0)

    def _block_apply(self, X, mode: str, dim: int):
        if getattr(self, "_unbatchable", None) is None:
            try:
                return torch.func.vmap(lambda v: self.apply(v, mode), in_dims=dim,
                                       out_dims=dim)(X)
            except (RuntimeError, NotImplementedError, AttributeError) as e:
                if not _cannot_batch(e, _is_dtensor(X)):
                    raise
                object.__setattr__(self, "_unbatchable", str(e))
                warnings.warn(f"{self._name()} {self.nrow}x{self.ncol}: torch.func.vmap cannot "
                              f"batch its function ({e}); its block applies take the column "
                              "loop, one call per vector", UserWarning, stacklevel=3)
        if dim == 0:
            return super().apply_matrix(X.t(), mode).t()
        return super().apply_matrix(X, mode)

    def _has_ctprod(self):
        return self._ctprod_fn is not None

    def _name(self):
        return "Function operator"


# what torch.func.vmap raises for an operation it cannot batch: its own
# errors ("vmap: ..."), a missing batching rule, a read of a batched
# tensor's storage (which it does not have), an autograd Function without
# setup_context (DTensor.from_local, to_local) and a property it cannot
# query on a batched tensor (DTensor's sharding propagation asks for one)
_UNBATCHABLE = ("vmap:", "Batching rule not implemented",
                "Cannot access data pointer of Tensor that doesn't have storage",
                "Cannot access storage of BatchedTensorImpl",
                "it must override the setup_context staticmethod",
                "inside of vmap")
# what a DTensor block's vector raises for a DTensor method: vmap hands the
# function a plain tensor wrapper
_DTENSOR_METHOD = "'Tensor' object has no attribute"


def _cannot_batch(e: Exception, dtensor: bool = False) -> bool:
    msg = str(e)
    if isinstance(e, AttributeError):
        return dtensor and _DTENSOR_METHOD in msg
    return any(m in msg for m in _UNBATCHABLE)


def make_operator(*args, **kwargs) -> LinearOperator:
    """User-facing polymorphic constructor, exported as ``LinearOperator``.

    Forms:
      - ``LinearOperator(M, symmetric=..., hermitian=...)`` for a 2-D array
      - ``LinearOperator(dtype, nrow, ncol, symmetric, hermitian, prod,
        tprod=None, ctprod=None)`` for function-backed operators
    """
    if len(args) >= 1 and getattr(args[0], "ndim", None) == 2:
        if len(args) > 1:
            raise TypeError("LinearOperator(M): extra positional args not allowed")
        return MatrixOperator(args[0], **kwargs)
    if len(args) >= 6:
        dtype, nrow, ncol, symmetric, hermitian, prod = args[:6]
        tprod = args[6] if len(args) > 6 else kwargs.pop("tprod", None)
        ctprod = args[7] if len(args) > 7 else kwargs.pop("ctprod", None)
        return FunctionOperator(nrow, ncol, prod, tprod, ctprod, symmetric=symmetric,
                                hermitian=hermitian, dtype=dtype, **kwargs)
    raise TypeError(
        "LinearOperator(...) expects a 2-D array or "
        "(dtype, nrow, ncol, symmetric, hermitian, prod[, tprod, ctprod])"
    )


def aslinearoperator(obj) -> LinearOperator:
    """Coerce an array or operator to a LinearOperator."""
    if isinstance(obj, LinearOperator):
        return obj
    if getattr(obj, "ndim", None) == 2:
        return MatrixOperator(obj)
    raise TypeError(f"cannot interpret {type(obj)} as a linear operator")
