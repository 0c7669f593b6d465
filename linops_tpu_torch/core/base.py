"""Core operator abstraction, in PyTorch.

Counterpart of ``linops_tpu/core/base.py``. An operator is a plain Python
object holding tensors; a lazy expression (compose / sum / scale / adjoint)
is a tree of such objects whose ``apply`` walks the tree eagerly.

Each class declares which attributes hold tensors (or nested operators,
or NamedTuples of tensors) in ``_fields_tensors``, which hold static
metadata in ``_fields_static``, and which hold state derived from the
tensors and built at first use in ``_fields_derived``. The split drives
``.to(device)``, which returns a copy with every tensor moved and the
derived state dropped, and the checkpoints, which also leave out the
tensor fields named in ``_fields_index`` (built from the others).

Modes
-----
An apply is parameterised by a *mode* in the group {N, T, C, H} (identity,
transpose, conjugate, conjugate-transpose), C2 x C2 under composition:
``H = T . C``. The adjoint-inference lattice is the reference's:

  adjoint:   hermitian -> prod | ctprod | conj.tprod.conj | symmetric -> conj.prod.conj | error
  transpose: symmetric -> prod | tprod  | conj.ctprod.conj | hermitian -> conj.prod.conj | error

Counters
--------
Product counters (``nprod/ntprod/nctprod``) live in a ``Counters`` cell,
bumped by the public entry points through a graph walk that mirrors the
calls the apply makes.
"""

from __future__ import annotations

import abc
import copy
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "LinearOperatorException",
    "LinearOperator",
    "Counters",
    "compose_modes",
    "mode_transposed",
    "mode_conjugated",
    "MODES",
    "default_device",
    "capture_signature",
]


class LinearOperatorException(Exception):
    """Raised on shape mismatches, uninferable transposes, bad promotions."""


# ----------------------------------------------------------------------------
# Modes
# ----------------------------------------------------------------------------

MODES = ("N", "T", "C", "H")

# mode -> (transposed, conjugated)
_MODE_TC = {"N": (False, False), "T": (True, False), "C": (False, True), "H": (True, True)}
_TC_MODE = {v: k for k, v in _MODE_TC.items()}


def compose_modes(outer: str, inner: str) -> str:
    """Compose two modes: mode(outer) applied to an operator in mode(inner)."""
    t1, c1 = _MODE_TC[outer]
    t2, c2 = _MODE_TC[inner]
    return _TC_MODE[(t1 ^ t2, c1 ^ c2)]


def mode_transposed(mode: str) -> bool:
    return _MODE_TC[mode][0]


def mode_conjugated(mode: str) -> bool:
    return _MODE_TC[mode][1]


def _conj(x):
    return x.conj() if x.is_complex() else x


def default_device(device=None, what: str = "this factory") -> torch.device:
    """The device an operator factory builds on: ``device`` when given, else
    the current CUDA device. Without a CUDA device the caller must ask for
    the CPU with ``device="cpu"``: nothing falls back to it silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise LinearOperatorException(
            f'{what}: no CUDA device is available; pass device="cpu" to build on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


# ----------------------------------------------------------------------------
# Counters
# ----------------------------------------------------------------------------


class Counters:
    """Host-side product counters."""

    __slots__ = ("nprod", "ntprod", "nctprod")

    def __init__(self):
        self.nprod = 0
        self.ntprod = 0
        self.nctprod = 0

    def reset(self):
        self.nprod = 0
        self.ntprod = 0
        self.nctprod = 0


# ----------------------------------------------------------------------------
# Tensor-field traversal (drives .to and .device)
# ----------------------------------------------------------------------------


def _move(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, LinearOperator):
        return value.to(device)
    if isinstance(value, tuple):  # a NamedTuple or a plain tuple, recursively
        items = (_move(v, device) for v in value)
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    return value


def _first_device(value):
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, LinearOperator):
        return value.device
    if isinstance(value, tuple):
        for v in value:
            d = _first_device(v)
            if d is not None:
                return d
    return None


def _walk(value, sig: list, tensors: list, seen: set, states: list):
    """Append ``value``'s signature to ``sig`` (its tensors to ``tensors``,
    and each state field it reaches to ``states`` as (operator, field)):
    tensors by address, version, shape, strides, dtype and device (a CPU
    scalar by value as well: an apply reads it on the host; a DTensor by its
    local tensor's, with its mesh, placements and global shape), operators by
    identity and fields (a node whose apply reads nothing but its fields,
    ``_key_by_fields``, by its fields alone; a state field, ``_fields_state``,
    by the layout of its tensors alone; a sharded operator's placement,
    ``parallel/sharded.py``, by its class and fields), device meshes by their
    ranks and axis names, containers item by item, plans (any other object
    with fields) by their fields, numbers and strings by value, anything else
    by identity."""
    if isinstance(value, torch.Tensor):
        tensors.append(value)
        local = _local(value)
        item = (local.data_ptr(), local._version, tuple(local.shape), local.stride(),
                local.dtype, local.device)
        if local is not value:
            item += _distribution(value)
        if not local.is_cuda and local.numel() == 1:
            item += (local.item(),)
        sig.append(item)
        plan = getattr(value, "_combine_plan", None)  # kernels/lane_gather.py
        if plan is not None:
            _walk(plan, sig, tensors, seen, states)
    elif isinstance(value, LinearOperator):
        cls = type(value)
        if cls._key_by_fields:
            sig.append((cls,))
        elif id(value) in seen:
            sig.append(("seen", id(value)))
            return
        else:
            seen.add(id(value))
            sig.append((cls, id(value)))
        for f in (cls._fields_tensors + cls._fields_static + cls._fields_derived
                  + cls._fields_index):
            if f in cls._fields_state:
                states.append((value, f))
                _walk_layout(getattr(value, f), sig, tensors)
            else:
                _walk(getattr(value, f, None), sig, tensors, seen, states)
        placement = getattr(value, "_placement", None)  # a sharded operator's
        if placement is not None:
            sig.append((type(placement),))
            for v in vars(placement).values():
                _walk(v, sig, tensors, seen, states)
    elif _is_mesh(value):
        sig.append(_mesh_key(value))
    elif isinstance(value, (tuple, list)):
        sig.append((type(value), len(value)))
        for v in value:
            _walk(v, sig, tensors, seen, states)
    elif isinstance(value, dict):
        sig.append((dict, len(value)))
        for k, v in value.items():
            sig.append(k if isinstance(k, (int, float, str, bool, tuple)) else id(k))
            _walk(v, sig, tensors, seen, states)
    elif value is None or isinstance(value, (bool, int, float, complex, str, torch.dtype,
                                             torch.device)):
        sig.append(value)
    elif isinstance(value, np.generic):
        sig.append(value.item())
    elif hasattr(value, "__dict__") and not callable(value) and id(value) not in seen:
        seen.add(id(value))
        sig.append((type(value), id(value)))
        for v in vars(value).values():
            _walk(v, sig, tensors, seen, states)
    else:
        sig.append((type(value), id(value)))


def _walk_layout(value, sig: list, tensors: list):
    """A state field's signature: each tensor by shape, strides (those that
    address anything: a dimension of one entry, or an empty tensor, has
    none), dtype and device, never by address, version or value; tuples
    item by item."""
    if isinstance(value, torch.Tensor):
        tensors.append(value)
        local = _local(value)
        shape = tuple(local.shape)
        empty = local.numel() == 0
        stride = tuple(0 if empty or n == 1 else st for n, st in zip(shape, local.stride()))
        item = (shape, stride, local.dtype, local.device)
        sig.append(item + _distribution(value) if local is not value else item)
    elif isinstance(value, tuple):
        sig.append((type(value), len(value)))
        for v in value:
            _walk_layout(v, sig, tensors)
    elif value is None:
        sig.append(None)
    else:
        raise TypeError(f"a state field holds {type(value).__name__}: tensors or tuples of them")


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"  # no import of torch.distributed


def _local(t):
    """A DTensor's local tensor (this rank's piece); any other tensor itself."""
    return t._local_tensor if _is_dtensor(t) else t


def _is_mesh(value) -> bool:
    return type(value).__name__ == "DeviceMesh"


def _mesh_key(mesh) -> tuple:
    """A device mesh by what every rank sees alike: its device type, ranks
    and axis names."""
    return ("mesh", mesh.device_type, tuple(mesh.mesh.flatten().tolist()),
            tuple(mesh.shape), mesh.mesh_dim_names)


def _distribution(t) -> tuple:
    """A DTensor's mesh, placements and global shape, for a key."""
    return _mesh_key(t.device_mesh), tuple(t.placements), tuple(t.shape)


def state_leaves(value) -> list:
    """The tensors of a state field (a tensor or a tuple of them), in order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if value is None:
        return []
    return [t for v in value for t in state_leaves(v)]


def capture_signature(op: "LinearOperator") -> tuple:
    """(key, tensors, states) of one walk of ``op``'s graph. The key is what
    a CUDA graph captured over ``op``'s applies depends on, hashable: every
    node's class, identity and fields (static values by value), and every
    tensor it reads by address, version and layout, except the tensors of
    state fields (``_fields_state``: an L-BFGS state, a shift σ), which it
    sees by layout alone. A new tensor outside state (a rebuilt plan), an
    in-place edit there (a bumped ``_version``) changes the key, so a
    captured graph never replays over memory it no longer owns
    (``utils/loop.py`` holds the operators of each graph it keeps); an update
    of state (a push, ``set_sigma``) keeps it, and the graph replays over
    static copies of the state that ``utils/loop.py`` refreshes before a
    replay. The tensors are every tensor the graph holds (fields, state,
    derived plans, indices); the states are the (operator, field) pairs of
    the state fields reached."""
    sig: list = []
    tensors: list = []
    states: list = []
    _walk(op, sig, tensors, set(), states)
    return tuple(sig), tensors, states


def _is_capture_safe(value) -> bool:
    if isinstance(value, LinearOperator):
        return value.capture_safe
    if isinstance(value, tuple):
        return all(_is_capture_safe(v) for v in value)
    return True


# ----------------------------------------------------------------------------
# Base class
# ----------------------------------------------------------------------------


class LinearOperator(abc.ABC):
    """Abstract base for all linear operators.

    Subclasses list their tensor-holding attributes in ``_fields_tensors``
    and static ones in ``_fields_static``, and implement ``_prod`` (and
    optionally ``_tprod`` / ``_ctprod``), or override ``apply`` wholesale for
    composite nodes that push modes down to children.
    """

    _fields_tensors: Tuple[str, ...] = ()
    _fields_static: Tuple[str, ...] = ()
    # derived from the tensor fields and rebuilt at first use (segment plans):
    # no state of their own, so ``.to`` drops them and checkpoints skip them
    _fields_derived: Tuple[str, ...] = ()
    # tensor fields built from the others at construction (a kernel's index):
    # ``.to`` moves them; checkpoints leave them out and ``_build_index``
    # rebuilds them after a load
    _fields_index: Tuple[str, ...] = ()
    # a node whose apply reads nothing but its fields: a capture key sees it
    # by them, so a fresh node over the same fields replays a captured graph
    _key_by_fields: bool = False
    # tensor fields that updates replace with new tensors of the same layout
    # (a push, a new shift): a capture key sees them by layout, and a
    # captured solve replays over static copies of them (``utils/loop.py``)
    _fields_state: Tuple[str, ...] = ()

    # numpy defers binary ops (u @ op, x * op, ...) to the reflected methods
    __array_ufunc__ = None

    nrow: int
    ncol: int

    def __init__(self):
        self._counters = Counters()

    # ------------------------------------------------------------------
    # Device placement
    # ------------------------------------------------------------------

    def to(self, device) -> "LinearOperator":
        """A copy with every tensor field (recursively) on ``device``.
        Counters start fresh on the copy."""
        new = copy.copy(self)
        for f in self._fields_tensors:
            object.__setattr__(new, f, _move(getattr(self, f), device))
        for f in self._fields_derived:
            object.__setattr__(new, f, None)
        object.__setattr__(new, "_counters", Counters())
        return new

    @property
    def device(self) -> Optional[torch.device]:
        """Device of the first tensor held, or None for tensorless operators."""
        for f in self._fields_tensors:
            d = _first_device(getattr(self, f))
            if d is not None:
                return d
        return None

    @property
    def capture_safe(self) -> bool:
        """Whether an apply can run inside a CUDA graph: it reads nothing
        back to the host and does no host work per call (after its lazy
        plans exist). A composite is safe when everything it holds is; a leaf
        that is not (a host factorization, a timer, a nested GMRES solve)
        says so, and solves over it run the per-iteration loop
        (``utils/loop.py``). DTensor leaves are safe: their dispatch is host
        work that a capture records once."""
        return all(_is_capture_safe(getattr(self, f, None)) for f in self._fields_tensors)

    # ------------------------------------------------------------------
    # Static metadata
    # ------------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrow, self.ncol)

    @property
    def T(self) -> "LinearOperator":
        from .adjoint import transpose

        return transpose(self)

    @property
    def H(self) -> "LinearOperator":
        from .adjoint import adjoint

        return adjoint(self)

    def adjoint(self) -> "LinearOperator":
        return self.H

    def transpose(self) -> "LinearOperator":
        return self.T

    def conj(self) -> "LinearOperator":
        from .adjoint import conj as _conj_op

        return _conj_op(self)

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def symmetric(self) -> bool:
        return False

    @property
    def hermitian(self) -> bool:
        return False

    def issymmetric(self) -> bool:
        return self.symmetric

    def ishermitian(self) -> bool:
        return self.hermitian

    def isreal(self) -> bool:
        return not self.dtype.is_complex

    def size(self, d: Optional[int] = None):
        """``size(op)`` / ``size(op, d)`` with d in {1, 2}."""
        if d is None:
            return self.shape
        if d == 1:
            return self.nrow
        if d == 2:
            return self.ncol
        raise LinearOperatorException("Linear operators only have 2 dimensions for now")

    def in_dim(self, mode: str = "N") -> int:
        return self.nrow if mode_transposed(mode) else self.ncol

    def out_dim(self, mode: str = "N") -> int:
        return self.ncol if mode_transposed(mode) else self.nrow

    # ------------------------------------------------------------------
    # Product slots (leaf operators implement these)
    # ------------------------------------------------------------------

    def _prod(self, v):
        raise NotImplementedError

    def _tprod(self, u):
        return NotImplemented

    def _ctprod(self, w):
        return NotImplemented

    def _has_tprod(self) -> bool:
        return type(self)._tprod is not LinearOperator._tprod

    def _has_ctprod(self) -> bool:
        return type(self)._ctprod is not LinearOperator._ctprod

    # ------------------------------------------------------------------
    # The apply engine: mode dispatch + adjoint-inference lattice
    # ------------------------------------------------------------------

    def apply(self, v, mode: str = "N"):
        """Apply the operator in the given mode."""
        if mode == "N":
            return self._prod(v)
        if mode == "C":
            # conj(A) v = conj(A conj(v))
            return _conj(self._prod(_conj(v)))
        if mode == "H":
            if self.hermitian:
                return self._prod(v)
            r = self._ctprod(v)
            if r is not NotImplemented:
                return r
            rt = self._tprod(_conj(v))
            if rt is not NotImplemented:
                return _conj(rt)
            if self.symmetric:
                return _conj(self._prod(_conj(v)))
            raise LinearOperatorException("unable to infer conjugate transpose operator")
        if mode == "T":
            if self.symmetric:
                return self._prod(v)
            r = self._tprod(v)
            if r is not NotImplemented:
                return r
            rc = self._ctprod(_conj(v))
            if rc is not NotImplemented:
                return _conj(rc)
            if self.hermitian:
                return _conj(self._prod(_conj(v)))
            raise LinearOperatorException("unable to infer transpose operator")
        raise ValueError(f"unknown mode {mode!r}")

    def apply_matrix(self, M, mode: str = "N"):
        """Column-batched apply. Default: one vector apply per column."""
        return torch.stack([self.apply(M[:, j], mode) for j in range(M.shape[1])], dim=1)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row-panel apply: ``Mt`` is (k, n), the result (k, m). Default: the
        column-batched apply between two transposes."""
        return self.apply_matrix(Mt.t(), mode).t()

    # ------------------------------------------------------------------
    # Counters
    # ------------------------------------------------------------------

    @property
    def counters(self) -> Counters:
        c = getattr(self, "_counters", None)
        if c is None:
            c = Counters()
            object.__setattr__(self, "_counters", c)
        return c

    @property
    def nprod(self) -> int:
        return self.counters.nprod

    @property
    def ntprod(self) -> int:
        return self.counters.ntprod

    @property
    def nctprod(self) -> int:
        return self.counters.nctprod

    def reset_counters(self) -> "LinearOperator":
        self.counters.reset()
        return self

    def _slot_for(self, mode: str) -> str:
        """Which counter slot an apply in ``mode`` hits."""
        if mode == "N" or mode == "C":
            return "nprod"
        if mode == "H":
            if self.hermitian:
                return "nprod"
            if self._has_ctprod():
                return "nctprod"
            if self._has_tprod():
                return "ntprod"
            return "nprod"  # symmetric fallback uses prod
        # mode == "T"
        if self.symmetric:
            return "nprod"
        if self._has_tprod():
            return "ntprod"
        if self._has_ctprod():
            return "nctprod"
        return "nprod"  # hermitian fallback uses prod

    def _bump(self, mode: str, n: int = 1):
        c = self.counters
        slot = self._slot_for(mode)
        setattr(c, slot, getattr(c, slot) + n)

    def _bump_children(self, mode: str, n: int = 1):
        """Composite nodes override to propagate counts to children in the
        modes their apply invokes them with."""

    def bump(self, mode: str, n: int = 1):
        self._bump(mode, n)
        self._bump_children(mode, n)

    # ------------------------------------------------------------------
    # Eager public API (core/apply.py)
    # ------------------------------------------------------------------

    def matvec(self, v, mode: str = "N"):
        from .apply import matvec

        return matvec(self, v, mode=mode)

    def rmatvec(self, w):
        """Adjoint apply: ``op.H @ w``."""
        from .apply import matvec

        return matvec(self, w, mode="H")

    def matmat(self, M, mode: str = "N"):
        from .apply import matmat

        return matmat(self, M, mode=mode)

    def to_dense(self, block_size: int = 4096):
        """Materialize as a dense tensor, block-columnwise."""
        from .apply import to_dense

        return to_dense(self, block_size=block_size)

    def __call__(self, v):
        return self.matvec(v)

    # ------------------------------------------------------------------
    # Operator algebra sugar
    # ------------------------------------------------------------------

    def _wrap_operand(self, other):
        """Auto-wrap bare matrices as operators (host data lands on this
        operator's device, or the default one)."""
        from .dense import MatrixOperator

        if isinstance(other, LinearOperator):
            return other
        if getattr(other, "ndim", None) == 2:
            host = not isinstance(other, torch.Tensor)
            return MatrixOperator(other, device=self.device if host else None)
        return None

    @staticmethod
    def _is_scalar(other) -> bool:
        return isinstance(other, (int, float, complex)) or getattr(other, "ndim", None) == 0

    def __mul__(self, other):
        from .algebra import Compose, Scale

        if getattr(other, "_is_universal_eye", False):
            return self  # op * opEye() is op
        if isinstance(other, LinearOperator):
            return Compose(self, other)
        if self._is_scalar(other):
            return Scale(other, self)
        if hasattr(other, "ndim"):
            if other.ndim == 1:
                return self.matvec(other)
            if other.ndim == 2:
                return Compose(self, self._wrap_operand(other))
        return NotImplemented

    def __rmul__(self, other):
        from .algebra import Compose, Scale

        if self._is_scalar(other):
            return Scale(other, self)  # x * op == op * x
        if getattr(other, "ndim", None) == 2:
            return Compose(self._wrap_operand(other), self)
        return NotImplemented

    def __matmul__(self, other):
        return self.__mul__(other)

    def __rmatmul__(self, other):
        # u @ op == transpose(op) * u (1-D arrays carry no orientation)
        if getattr(other, "ndim", None) == 1:
            return self.matvec(other, mode="T")
        return self.__rmul__(other)

    def __truediv__(self, x):
        from .algebra import Scale

        return Scale(1.0 / x, self)

    def __pow__(self, p):
        # op ** p for integral p >= 0: a lazy Compose chain by binary
        # exponentiation (log2(p) graph depth)
        if isinstance(p, bool):
            return NotImplemented
        try:
            import operator as _operator

            p = _operator.index(p)
        except TypeError:
            return NotImplemented
        if self.nrow != self.ncol:
            raise LinearOperatorException("operator power requires a square operator")
        if p < 0:
            raise ValueError("operator power requires p >= 0")
        if p == 0:
            from ..ops.eye import Eye

            return Eye(self.nrow, dtype=self.dtype)
        if p == 1:
            # fresh node, not `self`: aliasing would share counters with the base
            from .algebra import Scale

            return Scale(1.0, self)
        result = None
        base = self
        while p:
            if p & 1:
                result = base if result is None else result @ base
            p >>= 1
            if p:
                base = base @ base
        return result

    def __add__(self, other):
        from .algebra import Sum

        if isinstance(other, LinearOperator):
            return Sum(self, other)
        wrapped = self._wrap_operand(other)
        if wrapped is not None:
            return Sum(self, wrapped)
        if self._is_scalar(other):
            # op + x == op + x·opOnes, the ones on this operator's device
            from ..ops.eye import Ones

            return Sum(self, other * Ones(self.nrow, self.ncol, dtype=self.dtype,
                                          device=self.device))
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, LinearOperator):
            return self + (-other)
        wrapped = self._wrap_operand(other)
        if wrapped is not None:
            return self + (-wrapped)
        if self._is_scalar(other):
            return self + (-other)
        return NotImplemented

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        from .algebra import Scale

        return Scale(-1, self)

    def __pos__(self):
        return self

    def __getitem__(self, key):
        """Slicing returns an operator: ``op[rows, cols] == R @ op @ E`` with
        0-based ints, slices or index arrays (``ops/restriction.py``)."""
        from ..ops.restriction import op_getindex

        if not (isinstance(key, tuple) and len(key) == 2):
            raise LinearOperatorException("operators are sliced with op[rows, cols]")
        return op_getindex(self, key[0], key[1])

    # ------------------------------------------------------------------
    # Symmetrizers
    # ------------------------------------------------------------------

    def hermitianized(self):
        if self.nrow != self.ncol:
            raise LinearOperatorException("Operator is not square")
        if self.hermitian:
            return self
        return (self + self.H) / 2

    def symmetrized(self):
        if self.nrow != self.ncol:
            raise LinearOperatorException("Operator is not square")
        if self.symmetric:
            return self
        return (self + self.T) / 2

    # ------------------------------------------------------------------
    # Display
    # ------------------------------------------------------------------

    def _name(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return (
            f"{self._name()}\n"
            f"  nrow: {self.nrow}\n"
            f"  ncol: {self.ncol}\n"
            f"  dtype: {str(self.dtype).replace('torch.', '')}\n"
            f"  symmetric: {self.symmetric}\n"
            f"  hermitian: {self.hermitian}\n"
            f"  nprod:   {self.nprod}\n"
            f"  ntprod:  {self.ntprod}\n"
            f"  nctprod: {self.nctprod}\n"
        )
