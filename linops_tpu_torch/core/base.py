"""Core operator abstraction, in PyTorch.

Counterpart of ``linops_tpu/core/base.py``. An operator is a plain Python
object holding tensors; a lazy expression (compose / sum / scale / adjoint)
is a tree of such objects whose ``apply`` walks the tree eagerly.

Each class declares which attributes hold tensors (or nested operators,
or NamedTuples of tensors) in ``_fields_tensors``, which hold static
metadata in ``_fields_static``, and which hold state derived from the
tensors and built at first use in ``_fields_derived``. The split drives
``.to(device)``, which returns a copy with every tensor moved and the
derived state dropped, the checkpoints, which also leave out the
tensor fields named in ``_fields_index`` (built from the others), and the
structure key a captured solve is cached under (``capture_signature``),
which walks every field list, so an attribute an apply reads belongs in
one of them.

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
from typing import NamedTuple, Optional, Tuple

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
    "Signature",
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


class _Ident:
    """An object the key holds by identity (a function, anything without
    fields): equal only to itself, and kept alive by the key, so its id
    cannot pass to a new object while the key is cached."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _Ident) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


def _holds_tensor(value) -> bool:
    """Whether a field's value holds a tensor itself (in containers), not
    only through operators or plan objects (which are walked on their own)."""
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, (tuple, list)):
        return any(_holds_tensor(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_tensor(v) for v in value.values())
    return False


class Signature(NamedTuple):
    """One walk of an operator graph (``capture_signature``).

    ``key``: hashable, what a captured block over the graph depends on.
    ``tensors``: every distinct tensor the graph holds, in walk order (a
    graph of the same key lists tensors of the same layouts in the same
    order). ``mirrored``: the indices of those a captured block reads from
    its own copies (all but host scalars keyed by value). ``state``: the
    indices of those in fields that updates replace or applies write
    (``_fields_state``, ``_fields_written``), which a block copies even
    where it reads the rest in place. ``written``: the indices of those an
    apply adds into (``_fields_written``). ``holders``: the (object,
    attribute) pairs whose values hold tensors, for a capture to point at
    its copies."""

    key: tuple
    tensors: list
    mirrored: list
    state: list
    written: list
    holders: list


class _Walk:
    """The state of one ``capture_signature`` walk."""

    def __init__(self):
        self.sig, self.tensors, self.mirrored, self.state = [], [], [], []
        self.written, self.holders = [], []
        self.index = {}  # id of a tensor, operator or plan object -> its first-visit index
        self.nodes = 0

    def _first(self, value, kind) -> Optional[tuple]:
        """The key item of a repeat visit (sharing, not identity, is in the
        key), or None on the first, which is numbered."""
        i = self.index.get(id(value))
        if i is not None:
            return (kind, i)
        if kind == "alias":
            self.index[id(value)] = len(self.tensors)
        else:
            self.index[id(value)] = self.nodes
            self.nodes += 1
        return None

    def tensor(self, t, layout: bool, written: bool):
        seen = self._first(t, "alias")
        if seen is not None:
            self.sig.append(seen)
            return
        i = len(self.tensors)
        self.tensors.append(t)
        local = _local(t)
        shape = tuple(local.shape)
        empty = local.numel() == 0
        stride = tuple(0 if empty or n == 1 else st for n, st in zip(shape, local.stride()))
        item = (shape, stride, local.dtype, local.device)
        if local is not t:
            item += _distribution(t)
        if not layout and not local.is_cuda and local.numel() == 1:
            item += (local.item(),)  # an apply reads it on the host: its value is in the key
        else:
            self.mirrored.append(i)
            if layout:
                self.state.append(i)
        if written:
            self.written.append(i)
        self.sig.append(item)
        plan = getattr(t, "_combine_plan", None)  # kernels/lane_gather.py
        if plan is not None:
            self.value(plan)

    def fields(self, obj, names, layout=(), written=()):
        for f in dict.fromkeys(names):  # a field in two lists once
            v = getattr(obj, f, None)
            if _holds_tensor(v):
                self.holders.append((obj, f))
            self.sig.append(f)
            self.value(v, f in layout or f in written, f in written)

    def value(self, value, layout: bool = False, written: bool = False):
        sig = self.sig
        if isinstance(value, torch.Tensor):
            self.tensor(value, layout, written)
        elif isinstance(value, LinearOperator):
            seen = self._first(value, "seen")
            if seen is not None:
                sig.append(seen)
                return
            cls = type(value)
            # a placed copy applies through its placement
            if getattr(cls, "_placed_from", None) is None:
                value._build_derived()
            sig.append((cls,))
            self.fields(value, cls._fields_tensors + cls._fields_static + cls._fields_derived
                        + cls._fields_index + cls._fields_written,
                        cls._fields_state, cls._fields_written)
            placement = getattr(value, "_placement", None)  # a sharded operator's
            if placement is not None:
                self.value(placement)
        elif _is_mesh(value):
            sig.append(_mesh_key(value))
        elif isinstance(value, (tuple, list)):
            sig.append((type(value), len(value)))
            for v in value:
                self.value(v, layout, written)
        elif isinstance(value, dict):
            sig.append((dict, len(value)))
            for k, v in value.items():
                sig.append(k if isinstance(k, (int, float, str, bool, tuple)) else _Ident(k))
                self.value(v, layout, written)
        elif value is None or isinstance(value, (bool, int, float, complex, str, torch.dtype,
                                                 torch.device, np.dtype)):
            sig.append(value)
        elif isinstance(value, np.generic):
            sig.append(value.item())
        elif hasattr(value, "__dict__") and not callable(value):
            seen = self._first(value, "seen")
            if seen is not None:
                sig.append(seen)
                return
            sig.append((type(value),))
            self.fields(value, tuple(vars(value)))
        else:
            sig.append(_Ident(value))


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


def capture_signature(value) -> Signature:
    """One walk of an operator graph (or a tuple of them, ``None`` for an
    absent one): the key a CUDA graph captured over its applies is cached
    under, with the tensors that graph reads (``Signature``).

    The key is the structure, as the reference's jit cache keys a pytree by
    its treedef and its leaves' shapes and dtypes: every node by its class
    and its fields, static ones by value; a node reached twice by the index
    of its first visit (sharing, not identity); every tensor by layout
    (shape, the strides that address anything, dtype, device; a DTensor by
    its local tensor's, with its mesh, placements and global shape), never
    by address, version or value, a tensor reached twice by the index of
    its first visit (the aliasing pattern); a host scalar by value as well
    (an apply reads it on the host), unless it lies in a field an update
    replaces (``_fields_state``: σ) or an apply writes (``_fields_written``);
    a sharded operator's placement, and any other object with fields (a
    plan), by its class and fields; device meshes by their ranks and axis
    names; containers item by item; numbers and strings by value; anything
    else (a function) by identity, held by the key. So a fresh operator of
    the same structure has the same key, and a captured solve replays over
    its own copies of the tensors (``utils/loop.py``), into which it copies
    a fresh operator's before its first replay.

    Lazy plans (``_fields_derived``) are built first, as an apply on the
    operator's device would build them (``LinearOperator._build_derived``),
    so a fresh operator keys as one that has been applied."""
    w = _Walk()
    w.value(value)
    return Signature(tuple(w.sig), w.tensors, w.mirrored, w.state, w.written, w.holders)


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
    # tensor fields that updates replace with new tensors of the same layout
    # (a push, a new shift): a capture key sees a host scalar there by
    # layout, as it sees every other tensor (``capture_signature``)
    _fields_state: Tuple[str, ...] = ()
    # tensors an apply adds into in place (a counter), outside the other
    # lists: keyed by layout; a captured solve adds into its own copy and
    # copies it back after each replay (``utils/loop.py``)
    _fields_written: Tuple[str, ...] = ()

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

    def _build_derived(self) -> None:
        """Build the lazy plans (``_fields_derived``) that an apply on this
        operator's device would build, before a capture key is taken. A plan
        left out costs a fresh operator one more plain solve (its key differs
        until the plan exists), never a wrong replay."""

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
        that is not (a host factorization, a timer) says so, and solves over
        it run the per-iteration loop
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
