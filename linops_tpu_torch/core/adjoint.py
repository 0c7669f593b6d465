"""Adjoint / transpose / conjugate wrappers.

Counterpart of ``linops_tpu/core/adjoint.py``: zero-cost lazy wrappers with
the six-way involution group simplified at construction. A wrapper's
``apply`` composes its mode with the requested one; the inference lattice
lives in ``LinearOperator.apply``. Wrapper counters read the parent's slot
through the reference's cross-mapping (the adjoint's nprod is the parent's
nctprod, and so on).
"""

from __future__ import annotations

from .base import LinearOperator, compose_modes

__all__ = [
    "AdjointOperator",
    "TransposeOperator",
    "ConjugateOperator",
    "adjoint",
    "transpose",
    "conj",
]

_LABEL = {"H": "Adjoint", "T": "Transpose", "C": "Conjugate"}


class _ModeWrapper(LinearOperator):
    """Shared machinery; ``_mode`` is the group element this wrapper applies."""

    _fields_tensors = ("parent",)
    _fields_static = ()
    _mode = "N"

    def __init__(self, parent: LinearOperator):
        super().__init__()
        self.parent = parent

    @property
    def nrow(self):
        return self.parent.ncol if self._mode in ("T", "H") else self.parent.nrow

    @property
    def ncol(self):
        return self.parent.nrow if self._mode in ("T", "H") else self.parent.ncol

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def symmetric(self):
        return self.parent.symmetric

    @property
    def hermitian(self):
        return self.parent.hermitian

    def apply(self, v, mode: str = "N"):
        return self.parent.apply(v, compose_modes(mode, self._mode))

    def apply_matrix(self, M, mode: str = "N"):
        return self.parent.apply_matrix(M, compose_modes(mode, self._mode))

    def bump(self, mode: str, n: int = 1):
        self.parent.bump(compose_modes(mode, self._mode), n)

    def reset_counters(self):
        self.parent.reset_counters()
        return self

    def _counter_for(self, mode: str) -> int:
        """Read the slot the parent's dispatch actually bumps for the
        composed mode (an adjoint apply on a parent without ctprod falls
        back to tprod, so the wrapper reads that slot)."""
        m = compose_modes(mode, self._mode)
        p = self.parent
        return getattr(p, p._slot_for(m))

    @property
    def nprod(self):
        return self._counter_for("N")

    @property
    def ntprod(self):
        return self._counter_for("T")

    @property
    def nctprod(self):
        return self._counter_for("H")

    def _name(self):
        return f"{_LABEL[self._mode]} of " + self.parent._name()

    def __repr__(self):
        return f"{_LABEL[self._mode]} of the following LinearOperator:\n" + repr(self.parent)


class AdjointOperator(_ModeWrapper):
    _mode = "H"


class TransposeOperator(_ModeWrapper):
    _mode = "T"


class ConjugateOperator(_ModeWrapper):
    _mode = "C"


_WRAPPER_FOR = {"H": AdjointOperator, "T": TransposeOperator, "C": ConjugateOperator}


def _wrap(op: LinearOperator, mode: str) -> LinearOperator:
    """Wrap ``op`` in ``mode`` with full involution simplification. The
    self-adjoint shortcuts are not taken here: the wrapper stays and the
    lattice resolves at apply time, which keeps the counters right."""
    if mode == "N":
        return op
    if isinstance(op, _ModeWrapper):
        return _wrap(op.parent, compose_modes(mode, op._mode))
    return _WRAPPER_FOR[mode](op)


def adjoint(op: LinearOperator) -> LinearOperator:
    return _wrap(op, "H")


def transpose(op: LinearOperator) -> LinearOperator:
    return _wrap(op, "T")


def conj(op: LinearOperator) -> LinearOperator:
    return _wrap(op, "C")
