"""Horizontal, vertical and block-diagonal concatenation of operators.

Counterpart of ``linops_tpu/ops/cat.py``: n-ary nodes. ``hcat`` splits its
input into views (``narrow``, no copies) and sums the children's results;
``vcat`` and ``BlockDiagonalOperator`` write the children's results into one
output (``torch.cat``). The transpose and adjoint of an hcat apply as a vcat
of the children's transposes or adjoints, and the other way round. Flags:
hcat and vcat are neither symmetric nor hermitian; a block diagonal is so
when every block is. A bare 2-D array among the operands is wrapped as a
``MatrixOperator`` on the device of the other operands.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.base import LinearOperator, LinearOperatorException
from ..core.dense import MatrixOperator

__all__ = ["HCatOperator", "VCatOperator", "BlockDiagonalOperator", "hcat", "vcat", "hvcat"]


def _offsets(sizes: Sequence[int]) -> Tuple[int, ...]:
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return tuple(out)


def _as_operators(ops) -> tuple:
    """Operands as operators; bare matrices land on the operators' device."""
    dev = next((o.device for o in ops if isinstance(o, LinearOperator) and o.device is not None),
               None)
    out = []
    for o in ops:
        if isinstance(o, LinearOperator):
            out.append(o)
        elif getattr(o, "ndim", None) == 2:
            out.append(MatrixOperator(o, device=None if isinstance(o, torch.Tensor) else dev))
        else:
            raise TypeError(f"cannot interpret {type(o)} as a linear operator")
    return tuple(out)


def _sum(parts):
    """Σ parts with one new allocation (a child may return its input)."""
    if len(parts) == 1:
        return parts[0]
    y = parts[0] + parts[1]
    for p in parts[2:]:
        y = y.add_(p) if torch.promote_types(y.dtype, p.dtype) == y.dtype else y + p
    return y


def _split_apply(ops, X, sizes, mode, matrix: bool):
    """Each child applied to its slice (a view) of X's rows."""
    offs = _offsets(sizes)
    f = "apply_matrix" if matrix else "apply"
    return [getattr(o, f)(X.narrow(0, offs[i], sizes[i]), mode) for i, o in enumerate(ops)]


def _stack_apply(ops, X, mode, matrix: bool):
    f = "apply_matrix" if matrix else "apply"
    return torch.cat([getattr(o, f)(X, mode) for o in ops], dim=0)


class _Cat(LinearOperator):
    _fields_tensors = ("ops",)

    @property
    def dtype(self):
        dt = self.ops[0].dtype
        for o in self.ops[1:]:
            dt = torch.promote_types(dt, o.dtype)
        return dt

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _bump_children(self, mode: str, n: int = 1):
        for o in self.ops:
            o.bump(mode, n)


class HCatOperator(_Cat):
    """``[A B ...]``: N/C split v and sum; T/H stack the children's
    transposes."""

    def __init__(self, ops: Sequence[LinearOperator]):
        super().__init__()
        ops = _as_operators(ops)
        if not ops:
            raise LinearOperatorException("hcat of zero operators")
        if any(o.nrow != ops[0].nrow for o in ops):
            raise LinearOperatorException("hcat: inconsistent row sizes")
        self.ops = ops

    @property
    def nrow(self):
        return self.ops[0].nrow

    @property
    def ncol(self):
        return sum(o.ncol for o in self.ops)

    def _apply(self, X, mode, matrix):
        if mode in ("N", "C"):
            return _sum(_split_apply(self.ops, X, [o.ncol for o in self.ops], mode, matrix))
        return _stack_apply(self.ops, X, mode, matrix)

    def apply(self, v, mode: str = "N"):
        return self._apply(v, mode, False)

    def apply_matrix(self, M, mode: str = "N"):
        return self._apply(M, mode, True)

    def _name(self):
        return "Horizontal concatenation"


class VCatOperator(_Cat):
    """``[A; B; ...]``: N/C stack the children's results; T/H split and sum."""

    def __init__(self, ops: Sequence[LinearOperator]):
        super().__init__()
        ops = _as_operators(ops)
        if not ops:
            raise LinearOperatorException("vcat of zero operators")
        if any(o.ncol != ops[0].ncol for o in ops):
            raise LinearOperatorException("vcat: inconsistent column sizes")
        self.ops = ops

    @property
    def nrow(self):
        return sum(o.nrow for o in self.ops)

    @property
    def ncol(self):
        return self.ops[0].ncol

    def _apply(self, X, mode, matrix):
        if mode in ("N", "C"):
            return _stack_apply(self.ops, X, mode, matrix)
        return _sum(_split_apply(self.ops, X, [o.nrow for o in self.ops], mode, matrix))

    def apply(self, v, mode: str = "N"):
        return self._apply(v, mode, False)

    def apply_matrix(self, M, mode: str = "N"):
        return self._apply(M, mode, True)

    def _name(self):
        return "Vertical concatenation"


class BlockDiagonalOperator(_Cat):
    """diag(M1, ..., Mn); flags are ANDs over the blocks."""

    def __init__(self, *ops):
        super().__init__()
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        ops = _as_operators(ops)
        if not ops:
            raise LinearOperatorException("block-diagonal of zero operators")
        self.ops = ops

    @property
    def nrow(self):
        return sum(o.nrow for o in self.ops)

    @property
    def ncol(self):
        return sum(o.ncol for o in self.ops)

    @property
    def symmetric(self):
        return all(o.symmetric for o in self.ops)

    @property
    def hermitian(self):
        return all(o.hermitian for o in self.ops)

    def _resolve(self, mode):
        if mode == "T" and self.symmetric:
            return "N"
        if mode == "H" and self.hermitian:
            return "N"
        return mode

    def _apply(self, X, mode, matrix):
        mode = self._resolve(mode)
        sizes = [o.nrow if mode in ("T", "H") else o.ncol for o in self.ops]
        return torch.cat(_split_apply(self.ops, X, sizes, mode, matrix), dim=0)

    def apply(self, v, mode: str = "N"):
        return self._apply(v, mode, False)

    def apply_matrix(self, M, mode: str = "N"):
        return self._apply(M, mode, True)

    def _bump_children(self, mode: str, n: int = 1):
        mode = self._resolve(mode)
        for o in self.ops:
            o.bump(mode, n)

    def _name(self):
        return "Block-diagonal operator"


def _flat(ops):
    return tuple(ops[0]) if len(ops) == 1 and isinstance(ops[0], (list, tuple)) else ops


def hcat(*ops) -> LinearOperator:
    return HCatOperator(_flat(ops))


def vcat(*ops) -> LinearOperator:
    return VCatOperator(_flat(ops))


def hvcat(rows: Sequence[int], *ops) -> LinearOperator:
    """Block matrix from a flat list of operators with ``rows[i]`` blocks in
    row i, or from the nested form ``hvcat([[A, B], [C, D]])``."""
    if not ops and rows and isinstance(rows[0], (list, tuple)):
        return vcat(*[hcat(*row) for row in rows])
    if sum(rows) != len(ops):
        raise LinearOperatorException(
            f"hvcat: rows {tuple(rows)} sum to {sum(rows)} but {len(ops)} operators were given")
    out_rows = []
    a = 0
    for r in rows:
        out_rows.append(hcat(*ops[a:a + r]))
        a += r
    return vcat(*out_rows)
