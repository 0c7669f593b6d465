"""Sharded operators: partition an operator's tensors over a device mesh.

Counterpart of ``linops_tpu/parallel/sharded.py``. The reference places
each array leaf with a ``NamedSharding`` and lets GSPMD partition every
jitted apply. Here every rank runs the same program on its own piece, and
``shard_operator`` returns a copy of the operator whose tensors are
DTensors over the mesh plus a *placement*: the object its ``apply`` goes
through (``LinearOperator.apply``). The partition rules are the
reference's:

- dense 2-D leaves: rows split; 1-D leaves of length ≥ 2 (diagonals): split;
  scalars: replicated; DTensor runs the apply, inserting its collectives
  (a row-split dense product all-gathers x; a dot all-reduces);
- quasi-Newton memories ``(mem, n)``: split along n; the per-pair scalars
  and the Gram matrices replicated;
- BSR: block rows split. Forward: one all-gather of x, then K1 (K3/K5 for a
  windowed operator) on this rank's block rows, the output split by rows.
  Transpose: K2 (K4/K6) on this rank's rows into a full-length partial,
  then one reduce-scatter;
- ELL: rows split, applied as BSR is (plain torch);
- COO/CSR: the nnz axis split, ``indptr`` replicated; each rank sums its
  entries into a full-length partial, then one reduce-scatter;
- Clos routing programs and permutation stages: replicated whole (a row
  split of interdependent index structures means nothing); each rank runs
  K7-K12 on its replica of the whole input.

A size the mesh does not divide warns and replicates, as the reference
does; nothing is padded. Vectors are DTensors, split by rows
(``row_sharding(mesh).place(v)``), and a sharded operator returns DTensors
for them, in the input's placement. A plain tensor given to it counts as
replicated, and its result is a DTensor in the reference's placement:
split by rows for a row-partitioned forward apply, replicated where GSPMD
replicates (the transpose of a row split, one all-reduce; the nnz-split
formats; a replicated program). Each placement's ``layout`` says where the
operator keeps its vectors (``comm.layout_of``).
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional

import torch

from ..core.base import Counters, LinearOperator, mode_transposed
from . import comm
from .mesh import Mesh

__all__ = ["shard_operator", "operator_sharding_rule"]


def _placements():
    from torch.distributed.tensor import Replicate, Shard

    return Replicate, Shard


def _put(t, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    if comm.is_dtensor(t):
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _set(obj, name, value):
    object.__setattr__(obj, name, value)  # past classes that guard their fields


def _rank(mesh) -> int:
    return mesh.get_local_rank()


def _row_span(n: int, mesh):
    """This rank's rows of an n-row dimension split as DTensor splits it
    (``torch.chunk``: pieces of ceil(n / W), the last ones shorter)."""
    c = -(-n // mesh.size())
    r0 = min(_rank(mesh) * c, n)
    return r0, min(r0 + c, n)


def _local_rows(v, mesh, n: int):
    """This rank's rows of a vector or matrix ``v`` with n rows."""
    if comm.is_dtensor(v):
        _, Shard = _placements()
        if tuple(v.placements) != (Shard(0),):
            v = v.redistribute(mesh, [Shard(0)])
        return v.to_local()
    r0, r1 = _row_span(n, mesh)
    return v[r0:r1]


def _like(y, v, mesh):
    """The full result ``y`` (the same on every rank) as a DTensor with
    ``v``'s placements (a local slice: no communication), replicated when
    ``v`` is a plain tensor."""
    Replicate, _ = _placements()
    y = comm.from_local(y, mesh, [Replicate()], y.shape)
    return y.redistribute(mesh, v.placements) if comm.is_dtensor(v) else y


def _has_split(value, rows_of_matrix: bool = False) -> bool:
    """Whether an operator field holds a split DTensor (with
    ``rows_of_matrix``: a 2-D one split along its rows)."""
    if isinstance(value, LinearOperator):
        return any(_has_split(getattr(value, f, None), rows_of_matrix)
                   for f in type(value)._fields_tensors)
    if isinstance(value, tuple):
        return any(_has_split(v, rows_of_matrix) for v in value)
    if not comm.is_dtensor(value):
        return False
    if rows_of_matrix:
        return value.ndim == 2 and any(p.is_shard(0) for p in value.placements)
    return any(p.is_shard() for p in value.placements)


class _DTensorLeaves:
    """The operator's tensors are DTensors and DTensor runs the apply;
    plain tensors met on the way (index tensors, a replicated input) count
    as replicated, and a plain input's partial-sum result is reduced."""

    def __init__(self, mesh):
        self.mesh = mesh

    def apply(self, op, base, v, mode):
        with comm.plain_as_replicated():
            y = base(op, v, mode)
        return y if comm.is_dtensor(v) else comm._whole_sums(y)

    apply_matrix = apply_matrix_t = apply

    def layout(self, op, domain):
        Replicate, Shard = _placements()
        # the adjoint of a matrix with split rows sums over them: replicated
        whole = not _has_split(op) or (domain and _has_split(op, rows_of_matrix=True))
        return comm.Layout(self.mesh, [Replicate()] if whole else [Shard(0)])


class _Replicated:
    """Every rank holds the whole operator: the input is gathered, the apply
    runs on this rank's replica (on the card, its kernels), and the result
    takes the input's placement (replicated for a plain input)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def apply(self, op, base, v, mode):
        return _like(base(op, comm.gather_full(v), mode), v, self.mesh)

    apply_matrix = apply_matrix_t = apply

    def layout(self, op, domain):
        Replicate, _ = _placements()
        return comm.Layout(self.mesh, [Replicate()])


def _reduced(partial, v, mesh):
    """Per-rank full-length partial results summed: split by rows (one
    reduce-scatter) for a DTensor input, replicated (one all-reduce) for a
    plain one, as GSPMD places the sum."""
    return comm.reduce_scatter(partial, mesh) if comm.is_dtensor(v) else \
        comm.all_reduce(partial, mesh)


class _RowShard:
    """Rows split: ``local`` is this rank's row block as an operator of its
    own (full column count). Forward: gather x, apply locally, the output
    split by rows. Transpose: this rank's rows of u through the local
    transpose into a full-length partial, then one reduce-scatter (one
    all-reduce for a plain u)."""

    def __init__(self, mesh, local):
        self.mesh = mesh
        self.local = local

    def _run(self, op, v, mode, fn):
        _, Shard = _placements()
        if not mode_transposed(mode):
            y = fn(comm.gather_full(v), mode)
            return comm.from_local(y, self.mesh, [Shard(0)], (op.nrow, *y.shape[1:]))
        return _reduced(fn(_local_rows(v, self.mesh, op.nrow), mode), v, self.mesh)

    def apply(self, op, base, v, mode):
        return self._run(op, v, mode, self.local.apply)

    def apply_matrix(self, op, base, M, mode):
        return self._run(op, M, mode, self.local.apply_matrix)

    def apply_matrix_t(self, op, base, Mt, mode):
        return self.apply_matrix(op, base, Mt.t(), mode).t()

    def layout(self, op, domain):
        Replicate, Shard = _placements()
        return comm.Layout(self.mesh, [Replicate()] if domain else [Shard(0)])


class _NnzShard:
    """The stored entries split: ``local`` holds this rank's entries over
    the full shape. Every mode gathers the input and sums this rank's
    entries into a full-length partial, then one reduce-scatter (one
    all-reduce for a plain input)."""

    def __init__(self, mesh, local):
        self.mesh = mesh
        self.local = local

    def apply(self, op, base, v, mode):
        return _reduced(self.local.apply(comm.gather_full(v), mode), v, self.mesh)

    def apply_matrix(self, op, base, M, mode):
        return _reduced(self.local.apply_matrix(comm.gather_full(M), mode), M, self.mesh)

    def apply_matrix_t(self, op, base, Mt, mode):
        return self.apply_matrix(op, base, Mt.t(), mode).t()

    def layout(self, op, domain):
        Replicate, _ = _placements()
        return comm.Layout(self.mesh, [Replicate()])


_PLACED: dict = {}


def _placed_class(cls):
    """``cls`` with its three applies going through the instance's
    ``_placement`` (which may call ``cls``'s own apply, ``base``): the class
    of every operator ``shard_operator`` returns, made once per class."""
    sub = _PLACED.get(cls)
    if sub is None:
        def apply(self, v, mode="N"):
            return self._placement.apply(self, cls.apply, v, mode)

        def apply_matrix(self, M, mode="N"):
            return self._placement.apply_matrix(self, cls.apply_matrix, M, mode)

        def apply_matrix_t(self, Mt, mode="N"):
            return self._placement.apply_matrix_t(self, cls.apply_matrix_t, Mt, mode)

        sub = type(cls.__name__, (cls,), {
            "apply": apply, "apply_matrix": apply_matrix, "apply_matrix_t": apply_matrix_t,
            "_placed_from": cls, "__module__": cls.__module__,
            "__qualname__": cls.__qualname__, "__doc__": cls.__doc__})
        _PLACED[cls] = sub
    return sub


def _placed(new, placement):
    _set(new, "_placement", placement)
    _set(new, "__class__", _placed_class(type(new)))
    return new


def _default_placements(arr, n_dev: int):
    Replicate, Shard = _placements()
    if arr.ndim in (1, 2) and arr.shape[0] >= 2:
        if arr.shape[0] % n_dev == 0:
            return [Shard(0)]
        warnings.warn(
            f"shard_operator: leaf of shape {tuple(arr.shape)} is not divisible by the "
            f"{n_dev}-device mesh axis; it stays replicated", stacklevel=4)
    return [Replicate()]


def _qn_placements(arr, n_dev: int):
    """(mem, n) memories: split the operator dimension n; replicate the small
    per-pair scalars and the (mem, mem) Gram matrices."""
    Replicate, Shard = _placements()
    is_memory = arr.ndim == 2 and arr.shape[1] != arr.shape[0]
    if is_memory and arr.shape[1] % n_dev == 0:
        return [Shard(1)]
    if is_memory:
        warnings.warn(
            f"shard_operator: QN memory dimension n={arr.shape[1]} is not divisible by "
            f"the {n_dev}-device mesh axis; the ring buffers stay REPLICATED (a silent "
            "perf cliff at scale — pad n to a multiple of the mesh size)", stacklevel=4)
    return [Replicate()]


def _qn_states():
    from ..qn.lbfgs import LBFGSState
    from ..qn.lsr1 import LSR1State

    return LBFGSState, LSR1State


def _place(value, mesh, spec_fn):
    """Place the tensors inside an operator field, recursively."""
    if isinstance(value, LinearOperator):
        return shard_operator(value, mesh)
    if isinstance(value, _qn_states()):
        n_dev = mesh.size()
        return type(value)(*(_put(t, mesh, _qn_placements(t, n_dev)) for t in value))
    if isinstance(value, tuple):
        items = [_place(v, mesh, spec_fn) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    if isinstance(value, torch.Tensor):
        return _put(value, mesh, spec_fn(value))
    return value


def operator_sharding_rule(op: LinearOperator):
    """The placement function used for ``op``'s own tensors: ``arr ->
    placements``. A class may define ``_shard_child(self, arr, n_dev)`` to
    override it."""
    custom = getattr(type(op), "_shard_child", None)

    def spec_fn(arr, mesh_size=None, _op=op):
        return custom(_op, arr, mesh_size) if custom is not None else \
            _default_placements(arr, mesh_size)

    return spec_fn


def _shard_bsr(new, mesh):
    """Block rows split, or (warned) replicated where the mesh does not
    divide them into the vector's row split."""
    from ..sparse.formats import BSR

    _, Shard = _placements()
    d = new.data
    W = mesh.size()
    nbrow, bm = d.blocks.shape[0], d.block_shape[0]
    nrow = d.shape[0]
    c = -(-nrow // W)
    groups = new.win_q.shape[-1] if new.win_q is not None else nbrow
    if nbrow % W or groups % W or (nbrow // W) * bm != c or nrow <= (W - 1) * c:
        warnings.warn(
            f"shard_operator: BSR block-row count {nbrow} (rows {nrow}) does not split over "
            f"the {W}-device mesh axis; storage stays replicated (pad the block rows for a "
            "true row partition)", stacklevel=3)
        return _placed(new, _Replicated(mesh))
    local = copy.copy(new)
    k, nb_loc, g_loc = _rank(mesh), nbrow // W, groups // W
    rows = slice(k * nb_loc, (k + 1) * nb_loc)
    r0, r1 = _row_span(nrow, mesh)
    new.data = BSR(_put(d.blocks, mesh, [Shard(0)]), _put(d.block_cols, mesh, [Shard(0)]),
                   d.shape)
    local.data = BSR(new.data.blocks.to_local(), new.data.block_cols.to_local(),
                     (r1 - r0, d.shape[1]))
    if new.win_q is not None:
        grp = slice(k * g_loc, (k + 1) * g_loc)
        local.win_q = new.win_q[..., grp].contiguous()
        if new.cols_local is not None:
            local.cols_local = new.cols_local[rows].contiguous()
        if new.win_q_t is not None:
            local.win_q_t = new.win_q_t[:, grp].contiguous()
            local.win_valid_t = new.win_valid_t[:, grp].contiguous()
    local._symmetric = local._hermitian = False
    local._counters = Counters()
    local._check_plan()
    local._build_index()
    return _placed(new, _RowShard(mesh, local))


def _shard_ell(new, mesh):
    from ..sparse.formats import ELL
    from ..sparse.ops import ELLOperator

    _, Shard = _placements()
    d = new.data
    W, nrow = mesh.size(), d.vals.shape[0]
    if nrow % W:
        warnings.warn(
            f"shard_operator: ELL row count {nrow} is not divisible by the {W}-device mesh "
            "axis; storage stays replicated", stacklevel=3)
        return _placed(new, _Replicated(mesh))
    r0, r1 = _row_span(nrow, mesh)
    new.data = ELL(_put(d.vals, mesh, [Shard(0)]), _put(d.cols, mesh, [Shard(0)]), d.shape)
    local = ELLOperator(ELL(new.data.vals.to_local(), new.data.cols.to_local(),
                            (r1 - r0, d.shape[1])))
    return _placed(new, _RowShard(mesh, local))


def _shard_indexed(new, mesh):
    """COO/CSR: the nnz axis split, ``indptr`` replicated."""
    from ..sparse.formats import COO, CSR
    from ..sparse.ops import COOOperator

    Replicate, Shard = _placements()
    d = new.data
    W = mesh.size()
    if d.nnz % W:
        warnings.warn(
            f"shard_operator: nnz={d.nnz} not divisible by the {W}-device mesh axis; sparse "
            "storage stays replicated", stacklevel=3)
        return _placed(new, _Replicated(mesh))
    split = {f: _put(getattr(d, f), mesh, [Shard(0)]) for f in ("vals", "rows", "cols")}
    local = COOOperator(COO(*(split[f].to_local() for f in ("vals", "rows", "cols")), d.shape))
    if isinstance(d, CSR):
        new.data = d._replace(indptr=_put(d.indptr, mesh, [Replicate()]), **split)
    else:
        new.data = d._replace(**split)
    return _placed(new, _NnzShard(mesh, local))


def shard_operator(op: LinearOperator, mesh: Mesh, axis: Optional[str] = None):
    """A copy of ``op`` placed on ``mesh`` by the rules above, recursing
    through composite graphs. Every rank calls it with the same operator;
    each keeps its own piece. Structural flags are kept."""
    from ..ops.permutation import PermutationOperator
    from ..sparse.ops import BSROperator, COOOperator, CSROperator, ELLOperator, \
        RoutedCSROperator

    if axis is not None and axis != mesh.mesh_dim_names[0]:
        raise ValueError(f"mesh has no axis {axis!r}")
    new = copy.copy(op)
    base = getattr(type(op), "_placed_from", None)
    if base is not None:  # placed again: start from the operator's own class
        _set(new, "__class__", base)
    _set(new, "_counters", Counters())
    if isinstance(op, (RoutedCSROperator, PermutationOperator)):
        return _placed(new, _Replicated(mesh))
    if isinstance(op, BSROperator):
        return _shard_bsr(new, mesh)
    if isinstance(op, ELLOperator):
        return _shard_ell(new, mesh)
    if isinstance(op, (COOOperator, CSROperator)):
        return _shard_indexed(new, mesh)
    rule = operator_sharding_rule(op)
    n_dev = mesh.size()
    fields = {f: getattr(op, f) for f in type(op)._fields_tensors}
    split = []

    def spec_fn(arr):
        placements = rule(arr, n_dev)
        split.append(any(not p.is_replicate() for p in placements))
        return placements

    placed = {f: _place(v, mesh, spec_fn) for f, v in fields.items()}
    if split and not any(split) and not any(_holds_operator(v) for v in fields.values()):
        # a leaf whose tensors all stay whole: it runs on this rank's replica
        return _placed(new, _Replicated(mesh))
    for f, v in placed.items():
        _set(new, f, v)
    for f in type(op)._fields_derived:
        _set(new, f, None)
    return _placed(new, _DTensorLeaves(mesh))


def _holds_operator(value) -> bool:
    if isinstance(value, LinearOperator):
        return True
    return isinstance(value, tuple) and any(_holds_operator(v) for v in value)
