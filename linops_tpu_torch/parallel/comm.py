"""The distributed layer's collectives, and their count.

Every collective of the port passes through this module. The explicit ones
are the wrappers below: ``gather_full`` (an all-gather of a sharded vector),
``reduce_scatter`` of per-rank partial results, and ``exchange`` (one or
more neighbour exchange rounds over point-to-point sends). The first two go
through DTensor redistributions, so they run the same ``c10d_functional``
collectives that DTensor inserts on its own inside ordinary tensor ops (a
dot of two sharded vectors, a sharded dense product).

``counting()`` counts both kinds by the reference's names
(``linops_tpu/parallel/introspect.py::COLLECTIVE_OPS``): the functional
collectives through torch's ``CommDebugMode``, and each ``exchange`` round
as one ``collective-permute`` (the reference's ``ppermute``). A count is
per rank: what this process's program issued.

The rule for distributed calls lives here too. A call is distributed when
an operator or an argument holds a DTensor or is a placed or halo operator
(``mesh_of``). A public entry (an apply, a solver, ``matvec_chain``,
``funm_apply``, a spectral routine, an estimator, a check, a quasi-Newton
push, a shifted solve) runs a distributed call inside
``plain_as_replicated`` (``dtensor_entry``), so a plain operator,
preconditioner or scalar it meets counts as replicated, as GSPMD treats an
unsharded array beside a sharded one; a solver's plain vectors are placed
in the operator's vector layout first (``layout_of``: no communication, a
plain vector is the same on every rank), so x comes back where the
reference puts it; a vector that DTensor leaves as a partial sum is
reduced to a replicated one (the reference's ``PartitionSpec()``), and
loop-carried or stored DTensors keep the placements they came in with
(``keep_placements``). Loops that keep a basis or a block of such vectors
hold this rank's rows of it (``Rows``) and reduce their products with one
all-reduce. A random draw of a distributed call takes one seed on every
rank (``agree_seed``): the whole block is drawn alike everywhere and each
rank keeps its rows.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_OPS", "counting", "gather_full", "reduce_scatter", "all_reduce",
           "exchange", "from_local", "is_dtensor", "plain_as_replicated", "dtensor_entry",
           "keep_placements", "on_whole", "Rows", "rows_of", "Layout", "layout_of", "mesh_of",
           "rows_at", "agree_seed"]

COLLECTIVE_OPS = ("collective-permute", "all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all")

# c10d_functional op name -> the reference's instruction name
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_COUNTERS: list = []  # the open counting() dicts, innermost last
_REPLICATING = [0]  # depth of plain_as_replicated()


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@contextlib.contextmanager
def plain_as_replicated():
    """Inside the block a plain tensor met by a DTensor op counts as
    replicated. torch's ``implicit_replication`` switches that off when any
    block of it ends, nested or not, so only the outermost level enters it."""
    from torch.distributed.tensor.experimental import implicit_replication

    _REPLICATING[0] += 1
    try:
        if _REPLICATING[0] > 1:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _REPLICATING[0] -= 1


def _holds_dtensor(value) -> bool:
    if isinstance(value, (tuple, list)):
        return any(_holds_dtensor(v) for v in value)
    return type(value).__name__ == "DTensor"  # no import on a plain call


def _whole_sums(value):
    """``value`` with every DTensor vector or block that holds a partial sum
    reduced on the mesh dimensions it is partial on (one all-reduce each).
    A scalar (a residual norm) keeps its pending reduction, which DTensor
    runs where it is read."""
    if type(value) is tuple:
        return tuple(_whole_sums(v) for v in value)
    return made_whole(value) if is_dtensor(value) and value.ndim else value


def made_whole(t):
    """``t`` with the reduction it holds pending (a DTensor dot, norm or
    stack of dots) run now: one all-reduce on each mesh dimension it is
    partial on, so that it meets a split vector whole (DTensor would pay an
    all-gather and a reduce-scatter there). Anything else as it is."""
    if is_dtensor(t) and any(p.is_partial() for p in t.placements):
        from torch.distributed.tensor import Replicate

        return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in t.placements])
    return t


class Layout:
    """Where a distributed operator keeps its vectors: a mesh and the
    placements of an (n,) vector or an (n, k) block along its rows.
    ``place`` turns a whole tensor (the same on every rank) into a DTensor
    in this layout, each rank keeping its own rows: no communication."""

    def __init__(self, mesh, placements):
        self.mesh, self.placements = mesh, tuple(placements)

    def place(self, t):
        if is_dtensor(t):
            return t if tuple(t.placements) == self.placements else t.redistribute(
                self.mesh, self.placements)
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.placements, src_data_rank=None)

    def replicate(self, t):
        """A whole tensor (the same on every rank) as a replicated DTensor."""
        return from_local(t, self.mesh, _replicated(self.mesh), t.shape)


def _rows_split(mesh):
    from torch.distributed.tensor import Shard

    return [Shard(0)] * mesh.ndim


def _replicated(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _op_layout(op, domain: bool):
    """An operator's layout (``layout_of``), or None for a plain one: its
    own hook (``_vector_layout``), a placed operator's placement, a halo
    operator's mesh (vectors split by rows), else its first distributed
    child's or DTensor leaf's."""
    hook = getattr(op, "_vector_layout", None)
    if hook is not None:
        return hook(domain)
    placement = getattr(op, "_placement", None)
    if placement is not None:
        return placement.layout(op, domain)
    mesh = getattr(op, "_mesh", None)
    if type(mesh).__name__ == "DeviceMesh":
        return Layout(mesh, _rows_split(mesh))
    for f in type(op)._fields_tensors:
        lay = _layout(getattr(op, f, None), domain)
        if lay is not None:
            return lay
    return None


def _layout(value, domain: bool):
    from ..core.base import LinearOperator

    if isinstance(value, LinearOperator):
        return _op_layout(value, domain)
    if isinstance(value, (tuple, list)):
        for v in value:
            lay = _layout(v, domain)
            if lay is not None:
                return lay
        return None
    if type(value).__name__ == "DTensor":  # no import on a plain call
        from torch.distributed.tensor import Replicate

        return Layout(value.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in value.placements])
    return None


def layout_of(*values, domain: bool = False):
    """The layout of the first distributed value among ``values`` (operators,
    tensors, tuples of them), or None when none is distributed (a plain
    call). An operator's layout is where a forward apply of a replicated
    vector leaves its result (its range): rows split for a row-partitioned
    or halo operator, replicated for a replicated one; ``domain=True`` asks
    where its adjoint leaves one (replicated for a row-split matrix, whose
    adjoint sums over the split rows, as GSPMD places it). A DTensor's is
    its own placements, a pending partial sum counted as replicated."""
    for v in values:
        lay = _layout(v, domain)
        if lay is not None:
            return lay
    return None


def mesh_of(*values):
    """The mesh of a distributed call over ``values``, or None for a plain
    one: the predicate of every distributed entry."""
    lay = layout_of(*values)
    return None if lay is None else lay.mesh


def _place_plain(value, lay, n):
    """A plain (n,) vector or (n, k) block placed in ``lay``."""
    if isinstance(value, torch.Tensor) and not is_dtensor(value) and value.ndim in (1, 2) \
            and value.shape[0] == n:
        return lay.place(value)
    return value


def dtensor_entry(fn=None, *, place: bool = True):
    """The rule for a public entry: a distributed call (``mesh_of`` of its
    arguments, directly or in a tuple or list) runs ``fn`` inside
    ``plain_as_replicated`` and a partial-sum result comes back replicated;
    with ``place`` (a solver, a routine that keeps vectors across a loop) a
    plain vector or block whose length is the operator's is placed in the
    operator's layout first, so the loop keeps one layout and x comes back
    in it. A call with plain arguments runs ``fn`` as it is."""
    if fn is None:
        return functools.partial(dtensor_entry, place=place)

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        values = args + tuple(kwargs.values())
        lay = layout_of(*values)
        if lay is None:
            return fn(*args, **kwargs)
        if place and not _holds_dtensor(values):
            from ..core.base import LinearOperator

            op = next((a for a in values if isinstance(a, LinearOperator)), None)
            lay = layout_of(op) if op is not None else None
            if lay is not None:
                args = tuple(_place_plain(a, lay, op.nrow) for a in args)
                kwargs = {k: _place_plain(v, lay, op.nrow) for k, v in kwargs.items()}
        with plain_as_replicated():
            return _whole_sums(fn(*args, **kwargs))

    return entry


def agree_seed(seed: int, mesh) -> int:
    """Rank 0's ``seed`` on every rank of ``mesh``: one all-reduce (per mesh
    dimension) of a one-element tensor that holds it on the first rank and
    zero elsewhere, read back once. A one-rank mesh issues nothing."""
    if mesh.size() == 1:
        return int(seed)
    from torch.distributed.tensor import Partial

    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" \
        else torch.device(mesh.device_type)
    first = all(c == 0 for c in mesh.get_coordinate())
    t = torch.tensor([int(seed) if first else 0], dtype=torch.int64, device=dev)
    t = from_local(t, mesh, [Partial()] * mesh.ndim, (1,)).redistribute(
        mesh, _replicated(mesh)).to_local()
    return int(t.item())


def keep_placements(new, old):
    """``new`` (a tensor, or a tuple or named tuple of them) with each
    DTensor in the placements of its counterpart in ``old``, a pending
    partial sum there counted as replicated (DTensor cannot redistribute to
    a partial sum), and made whole where its counterpart was a plain tensor
    (a loop's flag or scalar, which counts as replicated): a loop's carry
    and an operator's stored state keep their layout, as a compiled loop's
    carry keeps its sharding, so a solve's key is the same before and after
    it runs. ``keep_placements(state, state)`` reduces a state's pending
    partial sums."""
    if isinstance(new, tuple):
        items = [keep_placements(a, b) for a, b in zip(new, old)]
        return type(new)(*items) if hasattr(new, "_fields") else tuple(items)
    if not is_dtensor(new):
        return new
    if not is_dtensor(old):
        return new.full_tensor() if isinstance(old, torch.Tensor) else new
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in old.placements)
    if tuple(new.placements) != want:
        return new.redistribute(old.device_mesh, want)
    return new


def on_whole(fn, *args):
    """``fn(*args)`` for small replicated operands (a Gram matrix, a
    compact middle): where some are DTensors, each rank runs ``fn`` on whole
    plain copies (a pending partial sum reduced) and the result comes back
    replicated, since a factorization or a small solve has no distributed
    form (and no sharding rule in every torch release). Plain operands run
    ``fn`` as they are."""
    meshes = [a.device_mesh for a in args if is_dtensor(a)]
    if not meshes:
        return fn(*args)
    from torch.distributed.tensor import Replicate

    out = fn(*(a.full_tensor() if is_dtensor(a) else a for a in args))
    return from_local(out, meshes[0], [Replicate()] * meshes[0].ndim, out.shape)


class Rows:
    """This rank's rows of vectors placed as ``like`` (a 1-D DTensor), for
    a loop that keeps a basis or a block of them: ``local`` takes a vector's
    piece (a redistribution first if it is placed otherwise; a plain tensor
    counts as replicated), ``dtensor`` makes a piece (or an (n_local, k)
    block) whole again, ``psum`` adds per-rank partial products over the
    ranks the rows are split across (one all-reduce), ``norm`` is the
    2-norm of a piece's vector (of each column of a block) as DTensor
    reduces it. The ``_t`` forms take (k, n_local) row panels. Made from a
    DTensor ``like`` or from a ``Layout`` and a row count ``n``."""

    def __init__(self, like=None, *, layout=None, n=None):
        from torch.distributed.tensor import Partial, Replicate, Shard

        if like is not None:
            layout, n = Layout(like.device_mesh, like.placements), like.shape[0]
        self.mesh, self.placements, self.n = layout.mesh, tuple(layout.placements), n
        self._partial = [Partial() if p.is_shard() else Replicate() for p in self.placements]
        self._whole = [Replicate()] * self.mesh.ndim
        self._panel = tuple(Shard(1) if p.is_shard() else p for p in self.placements)
        # the row pieces: their count, and this rank's index in the order of
        # DTensor's split (the mesh dimensions that split, outermost first)
        split = [d for d, p in enumerate(self.placements) if p.is_shard()]
        coord = self.mesh.get_coordinate()
        self.pieces, self.index = 1, 0
        for d in split:
            self.pieces *= self.mesh.shape[d]
            self.index = self.index * self.mesh.shape[d] + coord[d]
        from ..core.base import _mesh_key

        self.key = (_mesh_key(self.mesh), self.placements)

    def local(self, v):
        if not is_dtensor(v):
            return Layout(self.mesh, self.placements).place(v).to_local()
        if tuple(v.placements) != self.placements:
            v = v.redistribute(self.mesh, self.placements)
        return v.to_local()

    def dtensor(self, piece):
        return from_local(piece.contiguous(), self.mesh, self.placements,
                          (self.n, *piece.shape[1:]))

    def local_t(self, v):
        if tuple(v.placements) != self._panel:
            v = v.redistribute(self.mesh, self._panel)
        return v.to_local()

    def dtensor_t(self, panel):
        return from_local(panel.contiguous(), self.mesh, self._panel, (panel.shape[0], self.n))

    def psum(self, partial):
        return from_local(partial, self.mesh, self._partial, partial.shape).redistribute(
            self.mesh, self._whole).to_local()

    def norm(self, piece, dim=None):
        return torch.linalg.vector_norm(self.dtensor(piece), dim=dim).full_tensor()

    def norm_t(self, panel):
        """The 2-norm of each row of a (k, n_local) panel's whole."""
        return torch.linalg.vector_norm(self.dtensor_t(panel), dim=1).full_tensor()

    def replicated(self, t):
        """A small result, the same on every rank, as a replicated DTensor."""
        return from_local(t, self.mesh, self._whole, t.shape)


class _PlainRows:
    """``Rows`` for a plain vector: every step is the identity, the norm is
    ``torch.linalg.vector_norm``."""

    key = ()
    pieces, index = 1, 0

    @staticmethod
    def local(v):
        return v

    dtensor = psum = local_t = dtensor_t = replicated = local

    @staticmethod
    def norm(piece, dim=None):
        return torch.linalg.vector_norm(piece, dim=dim)

    @staticmethod
    def norm_t(panel):
        return torch.linalg.vector_norm(panel, dim=1)


def rows_of(v):
    """``Rows(v)`` for a DTensor, the identity steps for a plain tensor."""
    return Rows(v) if is_dtensor(v) else _PlainRows


def rows_at(layout, n: int):
    """``Rows`` of a ``Layout`` (None: the identity steps of a plain call)."""
    return _PlainRows if layout is None else Rows(layout=layout, n=n)


@contextlib.contextmanager
def counting():
    """Count the collectives issued inside the block: yields a dict from
    each name of ``COLLECTIVE_OPS`` to a count, filled when the block ends."""
    from torch.distributed.tensor.debug import CommDebugMode

    counts = dict.fromkeys(COLLECTIVE_OPS, 0)
    _COUNTERS.append(counts)
    try:
        with CommDebugMode() as mode:
            yield counts
    finally:
        _COUNTERS.remove(counts)
    for op, n in mode.get_comm_counts().items():
        name = _FUNCTIONAL.get(str(op).rsplit(".", 1)[-1])
        if name is not None:
            counts[name] += n


def from_local(local, mesh, placements, shape):
    """A DTensor over ``mesh`` from this rank's piece ``local`` of a tensor of
    global ``shape`` (no communication)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=stride)


def gather_full(v):
    """The whole of ``v`` on this rank as a plain tensor: an all-gather of a
    sharded DTensor, the local tensor of a replicated one, ``v`` itself for a
    plain tensor."""
    if not is_dtensor(v):
        return v
    return v.full_tensor()


def reduce_scatter(partial, mesh, dim: int = 0):
    """The sum over ranks of each rank's ``partial`` (a full-size tensor),
    sharded along ``dim`` over ``mesh``'s ranks in DTensor's layout: one
    reduce-scatter."""
    from torch.distributed.tensor import Partial, Shard

    placements = [Partial()] * mesh.ndim
    out = [Shard(dim)] * mesh.ndim
    return from_local(partial, mesh, placements, partial.shape).redistribute(mesh, out)


def all_reduce(partial, mesh):
    """The sum over ranks of each rank's ``partial`` (a full-size tensor),
    replicated: one all-reduce."""
    from torch.distributed.tensor import Partial

    return from_local(partial, mesh, [Partial()] * mesh.ndim, partial.shape).redistribute(
        mesh, _replicated(mesh))


def exchange(sends, recvs, rounds: int):
    """Post one batch of point-to-point transfers: ``sends`` and ``recvs`` are
    lists of (tensor, global peer rank); a send may be a strided or lazily
    conjugated view. Counts ``rounds`` collective-permutes
    (one per direction of the exchange, as the reference's ppermutes count,
    whether or not this rank sits at a chain end). Returns the requests:
    ``wait()`` each before reading a received tensor."""
    for counts in _COUNTERS:
        counts["collective-permute"] += rounds
    ops = [dist.P2POp(dist.isend, t.resolve_conj().contiguous(), peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
    if not ops:
        return []
    return dist.batch_isend_irecv(ops)
