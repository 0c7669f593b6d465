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

The rule for DTensor arguments lives here too. A public entry (an apply, a
solver, ``matvec_chain``, ``funm_apply``, a quasi-Newton push, a shifted
solve) given a DTensor vector runs inside ``plain_as_replicated``
(``dtensor_entry``), so a plain operator, preconditioner or scalar it meets
counts as replicated, as GSPMD treats an unsharded array beside a sharded
one; a vector that DTensor leaves as a partial sum is reduced to a
replicated one (the reference's ``PartitionSpec()``), and loop-carried or
stored DTensors keep the placements they came in with (``keep_placements``).
Loops that keep a basis of such vectors hold this rank's rows of it
(``Rows``) and reduce their products with one all-reduce.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_OPS", "counting", "gather_full", "reduce_scatter", "exchange",
           "from_local", "is_dtensor", "plain_as_replicated", "dtensor_entry",
           "keep_placements", "on_whole", "Rows", "rows_of"]

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
    if is_dtensor(value) and value.ndim and any(p.is_partial() for p in value.placements):
        from torch.distributed.tensor import Replicate

        return value.redistribute(value.device_mesh, [Replicate() if p.is_partial() else p
                                                      for p in value.placements])
    return value


def dtensor_entry(fn):
    """The rule for a public entry: called with a DTensor among its
    arguments (directly or in a tuple or list), ``fn`` runs inside
    ``plain_as_replicated`` and a partial-sum result comes back replicated.
    A call with plain arguments runs ``fn`` as it is."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if not (_holds_dtensor(args) or _holds_dtensor(tuple(kwargs.values()))):
            return fn(*args, **kwargs)
        with plain_as_replicated():
            return _whole_sums(fn(*args, **kwargs))

    return entry


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
    a loop that keeps a basis of them: ``local`` takes a vector's piece (a
    redistribution first if it is placed otherwise), ``dtensor`` makes a
    piece (or an (n_local, k) block) whole again, ``psum`` adds per-rank
    partial products over the ranks the rows are split across (one
    all-reduce), ``norm`` is the 2-norm of a piece's vector (of each column
    of a block) as DTensor reduces it."""

    def __init__(self, like):
        from torch.distributed.tensor import Partial, Replicate

        self.mesh, self.placements = like.device_mesh, tuple(like.placements)
        self.n = like.shape[0]
        self._partial = [Partial() if p.is_shard() else Replicate() for p in self.placements]
        self._whole = [Replicate()] * self.mesh.ndim

    def local(self, v):
        if tuple(v.placements) != self.placements:
            v = v.redistribute(self.mesh, self.placements)
        return v.to_local()

    def dtensor(self, piece):
        return from_local(piece, self.mesh, self.placements, (self.n, *piece.shape[1:]))

    def psum(self, partial):
        return from_local(partial, self.mesh, self._partial, partial.shape).redistribute(
            self.mesh, self._whole).to_local()

    def norm(self, piece, dim=None):
        return torch.linalg.vector_norm(self.dtensor(piece), dim=dim).full_tensor()


class _PlainRows:
    """``Rows`` for a plain vector: every step is the identity, the norm is
    ``torch.linalg.vector_norm``."""

    @staticmethod
    def local(v):
        return v

    dtensor = psum = local

    @staticmethod
    def norm(piece, dim=None):
        return torch.linalg.vector_norm(piece, dim=dim)


def rows_of(v):
    """``Rows(v)`` for a DTensor, the identity steps for a plain tensor."""
    return Rows(v) if is_dtensor(v) else _PlainRows


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


def exchange(sends, recvs, rounds: int):
    """Post one batch of point-to-point transfers: ``sends`` and ``recvs`` are
    lists of (tensor, global peer rank). Counts ``rounds`` collective-permutes
    (one per direction of the exchange, as the reference's ppermutes count,
    whether or not this rank sits at a chain end). Returns the requests:
    ``wait()`` each before reading a received tensor."""
    for counts in _COUNTERS:
        counts["collective-permute"] += rounds
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
    if not ops:
        return []
    return dist.batch_isend_irecv(ops)
