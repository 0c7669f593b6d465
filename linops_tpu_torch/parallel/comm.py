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
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_OPS", "counting", "gather_full", "reduce_scatter", "exchange",
           "from_local", "is_dtensor", "plain_as_replicated"]

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
