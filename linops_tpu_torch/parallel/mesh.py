"""Device meshes and shardings for distributed operators.

Counterpart of ``linops_tpu/parallel/mesh.py``. The reference is one
controller placing global arrays with a ``NamedSharding``; PyTorch is SPMD,
one process per device in a ``torch.distributed`` process group, and its own
forms of ``Mesh``, ``NamedSharding`` and ``P`` are ``DeviceMesh`` and the
DTensor placements (``Shard(dim)``, ``Replicate()``). ``Mesh`` is
``DeviceMesh``; ``P`` and ``NamedSharding`` are small classes that carry a
reference-style partition spec and translate it into placements.

A mesh spans ranks of the process group that ``initialize_distributed``
set up: NCCL ranks on CUDA devices by default, gloo ranks on the CPU when
asked (``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.base import LinearOperatorException

__all__ = ["make_mesh", "replicated", "row_sharding", "P", "NamedSharding", "Mesh",
           "mesh_device_type"]

Mesh = DeviceMesh


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dimension, each None (not split), a mesh axis name, or a tuple of
    names (split over those axes jointly, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class NamedSharding:
    """A mesh and a partition spec; ``placements`` are the DTensor placements
    they stand for, one per mesh dimension."""

    def __init__(self, mesh: DeviceMesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def place(self, t):
        """``t`` (the same global tensor on every rank) as a DTensor with
        these placements; each rank keeps its own piece, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.placements, src_data_rank=None)

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {self.spec})"


def mesh_device_type(device=None) -> str:
    """``"cuda"`` unless ``device`` says otherwise; without a card the caller
    must ask for the CPU."""
    if device is not None:
        return torch.device(device).type
    if not torch.cuda.is_available():
        raise LinearOperatorException(
            'no CUDA device is available; pass device="cpu" for a mesh of gloo ranks')
    return "cuda"


def _world() -> int:
    if not dist.is_initialized():
        raise LinearOperatorException(
            "no process group: call linops_tpu_torch.parallel.initialize_distributed() "
            "in every process first")
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard", device=None) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all of them),
    on CUDA devices unless ``device="cpu"``. Its one axis (default name
    ``"shard"``) is the operator-partition axis: operator rows and vector
    segments are split along it. Every rank of the process group calls it."""
    world = _world()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices but only {world} available")
    return DeviceMesh(mesh_device_type(device), torch.arange(n_devices),
                      mesh_dim_names=(axis,))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharding(mesh: DeviceMesh, axis: Optional[str] = None) -> NamedSharding:
    """Sharding that splits dim 0 across the mesh axis."""
    if axis is None:
        axis = mesh.mesh_dim_names[0]
    return NamedSharding(mesh, P(axis))
