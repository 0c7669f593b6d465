"""Distributed operator layer: device meshes, sharded operators, halo
exchanges, on ``torch.distributed`` (counterpart of ``linops_tpu/parallel``).

One process per device; ``initialize_distributed`` joins the process group
(NCCL on CUDA devices by default, gloo on the CPU when asked), ``make_mesh``
/ ``make_mesh2d`` build ``DeviceMesh``es over its ranks, vectors are
DTensors, and every collective passes through ``comm`` (counted by
``collective_counts``).
"""

from .mesh import make_mesh, replicated, row_sharding, P, NamedSharding, Mesh
from .sharded import shard_operator, operator_sharding_rule
from .init import initialize_distributed, runtime_info
from .halo import HaloPartitionedOperator, banded_partition
from .halo2d import HaloStencil2DOperator, stencil_partition_2d, make_mesh2d
from .introspect import collective_counts, hlo_collective_counts
from .scaling_bench import scaling_report

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "HaloStencil2DOperator",
    "stencil_partition_2d",
    "replicated",
    "row_sharding",
    "P",
    "NamedSharding",
    "Mesh",
    "shard_operator",
    "operator_sharding_rule",
    "initialize_distributed",
    "runtime_info",
    "HaloPartitionedOperator",
    "banded_partition",
    "collective_counts",
    "hlo_collective_counts",
    "scaling_report",
]
