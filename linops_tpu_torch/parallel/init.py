"""Process-group initialization (counterpart of
``linops_tpu/parallel/init.py``).

The reference wires the hosts of a TPU slice into one JAX runtime. Here
each device is one process, and ``initialize_distributed`` joins this
process to a ``torch.distributed`` process group: NCCL over the CUDA
devices by default, gloo on the CPU when asked (``backend="gloo"`` or
``device="cpu"``). Every mesh of ``make_mesh`` / ``make_mesh2d`` spans its
ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.base import LinearOperatorException

__all__ = ["initialize_distributed", "runtime_info"]


def _backend(backend, device) -> str:
    if backend is not None:
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise LinearOperatorException(
            'initialize_distributed: no CUDA device is available; pass backend="gloo" '
            '(or device="cpu") for CPU ranks')
    return "nccl"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join this process to the process group (idempotent: a second call is a
    no-op).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL);
    ``num_processes`` the world size and ``process_id`` this rank. Without
    them the launcher's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) decides, and with none of it a world of one
    process on a free local port. An NCCL rank takes the CUDA device
    ``LOCAL_RANK`` (default: its rank modulo the visible devices)."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif num_processes == 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise LinearOperatorException(
                "initialize_distributed: a world of several processes needs a "
                "coordinator_address (or MASTER_ADDR and MASTER_PORT)")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = _backend(backend, device)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))


def runtime_info() -> dict:
    """Topology summary for logging: this rank, the world size, the devices
    this process drives and the world's, and the platform."""
    if not dist.is_initialized():
        raise LinearOperatorException("runtime_info: call initialize_distributed() first")
    gpu = dist.get_backend() == "nccl"
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
        "platform": "gpu" if gpu else "cpu",
    }
