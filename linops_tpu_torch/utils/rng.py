"""Probe entropy for randomized checks, estimators and eigensolvers.

Counterpart of ``linops_tpu/utils/rng.py``. Every randomized function takes
``generator=`` (a ``torch.Generator`` on the device it draws on) where the
reference takes ``key=``; without one it draws a fresh generator seeded from
OS entropy, so no two calls share a fixed blind spot (a start vector
orthogonal to the dominant singular vector would fail every retry). Pass a
seeded generator to pin determinism.

The reference is one program with one key, so every device sees the same
probes. Here every rank is its own process: a fresh generator for a
distributed call (``like`` holds a placed, halo or DTensor value:
``parallel/comm.py::mesh_of``) takes rank 0's seed on every rank, agreed
by one all-reduce before any loop (none on a one-rank mesh), so each rank
draws the same whole block and keeps its own rows of it. A caller's own
generator is used as given: seeding it alike on every rank is the caller's
job, as passing one ``key`` is in the reference.
"""

from __future__ import annotations

import os

import torch

__all__ = ["fresh_generator"]


def fresh_generator(device, like=()) -> torch.Generator:
    """A generator on ``device`` seeded from OS entropy; for a distributed
    call over ``like`` (operators, tensors) seeded alike on every rank."""
    from ..parallel import comm

    seed = int.from_bytes(os.urandom(8), "little") & ((1 << 63) - 1)
    mesh = comm.mesh_of(*like)
    if mesh is not None:
        seed = comm.agree_seed(seed, mesh)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g
