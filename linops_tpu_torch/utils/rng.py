"""Probe entropy for randomized checks, estimators and eigensolvers.

Counterpart of ``linops_tpu/utils/rng.py``. Every randomized function takes
``generator=`` (a ``torch.Generator`` on the device it draws on) where the
reference takes ``key=``; without one it draws a fresh generator seeded from
OS entropy, so no two calls share a fixed blind spot (a start vector
orthogonal to the dominant singular vector would fail every retry). Pass a
seeded generator to pin determinism.
"""

from __future__ import annotations

import os

import torch

__all__ = ["fresh_generator"]


def fresh_generator(device) -> torch.Generator:
    """A generator on ``device`` seeded from OS entropy."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int.from_bytes(os.urandom(8), "little") & ((1 << 63) - 1))
    return g
