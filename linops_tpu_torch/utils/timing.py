"""Timing helpers: completion and the marginal two-count method.

Counterpart of the event half of ``linops_tpu/utils/timing.py``. On the card
work is timed between CUDA events and completion is an event's
``synchronize``; on the CPU the host clock times work that is already
complete. Chain timings take the marginal (long − short) method, which
cancels the per-call dispatch cost. The reference's relay-jitter machinery
has no counterpart.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Stopwatch", "sync", "marginal_chain_time"]


class Stopwatch:
    """Seconds between ``start()`` and ``stop()`` on ``device``: CUDA events
    on a card (``stop`` waits for the end event), the host clock otherwise."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t1 = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self._cuda:
            self._t0.record()
        else:
            self._h0 = time.perf_counter()

    def stop(self) -> float:
        if self._cuda:
            self._t1.record()
            self._t1.synchronize()
            return self._t0.elapsed_time(self._t1) / 1e3
        return time.perf_counter() - self._h0


def sync(out):
    """Wait for the device work that produces ``out`` (a tensor, or a tuple
    whose first tensor stands for the rest)."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def marginal_chain_time(run, *args, iters_short=5, iters_long=55, reps=3, device="cpu"):
    """Marginal seconds per iteration of ``run(*args, iters)``: the median
    of repeated (long − short) differences, each run timed by a
    ``Stopwatch`` on ``device``."""
    sync(run(*args, iters_short))
    sync(run(*args, iters_long))
    watch = Stopwatch(device)

    def timed(iters):
        watch.start()
        run(*args, iters)
        return watch.stop()

    deltas = [timed(iters_long) - timed(iters_short) for _ in range(reps)]
    return max(float(np.median(deltas)), 1e-9) / (iters_long - iters_short)
