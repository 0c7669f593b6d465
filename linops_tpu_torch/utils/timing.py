"""Timing helpers: completion and the marginal two-count method.

Counterpart of the event half of ``linops_tpu/utils/timing.py``. On the card
work is timed between CUDA events and completion is an event's
``synchronize``; on the CPU the host clock times work that is already
complete. Chain timings take the marginal (long − short) method, which
cancels the per-call dispatch cost; every timed run's output is synced, so a
time never stops at the host's enqueue. The reference's relay-jitter
machinery has no counterpart.
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

    def stop(self, out=None) -> float:
        """Seconds since ``start()``, once the work that produces ``out`` (a
        tensor or a tuple of them, ``sync``'s argument) is done: on the host
        clock after waiting for it, between events before it."""
        if self._cuda:
            self._t1.record()
            self._t1.synchronize()
            sync(out)
            return self._t0.elapsed_time(self._t1) / 1e3
        sync(out)
        return time.perf_counter() - self._h0


def _first_tensor(out):
    while isinstance(out, (tuple, list)):
        if not out:
            return None
        out = out[0]
    return out if isinstance(out, torch.Tensor) else None


def sync(out):
    """Wait for the device work that produces ``out`` (a tensor, or a tuple
    whose first tensor stands for the rest)."""
    out = _first_tensor(out)
    if out is not None and out.is_cuda:
        torch.cuda.synchronize(out.device)


def marginal_chain_time(run, *args, iters_short=5, iters_long=55, reps=3, device=None):
    """Marginal seconds per iteration of ``run(*args, iters)``: the median
    of repeated (long − short) differences, each run timed by a
    ``Stopwatch`` on ``device`` and its output synced, as the reference
    syncs every timed run. ``device=None`` takes the device of ``run``'s
    first output tensor (the CPU when it returns none), so a run on the
    card is timed with CUDA events, not by the host's enqueue."""
    sync(run(*args, iters_short))
    out = run(*args, iters_long)
    sync(out)
    if device is None:
        t = _first_tensor(out)
        device = t.device if t is not None else "cpu"
    watch = Stopwatch(device)

    def timed(iters):
        watch.start()
        return watch.stop(run(*args, iters))

    deltas = [timed(iters_long) - timed(iters_short) for _ in range(reps)]
    return max(float(np.median(deltas)), 1e-9) / (iters_long - iters_short)
