"""Timed decorator operator: the tracing and profiling hook.

Counterpart of ``linops_tpu/ops/timed.py``. Each eager apply through
``matvec`` is timed (CUDA events on the card, the host clock on the CPU,
``utils/timing.py::Stopwatch``), waits once for its result as the
reference's host fetch does, and is annotated for ``torch.profiler`` as
``linops.<slot>``. Inside a larger graph the decorator is transparent (its
``apply`` forwards). Counters delegate to the wrapped operator, and the
decorator commutes with ``.T``, ``.H`` and ``conj``.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator
from ..core.dense import aslinearoperator
from ..utils.timing import Stopwatch

__all__ = ["TimedOperator"]

_SLOT = {"N": "prod", "T": "tprod", "H": "ctprod", "C": "prod"}


class TimedOperator(LinearOperator):
    _fields_tensors = ("op",)
    _fields_static = ()

    def __init__(self, op):
        super().__init__()
        self.op = aslinearoperator(op)
        self.timings = {"prod": [0, 0.0], "tprod": [0, 0.0], "ctprod": [0, 0.0]}

    @property
    def nrow(self):
        return self.op.nrow

    @property
    def ncol(self):
        return self.op.ncol

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def symmetric(self):
        return self.op.symmetric

    @property
    def hermitian(self):
        return self.op.hermitian

    # inside a graph: transparent forwarding
    def apply(self, v, mode: str = "N"):
        return self.op.apply(v, mode)

    def apply_matrix(self, M, mode: str = "N"):
        return self.op.apply_matrix(M, mode)

    def _has_tprod(self):
        return self.op._has_tprod()

    def _has_ctprod(self):
        return self.op._has_ctprod()

    def _bump_children(self, mode: str, n: int = 1):
        self.op.bump(mode, n)

    # counters are the wrapped operator's, so they survive commutation
    @property
    def nprod(self) -> int:
        return self.op.nprod

    @property
    def ntprod(self) -> int:
        return self.op.ntprod

    @property
    def nctprod(self) -> int:
        return self.op.nctprod

    def reset_counters(self):
        super().reset_counters()
        self.op.reset_counters()
        return self

    # eager entry point: timed
    def matvec(self, v, mode: str = "N"):
        from ..core.apply import matvec

        slot = _SLOT[mode]
        device = v.device if isinstance(v, torch.Tensor) else (self.op.device or "cpu")
        watch = Stopwatch(device)
        with torch.profiler.record_function(f"linops.{slot}"):
            watch.start()
            out = matvec(self, v, mode=mode)
            dt = watch.stop()
        rec = self.timings[slot]
        rec[0] += 1
        rec[1] += dt
        return out

    @property
    def T(self):
        return TimedOperator(self.op.T)

    @property
    def H(self):
        return TimedOperator(self.op.H)

    def conj(self):
        return TimedOperator(self.op.conj())

    def _name(self):
        return "Timed operator"

    def __repr__(self):
        lines = ["TimedOperator wrapping:", repr(self.op), "timings:"]
        for slot, (n, t) in self.timings.items():
            lines.append(f"  {slot:8s} ncalls={n:6d}  total={t * 1e3:10.3f} ms")
        return "\n".join(lines)
