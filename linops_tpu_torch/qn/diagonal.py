"""Diagonal quasi-Newton Hessian approximations.

Counterpart of ``linops_tpu/qn/diagonal.py``. Each operator holds a diagonal
``d``; an apply is ``d ⊙ v`` and every ``push`` replaces ``d`` through one of
four updates, plain functions on tensors:

- ``DiagonalPSB``: the Zhu-Nazareth-Wolkowicz weak-secant update;
- ``DiagonalAndrei``: Andrei's update;
- ``SpectralGradient``: the Barzilai-Borwein scalar σI;
- ``DiagonalBFGS``: a diagonal BFGS-inspired update.

All are real, symmetric and hermitian. A diagonal given as host data goes
to ``device=``, the CUDA device by default (``device="cpu"`` for the CPU);
a tensor keeps its device.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, default_device
from ..core.precision import pdot

__all__ = ["DiagonalQNOperator", "DiagonalPSB", "DiagonalAndrei", "SpectralGradient",
           "DiagonalBFGS"]


def _psb_update(d, s, y):
    """Zhu-Nazareth-Wolkowicz PSB update, the sᵀBs = sᵀy relation
    norm-scaled as the reference scales it."""
    s2 = s * s
    sn2 = pdot(s, s)
    trA2 = pdot(s2, s2) / sn2 ** 2
    sT_y = pdot(s, y) / sn2
    sT_B_s = pdot(s2, d) / sn2
    q = (sT_y - sT_B_s) / trA2
    return d + q / sn2 * s2


def _andrei_update(d, s, y):
    """Andrei's diagonal update."""
    s2 = s * s
    sn2 = pdot(s, s)
    trA2 = pdot(s2, s2) / sn2 ** 2
    sT_y = pdot(s, y) / sn2
    sT_B_s = pdot(s2, d) / sn2
    q = (sT_y - sT_B_s + 1.0) / trA2  # sᵀs/‖s‖² == 1 after scaling
    return d + q / sn2 * s2 - 1.0


def _spg_update(d, s, y):
    """Barzilai-Borwein coefficient σ = ⟨s,y⟩/⟨s,s⟩ on every entry."""
    return torch.full_like(d, 1.0) * (pdot(s, y) / pdot(s, s))


def _dbfgs_update(d, s, y):
    """Diagonal BFGS-inspired update: d = |y| · Σ|y| / (sᵀy/‖s‖²)."""
    sT_y = pdot(s, y) / pdot(s, s)
    ay = torch.abs(y)
    return ay * (torch.sum(ay) / sT_y)


class DiagonalQNOperator(LinearOperator):
    """A diagonal operator with a quasi-Newton ``push`` rule."""

    _fields_tensors = ("d",)
    _fields_static = ("_n",)
    _fields_state = ("d",)  # a push or reset swaps in a new d

    _update = None  # subclasses set a staticmethod

    def __init__(self, d, *, device=None):
        super().__init__()
        if device is not None or not isinstance(d, torch.Tensor):
            d = torch.as_tensor(d, device=default_device(device, type(self).__name__))
        if d.ndim != 1:
            raise ValueError("initial diagonal must be a vector")
        if d.is_complex():
            raise ValueError("diagonal quasi-Newton operators are real-only")
        self.d = d
        self._n = d.shape[0]

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def symmetric(self):
        return True

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        return self.d * v

    def _tprod(self, u):
        return self.d * u

    def _ctprod(self, w):
        return self.d * w

    def apply_matrix(self, M, mode: str = "N"):
        return self.d[:, None] * M

    def push(self, s, y):
        """Quasi-Newton diagonal update; raises on ``s = 0``."""
        s = torch.as_tensor(s, dtype=self.d.dtype, device=self.d.device)
        y = torch.as_tensor(y, dtype=self.d.dtype, device=self.d.device)
        if not bool(torch.any(s != 0)):
            raise ValueError("Cannot update DiagonalQN operator with s=0")
        self.d = type(self)._update(self.d, s, y)
        return self

    def diag(self):
        return self.d

    def reset(self):
        """d = 1 and zero counters."""
        self.d = torch.ones_like(self.d)
        self.reset_counters()
        return self


class DiagonalPSB(DiagonalQNOperator):
    """Diagonal PSB approximation (Zhu-Nazareth-Wolkowicz): satisfies the
    weak secant equation ⟨s, Bs⟩ = ⟨s, y⟩; not necessarily positive
    definite."""

    _update = staticmethod(_psb_update)


class DiagonalAndrei(DiagonalQNOperator):
    """Andrei's diagonal approximation: satisfies the weak secant equation;
    not necessarily positive definite."""

    _update = staticmethod(_andrei_update)


class SpectralGradient(DiagonalQNOperator):
    """Spectral (Barzilai-Borwein) gradient approximation σ·I:
    ``SpectralGradient(sigma, n)`` with σ > 0 (f64 unless ``dtype``)."""

    _update = staticmethod(_spg_update)

    def __init__(self, sigma, n, dtype=None, *, device=None):
        sigma = float(sigma)
        if sigma <= 0:
            raise ValueError("σ must be positive")
        dev = default_device(device, "SpectralGradient")
        super().__init__(torch.full((int(n),), sigma, dtype=dtype or torch.float64, device=dev))

    @property
    def sigma(self) -> float:
        return float(self.d[0])


class DiagonalBFGS(DiagonalQNOperator):
    """Diagonal BFGS-inspired approximation (Marnissi et al.)."""

    _update = staticmethod(_dbfgs_update)
