"""Randomized property checks: one probe each, tolerance eps^(1/3).

Counterpart of ``linops_tpu/utils/checks.py``; exact equality for integer
element types. Probes come from ``_rand`` on the operator's device (or
``device=`` for an operator that holds no tensor), drawn from ``generator``
or a fresh one (``utils/rng.py``). On a distributed operator a probe is
drawn whole from one seed on every rank and placed in the operator's
layout (``parallel/comm.py``): every rank gives the same answer.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperatorException, default_device
from ..core.dense import aslinearoperator
from ..core.precision import pvdot
from ..parallel import comm
from .rng import fresh_generator

__all__ = ["check_ctranspose", "check_hermitian", "check_positive_definite"]


def _is_int(op) -> bool:
    return not (op.dtype.is_floating_point or op.dtype.is_complex)


def _real_dtype(op):
    if _is_int(op):
        return torch.float64
    return torch.empty((), dtype=op.dtype).real.dtype


def _eps(op) -> float:
    return torch.finfo(_real_dtype(op)).eps


def _device(op, device, what):
    return op.device if op.device is not None else default_device(device, what)


def _rand(g, n, op, device):
    """The probe: uniform on [0, 1) in op's real dtype, or integers in
    [-5, 5) for an integer operator."""
    if _is_int(op):
        u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
        return torch.floor(10 * u).to(op.dtype) - 5
    return torch.rand(n, generator=g, dtype=_real_dtype(op), device=device)


def _placed(op, v, domain: bool = False):
    """A whole probe, the same on every rank, in the operator's layout (its
    range's, or with ``domain`` its domain's)."""
    lay = comm.layout_of(op, domain=domain)
    return v if lay is None else lay.place(v)


def _close(a, b, op) -> bool:
    a, b = comm.gather_full(a), comm.gather_full(b)
    if _is_int(op):
        return bool(a == b)
    eps = _eps(op)
    return bool(torch.abs(a - b) < (torch.abs(a) + eps) * eps ** (1 / 3))


def _dot(a, b):
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return pvdot(a, b)
    return (a * b).sum()


@comm.dtensor_entry
def check_ctranspose(op, generator=None, *, device=None) -> bool:
    """⟨y, Ax⟩ ≈ conj(⟨x, Aᴴy⟩) on random probes."""
    op = aslinearoperator(op)
    m, n = op.shape
    dev = _device(op, device, "check_ctranspose")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    x = _placed(op, _rand(g, n, op, dev), domain=True)
    y = _placed(op, _rand(g, m, op, dev))
    yAx = _dot(y, op.matvec(x))
    xAty = _dot(x, op.matvec(y, mode="H"))
    return _close(yAx, xAty.conj(), op)


@comm.dtensor_entry
def check_hermitian(op, generator=None, *, device=None) -> bool:
    """Hermiticity through ‖Av‖² = ⟨v, A(Av)⟩."""
    op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException("shape mismatch")
    dev = _device(op, device, "check_hermitian")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    v = _placed(op, _rand(g, n, op, dev))
    w = op.matvec(v)
    return _close(_dot(w, w), _dot(v, op.matvec(w)), op)


@comm.dtensor_entry
def check_positive_definite(op, semi: bool = False, generator=None, *, device=None) -> bool:
    """One Rayleigh-quotient probe of (semi-)definiteness; an imaginary part
    of ⟨v, Av⟩ above sqrt(eps)·|⟨v, Av⟩| fails it."""
    op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException("shape mismatch")
    dev = _device(op, device, "check_positive_definite")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    v = _placed(op, _rand(g, n, op, dev))
    vw = comm.gather_full(_dot(v, op.matvec(v)))
    if not _is_int(op):
        if float(torch.abs(vw.imag if vw.is_complex() else 0 * vw)) > _eps(op) ** 0.5 * float(
                torch.abs(vw)):
            return False
    vw = float(vw.real if vw.is_complex() else vw)
    return (vw >= 0) if semi else (vw > 0)
