"""Matmul precision policy: precision follows storage dtype.

Counterpart of ``linops_tpu/core/precision.py``. There the TPU's DEFAULT
matmul precision truncates f32 to bf16, so every library contraction asks
for HIGHEST unless an input is stored in bf16. On Hopper the same trap is
TF32: with ``torch.backends.cuda.matmul.allow_tf32`` on (or a float32
matmul precision other than ``"highest"``) an f32 matmul keeps about three
decimal digits. The policy here:

- any bf16 input  → the bf16 product (f32 accumulation) is the arithmetic
  the storage asks for;
- otherwise       → f32 contractions must be f32-exact: no TF32.

This module changes no global flag, on import or later. The library's
contractions on CUDA check the flags and raise if they would run f32 in
TF32 (``check_f32_exact``); a caller that turned TF32 on for its own work
turns it off around calls into this package.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_precision", "f32_exact", "check_f32_exact", "pdot", "pmatmul",
           "pvdot"]


def matmul_precision(*dtypes) -> str:
    """``"default"`` when any input is bf16, else ``"highest"``."""
    if any(d == torch.bfloat16 for d in dtypes):
        return "default"
    return "highest"


def f32_exact() -> bool:
    """True when f32 matmuls on CUDA run in full f32 (no TF32)."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def check_f32_exact(*tensors) -> None:
    """Raise if a contraction over ``tensors`` would run f32 in TF32."""
    if any(t.is_cuda for t in tensors) and matmul_precision(
            *(t.dtype for t in tensors)) == "highest" and not f32_exact():
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision): f32 contractions would lose "
            "precision; disable it around calls into linops_tpu_torch")


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    check_f32_exact(a, b)
    return a.to(dt), b.to(dt)


def pmatmul(a, b):
    """``a @ b`` under the policy (inputs promoted to a common dtype)."""
    a, b = _promoted(a, b)
    return torch.matmul(a, b)


def pdot(a, b):
    """Unconjugated dot of two vectors under the policy."""
    a, b = _promoted(a, b)
    return torch.dot(a, b)


def pvdot(a, b):
    """``conj(a)·b`` of two vectors (``jnp.vdot``) under the policy."""
    a, b = _promoted(a, b)
    return torch.vdot(a, b)
