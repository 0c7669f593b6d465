"""Carry state from the JAX reference (``linops_tpu``) into this package.

Everything crosses as numpy arrays, never as JAX objects, so this package
never imports jax. A bf16 array crosses as f32 (exact) and is narrowed back
here: pass ``dtype=torch.bfloat16``, or hand over a numpy array whose dtype
is named ``bfloat16`` (ml_dtypes, as ``np.asarray`` of a JAX bf16 array
gives) and it is converted through f32 on the way.

Every function builds on ``device``: the CUDA device by default,
``device="cpu"`` for the CPU (see ``core.base.default_device``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.base import default_device
from .ops.diagonal import DiagonalOperator
from .qn import diagonal as _dqn
from .qn.lbfgs import LBFGSState
from .qn.lsr1 import LSR1State
from .sparse.dia import DIAOperator
from .sparse.formats import BSR
from .sparse.ops import BSROperator
from .sparse.routed import ReducePass, RoutedSpMV, RoutedTranspose
from .sparse.stencil import StencilOperator

__all__ = ["from_numpy", "to_numpy", "bsr_from_reference", "bsr_operator_from_reference",
           "lbfgs_state_from_reference", "lsr1_state_from_reference", "diagonal_from_reference",
           "diagonal_qn_from_reference", "dia_from_reference", "stencil_from_reference",
           "routed_from_reference"]


def from_numpy(a, *, dtype=None, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor, copied, on ``device``."""
    device = default_device(device, "from_numpy")
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = torch.bfloat16 if dtype is None else dtype
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 comes back as f32."""
    t = t.detach().cpu().resolve_conj()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def bsr_from_reference(blocks, block_cols, shape, *, dtype=None, device=None) -> BSR:
    """A reference ``BSR`` (its ``blocks``, ``block_cols`` and ``shape``) as
    this package's ``BSR``. Padding the reference added is kept."""
    device = default_device(device, "bsr_from_reference")
    return BSR(blocks=from_numpy(blocks, dtype=dtype, device=device),
               block_cols=from_numpy(block_cols, dtype=torch.int32, device=device),
               shape=(int(shape[0]), int(shape[1])))


def bsr_operator_from_reference(blocks, block_cols, shape, *, win_q=None, cols_local=None,
                                win_q_t=None, win_valid_t=None, wb=0, x_pad_blocks=0,
                                x_pad_blocks_t=0, symmetric=False, hermitian=False,
                                backend="auto", dtype=None, device=None) -> BSROperator:
    """A reference ``BSROperator`` as this package's, window plan included:
    its (padded) ``data`` fields, ``win_q``, ``cols_local``, ``win_q_t``,
    ``win_valid_t`` (numpy arrays or None) and ``_wb``, ``_x_pad_blocks``,
    ``_x_pad_blocks_t``. The operator runs the plan it is given; it does
    not plan again."""
    device = default_device(device, "bsr_operator_from_reference")
    return BSROperator(bsr_from_reference(blocks, block_cols, shape, dtype=dtype, device=device),
                       symmetric, hermitian, backend=backend, win_q=win_q,
                       cols_local=cols_local, win_q_t=win_q_t, win_valid_t=win_valid_t,
                       _wb=wb, _x_pad_blocks=x_pad_blocks, _x_pad_blocks_t=x_pad_blocks_t)


def lbfgs_state_from_reference(fields: Mapping[str, np.ndarray], *, device=None) -> LBFGSState:
    """A reference ``LBFGSState`` as this package's: ``fields`` maps each of
    the 13 field names to a numpy array (``{f: np.asarray(getattr(st, f))
    for f in st._fields}``)."""
    return _state_from_reference(LBFGSState, fields, device, "lbfgs_state_from_reference")


def _state_from_reference(cls, fields, device, what):
    device = default_device(device, what)
    missing = set(cls._fields) - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return cls(**{f: from_numpy(fields[f], dtype=torch.int32 if f == "insert" else None,
                                device=device) for f in cls._fields})


def lsr1_state_from_reference(fields: Mapping[str, np.ndarray], *, device=None) -> LSR1State:
    """A reference ``LSR1State`` as this package's: ``fields`` maps each of
    the 11 field names to a numpy array."""
    return _state_from_reference(LSR1State, fields, device, "lsr1_state_from_reference")


def dia_from_reference(diags, offsets, *, symmetric=False, hermitian=False, dtype=None,
                       device=None) -> DIAOperator:
    """A reference ``DIAOperator`` (its ``diags`` and ``offsets``) as this
    package's."""
    device = default_device(device, "dia_from_reference")
    return DIAOperator(from_numpy(diags, dtype=dtype, device=device), offsets,
                       symmetric=symmetric, hermitian=hermitian)


def stencil_from_reference(grid_shape, offsets, coeffs, *, dtype=None,
                           device=None) -> StencilOperator:
    """A reference ``StencilOperator`` (its grid, offsets and coefficients)
    as this package's."""
    device = default_device(device, "stencil_from_reference")
    return StencilOperator(grid_shape, offsets, from_numpy(coeffs, dtype=dtype, device=device))


def diagonal_qn_from_reference(cls_name: str, d, *, device=None):
    """A reference diagonal quasi-Newton operator (``DiagonalPSB``,
    ``DiagonalAndrei``, ``SpectralGradient`` or ``DiagonalBFGS``, by class
    name) with its current diagonal ``d``."""
    if cls_name not in ("DiagonalPSB", "DiagonalAndrei", "SpectralGradient", "DiagonalBFGS"):
        raise ValueError(f"unknown diagonal quasi-Newton class {cls_name!r}")
    cls = getattr(_dqn, cls_name)
    op = cls.__new__(cls)
    _dqn.DiagonalQNOperator.__init__(op, from_numpy(d, device=device))
    return op


def diagonal_from_reference(d, *, dtype=None, device=None) -> DiagonalOperator:
    """A reference ``opDiagonal``'s vector ``d`` as a ``DiagonalOperator``."""
    return DiagonalOperator(from_numpy(d, dtype=dtype, device=device))


_PROGRAMS = {cls.__name__: cls for cls in (RoutedSpMV, RoutedTranspose, ReducePass)}


def _program_leaf(v, device):
    """A reference program leaf in this package's form: arrays (numpy or,
    for ``ReducePass`` stages, device arrays passed through numpy) become
    tensors, program NamedTuples this package's, tuples recurse, the rest
    (ints, None) is kept."""
    if v is None or isinstance(v, (int, np.integer)):
        return v
    if isinstance(v, tuple):
        items = [_program_leaf(x, device) for x in v]
        if hasattr(v, "_fields"):
            return _PROGRAMS[type(v).__name__](*items)
        return tuple(items)
    return from_numpy(np.asarray(v), device=device)


def routed_from_reference(fwd_np, der_np=None, *, device=None):
    """The reference's routing programs (``pack_routed_csr(...,
    to_device=False)``: a ``RoutedSpMV`` and, optionally, its derived
    ``RoutedTranspose``) as this package's, on ``device``. Returns
    ``(fwd, der)``; ``der`` is None when ``der_np`` is."""
    device = default_device(device, "routed_from_reference")
    return _program_leaf(fwd_np, device), _program_leaf(der_np, device)
