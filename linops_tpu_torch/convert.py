"""Carry state from the JAX reference (``linops_tpu``) into this package.

Everything crosses as numpy arrays, never as JAX objects, so this package
never imports jax. A bf16 array crosses as f32 (exact) and is narrowed back
here: pass ``dtype=torch.bfloat16``, or hand over a numpy array whose dtype
is named ``bfloat16`` (ml_dtypes, as ``np.asarray`` of a JAX bf16 array
gives) and it is converted through f32 on the way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.diagonal import DiagonalOperator
from .qn.lbfgs import LBFGSState
from .sparse.formats import BSR
from .sparse.ops import BSROperator

__all__ = ["from_numpy", "to_numpy", "bsr_from_reference", "bsr_operator_from_reference",
           "lbfgs_state_from_reference", "diagonal_from_reference"]


def from_numpy(a, *, dtype=None, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor, copied, on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = torch.bfloat16 if dtype is None else dtype
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 comes back as f32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def bsr_from_reference(blocks, block_cols, shape, *, dtype=None, device=None) -> BSR:
    """A reference ``BSR`` (its ``blocks``, ``block_cols`` and ``shape``) as
    this package's ``BSR``. Padding the reference added is kept."""
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
    return BSROperator(bsr_from_reference(blocks, block_cols, shape, dtype=dtype, device=device),
                       symmetric, hermitian, backend=backend, win_q=win_q,
                       cols_local=cols_local, win_q_t=win_q_t, win_valid_t=win_valid_t,
                       _wb=wb, _x_pad_blocks=x_pad_blocks, _x_pad_blocks_t=x_pad_blocks_t)


def lbfgs_state_from_reference(fields: Mapping[str, np.ndarray], *, device=None) -> LBFGSState:
    """A reference ``LBFGSState`` as this package's: ``fields`` maps each of
    the 13 field names to a numpy array (``{f: np.asarray(getattr(st, f))
    for f in st._fields}``)."""
    missing = set(LBFGSState._fields) - set(fields)
    if missing:
        raise ValueError(f"L-BFGS state fields missing: {sorted(missing)}")
    return LBFGSState(**{
        f: from_numpy(fields[f], dtype=torch.int32 if f == "insert" else None, device=device)
        for f in LBFGSState._fields})


def diagonal_from_reference(d, *, dtype=None, device=None) -> DiagonalOperator:
    """A reference ``opDiagonal``'s vector ``d`` as a ``DiagonalOperator``."""
    return DiagonalOperator(from_numpy(d, dtype=dtype, device=device))
