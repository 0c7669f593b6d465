"""Block sparse rows (BSR) storage.

Counterpart of ``linops_tpu/sparse/formats.py`` (BSR only; COO/CSR/ELL come
with a later slice). Every block row holds the same number of (bm, bn)
blocks; padding blocks are zero and point at block column 0, so they add
nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["BSR", "bsr_from_dense"]


class BSR(NamedTuple):
    """``blocks[i, j]`` is the dense (bm, bn) block at block row i, block
    column ``block_cols[i, j]``. ``shape`` is the logical (unpadded) shape."""

    blocks: torch.Tensor  # (nbrow, kmax, bm, bn)
    block_cols: torch.Tensor  # (nbrow, kmax) int32
    shape: Tuple[int, int]

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.blocks.shape[2], self.blocks.shape[3])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        bn = self.blocks.shape[3]
        return (self.blocks.shape[0] * self.blocks.shape[2], -(-self.shape[1] // bn) * bn)


def bsr_from_dense(A, block_shape: Tuple[int, int] = (8, 128), tol: float = 0.0) -> BSR:
    """Tile A (numpy) into (bm, bn) blocks, keep the nonzero ones, pad each
    block row to the largest block count. Returns CPU tensors; move the
    operator built on it with ``.to(device)``."""
    A = np.asarray(A)
    nrow, ncol = A.shape
    bm, bn = block_shape
    nbrow = -(-nrow // bm)
    nbcol = -(-ncol // bn)
    Ap = np.zeros((nbrow * bm, nbcol * bn), dtype=A.dtype)
    Ap[:nrow, :ncol] = A

    tiles = Ap.reshape(nbrow, bm, nbcol, bn).transpose(0, 2, 1, 3)  # (nbrow, nbcol, bm, bn)
    nz_mask = (np.abs(tiles) > tol).any(axis=(2, 3))

    kmax = max(int(nz_mask.sum(axis=1).max()), 1)
    blocks = np.zeros((nbrow, kmax, bm, bn), dtype=A.dtype)
    block_cols = np.zeros((nbrow, kmax), dtype=np.int32)
    for i in range(nbrow):
        js = np.nonzero(nz_mask[i])[0]
        blocks[i, : len(js)] = tiles[i, js]
        block_cols[i, : len(js)] = js
    return BSR(blocks=torch.from_numpy(blocks), block_cols=torch.from_numpy(block_cols),
               shape=(nrow, ncol))
