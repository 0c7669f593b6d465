"""BSR SpMV kernels K1-K6, their plain versions and the window planners.

Counterparts of ``linops_tpu/kernels/bsr_spmv.py``:

- ``bsr_matvec_kernel`` replaces ``bsr_matvec_pallas`` (K1);
- ``bsr_rmatvec_kernel`` replaces ``bsr_rmatvec_pallas`` (K2);
- ``bsr_matvec_windowed_kernel`` replaces ``bsr_matvec_pallas_windowed`` (K3);
- ``bsr_rmatvec_windowed_kernel`` replaces ``bsr_rmatvec_pallas_windowed`` (K4);
- ``bsr_matvec_multiwin_kernel`` replaces ``bsr_matvec_pallas_multiwin`` (K5);
- ``bsr_rmatvec_multiwin_kernel`` replaces ``bsr_rmatvec_pallas_multiwin`` (K6).

Their panel forms, the block apply of a transpose (the reference runs
``jax.vmap`` of the vector kernel there, one batched ``pallas_call``):
``bsr_rmatmat_kernel`` (K2p), ``bsr_rmatmat_windowed_kernel`` (K4p) and
``bsr_rmatmat_multiwin_kernel`` (K6p), each on the plan of its vector kernel,
column j bit for bit the vector kernel applied to column j.

K3-K6 consume the reference's window plans (``bsr_window_plan``,
``bsr_window_plan_multi``, ``bsr_window_plan_multi_t``: host numpy, copied
from the reference so the same operator gets the same plan).

The kernels are hand-written CUDA C++ for ``sm_90a`` in ``csrc/bsr_spmv.cu``
(K1, K2, K2p) and ``csrc/bsr_window.cu`` (K3-K6, K4p, K6p), design notes there, built with
``nvcc`` at first use (``build.py``). Each
wrapper dispatches on the device of the tensors it is given: CPU tensors take
the plain PyTorch version beside it; CUDA tensors launch the kernel or raise.
There is no fallback from a CUDA tensor to the plain version.

What the TPU kernels needed and these do not: the one-hot selector matmuls
and the bf16 hi/mid/lo split of x (an exact gather replaces them), the
lane-major cols and the ``t_out``/``t_in`` layouts, and the nbrow padding to a
rows-per-program multiple for K1/K2. Data the reference padded is still
accepted. ``fast``/``variant``/``t_out``/``t_in`` are accepted for call-site
parity and ignored: the gather is exact and the layouts are natural.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import check_f32_exact
from ..core.segsum import segment_plan, segment_sum
from ..utils import loop

__all__ = [
    "bsr_matvec_kernel",
    "bsr_rmatvec_kernel",
    "bsr_matvec_windowed_kernel",
    "bsr_rmatvec_windowed_kernel",
    "bsr_matvec_multiwin_kernel",
    "bsr_rmatvec_multiwin_kernel",
    "bsr_rmatmat_kernel",
    "bsr_rmatmat_windowed_kernel",
    "bsr_rmatmat_multiwin_kernel",
    "bsr_matvec_plain",
    "bsr_rmatvec_plain",
    "bsr_matmat_plain",
    "bsr_matvec_windowed_plain",
    "bsr_rmatvec_windowed_plain",
    "bsr_rmatvec_windowed_plan",
    "bsr_matvec_multiwin_plain",
    "bsr_rmatvec_multiwin_plain",
    "bsr_rmatmat_plain",
    "bsr_rmatmat_windowed_plain",
    "bsr_rmatmat_multiwin_plain",
    "bsr_column_index",
    "bsr_column_plan",
    "BSRColumnPlan",
    "bsr_multiwin_index",
    "bsr_window_t_index",
    "bsr_multiwin_t_plan",
    "bsr_window_plan",
    "bsr_window_plan_multi",
    "bsr_window_plan_multi_t",
    "bsr_window_rows",
    "bsr_row_pad",
    "BSR_PALLAS_MAX_X_ELEMS",
    "BSR_PALLAS_MAX_WINDOW_BLOCKS",
    "BSR_PALLAS_MAX_WINDOWS",
    "launch_counts",
    "reset_launch_counts",
    "kernel_dtypes",
]

# kernel name -> launches since the last reset; bumped only where a kernel
# is launched (never by the plain versions), a launch recorded into a CUDA
# graph being captured included; a replay of that graph runs the kernel
# without the wrapper and is not counted (``utils/loop.py``)
_LAUNCHES = {"bsr_matvec": 0, "bsr_rmatvec": 0, "bsr_matvec_windowed": 0,
             "bsr_rmatvec_windowed": 0, "bsr_matvec_multiwin": 0,
             "bsr_rmatvec_multiwin": 0, "bsr_rmatmat": 0, "bsr_rmatmat_windowed": 0,
             "bsr_rmatmat_multiwin": 0}
loop.register_launches(_LAUNCHES)
# kernel name -> the device function each of its launches runs once: the name
# a profiler trace or a CUDA graph's kernel node gives it (K2, K4, K6 and
# their panel forms also run a combine pass)
LAUNCH_SYMBOLS = {"bsr_matvec": "bsr_matvec_kernel", "bsr_rmatvec": "rmatvec_chunk_kernel",
                  "bsr_matvec_windowed": "bsr_matvec_windowed_kernel",
                  "bsr_rmatvec_windowed": "windowed_combine_kernel",
                  "bsr_matvec_multiwin": "bsr_matvec_multiwin_kernel",
                  "bsr_rmatvec_multiwin": "multiwin_chunk_kernel",
                  "bsr_rmatmat": "rmatmat_chunk_kernel",
                  "bsr_rmatmat_windowed": "windowed_panel_combine_kernel",
                  "bsr_rmatmat_multiwin": "multiwin_panel_chunk_kernel"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (block dtype, vector/output dtype) pairs the kernels are instantiated for
_KERNEL_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                 (torch.bfloat16, torch.bfloat16)}

# K2's chunks: about _T_CHUNK_BYTES of blocks each (16 slots of 8x128 f32),
# longer when the operator has more than that many slots times
# _T_MAX_COL_CHUNKS, so that no column has more than _T_MAX_COL_CHUNKS
# partial rows for the combine pass to add
_T_CHUNK_BYTES = 65536
_T_MAX_COL_CHUNKS = 8192

# x (padded block columns × bn) above which BSROperator plans windows. The
# reference's VMEM bound, kept at its value so the same operators take the
# same paths in both packages.
BSR_PALLAS_MAX_X_ELEMS = 2_000_000
# Widest window, in block columns, the banded plan takes (the multi plan
# takes W·wb ≤ 2× this, read at call time). The port's own value, set by
# shared memory: K3/K5 stage a group's windows in one thread block's dynamic
# shared memory, at most 227 KB on Hopper; 2·192 block columns of bn = 128
# 4-byte values are 192 KiB.
BSR_PALLAS_MAX_WINDOW_BLOCKS = 192
# independently addressed windows per row group (multi plan, K5/K6)
BSR_PALLAS_MAX_WINDOWS = 4
# dynamic shared memory one Hopper thread block can take
WINDOW_SMEM_LIMIT = 232_448
# K3/K5 thread block: block rows of one group per thread block (a group of
# R block rows runs as ceil(R / this) thread blocks, each staging the windows)
_WIN_SLICE_ROWS = 256
# the reference's row-group tile target, for bsr_window_rows
_TILE_BYTES_TARGET = 4 * 1024 * 1024
_MAX_LANES = 8  # K5/K6 lanes the CUDA kernels take


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts()``: one per
    wrapper call that launched its kernel or recorded it into a CUDA graph
    being captured (a replay is not counted)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def kernel_dtypes(block_dtype, vec_dtype):
    """The (block, vector) dtypes a kernel would run with, or None when the
    kernels do not take this pair: blocks f32 or bf16, and a result dtype
    ``promote(block, vec)`` of f32 or bf16. The vector is cast to the result
    dtype by the wrapper (it is small; the blocks are never cast)."""
    res = torch.promote_types(block_dtype, vec_dtype)
    if (block_dtype, res) in _KERNEL_PAIRS:
        return block_dtype, res
    return None


def _acc_dtype(dtype):
    # f32 accumulation for f32/bf16 (as the TPU kernels); wider types keep theirs
    return torch.promote_types(dtype, torch.float32)


# ----------------------------------------------------------------------------
# Plain versions (also the operator's backend="torch" path)
# ----------------------------------------------------------------------------


def bsr_matvec_plain(blocks, block_cols, x_blocks):
    """y (nbrow, bm) = Σ_k blocks[r,k] @ x_blocks[block_cols[r,k]]: a gather
    plus one einsum, accumulated in at least f32, returned in
    ``promote(blocks, x)``."""
    check_f32_exact(blocks, x_blocks)
    res = torch.promote_types(blocks.dtype, x_blocks.dtype)
    acc = _acc_dtype(res)
    xg = x_blocks[block_cols.long()].to(acc)  # (nbrow, kmax, bn)
    return torch.einsum("rkmn,rkn->rm", blocks.to(acc), xg).to(res)


def bsr_matmat_plain(blocks, block_cols, X_blocks):
    """Multi-RHS: Y (nbrow, bm, k) = Σ_j blocks[r,j] @ X_blocks[block_cols[r,j]]."""
    check_f32_exact(blocks, X_blocks)
    res = torch.promote_types(blocks.dtype, X_blocks.dtype)
    acc = _acc_dtype(res)
    Xg = X_blocks[block_cols.long()].to(acc)  # (nbrow, kmax, bn, k)
    return torch.einsum("rkmn,rknc->rmc", blocks.to(acc), Xg).to(res)


def bsr_rmatvec_plain(blocks, block_cols, u_blocks, nbcol: int, plan=None):
    """out (nbcol, bn) = Σ_{(r,k): cols[r,k]=c} blocks[r,k]ᵀ @ u[r]: per-block
    contributions summed into their block column in a fixed order
    (``core/segsum.py``; ``plan`` is ``segment_plan(block_cols, nbcol)``,
    built here when not given), so a rerun gives the same bits."""
    check_f32_exact(blocks, u_blocks)
    res = torch.promote_types(blocks.dtype, u_blocks.dtype)
    acc = _acc_dtype(res)
    contrib = torch.einsum("rkmn,rm->rkn", blocks.to(acc), u_blocks.to(acc))
    bn = blocks.shape[3]
    if plan is None:
        plan = segment_plan(block_cols, nbcol)
    return segment_sum(contrib.reshape(-1, bn), plan).to(res)


def bsr_rmatmat_plain(blocks, block_cols, U, nbcol: int, plan=None):
    """K2's product over a panel: out (nbcol·bn, k) = Σ blocks[r,k]ᵀ @ U[r]
    for U (nbrow·bm, k), per-block contributions summed into their block
    column in ``bsr_rmatvec_plain``'s fixed order (a (bn, k) row per slot;
    ``plan`` as there)."""
    check_f32_exact(blocks, U)
    res = torch.promote_types(blocks.dtype, U.dtype)
    acc = _acc_dtype(res)
    nbrow, _, bm, bn = blocks.shape
    k = U.shape[1]
    contrib = torch.einsum("rkmn,rmj->rknj", blocks.to(acc), _panel_blocks(U, nbrow, bm).to(acc))
    if plan is None:
        plan = segment_plan(block_cols, nbcol)
    return segment_sum(contrib.flatten(0, 1), plan).to(res).reshape(nbcol * bn, k)


# ----------------------------------------------------------------------------
# K2's block-column index and chunk plan
# ----------------------------------------------------------------------------


def bsr_column_index(block_cols, nbcol: int):
    """(perm, colptr), both int32 on ``block_cols``' device: ``perm`` lists the
    flattened (r·kmax + k) block slots sorted stably by block column, and
    ``colptr[c]:colptr[c+1]`` is the range of column c in it."""
    flat = block_cols.reshape(-1).long()
    if flat.numel() >= 2**31:
        raise OverflowError("BSR with 2^31 or more block slots is not supported")
    perm = torch.argsort(flat, stable=True).to(torch.int32)
    counts = torch.bincount(flat, minlength=nbcol)
    colptr = torch.zeros(nbcol + 1, dtype=torch.int64, device=flat.device)
    colptr[1:] = torch.cumsum(counts, 0)
    return perm, colptr.to(torch.int32)


class BSRColumnPlan(NamedTuple):
    """K2's work plan, built once per operator (``bsr_column_plan``); every
    tensor int32 on the blocks' device.

    - ``perm``, ``colptr``: ``bsr_column_index``.
    - ``chunk_ptr`` (nchunks + 1): chunk i is ``perm[chunk_ptr[i]:chunk_ptr[i+1]]``,
      at most ``chunk_slots`` consecutive slots of one column (S in
      ``bsr_column_plan``); chunks follow the columns in order and cover
      ``perm`` once.
    - ``chunk_col`` (nchunks): the column of each chunk.
    - ``col_chunk`` (nbcol + 1): column c's chunks are ``col_chunk[c]:col_chunk[c+1]``.
    - ``combine_cols``: the columns with no chunk or several, which the
      combine pass writes (a column with one chunk is written by its chunk).
    """

    perm: torch.Tensor
    colptr: torch.Tensor
    chunk_ptr: torch.Tensor
    chunk_col: torch.Tensor
    col_chunk: torch.Tensor
    combine_cols: torch.Tensor
    chunk_slots: int


def bsr_column_plan(block_cols, nbcol: int, block_bytes: int = 4096) -> BSRColumnPlan:
    """K2's plan: each column's slots (in ``bsr_column_index`` order) cut into
    chunks of at most S slots, S holding 64 KiB of blocks of ``block_bytes``
    each (16 slots of 8x128 f32, 1 of 128x128 f32), raised to ⌈slots / 8192⌉
    on larger operators so that a column never has more than 8192 chunks: a
    chunk is one thread block's work, balanced however the slots fall into
    columns, and a column's chunks are added in chunk order by a second pass
    (``csrc/bsr_spmv.cu``)."""
    perm, colptr = bsr_column_index(block_cols, nbcol)
    return _chunked_plan(perm, colptr, nbcol, block_bytes)


def _chunked_plan(perm, colptr, nbcol: int, block_bytes: int) -> BSRColumnPlan:
    """A column plan from slots ``perm`` sorted by column (column c's are
    ``perm[colptr[c]:colptr[c+1]]``): the chunks as ``bsr_column_plan``
    cuts them."""
    nslots = perm.numel()
    S = max(_T_CHUNK_BYTES // max(int(block_bytes), 1), 1, -(-nslots // _T_MAX_COL_CHUNKS))
    dev = perm.device
    cp = colptr.long()
    nch = (cp[1:] - cp[:-1] + S - 1) // S  # chunks per column, 0 for an empty one
    col_chunk = torch.zeros(nbcol + 1, dtype=torch.int64, device=dev)
    col_chunk[1:] = torch.cumsum(nch, 0)
    chunk_col = torch.repeat_interleave(torch.arange(nbcol, device=dev), nch)
    rank = torch.arange(chunk_col.numel(), device=dev) - col_chunk[chunk_col]
    chunk_ptr = torch.full((chunk_col.numel() + 1,), nslots, dtype=torch.int64, device=dev)
    chunk_ptr[:-1] = cp[chunk_col] + rank * S
    combine_cols = torch.nonzero(nch != 1).reshape(-1)
    i32 = torch.int32
    return BSRColumnPlan(perm, colptr, chunk_ptr.to(i32), chunk_col.to(i32), col_chunk.to(i32),
                         combine_cols.to(i32), S)


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def _lib():
    from .build import load_library

    lib = load_library("bsr_spmv")
    if not getattr(lib, "_linops_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.linops_bsr_matvec.argtypes = [p, p, p, p, i64, i32, i32, i32, i32, i32, i32, p]
        lib.linops_bsr_matvec.restype = ctypes.c_int
        lib.linops_bsr_rmatvec.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i32, i32,
                                           i32, i32, i32, i32, p]
        lib.linops_bsr_rmatvec.restype = ctypes.c_int
        lib.linops_bsr_rmatmat.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i32, i32, i32,
                                           i32, i64, i64, i64, i64, i32, i32, i32, p]
        lib.linops_bsr_rmatmat.restype = ctypes.c_int
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def _device_stream(t):
    """(device index, current stream handle) of a CUDA tensor, for a launch."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.linops_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _check_blocks(blocks, block_cols, vec, what: str):
    """Validate the blocks, their columns and a vector's device and dtype;
    return the (block, vector) dtypes the kernel runs with."""
    if blocks.dim() != 4 or block_cols.dim() != 2 or tuple(block_cols.shape) != tuple(blocks.shape[:2]):
        raise ValueError(f"{what}: blocks must be (nbrow, kmax, bm, bn) and "
                         f"block_cols (nbrow, kmax); got {tuple(blocks.shape)}, "
                         f"{tuple(block_cols.shape)}")
    for t, name in ((block_cols, "block_cols"), (vec, "vector")):
        if t.device != blocks.device:
            raise ValueError(f"{what}: {name} is on {t.device}, blocks on {blocks.device}")
    if block_cols.dtype != torch.int32:
        raise TypeError(f"{what}: block_cols must be int32, got {block_cols.dtype}")
    pair = kernel_dtypes(blocks.dtype, vec.dtype)
    if pair is None:
        raise TypeError(f"{what}: the CUDA kernel takes f32/bf16 blocks with a "
                        f"f32/bf16 result; got blocks {blocks.dtype}, vector {vec.dtype}")
    if not blocks.is_contiguous() or not block_cols.is_contiguous():
        raise ValueError(f"{what}: blocks and block_cols must be contiguous")
    return pair


def _cuda_args(blocks, block_cols, vec, vec_rows: int, what: str, transpose: bool):
    """Validate CUDA inputs; return (vector in the kernel's dtype, dtypes)."""
    pair = _check_blocks(blocks, block_cols, vec, what)
    width = blocks.shape[2] if transpose else blocks.shape[3]
    if vec.dim() != 2 or vec.shape[0] != vec_rows or vec.shape[1] != width:
        raise ValueError(f"{what}: vector blocks must be ({vec_rows}, {width}), "
                         f"got {tuple(vec.shape)}")
    return vec.to(pair[1]).contiguous(), pair


def bsr_matvec_kernel(blocks, block_cols, x_blocks, *, fast: bool = False,
                      variant: str = "auto"):
    """K1: y (nbrow, bm) = BSR @ x_blocks (nbcol, bn), in
    ``promote(blocks, x)``. CPU tensors take ``bsr_matvec_plain``; CUDA
    tensors launch the kernel (f32/bf16 only) or raise. Every block column
    must be below ``x_blocks.shape[0]`` (``BSROperator`` checks this once at
    construction; the kernel does not). ``fast`` and ``variant`` are
    accepted and ignored (see module docstring)."""
    del fast, variant
    if blocks.device.type == "cpu":
        return bsr_matvec_plain(blocks, block_cols, x_blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"bsr_matvec: no kernel for device {blocks.device}")
    nbrow, kmax, bm, bn = blocks.shape
    x, (bdt, vdt) = _cuda_args(blocks, block_cols, x_blocks, x_blocks.shape[0], "bsr_matvec",
                              transpose=False)
    y = torch.empty((nbrow, bm), dtype=vdt, device=blocks.device)
    lib = _lib()
    rc = lib.linops_bsr_matvec(
        blocks.data_ptr(), block_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        nbrow, kmax, bm, bn, _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, "bsr_matvec")
    _LAUNCHES["bsr_matvec"] += 1
    return y


def bsr_rmatvec_kernel(blocks, block_cols, u_blocks, nbcol: int, *, plan=None):
    """K2: out (nbcol, bn) = Σ_{r,k} blocks[r,k]ᵀ · u[r] summed into block
    column ``block_cols[r,k]``, in ``promote(blocks, u)``. CPU tensors take
    ``bsr_rmatvec_plain``; CUDA tensors launch the deterministic kernel
    (f32/bf16 only) or raise. ``plan`` is the column plan from
    ``bsr_column_plan`` (built here when not given)."""
    if blocks.device.type == "cpu":
        return bsr_rmatvec_plain(blocks, block_cols, u_blocks, nbcol)
    if blocks.device.type != "cuda":
        raise ValueError(f"bsr_rmatvec: no kernel for device {blocks.device}")
    nbrow, kmax, bm, bn = blocks.shape
    u, (bdt, vdt) = _cuda_args(blocks, block_cols, u_blocks, nbrow, "bsr_rmatvec", transpose=True)
    if plan is None:
        plan = bsr_column_plan(block_cols, nbcol, bm * bn * blocks.element_size())
    tensors = _column_plan_tensors(plan, blocks, nbcol, plan.perm.numel() == nbrow * kmax,
                                   "bsr_rmatvec", "bsr_column_plan")
    nchunks = plan.chunk_col.numel()
    out = torch.empty((nbcol, bn), dtype=vdt, device=blocks.device)
    partial = torch.empty((nchunks, bn), dtype=torch.float32, device=blocks.device)
    lib = _lib()
    rc = lib.linops_bsr_rmatvec(
        blocks.data_ptr(), *(t.data_ptr() for t in tensors), u.data_ptr(), partial.data_ptr(),
        out.data_ptr(), nchunks, plan.combine_cols.numel(), kmax, bm, bn,
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, "bsr_rmatvec")
    _LAUNCHES["bsr_rmatvec"] += 1
    return out


def _panel_args(blocks, block_cols, U, what: str):
    """Validate a panel transpose's CUDA inputs; return (U in the kernel's
    dtype, dtypes). U is (nbrow·bm, k) with any strides (a cast copies it)."""
    pair = _check_blocks(blocks, block_cols, U, what)
    rows = blocks.shape[0] * blocks.shape[2]
    if U.dim() != 2 or U.shape[0] != rows:
        raise ValueError(f"{what}: the panel must be ({rows}, k), got {tuple(U.shape)}")
    return U.to(pair[1]), pair


def _panel_out(U, nrows: int, dtype):
    """The (nrows, k) output of a panel transpose, laid out as U: the
    transposed view of a row-major (k, nrows) where U is a row panel's view
    (``U.stride(0) == 1``), else row-major."""
    k = U.shape[1]
    if U.stride(0) == 1:
        return torch.empty((k, nrows), dtype=dtype, device=U.device).t()
    return torch.empty((nrows, k), dtype=dtype, device=U.device)


def _strides(U, out):
    return (*U.stride(), *out.stride())


def bsr_rmatmat_kernel(blocks, block_cols, U, nbcol: int, *, plan=None):
    """K2p: K2 over a panel, out (nbcol·bn, k) = Aᵀ U for U (nbrow·bm, k), in
    ``promote(blocks, U)``: one launch for every column, each stored block
    read once per 8 columns, column j bit for bit ``bsr_rmatvec_kernel`` of
    column j. U is read through its strides (a column panel, or a row
    panel's ``.t()``, without a copy; a dtype cast copies it), and the
    result is laid out as U: a row panel's view gives the transposed view
    of a row-major (k, nbcol·bn). CPU tensors take ``bsr_rmatmat_plain``
    (row-major); CUDA tensors
    launch the kernel (f32/bf16 only) or raise. ``plan``: K2's column plan
    (built here when not given)."""
    if blocks.device.type == "cpu":
        return bsr_rmatmat_plain(blocks, block_cols, U, nbcol)
    what = "bsr_rmatmat"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    U, (bdt, vdt) = _panel_args(blocks, block_cols, U, what)
    if plan is None:
        plan = bsr_column_plan(block_cols, nbcol, bm * bn * blocks.element_size())
    tensors = _column_plan_tensors(plan, blocks, nbcol, plan.perm.numel() == nbrow * kmax, what,
                                   "bsr_column_plan")
    k = U.shape[1]
    out = _panel_out(U, nbcol * bn, vdt)
    if k == 0:
        return out
    nchunks = plan.chunk_col.numel()
    partial = torch.empty((nchunks, k, bn), dtype=torch.float32, device=blocks.device)
    lib = _lib()
    rc = lib.linops_bsr_rmatmat(
        blocks.data_ptr(), *(t.data_ptr() for t in tensors), U.data_ptr(), partial.data_ptr(),
        out.data_ptr(), nchunks, plan.combine_cols.numel(), kmax, bm, bn, k, *_strides(U, out),
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out


def _column_plan_tensors(plan, blocks, nbcol: int, slots_ok: bool, what: str, maker: str):
    """A column plan's tensors (perm, chunk_ptr, chunk_col, col_chunk,
    combine_cols), checked against the blocks; ``slots_ok``: its slot count
    fits them."""
    tensors = (plan.perm, plan.chunk_ptr, plan.chunk_col, plan.col_chunk, plan.combine_cols)
    nchunks = plan.chunk_col.numel()
    if (not slots_ok or any(t.dtype != torch.int32 or t.device != blocks.device for t in tensors)
            or plan.col_chunk.numel() != nbcol + 1 or plan.chunk_ptr.numel() != nchunks + 1):
        raise ValueError(f"{what}: the plan does not index these blocks (see {maker})")
    return tensors


# ----------------------------------------------------------------------------
# Window plans (host numpy; copies of the reference's planners)
# ----------------------------------------------------------------------------


def bsr_row_pad(bm: int, kmax: int = 8, bn: int = 128, itemsize: int = 4) -> int:
    """The multiple BSROperator pads nbrow to before it plans windows: the
    reference's ``bsr_pallas_rows_per_program`` (a tile near 4 MB, snapped to
    its 128-lane rule), kept so that both packages pad, and so plan, the same
    operator alike. It has no meaning for the H100 kernels themselves."""
    per_row = max(kmax * bm * bn * itemsize, 1)
    r = _TILE_BYTES_TARGET // per_row
    m = 128 // math.gcd(int(kmax), 128)
    m = (8 * m) // math.gcd(8, m)
    r = int(max(8, min(128, (r // 8) * 8)))
    return int(max(m, (r // m) * m))


def bsr_window_rows(bm: int, kmax: int, bn: int, itemsize: int, nbrow: int) -> int:
    """Row group R of a window plan: the block rows that share one set of x
    windows. The reference's rule (``bsr_windowed_rows_per_program``: double
    ``bsr_row_pad`` while the group's blocks stay within 4 MB and divide
    nbrow), so the port plans exactly what the reference plans.

    Why it fits a Hopper thread block: R sets only how many block rows share
    the windows, and through the plan the window width, which the planners
    bound by ``BSR_PALLAS_MAX_WINDOW_BLOCKS`` so the windows fit shared
    memory. The kernels run a group as slices of ``_WIN_SLICE_ROWS`` block
    rows, one thread block each, so a thread block's working set (its staged
    windows, one accumulator per warp) does not grow with R."""
    r = bsr_row_pad(bm, kmax, bn, itemsize)
    while (r * 2) * kmax * bm * bn * itemsize <= _TILE_BYTES_TARGET and nbrow % (r * 2) == 0:
        r *= 2
    return r


def _nonzero_slots(blocks, chunk: int = 1 << 16) -> np.ndarray:
    """(nbrow, kmax) bool on the host: which block slots hold a nonzero
    value. One pass over the blocks on their own device, block rows in
    chunks (no full-size temporary)."""
    if isinstance(blocks, np.ndarray):
        return (blocks != 0).reshape(blocks.shape[0], blocks.shape[1], -1).any(-1)
    parts = [(blocks[i:i + chunk] != 0).flatten(2).any(2).cpu()
             for i in range(0, blocks.shape[0], chunk)]
    return torch.cat(parts).numpy() if parts else np.zeros(blocks.shape[:2], bool)


def _validated_real_slots(cols, blocks):
    """Real-slot mask shared by the planners (reference
    ``_validated_real_slots``): slot 0 is real, a later slot is real unless
    it points at block column 0, the packer's pad. A real block at column 0
    in a later slot would look like a pad, so where such slots exist the
    block values decide (pads are all zero): None unless every nonzero slot
    is marked real. ``blocks`` is a tensor (any device), an array, or None."""
    kmax = cols.shape[1]
    real = np.ones_like(cols, dtype=bool)
    real[:, 1:] = cols[:, 1:] != 0
    if kmax > 1 and (~real).any():
        if blocks is None:
            return None
        if (_nonzero_slots(blocks) & ~real).any():
            return None  # a "pad" slot holds a real block
    return real


def bsr_window_plan(block_cols, R: int, nbcol: int,
                    wb_max: int = BSR_PALLAS_MAX_WINDOW_BLOCKS, blocks=None):
    """Banded plan: every group of R block rows reads x through two adjacent
    (wb, bn) windows at ``q[g]·wb``. Returns (win_q int32 (ngroups,),
    cols_local int32 (nbrow, kmax) in [0, 2 wb), wb, x_pad_blocks), or None
    when a group's real columns span more than ``wb_max``, real columns are
    unsorted within a row, or nbrow is not a multiple of R. q never
    decreases (empty groups inherit their predecessor's window)."""
    cols = np.asarray(block_cols)
    nbrow, kmax = cols.shape
    if nbrow % R:
        return None
    ngroups = nbrow // R
    real = _validated_real_slots(cols, blocks)
    if real is None:
        return None
    if kmax > 1:
        d_ok = (cols[:, 1:] >= cols[:, :-1]) | ~real[:, 1:]
        if not bool(d_ok.all()):
            return None
    cg = cols.reshape(ngroups, -1)
    rg = real.reshape(ngroups, -1)
    mn = np.where(rg, cg, np.iinfo(np.int32).max).min(axis=1)
    mx = np.where(rg, cg, -1).max(axis=1)
    empty = mx < 0
    mn[empty] = 0
    mx[empty] = 0
    span = int((mx - mn).max(initial=0)) + 1
    wb = max(-(-span // 8) * 8, 8)
    if wb > wb_max:
        return None
    q = (mn // wb).astype(np.int64)
    q = np.maximum.accumulate(np.where(empty, 0, q) + np.where(empty, -(1 << 30), 0))
    q = np.maximum(q, 0)
    cols_local = np.where(real, cols - q.repeat(R)[:, None] * wb, 0)
    if cols_local.min(initial=0) < 0 or cols_local.max(initial=0) >= 2 * wb:
        return None
    x_pad_blocks = int(max((q.max(initial=0) + 2) * wb, -(-nbcol // wb) * wb))
    return q.astype(np.int32), cols_local.astype(np.int32), int(wb), x_pad_blocks


def bsr_window_plan_multi(block_cols, R: int, nbcol: int,
                          wb_max: int = BSR_PALLAS_MAX_WINDOW_BLOCKS, blocks=None,
                          max_windows: int = BSR_PALLAS_MAX_WINDOWS):
    """Multi-window plan: up to ``max_windows`` independently addressed
    (wb, bn) x windows per group of R block rows (a band plus a few far
    column clusters). Picks the power-of-two wb ≤ ``wb_max`` minimising W·wb
    with W·wb ≤ 2·``BSR_PALLAS_MAX_WINDOW_BLOCKS``; spare lanes point at a
    dump window past every column. Returns (win_q int32 (W, ngroups), wb,
    x_pad_blocks) or None."""
    cols = np.asarray(block_cols)
    nbrow, kmax = cols.shape
    if nbrow % R:
        return None
    ngroups = nbrow // R
    real = _validated_real_slots(cols, blocks)
    if real is None:
        return None
    base = np.sort(np.where(real, cols, -1).reshape(ngroups, -1).astype(np.int64), axis=1)
    best = None
    wb = 8
    while wb <= wb_max:
        ws = base // wb
        distinct = ((ws[:, 1:] != ws[:, :-1]) & (ws[:, 1:] >= 0)).sum(axis=1)
        distinct += ws[:, 0] >= 0
        W = int(distinct.max(initial=1))
        if 1 <= W <= max_windows and W * wb <= 2 * BSR_PALLAS_MAX_WINDOW_BLOCKS:
            cost = W * wb
            if best is None or cost < best[0]:
                best = (cost, wb, W)
        wb *= 2
    if best is None:
        return None
    _, wb, W = best
    W = max(W, 1)
    ws = base // wb
    pad_win = max(int(ws.max(initial=-1)), (nbcol - 1) // wb) + 1
    win_q = np.full((W, ngroups), pad_win, np.int64)
    is_new = np.ones_like(ws, bool)
    is_new[:, 1:] = ws[:, 1:] != ws[:, :-1]
    is_new &= ws >= 0
    pos = np.cumsum(is_new, axis=1) - 1
    gi, si = np.nonzero(is_new)
    win_q[pos[gi, si], gi] = ws[gi, si]
    x_pad_blocks = (pad_win + 1) * wb
    return win_q.astype(np.int32), int(wb), int(x_pad_blocks)


def bsr_window_plan_multi_t(block_cols, R: int, nbcol: int, wb: int, W: int, blocks=None):
    """Transpose plan over the multi plan's wb: each group's distinct real
    windows go to W lanes whose windows never decrease over groups (greedy:
    each window, ascending, to the eligible lane with the largest current
    window). Unused lanes repeat their window with valid 0. Slot-0 blocks at
    column 0 count as real only when nonzero (pad rows would otherwise pin
    window 0 to the last group). Returns (q_t int32 (W, ngroups), valid
    int32 (W, ngroups), x_pad_blocks) or None."""
    cols = np.asarray(block_cols)
    nbrow, kmax = cols.shape
    if nbrow % R:
        return None
    ngroups = nbrow // R
    real = _validated_real_slots(cols, blocks)
    if real is None:
        return None
    real = real.copy()
    if (cols[:, 0] == 0).any() and blocks is not None:
        real[:, 0] = (cols[:, 0] != 0) | _nonzero_slots(blocks[:, :1])[:, 0]
    ws_sorted = np.sort(np.where(real, cols // wb, -1).reshape(ngroups, R * kmax), axis=1)
    last = np.full(W, -1, np.int64)
    q_t = np.zeros((W, ngroups), np.int64)
    valid = np.zeros((W, ngroups), bool)
    for g in range(ngroups):
        row = ws_sorted[g]
        wins = np.unique(row[row >= 0])
        if wins.size > W:
            return None
        used = []
        for v in wins:
            cand = [w for w in range(W) if w not in used and last[w] <= v]
            if not cand:
                return None
            w = max(cand, key=lambda i: last[i])
            q_t[w, g] = v
            valid[w, g] = True
            last[w] = v
            used.append(w)
        for w in range(W):
            if w not in used:
                q_t[w, g] = max(last[w], 0)
                last[w] = q_t[w, g]
    x_pad_blocks = int(max(int(q_t.max(initial=0)) + 1, -(-nbcol // wb)) * wb)
    return q_t.astype(np.int32), valid.astype(np.int32), x_pad_blocks


# ----------------------------------------------------------------------------
# Plain versions of K3-K6: what the TPU kernels compute, from the same plans
# ----------------------------------------------------------------------------


def _row_groups(nbrow: int, ngroups: int, device):
    """Group of every block row: R = nbrow // ngroups consecutive rows each."""
    if ngroups <= 0 or nbrow % ngroups:
        raise ValueError(f"a window plan of {ngroups} groups does not divide nbrow={nbrow}")
    return torch.arange(nbrow, device=device) // (nbrow // ngroups)


def _pad_rows(t, rows: int):
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0])) if t.shape[0] < rows else t


def _windowed_cols(cols_local, win_q, wb: int):
    """(global block columns, inside): a slot reads block column
    q[g]·wb + cols_local; a local column outside [0, 2 wb) is in neither
    window and adds nothing (its global column is set to 0)."""
    g = _row_groups(cols_local.shape[0], win_q.shape[0], cols_local.device)
    cl = cols_local.long()
    inside = (cl >= 0) & (cl < 2 * wb)
    gcols = win_q.long()[g][:, None] * wb + cl
    return torch.where(inside, gcols, 0), inside


def _lane_weights(block_cols, win_q, wb: int, valid=None):
    """Per slot, how many lanes' windows hold its block column (for K6 only
    lanes whose step is valid): 1 for a real slot of a planned operator."""
    g = _row_groups(block_cols.shape[0], win_q.shape[1], block_cols.device)
    hit = (block_cols.long() // wb)[None] == win_q.long()[:, g][:, :, None]  # (W, nbrow, kmax)
    if valid is not None:
        hit &= (valid[:, g] != 0)[:, :, None]
    return hit.sum(0)


def bsr_matvec_windowed_plain(blocks, cols_local, win_q, x_blocks, *, wb: int,
                              x_pad_blocks: int, fast: bool = False, t_out: bool = False):
    """K3's product: y[r] = Σ_k blocks[r,k] @ x[q[g]·wb + cols_local[r,k]],
    x zero-padded to ``x_pad_blocks`` block rows; R = nbrow // len(win_q)."""
    del fast, t_out
    gcols, inside = _windowed_cols(cols_local, win_q, wb)
    check_f32_exact(blocks, x_blocks)
    res = torch.promote_types(blocks.dtype, x_blocks.dtype)
    acc = _acc_dtype(res)
    xg = _pad_rows(x_blocks, x_pad_blocks)[gcols].to(acc)
    xg = torch.where(inside[..., None], xg, torch.zeros((), dtype=acc, device=xg.device))
    return torch.einsum("rkmn,rkn->rm", blocks.to(acc), xg).to(res)


def bsr_matvec_multiwin_plain(blocks, block_cols, win_q, x_blocks, *, wb: int,
                              x_pad_blocks: int, fast: bool = False, t_out: bool = False):
    """K5's product: K1's sum, each slot counted once for every window
    [q[w,g]·wb, (q[w,g]+1)·wb) that holds its block column (once for a real
    slot; never for a dump window)."""
    del fast, t_out
    check_f32_exact(blocks, x_blocks)
    res = torch.promote_types(blocks.dtype, x_blocks.dtype)
    acc = _acc_dtype(res)
    weight = _lane_weights(block_cols, win_q, wb).to(acc)
    xg = _pad_rows(x_blocks, x_pad_blocks)[block_cols.long()].to(acc) * weight[..., None]
    return torch.einsum("rkmn,rkn->rm", blocks.to(acc), xg).to(res)


def _scatter(blocks, u_blocks, targets, weight, rows: int, sum_plan=None):
    """Σ over slots of weight·blocks[r,k]ᵀ u[r] into row ``targets[r,k]`` of
    a (rows, bn) result; for u (nbrow, bm, k), a panel, of a (rows, bn, k)
    one. Each slot's contribution is formed in at least f32;
    the sum into the rows is taken in f64, in slot order, and rounded once.
    (A column that gathers 2^19 slots, as the far cluster of the band +
    cluster benchmark does, would carry about 2e-5 of max|y| in f32
    rounding, twenty times the kernels' own.) ``sum_plan`` is
    ``segment_plan(targets, rows)``, built here when not given."""
    check_f32_exact(blocks, u_blocks)
    res = torch.promote_types(blocks.dtype, u_blocks.dtype)
    acc = _acc_dtype(res)
    eq = "rkmn,rm->rkn" if u_blocks.dim() == 2 else "rkmn,rmj->rknj"
    contrib = torch.einsum(eq, blocks.to(acc), u_blocks.to(acc))
    w = weight.reshape(weight.shape + (1,) * (contrib.dim() - 2))
    contrib = torch.where(w != 0, contrib * w.to(acc),
                          torch.zeros((), dtype=acc, device=contrib.device))
    wide = torch.promote_types(acc, torch.float64)
    if sum_plan is None:
        sum_plan = segment_plan(targets, rows)
    out = segment_sum(contrib.flatten(0, 1).to(wide), sum_plan)
    return out.to(res)


def bsr_rmatvec_windowed_plan(cols_local, win_q, *, wb: int, x_pad_blocks: int):
    """The plain K4's summation order (slots by their global block column),
    for ``bsr_rmatvec_windowed_plain(..., sum_plan=)``; an operator builds
    it once."""
    gcols, _ = _windowed_cols(cols_local, win_q, wb)
    return segment_plan(gcols, x_pad_blocks)


def bsr_rmatvec_windowed_plain(blocks, cols_local, win_q, u_blocks, *, wb: int,
                               x_pad_blocks: int, nbcol: int, t_in: bool = False,
                               sum_plan=None):
    """K4's product: out[q[g]·wb + cols_local[r,k]] += blocks[r,k]ᵀ u[r] over
    an (x_pad_blocks, bn) output, cut to nbcol block rows. Every target lies
    in a window the plan visits, so unvisited windows stay exactly zero.
    ``sum_plan``: ``bsr_rmatvec_windowed_plan``'s, built here when not given."""
    del t_in
    gcols, inside = _windowed_cols(cols_local, win_q, wb)
    return _scatter(blocks, u_blocks, gcols, inside.to(torch.int32), x_pad_blocks,
                    sum_plan)[:nbcol]


def bsr_rmatvec_multiwin_plain(blocks, block_cols, win_q_t, win_valid_t, u_blocks, *, wb: int,
                               x_pad_blocks: int, nbcol: int, t_in: bool = False,
                               sum_plan=None):
    """K6's product: the transpose scatter, each slot added once for every
    valid lane step whose window holds its block column (a repeated lane
    step, valid 0, adds nothing). ``sum_plan``: ``segment_plan(block_cols,
    max(x_pad_blocks, nbcol))``, built here when not given."""
    del t_in
    weight = _lane_weights(block_cols, win_q_t, wb, valid=win_valid_t)
    rows = max(x_pad_blocks, nbcol)
    return _scatter(blocks, u_blocks, block_cols, weight, rows, sum_plan)[:nbcol]


def _panel_blocks(U, nbrow: int, bm: int):
    return U.reshape(nbrow, bm, U.shape[1])


def bsr_rmatmat_windowed_plain(blocks, cols_local, win_q, U, *, wb: int, x_pad_blocks: int,
                               nbcol: int, sum_plan=None):
    """K4's product over a panel: U (nbrow·bm, k) in, (nbcol·bn, k) out, the
    per-slot contributions (bn, k) summed in ``bsr_rmatvec_windowed_plain``'s
    order (``sum_plan``: ``bsr_rmatvec_windowed_plan``'s)."""
    nbrow, _, bm, bn = blocks.shape
    gcols, inside = _windowed_cols(cols_local, win_q, wb)
    out = _scatter(blocks, _panel_blocks(U, nbrow, bm), gcols, inside.to(torch.int32),
                   x_pad_blocks, sum_plan)
    return out[:nbcol].reshape(nbcol * bn, U.shape[1])


def bsr_rmatmat_multiwin_plain(blocks, block_cols, win_q_t, win_valid_t, U, *, wb: int,
                               x_pad_blocks: int, nbcol: int, sum_plan=None):
    """K6's product over a panel: U (nbrow·bm, k) in, (nbcol·bn, k) out, in
    ``bsr_rmatvec_multiwin_plain``'s weights and order."""
    nbrow, _, bm, bn = blocks.shape
    weight = _lane_weights(block_cols, win_q_t, wb, valid=win_valid_t)
    out = _scatter(blocks, _panel_blocks(U, nbrow, bm), block_cols, weight,
                   max(x_pad_blocks, nbcol), sum_plan)
    return out[:nbcol].reshape(nbcol * bn, U.shape[1])


# ----------------------------------------------------------------------------
# K5's lane rows, K4's slot index and K6's column plan (built once per
# operator, on the plan's device)
# ----------------------------------------------------------------------------


def bsr_multiwin_index(block_cols, win_q, wb: int):
    """K5's lane rows, int32 (nbrow, kmax): for a slot whose block column c
    lies in lane w's window, the row w·wb + c % wb of the group's staged
    windows; -1 for a slot in no window (it adds nothing). One host sync.
    Raises when a slot lies in two lanes' windows: a multi plan never
    repeats a real window (its spare lanes point past every column)."""
    g = _row_groups(block_cols.shape[0], win_q.shape[1], block_cols.device)
    c = block_cols.long()
    hit = (c // wb)[None] == win_q.long()[:, g][:, :, None]  # (W, nbrow, kmax)
    if bool((hit.sum(0) > 1).any()):
        raise ValueError("bsr_multiwin_index: a block column lies in two windows of one group")
    lane = torch.arange(win_q.shape[0], device=c.device)[:, None, None]
    rows = (hit * (lane * wb + 1 + c % wb)).sum(0) - 1  # -1 where no lane holds c
    return rows.to(torch.int32)


def _partial_index(keys, slots, nrows: int):
    """(perm, ptr) int32: ``slots`` stably sorted by ``keys`` (so in
    increasing slot order within a key) and the offsets of each key."""
    if slots.numel() >= 2**31:
        raise OverflowError("BSR with 2^31 or more block slots is not supported")
    perm = slots[torch.argsort(keys, stable=True)].to(torch.int32)
    ptr = torch.zeros(nrows + 1, dtype=torch.int64, device=keys.device)
    ptr[1:] = torch.cumsum(torch.bincount(keys, minlength=nrows), 0)
    return perm, ptr.to(torch.int32)


def _require_monotone(q, what: str) -> None:
    if q.shape[-1] > 1 and bool((q[..., 1:] < q[..., :-1]).any()):
        raise ValueError(f"{what}: the windows must never decrease over groups")


def bsr_window_t_index(cols_local, win_q, wb: int):
    """K4's index: (perm, ptr) listing, for partial row g·2wb + l, the slots
    of group g with local column l, in slot order. One host sync (checks
    that q never decreases, which K4's combine relies on)."""
    _require_monotone(win_q, "bsr_window_t_index")
    nbrow, kmax = cols_local.shape
    L = 2 * wb
    g = _row_groups(nbrow, win_q.shape[0], cols_local.device).repeat_interleave(kmax)
    cl = cols_local.reshape(-1).long()
    slots = torch.nonzero((cl >= 0) & (cl < L)).squeeze(1)
    return _partial_index(g[slots] * L + cl[slots], slots, win_q.shape[0] * L)


def bsr_multiwin_t_plan(block_cols, win_q_t, win_valid_t, wb: int, nbcol: int,
                        block_bytes: int = 4096) -> BSRColumnPlan:
    """K6's column plan: every slot whose block column c < nbcol lies in the
    window of a valid lane step of its group (listed once per such lane
    step, as the plain K6 weighs it; once for a planned operator), sorted by
    column and within a column by slot, then cut into chunks as
    ``bsr_column_plan`` cuts K2's. Columns no window visits have no chunk.
    Checks that every lane's windows never decrease (the reference's
    transpose plan walks its output lanes in order). A few host syncs."""
    _require_monotone(win_q_t, "bsr_multiwin_t_plan")
    W, ngroups = win_q_t.shape
    nbrow, kmax = block_cols.shape
    g = _row_groups(nbrow, ngroups, block_cols.device).repeat_interleave(kmax)
    c = block_cols.reshape(-1).long()
    win = c // wb
    covered = [(win_valid_t[w].long()[g] != 0) & (win == win_q_t[w].long()[g]) & (c < nbcol)
               for w in range(W)]
    slots = torch.cat([torch.nonzero(hit).squeeze(1) for hit in covered])
    if slots.numel() >= 2**31:
        raise OverflowError("BSR with 2^31 or more block slots is not supported")
    slots = torch.sort(slots, stable=True).values
    perm = slots[torch.argsort(c[slots], stable=True)]
    colptr = torch.zeros(nbcol + 1, dtype=torch.int64, device=c.device)
    colptr[1:] = torch.cumsum(torch.bincount(c[perm], minlength=nbcol), 0)
    return _chunked_plan(perm.to(torch.int32), colptr.to(torch.int32), nbcol, block_bytes)


# ----------------------------------------------------------------------------
# K3-K6 wrappers
# ----------------------------------------------------------------------------


def _win_lib():
    from .build import load_library

    lib = load_library("bsr_window")
    if not getattr(lib, "_linops_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.linops_bsr_matvec_windowed.argtypes = [p, p, p, p, p, i64, i64, i32, i32, i32,
                                                   i32, i32, i32, i32, i32, i32, p]
        lib.linops_bsr_matvec_multiwin.argtypes = [p, p, p, p, p, i64, i64, i32, i32, i32,
                                                   i32, i32, i32, i32, i32, i32, i32, p]
        lib.linops_bsr_rmatvec_windowed.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, i32,
                                                    i32, i32, i32, i32, i32, p]
        lib.linops_bsr_rmatvec_multiwin.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i32,
                                                    i32, i32, i32, i32, i32, p]
        lib.linops_bsr_rmatmat_windowed.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, i32,
                                                    i32, i32, i32, i64, i64, i64, i64, i32,
                                                    i32, i32, p]
        lib.linops_bsr_rmatmat_multiwin.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i32,
                                                    i32, i32, i32, i64, i64, i64, i64, i32,
                                                    i32, i32, p]
        for f in (lib.linops_bsr_matvec_windowed, lib.linops_bsr_matvec_multiwin,
                  lib.linops_bsr_rmatvec_windowed, lib.linops_bsr_rmatvec_multiwin,
                  lib.linops_bsr_rmatmat_windowed, lib.linops_bsr_rmatmat_multiwin):
            f.restype = ctypes.c_int
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def _check_plan_tensor(t, blocks, ndim: int, name: str, what: str) -> None:
    if t.dim() != ndim or t.dtype != torch.int32 or t.device != blocks.device or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {ndim}-d int32 tensor on "
                         f"{blocks.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_windows(what: str, blocks, win_q, wb: int, lanes: int, itemsize: int) -> int:
    """Validate a plan's q against the blocks; return ngroups. ``itemsize``
    is the staged x's (K3/K5: ``lanes`` windows of wb·bn values must fit
    shared memory); 0 for the transposes, which stage nothing."""
    ngroups = win_q.shape[-1]
    if ngroups <= 0 or blocks.shape[0] % ngroups:
        raise ValueError(f"{what}: {ngroups} window groups do not divide nbrow={blocks.shape[0]}")
    if wb <= 0 or not 1 <= lanes <= _MAX_LANES:
        raise ValueError(f"{what}: needs wb > 0 and 1 to {_MAX_LANES} windows; got wb={wb}, "
                         f"{lanes} windows")
    smem = lanes * wb * blocks.shape[3] * itemsize
    if smem > WINDOW_SMEM_LIMIT:
        raise ValueError(f"{what}: {lanes} windows of {wb}x{blocks.shape[3]} values need "
                         f"{smem} bytes of shared memory; a thread block has {WINDOW_SMEM_LIMIT}")
    return ngroups


def _on_cuda(blocks, what: str) -> None:
    if blocks.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {blocks.device}")


def bsr_matvec_windowed_kernel(blocks, cols_local, win_q, x_blocks, *, wb: int,
                               x_pad_blocks: int, fast: bool = False, t_out: bool = False):
    """K3: y (nbrow, bm) = BSR @ x with x read through each row group's two
    adjacent windows (plan: ``bsr_window_plan``). CPU tensors take
    ``bsr_matvec_windowed_plain``; CUDA tensors launch the kernel (f32/bf16)
    or raise. The kernel stages window rows past x as zeros, so x is not
    padded to ``x_pad_blocks`` (accepted for call-site parity)."""
    if blocks.device.type == "cpu":
        return bsr_matvec_windowed_plain(blocks, cols_local, win_q, x_blocks, wb=wb,
                                         x_pad_blocks=x_pad_blocks)
    what = "bsr_matvec_windowed"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    x, (bdt, vdt) = _cuda_args(blocks, cols_local, x_blocks, x_blocks.shape[0], what,
                               transpose=False)
    _check_plan_tensor(win_q, blocks, 1, "win_q", what)
    ngroups = _check_windows(what, blocks, win_q, wb, 2, vdt.itemsize)
    y = torch.empty((nbrow, bm), dtype=vdt, device=blocks.device)
    lib = _win_lib()
    rc = lib.linops_bsr_matvec_windowed(
        blocks.data_ptr(), cols_local.data_ptr(), win_q.data_ptr(), x.data_ptr(), y.data_ptr(),
        x.shape[0], nbrow, ngroups, _WIN_SLICE_ROWS, kmax, bm, bn, wb,
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return y


def bsr_matvec_multiwin_kernel(blocks, block_cols, win_q, x_blocks, *, wb: int,
                               x_pad_blocks: int, fast: bool = False, t_out: bool = False,
                               index=None):
    """K5: y (nbrow, bm) = BSR @ x with x read through W independently
    addressed windows per row group (plan: ``bsr_window_plan_multi``). CPU
    tensors take ``bsr_matvec_multiwin_plain``; CUDA tensors launch the
    kernel (f32/bf16) or raise. x is not padded (see K3). ``index`` is
    ``bsr_multiwin_index(block_cols, win_q, wb)`` (built here when not
    given)."""
    if blocks.device.type == "cpu":
        return bsr_matvec_multiwin_plain(blocks, block_cols, win_q, x_blocks, wb=wb,
                                         x_pad_blocks=x_pad_blocks)
    what = "bsr_matvec_multiwin"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    x, (bdt, vdt) = _cuda_args(blocks, block_cols, x_blocks, x_blocks.shape[0], what,
                               transpose=False)
    _check_plan_tensor(win_q, blocks, 2, "win_q", what)
    W = win_q.shape[0]
    ngroups = _check_windows(what, blocks, win_q, wb, W, vdt.itemsize)
    if index is None:
        index = bsr_multiwin_index(block_cols, win_q, wb)
    if index.dtype != torch.int32 or index.shape != block_cols.shape or index.device != blocks.device:
        raise ValueError(f"{what}: index does not fit these blocks (see bsr_multiwin_index)")
    y = torch.empty((nbrow, bm), dtype=vdt, device=blocks.device)
    lib = _win_lib()
    rc = lib.linops_bsr_matvec_multiwin(
        blocks.data_ptr(), index.data_ptr(), win_q.data_ptr(), x.data_ptr(), y.data_ptr(),
        x.shape[0], nbrow, ngroups, W, _WIN_SLICE_ROWS, kmax, bm, bn, wb,
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return y


def _check_index(index, nrows: int, blocks, what: str):
    perm, ptr = index
    if (perm.dtype != torch.int32 or ptr.dtype != torch.int32 or ptr.numel() != nrows + 1
            or perm.device != blocks.device or ptr.device != blocks.device):
        raise ValueError(f"{what}: index does not fit this plan (see bsr_window_t_index)")
    return perm, ptr


def bsr_rmatvec_windowed_kernel(blocks, cols_local, win_q, u_blocks, *, wb: int,
                                x_pad_blocks: int, nbcol: int, t_in: bool = False, index=None):
    """K4: out (nbcol, bn) = the transpose scatter into each row group's two
    windows (plan: ``bsr_window_plan``); deterministic. CPU tensors take
    ``bsr_rmatvec_windowed_plain``; CUDA tensors launch the kernel
    (f32/bf16) or raise. ``index`` is ``bsr_window_t_index(cols_local,
    win_q, wb)`` (built here when not given; q must never decrease)."""
    if blocks.device.type == "cpu":
        return bsr_rmatvec_windowed_plain(blocks, cols_local, win_q, u_blocks, wb=wb,
                                          x_pad_blocks=x_pad_blocks, nbcol=nbcol)
    what = "bsr_rmatvec_windowed"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    u, (bdt, vdt) = _cuda_args(blocks, cols_local, u_blocks, nbrow, what, transpose=True)
    _check_plan_tensor(win_q, blocks, 1, "win_q", what)
    ngroups = _check_windows(what, blocks, win_q, wb, 2, 0)
    if index is None:
        index = bsr_window_t_index(cols_local, win_q, wb)
    perm, ptr = _check_index(index, ngroups * 2 * wb, blocks, what)
    partial = torch.empty((ngroups * 2 * wb, bn), dtype=torch.float32, device=blocks.device)
    out = torch.empty((nbcol, bn), dtype=vdt, device=blocks.device)
    lib = _win_lib()
    rc = lib.linops_bsr_rmatvec_windowed(
        blocks.data_ptr(), perm.data_ptr(), ptr.data_ptr(), u.data_ptr(), win_q.data_ptr(),
        partial.data_ptr(), out.data_ptr(), nbcol, ngroups, kmax, bm, bn, wb,
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out


def bsr_rmatvec_multiwin_kernel(blocks, block_cols, win_q_t, win_valid_t, u_blocks, *, wb: int,
                                x_pad_blocks: int, nbcol: int, t_in: bool = False, index=None):
    """K6: out (nbcol, bn) = the transpose scatter into W monotone output
    lanes (plan: ``bsr_window_plan_multi_t``); deterministic. CPU tensors
    take ``bsr_rmatvec_multiwin_plain``; CUDA tensors launch the kernel
    (f32/bf16) or raise. ``index`` is ``bsr_multiwin_t_plan(block_cols,
    win_q_t, win_valid_t, wb, nbcol, bm·bn·itemsize)``, K2's column plan over
    the slots the windows cover (built here when not given)."""
    if blocks.device.type == "cpu":
        return bsr_rmatvec_multiwin_plain(blocks, block_cols, win_q_t, win_valid_t, u_blocks,
                                          wb=wb, x_pad_blocks=x_pad_blocks, nbcol=nbcol)
    what = "bsr_rmatvec_multiwin"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    u, (bdt, vdt) = _cuda_args(blocks, block_cols, u_blocks, nbrow, what, transpose=True)
    W = _window_t_checks(what, blocks, win_q_t, win_valid_t, wb)
    plan = index
    if plan is None:
        plan = bsr_multiwin_t_plan(block_cols, win_q_t, win_valid_t, wb, nbcol,
                                   bm * bn * blocks.element_size())
    tensors = _column_plan_tensors(plan, blocks, nbcol, plan.perm.numel() <= W * nbrow * kmax,
                                   what, "bsr_multiwin_t_plan")
    nchunks = plan.chunk_col.numel()
    out = torch.empty((nbcol, bn), dtype=vdt, device=blocks.device)
    partial = torch.empty((nchunks, bn), dtype=torch.float32, device=blocks.device)
    lib = _win_lib()
    rc = lib.linops_bsr_rmatvec_multiwin(
        blocks.data_ptr(), *(t.data_ptr() for t in tensors), u.data_ptr(), partial.data_ptr(),
        out.data_ptr(), nchunks, plan.combine_cols.numel(), kmax, bm, bn,
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out


def _window_t_checks(what, blocks, win_q_t, win_valid_t, wb: int):
    """Validate a multi-window transpose plan; return its lane count W."""
    _check_plan_tensor(win_q_t, blocks, 2, "win_q_t", what)
    _check_plan_tensor(win_valid_t, blocks, 2, "win_valid_t", what)
    if win_valid_t.shape != win_q_t.shape:
        raise ValueError(f"{what}: win_valid_t {tuple(win_valid_t.shape)} does not match "
                         f"win_q_t {tuple(win_q_t.shape)}")
    _check_windows(what, blocks, win_q_t, wb, win_q_t.shape[0], 0)
    return win_q_t.shape[0]


def bsr_rmatmat_windowed_kernel(blocks, cols_local, win_q, U, *, wb: int, x_pad_blocks: int,
                                nbcol: int, index=None):
    """K4p: K4 over a panel, out (nbcol·bn, k) for U (nbrow·bm, k), one
    launch for every column, each stored block read once per 8 columns,
    column j bit for bit ``bsr_rmatvec_windowed_kernel`` of column j. U,
    its layout and the dispatch as ``bsr_rmatmat_kernel``'s; ``index`` as
    K4's (``bsr_window_t_index``, built here when not given)."""
    if blocks.device.type == "cpu":
        return bsr_rmatmat_windowed_plain(blocks, cols_local, win_q, U, wb=wb,
                                          x_pad_blocks=x_pad_blocks, nbcol=nbcol)
    what = "bsr_rmatmat_windowed"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    U, (bdt, vdt) = _panel_args(blocks, cols_local, U, what)
    _check_plan_tensor(win_q, blocks, 1, "win_q", what)
    ngroups = _check_windows(what, blocks, win_q, wb, 2, 0)
    if index is None:
        index = bsr_window_t_index(cols_local, win_q, wb)
    perm, ptr = _check_index(index, ngroups * 2 * wb, blocks, what)
    k = U.shape[1]
    out = _panel_out(U, nbcol * bn, vdt)
    if k == 0:
        return out
    partial = torch.empty((ngroups * 2 * wb, k, bn), dtype=torch.float32, device=blocks.device)
    lib = _win_lib()
    rc = lib.linops_bsr_rmatmat_windowed(
        blocks.data_ptr(), perm.data_ptr(), ptr.data_ptr(), U.data_ptr(), win_q.data_ptr(),
        partial.data_ptr(), out.data_ptr(), nbcol, ngroups, kmax, bm, bn, wb, k,
        *_strides(U, out), _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out


def bsr_rmatmat_multiwin_kernel(blocks, block_cols, win_q_t, win_valid_t, U, *, wb: int,
                                x_pad_blocks: int, nbcol: int, index=None):
    """K6p: K6 over a panel, out (nbcol·bn, k) for U (nbrow·bm, k), one
    launch for every column, each stored block read once per 8 columns,
    column j bit for bit ``bsr_rmatvec_multiwin_kernel`` of column j. U,
    its layout and the dispatch as ``bsr_rmatmat_kernel``'s; ``index`` as
    K6's (``bsr_multiwin_t_plan``, built here when not given)."""
    if blocks.device.type == "cpu":
        return bsr_rmatmat_multiwin_plain(blocks, block_cols, win_q_t, win_valid_t, U, wb=wb,
                                          x_pad_blocks=x_pad_blocks, nbcol=nbcol)
    what = "bsr_rmatmat_multiwin"
    _on_cuda(blocks, what)
    nbrow, kmax, bm, bn = blocks.shape
    U, (bdt, vdt) = _panel_args(blocks, block_cols, U, what)
    W = _window_t_checks(what, blocks, win_q_t, win_valid_t, wb)
    plan = index
    if plan is None:
        plan = bsr_multiwin_t_plan(block_cols, win_q_t, win_valid_t, wb, nbcol,
                                   bm * bn * blocks.element_size())
    tensors = _column_plan_tensors(plan, blocks, nbcol, plan.perm.numel() <= W * nbrow * kmax,
                                   what, "bsr_multiwin_t_plan")
    k = U.shape[1]
    out = _panel_out(U, nbcol * bn, vdt)
    if k == 0:
        return out
    nchunks = plan.chunk_col.numel()
    partial = torch.empty((nchunks, k, bn), dtype=torch.float32, device=blocks.device)
    lib = _win_lib()
    rc = lib.linops_bsr_rmatmat_multiwin(
        blocks.data_ptr(), *(t.data_ptr() for t in tensors), U.data_ptr(), partial.data_ptr(),
        out.data_ptr(), nchunks, plan.combine_cols.numel(), kmax, bm, bn, k, *_strides(U, out),
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt], *_device_stream(blocks))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out
