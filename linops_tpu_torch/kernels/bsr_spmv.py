"""BSR SpMV kernels K1 (forward) and K2 (transpose) and their plain versions.

Counterparts of ``linops_tpu/kernels/bsr_spmv.py``:

- ``bsr_matvec_kernel`` replaces ``bsr_matvec_pallas`` (K1);
- ``bsr_rmatvec_kernel`` replaces ``bsr_rmatvec_pallas`` (K2).

The kernels are hand-written CUDA C++ for ``sm_90a`` in ``csrc/bsr_spmv.cu``
(design notes there), built with ``nvcc`` at first use (``build.py``). Each
wrapper dispatches on the device of the tensors it is given: CPU tensors take
the plain PyTorch version beside it; CUDA tensors launch the kernel or raise.
There is no fallback from a CUDA tensor to the plain version.

What the TPU kernels needed and these do not: the one-hot selector matmuls
and the bf16 hi/mid/lo split of x (an exact gather replaces them), the
lane-major cols and the ``t_out``/``t_in`` layouts, and the nbrow padding to a
rows-per-program multiple. Data the reference padded is still accepted.
``fast``/``variant`` are accepted for call-site parity and ignored: the
gather is exact.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.precision import check_f32_exact

__all__ = [
    "bsr_matvec_kernel",
    "bsr_rmatvec_kernel",
    "bsr_matvec_plain",
    "bsr_rmatvec_plain",
    "bsr_matmat_plain",
    "bsr_column_index",
    "launch_counts",
    "reset_launch_counts",
    "kernel_dtypes",
]

# kernel name -> launches since the last reset; bumped only where a kernel
# is launched (never by the plain versions)
_LAUNCHES = {"bsr_matvec": 0, "bsr_rmatvec": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (block dtype, vector/output dtype) pairs the kernels are instantiated for
_KERNEL_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                 (torch.bfloat16, torch.bfloat16)}

# K2 thread block: up to 128 lanes over n, _T_SPLIT rows of threads over m
_T_TILE_MAX = 128
_T_SPLIT = 4


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts()``."""
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


def bsr_rmatvec_plain(blocks, block_cols, u_blocks, nbcol: int):
    """out (nbcol, bn) = Σ_{(r,k): cols[r,k]=c} blocks[r,k]ᵀ @ u[r]: per-block
    contributions summed into their block column by index."""
    check_f32_exact(blocks, u_blocks)
    res = torch.promote_types(blocks.dtype, u_blocks.dtype)
    acc = _acc_dtype(res)
    contrib = torch.einsum("rkmn,rm->rkn", blocks.to(acc), u_blocks.to(acc))
    bn = blocks.shape[3]
    out = torch.zeros((nbcol, bn), dtype=acc, device=blocks.device)
    out.index_add_(0, block_cols.reshape(-1).long(), contrib.reshape(-1, bn))
    return out.to(res)


# ----------------------------------------------------------------------------
# K2's block-column index
# ----------------------------------------------------------------------------


def bsr_column_index(block_cols, nbcol: int):
    """(perm, colptr), both int32 on ``block_cols``' device: ``perm`` lists the
    flattened (r·kmax + k) block slots sorted stably by block column, and
    ``colptr[c]:colptr[c+1]`` is the range of column c in it. Built once per
    operator; K2 walks each column's slots in this fixed order."""
    flat = block_cols.reshape(-1).long()
    if flat.numel() >= 2**31:
        raise OverflowError("BSR with 2^31 or more block slots is not supported")
    perm = torch.argsort(flat, stable=True).to(torch.int32)
    counts = torch.bincount(flat, minlength=nbcol)
    colptr = torch.zeros(nbcol + 1, dtype=torch.int64, device=flat.device)
    colptr[1:] = torch.cumsum(counts, 0)
    return perm, colptr.to(torch.int32)


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
        lib.linops_bsr_rmatvec.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i32, i32,
                                           i32, i32, i32, p]
        lib.linops_bsr_rmatvec.restype = ctypes.c_int
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.linops_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _cuda_args(blocks, block_cols, vec, vec_rows: int, what: str):
    """Validate CUDA inputs; return (vector in the kernel's dtype, dtypes)."""
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
    width = blocks.shape[3] if what == "bsr_matvec" else blocks.shape[2]
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
    x, (bdt, vdt) = _cuda_args(blocks, block_cols, x_blocks, x_blocks.shape[0], "bsr_matvec")
    y = torch.empty((nbrow, bm), dtype=vdt, device=blocks.device)
    lib = _lib()
    rc = lib.linops_bsr_matvec(
        blocks.data_ptr(), block_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        nbrow, kmax, bm, bn, _DTYPE_CODE[bdt], _DTYPE_CODE[vdt],
        blocks.device.index if blocks.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(blocks.device).cuda_stream)
    _check_launch(lib, rc, "bsr_matvec")
    _LAUNCHES["bsr_matvec"] += 1
    return y


def bsr_rmatvec_kernel(blocks, block_cols, u_blocks, nbcol: int, *, perm=None,
                       colptr=None):
    """K2: out (nbcol, bn) = Σ_{r,k} blocks[r,k]ᵀ · u[r] summed into block
    column ``block_cols[r,k]``, in ``promote(blocks, u)``. CPU tensors take
    ``bsr_rmatvec_plain``; CUDA tensors launch the deterministic kernel
    (f32/bf16 only) or raise. ``perm``/``colptr`` are the column index from
    ``bsr_column_index`` (built here when not given)."""
    if blocks.device.type == "cpu":
        return bsr_rmatvec_plain(blocks, block_cols, u_blocks, nbcol)
    if blocks.device.type != "cuda":
        raise ValueError(f"bsr_rmatvec: no kernel for device {blocks.device}")
    nbrow, kmax, bm, bn = blocks.shape
    u, (bdt, vdt) = _cuda_args(blocks, block_cols, u_blocks, nbrow, "bsr_rmatvec")
    if perm is None or colptr is None:
        perm, colptr = bsr_column_index(block_cols, nbcol)
    if (perm.dtype != torch.int32 or colptr.dtype != torch.int32
            or perm.numel() != nbrow * kmax or colptr.numel() != nbcol + 1
            or perm.device != blocks.device or colptr.device != blocks.device):
        raise ValueError("bsr_rmatvec: perm/colptr do not index these blocks "
                         "(see bsr_column_index)")
    out = torch.empty((nbcol, bn), dtype=vdt, device=blocks.device)
    tile = min(_T_TILE_MAX, -(-bn // 32) * 32)
    lib = _lib()
    rc = lib.linops_bsr_rmatvec(
        blocks.data_ptr(), perm.data_ptr(), colptr.data_ptr(), u.data_ptr(),
        out.data_ptr(), nbcol, kmax, bm, bn, tile, _T_SPLIT,
        _DTYPE_CODE[bdt], _DTYPE_CODE[vdt],
        blocks.device.index if blocks.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(blocks.device).cuda_stream)
    _check_launch(lib, rc, "bsr_rmatvec")
    _LAUNCHES["bsr_rmatvec"] += 1
    return out
