"""The host BSR packer, built from the JAX package's C++ source.

``linops_tpu/native/bsr_pack.cpp`` turns CSR arrays into the BSR layout
without a dense intermediate. This module reads that source (it neither
copies nor edits it), builds it with ``g++`` at first use into
``linops_tpu_torch/_native_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the source and flags, and loads it with ctypes. It does
not import the JAX package.

``available()`` is False when the library cannot be built (no ``g++``); the
pack functions then raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["bsr_pack_csr", "bsr_count", "available", "pack_calls"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "linops_tpu", "native", "bsr_pack.cpp")
_BUILD = os.path.join(_ROOT, "linops_tpu_torch", "_native_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_error = None
pack_calls = 0  # bsr_pack_csr calls in this process (chip_smoke reads it)


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
            so = os.path.join(_BUILD, f"libbsrpack_{h}.so")
            if not os.path.exists(so):
                os.makedirs(_BUILD, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                               capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            _error = e
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.bsr_count.restype = ctypes.c_int32
        lib.bsr_count.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p]
        for name, vp in (("bsr_fill_f32", f32p), ("bsr_fill_f64", f64p)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [vp, i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_int32, vp, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native BSR packer unavailable (g++ build of {_SRC} failed: {_error})")
    return lib


_I32_MAX = np.iinfo(np.int32).max


def _int32(a, what: str) -> np.ndarray:
    """The packer's ABI is int32: wider indices would be read out of bounds."""
    a = np.asarray(a)
    if a.size and int(a.max()) > _I32_MAX:
        raise OverflowError(f"{what} exceed int32 range (max {int(a.max())}); the native "
                            "packer supports nnz/dims up to 2^31-1")
    return np.ascontiguousarray(a, np.int32)


def bsr_count(cols, indptr, nrow: int, block_shape) -> tuple:
    """(kmax, counts): distinct block columns per block row, and their max."""
    lib = _lib_or_raise()
    bm, bn = block_shape
    cols, indptr = _int32(cols, "column indices"), _int32(indptr, "indptr")
    counts = np.zeros(-(-nrow // bm), np.int32)
    kmax = int(lib.bsr_count(cols, indptr, nrow, bm, bn, counts))
    return kmax, counts


def bsr_pack_csr(vals, cols, indptr, nrow, ncol, block_shape=(8, 128), pad_rows_to=1):
    """CSR → (blocks, block_cols) numpy arrays, as the reference's
    ``bsr_pack_csr``: block columns sorted within a block row, pads at block
    column 0 with zero values, duplicates summed, nbrow rounded up to a
    multiple of ``pad_rows_to``. Values f32 or f64."""
    global pack_calls
    lib = _lib_or_raise()
    bm, bn = block_shape
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.float32, np.float64):
        raise TypeError(f"native packer supports f32/f64, got {vals.dtype}")
    cols, indptr = _int32(cols, "column indices"), _int32(indptr, "indptr")
    nbrow = -(-nrow // bm)
    nbrow_padded = -(-nbrow // pad_rows_to) * pad_rows_to
    counts = np.zeros(nbrow, np.int32)
    kmax = max(int(lib.bsr_count(cols, indptr, nrow, bm, bn, counts)), 1)
    blocks = np.zeros((nbrow_padded, kmax, bm, bn), dtype=vals.dtype)
    block_cols = np.zeros((nbrow_padded, kmax), np.int32)
    fill = lib.bsr_fill_f32 if vals.dtype == np.float32 else lib.bsr_fill_f64
    fill(vals, cols, indptr, nrow, bm, bn, kmax, blocks[:nbrow].reshape(-1),
         block_cols[:nbrow].reshape(-1))
    pack_calls += 1
    return blocks, block_cols
