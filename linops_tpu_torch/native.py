"""Host C++ helpers: the BSR packer, the RCM ordering and the Clos router.

``native_src/bsr_pack.cpp`` (CSR → BSR without a dense intermediate, and
``rcm_order``) and ``native_src/clos_route.cpp`` (the radix-128 Clos router)
are this package's own copies of the reference's native sources, kept
byte-identical to them so both packages pack and route alike (a test checks
this). Each is built with ``g++`` at first use into
``linops_tpu_torch/_native_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the source and flags, and loaded with ctypes.

``available()`` is False when the packer cannot be built (no ``g++``); the
pack functions then raise. ``clos_route_native`` returns None when the router
cannot be built, as the reference's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["bsr_pack_csr", "bsr_count", "rcm_permutation", "clos_route_native",
           "available", "pack_calls"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "native_src")
_BUILD = os.path.join(_HERE, "_native_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
RADIX = 128

_lock = threading.Lock()
_libs: dict = {}    # stem -> loaded library
_errors: dict = {}  # stem -> the build or load error
pack_calls = 0  # bsr_pack_csr calls in this process (chip_smoke reads it)


def _build_and_load(src_name: str, stem: str):
    """The library built from ``native_src/<src_name>``, or None (the error
    kept in ``_errors``) when it cannot be built or loaded."""
    with _lock:
        if stem in _libs or stem in _errors:
            return _libs.get(stem)
        src = os.path.join(_SRC_DIR, src_name)
        try:
            with open(src, "rb") as f:
                h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
            so = os.path.join(_BUILD, f"lib{stem}_{h}.so")
            if not os.path.exists(so):
                os.makedirs(_BUILD, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True,
                               capture_output=True)
                os.replace(tmp, so)
            _libs[stem] = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            _errors[stem] = e
            return None
        return _libs[stem]


def _load():
    lib = _build_and_load("bsr_pack.cpp", "bsrpack")
    if lib is None or getattr(lib, "_linops_typed", False):
        return lib
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
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
    lib._linops_typed = True
    return lib


def _load_clos():
    lib = _build_and_load("clos_route.cpp", "closroute")
    if lib is None or getattr(lib, "_linops_typed", False):
        return lib
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.clos_route_c.restype = ctypes.c_int64
    lib.clos_route_c.argtypes = [i64p, ctypes.c_int64] + [i32p] * 5
    lib._linops_typed = True
    return lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native packer unavailable (g++ build of "
                           f"native_src/bsr_pack.cpp failed: {_errors.get('bsrpack')})")
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


def rcm_permutation(cols, indptr, n) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized CSR pattern, as the
    reference's: ``A_reordered = A[perm][:, perm]`` has a small bandwidth
    when the pattern is bandable. Returns int32 ``perm``."""
    lib = _lib_or_raise()
    cols, indptr = _int32(cols, "column indices"), _int32(indptr, "indptr")
    perm = np.zeros(n, np.int32)
    lib.rcm_order(cols, indptr, n, perm)
    return perm


def clos_route_native(dest):
    """Native radix-128 Clos routing with the stage-array contract of
    ``sparse/routing.py::clos_route`` (and the same arrays: the same Euler-walk
    order), int32. Returns None when the router cannot be built."""
    lib = _load_clos()
    if lib is None:
        return None
    dest = np.ascontiguousarray(dest, np.int64)
    n = dest.shape[0]
    if n % RADIX:
        raise ValueError(f"clos size must be a multiple of {RADIX}, got {n}")
    m = n // RADIX
    g1 = np.zeros((m, RADIX), np.int32)
    g5 = np.zeros((m, RADIX), np.int32)
    if m <= RADIX:
        g3 = np.zeros((RADIX, m), np.int32)
        g2 = g4 = np.zeros(1, np.int32)
    else:
        b = m // RADIX
        g2 = np.zeros((RADIX * b, RADIX), np.int32)
        g3 = np.zeros((RADIX * RADIX, b), np.int32)
        g4 = np.zeros((RADIX * b, RADIX), np.int32)
    stages = int(lib.clos_route_c(dest, n, g1.reshape(-1), g2.reshape(-1), g3.reshape(-1),
                                  g4.reshape(-1), g5.reshape(-1)))
    if stages < 0:
        raise ValueError(f"unsupported clos size {n}")
    if stages == 1:
        return [g1[:1]]
    if stages == 3:
        return [g1, g3, g5]
    return [g1, g2, g3, g4, g5]
