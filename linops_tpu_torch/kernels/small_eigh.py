"""E1: a batched small Hermitian eigensolver for Hopper, and its plain
version.

``small_eigh(A)`` computes what ``torch.linalg.eigh(A)`` computes (the lower
triangle read; eigenvalues ascending, orthonormal eigenvector columns) for a
batch of Hermitian (..., m, m) matrices in f32, f64, c64 or c128. It is not
the counterpart of a Pallas site: it replaces the ``jnp.linalg.eigh`` that
XLA lowers inside the reference's LOBPCG loop (``linops_tpu/utils/eig.py``:
the SVQB transforms at m = k, the Rayleigh–Ritz step at m = 3k). On a CUDA
tensor ``torch.linalg.eigh`` reads cuSOLVER's ``info`` back to the host, so
a CUDA graph cannot hold it; the kernel reads nothing back, allocates
nothing and calls no library, so ``utils/eig.py`` can run LOBPCG's
iterations in captured blocks (``utils/loop.py``).

The kernel is hand-written CUDA C++ for ``sm_90a`` in ``csrc/small_eigh.cu``
(parallel cyclic Jacobi, one thread block per matrix; design notes there),
built with ``nvcc`` at first use (``build.py``). The wrapper dispatches on
the tensor's device: a CPU tensor takes ``small_eigh_plain``
(``torch.linalg.eigh``); a CUDA tensor launches the kernel or raises. There
is no fallback from a CUDA tensor to the plain version. The kernel writes
through ctypes, outside autograd; where ``A`` needs a gradient the launch
runs inside ``_SmallEigh``, whose backward is eigh's (``eigh_vjp``), so a
card solve differentiates as a CPU one does.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import loop
from .bsr_spmv import _check_launch, _device_stream

__all__ = ["small_eigh", "small_eigh_plain", "launch_counts", "reset_launch_counts"]

# kernel name -> launches since the last reset (bumped only where the kernel
# is launched, one recorded into a CUDA graph being captured included)
_LAUNCHES = {"small_eigh": 0}
loop.register_launches(_LAUNCHES)
# kernel name -> the device function each launch runs once
LAUNCH_SYMBOLS = {"small_eigh": "small_eigh_kernel"}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts()``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def small_eigh_plain(A):
    """The plain version: ``torch.linalg.eigh(A)``, (eigenvalues ascending,
    eigenvector columns)."""
    return torch.linalg.eigh(A)


def _lib():
    from .build import load_library

    lib = load_library("small_eigh")
    if not getattr(lib, "_linops_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.linops_small_eigh.argtypes = [p, p, p, p, p, i32, i64, i32, i32, p]
        lib.linops_small_eigh.restype = ctypes.c_int
        lib.linops_small_eigh_workspace.argtypes = [i32, i32]
        lib.linops_small_eigh_workspace.restype = ctypes.c_int64
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def eigh_vjp(w, V, gw, gV):
    """The gradient of A from those of ``(w, V) = eigh(A)``, as
    ``torch.linalg.eigh``'s backward: V (diag(gw) + skew(Vᴴ gV) / (w_j − w_i)) Vᴴ."""
    VhgV = V.mH @ gV
    VhgV = 0.5 * (VhgV - VhgV.mH)
    E = w.unsqueeze(-2) - w.unsqueeze(-1)
    E.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    inner = VhgV / E.to(V.dtype)
    inner.diagonal(dim1=-2, dim2=-1).copy_(gw)
    return V @ inner @ V.mH


class _SmallEigh(torch.autograd.Function):
    """E1's launch as an autograd node (forward: the kernel; backward:
    ``eigh_vjp``, plain tensor operations)."""

    @staticmethod
    def forward(ctx, A):
        w, V, _ = _launch(A, False)
        ctx.save_for_backward(w, V)
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        return eigh_vjp(w, V, gw, gV)


def small_eigh(A, *, sweeps: bool = False):
    """E1: ``(w, V)`` of the Hermitian matrices ``A`` (..., m, m), w
    ascending, V's columns orthonormal eigenvectors; ``sweeps=True`` also
    returns the Jacobi sweeps each matrix ran (an int32 tensor of the batch
    shape; on the CPU and under autograd, ``None``). CPU tensors take
    ``small_eigh_plain``.
    A matrix with a NaN or infinite entry gets NaN eigenvalues and vectors."""
    if A.device.type == "cpu":
        out = small_eigh_plain(A)
        return (*out, None) if sweeps else out
    if not A.is_cuda:
        raise ValueError(f"small_eigh: tensors on {A.device} are not supported (cpu or cuda)")
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"small_eigh: dtype {A.dtype} is not supported (f32, f64, c64, c128)")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"small_eigh: expected (..., m, m) matrices, got {tuple(A.shape)}")
    if torch.is_grad_enabled() and A.requires_grad:
        out = _SmallEigh.apply(A)
        return (*out, None) if sweeps else out
    w, V, nsweeps = _launch(A, sweeps)
    return (w, V, nsweeps) if sweeps else (w, V)


def _launch(A, sweeps: bool):
    """One launch of E1 on the CUDA matrices A: (w, V, sweeps or None)."""
    m = A.shape[-1]
    batch_shape = tuple(A.shape[:-2])
    A3 = A.reshape(-1, m, m).contiguous()
    B = A3.shape[0]
    rdt = A.real.dtype if A.is_complex() else A.dtype
    w = torch.empty((B, m), dtype=rdt, device=A.device)
    V = torch.empty((B, m, m), dtype=A.dtype, device=A.device)
    nsweeps = torch.empty(B, dtype=torch.int32, device=A.device) if sweeps else None
    if B and m:
        lib = _lib()
        code = _DTYPE_CODE[A.dtype]
        per = lib.linops_small_eigh_workspace(m, code)
        work = torch.empty(B * per, dtype=torch.uint8, device=A.device) if per else None
        rc = lib.linops_small_eigh(A3.data_ptr(), w.data_ptr(), V.data_ptr(),
                                   None if work is None else work.data_ptr(),
                                   None if nsweeps is None else nsweeps.data_ptr(),
                                   m, B, code, *_device_stream(A3))
        _check_launch(lib, rc, "small_eigh")
        _LAUNCHES["small_eigh"] += 1
    return (w.reshape(batch_shape + (m,)), V.reshape(batch_shape + (m, m)),
            None if nsweeps is None else nsweeps.reshape(batch_shape))
