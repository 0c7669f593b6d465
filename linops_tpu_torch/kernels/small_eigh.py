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

The kernels are hand-written CUDA C++ for ``sm_90a`` in ``csrc/small_eigh.cu``
(design notes there), built with ``nvcc`` at first use (``build.py``): up to
m = 24 parallel cyclic Jacobi on scalar rotations (``small_eigh_kernel``, one
thread block per matrix); above it block Jacobi, a warp per pair of 8-wide
blocks with each pair's rotation applied as a dense product (the rotations in
f64 for f32 input), on a thread-block cluster of up to 8 CTAs per matrix
(``cluster_eigh_kernel``) where its buffers fit in shared memory, else on one
thread block (``blocked_eigh_kernel``). The C entry picks the kernel by m and
dtype (``linops_small_eigh_plan``); the private ``_kernel=`` names one, for
the card tests and ``chip_smoke.py``, which check and time each. The wrapper
dispatches on the tensor's device: a CPU tensor takes ``small_eigh_plain``
(``torch.linalg.eigh``); a CUDA tensor launches a kernel or raises. There is
no fallback from a CUDA tensor to the plain version. The kernel writes
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
_LAUNCHES = {"small_eigh": 0, "small_eigh_blocked": 0, "small_eigh_cluster": 0}
loop.register_launches(_LAUNCHES)
# kernel name -> the device function each launch runs once
LAUNCH_SYMBOLS = {"small_eigh": "small_eigh_kernel", "small_eigh_blocked": "blocked_eigh_kernel",
                  "small_eigh_cluster": "cluster_eigh_kernel"}
# _kernel= name, by the C entry's kernel code, and the launch count each bumps
_KERNELS = ("jacobi", "blocked", "cluster")
_NAMES = ("small_eigh", "small_eigh_blocked", "small_eigh_cluster")

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
        lib.linops_small_eigh.argtypes = [p, p, p, p, p, i32, i64, i32, i32, p, i32]
        lib.linops_small_eigh.restype = ctypes.c_int
        lib.linops_small_eigh_plan.argtypes = [i32, i32, i32, ctypes.POINTER(i64)]
        lib.linops_small_eigh_plan.restype = ctypes.c_int
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
    def forward(ctx, A, kernel):
        w, V, _ = _launch(A, False, kernel)
        ctx.save_for_backward(w, V)
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        return eigh_vjp(w, V, gw, gV), None


def _plan(m: int, dtype, kernel=None):
    """(kernel code, workspace bytes per matrix) the C entry takes for
    ``kernel`` (None: its choice by m and dtype)."""
    per = ctypes.c_int64()
    code = _lib().linops_small_eigh_plan(int(m), _DTYPE_CODE[dtype],
                                         -1 if kernel is None else _KERNELS.index(kernel),
                                         ctypes.byref(per))
    if code < 0:
        raise ValueError(f"small_eigh: the {kernel} kernel cannot take m = {m} in {dtype}")
    return code, per.value


def kernel_for(m: int, dtype=torch.float32) -> str:
    """The kernel the C entry takes at size m: "jacobi" (m ≤ 24), "cluster"
    (where its buffers fit in shared memory) or "blocked"."""
    return _KERNELS[_plan(m, dtype)[0]]


def small_eigh(A, *, sweeps: bool = False, _kernel: str | None = None):
    """E1: ``(w, V)`` of the Hermitian matrices ``A`` (..., m, m), w
    ascending, V's columns orthonormal eigenvectors; ``sweeps=True`` also
    returns the Jacobi sweeps each matrix ran (an int32 tensor of the batch
    shape; on the CPU and under autograd, ``None``). CPU tensors take
    ``small_eigh_plain``. A matrix with a NaN or infinite entry gets NaN
    eigenvalues and vectors. ``_kernel`` ("jacobi", "blocked" or "cluster")
    overrides the C entry's choice, for measurements."""
    if _kernel is not None and _kernel not in _KERNELS:
        raise ValueError(f"small_eigh: kernel {_kernel!r} is not one of {_KERNELS}")
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
        out = _SmallEigh.apply(A, _kernel)
        return (*out, None) if sweeps else out
    w, V, nsweeps = _launch(A, sweeps, _kernel)
    return (w, V, nsweeps) if sweeps else (w, V)


def _launch(A, sweeps: bool, kernel):
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
        which, per = _plan(m, A.dtype, kernel)
        work = torch.empty(B * per, dtype=torch.uint8, device=A.device) if per else None
        rc = lib.linops_small_eigh(A3.data_ptr(), w.data_ptr(), V.data_ptr(),
                                   None if work is None else work.data_ptr(),
                                   None if nsweeps is None else nsweeps.data_ptr(),
                                   m, B, _DTYPE_CODE[A.dtype], *_device_stream(A3), which)
        _check_launch(lib, rc, _NAMES[which])
        _LAUNCHES[_NAMES[which]] += 1
    return (w.reshape(batch_shape + (m,)), V.reshape(batch_shape + (m, m)),
            None if nsweeps is None else nsweeps.reshape(batch_shape))
