"""E2: a batched small least-squares solver for Hopper, and its plain
version.

``small_lstsq(a, b)`` computes what ``jnp.linalg.lstsq(a, b)[0]`` computes at
its default cutoff for a batch of (..., r, c) matrices and (..., r)
right-hand sides in f32, f64, c64 or c128: the minimum-norm y = V Σ⁺ Uᴴ b,
every singular value σ < eps·max(r, c)·σ_max (eps of the input's precision)
or σ = 0 dropped. It is not the counterpart of a Pallas site: it replaces the
``jnp.linalg.lstsq`` that XLA lowers inside the reference's GMRES restart
(``linops_tpu/utils/krylov.py:185``, the (m + 1) x m Hessenberg problem). On
a CUDA tensor ``torch.linalg.svd`` reads cuSOLVER's ``info`` back to the
host, so a CUDA graph cannot hold it; the kernel reads nothing back,
allocates nothing and calls no library, so ``utils/krylov.py::gmres`` runs
its restarts in captured blocks (``utils/loop.py``), nested ones as CUDA
while nodes.

The kernel is hand-written CUDA C++ for ``sm_90a`` in ``csrc/small_lstsq.cu``
(design notes there), built with ``nvcc`` at first use (``build.py``): a QR
of [H | b] by Givens rotations of rows, then one-sided Jacobi on the
triangular factor, in f64 (c128 for complex input): on its rows with b's
entries rotated along and no V for f32 and c64 input, on its columns with V
for f64 and c128 input (whose accuracy needs V). One thread block per
matrix, its buffers in shared memory where they fit, else in a global
workspace the wrapper allocates (the same code). The columns of H past a
lucky breakdown stay exactly zero under row rotations, so those entries of y
come out exactly 0, as the SVD cutoff gives them. The wrapper dispatches on
the tensor's device: a CPU tensor takes ``small_lstsq_plain`` (the SVD); a
CUDA tensor launches the kernel or raises. There is no fallback from a CUDA
tensor to the plain version. Under ``torch.func.vmap`` the batch is one
launch (``_SmallLstsq.vmap``). On the card there is no gradient: the
reference's GMRES ``lax.while_loop`` cannot be reverse-differentiated either.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import loop
from .bsr_spmv import _check_launch, _device_stream

__all__ = ["small_lstsq", "small_lstsq_plain", "launch_counts", "reset_launch_counts"]

# kernel name -> launches since the last reset (bumped only where the kernel
# is launched, one recorded into a CUDA graph being captured included)
_LAUNCHES = {"small_lstsq": 0}
loop.register_launches(_LAUNCHES)
# kernel name -> the device function each launch runs once
LAUNCH_SYMBOLS = {"small_lstsq": "small_lstsq_kernel"}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts()``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def small_lstsq_plain(a, b, *, full: bool = False):
    """The plain version: min ‖a y − b‖ through ``torch.linalg.svd``,
    singular values below eps·max(r, c)·σ_max and zeros dropped
    (``jnp.linalg.lstsq``'s default). ``full=True`` returns (y, σ
    descending, None)."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(s.dtype).eps * max(a.shape[-2:]) * s[..., :1]
    keep = (s > 0) & (s >= cut)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s)).to(a.dtype)
    uhb = (u.mH @ b.to(a.dtype).unsqueeze(-1)).squeeze(-1)
    y = (vh.mH @ (s_inv * uhb).unsqueeze(-1)).squeeze(-1)
    return (y, s, None) if full else y


def _lib():
    from .build import load_library

    lib = load_library("small_lstsq")
    if not getattr(lib, "_linops_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.linops_small_lstsq.argtypes = [p, p, p, p, p, p, i32, i32, i64, i32, i32, p]
        lib.linops_small_lstsq.restype = ctypes.c_int
        lib.linops_small_lstsq_work.argtypes = [i32, i32, i32, ctypes.POINTER(i64)]
        lib.linops_small_lstsq_work.restype = ctypes.c_int
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def workspace_bytes(r: int, c: int, dtype=torch.float32) -> int:
    """Global workspace per matrix the kernel takes at r x c (0: its buffer
    fits in shared memory)."""
    per = ctypes.c_int64()
    if _lib().linops_small_lstsq_work(int(r), int(c), _DTYPE_CODE[dtype], ctypes.byref(per)):
        raise ValueError(f"small_lstsq: cannot take a {r} x {c} matrix in {dtype}")
    return per.value


class _SmallLstsq(torch.autograd.Function):
    """E2's launch as a Function, so ``torch.func.vmap`` over it launches
    once for the whole batch (``vmap``: the batch dimension moved to the
    front). No backward: see the module docstring."""

    @staticmethod
    def forward(a, b):
        return _launch(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("small_lstsq: E2 has no gradient (the reference's GMRES loop, "
                           "a lax.while_loop, cannot be reverse-differentiated either)")

    @staticmethod
    def vmap(info, in_dims, a, b):
        def front(t, d):
            return t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)

        return _SmallLstsq.apply(front(a, in_dims[0]), front(b, in_dims[1])), (0, 0, 0)


def small_lstsq(a, b, *, full: bool = False):
    """E2: the minimum-norm least-squares solution y of a y ≈ b for
    matrices ``a`` (..., r, c) and right-hand sides ``b`` (..., r), with
    ``jnp.linalg.lstsq``'s default cutoff. ``full=True`` returns (y, the
    singular values descending (..., min(r, c)), the Jacobi sweeps each matrix ran as
    an int32 tensor of the batch shape, or None on the CPU). CPU tensors take
    ``small_lstsq_plain``. A non-finite entry gives NaN out."""
    if a.device.type == "cpu":
        return small_lstsq_plain(a, b, full=full)
    if not a.is_cuda:
        raise ValueError(f"small_lstsq: tensors on {a.device} are not supported (cpu or cuda)")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"small_lstsq: dtype {a.dtype} is not supported (f32, f64, c64, c128)")
    if a.dim() < 2 or tuple(b.shape) != tuple(a.shape[:-1]):
        raise ValueError(f"small_lstsq: expected (..., r, c) matrices and (..., r) right-hand "
                         f"sides, got {tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"small_lstsq: b is on {b.device}, a on {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError("small_lstsq: E2 has no gradient (the reference's GMRES loop, a "
                           "lax.while_loop, cannot be reverse-differentiated either); call it "
                           "under torch.no_grad()")
    y, s, sweeps = _SmallLstsq.apply(a, b.to(a.dtype))
    return (y, s, sweeps) if full else y


def _launch(a, b):
    """One launch of E2 on the CUDA matrices a and right-hand sides b (of
    a's dtype): (y, s, sweeps)."""
    r, c = a.shape[-2], a.shape[-1]
    batch_shape = tuple(a.shape[:-2])
    A3 = a.reshape(-1, r, c).contiguous()
    B2 = b.reshape(-1, r).contiguous()
    n = A3.shape[0]
    rdt = a.real.dtype if a.is_complex() else a.dtype
    y = torch.empty((n, c), dtype=a.dtype, device=a.device)
    s = torch.empty((n, c), dtype=rdt, device=a.device)
    sweeps = torch.empty(n, dtype=torch.int32, device=a.device)
    if n and r and c:
        lib = _lib()
        per = workspace_bytes(r, c, a.dtype)
        work = torch.empty(n * per, dtype=torch.uint8, device=a.device) if per else None
        rc = lib.linops_small_lstsq(A3.data_ptr(), B2.data_ptr(), y.data_ptr(), s.data_ptr(),
                                    None if work is None else work.data_ptr(),
                                    sweeps.data_ptr(), r, c, n, _DTYPE_CODE[a.dtype],
                                    *_device_stream(A3))
        _check_launch(lib, rc, "small_lstsq")
        _LAUNCHES["small_lstsq"] += 1
    else:  # an empty matrix: y = 0
        for t in (y, s, sweeps):
            t.zero_()
    k = min(r, c)  # the thin SVD's singular values
    return (y.reshape(batch_shape + (c,)), s[:, :k].reshape(batch_shape + (k,)),
            sweeps.reshape(batch_shape))
