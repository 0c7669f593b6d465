"""G1: a loop nested in a captured block, as a CUDA conditional WHILE node,
and the kernel that sets the node's condition.

The reference nests an inner solve's ``lax.while_loop`` inside the outer
solver's compiled loop (``linops_tpu/ops/linalg_ops.py``: the inner solve is
pure jnp), so both stop on the device. ``utils/loop.py`` captures the outer
solver's iterations into a CUDA graph; a ``device_while`` that runs while
such a capture is in progress becomes one WHILE node of that graph
(``while_node``): the node repeats its body graph, one masked block of the
inner loop, while a condition on the device is nonzero. ``set_while_condition``
launches the kernel that sets it (``set_while_condition_kernel`` in
``csrc/graph_cond.cu``, hand-written CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use by ``build.py``): it copies the inner loop's test
``act`` into the condition. It is not the counterpart of a
Pallas site; it is the device half of the reference's nested while loop.

The wrapper dispatches on the tensor's device: a CPU tensor takes
``while_condition_plain`` (the value the kernel would write; no graph runs on
the CPU); a CUDA tensor launches the kernel or raises. The node itself needs
CUDA 12.3 or later (the card's driver and toolkit).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..utils import loop
from .bsr_spmv import _check_launch

__all__ = ["set_while_condition", "while_condition_plain", "while_node", "open_bodies",
           "launch_counts", "reset_launch_counts"]

# kernel name -> launches since the last reset (bumped only where the kernel
# is launched, one recorded into a CUDA graph being captured included)
_LAUNCHES = {"while_condition": 0}
loop.register_launches(_LAUNCHES)
# kernel name -> the device function each launch runs once
LAUNCH_SYMBOLS = {"while_condition": "set_while_condition_kernel"}

_BODIES: list = []  # the body streams being captured, innermost last


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts()``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def open_bodies() -> tuple:
    """The streams whose capture into a while node's body is in progress,
    outermost first."""
    return tuple(_BODIES)


def _lib():
    from .build import load_library

    lib = load_library("graph_cond")
    if not getattr(lib, "_linops_typed", False):
        p, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.linops_while_handle.argtypes = [i64, ctypes.POINTER(u64)]
        lib.linops_while_condition.argtypes = [u64, p, i64]
        lib.linops_while_node_begin.argtypes = [i64, u64, i64, ctypes.POINTER(p)]
        lib.linops_while_node_end.argtypes = [i64]
        for f in (lib.linops_while_handle, lib.linops_while_condition,
                  lib.linops_while_node_begin, lib.linops_while_node_end):
            f.restype = ctypes.c_int
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def _flag(act):
    if act.dtype != torch.bool or act.numel() != 1:
        raise TypeError(f"set_while_condition: act must be one bool, got "
                        f"{act.dtype}{tuple(act.shape)}")
    return act


def while_condition_plain(act):
    """The plain version: the value the kernel gives the condition, ``act``,
    as a 0-dim bool tensor."""
    return _flag(act).reshape(())


def set_while_condition(handle: int, act):
    """Set the WHILE node condition ``handle`` (of the graph being captured)
    to ``act`` (one bool on the card) on the device: one launch of the kernel
    on the current stream. On a CPU tensor (no graph runs there) returns
    ``while_condition_plain(act)``."""
    if act.device.type == "cpu":
        return while_condition_plain(act)
    if not act.is_cuda:
        raise ValueError(f"set_while_condition: tensors on {act.device} are not supported")
    _flag(act)
    lib = _lib()
    stream = torch.cuda.current_stream(act.device).cuda_stream
    rc = lib.linops_while_condition(int(handle), act.data_ptr(), stream)
    _check_launch(lib, rc, "while_condition")
    _LAUNCHES["while_condition"] += 1
    return None


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.linops_cuda_error_string(rc).decode()
        raise RuntimeError(f"while node: {what} failed: CUDA error {rc} ({msg})")


@contextlib.contextmanager
def while_node(act, body_stream, pool):
    """Record a WHILE node into the graph the current stream is capturing:
    the condition is set from ``act`` (one bool on the card) before the node,
    the block's work (run inside) is captured on ``body_stream`` into the
    node's body with its allocations in ``pool``, and the body ends by setting
    the condition from ``act`` again (the block updates it in place). After
    the block the current stream depends on the node. Yields the body's
    ``cudaGraph_t`` (an address; it lives as long as the captured graph)."""
    dev = act.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    handle = ctypes.c_uint64()
    _check(lib, lib.linops_while_handle(stream, ctypes.byref(handle)), "creating its condition")
    set_while_condition(handle.value, act)
    body = ctypes.c_void_p()
    _check(lib, lib.linops_while_node_begin(stream, handle.value, body_stream.cuda_stream,
                                            ctypes.byref(body)),
           "adding the node and beginning its body")
    # the outer capture routes only its own capture's allocations to its pool:
    # the body's (another capture) go to ``pool`` while it is captured
    torch._C._cuda_beginAllocateToPool(dev.index, pool)
    _BODIES.append(body_stream)
    done = False
    try:
        with torch.cuda.stream(body_stream):
            yield body.value
            set_while_condition(handle.value, act)
        done = True
    finally:
        _BODIES.pop()
        torch._C._cuda_endAllocateToPool(dev.index, pool)
        rc = lib.linops_while_node_end(body_stream.cuda_stream)
        if done:
            _check(lib, rc, "ending its body")
