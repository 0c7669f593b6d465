"""Lane-gather kernels K7-K14, their plain versions and launch counts.

Counterparts of ``linops_tpu/kernels/lane_gather.py``, the crossbar primitive
of the Clos-routed unstructured SpMV (``sparse/routing.py``,
``sparse/routed.py``):

- ``lane_gather`` replaces ``lane_gather`` (K7);
- ``lane_gather_mul`` replaces ``lane_gather_mul`` (K8);
- ``lane_gather_mul_t_batched`` replaces ``lane_gather_mul_t_batched`` (K9);
- ``lane_gather_sum`` replaces ``lane_gather_sum`` (K10);
- ``lane_segsum`` replaces ``lane_segsum`` (K11);
- ``lane_gather_mul_segsum`` replaces ``lane_gather_mul_segsum`` (K12);
- ``tiled_combine`` replaces ``tiled_combine`` (K13): the row combine over
  128-row tiles for a routed program without segment bounds;
- ``lane_gather_mul_t`` replaces ``lane_gather_mul_t`` (K14): K9 for one
  chunk and one repeat, launched through K9's kernel.

All work on rows of 128 lanes with int8 lane indices. Index, value and
boundary arrays are shared by every repeat of the data (the reference's
rep-outer layout, one copy for all RHS columns): repeated operands are
(rep·R0, 128), shared ones (R0, 128), and output row i reads shared row
i mod R0.

The kernels are hand-written CUDA C++ for ``sm_90a`` in
``csrc/lane_gather.cu`` (design notes there), built with ``nvcc`` at first
use (``build.py``). Each wrapper dispatches on the device of the tensors it
is given: CPU tensors take the plain PyTorch version beside it (``*_plain``);
CUDA tensors launch the kernel or raise. There is no fallback from a CUDA
tensor to the plain version. The kernels take any R0 (the reference's
128-row tile rule was a TPU VMEM constraint), f32 or bf16, 128 lanes; K8,
K9 and K12 read the shared values in their own dtype beside data of either,
so no wrapper converts or copies a program array. The plain versions take
any width and dtype; both take products in at least f32 and sum in at least
f32, rounding once to the result type.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.segsum import SegmentPlan, segment_plan, segment_sum
from ..utils import loop
from .bsr_spmv import _check_launch, _device_stream

__all__ = [
    "lane_gather",
    "lane_gather_mul",
    "lane_gather_mul_t_batched",
    "lane_gather_sum",
    "lane_segsum",
    "lane_gather_mul_segsum",
    "tiled_combine",
    "lane_gather_mul_t",
    "lane_gather_plain",
    "lane_gather_mul_plain",
    "lane_gather_mul_t_batched_plain",
    "lane_gather_sum_plain",
    "lane_segsum_plain",
    "lane_gather_mul_segsum_plain",
    "tiled_combine_plain",
    "tiled_combine_plan",
    "lane_gather_mul_t_plain",
    "launch_counts",
    "reset_launch_counts",
    "RADIX",
]

RADIX = 128

# kernel name -> launches since the last reset; bumped only where a kernel
# is launched (never by the plain versions), a launch recorded into a CUDA
# graph being captured included; a replay of that graph runs the kernel
# without the wrapper and is not counted (``utils/loop.py``)
_LAUNCHES = {"lane_gather": 0, "lane_gather_mul": 0, "lane_gather_mul_t_batched": 0,
             "lane_gather_sum": 0, "lane_segsum": 0, "lane_gather_mul_segsum": 0,
             "tiled_combine": 0, "lane_gather_mul_t": 0}
loop.register_launches(_LAUNCHES)
# kernel name -> the device function each of its launches runs once: the name
# a profiler trace or a CUDA graph's kernel node gives it (K9 and K14 share one)
LAUNCH_SYMBOLS = {"lane_gather": "gather_kernel", "lane_gather_mul": "gather_mul_kernel",
                  "lane_gather_mul_t_batched": "gather_mul_t_kernel",
                  "lane_gather_sum": "gather_sum_kernel", "lane_segsum": "segsum_kernel",
                  "lane_gather_mul_segsum": "gather_mul_segsum_kernel",
                  "tiled_combine": "tiled_combine_kernel",
                  "lane_gather_mul_t": "gather_mul_t_kernel"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts()``: one per
    wrapper call that launched its kernel or recorded it into a CUDA graph
    being captured (a replay is not counted)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _acc(dtype):
    # f32 arithmetic for f32/bf16 (as the kernels); wider types keep theirs
    return torch.promote_types(dtype, torch.float32)


# ----------------------------------------------------------------------------
# Plain versions (any width, any dtype)
# ----------------------------------------------------------------------------


def lane_gather_plain(a, idx, rep: int = 1):
    """out[i, l] = a[i, idx[i mod R0, l]] for a (rep·R0, L) over idx (R0, L)."""
    m, L = idx.shape
    ix = idx.long()
    if rep == 1:
        return torch.gather(a, 1, ix)
    return torch.gather(a.reshape(rep, m, L), 2, ix.expand(rep, m, L)).reshape(rep * m, L)


def lane_gather_mul_plain(xw, idx, vals, rep: int = 1):
    """out[i, l] = vals[i mod R0, l] · xw[i, idx[i mod R0, l]], in
    ``promote(vals, xw)``."""
    res = torch.promote_types(vals.dtype, xw.dtype)
    acc = _acc(res)
    g = lane_gather_plain(xw, idx, rep).to(acc)
    m, L = idx.shape
    if rep == 1:
        return (vals.to(acc) * g).to(res)
    return (vals.to(acc)[None] * g.reshape(rep, m, L)).reshape(rep * m, L).to(res)


def lane_gather_mul_t_batched_plain(xw, idx, vals, C: int, m: int, rep: int = 1):
    """K8 over (rep·C·m, 128) with each chunk's (m, 128) products
    transposed: returns (rep·C·128, m)."""
    z = lane_gather_mul_plain(xw, idx, vals, rep)
    L = idx.shape[1]
    return z.reshape(rep * C, m, L).transpose(1, 2).reshape(rep * C * L, m)


def lane_gather_sum_plain(a, idx, w: int, rep: int = 1):
    """K7, then the sum of each w consecutive lanes: (rows, L) -> (rows, L/w)."""
    g = lane_gather_plain(a, idx, rep)
    rows, L = g.shape
    return g.to(_acc(g.dtype)).reshape(rows, L // w, w).sum(dim=2).to(g.dtype)


def _segsum(z, lo, hi, rep: int):
    """S[i, c] = cs[i, hi[c]] - cs[i, lo[c]] (−1 reads as 0), cs the
    inclusive lane prefix of z, in z's dtype."""
    m, L = lo.shape
    zz = z.reshape(rep, m, L)
    cs = torch.cumsum(zz, dim=2)
    lo_i, hi_i = lo.long().expand(rep, m, L), hi.long().expand(rep, m, L)
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    hi_g = torch.where(hi_i >= 0, torch.gather(cs, 2, hi_i.clamp_min(0)), zero)
    lo_g = torch.where(lo_i >= 0, torch.gather(cs, 2, lo_i.clamp_min(0)), zero)
    return (hi_g - lo_g).reshape(rep * m, L)


def lane_segsum_plain(q, lo, hi, rep: int = 1):
    """Per-window contiguous segment sums (``lane_segsum``), accumulated in
    at least f32 and rounded once to q's dtype."""
    return _segsum(q.to(_acc(q.dtype)), lo, hi, rep).to(q.dtype)


def lane_gather_mul_segsum_plain(a, idx, vals, lo, hi, rep: int = 1):
    """K8, then K11 on the products (kept in at least f32), rounded once to
    ``promote(vals, a)``."""
    res = torch.promote_types(vals.dtype, a.dtype)
    acc = _acc(res)
    m, L = idx.shape
    g = lane_gather_plain(a, idx, rep).to(acc).reshape(rep, m, L)
    z = (vals.to(acc)[None] * g).reshape(rep * m, L)
    return _segsum(z, lo, hi, rep).to(res)


def tiled_combine_plan(rowid) -> SegmentPlan:
    """The plain combine's summation order for ``rowid``: slot (t, k) adds
    into segment t·128 + rowid[t, k], trash slots into a last one. Built at
    the first call for a ``rowid`` tensor and kept on it as an attribute, so
    a routed program builds it once and a copy of ``rowid`` on another
    device builds its own."""
    plan = getattr(rowid, "_combine_plan", None)
    if plan is None:
        T = rowid.shape[0]
        rid = rowid.long()
        seg = torch.where(rid >= 0, torch.arange(T, device=rid.device)[:, None] * RADIX + rid,
                          T * RADIX)
        plan = segment_plan(seg, T * RADIX + 1)
        rowid._combine_plan = plan
    return plan


def tiled_combine_plain(q, rowid, rep: int = 1):
    """out[j, t·128 + i] = Σ_k q[j, t·K + k]·[rowid[t, k] == i] over T tiles of
    K slots (rowid < 0 = trash): q (rep·T·K,) -> (rep·T·128,), summed in at
    least f32, in slot order (``tiled_combine_plan``), and rounded once to
    q's dtype."""
    T, K = rowid.shape
    qt = q.reshape(rep, T * K).t().to(_acc(q.dtype))  # (T·K, rep): slots lead
    out = segment_sum(qt, tiled_combine_plan(rowid))
    return out[:T * RADIX].t().reshape(-1).to(q.dtype)


def lane_gather_mul_t_plain(xw, idx, vals):
    """K8 on one (m, L) chunk, transposed: (L, m) in ``promote(vals, xw)``."""
    return lane_gather_mul_plain(xw, idx, vals).t().contiguous()


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def _lib():
    from .build import load_library

    lib = load_library("lane_gather")
    if not getattr(lib, "_linops_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        tail = [i32, i32, p]  # (data) dtype, device, stream; K8/K9/K12 put vals' first
        lib.linops_lane_gather.argtypes = [p, p, p, i64, i64] + tail
        lib.linops_lane_gather_mul.argtypes = [p, p, p, p, i64, i64, i32] + tail
        lib.linops_lane_gather_mul_t.argtypes = [p, p, p, p, i64, i64, i64, i32] + tail
        lib.linops_lane_gather_sum.argtypes = [p, p, p, i64, i64, i32] + tail
        lib.linops_lane_segsum.argtypes = [p, p, p, p, i64, i64] + tail
        lib.linops_lane_gather_mul_segsum.argtypes = [p, p, p, p, p, p, i64, i64, i32] + tail
        lib.linops_tiled_combine.argtypes = [p, p, p, i64, i64, i64] + tail
        for name in ("linops_lane_gather", "linops_lane_gather_mul", "linops_lane_gather_mul_t",
                     "linops_lane_gather_sum", "linops_lane_segsum",
                     "linops_lane_gather_mul_segsum", "linops_tiled_combine"):
            getattr(lib, name).restype = ctypes.c_int
        lib.linops_cuda_error_string.argtypes = [ctypes.c_int]
        lib.linops_cuda_error_string.restype = ctypes.c_char_p
        lib._linops_typed = True
    return lib


def _on_cpu(t, what: str) -> bool:
    """True for a CPU tensor (take the plain version); False for CUDA; raises
    for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return False


def _rows(t, device, what: str, name: str, shared: bool = False):
    """A (rows, 128) operand, checked: on ``device`` and contiguous. The
    kernels read rows with 16-byte vector loads: a repeated (per-call)
    operand at an odd offset is copied once into fresh storage; a shared one
    (the program's indices, values and bounds) raises instead, so no program
    array is copied on an apply."""
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
    if t.dim() != 2 or t.shape[1] != RADIX:
        raise ValueError(f"{what}: {name} must be (rows, {RADIX}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.data_ptr() % 16:
        if shared:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
        t = t.clone()
    return t


def _index(t, rows: int, device, what: str, name: str):
    if t.dtype != torch.int8:
        raise TypeError(f"{what}: {name} must be int8, got {t.dtype}")
    if tuple(t.shape) != (rows, RADIX):
        raise ValueError(f"{what}: {name} must be ({rows}, {RADIX}), got {tuple(t.shape)}")
    return _rows(t, device, what, name, shared=True)


def _kernel_dtype(what: str, *dtypes):
    """The result dtype, promote(*dtypes); each operand must be f32 or bf16."""
    if any(d not in _DTYPE_CODE for d in dtypes):
        raise TypeError(f"{what}: the CUDA kernel takes f32/bf16 operands; got "
                        f"{', '.join(str(d) for d in dtypes)}")
    res = dtypes[0]
    for d in dtypes[1:]:
        res = torch.promote_types(res, d)
    return res


def _repeats(a, r0: int, rep: int, what: str):
    if rep < 1 or a.shape[0] != rep * r0:
        raise ValueError(f"{what}: {a.shape[0]} rows is not rep={rep} times the "
                         f"{r0} shared rows")


def lane_gather(a, idx, rep: int = 1):
    """K7: out[i, l] = a[i, idx[i mod R0, l]], a (rep·R0, 128) over a shared
    int8 idx (R0, 128). CPU tensors take ``lane_gather_plain``."""
    if _on_cpu(a, "lane_gather"):
        return lane_gather_plain(a, idx, rep)
    r0 = idx.shape[0]
    _kernel_dtype("lane_gather", a.dtype)
    a = _rows(a, a.device, "lane_gather", "a")
    _repeats(a, r0, rep, "lane_gather")
    idx = _index(idx, r0, a.device, "lane_gather", "idx")
    out = torch.empty_like(a)
    lib = _lib()
    rc = lib.linops_lane_gather(a.data_ptr(), idx.data_ptr(), out.data_ptr(), a.shape[0], r0,
                                _DTYPE_CODE[a.dtype], *_device_stream(a))
    _check_launch(lib, rc, "lane_gather")
    _LAUNCHES["lane_gather"] += 1
    return out


def _mul_operands(xw, idx, vals, rep, what):
    """Checked (xw, idx, vals), each kept in its own dtype, and the result
    dtype ``promote(vals, xw)``."""
    r0 = idx.shape[0]
    dt = _kernel_dtype(what, vals.dtype, xw.dtype)
    xw = _rows(xw, xw.device, what, "xw")
    _repeats(xw, r0, rep, what)
    idx = _index(idx, r0, xw.device, what, "idx")
    vals = _rows(vals, xw.device, what, "vals", shared=True)
    if vals.shape[0] != r0:
        raise ValueError(f"{what}: vals has {vals.shape[0]} rows, idx {r0}")
    return xw, idx, vals, dt


def _codes(vals, data):
    """(vals' dtype code, data's dtype code): K8/K9/K12's type arguments."""
    return _DTYPE_CODE[vals.dtype], _DTYPE_CODE[data.dtype]


def lane_gather_mul(xw, idx, vals, rep: int = 1):
    """K8: out[i, l] = vals[i mod R0, l] · xw[i, idx[i mod R0, l]], in
    ``promote(vals, xw)``. CPU tensors take ``lane_gather_mul_plain``."""
    if _on_cpu(xw, "lane_gather_mul"):
        return lane_gather_mul_plain(xw, idx, vals, rep)
    xw, idx, vals, dt = _mul_operands(xw, idx, vals, rep, "lane_gather_mul")
    out = torch.empty(xw.shape, dtype=dt, device=xw.device)
    lib = _lib()
    rc = lib.linops_lane_gather_mul(xw.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                                    out.data_ptr(), xw.shape[0], idx.shape[0],
                                    *_codes(vals, xw), *_device_stream(xw))
    _check_launch(lib, rc, "lane_gather_mul")
    _LAUNCHES["lane_gather_mul"] += 1
    return out


def lane_gather_mul_t_batched(xw, idx, vals, C: int, m: int, rep: int = 1):
    """K9: K8 over xw (rep·C·m, 128) and shared idx/vals (C·m, 128), each
    chunk's products transposed: rows [(j·C + c)·128, ...) of the (rep·C·128,
    m) result hold repeat j, chunk c. CPU tensors take the plain version."""
    if _on_cpu(xw, "lane_gather_mul_t_batched"):
        return lane_gather_mul_t_batched_plain(xw, idx, vals, C, m, rep)
    if idx.shape[0] != C * m:
        raise ValueError(f"lane_gather_mul_t_batched: idx has {idx.shape[0]} rows, "
                         f"expected C·m = {C * m}")
    xw, idx, vals, dt = _mul_operands(xw, idx, vals, rep, "lane_gather_mul_t_batched")
    out = torch.empty((rep * C * RADIX, m), dtype=dt, device=xw.device)
    lib = _lib()
    rc = lib.linops_lane_gather_mul_t(xw.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                                      out.data_ptr(), C, m, rep, *_codes(vals, xw),
                                      *_device_stream(xw))
    _check_launch(lib, rc, "lane_gather_mul_t_batched")
    _LAUNCHES["lane_gather_mul_t_batched"] += 1
    return out


def lane_gather_sum(a, idx, w: int, rep: int = 1):
    """K10: the last crossbar, then the sum of each w consecutive lanes:
    a (rep·R0, 128) over idx (R0, 128) -> (rep·R0, 128 // w). w is a power of
    two up to 128. CPU tensors take ``lane_gather_sum_plain``."""
    if w < 1 or w > RADIX or w & (w - 1):
        raise ValueError(f"lane_gather_sum: w must be a power of two up to {RADIX}, got {w}")
    if _on_cpu(a, "lane_gather_sum"):
        return lane_gather_sum_plain(a, idx, w, rep)
    r0 = idx.shape[0]
    dt = _kernel_dtype("lane_gather_sum", a.dtype)
    a = _rows(a, a.device, "lane_gather_sum", "a")
    _repeats(a, r0, rep, "lane_gather_sum")
    idx = _index(idx, r0, a.device, "lane_gather_sum", "idx")
    out = torch.empty((a.shape[0], RADIX // w), dtype=dt, device=a.device)
    lib = _lib()
    rc = lib.linops_lane_gather_sum(a.data_ptr(), idx.data_ptr(), out.data_ptr(), a.shape[0],
                                    r0, w, _DTYPE_CODE[dt], *_device_stream(a))
    _check_launch(lib, rc, "lane_gather_sum")
    _LAUNCHES["lane_gather_sum"] += 1
    return out


def lane_segsum(q, lo, hi, rep: int = 1):
    """K11: S[i, c] = the sum of q's c-th contiguous lane segment in window i,
    from int8 boundaries lo/hi (R0, 128) (see ``sparse/routed.py::_run_bounds``;
    −1 = no term). CPU tensors take ``lane_segsum_plain``."""
    if _on_cpu(q, "lane_segsum"):
        return lane_segsum_plain(q, lo, hi, rep)
    r0 = lo.shape[0]
    dt = _kernel_dtype("lane_segsum", q.dtype)
    q = _rows(q, q.device, "lane_segsum", "q")
    _repeats(q, r0, rep, "lane_segsum")
    lo = _index(lo, r0, q.device, "lane_segsum", "lo")
    hi = _index(hi, r0, q.device, "lane_segsum", "hi")
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.linops_lane_segsum(q.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                                q.shape[0], r0, _DTYPE_CODE[dt], *_device_stream(q))
    _check_launch(lib, rc, "lane_segsum")
    _LAUNCHES["lane_segsum"] += 1
    return out


def lane_gather_mul_segsum(a, idx, vals, lo, hi, rep: int = 1):
    """K12: K8, then K11 on the products: the last stage of the derived
    transpose. a (rep·R0, 128) over shared idx/vals/lo/hi (R0, 128); result in
    ``promote(vals, a)``. CPU tensors take the plain version."""
    if _on_cpu(a, "lane_gather_mul_segsum"):
        return lane_gather_mul_segsum_plain(a, idx, vals, lo, hi, rep)
    what = "lane_gather_mul_segsum"
    a, idx, vals, dt = _mul_operands(a, idx, vals, rep, what)
    r0 = idx.shape[0]
    lo = _index(lo, r0, a.device, what, "lo")
    hi = _index(hi, r0, a.device, what, "hi")
    out = torch.empty(a.shape, dtype=dt, device=a.device)
    lib = _lib()
    rc = lib.linops_lane_gather_mul_segsum(a.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                                           lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                                           a.shape[0], r0, *_codes(vals, a),
                                           *_device_stream(a))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out


def tiled_combine(q, rowid, rep: int = 1):
    """K13: the row combine over 128-row tiles, for any ``rowid`` per tile:
    q (rep·T·K,) partials, tile t of repeat j owning slots [(j·T + t)·K, ...),
    over a shared int8 rowid (T, K) (row within the tile, −1 = trash); returns
    (rep·T·128,) row sums in q's dtype, summed in f32 in a fixed order (the
    same bits on every run). CPU tensors take ``tiled_combine_plain``."""
    if _on_cpu(q, "tiled_combine"):
        return tiled_combine_plain(q, rowid, rep)
    what = "tiled_combine"
    dt = _kernel_dtype(what, q.dtype)
    if rowid.dim() != 2:
        raise ValueError(f"{what}: rowid must be (T, K), got {tuple(rowid.shape)}")
    T, K = rowid.shape
    if rowid.dtype != torch.int8:
        raise TypeError(f"{what}: rowid must be int8, got {rowid.dtype}")
    if q.device != rowid.device:
        raise ValueError(f"{what}: rowid is on {rowid.device}, expected {q.device}")
    if rep < 1 or q.dim() != 1 or q.shape[0] != rep * T * K:
        raise ValueError(f"{what}: q must be (rep·T·K,) = ({rep * T * K},), got "
                         f"{tuple(q.shape)}")
    if not (q.is_contiguous() and rowid.is_contiguous()):
        raise ValueError(f"{what}: q and rowid must be contiguous")
    out = torch.empty(rep * T * RADIX, dtype=dt, device=q.device)
    lib = _lib()
    rc = lib.linops_tiled_combine(q.data_ptr(), rowid.data_ptr(), out.data_ptr(), T, K, rep,
                                  _DTYPE_CODE[dt], *_device_stream(q))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out


def lane_gather_mul_t(xw, idx, vals):
    """K14: K8 on one chunk with a transposed output: xw, idx, vals (m, 128)
    -> (128, m) in ``promote(vals, xw)``, any m. On the card it launches K9's
    kernel with C = 1 and rep = 1 and counts as K14. CPU tensors take
    ``lane_gather_mul_t_plain``."""
    if _on_cpu(xw, "lane_gather_mul_t"):
        return lane_gather_mul_t_plain(xw, idx, vals)
    what = "lane_gather_mul_t"
    m = idx.shape[0]
    if xw.shape[0] != m:
        raise ValueError(f"{what}: xw has {xw.shape[0]} rows, idx {m}")
    xw, idx, vals, dt = _mul_operands(xw, idx, vals, 1, what)
    out = torch.empty((RADIX, m), dtype=dt, device=xw.device)
    lib = _lib()
    rc = lib.linops_lane_gather_mul_t(xw.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                                      out.data_ptr(), 1, m, 1, *_codes(vals, xw),
                                      *_device_stream(xw))
    _check_launch(lib, rc, what)
    _LAUNCHES[what] += 1
    return out
