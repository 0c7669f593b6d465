"""Sparse linear operators over COO / CSR / ELL / BSR storage, the
Clos-routed CSR operator, and ``opSparse``.

Counterpart of ``linops_tpu/sparse/ops.py``. Transpose and adjoint products
reuse the same storage; no transposed copy is made.

- COO/CSR: gather plus a segment sum in a fixed order (the reference's
  gather + ``segment_sum``); ELL: gather plus a row sum forward, a segment
  sum for the transpose. Each sum follows a plan built once per operator
  and direction (``core/segsum.py``), so a rerun on the card gives the same
  bits. Plain PyTorch; no kernel.
- BSR: the hand-written kernels K1-K6 on CUDA (see ``BSROperator``).
- Routed CSR: the Clos-routed pipeline of ``sparse/routed.py`` over the
  lane-gather kernels K7-K12 on CUDA (see ``RoutedCSROperator``).

``opSparse`` builds on the CUDA device unless asked for another with
``device=`` (``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import copy
import time
from typing import Tuple, Union

import numpy as np
import torch

from ..core.ad import KernelApply, kernel_graph_wanted
from ..core.base import (LinearOperator, LinearOperatorException, _conj, _move, compose_modes,
                         default_device, mode_conjugated, mode_transposed)
from ..core.segsum import SegmentPlan, segment_plan, segment_sum
from ..kernels import bsr_spmv as K
from ..kernels.bsr_spmv import (
    bsr_column_plan,
    bsr_matmat_plain as bsr_matmat,
    bsr_matvec_kernel,
    bsr_matvec_plain as bsr_matvec,
    bsr_rmatvec_kernel,
    bsr_rmatvec_plain as bsr_rmatvec,
    kernel_dtypes,
)
from .formats import (
    BSR,
    COO,
    CSR,
    ELL,
    bsr_from_dense,
    check_int32_range,
    coo_from_dense,
    csr_from_dense,
    csr_from_parts,
    ell_from_csr_parts,
    ell_from_dense,
)

__all__ = ["COOOperator", "CSROperator", "RoutedCSROperator", "ELLOperator", "BSROperator",
           "opSparse", "bsr_matvec", "bsr_rmatvec", "bsr_matmat", "ROUTED_AUTO_WARN_NNZ",
           "ROUTED_AUTO_MAX_NNZ"]


def coo_matvec(vals, cols, plan: SegmentPlan, x):
    """y[r] = Σ vals[k]·x[cols[k]] over the k of row r, summed in ``plan``'s
    order (x may carry a trailing column dimension)."""
    v = vals if x.dim() == 1 else vals[:, None]
    return segment_sum(v * x.index_select(0, cols), plan)


class _SparseBase(LinearOperator):
    _fields_tensors = ("data",)
    _fields_static = ("_symmetric", "_hermitian")

    def __init__(self, data, symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        self.data = data
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    def apply(self, v, mode: str = "N"):
        # sparse applies pad to block multiples (and torch gathers would
        # fail late), so validate the true dims up front
        if getattr(v, "ndim", 1) != 1 or v.shape[0] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        return super().apply(v, mode)

    def _check_mat(self, M, mode: str):
        if getattr(M, "ndim", 2) != 2 or M.shape[0] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")

    @property
    def nrow(self):
        return self.data.shape[0]

    @property
    def ncol(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.vals.dtype if hasattr(self.data, "vals") else self.data.blocks.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def nnz(self) -> int:
        return self.data.nnz


class _Summed(_SparseBase):
    """Sparse storage whose products sum through ``segment_sum``: the
    forward plan (``sum_n``) and the transpose plan (``sum_t``) are built at
    their first use and kept, once per operator."""

    _fields_derived = ("sum_n", "sum_t")

    def __init__(self, data, symmetric: bool = False, hermitian: bool = False):
        super().__init__(data, symmetric, hermitian)
        self.sum_n = self.sum_t = None

    # the plans the applies read: the forward's (sum_n) and the transpose's (sum_t)
    _plans = (False, True)

    def _build_derived(self):
        for transpose in self._plans:
            self._plan_for(transpose)

    def _plan_for(self, transpose: bool) -> SegmentPlan:
        field = "sum_t" if transpose else "sum_n"
        plan = getattr(self, field)
        if plan is None:
            plan = self._build_plan(transpose)
            setattr(self, field, plan)
        return plan


class _IndexedSparse(_Summed):
    """COO/CSR applies (gather + a segment sum in a fixed order): the
    forward sums each row in stored order (CSR rows are sorted; COO takes a
    stable sort by row), the transpose each column in a stable sort by
    column."""

    def _build_plan(self, transpose: bool) -> SegmentPlan:
        d = self.data
        if transpose:
            return segment_plan(d.cols, d.shape[1])
        return segment_plan(d.rows, d.shape[0], is_sorted=isinstance(d, CSR))

    def _prod(self, v):
        return coo_matvec(self.data.vals, self.data.cols, self._plan_for(False), v)

    def _tprod(self, u):
        return coo_matvec(self.data.vals, self.data.rows, self._plan_for(True), u)

    def _ctprod(self, w):
        return coo_matvec(_conj(self.data.vals), self.data.rows, self._plan_for(True), w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        d = self.data
        if mode == "N":
            return coo_matvec(d.vals, d.cols, self._plan_for(False), M)
        if mode == "C":  # conj(A) M = conj(A conj(M))
            return _conj(coo_matvec(d.vals, d.cols, self._plan_for(False), _conj(M)))
        vals = d.vals if mode == "T" else _conj(d.vals)
        return coo_matvec(vals, d.rows, self._plan_for(True), M)


class COOOperator(_IndexedSparse):
    """Sparse operator over COO storage."""


class CSROperator(_IndexedSparse):
    """Sparse operator over CSR storage (its expanded ``rows`` drive the
    same gather + segment sum as COO)."""


class ELLOperator(_Summed):
    """ELLPACK operator: forward is a gather plus a row sum (no scatter);
    the transpose is a segment sum over a stable sort of the slots by
    column."""

    _plans = (True,)  # the forward sums each row's slots directly

    def _build_plan(self, transpose: bool) -> SegmentPlan:
        return segment_plan(self.data.cols, self.data.shape[1])

    def _prod(self, v):
        d = self.data
        return torch.sum(d.vals * v[d.cols.long()], dim=1)

    def _tprod_vals(self, vals, u):
        return segment_sum((vals * u[:, None]).reshape(-1), self._plan_for(True))

    def _tprod(self, u):
        return self._tprod_vals(self.data.vals, u)

    def _ctprod(self, w):
        return self._tprod_vals(_conj(self.data.vals), w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        d = self.data
        cols = d.cols.long()
        if mode == "N":
            return torch.sum(d.vals[:, :, None] * M[cols], dim=1)
        if mode == "C":
            return _conj(torch.sum(d.vals[:, :, None] * _conj(M)[cols], dim=1))
        vals = d.vals if mode == "T" else _conj(d.vals)
        contrib = (vals[:, :, None] * M[:, None, :]).reshape(-1, M.shape[1])
        return segment_sum(contrib, self._plan_for(True))


def _on_card(t) -> bool:  # patchable seam: the CPU tests reach the routed matrix branch
    return t.is_cuda


def _numpy_vals(vals: torch.Tensor) -> np.ndarray:
    """A value tensor on the host as numpy; bf16 crosses as f32 (exact)."""
    vals = vals.detach().cpu()
    return (vals.float() if vals.dtype == torch.bfloat16 else vals).numpy()


class RoutedCSROperator(CSROperator):
    """CSR operator whose products run through the Clos-routed lane-gather
    pipeline (``sparse/routed.py``) instead of gather + segment sum: the
    path for genuinely unstructured patterns.

    Storage: the plain CSR (matrix right-hand sides off the card, dense
    conversion and the ``backend="xla"`` path reuse it) plus the packed
    forward routing program ``routed``. The transpose program is derived
    from the forward pack at construction (``RoutedTranspose``: the inverse
    network, no second router run), so ``op.T`` runs at full speed at once.

    ``backend``: ``"auto"`` or ``"routed"`` take the routed pipeline (the
    kernels on CUDA for f32/bf16 results, their plain versions otherwise);
    ``"xla"`` (alias ``"torch"``) the inherited CSR gather path. When the
    derived program is unavailable (ReducePass-fallback combines, extreme
    column skew) or ``defer_transpose=True``, the first T/H ``bump`` packs
    the transpose as a full CSC re-pack (``_ensure_transpose``).

    ``host_parts`` = (vals, cols, indptr) as host arrays spares the pack a
    copy back from the device; it is dropped after construction. The
    program lands on the device of ``data``; ``pack_seconds`` holds the
    host seconds spent packing (``"host"``) and uploading (``"upload"``).
    """

    _fields_tensors = ("data", "routed", "routed_t")
    _fields_static = ("_symmetric", "_hermitian", "_backend", "_w", "_defer_t")
    _fields_derived = ("sum_n", "sum_t", "_grad_plans")

    def __init__(self, data, symmetric=False, hermitian=False, routed=None, routed_t=None,
                 w="auto", backend="auto", defer_transpose=False, host_parts=None):
        super().__init__(data, symmetric, hermitian)
        backend = {"torch": "xla"}.get(backend, backend)
        if backend not in ("auto", "routed", "xla"):
            raise ValueError(f"unknown routed backend {backend!r}")
        self._backend = backend
        self._w = w
        self._defer_t = bool(defer_transpose)
        self.routed = routed
        self.routed_t = routed_t
        self._grad_plans = None
        self.pack_seconds = {"host": 0.0, "upload": 0.0}
        self._host_parts = host_parts
        try:
            if routed is None and backend != "xla":
                want_t = (routed_t is None and not defer_transpose
                          and not (symmetric or hermitian))
                packed = self._pack(transpose=False, with_transpose=want_t)
                if want_t:
                    self.routed, derived = packed
                    if derived is not None:
                        self.routed_t = derived
                else:
                    self.routed = packed
        finally:
            self._host_parts = None

    def _host_csr(self):
        """(vals, cols, indptr) on the host; vals in the numpy type that
        carries the stored dtype (f32 for bf16)."""
        want = _numpy_vals(torch.empty(0, dtype=self.data.vals.dtype)).dtype
        hp = self._host_parts
        if hp is not None:
            v, c, i = hp
            return np.asarray(v).astype(want, copy=False), np.asarray(c), np.asarray(i)
        d = self.data
        return _numpy_vals(d.vals), d.cols.cpu().numpy(), d.indptr.cpu().numpy()

    def _upload(self, prog):
        """A host program on the data's device, values in the stored dtype."""
        from .routed import RoutedTranspose, upload_program

        if prog is None:
            return None
        t0 = time.perf_counter()
        prog = upload_program(prog, self.data.vals.device)
        dt = self.data.vals.dtype
        if isinstance(prog, RoutedTranspose):
            prog = prog._replace(vals_pre=prog.vals_pre.to(dt))
        else:
            prog = prog._replace(vals=prog.vals.to(dt))
        self.pack_seconds["upload"] += time.perf_counter() - t0
        return prog

    def _pack(self, transpose: bool, with_transpose: bool = False):
        from .routed import pack_routed_csr

        d = self.data
        t0 = time.perf_counter()
        vals, cols, indptr = self._host_csr()
        if not transpose:
            packed = pack_routed_csr(vals, cols, indptr, d.shape, w=self._w,
                                     with_transpose=with_transpose, to_device=False)
            self.pack_seconds["host"] += time.perf_counter() - t0
            if with_transpose:
                return self._upload(packed[0]), self._upload(packed[1])
            return self._upload(packed)
        # transpose pack: re-sort by (col, row), a stable CSC build
        rows = np.asarray(cols, np.int64)
        cols = np.repeat(np.arange(d.shape[0], dtype=np.int64), np.diff(indptr))
        shp = (d.shape[1], d.shape[0])
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(shp[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=shp[0]), out=indptr[1:])
        packed = pack_routed_csr(vals[order], cols[order], indptr, shp, w=self._w,
                                 to_device=False)
        self.pack_seconds["host"] += time.perf_counter() - t0
        return self._upload(packed)

    def _use_routed(self) -> bool:
        return self._backend != "xla"

    def _build_derived(self):
        # the routed pipeline reads no segment plan (a transpose program that
        # is packed at the first T apply, ``defer_transpose``, is left to it)
        if not self._routed_ready():
            super()._build_derived()

    def _ensure_transpose(self):
        if self.routed_t is None and self._use_routed():
            self.routed_t = self._pack(transpose=True)

    def bump(self, mode: str, n: int = 1):
        # the transpose program is packed on the host before the first T/H
        # apply; mode "C" is served by the forward program (conj∘prod∘conj)
        if mode in ("T", "H") and not (self._symmetric or self._hermitian):
            self._ensure_transpose()
        super().bump(mode, n)

    def _routed_ready(self) -> bool:
        return self._use_routed() and self.routed is not None

    def _program_values(self):
        """The value tensors the routed applies read: the forward program's,
        then the transpose program's where one is packed."""
        from .routed import RoutedTranspose

        out = [self.routed.vals]
        rt = self.routed_t
        if rt is not None:
            out.append(rt.vals_pre if isinstance(rt, RoutedTranspose) else rt.vals)
        return out

    def _programs_with(self, tensors):
        """(routed, routed_t) reading their values from ``tensors`` (as
        ``_program_values`` orders them), or as they are for ()."""
        from .routed import RoutedTranspose

        routed, rt = self.routed, self.routed_t
        if tensors:
            routed = routed._replace(vals=tensors[0])
            if rt is not None:
                rt = (rt._replace(vals_pre=tensors[1]) if isinstance(rt, RoutedTranspose)
                      else rt._replace(vals=tensors[1]))
        return routed, rt

    def _routed_graph(self, x, how):
        """The routed apply ``how`` = (mode, kind) of x. Where it runs the
        kernels and gradients (or a ``torch.func`` transform) need the graph,
        it goes through ``KernelApply``, with the programs' values as its
        tensors: its backward is the apply in the adjoint mode and, for the
        values, ``_kernel_tensor_grads``. Otherwise the apply runs as it is."""
        from .routed import _use_kernel

        vals = self._program_values()
        if _use_kernel(None, self.routed.vals, x) and kernel_graph_wanted(x, *vals):
            return KernelApply.apply(self, how, x, *vals)
        return self._kernel_apply(x, how, ())

    # torch.func.vmap over a vector apply runs the matrix kind on the B
    # vectors as a row panel (``KernelApply.vmap``)
    _kernel_batch_kind = "panel"

    def _program_mode(self, mode: str) -> str:
        """The mode a program serves: a symmetric (hermitian) operator serves
        T and H (H and T) with the forward program, as ``apply`` does."""
        if mode_transposed(mode) and self._symmetric:
            return compose_modes("T", mode)
        if mode_transposed(mode) and self._hermitian:
            return compose_modes("H", mode)
        return mode

    def _kernel_apply(self, x, how, tensors=()):
        """The routed apply of x in ``how`` = (mode, kind), kind ``"vec"``,
        ``"mat"`` (a matrix of columns) or ``"panel"`` (rows), the programs
        reading their values from ``tensors`` when given. A vector apply packs
        a transpose program not yet packed, as ``bump`` packs it."""
        if tensors:
            op = copy.copy(self)
            op.routed, op.routed_t = self._programs_with(tensors)
            return op._kernel_apply(x, how, ())
        mode, kind = self._program_mode(how[0]), how[1]
        if kind != "vec":
            panel = kind == "panel"
            Y = self._routed_apply_matrix(x, mode, panel)
            if Y is not None:
                return Y
            return super().apply_matrix(x.t(), mode).t() if panel else super().apply_matrix(x, mode)
        from .routed import routed_matvec

        if mode == "N":
            return routed_matvec(self.routed, x)
        if mode == "C":
            return _conj(routed_matvec(self.routed, _conj(x)))
        return self._tprod_routed(x, conj_vals=mode == "H")

    def _grad_plan(self, which: str, prog):
        """``routed.value_grad_plan`` of a program, built at its first use and
        kept (rebuilt when the program's index arrays change)."""
        from .routed import RoutedTranspose, value_grad_plan

        key = (prog.g1inv if isinstance(prog, RoutedTranspose) else prog.lane_idx).data_ptr()
        plans = self._grad_plans or {}
        if which not in plans or plans[which][0] != key:
            plans[which] = (key, value_grad_plan(prog))
            self._grad_plans = plans
        return plans[which][1]

    def _kernel_tensor_grads(self, x, g, how, tensors):
        """The values' gradients for ``KernelApply``, in torch's convention:
        per packed slot ``g[row] · conj(x[col])`` for the program the apply
        read (the forward program for N and C; the transpose program for T
        and H, where for the derived transpose x is indexed by row and g by
        column), conjugated for C and H; None for a program the apply did not
        read. The routing runs on the kernels: g back to the slots through the
        inverse crossbars (K7), times the phase-1 gather of x (K8); see
        ``routed.routed_value_grad`` and ``routed_t_value_grad``."""
        from .routed import RoutedTranspose, routed_t_value_grad, routed_value_grad

        mode, kind = self._program_mode(how[0]), how[1]
        routed, rt = self._programs_with(tensors)

        def rows(t):
            return t[None] if kind == "vec" else (t.t() if kind == "mat" else t)

        X, G = rows(x), rows(g)
        if mode in ("N", "C"):
            slot, grad = 0, routed_value_grad(routed, self._grad_plan("fwd", routed), X, G)
        elif isinstance(rt, RoutedTranspose):
            slot, grad = 1, routed_t_value_grad(rt, routed, self._grad_plan("t", rt), X, G)
        else:
            slot, grad = 1, routed_value_grad(rt, self._grad_plan("t", rt), X, G)
        if mode_conjugated(mode):
            grad = _conj(grad)
        out = [None] * len(tensors)
        out[slot] = grad.to(tensors[slot].dtype)
        return tuple(out)

    def _prod(self, v):
        if not self._routed_ready():
            return super()._prod(v)
        return self._routed_graph(v, ("N", "vec"))

    def _tprod_routed(self, u, conj_vals: bool):
        self._ensure_transpose()  # an apply that skipped bump
        from .routed import RoutedTranspose, routed_matvec, routed_rmatvec

        rt = self.routed_t
        if isinstance(rt, RoutedTranspose):
            if conj_vals and rt.vals_pre.is_complex():
                rt = rt._replace(vals_pre=rt.vals_pre.conj_physical())
            return routed_rmatvec(rt, u)
        if conj_vals and rt.vals.is_complex():
            rt = rt._replace(vals=rt.vals.conj_physical())
        return routed_matvec(rt, u)

    def _tprod(self, u):
        if not self._routed_ready():
            return super()._tprod(u)
        return self._routed_graph(u, ("T", "vec"))

    def _ctprod(self, w):
        if not self._routed_ready():
            return super()._ctprod(w)
        return self._routed_graph(w, ("H", "vec"))

    def _matrix_prog(self, mode: str):
        """(prog, conj_vals, conj_io) for a matrix apply in ``mode``;
        symmetric/hermitian operators serve T/H with the forward program."""
        return {
            "N": (self.routed, False, False),
            "C": (self.routed, False, True),
            "T": ((self.routed, False, False) if self._symmetric
                  else (self.routed_t, False, False)),
            "H": ((self.routed, False, False) if self._hermitian
                  else (self.routed_t, True, False)),
        }[mode]

    def matrix_path(self, mode: str = "N", panel: bool = False) -> str:
        """Which implementation a matrix apply takes: ``"routed_panel"`` /
        ``"routed"`` (the routed pipeline with ``rep=k`` kernels, on CUDA) or
        ``"csr_fallback"`` (the CSR gather path, as the reference takes off
        its accelerator)."""
        if not (self._use_routed() and _on_card(self.data.vals)):
            return "csr_fallback"
        if self._matrix_prog(mode)[0] is None:
            return "csr_fallback"
        return "routed_panel" if panel else "routed"

    def _routed_apply_matrix(self, M, mode: str, panel: bool):
        """The routed matrix apply, or None where the CSR path serves it."""
        if self.matrix_path(mode, panel) == "csr_fallback":
            return None
        from .routed import RoutedTranspose, routed_matmat, routed_rmatmat

        prog, conj_vals, conj_io = self._matrix_prog(mode)
        apply_fn = routed_matmat
        if isinstance(prog, RoutedTranspose):
            apply_fn = routed_rmatmat
            if conj_vals and prog.vals_pre.is_complex():
                prog = prog._replace(vals_pre=prog.vals_pre.conj_physical())
        elif conj_vals and prog.vals.is_complex():
            prog = prog._replace(vals=prog.vals.conj_physical())
        X = _conj(M) if conj_io else M
        Y = apply_fn(prog, X, panel=panel)
        return _conj(Y) if conj_io else Y

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        if not self._routed_ready():
            return super().apply_matrix(M, mode)
        return self._routed_graph(M, (mode, "mat"))

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row-panel apply, (k, n) in, (k, m) out: the routed pipeline's own
        layout on both ends."""
        if Mt.ndim != 2 or Mt.shape[1] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        if not self._routed_ready():
            return super().apply_matrix(Mt.t(), mode).t()
        return self._routed_graph(Mt, (mode, "panel"))

    def _name(self):
        return "Routed CSR sparse operator"


# reference backend names, so reference call sites port unchanged
_BACKEND_ALIASES = {"pallas": "kernel", "pallas_fast": "kernel", "xla": "torch"}


def _plan_tensor(a, device):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


class BSROperator(_SparseBase):
    """Block-sparse-row operator.

    Backends (``backend=``):

    - ``"auto"`` (default): f32 or bf16 blocks on a CUDA device, with an f32
      or bf16 result, run the hand-written kernels; anything else (CPU
      tensors, f64, complex) runs their plain PyTorch versions.
    - ``"kernel"`` (aliases ``"pallas"``, ``"pallas_fast"``): always the
      kernels; raises where they cannot run (off CUDA, other dtypes).
    - ``"torch"`` (alias ``"xla"``): the plain K1/K2 versions, no windows.

    Window plans (large x): when ``backend != "torch"``, (``backend !=
    "auto"`` or bm < 128) and the padded x holds more than
    ``BSR_PALLAS_MAX_X_ELEMS`` values, construction pads nbrow to
    ``bsr_row_pad`` (zero blocks at block column 0) and plans, as the
    reference does: a banded plan (``win_q``, ``cols_local``: forward K3,
    transpose K4), else a multi-window plan (``win_q`` (W, ngroups),
    ``cols_local`` None: forward K5) with a monotone-lane transpose plan
    (``win_q_t``, ``win_valid_t``: K6) when one exists. Without a transpose
    plan the transpose runs K2, which has no size bound on the card; with no
    plan at all, K1/K2 run as for small x. CPU tensors take the plain
    version of the same branch. A plan can also be passed in (the
    reference's keyword arguments), e.g. one carried over by
    ``convert.bsr_operator_from_reference``.

    Block applies (``apply_matrix``, (n, k); ``apply_matrix_t``, (k, n)),
    as the reference's vmapped vector apply runs them, one pass over the
    blocks for all k columns: N on the card in one launch of the plan's
    forward panel (K1p, K3p or K5p), elsewhere with the gather and einsum of
    ``bsr_matmat`` (the reference's N block); T and H (real blocks) in one
    launch of the plan's panel transpose (K2p, K4p or K6p; their plain
    versions on the CPU, and for complex blocks, H on the conjugate); C as
    conj(N(conj M)). A symmetric (hermitian) operator's T (H) block is its
    N block, as ``apply`` maps the modes, on the plan's forward panel (its
    plain version off the card), as the reference's vmapped T apply runs its
    forward kernel. ``torch.func.vmap`` of a vector apply in any mode runs
    the block apply of that mode once, on the vectors as a row panel.

    Construction builds K2's column plan, K5's lane rows for a multi
    plan and, with a transpose plan, K4's slot index or K6's column plan,
    on the data's device, once. Data padded by the reference (extra zero block rows at
    block column 0) is accepted: applies truncate to ``shape``.
    """

    _fields_tensors = ("data", "col_plan", "win_q", "cols_local", "win_q_t",
                       "win_valid_t", "lane_rows", "t_perm", "t_ptr", "t_plan")
    _fields_static = ("_symmetric", "_hermitian", "_backend", "_wb", "_x_pad_blocks",
                      "_x_pad_blocks_t")
    _fields_derived = ("_plain_t_plan",)
    _fields_index = ("col_plan", "lane_rows", "t_perm", "t_ptr", "t_plan")

    def __init__(self, data: BSR, symmetric: bool = False, hermitian: bool = False,
                 backend: str = "auto", win_q=None, cols_local=None, win_q_t=None,
                 win_valid_t=None, _wb: int = 0, _x_pad_blocks: int = 0,
                 _x_pad_blocks_t: int = 0):
        # the kernels take contiguous storage; a no-op for contiguous data
        data = data._replace(blocks=data.blocks.contiguous(),
                             block_cols=data.block_cols.contiguous())
        super().__init__(data, symmetric, hermitian)
        backend = _BACKEND_ALIASES.get(backend, backend)
        if backend not in ("auto", "kernel", "torch"):
            raise ValueError(f"unknown BSR backend {backend!r}")
        self._backend = backend
        blocks, cols = data.blocks, data.block_cols
        if blocks.ndim != 4 or tuple(cols.shape) != tuple(blocks.shape[:2]):
            raise LinearOperatorException(
                f"BSR blocks must be (nbrow, kmax, bm, bn) and block_cols "
                f"(nbrow, kmax); got {tuple(blocks.shape)}, {tuple(cols.shape)}")
        if cols.dtype != torch.int32:
            raise LinearOperatorException(f"BSR block_cols must be int32, got {cols.dtype}")
        nrow, ncol = data.shape
        bm, bn = data.block_shape
        if blocks.shape[0] * bm < nrow:
            raise LinearOperatorException(f"BSR has {blocks.shape[0]} block rows of {bm}, "
                                          f"fewer than shape[0]={nrow}")
        nbcol = self._nbcol
        if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= nbcol):
            raise LinearOperatorException(f"BSR block_cols must lie in [0, {nbcol})")
        dev = blocks.device
        self.win_q = _plan_tensor(win_q, dev)
        self.cols_local = _plan_tensor(cols_local, dev)
        self.win_q_t = _plan_tensor(win_q_t, dev)
        self.win_valid_t = _plan_tensor(win_valid_t, dev)
        self._wb, self._x_pad_blocks = int(_wb), int(_x_pad_blocks)
        self._x_pad_blocks_t = int(_x_pad_blocks_t)
        maybe_kernel = backend != "torch" and (backend != "auto" or bm < 128)
        given = any(a is not None for a in (win_q, cols_local, win_q_t, win_valid_t))
        if not given and maybe_kernel and nbcol * bn > K.BSR_PALLAS_MAX_X_ELEMS:
            self._plan()
        self._check_plan()
        self._build_index()

    def _build_index(self):
        """K2's column plan, K5's lane rows, K4's slot index and K6's column
        plan from the block columns and the window plan; the plain
        transpose's segment plan is dropped, to be built at its next use."""
        d = self.data
        bm, bn = d.block_shape
        self.col_plan = bsr_column_plan(d.block_cols, self._nbcol,
                                        bm * bn * d.blocks.element_size())
        self._plain_t_plan = None
        self.lane_rows = self.t_perm = self.t_ptr = self.t_plan = None
        if self.win_q is not None and self.cols_local is None:
            self.lane_rows = K.bsr_multiwin_index(d.block_cols, self.win_q, self._wb)
        if self.win_q is not None and self.cols_local is not None:
            self.t_perm, self.t_ptr = K.bsr_window_t_index(self.cols_local, self.win_q, self._wb)
        elif self.win_q_t is not None:
            self.t_plan = K.bsr_multiwin_t_plan(d.block_cols, self.win_q_t, self.win_valid_t,
                                                self._wb, self._nbcol,
                                                bm * bn * d.blocks.element_size())

    def _plan(self):
        """Pad nbrow and plan windows as the reference's constructor does
        (``linops_tpu/sparse/ops.py:613-702``); leaves no plan when none fits."""
        d = self.data
        bm, bn = d.block_shape
        kmax = d.blocks.shape[1]
        itemsize = d.blocks.element_size()
        pad = (-d.blocks.shape[0]) % K.bsr_row_pad(bm, kmax, bn, itemsize)
        if pad:
            self.data = d = d._replace(
                blocks=torch.nn.functional.pad(d.blocks, (0, 0, 0, 0, 0, 0, 0, pad)),
                block_cols=torch.nn.functional.pad(d.block_cols, (0, 0, 0, pad)))
        nbrow, nbcol = d.blocks.shape[0], self._nbcol
        R = K.bsr_window_rows(bm, kmax, bn, itemsize, nbrow)
        cols = d.block_cols.cpu().numpy()
        # the live module constant governs (tests shrink it); the forward
        # kernels stage 2 windows of bn values, at most 4 bytes each
        wb_max = min(K.BSR_PALLAS_MAX_WINDOW_BLOCKS, K.WINDOW_SMEM_LIMIT // (2 * bn * 4))
        plan = K.bsr_window_plan(cols, R, nbcol, wb_max=wb_max, blocks=d.blocks)
        dev = d.blocks.device
        if plan is not None:
            q, cl, wb, xpb = plan
            self.win_q, self.cols_local = _plan_tensor(q, dev), _plan_tensor(cl, dev)
            self._wb, self._x_pad_blocks = wb, xpb
            return
        planm = K.bsr_window_plan_multi(cols, R, nbcol, wb_max=wb_max, blocks=d.blocks)
        if planm is None:
            return
        qm, wb, xpb = planm
        if qm.shape[0] * wb * bn * 4 > K.WINDOW_SMEM_LIMIT:
            return  # wide blocks: the W windows would not fit shared memory
        self.win_q, self._wb, self._x_pad_blocks = _plan_tensor(qm, dev), wb, xpb
        # the transpose's lane count is independent of the forward's W: when
        # W lanes cannot be made monotone, more (up to the cap) often can
        for Wt in sorted({int(qm.shape[0]), K.BSR_PALLAS_MAX_WINDOWS}):
            plant = K.bsr_window_plan_multi_t(cols, R, nbcol, wb, Wt, blocks=d.blocks)
            if plant is not None:
                qt, vt, xpbt = plant
                self.win_q_t, self.win_valid_t = _plan_tensor(qt, dev), _plan_tensor(vt, dev)
                self._x_pad_blocks_t = xpbt
                return

    def _check_plan(self):
        """A plan passed in (or made) must fit the blocks."""
        if self.win_q is None:
            if self.cols_local is not None or self.win_q_t is not None:
                raise LinearOperatorException("a BSR window plan needs win_q")
            return
        nbrow = self.data.blocks.shape[0]
        ngroups = self.win_q.shape[-1]
        if self._wb <= 0 or ngroups == 0 or nbrow % ngroups:
            raise LinearOperatorException(
                f"BSR window plan: wb={self._wb}, {ngroups} groups for nbrow={nbrow}")
        if self.cols_local is not None:
            if self.win_q.dim() != 1 or self.cols_local.shape != self.data.block_cols.shape:
                raise LinearOperatorException("BSR banded plan: win_q must be (ngroups,) and "
                                              "cols_local shaped like block_cols")
        elif self.win_q.dim() != 2:
            raise LinearOperatorException("BSR multi-window plan: win_q must be (W, ngroups)")
        if self.win_q_t is not None and (self.win_valid_t is None
                                         or self.win_q_t.shape != self.win_valid_t.shape
                                         or self.win_q_t.shape[1] != ngroups):
            raise LinearOperatorException("BSR transpose plan: win_q_t and win_valid_t must "
                                          "both be (W, ngroups)")

    @property
    def _nbcol(self) -> int:
        return -(-self.data.shape[1] // self.data.block_shape[1])

    @property
    def dtype(self):
        return self.data.blocks.dtype

    @property
    def nnz(self) -> int:
        """Stored (padded) values."""
        return self.data.blocks.numel()

    def _windowed(self, transpose: bool) -> bool:
        """The apply takes a window kernel (or its plain version)."""
        if self.win_q is None or self._backend == "torch":
            return False
        return not transpose or self.cols_local is not None or self.win_q_t is not None

    def _kernel_fits(self, vec) -> bool:
        """Whether an apply to ``vec`` takes a kernel (and so no summation
        plan): a backend that allows one, blocks and vector on a CUDA device,
        dtypes the kernels take."""
        blocks = self.data.blocks
        return (self._backend != "torch" and blocks.is_cuda and vec.is_cuda
                and kernel_dtypes(blocks.dtype, vec.dtype) is not None)

    def _use_kernel(self, vec) -> bool:
        fits = self._kernel_fits(vec)
        if self._backend == "kernel" and not fits:
            raise LinearOperatorException(
                f"backend='kernel' needs f32/bf16 blocks and vectors on a CUDA "
                f"device; got blocks {self.data.blocks.dtype} on "
                f"{self.data.blocks.device}, vector {vec.dtype} on {vec.device}")
        return fits

    @staticmethod
    def _pad_to(v, need: int):
        if v.shape[0] < need:
            v = torch.nn.functional.pad(v, (0, need - v.shape[0]))
        return v

    def _prod(self, v):
        blocks = self.data.blocks
        if self._use_kernel(v) and kernel_graph_wanted(v, blocks):
            return KernelApply.apply(self, ("N", "vec"), v, blocks)
        return self._prod_impl(blocks, v)

    def _prod_impl(self, blocks, v):
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = blocks.shape[0], self._nbcol
        xb = self._pad_to(v, nbcol * bn).reshape(nbcol, bn)
        kern = self._use_kernel(v)
        if self._windowed(transpose=False):
            plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks)
            if self.cols_local is not None:
                f = K.bsr_matvec_windowed_kernel if kern else K.bsr_matvec_windowed_plain
                y = f(blocks, self.cols_local, self.win_q, xb, **plan)
            else:
                if kern:
                    y = K.bsr_matvec_multiwin_kernel(blocks, d.block_cols, self.win_q, xb,
                                                     index=self.lane_rows, **plan)
                else:
                    y = K.bsr_matvec_multiwin_plain(blocks, d.block_cols, self.win_q, xb, **plan)
        elif kern:
            y = bsr_matvec_kernel(blocks, d.block_cols, xb)
        else:
            y = bsr_matvec(blocks, d.block_cols, xb)
        return y.reshape(nbrow * bm)[: d.shape[0]]

    def _tprod_impl(self, blocks, u):
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = blocks.shape[0], self._nbcol
        ub = self._pad_to(u, nbrow * bm).reshape(nbrow, bm)
        kern = not blocks.is_complex() and self._use_kernel(u)
        if self._windowed(transpose=True):
            if self.cols_local is not None:
                plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks, nbcol=nbcol)
                if kern:
                    x = K.bsr_rmatvec_windowed_kernel(blocks, self.cols_local, self.win_q, ub,
                                                      index=(self.t_perm, self.t_ptr), **plan)
                else:
                    x = K.bsr_rmatvec_windowed_plain(blocks, self.cols_local, self.win_q, ub,
                                                     sum_plan=self.plain_transpose_plan(),
                                                     **plan)
            else:
                plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks_t, nbcol=nbcol)
                args = (blocks, d.block_cols, self.win_q_t, self.win_valid_t, ub)
                if kern:
                    x = K.bsr_rmatvec_multiwin_kernel(*args, index=self.t_plan, **plan)
                else:
                    x = K.bsr_rmatvec_multiwin_plain(*args, sum_plan=self.plain_transpose_plan(),
                                                     **plan)
        elif kern:
            x = bsr_rmatvec_kernel(blocks, d.block_cols, ub, nbcol, plan=self.col_plan)
        else:
            x = bsr_rmatvec(blocks, d.block_cols, ub, nbcol, plan=self.plain_transpose_plan())
        return x.reshape(nbcol * bn)[: d.shape[1]]

    def _build_derived(self):
        # the plain K2/K4/K6 read their summation order; the kernels, which a
        # solve's vectors (of the blocks' device and dtype) take, do not
        if not self._kernel_fits(self.data.blocks):
            self.plain_transpose_plan()

    def plain_transpose_plan(self) -> SegmentPlan:
        """The summation order of the plain transpose this operator takes
        (plain K2, K4 or K6): built at its first use and kept."""
        if self._plain_t_plan is None:
            d, nbcol = self.data, self._nbcol
            if not self._windowed(transpose=True):
                plan = segment_plan(d.block_cols, nbcol)
            elif self.cols_local is not None:
                plan = K.bsr_rmatvec_windowed_plan(self.cols_local, self.win_q, wb=self._wb,
                                                   x_pad_blocks=self._x_pad_blocks)
            else:
                plan = segment_plan(d.block_cols, max(self._x_pad_blocks_t, nbcol))
            self._plain_t_plan = plan
        return self._plain_t_plan

    def _tprod(self, u):
        blocks = self.data.blocks
        if not blocks.is_complex() and self._use_kernel(u) and kernel_graph_wanted(u, blocks):
            return KernelApply.apply(self, ("T", "vec"), u, blocks)
        return self._tprod_impl(blocks, u)

    def _ctprod(self, w):
        if not self.data.blocks.is_complex():
            return self._tprod(w)
        return self._tprod_impl(self.data.blocks.conj(), w)

    def _kernel_apply(self, x, how, tensors):
        """The apply of x in ``how`` = (mode, kind) with ``tensors`` =
        (blocks,): for a vector (kind ``"vec"``) K1/K3/K5 for N, K2/K4/K6 for
        T on the card (their plain versions on the CPU); for a block (kind
        ``"mat"``, columns, or ``"panel"``, rows) the N block (K1p/K3p/K5p
        on the card, ``bsr_matmat`` elsewhere) or the T block
        (K2p/K4p/K6p); ``KernelApply`` runs it."""
        mode, kind = how
        (blocks,) = tensors
        if kind != "vec":
            if mode == "N":
                return self._nmat_impl(blocks, x, kind)
            if mode == "C":
                return _conj(self._nmat_impl(blocks, _conj(x), kind))
            return self._tmat_impl(blocks if mode == "T" else _conj(blocks), x, kind)
        if mode == "N":
            return self._prod_impl(blocks, x)
        if mode == "T":
            return self._tprod_impl(blocks, x)
        if mode == "H":
            return self._tprod_impl(_conj(blocks), x)
        return _conj(self._prod_impl(blocks, _conj(x)))

    def _slot_columns(self, transpose: bool):
        """Per block slot, what the apply in this direction reads or writes:
        (block column (nbrow, kmax), weight (nbrow, kmax) or None for 1, the
        block rows of the padded x or output). The windowed kernels and
        their panel forms address columns through their plan (K3/K4: window
        base + local column, 0 outside both windows; K5/K6: the block
        column, once per lane window that holds it)."""
        d = self.data
        if not self._windowed(transpose):
            return d.block_cols.long(), None, self._nbcol
        if self.cols_local is not None:
            gcols, inside = K._windowed_cols(self.cols_local, self.win_q, self._wb)
            return gcols, inside, self._x_pad_blocks
        if transpose:
            weight = K._lane_weights(d.block_cols, self.win_q_t, self._wb, valid=self.win_valid_t)
            return d.block_cols.long(), weight, max(self._x_pad_blocks_t, self._nbcol)
        return (d.block_cols.long(), K._lane_weights(d.block_cols, self.win_q, self._wb),
                self._x_pad_blocks)

    def _kernel_tensor_grads(self, x, g, how, tensors):
        """The blocks' gradient for ``KernelApply``: ``g[r] ⊗ x[col[r,k]]`` for
        mode N and ``x[r] ⊗ g[col[r,k]]`` for T, summed over the columns j of
        a block (``Σ_j x[r, j] ⊗ g[col[r,k], j]``), conjugated as torch's
        convention asks for C and H, each slot weighted as the apply weighs
        it, padding slots included: what autograd of the plain version
        gives. Each slot is written once (deterministic); a gather and a
        batched outer product in plain torch, in the blocks' dtype."""
        mode, kind = how
        (blocks,) = tensors
        bm, bn = self.data.block_shape
        nbrow = blocks.shape[0]
        transpose = mode_transposed(mode)
        cols, weight, xrows = self._slot_columns(transpose)
        rows_vec, cols_vec = (x, g) if transpose else (g, x)
        acc = torch.promote_types(torch.promote_types(blocks.dtype, g.dtype), torch.float32)

        def columns(v, rows):  # (rows, k): a vector as one column, a row panel transposed
            v = v[:, None] if kind == "vec" else (v.t() if kind == "panel" else v)
            return K._pad_rows(v, rows)

        rv = columns(rows_vec, nbrow * bm).reshape(nbrow, bm, -1).to(acc)
        cv = columns(cols_vec, xrows * bn).reshape(xrows, bn, -1)[cols].to(acc)
        if weight is not None:
            cv = cv * weight[..., None, None].to(acc)
        grad = torch.einsum("rmj,rknj->rkmn", rv, _conj(cv))
        if transpose != mode_conjugated(mode):
            grad = _conj(grad)
        return (grad.to(blocks.dtype),)

    # torch.func.vmap over a vector apply runs the block apply of its mode
    # once, on the B vectors as a row panel (``KernelApply.vmap``): the
    # forward panel for N (and C), the panel transpose for T (and H)
    _kernel_batch_kind = "panel"

    def apply_matrix(self, M, mode: str = "N"):
        """Column block (n, k) → (m, k): see the class docstring."""
        self._check_mat(M, mode)
        return self._block_apply(M, mode, "mat")

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """Row panel (k, n) → (k, m), the same block apply on its rows."""
        if getattr(Mt, "ndim", 2) != 2 or Mt.shape[1] != self.in_dim(mode):
            raise LinearOperatorException("shape mismatch")
        return self._block_apply(Mt, mode, "panel")

    def _block_apply(self, X, mode: str, kind: str):
        """A block apply of kind ``"mat"`` or ``"panel"`` (``_kernel_apply``),
        through ``KernelApply`` where a panel kernel runs and the graph is
        wanted. A symmetric T (hermitian H) block is the N block on the
        plan's forward panel (``folded``), as the reference's vmapped apply
        runs it."""
        folded = (mode == "T" and self._symmetric) or (mode == "H" and self._hermitian)
        if folded:
            mode = "N"
        blocks = self.data.blocks
        if mode_transposed(mode) and not blocks.is_complex():
            mode = "T"  # H of real blocks
        kern = not blocks.is_complex() and self._use_kernel(X)
        if kern and kernel_graph_wanted(X, blocks):
            return KernelApply.apply(self, (mode, kind), X, blocks)
        if folded and not kern:
            return self._nmat_impl(blocks, X, kind, planned=True)
        return self._kernel_apply(X, (mode, kind), (blocks,))

    def _nmat_impl(self, blocks, X, kind: str, planned: bool = False):
        """The N block for every column (a row panel goes in as its
        transposed view and comes out in rows: no copy unless it is padded).
        On the card one launch of the plan's forward panel (K1p, K3p or
        K5p), as the reference's vmapped vector apply runs its forward
        kernel; elsewhere ``bsr_matmat``'s gather and einsum, the
        reference's N block, or with ``planned`` (a symmetric T or hermitian
        H block, the reference's vmapped apply) the plain version of the
        plan's forward panel."""
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = blocks.shape[0], self._nbcol
        rows = kind == "panel"
        M = K._pad_rows(X.t() if rows else X, nbcol * bn)
        k = M.shape[1]
        kern = not blocks.is_complex() and self._use_kernel(X)
        if (kern or planned) and self._windowed(transpose=False):
            plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks)
            if self.cols_local is not None:
                args = (blocks, self.cols_local, self.win_q)
                Y = (K.bsr_matmat_windowed_kernel(*args, M, **plan) if kern else
                     K._fwd_plain(K.bsr_matvec_windowed_plain, M, bn, *args, **plan))
            elif kern:
                Y = K.bsr_matmat_multiwin_kernel(blocks, d.block_cols, self.win_q, M,
                                                 index=self.lane_rows, **plan)
            else:
                Y = K._fwd_plain(K.bsr_matvec_multiwin_plain, M, bn, blocks, d.block_cols,
                                 self.win_q, **plan)
        elif kern:
            Y = K.bsr_matmat_kernel(blocks, d.block_cols, M)
        else:
            Y = bsr_matmat(blocks, d.block_cols, M.reshape(nbcol, bn, k)).reshape(nbrow * bm, k)
        Y = Y[: d.shape[0]]
        return Y.t() if rows else Y

    def _tmat_impl(self, blocks, X, kind: str):
        """The T block: one call of the plan's panel transpose (K2p, K4p or
        K6p on the card, its plain version otherwise) for every column; on
        the card a one-column block takes the vector kernel (K2, K4 or K6),
        the same bits (the panels are slower for one column on the H100:
        PERF.md §6). A row panel goes in as its transposed view and the
        kernel writes it out in rows (the wrappers lay the result out as
        U): no copy unless it is padded."""
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = blocks.shape[0], self._nbcol
        rows = kind == "panel"
        U = K._pad_rows(X.t() if rows else X, nbrow * bm)
        kern = not blocks.is_complex() and self._use_kernel(X)
        if kern and U.shape[1] == 1:  # the vector kernel: the panel's bits, faster on the card
            out = self._tprod_impl(blocks, U[:, 0])[:, None]
        elif self._windowed(transpose=True):
            if self.cols_local is not None:
                plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks, nbcol=nbcol)
                args = (blocks, self.cols_local, self.win_q, U)
                if kern:
                    out = K.bsr_rmatmat_windowed_kernel(*args, index=(self.t_perm, self.t_ptr),
                                                        **plan)
                else:
                    out = K.bsr_rmatmat_windowed_plain(*args, sum_plan=self.plain_transpose_plan(),
                                                       **plan)
            else:
                plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks_t, nbcol=nbcol)
                args = (blocks, d.block_cols, self.win_q_t, self.win_valid_t, U)
                if kern:
                    out = K.bsr_rmatmat_multiwin_kernel(*args, index=self.t_plan, **plan)
                else:
                    out = K.bsr_rmatmat_multiwin_plain(*args, sum_plan=self.plain_transpose_plan(),
                                                       **plan)
        elif kern:
            out = K.bsr_rmatmat_kernel(blocks, d.block_cols, U, nbcol, plan=self.col_plan)
        else:
            out = K.bsr_rmatmat_plain(blocks, d.block_cols, U, nbcol,
                                      plan=self.plain_transpose_plan())
        out = out[: d.shape[1]]
        return out.t() if rows else out

    def _name(self):
        return "BSR sparse operator"


# ----------------------------------------------------------------------------
# Factory
# ----------------------------------------------------------------------------

# largest tile first: on equal stored bytes the bigger tile streams faster
_BSR_AUTO_CANDIDATES = ((128, 128), (32, 128), (16, 128), (8, 128))

# format="auto" picks the Clos-routed layout for unstructured patterns up to
# ROUTED_AUTO_MAX_NNZ, announcing the host pack above ROUTED_AUTO_WARN_NNZ;
# beyond the cap it falls to the CSR gather path with a warning. The
# reference's thresholds, so both packages choose alike.
ROUTED_AUTO_WARN_NNZ = 4_000_000
ROUTED_AUTO_MAX_NNZ = 32_000_000


def _itemsize(dtype, fallback) -> int:
    if dtype is None:
        return np.dtype(fallback).itemsize
    return torch.empty((), dtype=dtype).element_size() if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype).itemsize


def _auto_block_shape(sp, return_stored: bool = False, dtype=None):
    """The BSR block shape whose padded storage streams the fewest bytes
    (the reference's rule, native block counter; (8, 128) without it). bm
    below the reference's storage tile (8 rows for 4-byte, 16 for 2-byte
    values) is charged the whole tile, as the reference charges it, so both
    packages pick the same shape."""
    from .. import native

    if not native.available():
        return ((8, 128), None) if return_stored else (8, 128)
    itemsize = _itemsize(dtype, sp.data.dtype)
    native_sublanes = 8 * max(4 // itemsize, 1)
    best, best_cost, best_stored = (8, 128), None, None
    nrow = sp.shape[0]
    for bm, bn in _BSR_AUTO_CANDIDATES:
        kmax, _ = native.bsr_count(sp.indices, sp.indptr, nrow, (bm, bn))
        stored = -(-nrow // bm) * max(kmax, 1) * bm * bn
        cost = stored * itemsize * max(native_sublanes / bm, 1.0)
        if best_cost is None or cost < best_cost:
            best, best_cost, best_stored = (bm, bn), cost, stored
    return (best, best_stored) if return_stored else best


def _to_dtype(t, dtype):
    return t if dtype is None else t.to(dtype)


def _bsr_from_scipy(sp, block_shape, dtype):
    """The native packer's BSR of a scipy CSR matrix (CPU tensors)."""
    from .. import native

    vals = sp.data
    blocks, bcols = native.bsr_pack_csr(
        vals, sp.indices, sp.indptr, sp.shape[0], sp.shape[1], block_shape,
        pad_rows_to=K.bsr_row_pad(block_shape[0], bn=block_shape[1],
                                  itemsize=_itemsize(dtype, vals.dtype)))
    return BSR(_to_dtype(torch.from_numpy(blocks), dtype), torch.from_numpy(bcols),
               (int(sp.shape[0]), int(sp.shape[1])))


def opSparse(
    A,
    format: str = "csr",
    block_shape: Union[Tuple[int, int], str] = (8, 128),
    symmetric: bool = False,
    hermitian: bool = False,
    tol: float = 0.0,
    backend: str = "auto",
    dtype=None,
    w="auto",
    reorder=None,
    device=None,
):
    """A sparse operator from a dense array, a scipy sparse matrix or a
    prebuilt COO/CSR/ELL/BSR. ``format`` in {'coo', 'csr', 'ell', 'bsr',
    'routed', 'auto'}; ``block_shape="auto"`` picks the BSR tile that stores
    the fewest bytes; ``format="auto"`` sends block-structured patterns to
    BSR and scattered ones to the Clos-routed pipeline ('routed', ``w`` the
    row-slot width); ``backend`` selects the BSR apply (see
    ``BSROperator``); ``dtype`` (a
    torch dtype) the stored value type. A scipy matrix goes to BSR or to the
    routed layout through the host packers (no dense intermediate).
    ``reorder="rcm"`` (square matrices) builds ``Pᵀ·op(A[perm][:, perm])·P``
    with a reverse-Cuthill-McKee permutation (``sparse/reorder.py``).

    The operator lands on ``device``: the CUDA device by default,
    ``device="cpu"`` for the CPU; without a card and without ``device`` it
    raises. A prebuilt format keeps its tensors' device unless ``device`` is
    given."""
    prebuilt = isinstance(A, (COO, CSR, ELL, BSR))
    dev = None if prebuilt and device is None else default_device(device, "opSparse")
    if reorder is not None:
        if reorder != "rcm":
            raise ValueError(f"unknown reorder {reorder!r} (only 'rcm')")
        from .reorder import rcm_reordered_operator

        if not hasattr(A, "tocsr"):
            import scipy.sparse as sps

            if prebuilt:
                raise LinearOperatorException(
                    "reorder='rcm' takes a scipy sparse matrix or a dense array "
                    "(the permutation is computed on the host)")
            Ad = np.asarray(A)
            if tol > 0:
                Ad = np.where(np.abs(Ad) > tol, Ad, 0.0)
            A = sps.csr_matrix(Ad)
        return rcm_reordered_operator(A.tocsr(), dict(
            format=format, block_shape=block_shape, symmetric=symmetric, hermitian=hermitian,
            tol=tol, backend=backend, dtype=dtype, w=w), device=dev)
    if prebuilt:
        if dtype is not None:
            A = (A._replace(blocks=A.blocks.to(dtype)) if isinstance(A, BSR)
                 else A._replace(vals=A.vals.to(dtype)))
        if dev is not None:
            A = _move(A, dev)
        if isinstance(A, COO):
            return COOOperator(A, symmetric, hermitian)
        if isinstance(A, CSR):
            if format == "routed":
                return RoutedCSROperator(A, symmetric, hermitian, w=w)
            return CSROperator(A, symmetric, hermitian)
        if isinstance(A, ELL):
            return ELLOperator(A, symmetric, hermitian)
        return BSROperator(A, symmetric, hermitian, backend=backend)

    # the format functions below stage on the host (device="cpu"); on_dev casts to the
    # asked dtype there and uploads once
    def on_dev(data):
        field = "blocks" if isinstance(data, BSR) else "vals"
        data = data._replace(**{field: _to_dtype(getattr(data, field), dtype)})
        return _move(data, dev)

    if format == "auto" and not hasattr(A, "tocsr"):
        import scipy.sparse as sps

        Ad = np.asarray(A)
        if tol > 0:  # honour tol like every other dense path
            Ad = np.where(np.abs(Ad) > tol, Ad, 0.0)
        A = sps.csr_matrix(Ad)

    if hasattr(A, "tocsr"):  # scipy sparse
        sp = A.tocsr()
        if format == "auto":
            shape_best, stored = _auto_block_shape(sp, return_stored=True, dtype=dtype)
            itemsize = _itemsize(dtype, sp.data.dtype)
            if stored is not None and stored * itemsize < sp.nnz * (itemsize + 8):
                format, block_shape = "bsr", shape_best
            elif 0 < sp.nnz <= ROUTED_AUTO_MAX_NNZ:
                format = "routed"
                if sp.nnz > ROUTED_AUTO_WARN_NNZ:
                    import warnings

                    warnings.warn(
                        f"opSparse(format='auto'): unstructured pattern with {sp.nnz} nnz "
                        f"routes through the Clos pipeline, which first packs a routing "
                        f"program on the host (a one-time cost that grows with nnz). Pass "
                        f"format='csr' to skip packing, or reorder='rcm' if the pattern is "
                        f"bandable.", stacklevel=2)
            else:
                format = "csr"
                if sp.nnz > ROUTED_AUTO_MAX_NNZ:
                    import warnings

                    warnings.warn(
                        f"opSparse(format='auto'): {sp.nnz} nnz exceeds the auto-routing cap "
                        f"({ROUTED_AUTO_MAX_NNZ}); using the gather + segment-sum CSR path. "
                        f"Pass format='routed' to pack anyway, or reorder='rcm' if the "
                        f"pattern is bandable.", stacklevel=2)
        if format in ("csr", "routed"):
            data = on_dev(csr_from_parts(sp.data, sp.indices, sp.indptr, sp.shape,
                                         device="cpu"))
            if format == "csr":
                return CSROperator(data, symmetric, hermitian)
            return RoutedCSROperator(data, symmetric, hermitian, w=w,
                                     host_parts=(sp.data, sp.indices, sp.indptr))
        if format == "ell":
            return ELLOperator(on_dev(ell_from_csr_parts(sp.data, sp.indices, sp.indptr,
                                                         sp.shape, device="cpu")), symmetric, hermitian)
        if format == "coo":
            sc = sp.tocoo()
            check_int32_range(sc.shape, sc.nnz)
            data = COO(vals=torch.from_numpy(np.array(sc.data)),
                       rows=torch.from_numpy(sc.row.astype(np.int32)),
                       cols=torch.from_numpy(sc.col.astype(np.int32)),
                       shape=(int(sc.shape[0]), int(sc.shape[1])))
            return COOOperator(on_dev(data), symmetric, hermitian)
        if format == "bsr":
            from .. import native

            # the packer takes f32/f64 values; others go through the dense path
            if native.available() and sp.data.dtype in (np.float32, np.float64):
                if block_shape == "auto":
                    block_shape = _auto_block_shape(sp, dtype=dtype)
                return BSROperator(on_dev(_bsr_from_scipy(sp, tuple(block_shape), dtype)),
                                   symmetric, hermitian, backend=backend)
        A = sp.toarray()

    A = np.asarray(A)
    if format == "coo":
        return COOOperator(on_dev(coo_from_dense(A, tol, device="cpu")), symmetric, hermitian)
    if format == "csr":
        return CSROperator(on_dev(csr_from_dense(A, tol, device="cpu")), symmetric, hermitian)
    if format == "routed":
        return RoutedCSROperator(on_dev(csr_from_dense(A, tol, device="cpu")), symmetric,
                                 hermitian, w=w)
    if format == "ell":
        return ELLOperator(on_dev(ell_from_dense(A, tol, device="cpu")), symmetric, hermitian)
    if format == "bsr":
        if block_shape == "auto":
            import scipy.sparse as sps

            return opSparse(sps.csr_matrix(A), format="bsr", block_shape="auto",
                            symmetric=symmetric, hermitian=hermitian, backend=backend,
                            dtype=dtype, device=dev)
        return BSROperator(on_dev(bsr_from_dense(A, block_shape, tol, device="cpu")), symmetric,
                           hermitian, backend=backend)
    raise ValueError(f"unknown sparse format {format!r}")
