"""Sparse linear operators over COO / CSR / ELL / BSR storage, and ``opSparse``.

Counterpart of ``linops_tpu/sparse/ops.py``. Transpose and adjoint products
reuse the same storage; no transposed copy is made.

- COO/CSR: gather plus ``index_add_`` (the reference's gather +
  ``segment_sum``); ELL: gather plus a row sum forward, ``index_add_`` for
  the transpose. Plain PyTorch; no kernel.
- BSR: the hand-written kernels K1-K6 on CUDA (see ``BSROperator``).

The Clos-routed CSR operator (``format="routed"``) and the RCM reorder come
with slice 3 of the port; asking for them raises.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..core.base import LinearOperator, LinearOperatorException, _conj
from ..kernels import bsr_spmv as K
from ..kernels.bsr_spmv import (
    bsr_column_index,
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

__all__ = ["COOOperator", "CSROperator", "ELLOperator", "BSROperator", "opSparse",
           "bsr_matvec", "bsr_rmatvec", "bsr_matmat"]


def coo_matvec(vals, rows, cols, nrow: int, x):
    """y[r] = Σ vals[k]·x[cols[k]] over k with rows[k] = r (x may carry a
    trailing column dimension)."""
    v = vals if x.dim() == 1 else vals[:, None]
    contrib = v * x[cols.long()]
    y = torch.zeros((nrow,) + tuple(x.shape[1:]), dtype=contrib.dtype, device=contrib.device)
    return y.index_add_(0, rows.long(), contrib)


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


class _IndexedSparse(_SparseBase):
    """COO/CSR applies (gather + ``index_add_``)."""

    def _prod(self, v):
        d = self.data
        return coo_matvec(d.vals, d.rows, d.cols, d.shape[0], v)

    def _tprod(self, u):
        d = self.data
        return coo_matvec(d.vals, d.cols, d.rows, d.shape[1], u)

    def _ctprod(self, w):
        d = self.data
        return coo_matvec(_conj(d.vals), d.cols, d.rows, d.shape[1], w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        d = self.data
        if mode == "N":
            return coo_matvec(d.vals, d.rows, d.cols, d.shape[0], M)
        if mode == "C":  # conj(A) M = conj(A conj(M))
            return _conj(coo_matvec(d.vals, d.rows, d.cols, d.shape[0], _conj(M)))
        vals = d.vals if mode == "T" else _conj(d.vals)
        return coo_matvec(vals, d.cols, d.rows, d.shape[1], M)


class COOOperator(_IndexedSparse):
    """Sparse operator over COO storage."""


class CSROperator(_IndexedSparse):
    """Sparse operator over CSR storage (its expanded ``rows`` drive the
    same gather + ``index_add_`` as COO)."""


class ELLOperator(_SparseBase):
    """ELLPACK operator: forward is a gather plus a row sum (no scatter);
    the transpose scatters with ``index_add_``."""

    def _prod(self, v):
        d = self.data
        return torch.sum(d.vals * v[d.cols.long()], dim=1)

    def _tprod_vals(self, vals, u):
        d = self.data
        contrib = (vals * u[:, None]).reshape(-1)
        out = torch.zeros(d.shape[1], dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, d.cols.reshape(-1).long(), contrib)

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
        out = torch.zeros((d.shape[1], M.shape[1]), dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, cols.reshape(-1), contrib)


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

    Construction builds K2's block-column index, K5's lane rows for a multi
    plan and, with a transpose plan, K4/K6's slot index, on the data's
    device, once. Data padded by the reference (extra zero block rows at
    block column 0) is accepted: applies truncate to ``shape``.
    """

    _fields_tensors = ("data", "col_perm", "col_ptr", "win_q", "cols_local", "win_q_t",
                       "win_valid_t", "lane_rows", "t_perm", "t_ptr")
    _fields_static = ("_symmetric", "_hermitian", "_backend", "_wb", "_x_pad_blocks",
                      "_x_pad_blocks_t")

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
        d = self.data
        self.col_perm, self.col_ptr = bsr_column_index(d.block_cols, nbcol)
        self.lane_rows = self.t_perm = self.t_ptr = None
        if self.win_q is not None and self.cols_local is None:
            self.lane_rows = K.bsr_multiwin_index(d.block_cols, self.win_q, self._wb)
        if self.win_q is not None and self.cols_local is not None:
            self.t_perm, self.t_ptr = K.bsr_window_t_index(self.cols_local, self.win_q, self._wb)
        elif self.win_q_t is not None:
            self.t_perm, self.t_ptr = K.bsr_multiwin_t_index(
                d.block_cols, self.win_q_t, self.win_valid_t, self._wb)

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

    def _use_kernel(self, vec) -> bool:
        if self._backend == "torch":
            return False
        on_cuda = self.data.blocks.is_cuda and vec.is_cuda
        fits = kernel_dtypes(self.data.blocks.dtype, vec.dtype) is not None
        if self._backend == "kernel" and not (on_cuda and fits):
            raise LinearOperatorException(
                f"backend='kernel' needs f32/bf16 blocks and vectors on a CUDA "
                f"device; got blocks {self.data.blocks.dtype} on "
                f"{self.data.blocks.device}, vector {vec.dtype} on {vec.device}")
        return on_cuda and fits

    @staticmethod
    def _pad_to(v, need: int):
        if v.shape[0] < need:
            v = torch.nn.functional.pad(v, (0, need - v.shape[0]))
        return v

    def _prod(self, v):
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = d.blocks.shape[0], self._nbcol
        xb = self._pad_to(v, nbcol * bn).reshape(nbcol, bn)
        kern = self._use_kernel(v)
        if self._windowed(transpose=False):
            plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks)
            if self.cols_local is not None:
                f = K.bsr_matvec_windowed_kernel if kern else K.bsr_matvec_windowed_plain
                y = f(d.blocks, self.cols_local, self.win_q, xb, **plan)
            else:
                if kern:
                    y = K.bsr_matvec_multiwin_kernel(d.blocks, d.block_cols, self.win_q, xb,
                                                     index=self.lane_rows, **plan)
                else:
                    y = K.bsr_matvec_multiwin_plain(d.blocks, d.block_cols, self.win_q, xb, **plan)
        elif kern:
            y = bsr_matvec_kernel(d.blocks, d.block_cols, xb)
        else:
            y = bsr_matvec(d.blocks, d.block_cols, xb)
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
                                                     **plan)
            else:
                plan = dict(wb=self._wb, x_pad_blocks=self._x_pad_blocks_t, nbcol=nbcol)
                args = (blocks, d.block_cols, self.win_q_t, self.win_valid_t, ub)
                if kern:
                    x = K.bsr_rmatvec_multiwin_kernel(*args, index=(self.t_perm, self.t_ptr),
                                                      **plan)
                else:
                    x = K.bsr_rmatvec_multiwin_plain(*args, **plan)
        elif kern:
            x = bsr_rmatvec_kernel(blocks, d.block_cols, ub, nbcol,
                                   perm=self.col_perm, colptr=self.col_ptr)
        else:
            x = bsr_rmatvec(blocks, d.block_cols, ub, nbcol)
        return x.reshape(nbcol * bn)[: d.shape[1]]

    def _tprod(self, u):
        return self._tprod_impl(self.data.blocks, u)

    def _ctprod(self, w):
        if not self.data.blocks.is_complex():
            return self._tprod(w)
        return self._tprod_impl(self.data.blocks.conj(), w)

    def apply_matrix(self, M, mode: str = "N"):
        self._check_mat(M, mode)
        if mode != "N":
            return super().apply_matrix(M, mode)
        d = self.data
        bm, bn = d.block_shape
        nbrow, nbcol = d.blocks.shape[0], self._nbcol
        k = M.shape[1]
        M = torch.nn.functional.pad(M, (0, 0, 0, nbcol * bn - M.shape[0]))
        Y = bsr_matmat(d.blocks, d.block_cols, M.reshape(nbcol, bn, k))
        return Y.reshape(nbrow * bm, k)[: d.shape[0]]

    def _name(self):
        return "BSR sparse operator"


# ----------------------------------------------------------------------------
# Factory
# ----------------------------------------------------------------------------

# largest tile first: on equal stored bytes the bigger tile streams faster
_BSR_AUTO_CANDIDATES = ((128, 128), (32, 128), (16, 128), (8, 128))
_SLICE3 = "comes with slice 3 of the PyTorch port (the Clos-routed path)"


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
):
    """A sparse operator from a dense array, a scipy sparse matrix or a
    prebuilt COO/CSR/ELL/BSR. ``format`` in {'coo', 'csr', 'ell', 'bsr',
    'auto'}; ``block_shape="auto"`` picks the BSR tile that stores the
    fewest bytes; ``backend`` selects the BSR apply (see ``BSROperator``);
    ``dtype`` (a torch dtype) the stored value type. A scipy matrix goes to
    BSR through the native packer (no dense intermediate). The result lives
    on the CPU: move it with ``.to(device)``.

    Not ported yet, and raising: ``format="routed"``, ``format="auto"``
    where it would pick the routed layout, and ``reorder="rcm"`` (slice 3).
    ``w`` (the routed slot width) is accepted for call-site parity."""
    del w
    if reorder is not None:
        raise LinearOperatorException(f"opSparse(reorder={reorder!r}) {_SLICE3}")
    if format == "routed":
        raise LinearOperatorException(f"opSparse(format='routed') {_SLICE3}")
    if isinstance(A, (COO, CSR, ELL, BSR)):
        if dtype is not None:
            A = (A._replace(blocks=A.blocks.to(dtype)) if isinstance(A, BSR)
                 else A._replace(vals=A.vals.to(dtype)))
        if isinstance(A, COO):
            return COOOperator(A, symmetric, hermitian)
        if isinstance(A, CSR):
            return CSROperator(A, symmetric, hermitian)
        if isinstance(A, ELL):
            return ELLOperator(A, symmetric, hermitian)
        return BSROperator(A, symmetric, hermitian, backend=backend)

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
            elif sp.nnz > 0:
                raise LinearOperatorException(
                    f"opSparse(format='auto') picks the routed layout for this unstructured "
                    f"pattern, which {_SLICE3}; pass format='csr' or 'bsr'")
            else:
                format = "csr"
        if format == "csr":
            data = csr_from_parts(sp.data, sp.indices, sp.indptr, sp.shape)
            return CSROperator(data._replace(vals=_to_dtype(data.vals, dtype)),
                               symmetric, hermitian)
        if format == "ell":
            data = ell_from_csr_parts(sp.data, sp.indices, sp.indptr, sp.shape)
            return ELLOperator(data._replace(vals=_to_dtype(data.vals, dtype)),
                               symmetric, hermitian)
        if format == "coo":
            sc = sp.tocoo()
            check_int32_range(sc.shape, sc.nnz)
            data = COO(vals=_to_dtype(torch.from_numpy(np.array(sc.data)), dtype),
                       rows=torch.from_numpy(sc.row.astype(np.int32)),
                       cols=torch.from_numpy(sc.col.astype(np.int32)),
                       shape=(int(sc.shape[0]), int(sc.shape[1])))
            return COOOperator(data, symmetric, hermitian)
        if format == "bsr":
            from .. import native

            # the packer takes f32/f64 values; others go through the dense path
            if native.available() and sp.data.dtype in (np.float32, np.float64):
                if block_shape == "auto":
                    block_shape = _auto_block_shape(sp, dtype=dtype)
                return BSROperator(_bsr_from_scipy(sp, tuple(block_shape), dtype),
                                   symmetric, hermitian, backend=backend)
        A = sp.toarray()

    A = np.asarray(A)
    if format == "coo":
        data = coo_from_dense(A, tol)
        return COOOperator(data._replace(vals=_to_dtype(data.vals, dtype)), symmetric, hermitian)
    if format == "csr":
        data = csr_from_dense(A, tol)
        return CSROperator(data._replace(vals=_to_dtype(data.vals, dtype)), symmetric, hermitian)
    if format == "ell":
        data = ell_from_dense(A, tol)
        return ELLOperator(data._replace(vals=_to_dtype(data.vals, dtype)), symmetric, hermitian)
    if format == "bsr":
        if block_shape == "auto":
            import scipy.sparse as sps

            return opSparse(sps.csr_matrix(A), format="bsr", block_shape="auto",
                            symmetric=symmetric, hermitian=hermitian, backend=backend,
                            dtype=dtype)
        data = bsr_from_dense(A, block_shape, tol)
        return BSROperator(data._replace(blocks=_to_dtype(data.blocks, dtype)), symmetric,
                           hermitian, backend=backend)
    raise ValueError(f"unknown sparse format {format!r}")
