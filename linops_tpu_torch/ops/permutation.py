"""Permutation operators, Clos-routed.

Counterpart of ``linops_tpu/ops/permutation.py``. ``x[perm]`` is a
fine-grained gather; a permutation is a static data movement, so it routes
through the same radix-128 Clos network as the unstructured SpMV
(``sparse/routing.py``): 3 or 5 crossbars, each a 128-lane gather (K7, the
last one fused with a width-1 slot sum, K10), with tensor transposes as
the wirings between them.

``opPermutation(rcm_perm)`` conjugates a scattered operator into banded form
(``sparse/reorder.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ad import KernelApply, kernel_graph_wanted
from ..core.base import LinearOperator, LinearOperatorException, default_device, mode_transposed
from ..sparse.routed import _clos_size, _route_and_sum, _route_int8
from ..sparse.routing import RADIX

__all__ = ["PermutationOperator", "opPermutation"]

_TINY = 4 * RADIX  # below this padded size the plain gather routes it


def _build_stages(dest_n: np.ndarray, npad: int, device):
    """Stage arrays routing position j -> dest_n[j], identity on the pad tail,
    as int8 tensors on ``device`` (G1 not folded: the input is runtime data)."""
    dest = np.arange(npad, dtype=np.int64)
    dest[: dest_n.shape[0]] = dest_n
    return tuple(torch.from_numpy(g).to(device) for g in _route_int8(dest))


class PermutationOperator(LinearOperator):
    """``y = x[perm]`` (the row-permutation matrix ``P[i, perm[i]] = 1``).

    Transpose and adjoint applies run a second routing program, for the
    inverse permutation (``Pᵀ = P⁻¹``), packed at the first T/H ``bump``.
    On CUDA, f32/bf16 inputs take the lane-gather kernels; other dtypes and
    CPU tensors run the same stage arrays through ``torch.gather``, and tiny
    instances (padded size below 512) the plain routed gathers everywhere.

    dtype contract: a permutation carries no values; applies keep the input
    dtype. ``dtype`` reports float32 as a placeholder only, as the
    reference's does.
    """

    _fields_tensors = ("stages", "stages_inv", "perm", "perm_inv")
    _fields_static = ("_n", "_npad")

    def __init__(self, perm, device=None):
        super().__init__()
        dev = default_device(device, "PermutationOperator")
        perm = np.asarray(perm, np.int64)
        n = perm.shape[0]
        if not np.array_equal(np.sort(perm), np.arange(n)):
            raise LinearOperatorException("perm is not a permutation")
        self._n = int(n)
        self._npad = int(_clos_size(n))
        # y[i] = x[perm[i]]  <=>  the element at j moves to slot inv[j]
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        self.perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
        self.perm_inv = torch.from_numpy(inv.astype(np.int32)).to(dev)
        self.stages = _build_stages(inv, self._npad, dev)
        # the inverse program is packed at the first T/H bump: forward-only
        # users skip half the pack
        self.stages_inv = None

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return torch.float32  # placeholder: see the dtype contract above

    def _use_kernel(self, x) -> bool:
        return self._npad >= _TINY and x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)

    def _route(self, x, mode: str):
        """x through the forward (mode N) or the inverse (mode T) stages; on
        the kernels through ``KernelApply`` when gradients or a ``torch.func``
        transform need the graph (its backward routes through the other
        stages)."""
        if self._use_kernel(x) and kernel_graph_wanted(x):
            return KernelApply.apply(self, (mode, "vec"), x)
        return self._kernel_apply(x, (mode, "vec"), ())

    def _kernel_apply(self, x, how, tensors=()):
        # a real permutation: C acts like N, H like T
        if mode_transposed(how[0]):
            self._ensure_inverse()
            stages = self.stages_inv
        else:
            stages = self.stages
        xp = torch.nn.functional.pad(x, (0, self._npad - self._n)) if self._n < self._npad else x
        a = _route_and_sum(xp.reshape(-1, RADIX), stages, self._use_kernel(x), g1_folded=False,
                           w=1)
        return a.reshape(-1)[: self._n]

    def _ensure_inverse(self):
        if self.stages_inv is None:
            self.stages_inv = _build_stages(self.perm.cpu().numpy().astype(np.int64),
                                            self._npad, self.perm.device)

    def bump(self, mode: str, n: int = 1):
        # matmat(T/H) lands here too and packs a program its row gather never
        # uses: one wasted pack beats a missing one on the vector path
        if mode in ("T", "H"):
            self._ensure_inverse()
        super().bump(mode, n)

    def _prod(self, v):
        return self._route(v, "N")

    def _tprod(self, u):
        return self._route(u, "T")  # packs the inverse when an apply skipped bump

    def _ctprod(self, w):
        return self._tprod(w)

    def apply_matrix(self, M, mode: str = "N"):
        # a matrix moves whole rows: one row gather. Mode C of a real
        # permutation acts like N.
        idx = self.perm if mode in ("N", "C") else self.perm_inv
        return M[idx.long()]

    def _name(self):
        return "Permutation operator (Clos-routed)"


def opPermutation(perm, device=None) -> PermutationOperator:
    """Permutation operator ``(P x)[i] = x[perm[i]]`` with Clos-routed
    applies, on ``device`` (the CUDA device by default; ``device="cpu"``
    for the CPU)."""
    return PermutationOperator(perm, device=device)
