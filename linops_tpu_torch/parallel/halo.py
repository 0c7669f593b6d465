"""Halo-exchange row-partitioned operators (banded / block-banded SpMV).

Counterpart of ``linops_tpu/parallel/halo.py``: the operator's rows are
partitioned over a 1-D mesh; each rank owns a row slab and needs only its
own x segment plus ``halo`` entries from each neighbour. One apply:

  1. posts the two boundary exchanges (point-to-point, no wrap-around at
     the chain ends: rank 0 has no left neighbour, the last rank no right
     one; their halo terms are zero),
  2. computes the interior product ``A_int @ x_local`` while they are in
     flight (a plain dense product, as the reference's ``pmatmul``),
  3. waits, then adds the halo terms.

Two ``collective-permute`` rounds per apply and no all-gather (counted by
``comm``). A block apply (``apply_matrix`` of an (n, k) column panel,
``apply_matrix_t`` of a (k, n) row panel) is one such exchange of (h, k)
(or (k, h)) strips, as the reference's vmapped apply batches its
``ppermute``s: 2 rounds for any k. Unstructured matrices with general
coupling take ``shard_operator`` instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import LinearOperator, LinearOperatorException, _conj
from ..core.precision import pmatmul
from . import comm

__all__ = ["HaloPartitionedOperator", "banded_partition"]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _mesh_ranks(mesh):
    """Global ranks of the mesh, in mesh order."""
    return [int(r) for r in mesh.mesh.reshape(-1).tolist()]


def _segment(v, mesh, n: int, m: int, dim: int = 0):
    """This rank's length-m piece along ``dim`` of a vector or a panel whose
    ``dim`` has length n: the local piece of a DTensor (redistributed once to
    a split along ``dim`` when it is not one), a slice of a plain tensor
    (which counts as replicated)."""
    if v.ndim not in (1, 2) or dim >= v.ndim or v.shape[dim] != n:
        raise LinearOperatorException(
            f"shape mismatch: expected {n} along dimension {dim}, got {tuple(v.shape)}")
    if comm.is_dtensor(v):
        from torch.distributed.tensor import Shard

        want = [Shard(dim)] * mesh.ndim
        if list(v.placements) != want:
            v = v.redistribute(mesh, want)
        return v.to_local()
    r = mesh.get_local_rank() if mesh.ndim == 1 else _flat_rank(mesh)
    return v.narrow(dim, r * m, m)


def _check_panel(M):
    if M.ndim != 2:
        raise LinearOperatorException(f"a block apply takes a 2-D panel, got {tuple(M.shape)}")


def _split_out(y, mesh, dim: int, shape):
    """This rank's piece ``y`` of a result of global ``shape`` as a DTensor
    split along ``dim`` (the operator's vector layout along a panel's rows
    or columns), for a DTensor input and for a plain one."""
    from torch.distributed.tensor import Shard

    return comm.from_local(y, mesh, [Shard(dim)] * mesh.ndim, shape)


def _mul(A, x, dim: int, transpose: bool):
    """A (Aᵀ with ``transpose``) times a vector or a column panel (``dim``
    0), or times each row of a row panel (``dim`` 1, as ``x Aᵀ``): one dense
    product."""
    if dim == 1:
        return pmatmul(x, A if transpose else A.mT)
    if not transpose:
        return pmatmul(A, x)
    return pmatmul(x, A) if x.ndim == 1 else pmatmul(A.mT, x)


def _present(*pairs):
    """The (tensor, peer) pairs whose peer exists (not past a chain end)."""
    return [(t, peer) for t, peer in pairs if peer is not None]


def _flat_rank(mesh) -> int:
    coord = mesh.get_coordinate()
    rank = 0
    for c, s in zip(coord, mesh.shape):
        rank = rank * s + c
    return rank


def _slab(a, mesh, device):
    """This rank's rows of a host or device (n, k) slab, as a DTensor split
    by rows (each rank keeps its own piece; nothing is sent)."""
    from torch.distributed.tensor import Shard

    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device=device)
    return comm.from_local(t[_row_range(t.shape[0], mesh)].contiguous(), mesh, [Shard(0)],
                           t.shape)


def _row_range(n: int, mesh):
    m = n // mesh.size()
    r = mesh.get_local_rank()
    return slice(r * m, (r + 1) * m)


class HaloPartitionedOperator(LinearOperator):
    """Square operator with rows partitioned over a 1-D mesh and coupling
    bounded by ``halo`` entries into each neighbour segment.

    ``A_int`` is (n_dev·m, m), the stacked per-device interior slabs;
    ``A_left``/``A_right`` are (n_dev·m, h), the neighbour couplings; all
    are split by rows (DTensors: each rank holds its slab). Symmetric iff
    declared (flags are the caller's contract). Vectors are split by rows;
    a plain vector counts as replicated and gets its result split by rows.
    A column panel (n, k) splits by rows and a row panel (k, n) by columns
    likewise; a block apply exchanges the strips of its k columns in one
    batch (2 rounds), in every mode."""

    _fields_tensors = ("A_int", "A_left", "A_right")
    _fields_static = ("_n", "_halo", "_mesh", "_symmetric", "_hermitian")

    def __init__(self, A_int, A_left, A_right, mesh, *, axis: Optional[str] = None,
                 symmetric: bool = False, hermitian: bool = False):
        super().__init__()
        if axis is not None and axis != mesh.mesh_dim_names[0]:
            raise LinearOperatorException(f"mesh has no axis {axis!r}")
        n_dev = mesh.size()
        n = A_int.shape[0]
        if n % n_dev != 0:
            raise LinearOperatorException("rows must divide the mesh axis")
        if A_int.shape[1] != n // n_dev:
            raise LinearOperatorException(
                f"interior slab must be (n, n/n_dev); got {tuple(A_int.shape)}")
        if A_left.shape[0] != n or A_right.shape[0] != n:
            raise LinearOperatorException(
                "neighbor-coupling slabs must have the same row count as A_int")
        if A_left.shape[1] != A_right.shape[1]:
            raise LinearOperatorException(
                f"left/right halo widths differ: {A_left.shape[1]} vs {A_right.shape[1]}")
        dev = _mesh_device(mesh)
        self.A_int = _slab(A_int, mesh, dev)
        self.A_left = _slab(A_left, mesh, dev)
        self.A_right = _slab(A_right, mesh, dev)
        self._n = int(n)
        self._halo = int(A_left.shape[1])
        self._mesh = mesh
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return self.A_int.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def halo(self):
        return self._halo

    @property
    def mesh(self):
        return self._mesh

    def _neighbours(self):
        """(left, right) global ranks, None at the chain ends."""
        ranks = _mesh_ranks(self._mesh)
        r = self._mesh.get_local_rank()
        return (ranks[r - 1] if r > 0 else None,
                ranks[r + 1] if r + 1 < len(ranks) else None)

    def _apply(self, v, dim: int, transpose: bool, conj: bool):
        """A (Aᵀ with ``transpose``) applied to a vector or a column panel
        (``dim`` 0) or to the rows of a row panel (``dim`` 1), between two
        conjugations with ``conj``: the boundary strips of all k columns
        travel in one exchange while the interior product computes."""
        n, m, h = self._n, self._n // self._mesh.size(), self._halo
        dt = torch.promote_types(self.dtype, v.dtype)
        x = _segment(v, self._mesh, n, m, dim).to(dt)
        if conj:
            x = _conj(x)
        A_int, A_left, A_right = (t.to_local().to(dt) for t in (self.A_int, self.A_left,
                                                                 self.A_right))
        strip = (*x.shape[:dim], h, *x.shape[dim + 1:])  # (h,), (h, k) or (k, h)
        left, right = self._neighbours()
        works = []
        if not transpose:
            from_left, from_right = x.new_zeros(strip), x.new_zeros(strip)
            if self._mesh.size() > 1:  # boundary segments travel while the interior computes
                works = comm.exchange(
                    _present((x.narrow(dim, m - h, h), right), (x.narrow(dim, 0, h), left)),
                    _present((from_left, left), (from_right, right)), rounds=2)
            y = _mul(A_int, x, dim, False)  # overlap: no dependence on the exchange
            for w in works:
                w.wait()
            y = y + _mul(A_left, from_left, dim, False) + _mul(A_right, from_right, dim, False)
        else:
            # the own interior transposed, plus this rank's boundary rows feeding
            # the neighbours' couplings (the reference's ``_halo_transpose_body``)
            to_left = _mul(A_left, x, dim, True)    # lands on the left neighbour's tail
            to_right = _mul(A_right, x, dim, True)  # lands on the right neighbour's head
            recv_r, recv_l = x.new_zeros(strip), x.new_zeros(strip)
            if self._mesh.size() > 1:
                works = comm.exchange(_present((to_left, left), (to_right, right)),
                                      _present((recv_r, right), (recv_l, left)), rounds=2)
            y = _mul(A_int, x, dim, True)
            for w in works:
                w.wait()
            y.narrow(dim, 0, h).add_(recv_l)
            y.narrow(dim, m - h, h).add_(recv_r)
        if conj:
            y = _conj(y)
        return _split_out(y, self._mesh, dim, (*v.shape[:dim], n, *v.shape[dim + 1:]))

    def _prod(self, v):
        return self._apply(v, 0, False, False)

    def _tprod(self, u):
        return self._apply(u, 0, True, False)

    def _ctprod(self, w):
        # Aᴴw = conj(Aᵀ conj(w)): the transpose program, two conjugations
        return self._apply(w, 0, True, self.A_int.is_complex())

    def _block(self, M, mode: str, dim: int):
        """A panel in ``mode``: the vector apply's lattice
        (``LinearOperator.apply``), whose transpose here is the operator's
        own, conjugated around it for H."""
        _check_panel(M)
        if mode not in ("N", "T", "C", "H"):
            raise ValueError(f"unknown mode {mode!r}")
        transpose = (mode == "T" and not self.symmetric) or (mode == "H" and not self.hermitian)
        conj = mode == "C" or (mode == "H" and not self.hermitian and self.dtype.is_complex)
        return self._apply(M, dim, transpose, conj)

    def apply_matrix(self, M, mode: str = "N"):
        """(n, k) column panel: one exchange of (h, k) strips for all k
        columns (2 rounds), as the reference's vmapped apply."""
        return self._block(M, mode, 0)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """(k, n) row panel, the result (k, n): one exchange of (k, h)
        strips (2 rounds)."""
        return self._block(Mt, mode, 1)

    def _name(self):
        return f"Halo-partitioned operator (halo={self._halo})"


def banded_partition(A, mesh, halo: Optional[int] = None, *, axis=None,
                     symmetric: bool = False, hermitian: bool = False):
    """Partition a banded square matrix (numpy, or a tensor, the same on
    every rank) into a ``HaloPartitionedOperator`` on the mesh's devices.
    ``halo`` defaults to the bandwidth; it must be ≤ n / n_devices. Raises
    if couplings extend beyond one neighbour."""
    A = A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise LinearOperatorException("banded_partition requires a square matrix")
    n_dev = mesh.size()
    if n % n_dev != 0:
        raise LinearOperatorException("n must be divisible by the mesh size")
    m = n // n_dev

    if halo is None:
        r, c = np.nonzero(A)
        halo = int(np.abs(r - c).max()) if len(r) else 1
        halo = max(min(halo, m), 1)
    if halo > m:
        raise LinearOperatorException("halo exceeds the local segment size")

    A_int = np.zeros((n, m), A.dtype)
    A_left = np.zeros((n, halo), A.dtype)
    A_right = np.zeros((n, halo), A.dtype)
    for p in range(n_dev):
        rows = slice(p * m, (p + 1) * m)
        A_int[rows] = A[rows, p * m:(p + 1) * m]
        if p > 0:
            A_left[rows] = A[rows, p * m - halo:p * m]
        if p < n_dev - 1:
            A_right[rows] = A[rows, (p + 1) * m:(p + 1) * m + halo]
        # verify nothing couples beyond one neighbor
        mask = np.ones(n, bool)
        mask[max(p * m - halo, 0):min((p + 1) * m + halo, n)] = False
        if np.any(A[rows][:, mask] != 0):
            raise LinearOperatorException(
                "matrix couples beyond one neighbor halo; increase halo or use shard_operator")
    return HaloPartitionedOperator(A_int, A_left, A_right, mesh, axis=axis,
                                   symmetric=symmetric, hermitian=hermitian)
