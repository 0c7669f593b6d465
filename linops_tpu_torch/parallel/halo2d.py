"""2-D domain-decomposed 5-point stencil operator (grid halo exchange).

Counterpart of ``linops_tpu/parallel/halo2d.py``, the 2-D extension of
``halo.py``: the (ny, nx) grid is tiled over a 2-D mesh (py, px); each rank
owns a (ny/py, nx/px) tile, and one apply exchanges one-cell edge strips
with its four neighbours (no corners for a 5-point stencil; Dirichlet zero
at the grid edge), computing the centre term while the strips travel. Four
``collective-permute`` rounds per apply (two per mesh axis longer than
one), no all-gather.

The stencil is the constant-coefficient 5-point form

    y[i,j] = c·u[i,j] + n·u[i-1,j] + s·u[i+1,j] + w·u[i,j-1] + e·u[i,j+1]
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.base import LinearOperator, LinearOperatorException
from . import comm
from .halo import _mesh_device, _present, _segment
from .mesh import mesh_device_type

__all__ = ["HaloStencil2DOperator", "stencil_partition_2d", "make_mesh2d"]


def make_mesh2d(py: int, px: int, axes=("gy", "gx"), device=None):
    """A (py, px) 2-D mesh over the first py·px ranks, for grid domain
    decomposition (CUDA devices unless ``device="cpu"``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from .mesh import _world

    world = _world()
    if py * px > world:
        raise ValueError(f"requested {py}x{px} devices but only {world} available")
    return DeviceMesh(mesh_device_type(device), torch.arange(py * px).reshape(py, px),
                      mesh_dim_names=tuple(axes))


class HaloStencil2DOperator(LinearOperator):
    """Constant-coefficient 5-point stencil on an (ny, nx) grid, tiled over a
    2-D mesh. ``coeffs`` is the 5-vector ``[c, n, s, w, e]`` (replicated);
    the symmetry flags come from its values at construction.

    Vectors use the blocked (device-major) grid flattening: tile (p, q)
    occupies one contiguous segment, so a flat vector splits over the two
    mesh axes jointly (DTensor placements ``[Shard(0), Shard(0)]``) and an
    apply moves only the four edge strips. Convert with ``grid_to_vec`` /
    ``vec_to_grid``, a relabeling of whole arrays.

    The transpose stencil swaps n↔s and w↔e, so every mode runs the one
    apply with permuted (and, for C/H, conjugated) coefficients. Matrices go
    through ``apply_matrix``; ``apply`` takes vectors only. A plain vector
    counts as replicated and gets its result split as the operator's
    vectors are."""

    _fields_tensors = ("coeffs",)
    _fields_static = ("_ny", "_nx", "_mesh", "_symmetric", "_hermitian")

    def __init__(self, coeffs, ny: int, nx: int, mesh, *, axes=None):
        super().__init__()
        coeffs = torch.as_tensor(coeffs, device=_mesh_device(mesh))
        if tuple(coeffs.shape) != (5,):
            raise LinearOperatorException("coeffs must be the 5-vector [c, n, s, w, e]")
        axes = tuple(axes) if axes is not None else tuple(mesh.mesh_dim_names[:2])
        if len(axes) != 2 or mesh.ndim != 2 or tuple(mesh.mesh_dim_names) != axes:
            raise LinearOperatorException("need a 2-D mesh (two axis names)")
        py, px = mesh.shape
        if ny % py != 0 or nx % px != 0:
            raise LinearOperatorException(
                f"grid ({ny}, {nx}) must tile the mesh ({py}, {px}) evenly")
        self.coeffs = coeffs
        self._ny, self._nx = int(ny), int(nx)
        self._mesh = mesh
        c = coeffs.detach().cpu()
        sym = bool(c[1] == c[2]) and bool(c[3] == c[4])
        self._symmetric = sym
        self._hermitian = sym and (not c.is_complex() or bool((c.imag == 0).all()))

    @property
    def nrow(self):
        return self._ny * self._nx

    @property
    def ncol(self):
        return self.nrow

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    @property
    def mesh(self):
        return self._mesh

    def _coeffs_for(self, mode: str):
        cf = self.coeffs
        if mode in ("T", "H"):
            cf = cf[[0, 2, 1, 4, 3]]  # n<->s, w<->e
        if mode in ("H", "C") and cf.is_complex():
            cf = cf.conj()
        return cf

    @property
    def _tiles(self):
        py, px = self._mesh.shape
        return py, px, self._ny // py, self._nx // px

    def grid_to_vec(self, U):
        """(ny, nx) grid -> blocked flat vector (the operator's layout)."""
        py, px, by, bx = self._tiles
        U = torch.as_tensor(U, device=self.coeffs.device)
        return U.reshape(py, by, px, bx).permute(0, 2, 1, 3).reshape(-1)

    def vec_to_grid(self, v):
        """Blocked flat vector (a DTensor is gathered first) -> (ny, nx) grid."""
        py, px, by, bx = self._tiles
        v = comm.gather_full(torch.as_tensor(v) if not comm.is_dtensor(v) else v)
        return v.reshape(py, px, by, bx).permute(0, 2, 1, 3).reshape(self._ny, self._nx)

    def _neighbour(self, dy: int, dx: int):
        py, px = self._mesh.shape
        p, q = self._mesh.get_coordinate()
        if 0 <= p + dy < py and 0 <= q + dx < px:
            return int(self._mesh.mesh[p + dy, q + dx])
        return None

    def apply(self, v, mode: str = "N"):
        if v.ndim != 1 or v.shape[0] != self.nrow:
            raise LinearOperatorException(
                f"shape mismatch: expected ({self.nrow},), got {tuple(v.shape)} "
                "(matrices go through apply_matrix)")
        from torch.distributed.tensor import Shard

        py, px, by, bx = self._tiles
        cf = self._coeffs_for(mode)
        dt = torch.promote_types(cf.dtype, v.dtype)
        u = _segment(v, self._mesh, self.nrow, by * bx).to(dt).reshape(by, bx)
        c, cn, cs, cw, ce = cf.to(dt).unbind()
        north, south = self._neighbour(-1, 0), self._neighbour(1, 0)
        west, east = self._neighbour(0, -1), self._neighbour(0, 1)
        from_n, from_s = torch.zeros_like(u[0]), torch.zeros_like(u[0])
        from_w, from_e = torch.zeros_like(u[:, 0]), torch.zeros_like(u[:, 0])
        # post the four edge exchanges first; the centre term computes while
        # the strips are in flight
        rounds = 2 * int(py > 1) + 2 * int(px > 1)
        works = comm.exchange(
            _present((u[-1], south), (u[0], north), (u[:, -1], east), (u[:, 0], west)),
            _present((from_n, north), (from_s, south), (from_w, west), (from_e, east)),
            rounds) if rounds else []
        y = c * u  # overlap: no dependence on the exchange
        for w in works:
            w.wait()
        # Dirichlet boundary: the strips at the grid edge stay zero
        y = y + cn * torch.cat([from_n[None], u[:-1]], dim=0)
        y = y + cs * torch.cat([u[1:], from_s[None]], dim=0)
        y = y + cw * torch.cat([from_w[:, None], u[:, :-1]], dim=1)
        y = y + ce * torch.cat([u[:, 1:], from_e[:, None]], dim=1)
        return comm.from_local(y.reshape(-1), self._mesh, [Shard(0), Shard(0)], (self.nrow,))

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return f"HaloStencil2D({self._ny}x{self._nx} over {tuple(self._mesh.shape)})"


def stencil_partition_2d(coeffs, ny: int, nx: int, mesh, *, axes: Optional[tuple] = None):
    """A ``HaloStencil2DOperator`` (e.g. the 2-D Dirichlet Laplacian:
    ``coeffs = [4, -1, -1, -1, -1]``); numpy or tensor coefficients land on
    the mesh's devices."""
    return HaloStencil2DOperator(coeffs, ny, nx, mesh, axes=axes)
