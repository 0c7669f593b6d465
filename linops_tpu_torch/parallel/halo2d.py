"""2-D domain-decomposed 5-point stencil operator (grid halo exchange).

Counterpart of ``linops_tpu/parallel/halo2d.py``, the 2-D extension of
``halo.py``: the (ny, nx) grid is tiled over a 2-D mesh (py, px); each rank
owns a (ny/py, nx/px) tile, and one apply exchanges one-cell edge strips
with its four neighbours (no corners for a 5-point stencil; Dirichlet zero
at the grid edge), computing the centre term while the strips travel. Four
``collective-permute`` rounds per apply (two per mesh axis longer than
one), no all-gather. A block apply (``apply_matrix`` of an (n, k) column
panel, ``apply_matrix_t`` of a (k, n) row panel) runs on the (by, bx, k)
(or (k, by, bx)) tile and is one such exchange of (bx, k) and (by, k)
strips, as the reference's vmapped apply batches its ``ppermute``s: 4
rounds for any k, and each column equal to the vector apply's bit for bit.

The stencil is the constant-coefficient 5-point form

    y[i,j] = c·u[i,j] + n·u[i-1,j] + s·u[i+1,j] + w·u[i,j-1] + e·u[i,j+1]
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.base import LinearOperator, LinearOperatorException
from . import comm
from .halo import _check_panel, _mesh_device, _present, _segment, _split_out
from .mesh import mesh_device_type

__all__ = ["HaloStencil2DOperator", "stencil_partition_2d", "make_mesh2d"]


def _scale(coef, t):
    """``coef · t`` for a 0-dim ``coef``. A complex product is formed from
    its real parts, each multiply and add rounded on its own: ATen's complex
    multiply on the CPU rounds differently in its vectorized and its scalar
    loop, so a tile's bits would depend on its shape."""
    if not t.is_complex():
        return coef * t
    a, b, re, im = coef.real, coef.imag, t.real, t.imag
    return torch.complex(a * re - b * im, a * im + b * re)


def _add_shifted(y, u, coef, edge, dim: int, after: bool):
    """``y += coef · s`` in place, s being ``u`` shifted by one cell along
    ``dim``: s[i] = u[i-1] with the received strip ``edge`` at i = 0, or
    with ``after`` s[i] = u[i+1] with ``edge`` at the last cell. ``y`` and
    ``u`` are contiguous tiles of one shape. The product runs over the whole
    tile and the add over one contiguous range of the flat tile, offset by
    ``dim``'s stride (both vectorizable); the cells at i = 0 (the last cell)
    of every line, which the flat offset reaches from the neighbouring line,
    get their values back and ``coef · edge`` added instead. Per cell one
    product and one add, in the same order for a vector and for every
    column of a panel, so a column's bits are its vector apply's."""
    off, i = y.stride(dim), (y.shape[dim] - 1 if after else 0)
    kept = y.select(dim, i).clone()
    t, flat = _scale(coef, u).view(-1), y.view(-1)
    if after:
        flat[:-off].add_(t[off:])
    else:
        flat[off:].add_(t[:-off])
    y.select(dim, i).copy_(kept).add_(_scale(coef, edge))


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
    through ``apply_matrix`` (an (n, k) column panel split by rows) or
    ``apply_matrix_t`` (a (k, n) row panel split by columns), one exchange
    of k-wide strips per block; ``apply`` takes vectors only. A plain vector
    or panel counts as replicated and gets its result split as the
    operator's vectors are."""

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
        return self._apply(v, mode, 0)

    def apply_matrix(self, M, mode: str = "N"):
        """(n, k) column panel: the (by, bx, k) tile, one exchange of
        (bx, k) and (by, k) strips (4 rounds on a 2 x 2 mesh)."""
        _check_panel(M)
        return self._apply(M, mode, 0)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """(k, n) row panel, the result (k, n): the (k, by, bx) tile, one
        exchange of (k, bx) and (k, by) strips."""
        _check_panel(Mt)
        return self._apply(Mt, mode, 1)

    def _apply(self, v, mode: str, dim: int):
        """The stencil on this rank's tile of a vector, a column panel
        (``dim`` 0) or a row panel (``dim`` 1): grid rows on tile dimension
        ``dim``, grid columns on ``dim + 1``, a panel's k columns on the
        other."""
        py, px, by, bx = self._tiles
        cf = self._coeffs_for(mode)
        dt = torch.promote_types(cf.dtype, v.dtype)
        u = _segment(v, self._mesh, self.nrow, by * bx, dim).to(dt).contiguous()
        u = u.view(*u.shape[:dim], by, bx, *u.shape[dim + 1:])
        ay, ax = dim, dim + 1
        c, cn, cs, cw, ce = cf.to(dt).resolve_conj().unbind()
        north, south = self._neighbour(-1, 0), self._neighbour(1, 0)
        west, east = self._neighbour(0, -1), self._neighbour(0, 1)
        edge_y, edge_x = u.select(ay, 0).shape, u.select(ax, 0).shape
        from_n, from_s = u.new_zeros(edge_y), u.new_zeros(edge_y)
        from_w, from_e = u.new_zeros(edge_x), u.new_zeros(edge_x)
        # post the four edge exchanges first (every column's strips in one
        # batch); the centre term computes while the strips are in flight
        rounds = 2 * int(py > 1) + 2 * int(px > 1)
        works = comm.exchange(
            _present((u.select(ay, -1), south), (u.select(ay, 0), north),
                     (u.select(ax, -1), east), (u.select(ax, 0), west)),
            _present((from_n, north), (from_s, south), (from_w, west), (from_e, east)),
            rounds) if rounds else []
        y = _scale(c, u)  # overlap: no dependence on the exchange
        for w in works:
            w.wait()
        # Dirichlet boundary: the strips at the grid edge stay zero
        _add_shifted(y, u, cn, from_n, ay, after=False)
        _add_shifted(y, u, cs, from_s, ay, after=True)
        _add_shifted(y, u, cw, from_w, ax, after=False)
        _add_shifted(y, u, ce, from_e, ax, after=True)
        return _split_out(y.reshape(v.shape[:dim] + (by * bx,) + v.shape[dim + 1:]), self._mesh,
                          dim, v.shape)

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
