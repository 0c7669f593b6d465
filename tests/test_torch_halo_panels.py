"""Block applies of the halo operators of the port
(``linops_tpu_torch/parallel/halo.py``, ``halo2d.py``) on a 4-rank gloo
world on the CPU, against the reference's ``apply_matrix`` (a ``jax.vmap``
of its vector apply, whose ``ppermute``s batch over the columns) on 4 of
its virtual devices, in f64.

Three operators, each on the same mesh shape on both sides, so both keep
their vectors in the same layout: ``banded_partition`` of a complex
non-symmetric tridiagonal matrix (a band of 3) at halo 1 and at halo 2 on a
1 x 4 mesh, and ``stencil_partition_2d`` of an anisotropic 8 x 8 stencil
with complex coefficients on a 2 x 2 mesh. Each block apply, in modes N, T,
C and H, for k in {1, 3, 6}, of a column panel (``apply_matrix``) and of a
row panel (``apply_matrix_t``), given as a DTensor split as the operator's
vectors are and as a plain tensor (which counts as replicated):

- its values against the reference's at rtol 1e-10;
- the collectives it issues against the reference's HLO count of the same
  call on a panel split as its operator's vectors are (2 and 4
  collective-permutes, no all-gather, for any k);
- its result split as the operator's vectors are (rows of a column panel,
  columns of a row panel);
- for the 2-D stencil, every column bit for bit its vector apply.

As in ``tests/test_torch_halo.py``: one world for the file, every case run
in each rank without jax, numpy results back from rank 0.
"""

import functools
import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
RTOL = 1e-10
N = 64
MODES = ("N", "T", "C", "H")
KS = (1, 3, 6)
FORMS = ("column dtensor", "column plain", "row dtensor", "row plain")
OPS = ("banded_h1", "banded_h2", "stencil2d", "stencil2d_real")
GRID = (8, 8, [4.0 + 0.5j, -1.0 + 0.25j, -0.6 - 0.1j, -0.8, -1.2 + 0.3j])
REAL_COEFFS = [4.0, -1.0, -0.6, -0.8, -1.2]


def banded_matrix():
    """A complex non-symmetric tridiagonal matrix."""
    rng = np.random.default_rng(181)
    A = np.zeros((N, N), complex)
    for k in (-1, 0, 1):
        m = N - abs(k)
        A += np.diag(rng.standard_normal(m) + 1j * rng.standard_normal(m), k)
    return A


def panel(name, k):
    """The (n, k) column panel of the calls with k columns: complex, real
    for the real stencil."""
    rng = np.random.default_rng(1800 + k)
    M = rng.standard_normal((N, k)) + 1j * rng.standard_normal((N, k))
    return M.real.copy() if name == "stencil2d_real" else M


# --------------------------------------------------------------------------
# The rank side
# --------------------------------------------------------------------------


def port_ops():
    import linops_tpu_torch as lt  # noqa: F401
    from linops_tpu_torch.parallel import banded_partition, make_mesh, make_mesh2d
    from linops_tpu_torch.parallel import stencil_partition_2d

    mesh = make_mesh(WORLD, device="cpu")
    ny, nx, coeffs = GRID
    return {"banded_h1": banded_partition(banded_matrix(), mesh, halo=1),
            "banded_h2": banded_partition(banded_matrix(), mesh, halo=2),
            "stencil2d": stencil_partition_2d(torch.tensor(coeffs, dtype=torch.complex128), ny, nx,
                                              make_mesh2d(2, 2, device="cpu")),
            "stencil2d_real": stencil_partition_2d(torch.tensor(REAL_COEFFS, dtype=torch.float64), ny, nx,
                                                   make_mesh2d(2, 2, device="cpu"))}


def given(op, form, M):
    """The panel of ``form``: a column panel (n, k) or a row panel (k, n),
    a DTensor split as the operator's vectors are or a plain tensor."""
    from linops_tpu_torch.parallel.comm import from_local
    from linops_tpu_torch.parallel.halo import _segment
    from torch.distributed.tensor import Shard

    rows = form.startswith("row")
    t = torch.from_numpy(M.T.copy() if rows else M)
    if form.endswith("plain"):
        return t
    dim, mesh = int(rows), op.mesh
    piece = _segment(t, mesh, N, N // mesh.size(), dim).contiguous()
    return from_local(piece, mesh, [Shard(dim)] * mesh.ndim, t.shape)


def block_applies():
    """name -> (op, mode, k, form) -> (value in the column orientation,
    placements, collectives, columns bit for bit their vector applies)."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import collective_counts
    from linops_tpu_torch.parallel.comm import gather_full

    out = {}
    for name, op in port_ops().items():
        for k in KS:
            M = panel(name, k)
            for mode in MODES:
                cols = torch.stack([gather_full(op.apply(torch.from_numpy(M[:, j]), mode))
                                    for j in range(k)], dim=1)
                for form in FORMS:
                    X = given(op, form, M)
                    fn = op.apply_matrix_t if form.startswith("row") else op.apply_matrix
                    counts = collective_counts(lambda: fn(X, mode))
                    Y = fn(X, mode)
                    whole = gather_full(Y)
                    whole = whole.T if form.startswith("row") else whole
                    out[name, mode, k, form] = dict(
                        y=whole.numpy(), placements=[type(p).__name__ + str(getattr(p, "dim", ""))
                                                     for p in Y.placements],
                        shape=tuple(Y.shape), counts=counts, bits=torch.equal(whole, cols))
    return out if dist.get_rank() == 0 else None


def rejects():
    """A block apply given a vector or a panel of the wrong length raises."""
    import linops_tpu_torch as lt

    out = {}
    for name, op in port_ops().items():
        for what, call in {"vector": lambda: op.apply_matrix(torch.ones(N, dtype=torch.float64)),
                           "length": lambda: op.apply_matrix(torch.ones((N - 1, 2))),
                           "row length": lambda: op.apply_matrix_t(torch.ones((2, N + 1)))}.items():
            try:
                call()
                out[name, what] = False
            except lt.LinearOperatorException:
                out[name, what] = True
    return out


def world_main():
    import torch.distributed as dist

    out = {}
    for fn in (block_applies, rejects):
        try:
            out[fn.__name__] = ("ok", fn())
        except Exception:
            out[fn.__name__] = ("error", traceback.format_exc())
    return out if dist.get_rank() == 0 else None


# --------------------------------------------------------------------------
# The pytest side
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    from linops_tpu_torch.parallel import launch

    return launch.run(os.path.abspath(__file__) + ":world_main", WORLD, backend="gloo",
                      timeout=600)[0]


def result(world, name):
    status, value = world[name]
    if status != "ok":
        pytest.fail(f"case {name} failed in the world:\n{value}")
    return value


@functools.lru_cache(maxsize=None)
def reference_ops():
    import jax
    import jax.numpy as jnp

    from linops_tpu.parallel import (banded_partition, make_mesh, make_mesh2d,
                                     stencil_partition_2d)

    if jax.device_count() < WORLD:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    mesh = make_mesh(WORLD)
    ny, nx, coeffs = GRID
    return {"banded_h1": banded_partition(banded_matrix(), mesh, halo=1),
            "banded_h2": banded_partition(banded_matrix(), mesh, halo=2),
            "stencil2d": stencil_partition_2d(jnp.asarray(coeffs), ny, nx, make_mesh2d(2, 2)),
            "stencil2d_real": stencil_partition_2d(jnp.asarray(REAL_COEFFS), ny, nx,
                                                   make_mesh2d(2, 2))}


@functools.lru_cache(maxsize=None)
def reference_call(name, mode, k, rows):
    """The reference's block apply of the same panel, split as its
    operator's vectors are (by rows, or by columns for a row panel): (the
    value in the column orientation, the HLO collective counts of the
    call). A plain (unplaced) panel compiles to the same collectives."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from linops_tpu.parallel.introspect import hlo_collective_counts

    op = reference_ops()[name]
    axes = tuple(op.mesh.axis_names)
    M = panel(name, k)
    M = jax.device_put(jnp.asarray(M.T if rows else M),
                       NamedSharding(op.mesh, P(None, axes) if rows else P(axes, None)))
    fn = jax.jit((lambda X: op.apply_matrix_t(X, mode)) if rows else
                 (lambda X: op.apply_matrix(X, mode)))
    compiled = fn.lower(M).compile()
    y = np.asarray(compiled(M))
    return (y.T if rows else y), hlo_collective_counts(compiled.as_text())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", OPS)
def test_block_apply_matches_the_reference(world, name, mode, k, form):
    """The values at rtol 1e-10 and the collectives of the reference's
    vmapped block apply; the result split as the operator's vectors are;
    the 2-D stencil's columns bit for bit its vector applies."""
    r = result(world, "block_applies")[name, mode, k, form]
    rows = form.startswith("row")
    want, counts = reference_call(name, mode, k, rows)
    got = r["y"]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), f"max|Δ| {err:.3e}"
    assert r["counts"] == counts
    assert counts["collective-permute"] == (4 if name.startswith("stencil2d") else 2)
    assert counts["all-gather"] == 0
    assert r["shape"] == ((k, N) if rows else (N, k))
    assert set(r["placements"]) == {f"Shard{int(rows)}"}
    if name.startswith("stencil2d"):
        assert r["bits"]


@pytest.mark.parametrize("name", OPS)
def test_block_apply_rejects_what_it_cannot_take(world, name):
    """A vector, or a panel whose length is not the operator's, raises."""
    r = result(world, "rejects")
    assert all(r[name, what] for what in ("vector", "length", "row length"))
