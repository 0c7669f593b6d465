"""Halo-exchange partitioned operators of the port
(``linops_tpu_torch/parallel/halo.py``) on a 4-rank gloo world on the CPU,
against the reference on its 8 virtual devices (``tests/test_halo.py``, one
test here per test there) in f64, rtol 1e-10.

As in ``tests/test_torch_parallel.py``: one world for the file (a module
fixture), every case run in each rank without jax, numpy results back from
rank 0. Each apply is 2 ``collective-permute`` rounds and no all-gather.
"""

import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
RTOL = 1e-10
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def banded(rng, n, bw):
    A = np.zeros((n, n))
    for k in range(-bw, bw + 1):
        A += np.diag(rng.standard_normal(n - abs(k)), k)
    return A


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), f"max|Δ| {err:.3e} > {rtol:g}·max|ref|"


def data(name):
    """The same inputs on both sides: (matrix, vectors) per case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 128
    if name == "cg":
        A = banded(rng, n, 2)
        return A @ A.T + 2 * n * np.eye(n), rng.standard_normal(n)
    return banded(rng, n, 3 if name == "matvec" else 2), rng.standard_normal(n)


def full(y):
    from linops_tpu_torch.parallel.comm import gather_full

    return gather_full(y).numpy()


def _place(mesh, v):
    from linops_tpu_torch.parallel import row_sharding

    return row_sharding(mesh).place(torch.from_numpy(v))


@case
def banded_matvec(mesh):
    from linops_tpu_torch.parallel import banded_partition, collective_counts

    A, v = data("matvec")
    op = banded_partition(A, mesh)
    vs = _place(mesh, v)
    return dict(halo=op.halo, y=full(op * vs), y_plain=full(op * torch.from_numpy(v)),
                counts=collective_counts(lambda: op.apply(vs, "N")),
                counts_t=collective_counts(lambda: op.apply(vs, "T")),
                placements=str(op.A_int.placements))


@case
def banded_transpose(mesh):
    from linops_tpu_torch.parallel import banded_partition

    A, u = data("transpose")
    op = banded_partition(A, mesh)
    us = _place(mesh, u)
    return dict(yt=full(op.T * us), yh=full(op.H * us))


@case
def halo_chain_and_cg(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import banded_partition

    A, b = data("cg")
    op = banded_partition(A, mesh, symmetric=True, hermitian=True)
    bs = _place(mesh, b)
    x, iters, res = lt.cg(op, bs, tol=1e-10, maxiter=300)
    out = lt.matvec_chain(op, bs, 10)
    return dict(x=full(x), iters=iters, chain=full(out))


@case
def coupling_beyond_halo_rejected(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import banded_partition

    A = np.eye(128)
    A[0, -1] = 1.0  # couples across the whole chain
    try:
        banded_partition(A, mesh, halo=2)
    except lt.LinearOperatorException as e:
        return str(e)
    return None


@case
def halo_in_algebra(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import banded_partition

    A, v = data("algebra")
    d = np.random.default_rng(5).standard_normal(128) + 2.0
    op = banded_partition(A, mesh)
    chain = 2.0 * (lt.opDiagonal(torch.from_numpy(d)) @ op)
    return dict(y=full(chain * torch.from_numpy(v)), d=d)  # a plain vector: replicated


@case
def lobpcg_on_halo_partitioned_operator(mesh):
    import scipy.sparse as sps

    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import banded_partition

    n = 32
    T = sps.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).toarray()
    hop = banded_partition(torch.from_numpy(T), mesh, symmetric=True, hermitian=True)
    th, X, res, it = lt.lobpcg(hop, k=2, largest=True, tol=1e-8, maxiter=400,
                               generator=torch.Generator().manual_seed(0))
    return dict(theta=full(th))


def from_reference_slabs(mesh, slabs):
    """The reference's slabs (a 4-device mesh: the same split) through
    ``convert.halo_from_reference``."""
    from linops_tpu_torch.convert import halo_from_reference

    A, v = data("convert")
    op = halo_from_reference(*slabs, mesh)
    return dict(y=full(op * _place(mesh, v)), yt=full(op.T * _place(mesh, v)))


def world_main(slabs):
    import torch.distributed as dist

    from linops_tpu_torch.parallel import make_mesh

    mesh = make_mesh(WORLD, device="cpu")
    out = {}
    cases = dict(CASES, from_reference_slabs=lambda m: from_reference_slabs(m, slabs))
    for name, fn in cases.items():
        try:
            out[name] = ("ok", fn(mesh))
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def world():
    import jax

    from linops_tpu.parallel import make_mesh
    from linops_tpu.parallel.halo import banded_partition

    A, _ = data("convert")
    op_j = banded_partition(A, make_mesh(WORLD))  # the reference on 4 of its devices
    slabs = [np.asarray(x) for x in (op_j.A_int, op_j.A_left, op_j.A_right)]
    assert jax.device_count() >= WORLD
    from linops_tpu_torch.parallel import launch

    return launch.run(os.path.abspath(__file__) + ":world_main", WORLD, args=(slabs,),
                      backend="gloo", timeout=600)[0]


def result(world, name):
    status, value = world[name]
    if status != "ok":
        pytest.fail(f"case {name} failed in the world:\n{value}")
    return value


@pytest.fixture(scope="module")
def ref():
    import jax

    import linops_tpu as lo
    from linops_tpu.parallel import make_mesh

    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return lo, make_mesh(8)


def test_banded_matvec(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel.halo import banded_partition

    r = result(world, "banded_matvec")
    A, v = data("matvec")
    assert r["halo"] == 3
    close(r["y"], np.asarray(banded_partition(A, mesh) * v))
    close(r["y"], A @ v)
    np.testing.assert_array_equal(r["y_plain"], r["y"])  # a plain vector: the same result
    for counts in (r["counts"], r["counts_t"]):
        assert counts["collective-permute"] == 2 and counts["all-gather"] == 0, counts
    assert r["placements"] == "(Shard(dim=0),)"


def test_banded_transpose(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel.halo import banded_partition

    r = result(world, "banded_transpose")
    A, u = data("transpose")
    op_j = banded_partition(A, mesh)
    close(r["yt"], np.asarray(op_j.T * u))
    close(r["yh"], np.asarray(op_j.H * u))
    close(r["yt"], A.T @ u)


def test_halo_chain_and_cg(world, ref):
    lo, mesh = ref
    import jax.numpy as jnp
    from linops_tpu.parallel.halo import banded_partition

    r = result(world, "halo_chain_and_cg")
    A, b = data("cg")
    assert np.linalg.norm(A @ r["x"] - b) / np.linalg.norm(b) < 1e-8
    x_j, it_j, _ = lo.cg(banded_partition(A, mesh, symmetric=True, hermitian=True),
                         jnp.asarray(b), tol=1e-10, maxiter=300)
    close(r["x"], np.asarray(x_j), 1e-8)
    assert abs(r["iters"] - int(it_j)) <= 1
    assert np.isfinite(r["chain"]).all()


def test_coupling_beyond_halo_rejected(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel.halo import banded_partition

    msg = result(world, "coupling_beyond_halo_rejected")
    assert msg is not None and "neighbor" in msg
    A = np.eye(128)
    A[0, -1] = 1.0
    with pytest.raises(lo.LinearOperatorException):
        banded_partition(A, mesh, halo=2)


def test_halo_in_algebra(world):
    r = result(world, "halo_in_algebra")
    A, v = data("algebra")
    close(r["y"], 2.0 * np.diag(r["d"]) @ A @ v)


def test_lobpcg_on_halo_partitioned_operator(world):
    r = result(world, "lobpcg_on_halo_partitioned_operator")
    n = 32
    lam = np.sort(2.5 + 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))
    np.testing.assert_allclose(r["theta"], lam[-2:][::-1], rtol=1e-6)


def test_halo_from_reference_slabs(world):
    """A reference operator's slabs carried over (``convert.py``) apply as
    the matrix they came from."""
    r = result(world, "from_reference_slabs")
    A, v = data("convert")
    close(r["y"], A @ v)
    close(r["yt"], A.T @ v)
