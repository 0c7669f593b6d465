"""The 2-D domain-decomposed stencil of the port
(``linops_tpu_torch/parallel/halo2d.py``) on a 4-rank gloo world on the CPU,
a (2, 2) grid decomposition, against the reference on its 8 virtual devices,
a (4, 2) one (``tests/test_halo2d.py``, one test here per test there), in
f64.

As in ``tests/test_torch_parallel.py``: one world for the file, every case
run in each rank without jax, numpy results back from rank 0. Each apply is
4 ``collective-permute`` rounds and no all-gather; a Chebyshev solve issues
no all-reduce, CG does.
"""

import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
LAPLACE = [4.0, -1.0, -1.0, -1.0, -1.0]
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def t_(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def place2(mesh2, v):
    from linops_tpu_torch.parallel import NamedSharding, P

    return NamedSharding(mesh2, P(("gy", "gx"))).place(v)


def full(y):
    from linops_tpu_torch.parallel.comm import gather_full

    return gather_full(y).numpy()


def grid(seed, ny, nx):
    return np.random.default_rng(seed).standard_normal((ny, nx))


@case
def matches_single_device_stencil(mesh2):
    from linops_tpu_torch.parallel import stencil_partition_2d

    ny, nx = 16, 12
    op = stencil_partition_2d(t_(LAPLACE), ny, nx, mesh2)
    U = grid(1, ny, nx)
    v = op.grid_to_vec(t_(U))
    y = op.vec_to_grid(op @ place2(mesh2, v)).numpy()
    return dict(flags=(op.symmetric, op.hermitian, op.shape), y=y,
                roundtrip=op.vec_to_grid(op.grid_to_vec(t_(U))).numpy())


@case
def collective_contract(mesh2):
    from linops_tpu_torch.parallel import collective_counts, stencil_partition_2d

    ny, nx = 16, 12
    op = stencil_partition_2d(t_(LAPLACE), ny, nx, mesh2)
    v = place2(mesh2, torch.ones(ny * nx, dtype=torch.float64))
    return collective_counts(lambda: op @ v)


@case
def transpose_modes(mesh2):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import stencil_partition_2d

    ny, nx = 12, 8
    op = stencil_partition_2d(t_([4.0, -1.0, -2.0, -0.5, -1.5]), ny, nx, mesh2)
    v = np.random.default_rng(3).standard_normal(ny * nx)
    vs = place2(mesh2, t_(v))
    order = op.grid_to_vec(torch.arange(ny * nx, dtype=torch.float64).reshape(ny, nx))
    return dict(symmetric=op.symmetric, D=full(lt.to_dense(op)), v=v, yt=full(op.T @ vs),
                yh=full(op.H @ vs), ytt=full(op.T.T @ vs), order=order.numpy().astype(int))


@case
def solvers_and_eigs(mesh2):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import stencil_partition_2d

    ny, nx = 16, 12
    op = stencil_partition_2d(t_(LAPLACE), ny, nx, mesh2)
    b = np.random.default_rng(4).standard_normal(ny * nx)
    x, it, res = lt.cg(op, place2(mesh2, t_(b)), tol=1e-10, maxiter=500)
    th, X, rr, it2 = lt.lobpcg(op, k=2, largest=True, tol=1e-8, maxiter=600,
                               generator=torch.Generator().manual_seed(0))
    return dict(res=float(full(res)), theta=full(th), x_grid=op.vec_to_grid(x).numpy(),
                b_grid=op.vec_to_grid(t_(b)).numpy())


@case
def validation(mesh2):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import stencil_partition_2d

    raised = []
    for args in ((torch.ones(4), 8, 8), (torch.ones(5), 9, 8)):
        try:
            stencil_partition_2d(*args, mesh2)
            raised.append(False)
        except lt.LinearOperatorException:
            raised.append(True)
    return raised


@case
def rejects_matrix_apply(mesh2):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import stencil_partition_2d

    op = stencil_partition_2d(t_(LAPLACE), 16, 12, mesh2)
    try:
        op.apply(torch.ones((16 * 12, 3), dtype=torch.float64), "N")
        refused = False
    except lt.LinearOperatorException:
        refused = True
    Y = op.apply_matrix(torch.ones((16 * 12, 3), dtype=torch.float64), "N")
    return dict(refused=refused, shape=tuple(Y.shape))


@case
def chebyshev_is_all_reduce_free(mesh2):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts, stencil_partition_2d

    L = stencil_partition_2d(t_(LAPLACE), 32, 16, mesh2)
    b = place2(mesh2, torch.ones(32 * 16, dtype=torch.float64))
    cheb = collective_counts(lambda: lt.chebyshev(L, b, 0.05, 8.0, iters=30)[0])
    cg = collective_counts(lambda: lt.cg(L, b, tol=1e-8, maxiter=30)[0])
    return dict(cheb=cheb, cg=cg)


def from_reference_coeffs(mesh2, coeffs):
    from linops_tpu_torch.convert import halo2d_from_reference

    op = halo2d_from_reference(coeffs, 12, 8, mesh2)
    U = grid(6, 12, 8)
    return dict(y=op.vec_to_grid(op @ place2(mesh2, op.grid_to_vec(t_(U)))).numpy(),
                yt=op.vec_to_grid(op.T @ place2(mesh2, op.grid_to_vec(t_(U)))).numpy())


def world_main(coeffs):
    import torch.distributed as dist

    from linops_tpu_torch.parallel import make_mesh2d

    mesh2 = make_mesh2d(2, 2, device="cpu")
    out = {}
    cases = dict(CASES, from_reference_coeffs=lambda m: from_reference_coeffs(m, coeffs))
    for name, fn in cases.items():
        try:
            out[name] = ("ok", fn(mesh2))
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out if dist.get_rank() == 0 else None


NONSYM = [4.0, -1.0, -2.0, -0.5, -1.5]


@pytest.fixture(scope="module")
def world():
    import jax.numpy as jnp

    from linops_tpu.parallel import make_mesh2d, stencil_partition_2d
    from linops_tpu_torch.parallel import launch

    op_j = stencil_partition_2d(jnp.asarray(NONSYM), 12, 8, make_mesh2d(2, 2))
    return launch.run(os.path.abspath(__file__) + ":world_main", WORLD,
                      args=(np.asarray(op_j.coeffs),), backend="gloo", timeout=600)[0]


def result(world, name):
    status, value = world[name]
    if status != "ok":
        pytest.fail(f"case {name} failed in the world:\n{value}")
    return value


@pytest.fixture(scope="module")
def ref():
    import jax

    import linops_tpu as lo
    from linops_tpu.parallel import make_mesh2d

    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return lo, make_mesh2d(4, 2)


def test_halo2d_matches_single_device_stencil(world, ref):
    lo, mesh2 = ref
    import jax.numpy as jnp
    from linops_tpu.parallel import stencil_partition_2d

    r = result(world, "matches_single_device_stencil")
    ny, nx = 16, 12
    assert r["flags"] == (True, True, (ny * nx, ny * nx))
    U = grid(1, ny, nx)
    op_j = stencil_partition_2d(jnp.asarray(LAPLACE), ny, nx, mesh2)
    y_j = np.asarray(op_j.vec_to_grid(op_j @ op_j.grid_to_vec(jnp.asarray(U))))
    np.testing.assert_allclose(r["y"], y_j, atol=1e-12)
    L = lo.laplacian_2d(ny, nx, dtype=jnp.float64)
    np.testing.assert_allclose(r["y"], np.asarray(L @ jnp.asarray(U.reshape(-1))).reshape(ny, nx),
                               atol=1e-12)
    np.testing.assert_allclose(r["roundtrip"], U)  # the layout is a relabeling


def test_halo2d_collective_contract(world):
    counts = result(world, "collective_contract")
    assert counts["collective-permute"] == 4
    assert counts["all-gather"] == 0
    assert counts["all-reduce"] == 0


def test_halo2d_transpose_modes(world, ref):
    lo, mesh2 = ref
    import jax.numpy as jnp
    from linops_tpu.parallel import stencil_partition_2d

    r = result(world, "transpose_modes")
    assert not r["symmetric"]
    D, v = r["D"], r["v"]
    op_j = stencil_partition_2d(jnp.asarray([4.0, -1.0, -2.0, -0.5, -1.5]), 12, 8, mesh2)

    def on_grid(D_blocked, order):  # the blocked layouts differ with the mesh
        G = np.empty_like(D_blocked)
        G[np.ix_(order, order)] = D_blocked
        return G

    order_j = np.asarray(op_j.grid_to_vec(jnp.arange(96.0).reshape(12, 8))).astype(int)
    np.testing.assert_allclose(on_grid(D, r["order"]),
                               on_grid(np.asarray(lo.to_dense(op_j)), order_j), atol=1e-12)
    np.testing.assert_allclose(r["yt"], D.T @ v, atol=1e-12)
    np.testing.assert_allclose(r["yh"], D.T @ v, atol=1e-12)
    np.testing.assert_allclose(r["ytt"], D @ v, atol=1e-12)


def test_halo2d_solvers_and_eigs(world, ref):
    lo, mesh2 = ref
    import jax.numpy as jnp
    from linops_tpu.parallel import stencil_partition_2d

    r = result(world, "solvers_and_eigs")
    ny, nx = 16, 12
    assert r["res"] < 1e-8
    op_j = stencil_partition_2d(jnp.asarray(LAPLACE), ny, nx, mesh2)
    x_j, _, _ = lo.cg(op_j, op_j.grid_to_vec(jnp.asarray(r["b_grid"])), tol=1e-10, maxiter=500)
    np.testing.assert_allclose(r["x_grid"], np.asarray(op_j.vec_to_grid(x_j)), rtol=1e-8,
                               atol=1e-10)
    hy, hx = np.pi / (ny + 1), np.pi / (nx + 1)
    lam = np.sort([4 - 2 * np.cos(i * hy) - 2 * np.cos(j * hx)
                   for i in range(1, ny + 1) for j in range(1, nx + 1)])
    np.testing.assert_allclose(r["theta"], lam[-2:][::-1], rtol=1e-5)


def test_halo2d_validation(world):
    assert result(world, "validation") == [True, True]


def test_halo2d_rejects_matrix_apply(world):
    r = result(world, "rejects_matrix_apply")
    assert r["refused"] and r["shape"] == (16 * 12, 3)


def test_chebyshev_is_all_reduce_free_on_halo2d(world):
    r = result(world, "chebyshev_is_all_reduce_free")
    assert r["cheb"]["all-reduce"] == 0
    assert r["cheb"]["all-gather"] == 0
    assert r["cg"]["all-reduce"] > 0  # the inner products


def test_halo2d_from_reference_coeffs(world, ref):
    """A reference operator's coefficients carried over (``convert.py``):
    the same apply, N and T, in grid space."""
    lo, mesh2 = ref
    import jax.numpy as jnp
    from linops_tpu.parallel import stencil_partition_2d

    r = result(world, "from_reference_coeffs")
    op_j = stencil_partition_2d(jnp.asarray(NONSYM), 12, 8, mesh2)
    U = jnp.asarray(grid(6, 12, 8))
    np.testing.assert_allclose(r["y"], np.asarray(op_j.vec_to_grid(op_j @ op_j.grid_to_vec(U))),
                               atol=1e-12)
    np.testing.assert_allclose(r["yt"],
                               np.asarray(op_j.vec_to_grid(op_j.T @ op_j.grid_to_vec(U))),
                               atol=1e-12)
