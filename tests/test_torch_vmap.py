"""``torch.func.vmap`` over the port's operators and solvers, against
``jax.vmap`` of the reference (``tests/test_vmap_operators.py``), on the CPU
in f64.

A batch axis on an operator's tensors gives a batch of operators: the
applies and ``vmap(grad(...))`` run through ``torch.func.vmap``. The solvers
run under vmap as ``jax.vmap`` of a ``lax.while_loop`` does: every member
iterates until all have stopped, each frozen once its own test fails, with
per-member iteration counts (``utils/loop.py::device_while``); GMRES
builds its Arnoldi basis by stacking rows there. A kernel apply
under vmap (the kernel branches forced on the CPU, where the wrappers run
their plain versions) runs the kernel once per member, or the routed
matrix kind on the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt


def t_(a):
    return torch.from_numpy(np.asarray(a))


def test_vmap_diagonal_batch(rng):
    B, n = 5, 12
    ds = rng.standard_normal((B, n)) + 3.0
    vs = rng.standard_normal((B, n))
    ys_j = jax.vmap(lambda d, v: lo.opDiagonal(d) @ v)(jnp.asarray(ds), jnp.asarray(vs))
    ys_t = torch.func.vmap(lambda d, v: lt.opDiagonal(d) @ v)(t_(ds), t_(vs))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-15)
    np.testing.assert_allclose(ys_t.numpy(), ds * vs)


def test_vmap_graph_batch(rng):
    B, n = 4, 10
    As = rng.standard_normal((B, n, n))
    ds = rng.standard_normal((B, n))
    vs = rng.standard_normal((B, n))
    ys_j = jax.vmap(lambda A, d, v: (2.0 * lo.MatrixOperator(A) + lo.opDiagonal(d)) @ v)(
        jnp.asarray(As), jnp.asarray(ds), jnp.asarray(vs))
    ys_t = torch.func.vmap(lambda A, d, v: (2.0 * lt.MatrixOperator(A) + lt.opDiagonal(d)) @ v)(
        t_(As), t_(ds), t_(vs))
    oracle = 2.0 * np.einsum("bij,bj->bi", As, vs) + ds * vs
    np.testing.assert_allclose(ys_t.numpy(), oracle, atol=1e-12)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=1e-12)


def spd_batch(rng, B=6, n=14):
    As = rng.standard_normal((B, n, n))
    return np.einsum("bij,bkj->bik", As, As) + 10.0 * np.eye(n)[None], rng.standard_normal((B, n))


def test_vmap_batched_cg(rng):
    """B SPD systems, each with its own operator: torch.func.vmap(cg) solves
    the batch as jax.vmap(cg) does, with the same x and the same per-member
    iteration counts; outside vmap the count stays an int."""
    spd, bs = spd_batch(rng)

    def solve_j(A, b):
        return lo.cg(lo.MatrixOperator(A, symmetric=True, hermitian=True), b, tol=1e-12,
                     maxiter=200)

    def solve_t(A, b):
        return lt.cg(lt.MatrixOperator(A, symmetric=True, hermitian=True), b, tol=1e-12,
                     maxiter=200)

    xs_j, ks_j, _ = jax.vmap(solve_j)(jnp.asarray(spd), jnp.asarray(bs))
    xs_t, ks_t, res_t = torch.func.vmap(solve_t)(t_(spd), t_(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    assert res_t.shape == (spd.shape[0],)
    assert np.linalg.norm(np.einsum("bij,bj->bi", spd, xs_t.numpy()) - bs) < 1e-8
    _, k1, _ = solve_t(t_(spd[0]), t_(bs[0]))
    assert isinstance(k1, int) and k1 == int(ks_t[0])


@pytest.mark.parametrize("solver", ["bicgstab", "minres", "lsqr", "chebyshev"])
def test_vmap_batched_solvers(rng, solver):
    """The other solvers with a stopping test under vmap, and Chebyshev (no
    test: a fixed count), against jax.vmap of the reference: x within 1e-8
    relative and the same per-member counts."""
    spd, bs = spd_batch(rng)
    kw = {"bicgstab": dict(tol=1e-10, maxiter=200), "minres": dict(tol=1e-10, maxiter=200),
          "lsqr": dict(tol=1e-8, maxiter=200)}.get(solver, dict(iters=40))
    herm = dict(symmetric=True, hermitian=True)
    bounds = (5.0, 200.0) if solver == "chebyshev" else ()

    def solve(pkg, A, b):
        return getattr(pkg, solver)(pkg.MatrixOperator(A, **herm), b, *bounds, **kw)

    xs_j, ks_j, _ = jax.vmap(lambda A, b: solve(lo, A, b))(jnp.asarray(spd), jnp.asarray(bs))
    out_dims = (0, None, 0) if solver == "chebyshev" else 0
    xs_t, ks_t, _ = torch.func.vmap(lambda A, b: solve(lt, A, b), out_dims=out_dims)(
        t_(spd), t_(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(ks_t), (len(bs),)),
                                  np.broadcast_to(np.asarray(ks_j), (len(bs),)))


def test_vmap_batched_gmres(rng):
    """vmap(gmres): the Arnoldi basis built by stacking rows under vmap, the
    restarts stopping per member, against jax.vmap of the reference's gmres:
    x within 1e-8 relative and the same per-member restart counts."""
    B, n = 4, 14
    As = 4.0 * np.eye(n)[None] + rng.standard_normal((B, n, n)) / np.sqrt(n)
    As[0] += 2.0 * np.eye(n)  # members converge after different restart counts
    bs = rng.standard_normal((B, n))

    def solve(pkg, A, b):
        return pkg.gmres(pkg.MatrixOperator(A), b, tol=1e-10, restart=4, maxiter=30)

    xs_j, ks_j, _ = jax.vmap(lambda A, b: solve(lo, A, b))(jnp.asarray(As), jnp.asarray(bs))
    xs_t, ks_t, res_t = torch.func.vmap(lambda A, b: solve(lt, A, b))(t_(As), t_(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    assert len(set(ks_t.tolist())) > 1 and res_t.shape == (B,)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", As, xs_t.numpy()), bs, atol=1e-8)


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """The operators' kernel branches on CPU tensors (their wrappers take the
    plain versions there): KernelApply and its vmap rule run as on a card."""
    from linops_tpu_torch.ops import permutation as TP
    from linops_tpu_torch.sparse import ops as TO
    from linops_tpu_torch.sparse import routed as TR

    monkeypatch.setattr(TO.BSROperator, "_use_kernel", lambda self, v: self._backend != "torch")
    monkeypatch.setattr(TR, "_use_kernel", lambda uk, vals, x: True if uk is None else bool(uk))
    monkeypatch.setattr(TO, "_on_card", lambda t: True)
    monkeypatch.setattr(TP.PermutationOperator, "_use_kernel", lambda self, x: True)


def test_vmap_over_kernel_applies(rng, kernels_on_cpu, monkeypatch):
    """vmap over a kernel apply: BSR N and a permutation run the vector
    apply once per member, bit for bit; BSR T runs its block transpose once
    on the batch (a row panel, as the reference's vmap is one batched
    kernel), bit for bit that row panel's apply and within f64 rounding of
    the vector applies (on the CPU the plain panel sums in another order than
    the plain vector transpose; on the card K2p is bit for bit K2's column
    loop, ``tests/test_torch_gpu.py``); a routed operator runs its matrix
    kind on the batch (a row panel) and agrees with the vector applies; a
    batch of BSR operators (batched blocks) runs once per member."""
    import scipy.sparse as sps

    from linops_tpu_torch.kernels import bsr_spmv as K

    A = np.where(rng.random((40, 48)) < 0.3, rng.standard_normal((40, 48)), 0.0)
    op = lt.BSROperator(lt.bsr_from_dense(A, (4, 8), device="cpu"))
    panels = []
    panel_kernel = K.bsr_rmatmat_kernel
    monkeypatch.setattr(K, "bsr_rmatmat_kernel",
                        lambda *a, **kw: panels.append(1) or panel_kernel(*a, **kw))
    for mode in ("N", "T"):
        V = t_(rng.standard_normal((5, op.in_dim(mode))))
        Y = torch.func.vmap(lambda v: op.apply(v, mode))(V)
        vec = torch.stack([op.apply(v, mode) for v in V])
        if mode == "N":
            assert torch.equal(Y, vec) and panels == []
        else:
            assert panels == [1]
            assert torch.equal(Y, op.apply_matrix_t(V, "T"))
            assert float((Y - vec).abs().max()) <= 1e-12 * float(vec.abs().max())
    P = lt.opPermutation(rng.permutation(700), device="cpu")
    V = t_(rng.standard_normal((3, 700)))
    assert torch.equal(torch.func.vmap(lambda v: P @ v)(V), torch.stack([P @ v for v in V]))
    R = sps.random(300, 260, density=0.03, format="csr", random_state=81)
    routed = lt.opSparse(R, format="routed", device="cpu")
    for mode in ("N", "T"):
        V = t_(rng.standard_normal((6, routed.in_dim(mode))))
        Y = torch.func.vmap(lambda v: routed.apply(v, mode))(V)
        ref = torch.stack([routed.apply(v, mode) for v in V])
        np.testing.assert_allclose(Y.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    blocks = op.data.blocks
    Bs = torch.stack([blocks, 2.0 * blocks, -blocks])
    x = t_(rng.standard_normal(48))

    def apply_one(b):
        return lt.BSROperator(lt.BSR(b, op.data.block_cols, op.data.shape)) @ x

    np.testing.assert_allclose(torch.func.vmap(apply_one)(Bs).numpy(),
                               np.stack([A @ x.numpy() * s for s in (1.0, 2.0, -1.0)]),
                               rtol=1e-12, atol=1e-12)


def test_vmap_composes_with_grad(rng):
    B, n = 3, 8
    ds = np.abs(rng.standard_normal((B, n))) + 1.0
    vs = rng.standard_normal((B, n))

    def loss_j(d, v):
        return jnp.sum((lo.opDiagonal(d) @ v) ** 2)

    def loss_t(d, v):
        return ((lt.opDiagonal(d) @ v) ** 2).sum()

    g_j = jax.vmap(jax.grad(loss_j))(jnp.asarray(ds), jnp.asarray(vs))
    g_t = torch.func.vmap(torch.func.grad(loss_t))(t_(ds), t_(vs))
    np.testing.assert_allclose(g_t.numpy(), 2.0 * ds * vs ** 2, rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)
