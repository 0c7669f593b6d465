"""``torch.func.vmap`` over the port's operators, against ``jax.vmap`` of
the reference (``tests/test_vmap_operators.py``), on the CPU in f64.

A batch axis on an operator's tensors gives a batch of operators: the
applies and ``vmap(grad(...))`` run through ``torch.func.vmap``. The
batched CG does not: the port's solvers read one scalar per iteration to
stop (ROADMAP.md §3, fault 3), which ``vmap`` refuses as data-dependent
control flow, so the test solves the B systems one by one against
``jax.vmap``'s result and asserts that ``vmap(cg)`` raises.
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


def test_vmap_batched_cg(rng):
    """B SPD systems, each with its own operator: the port solves them one
    by one and agrees with jax.vmap(cg); torch.func.vmap(cg) raises (the
    stopping test reads a scalar on the host)."""
    B, n = 6, 14
    As = rng.standard_normal((B, n, n))
    spd = np.einsum("bij,bkj->bik", As, As) + 10.0 * np.eye(n)[None]
    bs = rng.standard_normal((B, n))

    def solve_j(A, b):
        return lo.cg(lo.MatrixOperator(A, symmetric=True, hermitian=True), b, tol=1e-12,
                     maxiter=200)[0]

    def solve_t(A, b):
        return lt.cg(lt.MatrixOperator(A, symmetric=True, hermitian=True), b, tol=1e-12,
                     maxiter=200)[0]

    xs_j = np.asarray(jax.vmap(solve_j)(jnp.asarray(spd), jnp.asarray(bs)))
    xs_t = torch.stack([solve_t(t_(spd[i]), t_(bs[i])) for i in range(B)]).numpy()
    res = np.einsum("bij,bj->bi", spd, xs_t) - bs
    assert np.linalg.norm(res) < 1e-8
    assert np.abs(xs_t - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    with pytest.raises(RuntimeError, match="data-dependent control flow"):
        torch.func.vmap(solve_t)(t_(spd), t_(bs))


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
