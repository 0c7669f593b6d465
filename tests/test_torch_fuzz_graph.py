"""Randomized operator graphs (``tests/test_fuzz_graph.py``) built in both
packages from the same draws: every mode, the densification and a matrix
apply of the port against the reference and the dense oracle, on the CPU in
f64 and complex128. Seeded, so deterministic. Port against reference:
max|Δ| ≤ 1e-10·max|ref|; both against the dense oracle at the reference's
own tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt

RTOL = 1e-9
CPU = dict(device="cpu")


def t_(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, rtol=1e-10):
    got = got.detach().resolve_conj().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1.0)


def _leaf(rng, m, n, complex_):
    """A random leaf of shape (m, n): (port, reference, dense)."""
    def randm(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if complex_ else a

    kind = rng.integers(0, 6)
    if kind == 1 and m == n:
        d = randm(n) + 2.0
        return lt.opDiagonal(t_(d)), lo.opDiagonal(jnp.asarray(d)), np.diag(d)
    if kind == 2 and m == n:
        return (lt.opEye(n, dtype=torch.complex128 if complex_ else torch.float64),
                lo.opEye(n, dtype=jnp.complex128 if complex_ else jnp.float64), np.eye(n))
    if kind == 3:
        A = randm((m, n)) * (rng.random((m, n)) < 0.5)
        fmt = ("csr", "coo", "ell")[rng.integers(0, 3)]
        return lt.opSparse(A, format=fmt, **CPU), lo.opSparse(A, format=fmt), A
    if kind == 4 and m == n and not complex_:
        h = rng.standard_normal(n)
        return (lt.opHouseholder(t_(h)), lo.opHouseholder(jnp.asarray(h)),
                np.eye(n) - 2 * np.outer(h, h))
    A = randm((m, n))
    return lt.LinearOperator(t_(A)), lo.LinearOperator(jnp.asarray(A)), A


def _graph(rng, m, n, depth, complex_):
    """A random graph of shape (m, n): (port, reference, dense)."""
    if depth == 0:
        return _leaf(rng, m, n, complex_)
    op_kind = rng.integers(0, 8)
    if op_kind == 0:  # scale
        gt, gj, D = _graph(rng, m, n, depth - 1, complex_)
        c = float(rng.standard_normal()) + (1j * float(rng.standard_normal()) if complex_ else 0.0)
        return c * gt, c * gj, c * D
    if op_kind == 1:  # sum
        g1t, g1j, D1 = _graph(rng, m, n, depth - 1, complex_)
        g2t, g2j, D2 = _graph(rng, m, n, depth - 1, complex_)
        return g1t + g2t, g1j + g2j, D1 + D2
    if op_kind == 2:  # compose through a random inner dim
        k = int(rng.integers(2, 7))
        g1t, g1j, D1 = _graph(rng, m, k, depth - 1, complex_)
        g2t, g2j, D2 = _graph(rng, k, n, depth - 1, complex_)
        return g1t @ g2t, g1j @ g2j, D1 @ D2
    if op_kind == 3:  # transpose of a flipped-shape graph
        gt, gj, D = _graph(rng, n, m, depth - 1, complex_)
        return lt.transpose(gt), lo.transpose(gj), D.T
    if op_kind == 4:  # adjoint
        gt, gj, D = _graph(rng, n, m, depth - 1, complex_)
        return lt.adjoint(gt), lo.adjoint(gj), D.conj().T
    if op_kind == 5:  # hcat of two half-width graphs
        n1 = max(1, n // 2)
        n2 = n - n1
        if n2 == 0:
            return _graph(rng, m, n, depth - 1, complex_)
        g1t, g1j, D1 = _graph(rng, m, n1, depth - 1, complex_)
        g2t, g2j, D2 = _graph(rng, m, n2, depth - 1, complex_)
        return lt.hcat(g1t, g2t), lo.hcat(g1j, g2j), np.hstack([D1, D2])
    if op_kind == 6 and m == n:  # shift
        gt, gj, D = _graph(rng, m, n, depth - 1, complex_)
        s = float(rng.standard_normal())
        return lt.ShiftedOperator(gt, s), lo.ShiftedOperator(gj, s), D + s * np.eye(n)
    if op_kind == 7 and m == n:  # symmetrizers (structural-flag Sum nodes)
        gt, gj, D = _graph(rng, m, n, depth - 1, complex_)
        if rng.integers(0, 2):
            ht, hj = gt.hermitianized(), gj.hermitianized()
            assert ht.hermitian and hj.hermitian
            return ht, hj, (D + D.conj().T) / 2
        st, sj = gt.symmetrized(), gj.symmetrized()
        assert st.symmetric and sj.symmetric
        return st, sj, (D + D.T) / 2
    return _graph(rng, m, n, depth - 1, complex_)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("complex_", [False, True])
def test_random_graphs_vs_reference_and_dense(seed, complex_):
    rng = np.random.default_rng(1000 + seed)
    m = int(rng.integers(2, 9))
    n = int(rng.integers(2, 9))
    depth = int(rng.integers(1, 4))
    op_t, op_j, D = _graph(rng, m, n, depth, complex_)
    assert op_t.shape == op_j.shape == D.shape
    assert (op_t.symmetric, op_t.hermitian) == (op_j.symmetric, op_j.hermitian)

    def rvec(k):
        v = rng.standard_normal(k)
        return v + 1j * rng.standard_normal(k) if complex_ else v

    scale = max(np.abs(D).max(), 1.0)
    v, u = rvec(n), rvec(m)
    M = np.stack([rvec(n) for _ in range(3)], axis=1)
    for got, ref, dense in (
            (op_t * t_(v), op_j * jnp.asarray(v), D @ v),
            (op_t.T * t_(u), op_j.T * jnp.asarray(u), D.T @ u),
            (op_t.H * t_(u), op_j.H * jnp.asarray(u), D.conj().T @ u),
            (op_t.to_dense(), op_j.to_dense(), D),
            (op_t.matmat(t_(M)), op_j.matmat(jnp.asarray(M)), D @ M)):
        close(got, ref)
        np.testing.assert_allclose(got.resolve_conj().numpy(), dense, rtol=RTOL,
                                   atol=RTOL * scale * 10)
