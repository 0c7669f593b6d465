"""Parity of the port's LOBPCG, svds, rsvd and Nyström preconditioner with
the JAX reference, in f64 on the CPU (mirrors test_eig.py).

LOBPCG is held in f64 (its default ``gram`` basis squares the basis
condition number). Both packages start from the same X0 block: they take
the same iteration count (±1), their eigenvalues agree within 1e-8
relative, and their eigenvector blocks span the same space (the projectors
agree within 1e-6). ``svds`` goes through the same LOBPCG; ``rsvd`` and the
Nyström sketch take the same Gaussian block through ``_rsvd`` /
``_nystrom_sketch`` and agree within 1e-10 relative in the singular values
and eigenvalues."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.utils import eig as jeig
from linops_tpu_torch.utils import eig as teig

CPU = dict(device="cpu")


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def spectrum_op(rng, lam, complex_=False):
    n = len(lam)
    Z = rng.standard_normal((n, n))
    if complex_:
        Z = Z + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(Z)
    A = (Q * lam) @ Q.conj().T
    A = (A + A.conj().T) / 2
    kw = dict(symmetric=not complex_, hermitian=True)
    return A, lt.LinearOperator(A, **CPU, **kw), lo.LinearOperator(A, **kw)


def proj(X):
    X = X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    Q, _ = np.linalg.qr(X)
    return Q @ Q.conj().T


def lobpcg_parity(op_t, op_j, X0, **kw):
    th_t, X_t, r_t, it_t = lt.lobpcg(op_t, X0=torch.from_numpy(X0), **kw)
    th_j, X_j, r_j, it_j = lo.lobpcg(op_j, X0=jnp.asarray(X0), **kw)
    assert abs(it_t - it_j) <= 1, (it_t, it_j)
    th_j = np.asarray(th_j)
    assert np.abs(th_t.numpy() - th_j).max() <= 1e-8 * max(np.abs(th_j).max(), 1.0)
    assert np.abs(proj(X_t) - proj(X_j)).max() <= 1e-6
    return th_t, X_t, r_t, it_t


@pytest.mark.parametrize("basis", ["gram", "direct"])
@pytest.mark.parametrize("largest", [False, True])
def test_lobpcg_matches_reference(rng, basis, largest):
    n, k = 80, 3
    lam = np.linspace(1.0, 100.0, n)
    A, op_t, op_j = spectrum_op(rng, lam)
    X0 = rng.standard_normal((n, k))
    th, X, res, it = lobpcg_parity(op_t, op_j, X0, k=k, largest=largest, tol=1e-8,
                                   maxiter=500, basis=basis)
    want = lam[::-1][:k] if largest else lam[:k]
    np.testing.assert_allclose(th.numpy(), want, rtol=1e-6)
    assert it < 500
    assert (res.numpy() <= 1e-8 * np.maximum(np.abs(th.numpy()), 1.0)).all()


def test_lobpcg_preconditioned(rng):
    n, k = 60, 2
    lam = np.linspace(1.0, 1000.0, n)
    A, op_t, op_j = spectrum_op(rng, lam)
    Minv = np.linalg.inv(A + 5 * np.eye(n))
    X0 = rng.standard_normal((n, k))
    M_t, M_j = lt.LinearOperator(Minv, **CPU), lo.LinearOperator(Minv)
    th_t, _, _, it_t = lt.lobpcg(op_t, X0=torch.from_numpy(X0), k=k, M=M_t, tol=1e-8,
                                 maxiter=300)
    th_j, _, _, it_j = lo.lobpcg(op_j, X0=jnp.asarray(X0), k=k, M=M_j, tol=1e-8, maxiter=300)
    assert abs(it_t - it_j) <= 1
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-8)
    _, _, _, it_plain = lt.lobpcg(op_t, X0=torch.from_numpy(X0), k=k, tol=1e-8, maxiter=300)
    assert it_t < it_plain


def test_lobpcg_complex_hermitian(rng):
    n, k = 40, 2
    lam = np.linspace(-5.0, 5.0, n)
    A, op_t, op_j = spectrum_op(rng, lam, complex_=True)
    X0 = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    lobpcg_parity(op_t, op_j, X0, k=k, tol=1e-8, maxiter=400)


def test_lobpcg_on_stencil_operator():
    g = 16
    L_t = lt.laplacian_2d(g, g, dtype=torch.float64, **CPU)
    L_j = lo.laplacian_2d(g, g, dtype=jnp.float64)
    X0 = np.random.default_rng(5).standard_normal((g * g, 2))
    th, _, _, _ = lobpcg_parity(L_t, L_j, X0, k=2, largest=True, tol=1e-7, maxiter=400)
    i = np.arange(1, g + 1)
    ev = np.sort((4 - 2 * np.cos(i[:, None] * np.pi / (g + 1))
                  - 2 * np.cos(i[None, :] * np.pi / (g + 1))).ravel())[::-1]
    np.testing.assert_allclose(th.numpy(), ev[:2], rtol=1e-6)


def test_lobpcg_block_size_and_constraints(rng):
    n = 60
    lam = np.arange(1.0, n + 1.0)
    A, op_t, op_j = spectrum_op(rng, lam)
    th, X, _, _ = lt.lobpcg(op_t, k=2, block_size=4, tol=1e-9, maxiter=400, generator=gen())
    np.testing.assert_allclose(th.numpy(), lam[:2], rtol=1e-7)
    # the next two eigenpairs with the first two as constraints
    X0 = rng.standard_normal((n, 2))
    th2, X2, _, _ = lobpcg_parity(op_t, op_j, X0, k=2, Y=X.numpy(), tol=1e-9, maxiter=400)
    np.testing.assert_allclose(th2.numpy(), lam[2:4], rtol=1e-7)
    assert np.abs(X.numpy().T @ X2.numpy()).max() <= 1e-7


def test_lobpcg_validation(rng):
    A, op_t, _ = spectrum_op(rng, np.linspace(1, 2, 12))
    with pytest.raises(ValueError):
        lt.lobpcg(op_t, k=5)
    with pytest.raises(ValueError):
        lt.lobpcg(op_t, k=1, basis="nope")
    with pytest.raises(lt.LinearOperatorException):
        lt.lobpcg(lt.LinearOperator(A, **CPU), k=1)  # not flagged hermitian
    with pytest.raises(lt.LinearOperatorException):
        lt.lobpcg(op_t, k=2, X0=np.ones((12, 2)))  # rank deficient
    with pytest.raises(lt.LinearOperatorException):
        lt.lobpcg(op_t, k=1, M=lt.LinearOperator(np.eye(5), **CPU))
    with pytest.raises(ValueError):
        lt.lobpcg(op_t, k=2, block_size=1)


def test_lobpcg_f32_stays_finite(rng):
    n = 200
    lam = np.linspace(1.0, 50.0, n)
    A, _, _ = spectrum_op(rng, lam)
    op = lt.LinearOperator(A.astype(np.float32), symmetric=True, hermitian=True, **CPU)
    th, X, res, it = lt.lobpcg(op, k=2, tol=1e-4, maxiter=300, generator=gen())
    assert th.dtype == torch.float32 and torch.isfinite(th).all() and torch.isfinite(X).all()
    np.testing.assert_allclose(th.numpy(), lam[:2], rtol=1e-3)
    R = A @ X.double().numpy() - X.double().numpy() * th.double().numpy()
    np.testing.assert_allclose(np.linalg.norm(R, axis=0), res.double().numpy(), atol=1e-3)


@pytest.mark.parametrize("shape", [(50, 30), (30, 50)])
def test_svds_matches_reference_and_dense(rng, shape):
    A = rng.standard_normal(shape)
    op_t = lt.LinearOperator(A, **CPU)
    U, s, V, res, it = lt.svds(op_t, k=3, tol=1e-9, maxiter=500, generator=gen())
    sd = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(s.numpy(), sd[:3], rtol=1e-8)
    np.testing.assert_allclose(A @ V.numpy(), U.numpy() * s.numpy(), atol=1e-7)
    Uj, sj, Vj, _, _ = lo.svds(lo.LinearOperator(A), k=3, tol=1e-9, maxiter=500)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-8)


def test_svds_smallest_and_complex(rng):
    A = rng.standard_normal((40, 20))
    _, s, _, _, _ = lt.svds(lt.LinearOperator(A, **CPU), k=2, largest=False, tol=1e-10,
                            maxiter=800, generator=gen())
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(A, compute_uv=False)[::-1][:2],
                               rtol=1e-6)
    Z = rng.standard_normal((30, 25)) + 1j * rng.standard_normal((30, 25))
    U, s, V, _, _ = lt.svds(lt.LinearOperator(Z, **CPU), k=2, tol=1e-9, maxiter=500,
                            generator=gen())
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(Z, compute_uv=False)[:2], rtol=1e-8)
    np.testing.assert_allclose(Z @ V.numpy(), U.numpy() * s.numpy(), atol=1e-7)


def test_gram_operator_matches_reference(rng):
    A = rng.standard_normal((9, 6))
    for side in ("right", "left"):
        g_t = teig._GramOperator(lt.LinearOperator(A, **CPU), side)
        g_j = jeig._GramOperator(lo.LinearOperator(A), side)
        assert g_t.hermitian and g_t.symmetric and g_t.shape == g_j.shape
        np.testing.assert_allclose(g_t.to_dense().numpy(), np.asarray(g_j.to_dense()),
                                   rtol=1e-12)
        assert lt.check_hermitian(g_t)


@pytest.mark.parametrize("power_iters", [0, 2])
def test_rsvd_same_block(rng, power_iters):
    m, n, l = 60, 40, 12
    A = rng.standard_normal((m, 8)) @ rng.standard_normal((8, n)) + 1e-3 * rng.standard_normal(
        (m, n))
    G = rng.standard_normal((n, l))
    U_t, s_t, V_t = teig._rsvd(lt.LinearOperator(A, **CPU), torch.from_numpy(G), power_iters)
    U_j, s_j, V_j = jeig._rsvd_jit(lo.LinearOperator(A), jnp.asarray(G), power_iters)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-10)
    np.testing.assert_allclose((U_t * s_t) @ V_t.T, np.asarray((U_j * s_j) @ V_j.T), atol=1e-10)


def test_rsvd_exact_on_low_rank(rng):
    A = rng.standard_normal((50, 5)) @ rng.standard_normal((5, 30))
    U, s, V = lt.rsvd(lt.LinearOperator(A, **CPU), 5, generator=gen())
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(A, compute_uv=False)[:5], rtol=1e-10)
    np.testing.assert_allclose((U * s).numpy() @ V.numpy().T, A, atol=1e-9)
    with pytest.raises(ValueError):
        lt.rsvd(lt.LinearOperator(A, **CPU), 0)


def test_nystrom_sketch_and_preconditioner(rng):
    n, l = 80, 20
    lam = np.concatenate([np.logspace(3, 0, 15), 1e-3 * np.ones(n - 15)])
    A, op_t, op_j = spectrum_op(rng, lam)
    Om = rng.standard_normal((n, l))
    U_t, lam_t = teig._nystrom_sketch(op_t, torch.from_numpy(Om))
    U_j, lam_j = jeig._nystrom_sketch(op_j, jnp.asarray(Om))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-10,
                               atol=1e-10 * float(lam_j[0]))
    mu = 0.1
    P_t = lt.NystromPreconditioner(U_t[:, :15], lam_t[:15], mu)
    P_j = jeig.NystromPreconditioner(U_j[:, :15], lam_j[:15], mu)
    v = rng.standard_normal(n)
    np.testing.assert_allclose((P_t @ torch.from_numpy(v)).numpy(), np.asarray(P_j @ v),
                               rtol=1e-9, atol=1e-9 * np.abs(v).max())
    shifted = op_t + mu * lt.opEye(n, dtype=torch.float64)
    b = torch.from_numpy(rng.standard_normal(n))
    P = lt.nystrom_preconditioner(op_t, 15, mu=mu, generator=gen())
    _, it_p, _ = lt.cg(shifted, b, tol=1e-10, maxiter=500, M=P)
    _, it_0, _ = lt.cg(shifted, b, tol=1e-10, maxiter=500)
    assert it_p < it_0


def test_nystrom_rank_truncates(rng):
    U = rng.standard_normal((40, 3))
    op = lt.LinearOperator(U @ U.T, symmetric=True, hermitian=True, **CPU)
    P = lt.nystrom_preconditioner(op, 10, mu=1.0, generator=gen())
    assert P.lam.shape[0] == 3
    with pytest.raises(lt.LinearOperatorException):
        lt.nystrom_preconditioner(lt.LinearOperator(np.zeros((10, 10)), symmetric=True,
                                                    hermitian=True, **CPU), 2, generator=gen())
