"""Parity of the port's operator zoo with the JAX reference, in f64 (and
complex128) on the CPU: ``KronOperator``/``kron`` (mirrors test_kron.py),
the factorization-backed inverses, Householder and hermitian operators
(test_linalg_ops.py), ``TimedOperator`` (the timed cases of
test_special_ops.py and test_linalg_ops.py), ``opSparseInverse`` /
``opSparseLDL`` and ``opIterativeInverse``.

The same numpy inputs go through both packages. Direct operators agree
within max|Δ| ≤ 1e-10·max|ref|; the iterative inverse takes the reference's
inner iteration count (±1) with x within 1e-8·‖x‖, as the solver tests do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import simple_matrix, simple_vector

RTOL = 1e-10
DTYPES = [np.float64, np.complex128]
CPU = dict(device="cpu")


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def vec(dtype, n, rng):
    v = rng.standard_normal(n)
    if dtype == np.complex128:
        v = v + 1j * rng.standard_normal(n)
    return v


def all_modes(op_t, op_j, n_in, n_out, dtype, rng):
    """N, T, H and C applies, vector and matrix, of both packages agree."""
    for mode in ("N", "T", "H", "C"):
        k = n_out if mode in ("T", "H") else n_in
        v = vec(dtype, k, rng)
        close(lt.matvec(op_t, torch.from_numpy(v), mode=mode),
              lo.matvec(op_j, jnp.asarray(v), mode=mode))
        M = np.stack([vec(dtype, k, rng) for _ in range(3)], axis=1)
        close(lt.matmat(op_t, torch.from_numpy(M), mode=mode),
              lo.matmat(op_j, jnp.asarray(M), mode=mode))


# --------------------------------------------------------------------------
# kron (test_kron.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shapes", [((3, 3), (2, 2)), ((4, 2), (3, 5)), ((2, 5), (4, 3))])
def test_kron_probes(dtype, shapes, rng):
    (m, n), (p, q) = shapes
    A = simple_matrix(dtype, m, n, rng)
    B = simple_matrix(dtype, p, q, rng)
    op_t = lt.kron(lt.LinearOperator(A, **CPU), lt.LinearOperator(B, **CPU))
    op_j = lo.kron(lo.LinearOperator(A), lo.LinearOperator(B))
    assert op_t.shape == op_j.shape == np.kron(A, B).shape
    all_modes(op_t, op_j, n * q, m * p, dtype, rng)
    close(op_t.to_dense(), np.kron(A, B), rtol=1e-12)


def test_kron_mixed_and_dense(rng):
    A = simple_matrix(np.float64, 2, 2, rng)
    B = simple_matrix(np.float64, 3, 3, rng)
    K = lt.kron(A, B, **CPU)
    assert isinstance(K, torch.Tensor) and K.device.type == "cpu"
    close(K, lo.kron(A, B))
    op_t = lt.kron(lt.LinearOperator(A, **CPU), torch.from_numpy(B))
    op_j = lo.kron(lo.LinearOperator(A), B)
    assert isinstance(op_t, lt.AbstractLinearOperator)
    x = rng.standard_normal(6)
    close(op_t @ torch.from_numpy(x), op_j @ jnp.asarray(x))


def test_kron_flags(rng):
    S = simple_matrix(np.float64, 3, 3, rng, symmetric=True)
    opS = lt.LinearOperator(S, symmetric=True, hermitian=True, **CPU)
    kk = lt.kron(opS, opS)
    assert kk.symmetric and kk.hermitian
    A = lt.LinearOperator(simple_matrix(np.float64, 3, 3, rng), **CPU)
    assert not lt.kron(opS, A).symmetric


def test_kron_to_dense_and_counters(rng):
    A = simple_matrix(np.float64, 2, 3, rng)
    B = simple_matrix(np.float64, 3, 2, rng)
    At, Bt = lt.LinearOperator(A, **CPU), lt.LinearOperator(B, **CPU)
    op = lt.kron(At, Bt)
    close(lt.to_dense(op), lo.to_dense(lo.kron(lo.LinearOperator(A), lo.LinearOperator(B))))
    op.reset_counters()
    At.reset_counters()
    op.T @ torch.ones(6, dtype=torch.float64)
    assert At.ntprod == 1 and Bt.ntprod == 1


# --------------------------------------------------------------------------
# linalg_ops (test_linalg_ops.py)
# --------------------------------------------------------------------------


def _spd(dtype, n, rng):
    A = simple_matrix(dtype, n, n, rng)
    return A @ A.conj().T + n * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_inverse(dtype, rng):
    M = simple_matrix(dtype, 5, 5, rng)
    op_t, op_j = lt.opInverse(M, **CPU), lo.opInverse(M)
    all_modes(op_t, op_j, 5, 5, dtype, rng)
    close(lt.to_dense(op_t @ lt.LinearOperator(M, **CPU)), np.eye(5), rtol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_cholesky(dtype, rng):
    M = _spd(dtype, 5, rng)
    op_t, op_j = lt.opCholesky(M, check=True, **CPU), lo.opCholesky(M, check=True)
    all_modes(op_t, op_j, 5, 5, dtype, rng)
    assert op_t.hermitian and op_t.symmetric == (dtype == np.float64)


def test_op_cholesky_check_rejects_and_nan(rng):
    M = simple_matrix(np.float64, 5, 5, rng)  # not symmetric
    with pytest.raises(lt.LinearOperatorException):
        lt.opCholesky(M, check=True, **CPU)
    N = -_spd(np.float64, 5, rng)
    with pytest.raises(lt.LinearOperatorException):
        lt.opCholesky(N, check=True, **CPU)
    # unchecked: a NaN factor, as jnp.linalg.cholesky leaves it
    y_t = lt.opCholesky(N, **CPU) @ torch.ones(5, dtype=torch.float64)
    y_j = lo.opCholesky(N) @ jnp.ones(5)
    assert torch.isnan(y_t).all() and np.isnan(np.asarray(y_j)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_ldl(dtype, rng):
    A = simple_matrix(dtype, 5, 5, rng)
    M = (A + A.conj().T) / 2 - 1.5 * np.eye(5)  # hermitian indefinite
    op_t, op_j = lt.opLDL(M, **CPU), lo.opLDL(M)
    all_modes(op_t, op_j, 5, 5, dtype, rng)
    v = simple_vector(dtype, 5)
    close(torch.from_numpy(M) @ (op_t @ torch.from_numpy(v)), v, rtol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_householder(dtype, rng):
    h = simple_vector(dtype, 5) / np.linalg.norm(simple_vector(dtype, 5))
    op_t, op_j = lt.opHouseholder(h, **CPU), lo.opHouseholder(h)
    all_modes(op_t, op_j, 5, 5, dtype, rng)
    assert op_t.hermitian and op_t.symmetric == (dtype == np.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_hermitian(dtype, rng):
    B = simple_matrix(dtype, 5, 5, rng)
    A = (B + B.conj().T) / 2
    d = np.real(np.diagonal(A)).astype(dtype)
    all_modes(lt.opHermitian(d, A, **CPU), lo.opHermitian(d, A), 5, 5, dtype, rng)
    all_modes(lt.opHermitian(A, **CPU), lo.opHermitian(A), 5, 5, dtype, rng)
    assert lt.opHermitian(A, **CPU).hermitian


def test_timed_operator(rng):
    A = simple_matrix(np.float64, 4, 4, rng)
    op = lt.TimedOperator(lt.LinearOperator(A, **CPU))
    op_j = lo.TimedOperator(lo.LinearOperator(A))
    v = simple_vector(np.float64, 4)
    close(op @ torch.from_numpy(v), op_j @ jnp.asarray(v))
    close(op.T @ torch.from_numpy(v), op_j.T @ jnp.asarray(v))
    assert op.timings["prod"][0] == 1 and op.timings["prod"][1] > 0
    assert isinstance(op.H, lt.TimedOperator) and isinstance(op.T, lt.TimedOperator)
    assert isinstance(op.conj(), lt.TimedOperator)
    assert "ncalls" in repr(op)
    assert lt.TimedLinearOperator is lt.TimedOperator


def test_timed_operator_counts_and_profiler_spans(rng):
    A = simple_matrix(np.float64, 6, 6, rng)
    inner = lt.LinearOperator(A, **CPU)
    op = lt.TimedOperator(inner)
    v = torch.ones(6, dtype=torch.float64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            op.matvec(v)
        op.matvec(v, mode="H")
    names = {e.key for e in prof.key_averages()}
    assert "linops.prod" in names and "linops.ctprod" in names
    assert op.timings["prod"][0] == 3 and op.timings["ctprod"][0] == 1
    assert op.nprod == inner.nprod == 3
    # the transposed wrapper counts on the same inner operator
    op.T @ v
    assert inner.ntprod == 1 and op.ntprod == 1


# --------------------------------------------------------------------------
# sparse factor
# --------------------------------------------------------------------------


def test_sparse_inverse(rng):
    from linops_tpu.ops.sparse_factor import opSparseInverse as j_inv, opSparseLDL as j_ldl

    n = 40
    A = (sps.random(n, n, density=0.2, random_state=3) + sps.eye(n) * n).tocsc()
    op_t, op_j = lt.opSparseInverse(A), j_inv(A)
    assert op_t.device is None and op_t.dtype == torch.float64
    all_modes(op_t, op_j, n, n, np.float64, rng)
    b = rng.standard_normal(n)
    x = (op_t @ torch.from_numpy(b)).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10
    S = (A + A.T) / 2
    xs = (lt.opSparseLDL(S, check=True) @ torch.from_numpy(b)).numpy()
    close(xs, j_ldl(S, check=True) @ jnp.asarray(b))
    assert np.linalg.norm(S @ xs - b) / np.linalg.norm(b) < 1e-10


def test_sparse_ldl_asymmetric_check():
    A = sps.random(10, 10, density=0.5, random_state=1).tocsc() + sps.eye(10)
    with pytest.raises(lt.LinearOperatorException):
        lt.opSparseLDL(A, check=True)


# --------------------------------------------------------------------------
# opIterativeInverse
# --------------------------------------------------------------------------


def _iter_parity(inv_t, inv_j, v, mode="N"):
    xt, kt, rt = inv_t.solve_info(torch.from_numpy(v), mode)
    xj, kj, rj = inv_j.solve_info(jnp.asarray(v), mode)
    assert abs(int(kt) - int(kj)) <= 1, (kt, kj)
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_iterative_inverse_hermitian(rng):
    n = 30
    A = simple_matrix(np.float64, n, n, rng, symmetric=True) + 3.0 * np.eye(n)
    inv_t = lt.opIterativeInverse(lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU),
                                  tol=1e-12, maxiter=200)
    inv_j = lo.opIterativeInverse(lo.LinearOperator(A, symmetric=True, hermitian=True),
                                  tol=1e-12, maxiter=200)
    assert inv_t.hermitian and inv_t.shape == (n, n)
    v = simple_vector(np.float64, n)
    _iter_parity(inv_t, inv_j, v)
    np.testing.assert_allclose((inv_t @ torch.from_numpy(v)).numpy(), np.linalg.solve(A, v),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mode", ["N", "T", "H"])
def test_iterative_inverse_nonsymmetric_modes(rng, mode):
    n = 24
    A = simple_matrix(np.float64, n, n, rng) + 4.0 * np.eye(n)
    inv_t = lt.opIterativeInverse(lt.LinearOperator(A, **CPU), tol=1e-12, maxiter=400)
    inv_j = lo.opIterativeInverse(lo.LinearOperator(A), tol=1e-12, maxiter=400)
    _iter_parity(inv_t, inv_j, simple_vector(np.float64, n), mode)


@pytest.mark.parametrize("solver", ["cg", "minres", "bicgstab", "gmres"])
def test_iterative_inverse_solvers(rng, solver):
    n = 20
    A = simple_matrix(np.float64, n, n, rng, symmetric=True) + 5.0 * np.eye(n)
    kw = dict(tol=1e-10, maxiter=100, solver=solver)
    inv_t = lt.opIterativeInverse(lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU),
                                  **kw)
    inv_j = lo.opIterativeInverse(lo.LinearOperator(A, symmetric=True, hermitian=True), **kw)
    _iter_parity(inv_t, inv_j, rng.standard_normal(n))


def test_iterative_inverse_as_preconditioner(rng):
    """The reference's case (``tests/test_linalg_ops.py``): inexact inner cg
    solves as the preconditioner of an outer cg. The nested solve runs in
    the outer loop's masked blocks, takes the reference's iterations and
    gives its x within 1e-10."""
    from linops_tpu_torch.utils import loop

    n = 40
    A = simple_matrix(np.float64, n, n, rng, symmetric=True) + 5.0 * np.eye(n)
    op = lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU)
    M = lt.opIterativeInverse(op, tol=1e-2, maxiter=10, solver="cg")
    b = simple_vector(np.float64, n)
    x, it, res = lt.cg(op, torch.from_numpy(b), tol=1e-10, maxiter=200, M=M)
    assert loop.stats["path"] == "blocks"
    assert float(res) < 1e-8 and it <= 6
    op_j = lo.LinearOperator(A, symmetric=True, hermitian=True)
    M_j = lo.opIterativeInverse(op_j, tol=1e-2, maxiter=10, solver="cg")
    x_j, it_j, _ = lo.cg(op_j, jnp.asarray(b), tol=1e-10, maxiter=200, M=M_j)
    assert it == int(it_j)
    close(x, x_j)


def test_iterative_inverse_validation_and_skew(rng):
    with pytest.raises(lt.LinearOperatorException):
        lt.opIterativeInverse(lt.LinearOperator(np.ones((3, 4)), **CPU))
    with pytest.raises(ValueError):
        lt.opIterativeInverse(lt.LinearOperator(np.eye(4), **CPU), solver="nope")
    n = 14
    K = rng.standard_normal((n, n))
    K = K - K.T  # skew: the auto solver (gmres) converges where bicgstab breaks down
    inv_t = lt.opIterativeInverse(lt.LinearOperator(K, **CPU), tol=1e-10, maxiter=300)
    inv_j = lo.opIterativeInverse(lo.LinearOperator(K), tol=1e-10, maxiter=300)
    _iter_parity(inv_t, inv_j, simple_vector(np.float64, n))


def test_timing_helpers_on_the_cpu():
    from linops_tpu_torch.utils.timing import Stopwatch, marginal_chain_time, sync

    A = torch.randn(64, 64, dtype=torch.float64)
    v = torch.ones(64, dtype=torch.float64)

    def run(iters):
        x = v
        for _ in range(iters):
            x = A @ x / 8.0
        return x

    sync(run(1))
    per = marginal_chain_time(run, iters_short=2, iters_long=12, reps=3, device="cpu")
    assert per > 0
    watch = Stopwatch("cpu")
    watch.start()
    run(5)
    assert watch.stop() > 0
