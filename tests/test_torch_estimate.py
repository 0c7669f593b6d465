"""Parity of the port's norm estimators, stochastic estimators and property
checks with the JAX reference, in f64 (and complex128) on the CPU (mirrors
test_normest.py, test_estimate.py and the checks).

JAX and torch random streams never agree, so the randomized parts take the
same probe blocks through the helpers that accept them explicitly:
``_hutchinson``, ``_hutchpp``, ``_diag_probes``, ``_slq``,
``_normest_jit``/``_normest_loop``, ``_lanczos_extreme``, ``_funm_jit``/
``_funm`` and the checks' ``_rand``. On the same probes the estimates agree
within 1e-10 relative (the power iteration: its count ±1 and 1e-8); the
public functions, on the port's own probes, meet the reference tests'
accuracy targets against dense truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import simple_matrix
from linops_tpu.utils import checks as jchecks
from linops_tpu.utils import estimate as jest
from linops_tpu.utils import norm as jnorm
from linops_tpu_torch.utils import checks as tchecks
from linops_tpu_torch.utils import estimate as test_
from linops_tpu_torch.utils import norm as tnorm

RTOL = 1e-10
CPU = dict(device="cpu")


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def spd(rng, n, spread=(1.0, 10.0)):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(*spread, n)
    return (Q * lam) @ Q.T, lam


def pair(A, **kw):
    return lt.LinearOperator(A, **CPU, **kw), lo.LinearOperator(A, **kw)


def signs(rng, shape):
    return np.where(rng.standard_normal(shape) < 0, -1.0, 1.0)


# --------------------------------------------------------------------------
# normest / estimate_opnorm (test_normest.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(30, 20), (20, 30), (25, 25)])
def test_normest_loop_matches_reference(rng, shape):
    A = rng.standard_normal(shape)
    op_t, op_j = pair(A)
    m = shape[0]
    v0, noise = signs(rng, m), rng.standard_normal(m)
    e_j, c_j = jnorm._normest_jit(op_j, jnp.asarray(v0), jnp.asarray(noise),
                                  jnp.asarray(1e-10), 1000)
    e_t, c_t = tnorm._normest_loop(op_t, torch.from_numpy(v0), torch.from_numpy(noise), 1e-10,
                                   1000)
    assert abs(c_t - int(c_j)) <= 1
    assert abs(e_t - float(e_j)) <= 1e-8 * float(e_j)
    assert abs(e_t - np.linalg.norm(A, 2)) <= 1e-6 * np.linalg.norm(A, 2)


def test_normest_public_and_zero_operator(rng):
    A = rng.standard_normal((30, 20))
    est, cnt = lt.normest(lt.LinearOperator(A, **CPU), tol=1e-10, maxiter=1000,
                          generator=gen(1))
    assert abs(est - np.linalg.norm(A, 2)) <= 1e-6 * np.linalg.norm(A, 2) and 0 < cnt <= 1000
    est2, _ = lt.normest(torch.from_numpy(A), tol=1e-10, maxiter=1000, generator=gen(1))
    assert est2 == est
    assert lt.normest(lt.opZeros(5, 5, dtype=torch.float64, **CPU), generator=gen()) == (0.0, 0)


def test_normest_warns_without_convergence(rng):
    A = rng.standard_normal((40, 40))
    with pytest.warns(UserWarning, match="did not converge"):
        _, cnt = lt.normest(lt.LinearOperator(A, **CPU), tol=1e-16, maxiter=2, generator=gen())
    assert cnt == 3


def test_estimate_opnorm_tiny_dense(rng):
    A = rng.standard_normal((4, 3))
    est, ok = lt.estimate_opnorm(lt.LinearOperator(A, **CPU))
    assert ok and abs(est - float(lo.estimate_opnorm(lo.LinearOperator(A))[0])) <= 1e-12 * est


@pytest.mark.parametrize("gram", [False, True])
def test_lanczos_extreme_matches_reference(rng, gram):
    n = 40
    A = rng.standard_normal((n, n))
    A = A + A.T if not gram else A
    op_t, op_j = pair(A, symmetric=not gram, hermitian=not gram)
    v0 = rng.standard_normal(n)
    th_j, r_j = jnorm._lanczos_extreme(op_j, jnp.asarray(v0), 20, gram)
    th_t, r_t = tnorm._lanczos_extreme(op_t, torch.from_numpy(v0), 20, gram)
    close(th_t, th_j)
    assert abs(float(r_t) - float(r_j)) <= 1e-8 * abs(float(th_j))


def test_estimate_opnorm_hermitian_and_general(rng):
    B, _ = spd(rng, 50)
    est, ok = lt.estimate_opnorm(lt.LinearOperator(B, symmetric=True, hermitian=True, **CPU),
                                 generator=gen())
    assert ok and abs(est - np.linalg.norm(B, 2)) <= 1e-8 * np.linalg.norm(B, 2)
    A = rng.standard_normal((60, 40))
    est, ok = lt.estimate_opnorm(lt.LinearOperator(A, **CPU), generator=gen())
    assert ok and abs(est - np.linalg.norm(A, 2)) <= 1e-6 * np.linalg.norm(A, 2)


def test_estimate_opnorm_lobpcg_fallback_on_clustered_edge():
    ng = 16
    n = ng * ng
    A = lt.laplacian_2d(ng, ng, dtype=torch.float64, **CPU) + lt.opDiagonal(
        torch.linspace(0.0, 1e-9, n, dtype=torch.float64))
    dense = A.to_dense().numpy()
    truth = np.abs(np.linalg.eigvalsh(dense)).max()
    with pytest.warns(UserWarning):
        nrm, ok = lt.estimate_opnorm(A, generator=gen(3), ncv=8, max_attempts=1)
    assert ok and abs(nrm - truth) <= 1e-6 * truth


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------


def test_checks_on_the_reference_probes(monkeypatch, rng):
    """Each check on the probe the reference draws returns the reference's
    verdict."""
    n = 12
    A = rng.standard_normal((n, n))
    H = A + A.T
    S = A @ A.T + n * np.eye(n)
    cases = [("check_ctranspose", A, {}), ("check_hermitian", H, dict(hermitian=True)),
             ("check_hermitian", A, {}), ("check_positive_definite", S, dict(hermitian=True)),
             ("check_positive_definite", -S, dict(hermitian=True))]
    for name, M, kw in cases:
        op_t, op_j = pair(M, **kw)
        key = jax.random.PRNGKey(7)
        probes = []
        real_rand = jchecks._rand

        def capture(k, m, op, _real=real_rand):
            p = _real(k, m, op)
            probes.append(np.asarray(p))
            return p

        monkeypatch.setattr(jchecks, "_rand", capture)
        want = getattr(jchecks, name)(op_j, key=key)
        it = iter(probes)
        monkeypatch.setattr(tchecks, "_rand", lambda g, m, op, dev: torch.tensor(next(it)))
        assert getattr(lt, name)(op_t, generator=gen()) == want, name
        monkeypatch.undo()


def test_checks_public(rng):
    A = simple_matrix(np.float64, 6, 6, rng)
    op = lt.LinearOperator(A, **CPU)
    assert lt.check_ctranspose(op)
    H = A + A.T
    assert lt.check_hermitian(lt.LinearOperator(H, hermitian=True, **CPU))
    assert not lt.check_hermitian(op)
    spd_ = A @ A.T + np.eye(6)
    assert lt.check_positive_definite(lt.LinearOperator(spd_, hermitian=True, **CPU))
    assert not lt.check_positive_definite(lt.LinearOperator(-spd_, hermitian=True, **CPU))
    assert lt.check_hermitian(torch.from_numpy(H)) and lt.check_ctranspose(torch.from_numpy(A))
    M = lt.LinearOperator(np.arange(16).reshape(4, 4) + np.arange(16).reshape(4, 4).T, **CPU)
    assert M.dtype == torch.int64 and lt.check_hermitian(M) and lt.check_ctranspose(M)
    Z = simple_matrix(np.complex128, 5, 5, rng)
    assert lt.check_ctranspose(lt.LinearOperator(Z, **CPU))
    with pytest.raises(lt.LinearOperatorException):
        lt.check_hermitian(lt.LinearOperator(np.ones((3, 4)), **CPU))


# --------------------------------------------------------------------------
# trace and diagonal (test_estimate.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 40])
def test_hutchinson_same_probes(rng, k):
    A = rng.standard_normal((30, 30))
    op_t, op_j = pair(A)
    G = signs(rng, (30, k))
    est_j, se_j = jest._hutchinson(op_j, jnp.asarray(G))
    est_t, se_t = test_._hutchinson(op_t, torch.from_numpy(G))
    close(est_t, est_j)
    close(se_t, se_j)


def test_hutchpp_same_probes(rng):
    A, _ = spd(rng, 40)
    op_t, op_j = pair(A, symmetric=True, hermitian=True)
    S, G = signs(rng, (40, 6)), signs(rng, (40, 8))
    est_j, se_j = jest._hutchpp(op_j, jnp.asarray(S), jnp.asarray(G))
    est_t, se_t = test_._hutchpp(op_t, torch.from_numpy(S), torch.from_numpy(G))
    close(est_t, est_j)
    close(se_t, se_j, rtol=1e-8)


def test_hutchpp_exact_on_low_rank(rng):
    n, r = 60, 5
    U = rng.standard_normal((n, r))
    A = U @ U.T
    est, _ = lt.estimate_trace(lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU),
                               probes=18, generator=gen())
    assert abs(est - np.trace(A)) <= 1e-8 * abs(np.trace(A))


def test_trace_public_methods(rng):
    A, lam = spd(rng, 80, (1.0, 3.0))
    op = lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU)
    for method in ("hutchinson", "hutchpp"):
        est, se = lt.estimate_trace(op, probes=300, method=method, generator=gen(2))
        assert abs(est - lam.sum()) <= 6 * se + 1e-9 * lam.sum()
    with pytest.raises(ValueError):
        lt.estimate_trace(op, probes=2)
    with pytest.raises(ValueError):
        lt.estimate_trace(op, method="nope")
    with pytest.raises(lt.LinearOperatorException):
        lt.estimate_trace(lt.LinearOperator(np.ones((3, 4)), **CPU))


def test_trace_complex_and_lazy_graph(rng):
    Z = simple_matrix(np.complex128, 10, 10, rng)
    est, _ = lt.estimate_trace(lt.LinearOperator(Z, **CPU), probes=3000, method="hutchinson",
                               generator=gen())
    assert isinstance(est, complex) and abs(est - np.trace(Z)) <= 0.5
    D = lt.opDiagonal(torch.linspace(1.0, 2.0, 20, dtype=torch.float64))
    # Rademacher probes are exact on a diagonal: gᵀDg = tr D
    est, _ = lt.estimate_trace(D @ D + 2 * lt.opEye(20, dtype=torch.float64), probes=3,
                               method="hutchinson", generator=gen())
    assert abs(est - (np.linspace(1, 2, 20) ** 2 + 2).sum()) <= 1e-9


@pytest.mark.parametrize("k", [1, 16])
def test_diag_probes_same_probes(rng, k):
    A = rng.standard_normal((25, 25))
    op_t, op_j = pair(A)
    G = signs(rng, (25, k))
    d_j, s_j = jest._diag_probes(op_j, jnp.asarray(G))
    d_t, s_t = test_._diag_probes(op_t, torch.from_numpy(G))
    close(d_t, d_j)
    if k > 1:
        close(s_t, s_j)
    else:
        assert not s_t.any()


def test_diagonal_exact_on_diagonal_operator():
    d = np.linspace(-1.0, 3.0, 17)
    est, se = lt.estimate_diagonal(lt.opDiagonal(d, **CPU), probes=4, generator=gen())
    close(est, d, rtol=1e-15)
    assert float(se.max()) == 0.0


# --------------------------------------------------------------------------
# SLQ and funm_apply
# --------------------------------------------------------------------------


@pytest.mark.parametrize("reorth", [True, False])
@pytest.mark.parametrize("f", ["log", "inv", "exp"])
def test_slq_same_probes(rng, reorth, f):
    n, k, m = 40, 6, 20
    A, _ = spd(rng, n)
    op_t, op_j = pair(A, symmetric=True, hermitian=True)
    G = signs(rng, (n, k))
    V0 = G / np.linalg.norm(G, axis=0, keepdims=True)
    fj = {"log": jnp.log, "inv": jnp.reciprocal, "exp": jnp.exp}[f]
    ft = {"log": torch.log, "inv": torch.reciprocal, "exp": torch.exp}[f]
    s_j = jest._slq(op_j, jnp.asarray(V0), m, reorth, fj)
    s_t = test_._slq(op_t, torch.from_numpy(V0), m, reorth, ft)
    close(s_t, s_j, rtol=1e-9 if not reorth else RTOL)


def test_logdet_and_spectral_sums(rng):
    A, lam = spd(rng, 50, (1.0, 5.0))
    op = lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU)
    est, se = lt.estimate_logdet(op, probes=64, lanczos_steps=30, generator=gen())
    assert abs(est - np.log(lam).sum()) <= 6 * se + 1e-8
    est, se = lt.estimate_spectral_sum(op, torch.reciprocal, probes=64, generator=gen())
    assert abs(est - (1 / lam).sum()) <= 6 * se + 1e-8


def test_slq_exact_on_scaled_identity_and_nan_on_indefinite(rng):
    I = lt.LinearOperator(2.5 * np.eye(20), symmetric=True, hermitian=True, **CPU)
    est, se = lt.estimate_logdet(I, probes=4, generator=gen())
    assert abs(est - 20 * np.log(2.5)) <= 1e-10 and se <= 1e-10
    B = rng.standard_normal((20, 20))
    S = lt.LinearOperator(B + B.T, symmetric=True, hermitian=True, **CPU)
    est, _ = lt.estimate_logdet(S, probes=4, generator=gen())
    assert np.isnan(est)
    with pytest.raises(lt.LinearOperatorException):
        lt.estimate_logdet(lt.LinearOperator(B, **CPU))
    with pytest.raises(ValueError):
        lt.estimate_spectral_sum(I, torch.log, probes=0)


@pytest.mark.parametrize("f", ["exp", "inv"])
@pytest.mark.parametrize("steps", [10, 40])
def test_funm_same_start(rng, f, steps):
    n = 40
    A, _ = spd(rng, n, (0.5, 3.0))
    op_t, op_j = pair(A, symmetric=True, hermitian=True)
    b = rng.standard_normal(n)
    fj = {"exp": jnp.exp, "inv": jnp.reciprocal}[f]
    ft = {"exp": torch.exp, "inv": torch.reciprocal}[f]
    close(lt.funm_apply(op_t, ft, torch.from_numpy(b), lanczos_steps=steps),
          lo.funm_apply(op_j, fj, jnp.asarray(b), lanczos_steps=steps))
    if steps >= n:
        want = scipy.linalg.expm(A) @ b if f == "exp" else np.linalg.solve(A, b)
        close(lt.funm_apply(op_t, ft, torch.from_numpy(b), lanczos_steps=steps), want,
              rtol=1e-9)


def test_funm_complex_and_edge_cases(rng):
    n = 12
    Z = simple_matrix(np.complex128, n, n, rng)
    H = Z @ Z.conj().T + np.eye(n)
    op_t, op_j = pair(H, hermitian=True)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    close(lt.funm_apply(op_t, torch.exp, torch.from_numpy(b), lanczos_steps=n),
          lo.funm_apply(op_j, jnp.exp, jnp.asarray(b), lanczos_steps=n))
    # a complex b on a real operator promotes; a zero b gives zero
    A, _ = spd(rng, n)
    op_r = lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU)
    y = lt.funm_apply(op_r, torch.exp, torch.from_numpy(b), lanczos_steps=n)
    close(y, scipy.linalg.expm(A) @ b, rtol=1e-9)
    z = lt.funm_apply(op_r, torch.log, torch.zeros(n, dtype=torch.float64))
    assert torch.equal(z, torch.zeros(n, dtype=torch.float64))
    # an invariant subspace found early: the guard keeps log finite
    e = lt.funm_apply(lt.LinearOperator(2.0 * np.eye(n), symmetric=True, hermitian=True, **CPU),
                      torch.log, torch.ones(n, dtype=torch.float64))
    close(e, np.log(2.0) * np.ones(n), rtol=1e-12)
    with pytest.raises(lt.LinearOperatorException):
        lt.funm_apply(op_r, torch.exp, torch.ones(n + 1, dtype=torch.float64))
