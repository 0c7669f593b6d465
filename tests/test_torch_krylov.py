"""The port's Krylov solvers (``linops_tpu_torch/utils/krylov.py``) against
the JAX reference's, on the CPU in f64.

Mirrors ``tests/test_krylov_solvers.py`` (22 tests) and ``tests/test_gmres.py``
(5 tests) case by case: the same operator, built from the same numpy data in
both packages, goes through the reference solver and the port's. Each case
keeps the reference test's own oracle (a dense numpy solve or lstsq) and
adds the parity checks:

- iterations (restarts for GMRES) equal, or within ±1 where the stopping
  test sits at rounding level (the two sum in other orders);
- ‖x − x_ref‖ ≤ 1e-8·‖x_ref‖;
- the returned residual within 1e-6 relative when the counts are equal.

Two reference tests exercise parts the port does not have: the L-SR1 model
(``lsr1.py`` is still to port) becomes an indefinite low-rank-plus-identity
model built in numpy, and the TPU residency hint (not ported) becomes the
matvec chain on a bf16 BSR operator against a hand-written loop.
"""

import jax.numpy as jnp
import numpy as np
import torch

import linops_tpu as lo
import linops_tpu_torch as lt


def _relres(A, x, b):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


def ops(A, **kw):
    """(reference operator, port operator) of one dense matrix."""
    return lo.LinearOperator(jnp.asarray(A), **kw), lt.LinearOperator(torch.from_numpy(A), **kw)


def np_of(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_solve(ref, got, b, k_slack=1, x_rtol=1e-8):
    """The parity checks on (x, k, res) of both solvers for the right-hand
    side b. A residual at rounding level (below 1e-10·‖b‖) only has to stay
    there."""
    (xj, kj, rj), (xt, kt, rt) = ref, got
    assert abs(int(kt) - int(kj)) <= k_slack, (int(kt), int(kj))
    xj, xt = np_of(xj), np_of(xt)
    assert xt.shape == xj.shape and xt.dtype == xj.dtype
    scale = max(np.linalg.norm(xj), 1e-300)
    assert np.linalg.norm(xt - xj) <= x_rtol * scale, np.linalg.norm(xt - xj) / scale
    rj, rt = np_of(rj), np_of(rt)
    if int(kt) == int(kj):
        floor = 1e-10 * np.linalg.norm(b)
        assert np.all(np.abs(rt - rj) <= 1e-6 * np.abs(rj) + floor), (rt, rj)


def both(solver, op_pair, b, *args, **kw):
    """Run ``solver`` of both packages on the same numpy inputs."""
    M = kw.pop("M", None)
    x0 = args[0] if args else None
    ref = getattr(lo, solver)(op_pair[0], jnp.asarray(b),
                              *(() if x0 is None else (jnp.asarray(x0),)),
                              **kw, **({} if M is None else {"M": M[0]}))
    got = getattr(lt, solver)(op_pair[1], torch.from_numpy(np.asarray(b)),
                              *(() if x0 is None else (torch.from_numpy(x0),)),
                              **kw, **({} if M is None else {"M": M[1]}))
    return ref, got


def diag_pair(d):
    return lo.opDiagonal(jnp.asarray(d)), lt.opDiagonal(torch.from_numpy(d))


# ---------------------------------------------------------------- MINRES

def test_minres_spd(rng):
    n = 40
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    ref, got = both("minres", ops(A, symmetric=True, hermitian=True), b, tol=1e-12, maxiter=4 * n)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-8 and got[1] <= n + 5


def test_minres_indefinite(rng):
    n = 50
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([rng.random(n // 2) + 1.0, -(rng.random(n - n // 2) + 1.0)])
    A = (Q * lam) @ Q.T
    b = rng.standard_normal(n)
    ref, got = both("minres", ops(A, symmetric=True, hermitian=True), b, tol=1e-12, maxiter=6 * n)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-7


def test_minres_preconditioned(rng):
    n = 60
    d = rng.random(n) * 100.0 + 1.0
    A = np.diag(d) + rng.standard_normal((n, n)) * 0.01
    A = (A + A.T) / 2
    pair = ops(A, symmetric=True, hermitian=True)
    b = rng.standard_normal(n)
    ref0, got0 = both("minres", pair, b, tol=1e-10, maxiter=8 * n)
    ref1, got1 = both("minres", pair, b, tol=1e-10, maxiter=8 * n, M=diag_pair(1.0 / d))
    same_solve(ref0, got0, b)
    same_solve(ref1, got1, b)
    assert _relres(A, got1[0], b) < 1e-7 and got1[1] <= got0[1]


def test_minres_hermitian_complex(rng):
    n = 24
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = M @ M.conj().T + n * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ref, got = both("minres", ops(A, symmetric=False, hermitian=True), b, tol=1e-12,
                    maxiter=6 * n)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-8


def test_minres_on_indefinite_model(rng):
    """The reference runs MINRES on an L-SR1 model (``lsr1.py`` is not ported
    yet): here the same kind of operator, identity plus rank-6 terms of both
    signs, as a dense symmetric indefinite matrix."""
    n = 30
    U = rng.standard_normal((n, 6))
    A = np.eye(n) + (U * np.array([3.0, -2.0, 1.5, -1.0, 2.5, -3.5])) @ U.T
    assert np.linalg.eigvalsh(A).min() < 0 < np.linalg.eigvalsh(A).max()
    b = rng.standard_normal(n)
    ref, got = both("minres", ops(A, symmetric=True, hermitian=True), b, tol=1e-11,
                    maxiter=8 * n)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-6


# -------------------------------------------------------------- BiCGSTAB

def test_bicgstab_nonsymmetric(rng):
    n = 40
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    ref, got = both("bicgstab", ops(A), b, tol=1e-12, maxiter=4 * n)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-8


def test_bicgstab_preconditioned(rng):
    n = 60
    d = rng.random(n) + 1.0
    A = rng.standard_normal((n, n)) * 0.05 + np.diag(d)
    b = rng.standard_normal(n)
    ref, got = both("bicgstab", ops(A), b, tol=1e-11, maxiter=4 * n, M=diag_pair(1.0 / d))
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-8


def test_bicgstab_complex(rng):
    n = 20
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ref, got = both("bicgstab", ops(A), b, tol=1e-12, maxiter=4 * n)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-8


def test_bicgstab_matches_gmres(rng):
    n = 32
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    pair = ops(A)
    b = rng.standard_normal(n)
    ref_b, got_b = both("bicgstab", pair, b, tol=1e-12, maxiter=4 * n)
    ref_g, got_g = both("gmres", pair, b, tol=1e-12, restart=n, maxiter=4)
    same_solve(ref_b, got_b, b)
    same_solve(ref_g, got_g, b)
    np.testing.assert_allclose(got_b[0].numpy(), got_g[0].numpy(), atol=1e-6)


# ------------------------------------------------------------------ LSQR

def test_lsqr_overdetermined(rng):
    m, n = 80, 30
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    ref, got = both("lsqr", ops(A), b, tol=1e-12, maxiter=6 * n)
    same_solve(ref, got, b)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-7)


def test_lsqr_underdetermined_consistent(rng):
    m, n = 20, 50
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n)
    ref, got = both("lsqr", ops(A), b, tol=1e-13, maxiter=8 * m)
    same_solve(ref, got, b)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-7)


def test_lsqr_damped(rng):
    m, n, damp = 60, 25, 0.7
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    ref, got = both("lsqr", ops(A), b, damp=damp, tol=1e-13, maxiter=10 * n)
    same_solve(ref, got, b)
    x_ref = np.linalg.solve(A.T @ A + damp ** 2 * np.eye(n), A.T @ b)
    np.testing.assert_allclose(got[0].numpy(), x_ref, atol=1e-7)


def test_lsqr_complex(rng):
    m, n = 40, 15
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    ref, got = both("lsqr", ops(A), b, tol=1e-13, maxiter=8 * n)
    same_solve(ref, got, b)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-6)


def test_lsqr_on_restriction_product(rng):
    n, m = 48, 20
    A = rng.standard_normal((n, n))
    rows = np.sort(rng.choice(n, size=m, replace=False))
    op_j = lo.opRestriction(jnp.asarray(rows), n) @ lo.LinearOperator(jnp.asarray(A))
    op_t = lt.opRestriction(rows, n, device="cpu") @ lt.LinearOperator(torch.from_numpy(A))
    b = rng.standard_normal(m)
    ref, got = both("lsqr", (op_j, op_t), b, tol=1e-12, maxiter=10 * n)
    same_solve(ref, got, b)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.lstsq(A[rows, :], b, rcond=None)[0],
                               atol=1e-6)


def test_solvers_zero_rhs(rng):
    n = 16
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    pair = ops(A, symmetric=True, hermitian=True)
    b = np.zeros(n)
    for solver in ("minres", "bicgstab", "lsqr"):
        ref, got = both(solver, pair, b, maxiter=10)
        x, k, _ = got
        assert torch.isfinite(x).all() and float(x.abs().max()) == 0.0 and k == 0 == int(ref[1])


def test_bicgstab_breakdown_no_nan(rng):
    A = np.array([[0.0, 1.0], [-1.0, 0.0]])
    ref, got = both("bicgstab", ops(A), np.array([1.0, 0.0]), tol=1e-10, maxiter=50)
    same_solve(ref, got, np.array([1.0, 0.0]), k_slack=0)
    x, k, res = got
    assert torch.isfinite(x).all() and np.isfinite(float(res)) and float(res) > 1e-10


def test_solvers_mixed_precision_preconditioner(rng):
    """An f64 preconditioner beside an f32 operator: the solve stays f32."""
    n = 24
    M = rng.standard_normal((n, n))
    A = (M @ M.T + n * np.eye(n)).astype(np.float32)
    pair = ops(A, symmetric=True, hermitian=True)
    b = rng.standard_normal(n).astype(np.float32)
    Mpre = diag_pair(1.0 / np.diag(A).astype(np.float64))
    for solver in ("cg", "minres", "bicgstab"):
        ref, got = both(solver, pair, b, tol=1e-5, maxiter=5 * n, M=Mpre)
        x = got[0]
        assert x.dtype == torch.float32 and _relres(A, x, b) < 1e-4
        assert abs(got[1] - int(ref[1])) <= 1
        assert np.linalg.norm(x.numpy() - np_of(ref[0])) <= 1e-5 * np.linalg.norm(np_of(ref[0]))
    ref, got = both("gmres", pair, b, tol=1e-5, maxiter=3 * n, M=Mpre)
    assert got[0].dtype == torch.float32 and _relres(A, got[0], b) < 1e-4
    assert abs(got[1] - int(ref[1])) <= 1


def test_matvec_chain_bf16_matches_a_plain_loop(rng):
    """The reference's residency test holds its chain bit for bit against a
    plain loop; the port has no residency hint, so its chain on a bf16 BSR
    operator must equal the loop exactly."""
    n = 1024
    A = rng.standard_normal((n, n)).astype(np.float32)
    d = lt.bsr_from_dense(A, (8, 32), device="cpu")
    op16 = lt.BSROperator(lt.BSR(d.blocks.to(torch.bfloat16), d.block_cols, d.shape))
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    got = lt.matvec_chain(op16, v, 7)
    x = v
    for _ in range(7):
        y = op16 @ x
        x = y / torch.linalg.vector_norm(y)
    assert torch.equal(got, x)


# ---------------------------------------------------------------- multi-RHS

def test_cg_multi_rhs(rng):
    n, k = 48, 5
    Mx = rng.standard_normal((n, n))
    A = Mx @ Mx.T + n * np.eye(n)
    B = rng.standard_normal((n, k))
    ref, got = both("cg", ops(A, symmetric=True, hermitian=True), B, tol=1e-12, maxiter=4 * n)
    same_solve(ref, got, B)
    assert tuple(got[2].shape) == (k,)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.solve(A, B), rtol=1e-7, atol=1e-8)


def test_cg_multi_rhs_preconditioned_and_freeze(rng):
    n, k = 40, 3
    Mx = rng.standard_normal((n, n))
    A = Mx @ Mx.T + np.diag(np.linspace(1, 100, n))
    B = rng.standard_normal((n, k))
    B[:, 0] = 0.0  # the zero column converges at iteration 0
    ref, got = both("cg", ops(A, symmetric=True, hermitian=True), B, tol=1e-10, maxiter=6 * n,
                    M=diag_pair(1.0 / np.diag(A)))
    same_solve(ref, got, B)
    X = got[0].numpy()
    assert np.all(np.isfinite(X)) and np.abs(X[:, 0]).max() == 0.0
    np.testing.assert_allclose(X[:, 1:], np.linalg.solve(A, B[:, 1:]), rtol=1e-6, atol=1e-7)


def test_minres_multi_rhs(rng):
    n, k = 60, 5
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([np.linspace(-8, -1, n // 2), np.linspace(1, 8, n - n // 2)])
    A = (Q * lam) @ Q.T
    pair = ops(A, symmetric=True, hermitian=True)
    B = rng.standard_normal((n, k))
    ref, got = both("minres", pair, B, tol=1e-10, maxiter=300)
    same_solve(ref, got, B)
    X, _, phibar = got
    assert tuple(phibar.shape) == (k,)
    assert np.all(np.linalg.norm(A @ X.numpy() - B, axis=0) < 1e-7)
    for j in range(k):
        xj, _, _ = lt.minres(pair[1], torch.from_numpy(B[:, j]), tol=1e-10, maxiter=300)
        assert np.linalg.norm(xj.numpy() - X[:, j].numpy()) < 1e-6


def test_minres_multi_rhs_freezes_a_converged_column_and_survives_beta_zero(rng):
    """The per-column masks of the multi-RHS MINRES: a zero column (β₁ = 0)
    and an eigenvector column (β = 0 after one step) stay finite and freeze
    while the others converge."""
    n = 30
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-4, 6, n) + 0.05
    A = (Q * lam) @ Q.T
    B = rng.standard_normal((n, 3))
    B[:, 0] = 0.0
    B[:, 1] = Q[:, 3]
    ref, got = both("minres", ops(A, symmetric=True, hermitian=True), B, tol=1e-10, maxiter=200)
    same_solve(ref, got, B)
    X = got[0].numpy()
    assert np.all(np.isfinite(X)) and np.abs(X[:, 0]).max() == 0.0
    np.testing.assert_allclose(X[:, 1], Q[:, 3] / lam[3], atol=1e-10)
    assert np.linalg.norm(A @ X[:, 2] - B[:, 2]) < 1e-8 * np.linalg.norm(B[:, 2])


def test_chebyshev_converges_at_the_rate(rng):
    n = 200
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lmin, lmax = 1.0, 50.0
    A = (Q * np.linspace(lmin, lmax, n)) @ Q.T
    op_j, op_t = ops(A, symmetric=True, hermitian=True)
    b = rng.standard_normal(n)
    x_true = np.linalg.solve(A, b)
    rate = (np.sqrt(lmax / lmin) - 1) / (np.sqrt(lmax / lmin) + 1)
    for iters in (20, 60):
        xj, _, rj = lo.chebyshev(op_j, jnp.asarray(b), lmin, lmax, iters=iters)
        xt, kt, rt = lt.chebyshev(op_t, torch.from_numpy(b), lmin, lmax, iters=iters)
        assert kt == iters
        assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= 1e-8 * np.linalg.norm(xj)
        assert abs(float(rt) - float(rj)) <= 1e-6 * float(rj)
        assert np.linalg.norm(xt.numpy() - x_true) / np.linalg.norm(x_true) < 4 * rate ** iters
    x0, k0, _ = lt.chebyshev(op_t, torch.from_numpy(b), lmin, lmax, iters=0)
    assert k0 == 0 and float(torch.linalg.vector_norm(x0)) == 0.0
    ev = np.sort(np.real(np.linalg.eigvals(np.diag(1.0 / np.diag(A)) @ A)))
    Mj, Mt = diag_pair(1.0 / np.diag(A))
    xj, _, _ = lo.chebyshev(op_j, jnp.asarray(b), float(ev[0]), float(ev[-1]), iters=60, M=Mj)
    xt, _, _ = lt.chebyshev(op_t, torch.from_numpy(b), float(ev[0]), float(ev[-1]), iters=60, M=Mt)
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= 1e-8 * np.linalg.norm(xj)
    assert np.linalg.norm(xt.numpy() - x_true) / np.linalg.norm(x_true) < 1e-4


def test_power_iteration(rng):
    n = 50
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, 10.0, n)) @ Q.T
    op_j, op_t = ops(A, symmetric=True, hermitian=True)
    v0 = rng.standard_normal(n)
    lam_j, v_j = lo.power_iteration(op_j, jnp.asarray(v0), iters=200)
    lam_t, v_t = lt.power_iteration(op_t, torch.from_numpy(v0), iters=200)
    assert abs(float(lam_t) - float(lam_j)) <= 1e-10 * abs(float(lam_j))
    assert np.linalg.norm(v_t.numpy() - np.asarray(v_j)) <= 1e-8
    assert abs(float(lam_t) - 10.0) < 1e-3


# ------------------------------------------------------------------ GMRES

def test_gmres_nonsymmetric(rng):
    n = 40
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    ref, got = both("gmres", ops(A), b, tol=1e-10, restart=20, maxiter=20)
    same_solve(ref, got, b, k_slack=0)
    assert _relres(A, got[0], b) < 1e-9


def test_gmres_preconditioned(rng):
    n = 60
    A = rng.standard_normal((n, n)) * 0.1 + np.diag(rng.random(n) + 1.0)
    pair = ops(A)
    b = rng.standard_normal(n)
    for M in (None, diag_pair(1.0 / np.diag(A))):
        ref, got = both("gmres", pair, b, tol=1e-10, restart=15, maxiter=30, M=M)
        same_solve(ref, got, b)
        assert _relres(A, got[0], b) < 1e-8


def test_gmres_on_sparse_operator(rng):
    n = 64
    A = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)) + n * np.eye(n)
    pair = lo.opSparse(A, format="csr"), lt.opSparse(A, format="csr", device="cpu")
    b = rng.standard_normal(n)
    ref, got = both("gmres", pair, b, tol=1e-9, restart=25, maxiter=10)
    same_solve(ref, got, b, k_slack=0)
    assert _relres(A, got[0], b) < 1e-8


def test_gmres_complex_operator_real_rhs(rng):
    n = 12
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    ref, got = both("gmres", ops(A), b, tol=1e-10, restart=n, maxiter=10)
    same_solve(ref, got, b, k_slack=0)
    assert got[0].dtype == torch.complex128 and _relres(A, got[0], b) < 1e-9


def test_cg_complex_operator_real_rhs(rng):
    n = 16
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = M @ M.conj().T + n * np.eye(n)
    b = rng.standard_normal(n)
    ref, got = both("cg", ops(A, symmetric=False, hermitian=True), b, tol=1e-10, maxiter=200)
    same_solve(ref, got, b)
    assert _relres(A, got[0], b) < 1e-8


def test_minres_beta_zero_breakdown(rng):
    """b an eigenvector: the Lanczos β is 0 after one step. Both solvers stop
    after that step with the exact solution and no NaN."""
    n = 20
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-3, 5, n) + 0.1
    A = (Q * lam) @ Q.T
    b = 2.0 * Q[:, 4]
    ref, got = both("minres", ops(A, symmetric=True, hermitian=True), b, tol=1e-12, maxiter=50)
    same_solve(ref, got, b, k_slack=0)
    assert got[1] <= 2 and torch.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0].numpy(), b / lam[4], atol=1e-12)
