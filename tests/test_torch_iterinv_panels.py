"""Block applies of ``opIterativeInverse`` in the port
(``linops_tpu_torch/ops/linalg_ops.py``, ``utils/krylov.py::_solve_panel``)
against the reference, on the CPU in f64 and c128.

The reference has no ``apply_matrix`` of its own for the iterative inverse:
it inherits ``jax.vmap`` of the vector apply (``linops_tpu/core/base.py:321``),
so a block of k columns is one batched inner solve in which each column
keeps its own recurrence, tolerance and count and freezes once its own test
fails. The port runs the same as one panel solve. Here:

- every inner solver (cg, minres, bicgstab, gmres, "auto") on a hermitian
  and a non-hermitian operator, modes N/T/C/H, k = 1, 3 and 6 as a column
  panel (``apply_matrix``) and k = 6 as a row panel (``apply_matrix_t``): each column
  within rtol 1e-10 of the reference's vmapped apply and of the port's
  vector apply, per-column counts equal to the reference's vmapped
  ``solve_info`` counts and the vector solves', ``inner_iterations`` equal
  to the column loop's sum, one ``device_while`` per block apply;
- a zero column and an instantly converged column beside a slow one (and
  BiCGSTAB's per-column breakdown): both frozen, exact zeros where the
  vector solve gives them, no NaN;
- inside an outer multi-RHS ``cg`` and LOBPCG, one inner loop per outer
  iteration;
- gradients with respect to the panel and to the wrapped operator's matrix
  within 1e-8 of ``jax.grad`` through the reference's vmapped apply (torch's
  conjugate-Wirtinger convention: the conjugate of ``jax.grad``).

The reference for k = 1 and 3 is the first columns of its k = 6 call: a
vmapped column does not depend on the others.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu_torch.utils import loop

RTOL = 1e-10
N = 40
MODES = ("N", "T", "C", "H")
KS = (1, 3, 6)
KW = dict(tol=1e-11, maxiter=60)  # gmres: restart 30, two restarts
CASES = (("cg", "herm"), ("minres", "herm"), ("bicgstab", "herm"), ("gmres", "herm"),
         ("auto", "herm"), ("bicgstab", "nonherm"), ("gmres", "nonherm"), ("auto", "nonherm"))
CPU = dict(device="cpu")


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


@functools.lru_cache(maxsize=None)
def matrix(kind, complex_):
    """A hermitian positive-definite matrix with eigenvalues 1..30, or a
    non-hermitian one (a shifted random matrix)."""
    rng = np.random.default_rng(190 + 2 * (kind == "herm") + complex_)
    G = rng.standard_normal((N, N)) + (1j * rng.standard_normal((N, N)) if complex_ else 0)
    if kind == "herm":
        Q, _ = np.linalg.qr(G)
        return (Q * np.linspace(1.0, 30.0, N)) @ Q.conj().T
    return G / np.sqrt(N) + 3.0 * np.eye(N)


def flags(kind, complex_):
    herm = kind == "herm"
    return dict(hermitian=herm, symmetric=herm and not complex_)


@functools.lru_cache(maxsize=None)
def panel(complex_, seed=0):
    rng = np.random.default_rng(1900 + seed)
    M = rng.standard_normal((N, max(KS)))
    return M + 1j * rng.standard_normal((N, max(KS))) if complex_ else M


def port_inverse(solver, kind, complex_):
    A = torch.tensor(matrix(kind, complex_))
    return lt.opIterativeInverse(lt.LinearOperator(A, **flags(kind, complex_), **CPU),
                                 solver=solver, **KW)


def ref_inverse(solver, kind, complex_):
    A = jnp.asarray(matrix(kind, complex_))
    return lo.opIterativeInverse(lo.LinearOperator(A, **flags(kind, complex_)), solver=solver,
                                 **KW)


@functools.lru_cache(maxsize=None)
def reference(solver, kind, complex_, mode):
    """The reference's block apply of the k = 6 panel (``jax.vmap`` of the
    vector apply) and its per-column counts (``jax.vmap`` of ``solve_info``)."""
    inv = ref_inverse(solver, kind, complex_)
    M = jnp.asarray(panel(complex_))
    counts = jax.vmap(lambda c: inv.solve_info(c, mode)[1], in_axes=1)(M)
    return np.asarray(inv.apply_matrix(M, mode)), np.asarray(counts)


@pytest.fixture
def loops(monkeypatch):
    """The keys of the ``loop.device_while`` calls made while it is active."""
    keys = []
    real = loop.device_while

    def counted(*args, **kwargs):
        keys.append(kwargs.get("key"))
        return real(*args, **kwargs)

    monkeypatch.setattr(loop, "device_while", counted)
    return keys


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("complex_", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("solver,kind", CASES)
def test_block_apply_is_the_vmapped_vector_apply(solver, kind, complex_, mode, loops):
    """Each column within rtol 1e-10 of the reference's vmapped apply and of
    the port's vector apply, with per-column counts equal to both; column
    and row panels; one inner loop per block apply; the inner iterations
    the column loop's sum."""
    want, want_counts = reference(solver, kind, complex_, mode)
    inv = port_inverse(solver, kind, complex_)
    M = torch.tensor(panel(complex_))
    vec = [inv.solve_info(M[:, j], mode) for j in range(M.shape[1])]
    vec_x = torch.stack([v[0] for v in vec], dim=1).numpy()
    vec_counts = np.array([int(v[1]) for v in vec])
    assert (vec_counts == want_counts).all()
    close(vec_x, want)
    for rows in (False, True):
        for k in KS if not rows else KS[-1:]:  # rows: the column code on the transpose
            given = M[:, :k].T.contiguous() if rows else M[:, :k]
            X, counts, res = inv._solve(given, mode, rows)
            got = (X.T if rows else X).numpy()
            close(got, want[:, :k])
            close(got, vec_x[:, :k])
            assert (counts.numpy() == want_counts[:k]).all()
            # residuals: within rounding of the right-hand side's norm
            vres = torch.stack([v[2] for v in vec[:k]]).numpy()
            assert res.shape == (k,)
            assert (np.abs(res.numpy() - vres) <= RTOL * np.linalg.norm(panel(complex_)[:, :k],
                                                                        axis=0)).all()
        # the block apply itself: one inner loop for the k columns, the
        # column loop's inner iterations
        inv.reset_inner_iterations()
        del loops[:]
        Y = (inv.apply_matrix_t if rows else inv.apply_matrix)(given, mode)
        assert len(loops) == 1, loops
        assert inv.inner_iterations == vec_counts.sum()
        assert torch.equal(Y, X)


def frozen_columns(complex_):
    """A zero column, an eigenvector (converged after one iteration) and a
    slow random column, for an SPD matrix."""
    A = matrix("herm", complex_)
    _, Q = np.linalg.eigh(A)
    M = panel(complex_, 1)[:, :3].copy()
    M[:, 0] = 0.0
    M[:, 1] = Q[:, 5]
    return A, M


@pytest.mark.parametrize("rows", [False, True], ids=["columns", "rows"])
@pytest.mark.parametrize("solver", ["cg", "minres", "bicgstab", "gmres"])
def test_zero_and_converged_columns_freeze(solver, rows):
    """The zero column runs 0 iterations and stays exactly 0, the
    eigenvector stops after one; the slow column runs on, as in the
    reference's vmapped solve and the port's vector solves."""
    A, M = frozen_columns(True)
    kw = dict(tol=1e-11, maxiter=60)
    ref = lo.opIterativeInverse(lo.LinearOperator(jnp.asarray(A), hermitian=True), solver=solver,
                                **kw)
    want = np.asarray(ref.apply_matrix(jnp.asarray(M), "N"))
    want_counts = np.asarray(jax.vmap(lambda c: ref.solve_info(c, "N")[1], in_axes=1)(
        jnp.asarray(M)))
    inv = lt.opIterativeInverse(lt.LinearOperator(torch.tensor(A), hermitian=True, **CPU),
                                solver=solver, **kw)
    Mt = torch.tensor(M)
    X, counts, _ = inv._solve(Mt.T.contiguous() if rows else Mt, "N", rows)
    X = X.T if rows else X
    vec = [inv.solve_info(Mt[:, j], "N") for j in range(3)]
    assert counts.tolist() == want_counts.tolist() == [int(v[1]) for v in vec]
    assert counts[0] == 0 and counts[1] == 1 and counts[2] > 1
    assert torch.equal(X[:, 0], torch.zeros(N, dtype=X.dtype))
    assert (want[:, 0] == 0).all() and torch.equal(vec[0][0], X[:, 0])
    close(X.numpy(), want)
    close(X.numpy(), torch.stack([v[0] for v in vec], dim=1).numpy())


def test_bicgstab_breaks_down_per_column():
    """On a block-diagonal operator (a skew-symmetric block of 2 x 2
    rotations, an SPD block) a column in the skew block breaks down at its
    first iteration (r̂·v = 0) and keeps its last iterate (0), a column in
    the SPD block converges: no NaN, both as the reference's vmapped solve
    and the vector solves."""
    h = N // 2
    rng = np.random.default_rng(7)
    A = np.zeros((N, N))
    for i in range(0, h, 2):  # rotation blocks: x·Ax = 0 exactly for x = e_i
        A[i, i + 1], A[i + 1, i] = 1.0, -1.0
    A[h:, h:] = matrix("herm", False)[:h, :h] + 5.0 * np.eye(h)
    M = np.zeros((N, 2))
    M[0, 0] = 3.0
    M[h:, 1] = rng.standard_normal(h)
    kw = dict(solver="bicgstab", tol=1e-11, maxiter=60)
    ref = lo.opIterativeInverse(lo.LinearOperator(jnp.asarray(A)), **kw)
    want = np.asarray(ref.apply_matrix(jnp.asarray(M), "N"))
    want_counts = np.asarray(jax.vmap(lambda c: ref.solve_info(c, "N")[1], in_axes=1)(
        jnp.asarray(M)))
    inv = lt.opIterativeInverse(lt.LinearOperator(torch.tensor(A), **CPU), **kw)
    X, counts, res = inv._solve(torch.tensor(M), "N", False)
    vec = [inv.solve_info(torch.tensor(M[:, j]), "N") for j in range(2)]
    assert counts.tolist() == want_counts.tolist() == [int(v[1]) for v in vec]
    assert counts[0] == 1 and counts[1] > 1
    assert torch.isfinite(X).all() and torch.isfinite(res).all()
    assert torch.equal(X[:, 0], torch.zeros(N, dtype=X.dtype)) and (want[:, 0] == 0).all()
    close(X.numpy(), want)
    assert float(res[0]) == pytest.approx(float(vec[0][2]), rel=1e-12)


def test_block_apply_rejects_what_it_cannot_take():
    """A panel whose length is not the operator's raises: there is no
    column loop to fall back to."""
    inv = port_inverse("cg", "herm", False)
    for call in (lambda: inv.apply_matrix(torch.ones((N - 1, 2), dtype=torch.float64)),
                 lambda: inv.apply_matrix_t(torch.ones((2, N + 1), dtype=torch.float64))):
        with pytest.raises(lt.LinearOperatorException):
            call()


def test_one_inner_loop_per_outer_cg_iteration(monkeypatch, loops):
    """A multi-RHS cg with the iterative inverse as M: one inner panel loop
    per outer iteration (and one for the setup's M R), not k; the same
    solution as the reference's."""
    monkeypatch.setattr(loop, "BLOCK", 1)  # one masked iteration per block: body runs = iterations
    A = matrix("herm", False)
    B = panel(False, 2)[:, :4]
    S = A + 5.0 * np.eye(N)
    inner = dict(solver="cg", tol=1e-3, maxiter=8)
    M = lt.opIterativeInverse(lt.LinearOperator(torch.tensor(S), hermitian=True, symmetric=True,
                                                **CPU), **inner)
    X, it, _ = lt.cg(lt.LinearOperator(torch.tensor(A), hermitian=True, symmetric=True, **CPU),
                     torch.tensor(B), tol=1e-10, maxiter=200, M=M)
    assert loops.count(("cg_panel", False)) == it + 1
    assert loops.count(("cg",)) == 0
    Mj = lo.opIterativeInverse(lo.LinearOperator(jnp.asarray(S), hermitian=True, symmetric=True),
                               **inner)
    Xj, itj, _ = lo.cg(lo.LinearOperator(jnp.asarray(A), hermitian=True, symmetric=True),
                       jnp.asarray(B), tol=1e-10, maxiter=200, M=Mj)
    assert it == int(itj)
    close(X.numpy(), np.asarray(Xj), rtol=1e-8)


def test_one_inner_loop_per_lobpcg_iteration(monkeypatch, loops):
    """LOBPCG with the iterative inverse as M: its M apply, a row panel of
    k rows, is one inner loop per iteration; θ the reference's."""
    monkeypatch.setattr(loop, "BLOCK", 1)
    A = matrix("herm", False)
    X0 = panel(False, 3)[:, :2]
    inner = dict(solver="cg", tol=1e-2, maxiter=10)
    op = lt.LinearOperator(torch.tensor(A), hermitian=True, symmetric=True, **CPU)
    M = lt.opIterativeInverse(op, **inner)
    theta, _, _, it = lt.lobpcg(op, 2, torch.tensor(X0), M=M, tol=1e-8, maxiter=100)
    assert loops.count(("cg_panel", True)) == it
    assert loops.count(("cg",)) == 0
    opj = lo.LinearOperator(jnp.asarray(A), hermitian=True, symmetric=True)
    thetaj = lo.lobpcg(opj, 2, jnp.asarray(X0), M=lo.opIterativeInverse(opj, **inner), tol=1e-8,
                       maxiter=100)[0]
    close(theta.numpy(), np.asarray(thetaj), rtol=1e-8)


GRAD_CASES = [("auto", "nonherm", m, c, False) for m in ("N", "T", "H") for c in (False, True)]
GRAD_CASES += [("auto", "nonherm", "H", True, True), ("cg", "herm", "N", True, False),
               ("cg", "herm", "N", False, True)]


@pytest.mark.parametrize("solver,kind,mode,complex_,rows", GRAD_CASES)
def test_block_gradients_match_jax(solver, kind, mode, complex_, rows):
    """∂/∂panel and ∂/∂A of a real loss through a block apply: the port's
    (one panel solve backward, the pullback of one panel apply) against
    ``jax.grad`` through the reference's vmapped apply, conjugated. rtol
    1e-8: the inner solve stops at 1e-13."""
    n, k = 12, 3
    rng = np.random.default_rng(31)
    A = matrix(kind, complex_)[:n, :n] + (6.0 * np.eye(n) if kind == "nonherm" else 0)
    V = rng.standard_normal((n, k)) + (1j * rng.standard_normal((n, k)) if complex_ else 0)
    W = rng.standard_normal((n, k)) + (1j * rng.standard_normal((n, k)) if complex_ else 0)
    kw = dict(solver=solver, tol=1e-13, maxiter=400)
    fl = flags(kind, complex_)

    def loss_j(A_, V_):
        inv = lo.opIterativeInverse(lo.LinearOperator(A_, **fl), **kw)
        X = inv.apply_matrix_t(V_.T, mode).T if rows else inv.apply_matrix(V_, mode)
        return jnp.real(jnp.sum(jnp.conj(jnp.asarray(W)) * X))

    gA_j, gV_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(V))
    At = torch.tensor(A, requires_grad=True)
    Vt = torch.tensor(V, requires_grad=True)
    inv = lt.opIterativeInverse(lt.LinearOperator(At, **fl, **CPU), **kw)
    X = inv.apply_matrix_t(Vt.T, mode).T if rows else inv.apply_matrix(Vt, mode)
    gA, gV = torch.autograd.grad(torch.real(torch.sum(torch.tensor(W).conj() * X)), (At, Vt))
    close(gA.resolve_conj().numpy(), np.conj(np.asarray(gA_j)), rtol=1e-8)
    close(gV.resolve_conj().numpy(), np.conj(np.asarray(gV_j)), rtol=1e-8)
