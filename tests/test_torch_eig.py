"""Parity of the port's LOBPCG, svds, rsvd and Nyström preconditioner with
the JAX reference, in f64 on the CPU (mirrors test_eig.py).

LOBPCG is held in f64 (its default ``gram`` basis squares the basis
condition number). Both packages start from the same X0 block: they take
the same iteration count (±1), their eigenvalues agree within 1e-8
relative, and their eigenvector blocks span the same space (the projectors
agree within 1e-6). ``svds`` goes through the same LOBPCG; ``rsvd`` and the
Nyström sketch take the same Gaussian block through ``_rsvd`` /
``_nystrom_sketch`` and agree within 1e-10 relative in the singular values
and eigenvalues.

LOBPCG and svds run on ``utils/loop.py::device_while``: in blocks of
``loop.BLOCK`` masked iterations they give the count and every bit of one
masked iteration per host read (the per-iteration loop), with ⌈I/4⌉ + 1
host reads."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.utils import eig as jeig
from linops_tpu_torch.utils import eig as teig
from linops_tpu_torch.utils import loop

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


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_small_eigh_backward_is_eighs(rng, dtype):
    """E1's backward (``eigh_vjp``, which a card launch runs under autograd)
    gives ``torch.linalg.eigh``'s gradient for a gauge-invariant loss of w
    and |V|², within 1e-10."""
    from linops_tpu_torch.kernels.small_eigh import eigh_vjp

    m = 7
    A = torch.from_numpy(rng.standard_normal((2, m, m))).to(dtype)
    if dtype.is_complex:
        A = A + 1j * torch.from_numpy(rng.standard_normal((2, m, m)))
    A = 0.5 * (A + A.mH)
    cw = torch.from_numpy(rng.standard_normal((2, m)))
    cV = torch.from_numpy(rng.standard_normal((2, m, m)))

    def loss(w, V):
        return (cw * w).sum() + (cV * V.abs() ** 2).sum()

    A_ = A.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(loss(*torch.linalg.eigh(A_)), A_)
    w, V = torch.linalg.eigh(A)
    w_, V_ = w.clone().requires_grad_(), V.clone().requires_grad_()
    gw, gV = torch.autograd.grad(loss(w_, V_), (w_, V_))
    g = eigh_vjp(w, V, gw, gV)
    assert (g - g_ref).abs().max() <= 1e-10 * g_ref.abs().max()


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


# ----------------------------------------------------------------------------
# On the device loop
# ----------------------------------------------------------------------------


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


LOBPCG_CASES = {  # name -> (basis, complex, extra: "M", "Y" or "block_size")
    "gram": ("gram", False, None), "direct": ("direct", False, None),
    "gram_complex": ("gram", True, None), "direct_complex": ("direct", True, None),
    "gram_M": ("gram", False, "M"), "direct_M": ("direct", False, "M"),
    "gram_Y": ("gram", False, "Y"), "direct_Y": ("direct", True, "Y"),
    "gram_k_conv": ("gram", False, "block_size"),
}


@pytest.mark.parametrize("name", list(LOBPCG_CASES))
def test_lobpcg_blocks_match_per_iteration_loop_and_reference(rng, monkeypatch, name):
    """LOBPCG (both bases, real and complex, with M, with Y, with an internal
    block wider than k) in blocks of 4 against one masked iteration per
    read: the same count and θ, X and resnorm bits, ⌈I/4⌉ + 1 host reads;
    and the reference's count (±1), θ (1e-8) and span (1e-6), as
    ``lobpcg_parity`` holds them."""
    basis, complex_, extra = LOBPCG_CASES[name]
    n, k = 60, 2
    lam = np.linspace(1.0, 100.0, n)
    A, opt, opj = spectrum_op(rng, lam, complex_)
    X0 = rng.standard_normal((n, k)) + (1j * rng.standard_normal((n, k)) if complex_ else 0)
    args = dict(k=k, tol=1e-8, maxiter=300, basis=basis)
    jargs, targs = dict(args), dict(args)
    if extra == "M":
        Minv = np.linalg.inv(A + 5 * np.eye(n))
        jargs["M"], targs["M"] = lo.LinearOperator(Minv), lt.LinearOperator(Minv, **CPU)
    elif extra == "Y":
        Y = np.linalg.eigh(A)[1][:, :2]  # the two lowest eigenvectors: the next two are sought
        jargs["Y"], targs["Y"] = jnp.asarray(Y), t_(Y)
    elif extra == "block_size":
        jargs["block_size"] = targs["block_size"] = 4  # k_conv = 2 < k = 4

    def port(block):
        monkeypatch.setattr(loop, "BLOCK", block)
        out = lt.lobpcg(opt, X0=t_(X0), **targs)
        return out, dict(loop.stats)

    if extra == "block_size":  # the padded columns come from a generator: the same one twice
        def port(block):  # noqa: F811
            monkeypatch.setattr(loop, "BLOCK", block)
            out = lt.lobpcg(opt, k=k, tol=1e-8, maxiter=300, basis=basis, block_size=4,
                            generator=torch.Generator().manual_seed(3))
            return out, dict(loop.stats)

    (th1, X1, r1, it1), st1 = port(1)
    (th4, X4, r4, it4), st4 = port(4)
    assert isinstance(it4, int) and it4 == it1 and 1 < it4 < 300
    assert torch.equal(th4, th1) and torch.equal(X4, X1) and torch.equal(r4, r1)
    assert st4["path"] == "blocks" and st4["iterations"] == it4
    assert st4["reads"] == st4["blocks"] + 1 == math.ceil(it4 / 4) + 1
    assert st1["reads"] == it1 + 1
    if extra == "block_size":  # no shared start block: the converged pairs
        np.testing.assert_allclose(th4.numpy(), lam[:k], rtol=1e-7)
        return
    thj, Xj, _, itj = lo.lobpcg(opj, X0=jnp.asarray(X0), **jargs)
    assert abs(it4 - int(itj)) <= 1
    thj = np.asarray(thj)
    assert np.abs(th4.numpy() - thj).max() <= 1e-8 * max(np.abs(thj).max(), 1.0)
    assert np.abs(proj(X4.numpy()) - proj(Xj)).max() <= 1e-6


@pytest.mark.parametrize("shape", [(50, 30), (30, 50)])
def test_svds_blocks_match_per_iteration_loop_and_reference(rng, monkeypatch, shape):
    """svds runs LOBPCG on the Gram operator: in blocks of 4 the bits and
    count of one iteration per read, and the reference's singular values
    (1e-8, as above); a second svds of the same operator makes a fresh
    Gram node with the same capture signature, and keeps nothing on it."""
    A = rng.standard_normal(shape)
    op = lt.LinearOperator(t_(A))
    attrs = set(vars(op))

    def port(block):
        monkeypatch.setattr(loop, "BLOCK", block)
        out = lt.svds(op, k=3, tol=1e-9, maxiter=500, generator=torch.Generator().manual_seed(0))
        return out, dict(loop.stats)

    (U1, s1, V1, r1, it1), _ = port(1)
    (U4, s4, V4, r4, it4), st4 = port(4)
    assert it4 == it1 and all(torch.equal(a, b) for a, b in ((U4, U1), (s4, s1), (V4, V1),
                                                             (r4, r1)))
    assert st4["path"] == "blocks" and st4["reads"] == math.ceil(it4 / 4) + 1
    _, sj, _, _, _ = lo.svds(lo.LinearOperator(jnp.asarray(A)), k=3, tol=1e-9, maxiter=500)
    np.testing.assert_allclose(s4.numpy(), np.asarray(sj), rtol=1e-8)
    from linops_tpu_torch.core.base import capture_signature
    from linops_tpu_torch.utils.eig import _GramOperator

    side = "right" if shape[1] <= shape[0] else "left"
    key = capture_signature(_GramOperator(op, side))[0]
    assert capture_signature(_GramOperator(op, side))[0] == key  # a fresh node, one key
    # a copy has the same structure: one key (a captured block copies its tensors in)
    assert capture_signature(_GramOperator(op.to("cpu"), side))[0] == key
    assert capture_signature(_GramOperator(op, "left" if side == "right" else "right"))[0] != key
    assert set(vars(op)) == attrs  # svds keeps nothing on the operator


@pytest.mark.parametrize("kernel", ["auto", "jacobi", "blocked", "cluster"])
def test_small_eigh_kernel_choice_on_the_cpu(rng, kernel):
    """``small_eigh(A, _kernel=...)`` names E1's Jacobi, blocked or cluster
    kernel on the card ("auto": the C entry's choice); a CPU tensor takes the
    plain version whichever is named, so each gives the reference's
    eigenvalues (f64 at m = 40, within 1e-12 of numpy); another name raises
    before anything runs."""
    from linops_tpu_torch.kernels import small_eigh as E1

    A = rng.standard_normal((40, 40))
    A = A + A.T
    w, V = E1.small_eigh(torch.from_numpy(A), _kernel=None if kernel == "auto" else kernel)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(A), rtol=0, atol=1e-12 * 40)
    assert E1.LAUNCH_SYMBOLS.keys() == E1.launch_counts().keys() == set(E1._NAMES)
    with pytest.raises(ValueError, match="kernel"):
        E1.small_eigh(torch.from_numpy(A), _kernel="qr")
