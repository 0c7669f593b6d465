"""The operator-contract sweep (``tests/test_contract_sweep.py``) over the
port, every family built in both packages from the same numpy data, on the
CPU in f64: densification, the adjoint lattice, mode arithmetic, gradients
(``torch.autograd`` against ``jax.grad``), applies of an operator passed as
an argument (the port has no jit: the same operator applied twice gives the
same bits), complex applies, counters, eltype lying and dtype promotion.
Agreement with the reference: max|Δ| ≤ 1e-10·max|ref| (the reference's own
tolerances against the dense oracles where it states them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import assert_close

RTOL = 1e-10
CPU = dict(device="cpu")


def host(a):
    return a.detach().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, ref, rtol=RTOL):
    got, ref = host(got), host(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    assert float(np.abs(got - ref).max(initial=0.0)) <= rtol * scale


def t_(a):
    return torch.from_numpy(np.asarray(a))


def _operators(rng):
    """(name, port operator, reference operator, dense oracle) over the zoo."""
    n = 12
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n))
    d = rng.standard_normal(n) + 2.0
    Asp = A * (rng.random((n, n)) < 0.4)
    h = rng.standard_normal(n)

    mat_t, mat_j = lt.LinearOperator(t_(A)), lo.LinearOperator(jnp.asarray(A))
    diag_t, diag_j = lt.opDiagonal(t_(d)), lo.opDiagonal(jnp.asarray(d))
    idx = np.arange(0, n, 2)
    out = [
        ("matrix", mat_t, mat_j, A),
        ("diagonal", diag_t, diag_j, np.diag(d)),
        ("eye", lt.opEye(n), lo.opEye(n), np.eye(n)),
        ("ones", lt.opOnes(n, n, **CPU), lo.opOnes(n, n), np.ones((n, n))),
        ("zeros", lt.opZeros(n, n, **CPU), lo.opZeros(n, n), np.zeros((n, n))),
        ("scale", 2.5 * mat_t, 2.5 * mat_j, 2.5 * A),
        ("compose", mat_t @ diag_t, mat_j @ diag_j, A @ np.diag(d)),
        ("sum", mat_t + diag_t, mat_j + diag_j, A + np.diag(d)),
        ("sub", mat_t - diag_t, mat_j - diag_j, A - np.diag(d)),
        ("adjoint", mat_t.H, mat_j.H, A.T),
        ("csr", lt.opSparse(Asp, format="csr", **CPU), lo.opSparse(Asp, format="csr"), Asp),
        ("bsr", lt.opSparse(Asp, format="bsr", block_shape=(4, 4), **CPU),
         lo.opSparse(Asp, format="bsr", block_shape=(4, 4)), Asp),
        ("coo", lt.opSparse(Asp, format="coo", **CPU), lo.opSparse(Asp, format="coo"), Asp),
        ("shifted", lt.ShiftedOperator(mat_t, 0.7), lo.ShiftedOperator(mat_j, 0.7),
         A + 0.7 * np.eye(n)),
        ("householder", lt.opHouseholder(t_(h)), lo.opHouseholder(jnp.asarray(h)),
         np.eye(n) - 2 * np.outer(h, h)),
        ("blockdiag", lt.BlockDiagonalOperator(mat_t, diag_t),
         lo.BlockDiagonalOperator(mat_j, diag_j),
         np.block([[A, np.zeros((n, n))], [np.zeros((n, n)), np.diag(d)]])),
        ("hcat", lt.hcat(mat_t, diag_t), lo.hcat(mat_j, diag_j), np.hstack([A, np.diag(d)])),
        ("vcat", lt.vcat(mat_t, diag_t), lo.vcat(mat_j, diag_j), np.vstack([A, np.diag(d)])),
        ("kron", lt.kron(lt.LinearOperator(t_(A[:4, :4])), lt.LinearOperator(t_(B[:3, :3]))),
         lo.kron(lo.LinearOperator(jnp.asarray(A[:4, :4])), lo.LinearOperator(jnp.asarray(B[:3, :3]))),
         np.kron(A[:4, :4], B[:3, :3])),
        ("restriction", lt.opRestriction(idx, n, **CPU), lo.opRestriction(jnp.asarray(idx), n),
         np.eye(n)[::2]),
        ("slice", mat_t[torch.arange(3), torch.arange(4)], mat_j[jnp.arange(3), jnp.arange(4)],
         A[:3, :4]),
        ("timed", lt.TimedOperator(mat_t), lo.TimedOperator(mat_j), A),
        ("power", mat_t ** 3, mat_j ** 3, np.linalg.matrix_power(A, 3)),
        ("hermitianized", mat_t.hermitianized(), mat_j.hermitianized(), (A + A.T) / 2),
        ("symmetrized", mat_t.symmetrized(), mat_j.symmetrized(), (A + A.T) / 2),
    ]
    S = A @ A.T + 5.0 * np.eye(n)
    out.append((
        "iter_inverse",
        lt.opIterativeInverse(lt.LinearOperator(t_(S), symmetric=True, hermitian=True),
                              tol=1e-13, maxiter=300),
        lo.opIterativeInverse(lo.LinearOperator(jnp.asarray(S), symmetric=True, hermitian=True),
                              tol=1e-13, maxiter=300),
        np.linalg.inv(S),
    ))
    Uq = np.linalg.qr(rng.standard_normal((n, 3)))[0]
    lam = np.array([4.0, 2.0, 1.0])
    scale = (lam[-1] + 0.5) / (lam + 0.5)
    out.append(("nystrom_pinv", lt.NystromPreconditioner(t_(Uq), t_(lam), mu=0.5),
                lo.NystromPreconditioner(jnp.asarray(Uq), jnp.asarray(lam), mu=0.5),
                (Uq * scale) @ Uq.T + (np.eye(n) - Uq @ Uq.T)))
    return out


def _rtol(name):
    # the iterative inverse stops at 1e-13: its applies agree to the solve's accuracy
    return 1e-8 if name == "iter_inverse" else RTOL


def test_contract_sweep(rng):
    for name, op_t, op_j, dense in _operators(rng):
        m, n = dense.shape
        assert op_t.shape == op_j.shape == (m, n), name
        v, u = rng.standard_normal(n), rng.standard_normal(m)
        vt, ut, vj, uj = t_(v), t_(u), jnp.asarray(v), jnp.asarray(u)
        r = _rtol(name)
        close(op_t * vt, op_j * vj, r)
        assert_close(host(op_t * vt), dense @ v)
        close(op_t.to_dense(), op_j.to_dense(), r)
        assert_close(host(op_t.to_dense()), dense, rtol=1e-10)
        close(op_t.T * ut, op_j.T * uj, r)
        close(op_t.H * ut, op_j.H * uj, r)
        assert_close(host(op_t.H * ut), dense.T @ u)
        close(op_t.T.T * vt, dense @ v, max(r, 1e-9))
        close((2.0 * op_t) * vt, (2.0 * op_j) * vj, r)
        close((-op_t) * vt, (-op_j) * vj, r)


def test_contract_sweep_gradients(rng):
    """torch.autograd through every family's apply, against jax.grad."""
    for name, op_t, op_j, dense in _operators(rng):
        m, n = dense.shape
        x = rng.standard_normal(n)
        gj = jax.grad(lambda x_: jnp.sum(op_j.apply(x_, "N")))(jnp.asarray(x))
        xt = t_(x).requires_grad_(True)
        y = op_t.apply(xt, "N")
        if y.requires_grad:
            (gt,) = torch.autograd.grad(y.sum(), xt)
        else:  # torch's form of a zero gradient: a constant output has no graph
            assert name == "zeros"
            gt = torch.zeros_like(xt)
        close(gt, gj, _rtol(name))
        assert_close(host(gt), dense.T @ np.ones(m), rtol=1e-9)


def test_contract_sweep_operator_as_argument(rng):
    """The reference's jit case: every family applies under jit with the
    operator a pytree argument. The port has no jit; the operator passed as
    an argument applies twice with equal results."""
    def f(o, x):
        return o.apply(x, "N")

    for name, op_t, op_j, dense in _operators(rng):
        v = rng.standard_normal(dense.shape[1])
        y1, y2 = f(op_t, t_(v)), f(op_t, t_(v))
        assert torch.equal(y1, y2), name
        close(y1, jax.jit(f)(op_j, jnp.asarray(v)), _rtol(name))


def test_contract_sweep_complex(rng):
    n = 10
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    d = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    Asp = A * (rng.random((n, n)) < 0.4)
    mat_t, mat_j = lt.LinearOperator(t_(A)), lo.LinearOperator(jnp.asarray(A))
    cases = [
        ("matrix", mat_t, mat_j, A),
        ("diagonal", lt.opDiagonal(t_(d)), lo.opDiagonal(jnp.asarray(d)), np.diag(d)),
        ("scale", (1 + 2j) * mat_t, (1 + 2j) * mat_j, (1 + 2j) * A),
        ("compose", mat_t @ mat_t, mat_j @ mat_j, A @ A),
        ("sum", mat_t + mat_t.T, mat_j + mat_j.T, A + A.T),
        ("csr", lt.opSparse(Asp, format="csr", **CPU), lo.opSparse(Asp, format="csr"), Asp),
        ("coo", lt.opSparse(Asp, format="coo", **CPU), lo.opSparse(Asp, format="coo"), Asp),
        ("shifted", lt.ShiftedOperator(mat_t, 0.5 - 1j), lo.ShiftedOperator(mat_j, 0.5 - 1j),
         A + (0.5 - 1j) * np.eye(n)),
        ("kron", lt.kron(lt.LinearOperator(t_(A[:3, :3])), lt.LinearOperator(t_(A[:4, :4]))),
         lo.kron(lo.LinearOperator(jnp.asarray(A[:3, :3])), lo.LinearOperator(jnp.asarray(A[:4, :4]))),
         np.kron(A[:3, :3], A[:4, :4])),
        ("hcat", lt.hcat(mat_t, mat_t), lo.hcat(mat_j, mat_j), np.hstack([A, A])),
    ]
    for name, op_t, op_j, dense in cases:
        m2, n2 = dense.shape
        v = rng.standard_normal(n2) + 1j * rng.standard_normal(n2)
        u = rng.standard_normal(m2) + 1j * rng.standard_normal(m2)
        vt, ut, vj, uj = t_(v), t_(u), jnp.asarray(v), jnp.asarray(u)
        close(op_t * vt, op_j * vj)
        close(op_t.H * ut, op_j.H * uj)
        close(op_t.T * ut, op_j.T * uj)
        close(op_t.conj() * vt, op_j.conj() * vj)
        assert_close(host(op_t.H * ut), dense.conj().T @ u)
        close(op_t.to_dense(), dense)


def test_contract_sweep_counters(rng):
    """The reference's per-family counter assertions, and the port's
    counters equal to the reference's after the same applies."""
    for name, op_t, op_j, dense in _operators(rng):
        m, n = dense.shape
        v, u = rng.standard_normal(n), rng.standard_normal(m)
        for op, vec in ((op_t, t_), (op_j, jnp.asarray)):
            op.reset_counters()
            for _ in range(3):
                op * vec(v)
            for _ in range(2):
                op.T * vec(u)
            op.H * vec(u)
        assert (op_t.nprod, op_t.ntprod, op_t.nctprod) == \
            (op_j.nprod, op_j.ntprod, op_j.nctprod), name
        if op_t.symmetric and op_t.hermitian:
            assert (op_t.nprod, op_t.ntprod, op_t.nctprod) == (6, 0, 0), name
        elif name != "adjoint":
            assert (op_t.nprod, op_t.ntprod, op_t.nctprod) == (3, 2, 1), name
        if name == "matrix":
            lt.conj(op_t) * t_(v)
            assert op_t.nprod == 4, name
        if not (op_t.symmetric and op_t.hermitian):
            assert lt.transpose(op_t).nprod == op_t.ntprod, name
            assert lt.transpose(op_t).ntprod == op_t.nprod, name
            assert lt.adjoint(op_t).nprod == op_t.nctprod, name
        op_t.reset_counters()
        assert (op_t.nprod, op_t.ntprod, op_t.nctprod) == (0, 0, 0), name


def test_contract_sweep_eltype_lying(rng):
    """A FunctionOperator lying about its eltype (complex products declared
    float64) raises on apply and on densification, for every family."""
    n = 10
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    d = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    Asp = A * (rng.random((n, n)) < 0.4)
    mat = lt.LinearOperator(t_(A))
    families = [
        ("matrix", mat),
        ("diagonal", lt.opDiagonal(t_(d))),
        ("compose", mat @ mat),
        ("sum", mat + mat.T),
        ("csr", lt.opSparse(Asp, format="csr", **CPU)),
        ("shifted", lt.ShiftedOperator(mat, 0.5 - 1j)),
        ("hcat", lt.hcat(mat, mat)),
        ("kron", lt.kron(lt.LinearOperator(t_(A[:3, :3])), lt.LinearOperator(t_(A[:4, :4])))),
    ]
    for name, op in families:
        m2, n2 = op.shape
        liar = lt.FunctionOperator(m2, n2, prod=lambda x, _op=op: _op.apply(x, "N"),
                                   tprod=lambda x, _op=op: _op.apply(x, "T"),
                                   dtype=torch.float64)
        with pytest.raises(lt.LinearOperatorException):
            liar * t_(rng.standard_normal(n2))
        with pytest.raises(lt.LinearOperatorException):
            liar.to_dense()


def test_contract_sweep_dtype_promotion(rng):
    """The result dtype follows promote(op, v) in both packages alike."""
    for name, op_t, op_j, dense in _operators(rng):
        m, n = dense.shape
        if op_t.dtype.is_complex:
            continue
        v32 = rng.standard_normal(n).astype(np.float32)
        out_t, out_j = op_t * t_(v32), op_j * jnp.asarray(v32)
        assert out_t.dtype == torch.promote_types(op_t.dtype, torch.float32), name
        assert str(out_t.dtype).replace("torch.", "") == str(out_j.dtype), name
        vc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        outc = op_t * t_(vc)
        assert outc.dtype.is_complex, name
        close(outc, op_j * jnp.asarray(vc), _rtol(name))
        assert_close(host(outc), dense @ vc)
