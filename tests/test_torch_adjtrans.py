"""The adjoint, transpose and conjugate wrappers (``tests/test_adjtrans.py``)
in the port against the reference, on the CPU in complex128 and f64: the
densified wrappers and their scaled and negated forms, the involution group,
wrapper applies, adjoints derived from a transpose product and back, the
counters the wrappers cross-map, unary and scalar operations on the views,
sums and concatenations that mix views, and the symmetrizers' flags.
Port against reference: max|Δ| ≤ 1e-10·max|ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import assert_close


def t_(a):
    return torch.from_numpy(np.asarray(a))


def host(a):
    return a.detach().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, ref, rtol=1e-10):
    got, ref = host(got), host(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= rtol * max(np.abs(ref).max(initial=0.0), 1.0)


@pytest.fixture
def complex_ops(rng):
    A = rng.random((5, 3)) + 1j * rng.random((5, 3))
    return A, lt.LinearOperator(t_(A)), lo.LinearOperator(jnp.asarray(A))


WRAPPERS = [(lambda M: M.conj().T, lambda o: o.H), (np.conj, lambda o: o.conj()),
            (lambda M: M.T, lambda o: o.T)]


def test_wrapper_densification(complex_ops):
    A, op_t, op_j = complex_ops
    for foo, view in WRAPPERS:
        ft, fj = view(op_t), view(op_j)
        for got, ref, dense in ((ft.to_dense(), fj.to_dense(), foo(A)),
                                ((-ft).to_dense(), (-fj).to_dense(), foo(-A)),
                                (((2 + 3j) * ft).to_dense(), ((2 + 3j) * fj).to_dense(),
                                 (2 + 3j) * foo(A)),
                                ((ft * (2 + 3j)).to_dense(), (fj * (2 + 3j)).to_dense(),
                                 foo(A) * (2 + 3j))):
            close(got, ref)
            assert_close(host(got), dense)


def test_involution_group(complex_ops):
    _, op, _ = complex_ops
    aop, cop, top = op.H, op.conj(), op.T
    assert aop.H is op and top.T is op and cop.conj() is op
    assert type(top.H) is type(cop) and type(cop.H) is type(top)
    assert type(aop.conj()) is type(top) and type(top.conj()) is type(aop)
    assert type(cop.T) is type(aop) and type(aop.T) is type(cop)


def test_wrapper_applies(complex_ops, rng):
    A, op_t, op_j = complex_ops
    v5c, v5r = rng.random(5) + 1j * rng.random(5), rng.random(5)
    v3c, v3r = rng.random(3) + 1j * rng.random(3), rng.random(3)
    for view, vec, dense in ((lambda o: o.H, v5c, A.conj().T), (lambda o: o.T, v5c, A.T),
                             (lambda o: o.H, v5r, A.conj().T), (lambda o: o.T, v5r, A.T),
                             (lambda o: o.conj(), v3c, np.conj(A)),
                             (lambda o: o.conj(), v3r, np.conj(A))):
        got = view(op_t) * t_(vec)
        close(got, view(op_j) * jnp.asarray(vec))
        assert_close(host(got), dense @ vec)


def _function_ops(A, which):
    """FunctionOperators with prod and one of tprod / ctprod, in both packages."""
    At, Aj = t_(A), jnp.asarray(A)
    if which == "tprod":
        return (lt.FunctionOperator(5, 3, lambda x: At @ x, lambda y: At.T @ y, None,
                                    dtype=torch.complex128),
                lo.FunctionOperator(5, 3, lambda x: Aj @ x, lambda y: Aj.T @ y, None,
                                    dtype=jnp.complex128))
    return (lt.FunctionOperator(5, 3, lambda x: At @ x, None, lambda y: At.conj().T @ y,
                                dtype=torch.complex128),
            lo.FunctionOperator(5, 3, lambda x: Aj @ x, None, lambda y: Aj.conj().T @ y,
                                dtype=jnp.complex128))


def test_derived_adjoint_from_tprod(rng):
    A = rng.random((5, 3)) + 1j * rng.random((5, 3))
    op_t, op_j = _function_ops(A, "tprod")
    for foo, view in WRAPPERS:
        close(view(op_t).to_dense(), view(op_j).to_dense())
        assert_close(host(view(op_t).to_dense()), foo(A))
    v = rng.random(5) + 1j * rng.random(5)
    close(op_t.H * t_(v), op_j.H * jnp.asarray(v))
    close(op_t.T * t_(v), A.T @ v)


def test_derived_transpose_from_ctprod(rng):
    A = rng.random((5, 3)) + 1j * rng.random((5, 3))
    op_t, op_j = _function_ops(A, "ctprod")
    v = rng.random(5) + 1j * rng.random(5)
    close(op_t.T * t_(v), op_j.T * jnp.asarray(v))
    close(op_t.H * t_(v), A.conj().T @ v)
    close(op_t.T.to_dense(), A.T)


def test_wrapper_counters(complex_ops, rng):
    _, op_t, op_j = complex_ops
    v, w = rng.random(5) + 1j * rng.random(5), rng.random(3) + 1j * rng.random(3)
    for op, vec in ((op_t, t_), (op_j, jnp.asarray)):
        op.reset_counters()
        op.H * vec(v)
        assert op.nctprod == 1 and op.nprod == 0
        op.T * vec(v)
        assert op.ntprod == 1
        op.conj() * vec(w)
        assert op.nprod == 1
    assert (op_t.nprod, op_t.ntprod, op_t.nctprod) == (op_j.nprod, op_j.ntprod, op_j.nctprod)


def test_wrapper_counters_follow_fallback_slot(rng):
    A = rng.standard_normal((4, 4))
    At, Aj = t_(A), jnp.asarray(A)
    fo_t = lt.FunctionOperator(4, 4, lambda x: At @ x, lambda y: At.T @ y, dtype=torch.float64)
    fo_j = lo.FunctionOperator(4, 4, lambda x: Aj @ x, lambda y: Aj.T @ y)
    for fo, ones in ((fo_t, torch.ones(4, dtype=torch.float64)), (fo_j, jnp.ones(4))):
        fo.reset_counters()
        fo.H * ones
        assert fo.ntprod == 1 and fo.nctprod == 0
        assert fo.H.nprod == 1


def test_unary_scalar_on_adjtrans(rng):
    A = rng.standard_normal((5, 3))
    op_t, op_j = lt.LinearOperator(t_(A)), lo.LinearOperator(jnp.asarray(A))
    for vt, vj in ((lt.adjoint, lo.adjoint), (lt.transpose, lo.transpose)):
        close(vt(-op_t).to_dense(), (-vt(op_t)).to_dense())
        close(vt(2 * op_t).to_dense(), (2 * vt(op_t)).to_dense())
        close(vt(-op_t).to_dense(), vj(-op_j).to_dense())


def test_sum_and_cat_with_adjtrans(rng):
    A = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    opA = lt.LinearOperator(t_(A))
    opJ = lo.LinearOperator(jnp.asarray(A))
    for (view, vj), dense_view in (((lt.adjoint, lo.adjoint), lambda M: M.conj().T),
                                   ((lt.transpose, lo.transpose), lambda M: M.T)):
        want = A + dense_view(A)
        close((view(opA) + opA).to_dense(), want)
        close((opA + view(opA)).to_dense(), want)
        close((view(opA) + t_(A)).to_dense(), want)  # a raw matrix is wrapped
        close(lt.hcat(view(opA), opA).to_dense(), np.hstack([dense_view(A), A]))
        close(lt.vcat(opA, view(opA)).to_dense(), np.vstack([A, dense_view(A)]))
        got = lt.hvcat([[view(opA), opA], [opA, view(opA)]]).to_dense()
        close(got, np.block([[dense_view(A), A], [A, dense_view(A)]]))
        close(got, lo.hvcat([[vj(opJ), opJ], [opJ, vj(opJ)]]).to_dense())


def test_hermitianized_symmetrized_flags(rng):
    A = rng.standard_normal((12, 12))
    op_t, op_j = lt.LinearOperator(t_(A)), lo.LinearOperator(A)
    for make in (lambda o: o.hermitianized(), lambda o: o.symmetrized()):
        ht, hj = make(op_t), make(op_j)
        assert ht.hermitian and ht.symmetric and hj.hermitian and hj.symmetric
        close(lt.to_dense(ht), (A + A.T) / 2)
        close(lt.to_dense(ht), lo.to_dense(hj))
    assert lt.check_hermitian(op_t.hermitianized())
    C = rng.standard_normal((10, 10)) + 1j * rng.standard_normal((10, 10))
    opc_t, opc_j = lt.LinearOperator(t_(C)), lo.LinearOperator(C)
    Hc, Sc = opc_t.hermitianized(), opc_t.symmetrized()
    assert Hc.hermitian and not Hc.symmetric and Sc.symmetric and not Sc.hermitian
    assert (Hc.hermitian, Hc.symmetric) == (opc_j.hermitianized().hermitian,
                                            opc_j.hermitianized().symmetric)
    close(lt.to_dense(Hc), (C + C.conj().T) / 2)
    other = lt.LinearOperator(t_(rng.standard_normal((12, 12))))
    assert not (op_t + other).hermitian
