"""The core operator algebra (``tests/test_linop.py``) in the port against
the reference, on the CPU in f64 and complex128: wrap and apply, the
algebra, scalar and matrix operands, shape errors, the 5-arg ``mul`` (vector
and matrix, NaN-safe β = 0, donation), counters, function operators and
the inference lattice, eltype lying, the involutions, dtype promotion,
repeated applies, the symmetrizers, ``matmat``, row-vector forms, operator
powers and the reference's names. Port against reference: max|Δ| ≤
1e-10·max|ref|; both against the dense oracle at the reference's
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import RTOL, assert_close, simple_matrix, simple_vector

DTYPES = [np.float64, np.complex128]
TDT = {np.float64: torch.float64, np.complex128: torch.complex128}


def t_(a):
    return torch.from_numpy(np.array(a))


def host(a):
    return a.detach().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, ref, rtol=1e-10):
    got, ref = host(got), host(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max(initial=0.0) <= rtol * max(np.abs(ref).max(initial=0.0), 1.0)


def both(A, **kw):
    return lt.LinearOperator(t_(A), **kw), lo.LinearOperator(jnp.asarray(A), **kw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matrix_operator_basic(dtype, rng):
    A = simple_matrix(dtype, 5, 3, rng)
    op, opj = both(A)
    assert op.shape == (5, 3) and op.size(1) == 5 and op.size(2) == 3
    assert op.dtype == TDT[dtype]
    v, u = simple_vector(dtype, 3), simple_vector(dtype, 5)
    for got, ref, dense in ((op @ t_(v), opj @ v, A @ v), (op.T @ t_(u), opj.T @ u, A.T @ u),
                            (op.H @ t_(u), opj.H @ u, A.conj().T @ u),
                            (op.conj() @ t_(v), opj.conj() @ v, A.conj() @ v),
                            (op.to_dense(), opj.to_dense(), A)):
        close(got, ref)
        assert_close(host(got), dense)


@pytest.mark.parametrize("dtype", DTYPES)
def test_algebra_oracle(dtype, rng):
    A, B = simple_matrix(dtype, 5, 5, rng), simple_matrix(dtype, 5, 5, rng)
    (opA, opAj), (opB, opBj) = both(A), both(B)
    v = simple_vector(dtype, 5)
    cases = {
        "sum": (opA + opB, opAj + opBj, A + B),
        "sub": (opA - opB, opAj - opBj, A - B),
        "compose": (opA @ opB, opAj @ opBj, A @ B),
        "neg": (-opA, -opAj, -A),
        "scale": (2.5 * opA, 2.5 * opAj, 2.5 * A),
        "scale_r": (opA * 2.5, opAj * 2.5, A * 2.5),
        "div": (opA / 2.0, opAj / 2.0, A / 2.0),
        "affine": (2.0 * opA @ opB - opB.T / 3.0, 2.0 * opAj @ opBj - opBj.T / 3.0,
                   2.0 * A @ B - B.T / 3.0),
    }
    for name, (op, opj, M) in cases.items():
        for got, ref, dense in ((op @ t_(v), opj @ v, M @ v), (op.T @ t_(v), opj.T @ v, M.T @ v),
                                (op.H @ t_(v), opj.H @ v, M.conj().T @ v),
                                (op.to_dense(), opj.to_dense(), M)):
            close(got, ref)
            assert_close(host(got), dense, rtol=10 * RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scalar_plus_operator(dtype, rng):
    A = simple_matrix(dtype, 4, 4, rng)
    op, opj = both(A)
    v = simple_vector(dtype, 4)
    for got, ref, dense in (((op + 2.0) @ t_(v), (opj + 2.0) @ v, (A + 2.0) @ v),
                            ((2.0 + op) @ t_(v), (2.0 + opj) @ v, (A + 2.0) @ v),
                            ((op - 2.0) @ t_(v), (opj - 2.0) @ v, (A - 2.0) @ v),
                            ((2.0 - op) @ t_(v), (2.0 - opj) @ v, (2.0 - A) @ v)):
        close(got, ref)
        assert_close(host(got), dense, rtol=10 * RTOL)


def test_matrix_operand_autowrap(rng):
    A, B = simple_matrix(np.float64, 4, 4, rng), simple_matrix(np.float64, 4, 4, rng)
    op, opj = both(A)
    v = simple_vector(np.float64, 4)
    Bt, Bj = t_(B), jnp.asarray(B)
    for got, ref in (((op + Bt) @ t_(v), (opj + Bj) @ v), ((op @ Bt) @ t_(v), (opj @ Bj) @ v),
                     ((Bt @ op) @ t_(v), (Bj @ opj) @ v)):
        close(got, ref)
    assert_close(host((Bt @ op) @ t_(v)), (B @ A) @ v, rtol=10 * RTOL)


def test_shape_mismatch_raises(rng):
    A, B = simple_matrix(np.float64, 5, 3, rng), simple_matrix(np.float64, 5, 3, rng)
    op = lt.LinearOperator(t_(A))
    with pytest.raises(lt.LinearOperatorException):
        op @ torch.ones(5, dtype=torch.float64)
    with pytest.raises(lt.LinearOperatorException):
        lt.LinearOperator(t_(A)) @ lt.LinearOperator(t_(B))
    with pytest.raises(lt.LinearOperatorException):
        lt.LinearOperator(t_(A)) + lt.LinearOperator(t_(B.T))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mul_axpby(dtype, rng):
    A = simple_matrix(dtype, 5, 5, rng)
    op, opj = both(A)
    v, res = simple_vector(dtype, 5), simple_vector(dtype, 5) * 0.5
    close(lt.mul(op, t_(v), 2.0, 3.0, t_(res)), lo.mul(opj, v, 2.0, 3.0, res))
    res_nan = np.full(5, np.nan, dtype=dtype)
    out0 = lt.mul(op, t_(v), 2.0, 0, t_(res_nan))
    assert not np.any(np.isnan(host(out0)))
    close(out0, lo.mul(opj, v, 2.0, 0, res_nan))
    close(lt.mul(op, t_(v), 2.0, 3.0, t_(res), mode="T"), lo.mul(opj, v, 2.0, 3.0, res, mode="T"))
    assert_close(host(lt.mul(op, t_(v), 2.0, 3.0, t_(res), mode="T")),
                 2.0 * (A.T @ v) + 3.0 * res, rtol=10 * RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mul_matrix_axpby(dtype, rng):
    A = simple_matrix(dtype, 6, 4, rng)
    op, opj = both(A)
    M = np.stack([simple_vector(dtype, 4) * (i + 1) for i in range(3)], axis=1)
    Res = np.stack([simple_vector(dtype, 6) * 0.5 for _ in range(3)], axis=1)
    close(lt.mul(op, t_(M), 2.0, 3.0, t_(Res)), lo.mul(opj, M, 2.0, 3.0, Res))
    close(lt.mul(op, t_(M), 2.0), lo.mul(opj, M, 2.0))
    close(lt.mul(op, t_(M)), A @ M)
    out0 = lt.mul(op, t_(M), 2.0, 0, t_(np.full((6, 3), np.nan, dtype=dtype)))
    assert not np.any(np.isnan(host(out0)))
    ResT = np.stack([simple_vector(dtype, 4) for _ in range(3)], axis=1)
    dest = t_(ResT)
    outT = lt.mul(op, t_(Res), 2.0, 3.0, dest, mode="T", donate=True)
    assert outT is dest
    close(outT, lo.mul(opj, np.asarray(Res), 2.0, 3.0, jnp.asarray(ResT), mode="T"))
    with pytest.raises(lt.LinearOperatorException):
        lt.mul(op, t_(M), 2.0, 3.0, torch.zeros(6, dtype=TDT[dtype]))


def test_counters(rng):
    A = simple_matrix(np.complex128, 4, 4, rng)
    op, opj = both(A)
    v = simple_vector(np.complex128, 4)
    for o, vec in ((op, t_(v)), (opj, jnp.asarray(v))):
        assert (o.nprod, o.ntprod, o.nctprod) == (0, 0, 0)
        o @ vec
        o @ vec
        assert o.nprod == 2
        o.T @ vec
        assert o.ntprod == 1
        o.H @ vec
        assert o.nctprod == 1
        assert o.H.nprod == o.nctprod
        o.reset_counters()
        assert (o.nprod, o.ntprod, o.nctprod) == (0, 0, 0)


def test_counters_composite(rng):
    A, B = simple_matrix(np.float64, 4, 4, rng), simple_matrix(np.float64, 4, 4, rng)
    (opA, opAj), (opB, opBj) = both(A), both(B)
    v = simple_vector(np.float64, 4)
    for a, b, vec in ((opA, opB, t_(v)), (opAj, opBj, jnp.asarray(v))):
        comp = a @ b
        comp @ vec
        assert a.nprod == 1 and b.nprod == 1
        comp.T @ vec
        assert a.ntprod == 1 and b.ntprod == 1


def test_function_operator(rng):
    A = simple_matrix(np.float64, 4, 4, rng)
    At = t_(A)
    op = lt.FunctionOperator(4, 4, lambda v: At @ v, lambda u: At.T @ u, dtype=torch.float64)
    v = simple_vector(np.float64, 4)
    close(op @ t_(v), A @ v)
    close(op.T @ t_(v), A.T @ v)
    close(op.H @ t_(v), A.T @ v)  # ctprod inferred from tprod for a real dtype


def test_function_operator_factory(rng):
    A = simple_matrix(np.float64, 4, 4, rng)
    At = t_(A)
    op = lt.LinearOperator(torch.float64, 4, 4, False, False, lambda v: At @ v,
                           lambda u: At.T @ u)
    close(op @ t_(simple_vector(np.float64, 4)), A @ simple_vector(np.float64, 4))


def test_unable_to_infer(rng):
    A = simple_matrix(np.complex128, 4, 4, rng)
    At = t_(A)
    op = lt.FunctionOperator(4, 4, lambda v: At @ v, dtype=torch.complex128)
    v = t_(simple_vector(np.complex128, 4))
    with pytest.raises(lt.LinearOperatorException, match="unable to infer"):
        op.T @ v
    with pytest.raises(lt.LinearOperatorException, match="unable to infer"):
        op.H @ v


def test_symmetric_inference(rng):
    A = simple_matrix(np.float64, 4, 4, rng, symmetric=True)
    At = t_(A)
    op = lt.FunctionOperator(4, 4, lambda v: At @ v, symmetric=True, hermitian=True,
                             dtype=torch.float64)
    v = simple_vector(np.float64, 4)
    close(op.T @ t_(v), A.T @ v)
    close(op.H @ t_(v), A.conj().T @ v)


def test_hermitian_complex_inference(rng):
    B = simple_matrix(np.complex128, 4, 4, rng)
    A = (B + B.conj().T) / 2
    At = t_(A)
    op = lt.FunctionOperator(4, 4, lambda v: At @ v, hermitian=True, dtype=torch.complex128)
    v = simple_vector(np.complex128, 4)
    close(op.H @ t_(v), A.conj().T @ v)
    close(op.T @ t_(v), A.T @ v)  # through the conj trick


def test_eltype_lying_raises(rng):
    A = simple_matrix(np.complex128, 4, 4, rng)
    At = t_(A)
    # torch's matmul does not promote as jnp's does: the product promotes itself
    op = lt.FunctionOperator(4, 4, lambda v: At @ v.to(At.dtype), dtype=torch.float64)
    with pytest.raises(lt.LinearOperatorException):
        op @ t_(simple_vector(np.float64, 4))


def test_involutions(rng):
    A = simple_matrix(np.complex128, 4, 3, rng)
    op, opj = both(A)
    assert op.H.H is op and op.T.T is op and op.conj().conj() is op
    assert isinstance(op.H.T, lt.ConjugateOperator)
    assert isinstance(op.T.H, lt.ConjugateOperator)
    assert isinstance(op.conj().T, lt.AdjointOperator)
    assert op.H.shape == (3, 4) and op.conj().shape == (4, 3)
    v = simple_vector(np.complex128, 3)
    close(op.H.T @ t_(v), opj.H.T @ v)
    assert_close(host(op.H.T @ t_(v)), A.conj() @ v)


def test_dtype_promotion(rng):
    A = simple_matrix(np.float64, 4, 4, rng)
    op, opj = both(A)
    v = simple_vector(np.complex128, 4)
    out = op @ t_(v)
    assert out.dtype == torch.complex128
    close(out, opj @ v)


def test_repeated_applies_across_operators(rng):
    """The reference's recompilation guard counts its jit cache; the port has
    none. What stays: fresh operators of the same structure, applied
    repeatedly, agree with the reference's every time."""
    A = simple_matrix(np.float64, 16, 16, rng)
    v = np.asarray(simple_vector(np.float64, 16))
    op = 2.0 * lt.LinearOperator(t_(A)) + lt.LinearOperator(t_(A)).T
    opj = 2.0 * lo.LinearOperator(A) + lo.LinearOperator(A).T
    for i in range(5):
        close(op @ t_(v * (i + 1.0)), opj @ (v * (i + 1.0)))
        op2 = 2.0 * lt.LinearOperator(t_(A * (i + 1.0))) + lt.LinearOperator(t_(A)).T
        op2j = 2.0 * lo.LinearOperator(A * (i + 1.0)) + lo.LinearOperator(A).T
        close(op2 @ t_(v), op2j @ v)


def test_symmetrizers(rng):
    A = simple_matrix(np.complex128, 4, 4, rng)
    op, opj = both(A)
    v = simple_vector(np.complex128, 4)
    close(op.hermitianized() @ t_(v), opj.hermitianized() @ v)
    close(op.symmetrized() @ t_(v), opj.symmetrized() @ v)
    assert_close(host(op.hermitianized() @ t_(v)), (A + A.conj().T) / 2 @ v, rtol=10 * RTOL)


def test_matmat(rng):
    A, M = simple_matrix(np.float64, 5, 3, rng), simple_matrix(np.float64, 3, 4, rng)
    U = simple_matrix(np.float64, 5, 2, rng)
    op, opj = both(A)
    close(op.matmat(t_(M)), opj.matmat(M))
    close(op.matmat(t_(U), mode="T"), opj.matmat(U, mode="T"))
    assert_close(host(op.matmat(t_(U), mode="T")), A.T @ U)


def test_row_vector_forms(rng):
    A = simple_matrix(np.complex128, 5, 3, rng)
    op, opj = both(A)
    u = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    close(t_(u) @ op, u @ opj)
    assert_close(host(t_(u) @ op), A.T @ u)
    close(t_(np.conj(u)) @ op, A.T @ np.conj(u))
    w = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    close(op.H.T * t_(w), opj.H.T * jnp.asarray(w))


def test_operator_power(rng):
    A = 0.3 * rng.standard_normal((10, 10))
    op, opj = both(A)
    for p in (0, 1, 2, 3, 7):
        close(lt.to_dense(op ** p), lo.to_dense(opj ** p))
        assert_close(host(lt.to_dense(op ** p)), np.linalg.matrix_power(A, p))
    v = rng.standard_normal(10)
    close((op ** 3) * t_(v), A @ (A @ (A @ v)))
    with pytest.raises(ValueError):
        op ** -1
    with pytest.raises(lt.LinearOperatorException):
        lt.LinearOperator(t_(rng.standard_normal((4, 3)))) ** 2
    with pytest.raises(TypeError):
        op ** 1.5


def test_operator_power_numpy_exponent(rng):
    A = 0.3 * rng.standard_normal((6, 6))
    op = lt.LinearOperator(t_(A))
    close(lt.to_dense(op ** np.int64(3)), np.linalg.matrix_power(A, 3))


def test_reference_name_aliases():
    native = ["BlockDiagonalOperator", "DiagonalAndrei", "DiagonalBFGS", "DiagonalPSB",
              "InverseLBFGSOperator", "LBFGSOperator", "LSR1Operator", "ShiftedOperator",
              "SpectralGradient", "check_ctranspose", "opCholesky", "opDiagonal",
              "opExtension", "opEye", "opHermitian", "opHouseholder", "opInverse", "opLDL",
              "opOnes", "opRestriction", "opZeros"]
    aliases = ["AbstractLinearOperator", "AdjointLinearOperator", "TransposeLinearOperator",
               "ConjugateLinearOperator", "TimedLinearOperator"]
    for name in native + aliases:
        assert hasattr(lt, name) and hasattr(lo, name), name
    assert lt.TimedLinearOperator is lt.TimedOperator
    assert isinstance(lt.opEye(3), lt.AbstractLinearOperator)
