"""The port's block operators (``linops_tpu_torch/ops/cat.py``) against the
JAX reference, on the CPU in f64.

Mirrors ``tests/test_cat.py`` (7 tests) and the block-diagonal case of
``tests/test_special_ops.py``: the same blocks in both packages, applied in
the N, T, H (and C) modes, as column blocks, through ``to_dense`` and the
5-arg ``mul``; max|Δ| ≤ 1e-10·max|ref| against the reference (and the dense
oracle of the reference test). The shape probes raise
``LinearOperatorException`` in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import simple_matrix, simple_vector

DTYPES = [np.float64, np.complex128]
MODES = ("N", "T", "C", "H")
RTOL = 1e-10


def assert_rel(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def pair(A, **kw):
    return lo.LinearOperator(jnp.asarray(A), **kw), lt.LinearOperator(torch.from_numpy(A), **kw)


def check_all_modes(op_j, op_t, dense, rng, complex_):
    """Every mode as a vector and as a 3-column block, the dense form, and
    the reference's dense oracle."""
    oracle = {"N": dense, "T": dense.T, "C": dense.conj(), "H": dense.conj().T}
    for mode in MODES:
        n = op_t.in_dim(mode)
        v = rng.standard_normal(n) + (1j * rng.standard_normal(n) if complex_ else 0)
        got = op_t.matvec(torch.from_numpy(v), mode=mode)
        assert_rel(got, op_j.matvec(jnp.asarray(v), mode=mode))
        assert_rel(got, oracle[mode] @ v)
        V = rng.standard_normal((n, 3)) + (1j * rng.standard_normal((n, 3)) if complex_ else 0)
        assert_rel(op_t.matmat(torch.from_numpy(V), mode=mode),
                   op_j.matmat(jnp.asarray(V), mode=mode))
    assert_rel(op_t.to_dense(), lo.to_dense(op_j))
    assert_rel(op_t.to_dense(), dense)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hcat(dtype, rng):
    A = simple_matrix(dtype, 4, 3, rng)
    B = simple_matrix(dtype, 4, 2, rng)
    (Aj, At), (Bj, Bt) = pair(A), pair(B)
    op_t, op_j = lt.hcat(At, Bt), lo.hcat(Aj, Bj)
    assert op_t.shape == (4, 5) and isinstance(op_t, lt.HCatOperator)
    check_all_modes(op_j, op_t, np.hstack([A, B]), rng, dtype == np.complex128)
    u = simple_vector(dtype, 4)
    # the adjoint of an hcat is a vcat of the adjoints
    assert_rel(op_t.H * torch.from_numpy(u), lt.vcat(At.H, Bt.H) * torch.from_numpy(u))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vcat(dtype, rng):
    A = simple_matrix(dtype, 4, 3, rng)
    B = simple_matrix(dtype, 2, 3, rng)
    (Aj, At), (Bj, Bt) = pair(A), pair(B)
    op_t, op_j = lt.vcat(At, Bt), lo.vcat(Aj, Bj)
    assert op_t.shape == (6, 3)
    check_all_modes(op_j, op_t, np.vstack([A, B]), rng, dtype == np.complex128)


def test_cat_shape_errors(rng):
    A = simple_matrix(np.float64, 4, 3, rng)
    B = simple_matrix(np.float64, 3, 3, rng)
    C = simple_matrix(np.float64, 4, 2, rng)
    for pkg, wrap in ((lo, jnp.asarray), (lt, torch.from_numpy)):
        with pytest.raises(pkg.LinearOperatorException):
            pkg.hcat(pkg.LinearOperator(wrap(A)), pkg.LinearOperator(wrap(B)))
        with pytest.raises(pkg.LinearOperatorException):
            pkg.vcat(pkg.LinearOperator(wrap(A)), pkg.LinearOperator(wrap(C)))
        with pytest.raises(pkg.LinearOperatorException):
            pkg.hcat()


@pytest.mark.parametrize("dtype", DTYPES)
def test_hvcat(dtype, rng):
    A = simple_matrix(dtype, 2, 2, rng)
    B = simple_matrix(dtype, 2, 3, rng)
    C = simple_matrix(dtype, 3, 2, rng)
    D = simple_matrix(dtype, 3, 3, rng)
    ps = [pair(X) for X in (A, B, C, D)]
    op_j = lo.hvcat((2, 2), *[p[0] for p in ps])
    op_t = lt.hvcat((2, 2), *[p[1] for p in ps])
    assert op_t.shape == (5, 5)
    check_all_modes(op_j, op_t, np.block([[A, B], [C, D]]), rng, dtype == np.complex128)
    nested = lt.hvcat([[ps[0][1], ps[1][1]], [ps[2][1], ps[3][1]]])
    assert_rel(nested.to_dense(), np.block([[A, B], [C, D]]))


def test_cat_mixed_matrix_operand(rng):
    A = simple_matrix(np.float64, 3, 2, rng)
    B = simple_matrix(np.float64, 3, 3, rng)
    op_j = lo.hcat(lo.LinearOperator(jnp.asarray(A)), B)
    op_t = lt.hcat(lt.LinearOperator(torch.from_numpy(A)), B)  # bare host matrix wrapped
    assert op_t.ops[1].device == torch.device("cpu")  # on the other operand's device
    v = simple_vector(np.float64, 5)
    assert_rel(op_t * torch.from_numpy(v), op_j * jnp.asarray(v))
    assert_rel(op_t * torch.from_numpy(v), np.hstack([A, B]) @ v)


def test_nary_cat(rng):
    mats = [simple_matrix(np.float64, 3, k, rng) for k in (1, 2, 3)]
    op_t = lt.hcat(*[lt.LinearOperator(torch.from_numpy(m)) for m in mats])
    op_j = lo.hcat(*[lo.LinearOperator(jnp.asarray(m)) for m in mats])
    check_all_modes(op_j, op_t, np.hstack(mats), rng, False)
    assert_rel(lt.vcat([lt.LinearOperator(torch.from_numpy(m.T)) for m in mats]).to_dense(),
               np.vstack([m.T for m in mats]))


def test_hvcat_count_mismatch(rng):
    for pkg, wrap in ((lo, jnp.asarray), (lt, torch.from_numpy)):
        A = pkg.LinearOperator(wrap(rng.standard_normal((3, 3))))
        with pytest.raises(pkg.LinearOperatorException):
            pkg.hvcat((2,), A, A, A)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_diagonal(dtype, rng):
    A = simple_matrix(dtype, 3, 3, rng)
    B = simple_matrix(dtype, 2, 4, rng)
    C = simple_matrix(dtype, 2, 2, rng, symmetric=True)
    op_j = lo.BlockDiagonalOperator(lo.LinearOperator(A), jnp.asarray(B), lo.LinearOperator(C))
    op_t = lt.BlockDiagonalOperator(lt.LinearOperator(torch.from_numpy(A)), torch.from_numpy(B),
                                    lt.LinearOperator(torch.from_numpy(C)))
    assert op_t.shape == (7, 9)
    check_all_modes(op_j, op_t, sla.block_diag(A, B, C), rng, dtype == np.complex128)
    S1 = simple_matrix(np.float64, 2, 2, rng, symmetric=True)
    S2 = simple_matrix(np.float64, 3, 3, rng, symmetric=True)
    sym = lt.BlockDiagonalOperator([lt.LinearOperator(torch.from_numpy(S), symmetric=True,
                                                      hermitian=True) for S in (S1, S2)])
    assert sym.symmetric and sym.hermitian and not op_t.symmetric
    sym.reset_counters()
    lt.matvec(sym, torch.ones(5), mode="T")  # a symmetric block diagonal applies N
    assert [o.nprod for o in sym.ops] == [1, 1] and sym.nprod == 1


def test_five_arg_mul_on_blocks_keeps_the_nan_safe_beta_rule(rng):
    """5-arg ``mul`` through a saddle-point block operator: β == 0 never
    reads ``res`` (a NaN there cannot leak), a nonzero β adds β·res."""
    A = simple_matrix(np.float64, 4, 4, rng, symmetric=True)
    Bm = simple_matrix(np.float64, 2, 4, rng)
    K_j = lo.vcat(lo.hcat(lo.LinearOperator(jnp.asarray(A)), lo.LinearOperator(jnp.asarray(Bm.T))),
                  lo.hcat(lo.LinearOperator(jnp.asarray(Bm)), lo.opZeros(2, 2)))
    K_t = lt.vcat(lt.hcat(lt.LinearOperator(torch.from_numpy(A)),
                          lt.LinearOperator(torch.from_numpy(Bm.T))),
                  lt.hcat(lt.LinearOperator(torch.from_numpy(Bm)),
                          lt.opZeros(2, 2, device="cpu")))
    v = rng.standard_normal(6)
    res = np.full(6, np.nan)
    for beta in (0, torch.tensor(0.0)):
        got = lt.mul(K_t, torch.from_numpy(v), 2.0, beta, torch.from_numpy(res))
        assert torch.isfinite(got).all()
        assert_rel(got, lo.mul(K_j, jnp.asarray(v), 2.0, 0.0, jnp.asarray(res)))
    res = rng.standard_normal(6)
    for mode in ("N", "T", "H"):
        assert_rel(lt.mul(K_t, torch.from_numpy(v), 2.0, 0.5, torch.from_numpy(res), mode=mode),
                   lo.mul(K_j, jnp.asarray(v), 2.0, 0.5, jnp.asarray(res), mode=mode))
    M = rng.standard_normal((6, 3))
    R = rng.standard_normal((6, 3))
    assert_rel(lt.mul(K_t, torch.from_numpy(M), -1.0, 3.0, torch.from_numpy(R)),
               lo.mul(K_j, jnp.asarray(M), -1.0, 3.0, jnp.asarray(R)))


def test_hcat_splits_its_input_by_views(rng):
    """The children see views of the input, not copies; vcat allocates one
    output."""
    seen = []
    A = lt.LinearOperator(torch.float64, 2, 3, False, False,
                          lambda v: (seen.append(v), torch.zeros(2, dtype=v.dtype))[1])
    op = lt.hcat(lt.LinearOperator(torch.zeros(2, 2, dtype=torch.float64)), A)
    v = torch.arange(5.0, dtype=torch.float64)
    op * v
    assert seen[0].data_ptr() == v.data_ptr() + 2 * v.element_size()
