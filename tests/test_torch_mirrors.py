"""The last of the reference's test cases without a counterpart of the same
name: from ``tests/test_sparse.py`` (twelve), ``tests/test_native.py`` (two),
``tests/test_special_ops.py`` (five) and ``tests/test_storage_propagation.py``
(two). Each runs the port on the CPU on the reference's inputs (the same
seeded ``rng``) and holds it to the reference's oracle and tolerance
(``helpers.assert_close``, rtol sqrt(eps)), and to ``linops_tpu``'s own
result on the same inputs. The reference's TPU-only cases (the chunked CSR
apply, the 128-lane row rule, the windowed kernels' packed I/O) have no
counterpart: the port has none of that machinery.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import assert_close, simple_matrix, simple_vector
from torch_refnative import ensure_reference_native

# the reference's native libraries whole before its sparse builders call them
ensure_reference_native()

CPU = dict(device="cpu")
DTYPES = [np.float64, np.complex128]


def sprand(rng, m, n, density=0.1, complex_=False):
    """The reference's generator (``tests/test_sparse.py``)."""
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
    mask = rng.random((m, n)) < density
    return A * mask


def t_(a):
    return torch.from_numpy(np.asarray(a))


def np_(y):
    return y.detach().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def both_close(port, ref, oracle, rtol=None):
    """The port against the oracle (the reference's check) and against the
    reference's own result."""
    kw = {} if rtol is None else dict(rtol=rtol)
    assert_close(np_(port), oracle, **kw)
    assert_close(np_(port), np.asarray(ref), **kw)


# --------------------------------------------------------------------------
# test_sparse.py
# --------------------------------------------------------------------------


def test_sparse_in_algebra(rng):
    """Sparse operators take part in the lazy algebra graph."""
    n = 48
    A = sprand(rng, n, n, 0.1)
    B = sprand(rng, n, n, 0.1)
    v = rng.standard_normal(n)
    chain = 2.0 * (lt.opSparse(A, format="csr", **CPU)
                   @ lt.opSparse(B, format="bsr", block_shape=(8, 16), **CPU)) \
        + lt.opSparse(A, format="csr", **CPU).T - lt.opEye(n)
    chain_j = 2.0 * (lo.opSparse(A, format="csr") @ lo.opSparse(B, format="bsr",
                                                                 block_shape=(8, 16))) \
        + lo.opSparse(A, format="csr").T - lo.opEye(n)
    both_close(chain * t_(v), chain_j * v, (2.0 * (A @ B) + A.T - np.eye(n)) @ v)


def test_sparse_symmetric_flags(rng):
    n = 20
    A = sprand(rng, n, n, 0.3)
    A = (A + A.T) / 2
    op = lt.opSparse(A, format="csr", symmetric=True, hermitian=True, **CPU)
    op_j = lo.opSparse(A, format="csr", symmetric=True, hermitian=True)
    assert op.symmetric and op.hermitian and op_j.symmetric and op_j.hermitian
    assert lt.check_hermitian(op) and lo.check_hermitian(op_j)


def test_scipy_interop(rng):
    m, n = 30, 40
    A = sprand(rng, m, n, 0.2)
    S = scipy_sparse.csr_matrix(A)
    op, op_j = lt.opSparse(S, **CPU), lo.opSparse(S)
    v = rng.standard_normal(n)
    both_close(op * t_(v), op_j * v, A @ v)
    assert op.nnz == op_j.nnz == S.nnz


def test_scipy_coo_no_densify(rng):
    """scipy input with format='coo' builds directly from the COO triplets."""
    S = scipy_sparse.random(50, 40, density=0.1, random_state=2).tocsr()
    op, op_j = lt.opSparse(S, format="coo", **CPU), lo.opSparse(S, format="coo")
    assert type(op).__name__ == type(op_j).__name__ == "COOOperator"
    v = rng.standard_normal(40)
    both_close(op * t_(v), op_j * v, S @ v)


def test_ell_operator(rng):
    """ELL: forward is a gather and a row sum; every mode against the dense
    matrix, with an empty row and a heavy one, from a dense array and from
    scipy."""
    m, n = 37, 29
    A = sprand(rng, m, n, 0.2)
    A[3] = 0.0  # empty row
    A[5, :25] = rng.standard_normal(25)  # heavy row (kmax driver)
    for src in (A, scipy_sparse.csr_matrix(A)):
        op, op_j = lt.opSparse(src, format="ell", **CPU), lo.opSparse(src, format="ell")
        assert type(op).__name__ == type(op_j).__name__ == "ELLOperator"
        v = rng.standard_normal(n)
        u = rng.standard_normal(m)
        both_close(op * t_(v), op_j * v, A @ v)
        both_close(op.T * t_(u), op_j.T * u, A.T @ u)
        both_close(op.H * t_(u), op_j.H * u, A.T @ u)
        both_close(lt.to_dense(op), op_j.to_dense(), A, rtol=1e-12)
        X = rng.standard_normal((n, 3))
        both_close(op.matmat(t_(X)), op_j.matmat(X), A @ X)
        Y = rng.standard_normal((m, 3))
        assert tuple(op.matmat(t_(Y), mode="T").shape) == (n, 3)


def test_ell_complex(rng):
    m = n = 24
    A = sprand(rng, m, n, 0.25, complex_=True)
    op, op_j = lt.opSparse(A, format="ell", **CPU), lo.opSparse(A, format="ell")
    u = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    both_close(op.H * t_(u), op_j.H * u, A.conj().T @ u)
    M = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    both_close(op.matmat(t_(M), mode="C"), op_j.matmat(jnp.asarray(M), mode="C"),
               np.conj(A) @ M)


def _square_sparse(rng, n=64):
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    A[np.arange(n), np.arange(n)] = 1.0
    return A


def _formats(A, pkg, **kw):
    return [pkg.opSparse(A, format=f, **kw) if f != "bsr" else
            pkg.opSparse(A, format="bsr", block_shape=(8, 8), **kw)
            for f in ("coo", "csr", "ell", "bsr")]


def test_sparse_apply_rejects_wrong_length(rng):
    """A wrong-length vector (or a matrix) given to a vector apply raises,
    for every format and mode, in both packages."""
    n = 64
    A = _square_sparse(rng, n)
    for pkg, zeros, kw in ((lt, torch.zeros, CPU), (lo, jnp.zeros, {})):
        for op in _formats(A, pkg, **kw):
            for mode in ("N", "T", "C", "H"):
                with pytest.raises(pkg.LinearOperatorException):
                    op.apply(zeros(n - 3, dtype=torch.float64 if pkg is lt else None), mode)
                with pytest.raises(pkg.LinearOperatorException):
                    op.apply(zeros((n, 2), dtype=torch.float64 if pkg is lt else None), mode)


def test_sparse_apply_matrix_rejects_wrong_shape(rng):
    """A wrong-height (or 1-D) matrix given to ``apply_matrix`` raises, for
    every format and mode, in both packages."""
    n = 64
    A = _square_sparse(rng, n)
    for pkg, zeros, kw in ((lt, torch.zeros, CPU), (lo, jnp.zeros, {})):
        for op in _formats(A, pkg, **kw):
            for mode in ("N", "T", "C", "H"):
                with pytest.raises(pkg.LinearOperatorException):
                    op.apply_matrix(zeros((n - 3, 2), dtype=torch.float64 if pkg is lt else None),
                                    mode)
                with pytest.raises(pkg.LinearOperatorException):
                    op.apply_matrix(zeros(n, dtype=torch.float64 if pkg is lt else None), mode)


def test_native_packer_sums_duplicates(rng):
    """A non-canonical CSR with duplicate (row, col) entries packs to BSR
    with the duplicates summed (scipy's convention), by both packages'
    packers."""
    from linops_tpu.native import bsr_pack_csr as pack_j
    from linops_tpu_torch.native import bsr_pack_csr as pack_t

    rows = np.array([0, 0, 1, 2])
    cols = np.array([1, 1, 2, 0])
    vals = np.array([2.0, 3.0, 1.0, 4.0])
    indptr = np.array([0, 2, 3, 4, 4, 4, 4, 4, 4], np.int32)  # duplicates kept
    dense = {}
    for name, pack in (("port", pack_t), ("reference", pack_j)):
        blocks, bcols = pack(vals, cols, indptr, 8, 8, (4, 4))
        d = np.zeros((8, 8))
        for i in range(blocks.shape[0]):
            for kk in range(blocks.shape[1]):
                j = bcols[i, kk]
                d[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4] += np.asarray(blocks[i, kk])
        dense[name] = d
    want = scipy_sparse.coo_matrix((vals, (rows, cols)), shape=(8, 8)).toarray()
    assert dense["port"][0, 1] == 5.0  # 2 + 3 summed
    np.testing.assert_array_equal(dense["port"], want)
    np.testing.assert_array_equal(dense["port"], dense["reference"])


def test_sparse_matmat_conj_mode(rng):
    """Mode 'C' matmat is conj(A) @ M (the reference's regression:
    triple conjugation returned A @ M)."""
    m, n, k = 12, 15, 4
    A = sprand(rng, m, n, 0.3, complex_=True)
    M = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    for fmt in ("coo", "csr"):
        got = np_(lt.opSparse(A, format=fmt, **CPU).matmat(t_(M), mode="C"))
        np.testing.assert_allclose(got, np.conj(A) @ M, rtol=1e-10)
        ref = np.asarray(lo.opSparse(A, format=fmt).matmat(jnp.asarray(M), mode="C"))
        np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_bsr_matmat_direct(rng):
    """The BSR multi-RHS apply matches the dense product, on unaligned shapes."""
    m, n, k = 37, 53, 6
    A = sprand(rng, m, n, 0.3)
    op = lt.opSparse(A, format="bsr", block_shape=(8, 16), **CPU)
    op_j = lo.opSparse(A, format="bsr", block_shape=(8, 16))
    X = rng.standard_normal((n, k))
    both_close(op.matmat(t_(X)), op_j.matmat(X), A @ X)


def test_bsr_padding_alignment(rng):
    """BSR pads ragged dimensions with zero blocks; the logical shape stays."""
    m, n = 37, 53  # deliberately unaligned
    A = sprand(rng, m, n, 0.3)
    op = lt.opSparse(A, format="bsr", block_shape=(8, 16), **CPU)
    op_j = lo.opSparse(A, format="bsr", block_shape=(8, 16))
    assert op.shape == op_j.shape == (m, n)
    v = rng.standard_normal(n)
    both_close(op * t_(v), op_j * v, A @ v)
    u = rng.standard_normal(m)
    both_close(op.T * t_(u), op_j.T * u, A.T @ u)


# --------------------------------------------------------------------------
# test_native.py
# --------------------------------------------------------------------------


def test_packed_operator_matvec(rng):
    """A CSR packed to BSR by the native packer, as a ``BSROperator``."""
    from linops_tpu.sparse.formats import BSR as BSR_j
    from linops_tpu_torch.native import bsr_pack_csr

    n = 300
    A = scipy_sparse.random(n, n, density=0.03, random_state=2, dtype=np.float64).tocsr()
    blocks, bcols = bsr_pack_csr(A.data, A.indices, A.indptr, n, n, (8, 32), pad_rows_to=8)
    op = lt.BSROperator(lt.BSR(t_(blocks), t_(bcols), (n, n)))
    op_j = lo.BSROperator(BSR_j(jnp.asarray(blocks), jnp.asarray(bcols), (n, n)))
    v = rng.standard_normal(n)
    both_close(op * t_(v), op_j * v, A @ v)
    u = rng.standard_normal(n)
    both_close(op.T * t_(u), op_j.T * u, A.T @ u)


def test_rcm_reduces_banded_bandwidth(rng):
    """On a shuffled banded matrix RCM recovers a small bandwidth; the
    port's native RCM gives the reference's permutation."""
    from linops_tpu.native import rcm_permutation as rcm_j
    from linops_tpu_torch.native import rcm_permutation

    n = 400
    diags = [np.ones(n), np.ones(n - 1), np.ones(n - 1), np.ones(n - 3), np.ones(n - 3)]
    A = scipy_sparse.diags(diags, [0, 1, -1, 3, -3]).tocsr()
    p = rng.permutation(n)
    Ap = A[p][:, p].tocsr()
    perm = np.asarray(rcm_permutation(Ap.indices, Ap.indptr, n))
    assert sorted(perm.tolist()) == list(range(n))
    B = Ap[perm][:, perm].toarray()
    r, c = np.nonzero(B)
    assert np.abs(r - c).max() <= 10  # the original bandwidth is 3
    np.testing.assert_array_equal(perm, np.asarray(rcm_j(Ap.indices, Ap.indptr, n)))


# --------------------------------------------------------------------------
# test_special_ops.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_sized_eye(dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.complex128
    op = lt.opEye(5, dtype=tdt)
    v = simple_vector(dtype, 5)
    assert_close(np_(op @ t_(v)), v)
    assert op.symmetric and op.hermitian
    # rectangular: zero-fills the tail (the reference's rule)
    op2, op2_j = lt.opEye(6, 4, dtype=tdt), lo.opEye(6, 4, dtype=dtype)
    v4 = simple_vector(dtype, 4)
    expected = np.zeros(6, dtype)
    expected[:4] = v4
    both_close(op2 @ t_(v4), op2_j @ v4, expected)
    assert not op2.symmetric and not op2_j.symmetric
    v6 = simple_vector(dtype, 6)
    both_close(op2.T @ t_(v6), op2_j.T @ v6, v6[:4])
    both_close(lt.to_dense(op2), lo.to_dense(op2_j), np.eye(6, 4))


def test_diagonal_rect():
    d = np.linspace(1.0, 2.0, 4)
    D = np.zeros((6, 4))
    np.fill_diagonal(D, d)
    op, op_j = lt.opDiagonal(6, 4, t_(d)), lo.opDiagonal(6, 4, d)
    v = np.arange(1.0, 5.0)
    both_close(op @ t_(v), op_j @ v, D @ v)
    u = np.arange(1.0, 7.0)
    both_close(op.T @ t_(u), op_j.T @ u, D.T @ u)
    assert not op.symmetric
    D2 = np.zeros((3, 5))  # wide
    np.fill_diagonal(D2, d[:3])
    w = np.arange(1.0, 6.0)
    both_close(lt.opDiagonal(3, 5, t_(d)) @ t_(w), lo.opDiagonal(3, 5, d) @ w, D2 @ w)
    op3 = lt.opDiagonal(3, 3, t_(d))  # the square rectangular form truncates
    assert op3.shape == lo.opDiagonal(3, 3, d).shape == (3, 3)
    assert op3.symmetric


def test_integer_operator(rng):
    """An integer-valued matrix wraps and passes the property checks."""
    A = np.round(rng.standard_normal((6, 6)) * 3).astype(np.int64)
    op = lt.LinearOperator(t_(A), **CPU)
    assert lt.check_ctranspose(op)
    assert lt.check_hermitian(op + op.H)
    assert lt.check_positive_definite(op @ op.H + 20 * lt.opEye(6))
    op_j = lo.LinearOperator(jnp.asarray(A))
    assert lo.check_positive_definite(op_j @ op_j.H + 20 * lo.opEye(6))
    v = np.arange(6)
    np.testing.assert_array_equal(np_(op @ t_(v)), np.asarray(op_j @ jnp.asarray(v)))


def test_universal_eye_scalar_rejected():
    """``2.0 * opEye()`` raises in both packages (it must not become the bare
    scalar: A + σ·opEye() would compute A + σ·ones)."""
    for pkg in (lt, lo):
        with pytest.raises(pkg.LinearOperatorException):
            2.0 * pkg.opEye()
        with pytest.raises(pkg.LinearOperatorException):
            pkg.opEye() * 2.0


def test_permutation_conj_matmat_matches_vector_path(rng):
    """Mode 'C' (conjugate, no transpose) of a real permutation acts as 'N'
    on a matrix too; the inverse program is built at the first transpose."""
    n = 256
    perm = rng.permutation(n)
    P = lt.opPermutation(perm, **CPU)
    M = rng.standard_normal((n, 3))
    np.testing.assert_allclose(np_(P.matmat(t_(M), mode="C")), M[perm], atol=0)
    np.testing.assert_allclose(np_(P.matmat(t_(M), mode="C")),
                               np.asarray(lo.opPermutation(perm).matmat(M, mode="C")), atol=0)
    assert P.stages_inv is None
    _ = P.T * t_(rng.standard_normal(n))
    assert P.stages_inv is not None


# --------------------------------------------------------------------------
# test_storage_propagation.py
# --------------------------------------------------------------------------


_TORCH = {jnp.float32: torch.float32, jnp.float64: torch.float64, jnp.complex64: torch.complex64}


@pytest.mark.parametrize("dt", [jnp.float32, jnp.float64, jnp.complex64])
def test_dtype_propagation_constructors(dt, rng):
    """Every constructor keeps its input's dtype, in the operator and in
    its applies, as the reference's do."""
    n = 16
    tdt = _TORCH[dt]
    mat_np = rng.standard_normal((n, n))
    vec_np = rng.standard_normal(n)
    mat, vec = t_(mat_np).to(tdt), t_(vec_np).to(tdt)

    def L(a):
        return lt.LinearOperator(a, **CPU)

    ops = [
        L(mat),
        lt.LinearOperator(tdt, n, n, False, False, lambda v: mat @ v),
        lt.opEye(n, dtype=tdt),
        lt.opEye(8, n, dtype=tdt),
        lt.opOnes(n, n, dtype=tdt, **CPU),
        lt.opZeros(n, n, dtype=tdt, **CPU),
        lt.opDiagonal(vec),
        lt.BlockDiagonalOperator(L(mat), L(mat)),
        lt.hcat(L(mat), lt.opDiagonal(vec)),
        lt.vcat(L(mat), lt.opDiagonal(vec)),
        lt.ShiftedOperator(L(mat), 0.5),
        lt.kron(L(mat[:3, :3]), L(mat[:4, :4])),
        2.0 * L(mat),
        L(mat) + lt.opDiagonal(vec),
        L(mat) @ lt.opDiagonal(vec),
    ]
    mat_j, vec_j = jnp.asarray(mat_np).astype(dt), jnp.asarray(vec_np).astype(dt)
    ref = lo.ShiftedOperator(lo.LinearOperator(mat_j), 0.5)
    for op in ops:
        assert op.dtype == tdt, type(op).__name__
        y = op.matvec(torch.ones(op.ncol, dtype=tdt))
        assert y.dtype == tdt, type(op).__name__
    y = np_(ops[10].matvec(torch.ones(n, dtype=tdt)))
    np.testing.assert_allclose(y, np.asarray(ref.matvec(jnp.ones(n, dt))),
                               rtol=1e-5 if dt != jnp.float64 else 1e-12)
    assert jnp.dtype(lo.opDiagonal(vec_j).dtype) == jnp.dtype(dt)


@pytest.mark.parametrize("dt", [jnp.float32, jnp.float64])
def test_dtype_propagation_qn(dt):
    """The quasi-Newton operators keep their dtype."""
    n = 12
    tdt = _TORCH[dt]
    for op in (lt.LBFGSOperator(tdt, n, mem=3, **CPU), lt.InverseLBFGSOperator(tdt, n, mem=3, **CPU),
               lt.LSR1Operator(tdt, n, mem=3, **CPU)):
        assert op.dtype == tdt
        assert op.matvec(torch.ones(n, dtype=tdt)).dtype == tdt
    if dt == jnp.float64:
        for op, op_j in ((lt.DiagonalPSB(np.ones(n), **CPU), lo.DiagonalPSB(np.ones(n))),
                         (lt.SpectralGradient(1.0, n, **CPU), lo.SpectralGradient(1.0, n))):
            assert op.dtype == tdt and jnp.dtype(op_j.dtype) == jnp.dtype(dt)
