"""Parity of the port's sparse formats, COO/CSR/ELL/BSR operators, native
packer and ``opSparse`` with the JAX reference, on the CPU.

- Builders: the same arrays as the reference's (exact).
- Operators, f64 (real and complex): N/T/C/H applies and matrix applies
  agree to max|Δ| ≤ 1e-10·max|ref|.
- Native packer: bit-identical to the reference's ``bsr_pack_csr``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.native import bsr_pack_csr as jax_bsr_pack_csr
from linops_tpu.sparse import formats as JF
from linops_tpu.sparse.ops import _auto_block_shape as jax_auto_block_shape
from linops_tpu_torch import native
from linops_tpu_torch.convert import to_numpy
from linops_tpu_torch.sparse import formats as TF
from linops_tpu_torch.sparse.ops import _auto_block_shape
from torch_refnative import ensure_reference_native

# the reference's native libraries whole before its packer is called
ensure_reference_native()

MODES = ("N", "T", "C", "H")
FORMATS = ("coo", "csr", "ell", "bsr")


def rel_err(got, ref) -> float:
    got = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor) else got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def sprand(rng, m, n, density=0.12, complex_=False):
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
    return A * (rng.random((m, n)) < density)


def vec(rng, n, complex_):
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if complex_ else v


def check_modes(op_t, op_j, rng, complex_, tol=1e-10):
    assert op_t.shape == op_j.shape
    for mode in MODES:
        v = vec(rng, op_t.in_dim(mode), complex_)
        assert rel_err(op_t.matvec(torch.from_numpy(v), mode=mode),
                       op_j.matvec(jnp.asarray(v), mode=mode)) <= tol, mode
        M = np.stack([vec(rng, op_t.in_dim(mode), complex_) for _ in range(3)], axis=1)
        assert rel_err(op_t.matmat(torch.from_numpy(M), mode=mode),
                       op_j.matmat(jnp.asarray(M), mode=mode)) <= tol, mode


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("complex_", [False, True])
def test_opsparse_from_dense_f64(rng, fmt, complex_):
    A = sprand(rng, 45, 70, complex_=complex_)
    op_j = lo.opSparse(A, format=fmt, block_shape=(8, 16), backend="xla")
    op_t = lt.opSparse(A, format=fmt, block_shape=(8, 16), device="cpu")
    check_modes(op_t, op_j, rng, complex_)
    assert rel_err(op_t.to_dense(), A) <= 1e-12


@pytest.mark.parametrize("fmt", FORMATS)
def test_opsparse_from_scipy_f64(rng, fmt):
    A = sprand(rng, 130, 90)
    sp = sps.csr_matrix(A)
    op_j = lo.opSparse(sp, format=fmt, block_shape=(8, 32), backend="xla")
    op_t = lt.opSparse(sp, format=fmt, block_shape=(8, 32), device="cpu")
    check_modes(op_t, op_j, rng, False)
    if fmt == "bsr":  # the native packer's layout, padding included
        assert op_t.data.blocks.shape == op_j.data.blocks.shape
        assert np.array_equal(to_numpy(op_t.data.blocks), np.asarray(op_j.data.blocks))
        assert np.array_equal(to_numpy(op_t.data.block_cols), np.asarray(op_j.data.block_cols))


@pytest.mark.parametrize("fmt", FORMATS)
def test_opsparse_from_prebuilt_formats(rng, fmt):
    A = sprand(rng, 40, 33)
    build = {"coo": "coo_from_dense", "csr": "csr_from_dense", "ell": "ell_from_dense",
             "bsr": "bsr_from_dense"}[fmt]
    args = (A, (8, 16)) if fmt == "bsr" else (A,)
    op_j = lo.opSparse(getattr(JF, build)(*args), backend="xla")
    op_t = lt.opSparse(getattr(TF, build)(*args, device="cpu"))
    assert type(op_t).__name__ == type(op_j).__name__
    check_modes(op_t, op_j, rng, False)


@pytest.mark.parametrize("tol", [0.0, 0.5])
def test_builders_match_reference(rng, tol):
    A = sprand(rng, 37, 29, density=0.3)
    for name, fields in (("coo_from_dense", ("vals", "rows", "cols")),
                         ("csr_from_dense", ("vals", "cols", "indptr", "rows")),
                         ("ell_from_dense", ("vals", "cols"))):
        dj, dt = getattr(JF, name)(A, tol), getattr(TF, name)(A, tol, device="cpu")
        assert tuple(dt.shape) == tuple(dj.shape) and dt.nnz == dj.nnz
        for f in fields:
            a, b = to_numpy(getattr(dt, f)), np.asarray(getattr(dj, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
    sp = sps.csr_matrix(np.where(np.abs(A) > tol, A, 0.0))
    cj = JF.csr_from_parts(sp.data, sp.indices, sp.indptr, sp.shape)
    ct = TF.csr_from_parts(sp.data, sp.indices, sp.indptr, sp.shape, device="cpu")
    ej = JF.ell_from_csr_parts(sp.data, sp.indices, sp.indptr, sp.shape)
    et = TF.ell_from_csr_parts(sp.data, sp.indices, sp.indptr, sp.shape, device="cpu")
    for dt, dj in ((ct, cj), (et, ej)):
        for f in dt._fields[:-1]:
            assert np.array_equal(to_numpy(getattr(dt, f)), np.asarray(getattr(dj, f))), f


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block,pad", [((8, 128), 1), ((8, 32), 16), ((16, 16), 3)])
def test_native_packer_bit_identical(rng, dtype, block, pad):
    A = sprand(rng, 203, 300, density=0.05).astype(dtype)
    A[5, :] = 0.0  # an empty row
    sp = sps.csr_matrix(A)
    bj, cj = jax_bsr_pack_csr(sp.data, sp.indices, sp.indptr, *sp.shape, block, pad_rows_to=pad)
    bt, ct = native.bsr_pack_csr(sp.data, sp.indices, sp.indptr, *sp.shape, block,
                                 pad_rows_to=pad)
    assert bt.dtype == bj.dtype and bt.shape == bj.shape and np.array_equal(bt, bj)
    assert ct.dtype == cj.dtype and np.array_equal(ct, cj)
    kmax, counts = native.bsr_count(sp.indices, sp.indptr, sp.shape[0], block)
    assert kmax == bt.shape[1] and counts.max() == kmax


def test_native_packer_builds_outside_the_reference(rng):
    assert native.available()
    assert native._BUILD.endswith("_native_build") and "linops_tpu_torch" in native._BUILD
    before = native.pack_calls
    lt.opSparse(sps.csr_matrix(sprand(rng, 20, 20)), format="bsr", block_shape=(8, 16),
                device="cpu")
    assert native.pack_calls == before + 1


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_auto_block_shape_matches_reference(rng, dtype):
    n = 256
    A = np.zeros((n, n))
    for i in range(0, n, 32):  # dense 32x32 tiles along the diagonal
        A[i:i + 32, i:i + 32] = rng.standard_normal((32, 32))
    sp = sps.csr_matrix(A.astype(np.float32))
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    assert _auto_block_shape(sp, return_stored=True, dtype=td) == \
        jax_auto_block_shape(sp, return_stored=True, dtype=jd)
    op_j = lo.opSparse(sp, format="bsr", block_shape="auto", dtype=jd, backend="xla")
    op_t = lt.opSparse(sp, format="bsr", block_shape="auto", dtype=td, device="cpu")
    assert op_t.data.block_shape == op_j.data.block_shape
    assert op_t.data.blocks.dtype == (torch.float32 if dtype is None else torch.bfloat16)
    v = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(op_j * jnp.asarray(v), np.float32)
    got = to_numpy(op_t * torch.from_numpy(v))
    assert rel_err(got, ref) <= (1e-6 if dtype is None else 1e-2)


def test_format_auto_picks_bsr_for_blocks(rng):
    A = np.kron(np.eye(16), rng.standard_normal((8, 128)))  # block diagonal, fully dense blocks
    op_t = lt.opSparse(sps.csr_matrix(A), format="auto", device="cpu")
    op_j = lo.opSparse(sps.csr_matrix(A), format="auto", backend="xla")
    assert isinstance(op_t, lt.BSROperator) and type(op_j).__name__ == "BSROperator"
    assert op_t.data.block_shape == op_j.data.block_shape
    v = rng.standard_normal(A.shape[1])
    assert rel_err(op_t * torch.from_numpy(v), A @ v) <= 1e-12


def test_dtype_kwarg_casts_values(rng):
    A = sprand(rng, 64, 64).astype(np.float32)
    v = rng.standard_normal(64).astype(np.float32)
    for fmt in FORMATS:
        op = lt.opSparse(sps.csr_matrix(A), format=fmt, dtype=torch.float64, block_shape=(8, 16),
                         device="cpu")
        assert op.dtype == torch.float64
        assert rel_err(op * torch.from_numpy(v).double(), A.astype(np.float64) @ v) <= 1e-12


def test_unported_paths_raise_naming_slice_3(rng):
    """The paths slices 1-2 left raising (slice 3) now build, like the
    reference's; only unknown formats and reorders raise."""
    A = sprand(rng, 32, 32)
    assert isinstance(lt.opSparse(A, format="routed", device="cpu"), lt.RoutedCSROperator)
    assert isinstance(lt.opSparse(A, format="csr", reorder="rcm", device="cpu"),
                      lt.ReorderedOperator)
    scattered = sps.random(600, 600, density=0.01, random_state=1, format="csr")
    assert isinstance(lt.opSparse(scattered, format="auto", device="cpu"), lt.RoutedCSROperator)
    assert isinstance(lo.opSparse(scattered, format="auto"), lo.RoutedCSROperator)
    with pytest.raises(ValueError, match="unknown sparse format"):
        lt.opSparse(A, format="dia", device="cpu")
    with pytest.raises(ValueError, match="unknown reorder"):
        lt.opSparse(A, reorder="amd", device="cpu")


def test_int32_range_and_shape_checks(rng):
    with pytest.raises(OverflowError):
        TF.check_int32_range((2**31, 4), 10)
    op = lt.opSparse(sprand(rng, 10, 12), format="csr", device="cpu")
    with pytest.raises(lt.LinearOperatorException, match="shape mismatch"):
        op * torch.ones(11, dtype=torch.float64)
    with pytest.raises(lt.LinearOperatorException, match="shape mismatch"):
        op.matmat(torch.ones((10, 2), dtype=torch.float64))


def test_sparse_operators_move_with_to(rng):
    A = sprand(rng, 24, 24)
    for fmt in FORMATS:
        op = lt.opSparse(A, format=fmt, block_shape=(8, 8), symmetric=False, device="cpu")
        moved = op.to("cpu")
        v = torch.from_numpy(rng.standard_normal(24))
        assert torch.equal(moved * v, op * v) and moved.device == torch.device("cpu")
