"""The port's ones/zeros, shifted and restriction operators, slicing and
``op ± scalar`` against the JAX reference, on the CPU in f64.

Mirrors ``tests/test_special_ops.py`` (``test_ones_zeros``, the restriction,
extension, getindex and slicing cases), ``tests/test_shifted_operator.py``
(4 tests) and the scalar cases of ``tests/test_linop.py``: the same data in
both packages, applied in the N, T, H (and C) modes; max|Δ| ≤ 1e-10·max|ref|
against the reference and the reference test's dense oracle. The probes
(out-of-range indices, non-square shifts, ``op[i]``) raise
``LinearOperatorException`` in both. The export-parity test pins which
names of the reference's ``__all__`` the port has, and which it still lacks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
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


def modes_agree(op_j, op_t, dense, rng, complex_):
    oracle = {"N": dense, "T": dense.T, "C": dense.conj(), "H": dense.conj().T}
    for mode in MODES:
        n = op_t.in_dim(mode)
        v = rng.standard_normal(n) + (1j * rng.standard_normal(n) if complex_ else 0)
        got = op_t.matvec(torch.from_numpy(v), mode=mode)
        assert_rel(got, op_j.matvec(jnp.asarray(v), mode=mode))
        assert_rel(got, oracle[mode] @ v)
        V = rng.standard_normal((n, 2)) + (1j * rng.standard_normal((n, 2)) if complex_ else 0)
        assert_rel(op_t.matmat(torch.from_numpy(V), mode=mode),
                   op_j.matmat(jnp.asarray(V), mode=mode))
    assert_rel(op_t.to_dense(), dense)


TORCH_DT = {np.float64: torch.float64, np.complex128: torch.complex128}


@pytest.mark.parametrize("dtype", DTYPES)
def test_ones_zeros(dtype, rng):
    ones_t = lt.opOnes(4, 3, dtype=TORCH_DT[dtype], device="cpu")
    ones_j = lo.opOnes(4, 3, dtype=dtype)
    assert ones_t.device == torch.device("cpu") and ones_t.dtype == TORCH_DT[dtype]
    modes_agree(ones_j, ones_t, np.ones((4, 3)), rng, dtype == np.complex128)
    zeros_t = lt.opZeros(4, 3, dtype=TORCH_DT[dtype], device="cpu")
    modes_agree(lo.opZeros(4, 3, dtype=dtype), zeros_t, np.zeros((4, 3)), rng,
                dtype == np.complex128)
    assert lt.opOnes(3, 3, device="cpu").symmetric and not ones_t.symmetric
    assert lt.opZeros(3, 3, device="cpu").hermitian and not zeros_t.hermitian
    assert ones_t.to("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_scalar_plus_operator(dtype, rng):
    """op + x == op + x·opOnes, and the three other spellings."""
    A = simple_matrix(dtype, 4, 4, rng)
    op_j, op_t = lo.LinearOperator(A), lt.LinearOperator(torch.from_numpy(A))
    for f, M in ((lambda o: o + 2.0, A + 2.0), (lambda o: 2.0 + o, A + 2.0),
                 (lambda o: o - 2.0, A - 2.0), (lambda o: 2.0 - o, 2.0 - A),
                 (lambda o: o + torch.tensor(0.5) if isinstance(o, lt.AbstractLinearOperator)
                  else o + jnp.asarray(0.5), A + 0.5)):
        got_op = f(op_t)
        assert isinstance(got_op, lt.AbstractLinearOperator)
        modes_agree(f(op_j), got_op, M, rng, dtype == np.complex128)


def test_shifted_basic(rng):
    H = simple_matrix(np.float64, 5, 5, rng, symmetric=True)
    sigma = 0.7
    op_j = lo.ShiftedOperator(lo.LinearOperator(H, symmetric=True, hermitian=True), sigma)
    op_t = lt.ShiftedOperator(lt.LinearOperator(torch.from_numpy(H), symmetric=True,
                                                hermitian=True), sigma)
    modes_agree(op_j, op_t, H + sigma * np.eye(5), rng, False)
    assert op_t.symmetric and op_t.hermitian
    assert op_t.sigma.dtype == torch.float64 and op_t.sigma.ndim == 0


def test_shifted_mutable_sigma(rng):
    """σ changes after construction; nothing else is rebuilt (the same inner
    operator and tensors serve every σ)."""
    H = simple_matrix(np.float64, 4, 4, rng)
    inner = lt.LinearOperator(torch.from_numpy(H))
    op = lt.ShiftedOperator(inner, 0.0)
    op_j = lo.ShiftedOperator(lo.LinearOperator(H), 0.0)
    v = simple_vector(np.float64, 4)
    assert_rel(op * torch.from_numpy(v), H @ v)
    A_before = inner.A
    op.set_sigma(2.5)
    op_j.set_sigma(2.5)
    assert op.op is inner and inner.A is A_before
    modes_agree(op_j, op, H + 2.5 * np.eye(4), rng, False)
    op.sigma = torch.tensor(-1.0, dtype=torch.float64)  # plain assignment works too
    assert_rel(op * torch.from_numpy(v), (H - np.eye(4)) @ v)


def test_shifted_complex_adjoint(rng):
    H = simple_matrix(np.complex128, 4, 4, rng)
    Hh = (H + H.conj().T) / 2
    sigma = 1.0 + 2.0j
    op_j = lo.ShiftedOperator(lo.LinearOperator(Hh, hermitian=True), sigma)
    op_t = lt.ShiftedOperator(lt.LinearOperator(torch.from_numpy(Hh), hermitian=True), sigma)
    modes_agree(op_j, op_t, Hh + sigma * np.eye(4), rng, True)
    assert not op_t.hermitian  # follows the current σ
    op_t.set_sigma(1.0 + 0j)
    assert op_t.hermitian


def test_shifted_requires_square(rng):
    A = simple_matrix(np.float64, 4, 3, rng)
    with pytest.raises(lt.LinearOperatorException):
        lt.ShiftedOperator(lt.LinearOperator(torch.from_numpy(A)), 1.0)
    with pytest.raises(lo.LinearOperatorException):
        lo.ShiftedOperator(lo.LinearOperator(A), 1.0)


def test_restriction_extension(rng):
    idx = np.array([0, 2, 4])
    R_t, R_j = lt.opRestriction(idx, 6, device="cpu"), lo.opRestriction(idx, 6)
    S = np.eye(6)[idx]
    modes_agree(R_j, R_t, S, rng, True)
    E_t, E_j = lt.opExtension(idx, 6, device="cpu"), lo.opExtension(idx, 6)
    modes_agree(E_j, E_t, S.T, rng, True)
    Rk = lt.opRestriction(2, 6, device="cpu")  # an int index
    v = np.arange(10.0, 16.0)
    assert Rk.shape == (1, 6) and float((Rk * torch.from_numpy(v))[0]) == v[2]
    for bad in (np.array([7]), np.array([-1])):
        with pytest.raises(lt.LinearOperatorException):
            lt.opRestriction(bad, 6, device="cpu")
        with pytest.raises(lo.LinearOperatorException):
            lo.opRestriction(bad, 6)
    with pytest.raises(lt.LinearOperatorException):
        lt.opRestriction(np.array([0.5]), 6, device="cpu")
    assert lt.opRestriction(slice(None), 4).shape == (4, 4)
    assert_rel(lt.opRestriction(slice(1, 5, 2), 6, device="cpu") * torch.from_numpy(v), v[1:5:2])
    idx_t = torch.tensor([5, 1])  # an index tensor keeps its device
    assert lt.opRestriction(idx_t, 6).device == torch.device("cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_getindex_slicing(dtype, rng):
    A = simple_matrix(dtype, 6, 5, rng)
    op_j, op_t = lo.LinearOperator(A), lt.LinearOperator(torch.from_numpy(A))
    for key in ((slice(1, 4), slice(0, 3)), (2, slice(None)), (slice(None), 3),
                (np.array([0, 5]), np.array([1, 2, 4])), (slice(None), slice(None)),
                (np.array([1, 1, 3]), 0)):
        sub_t, sub_j = op_t[key], op_j[key]
        assert isinstance(sub_t, lt.AbstractLinearOperator)
        rows = np.arange(6)[key[0]].reshape(-1) if not isinstance(key[0], np.ndarray) else key[0]
        cols = np.arange(5)[key[1]].reshape(-1) if not isinstance(key[1], np.ndarray) else key[1]
        modes_agree(sub_j, sub_t, A[np.ix_(rows, cols)], rng, dtype == np.complex128)
    with pytest.raises(lt.LinearOperatorException):
        op_t[1]


def test_block_slices_apply_as_rows_of_the_whole(rng):
    """``K[r0:r1, c0:c1] @ v`` equals rows r0:r1 of ``K`` applied to v padded
    with zeros (the chip check of the saddle-point system, small)."""
    A = rng.standard_normal((30, 30))
    K = lt.vcat(lt.hcat(lt.LinearOperator(torch.from_numpy(A)), lt.opOnes(30, 5, device="cpu")),
                lt.hcat(lt.opOnes(5, 30, device="cpu"), lt.opZeros(5, 5, device="cpu")))
    r0, r1, c0, c1 = 3, 33, 10, 34
    v = torch.from_numpy(rng.standard_normal(c1 - c0))
    pad = torch.zeros(35, dtype=torch.float64)
    pad[c0:c1] = v
    assert_rel(K[r0:r1, c0:c1] * v, (K * pad)[r0:r1])


def test_restriction_extension_identities(rng):
    n = 10
    v = rng.standard_normal(n)
    for idx in (np.array([0, 1, 3, 6]), np.arange(2, 6), np.arange(0, 7, 2)):
        P = lt.opRestriction(idx, n, device="cpu")
        Z = lt.opExtension(idx, n, device="cpu")
        w, vz = v[idx], np.zeros(n)
        vz[idx] = v[idx]
        vt, wt = torch.from_numpy(v), torch.from_numpy(w)
        assert_rel(P * vt, w)
        assert_rel(P.H * wt, vz)
        assert_rel(Z * wt, vz)
        assert_rel(Z.H * vt, w)
        assert_rel((P @ Z) * wt, w)
        assert_rel((Z @ P) * vt, vz)


def test_restriction_duplicate_indices_adjoint(rng):
    R = lt.opRestriction(np.array([1, 1, 2]), 4, device="cpu")
    v, u = rng.standard_normal(4), rng.standard_normal(3)
    lhs = float((R * torch.from_numpy(v)) @ torch.from_numpy(u))
    rhs = float(torch.from_numpy(v) @ (R.H * torch.from_numpy(u)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert_rel(R.H * torch.from_numpy(u),
               lo.opRestriction(np.array([1, 1, 2]), 4).H * jnp.asarray(u))


def test_slicing_always_returns_operators(rng):
    A = rng.standard_normal((5, 5))
    op = lt.LinearOperator(torch.from_numpy(A))
    col = op[:, 1]
    assert isinstance(col, lt.AbstractLinearOperator) and col.shape == (5, 1)
    assert_rel(col @ torch.tensor([3.0], dtype=torch.float64), A[:, 1] * 3.0)
    scalar = op[1, 1]
    assert isinstance(scalar, lt.AbstractLinearOperator) and scalar.shape == (1, 1)
    assert abs(float((scalar @ torch.tensor([3.0], dtype=torch.float64))[0]) - A[1, 1] * 3) < 1e-12
    assert_rel(op[1:4, 0:2].to_dense(), A[1:4, 0:2])


def test_export_parity():
    """The port exports the reference's spelling of every name it has; what
    the reference exports and the port does not is exactly the list of what
    is still to port."""
    extra = {"MODES", "compose_modes", "matmul_precision", "f32_exact", "check_f32_exact",
             "bsr_from_dense", "coo_from_dense", "csr_from_dense", "csr_from_parts",
             "ell_from_csr_parts", "ell_from_dense"}
    assert set(lt.__all__) - set(lo.__all__) == extra
    for name in lt.__all__:
        assert hasattr(lt, name), name
    slice4 = {"Ones", "Zeros", "opOnes", "opZeros", "RestrictionOperator", "opRestriction",
              "opExtension", "HCatOperator", "VCatOperator", "BlockDiagonalOperator", "hcat",
              "vcat", "hvcat", "ShiftedOperator", "solve_shifted_system",
              "solve_shifted_systems", "ldiv", "gmres", "minres", "bicgstab", "lsqr",
              "chebyshev", "power_iteration"}
    assert slice4 <= set(lt.__all__)
    missing = set(lo.__all__) - set(lt.__all__)
    assert missing == {"apply_cache_sizes", "apply_linear"}
    for alias, cls in (("TimedLinearOperator", "TimedOperator"),
                       ("AdjointLinearOperator", "AdjointOperator"),
                       ("TransposeLinearOperator", "TransposeOperator"),
                       ("ConjugateLinearOperator", "ConjugateOperator")):
        assert getattr(lt, alias) is getattr(lt, cls)
