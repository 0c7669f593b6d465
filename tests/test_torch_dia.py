"""Parity of the port's DIA and stencil operators and the Laplacian builders
with the JAX reference, in f64 (and complex128) on the CPU (mirrors
test_dia.py).

The same numpy data goes through both packages (the port's operators built
directly and through ``convert.dia_from_reference`` /
``stencil_from_reference``); N, T, H and C applies, vector, column block
and row panel, agree within max|Δ| ≤ 1e-10·max|ref|, and CG on a stencil
takes the reference's iteration count (±1) with x within 1e-8·‖x‖."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.sparse import dia as jdia
from linops_tpu.sparse import stencil as jst
from linops_tpu_torch.convert import dia_from_reference, stencil_from_reference

RTOL = 1e-10
CPU = dict(device="cpu")


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def banded(rng, n, bw, complex_=False):
    A = np.zeros((n, n), np.complex128 if complex_ else np.float64)
    for k in range(-bw, bw + 1):
        d = rng.standard_normal(n - abs(k))
        if complex_:
            d = d + 1j * rng.standard_normal(n - abs(k))
        A += np.diag(d, k)
    return A


def vec(n, rng, complex_=False, k=None):
    shape = (n,) if k is None else (n, k)
    v = rng.standard_normal(shape)
    return v + 1j * rng.standard_normal(shape) if complex_ else v


def all_modes(op_t, op_j, n, rng, complex_=False):
    for mode in ("N", "T", "H", "C"):
        v = vec(n, rng, complex_)
        close(lt.matvec(op_t, torch.from_numpy(v), mode=mode),
              lo.matvec(op_j, jnp.asarray(v), mode=mode))
        M = vec(n, rng, complex_, 4)
        close(lt.matmat(op_t, torch.from_numpy(M), mode=mode),
              lo.matmat(op_j, jnp.asarray(M), mode=mode))
    Mt = vec(n, rng, complex_, 3).T.copy()
    close(op_t.apply_matrix_t(torch.from_numpy(Mt)), op_j.apply_matrix_t(jnp.asarray(Mt)))


@pytest.mark.parametrize("complex_", [False, True])
def test_dia_from_dense_all_modes(rng, complex_):
    n = 40
    A = banded(rng, n, 3, complex_)
    op_t, op_j = lt.dia_from_dense(A, **CPU), jdia.dia_from_dense(A)
    assert op_t.offsets == op_j.offsets and op_t.symmetric == op_j.symmetric is False
    assert op_t.nnz == op_j.nnz
    all_modes(op_t, op_j, n, rng, complex_)
    close(op_t.to_dense(), A, rtol=1e-12)


def test_dia_carried_across_and_asymmetric_offsets(rng):
    n = 33
    diags = rng.standard_normal((4, n))
    offsets = (-7, -1, 2, 5)
    op_j = jdia.DIAOperator(jnp.asarray(diags), offsets)
    op_t = dia_from_reference(np.asarray(op_j.diags), op_j.offsets, **CPU)
    all_modes(op_t, op_j, n, rng)


def test_dia_transpose_is_deterministic(rng):
    """The slice-add transpose sums in offset order: two runs give the same
    bits, and a symmetric shift pair sums like the reference."""
    n = 64
    A = banded(rng, n, 4)
    op = lt.dia_from_dense(A, **CPU)
    u = torch.from_numpy(rng.standard_normal(n))
    assert torch.equal(op.T @ u, op.T @ u)
    close(op.T @ u, A.T @ u.numpy(), rtol=1e-12)


def test_laplacian_1d():
    n = 16
    L_t, L_j = lt.laplacian_1d(n, dtype=torch.float64, **CPU), jdia.laplacian_1d(
        n, dtype=jnp.float64)
    close(L_t.to_dense(), L_j.to_dense())
    close(L_t.to_dense(), 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1), rtol=1e-12)
    assert L_t.symmetric and L_t.hermitian


def test_laplacian_2d_forms(rng):
    nx, ny = 5, 7
    S_t = lt.laplacian_2d(nx, ny, dtype=torch.float64, **CPU)
    D_t = lt.laplacian_2d_dia(nx, ny, dtype=torch.float64, **CPU)
    assert isinstance(S_t, lt.Stencil2DOperator) and isinstance(D_t, lt.DIAOperator)
    S_j = jdia.laplacian_2d(nx, ny, dtype=jnp.float64)
    D_j = jdia.laplacian_2d_dia(nx, ny, dtype=jnp.float64)
    close(S_t.to_dense(), S_j.to_dense())
    close(D_t.to_dense(), D_j.to_dense())
    close(S_t.to_dense(), D_t.to_dense().numpy(), rtol=0)
    assert S_t.symmetric and S_t.hermitian
    all_modes(S_t, S_j, nx * ny, rng)
    all_modes(D_t, D_j, nx * ny, rng)


def test_kron_of_1d_laplacians_is_the_2d_one(rng):
    """L1 ⊗ I + I ⊗ L1 is the 5-point Laplacian on the square grid."""
    g = 9
    L1 = lt.laplacian_1d(g, dtype=torch.float64, **CPU)
    I1 = lt.LinearOperator(torch.eye(g, dtype=torch.float64))
    K = lt.kron(L1, I1) + lt.kron(I1, L1)
    S = lt.laplacian_2d(g, g, dtype=torch.float64, **CPU)
    v = torch.from_numpy(rng.standard_normal(g * g))
    close(K @ v, (S @ v).numpy(), rtol=1e-12)


@pytest.mark.parametrize("use", ["dia", "stencil"])
def test_in_algebra_and_cg(rng, use):
    g = 12
    n = g * g
    build_t = lt.laplacian_2d if use == "stencil" else lt.laplacian_2d_dia
    build_j = jdia.laplacian_2d if use == "stencil" else jdia.laplacian_2d_dia
    A_t = build_t(g, g, dtype=torch.float64, **CPU) + 0.3 * lt.opEye(n, dtype=torch.float64)
    A_j = build_j(g, g, dtype=jnp.float64) + 0.3 * lo.opEye(n, dtype=jnp.float64)
    b = rng.standard_normal(n)
    xt, kt, rt = lt.cg(A_t, torch.from_numpy(b), tol=1e-10, maxiter=500)
    xj, kj, rj = lo.cg(A_j, jnp.asarray(b), tol=1e-10, maxiter=500)
    assert abs(kt - int(kj)) <= 1 and float(rt) < 1e-8 * np.linalg.norm(b)
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_dia_errors():
    with pytest.raises(lt.LinearOperatorException):
        lt.DIAOperator(torch.zeros(2, 5), [0])  # offsets length mismatch
    with pytest.raises(lt.LinearOperatorException):
        lt.dia_from_dense(np.zeros((3, 4)), **CPU)
    assert lt.dia_from_dense(np.zeros((3, 3)), **CPU).offsets == (0,)


def test_stencil2d_varying_coefficients(rng):
    nx, ny = 5, 6
    offsets = [(0, 0), (0, 1), (1, 0), (-1, -1)]
    coeffs = rng.standard_normal((len(offsets), nx, ny))
    S_t = lt.Stencil2DOperator(nx, ny, offsets, torch.from_numpy(coeffs))
    S_j = jst.Stencil2DOperator(nx, ny, offsets, jnp.asarray(coeffs))
    assert not S_t.symmetric
    all_modes(S_t, S_j, nx * ny, rng)


def test_stencil2d_complex_coefficients(rng):
    nx, ny = 4, 5
    offsets = [(0, -1), (0, 0), (0, 1), (1, 0)]
    coeffs = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    S_t = lt.opStencil2D(nx, ny, offsets, coeffs, **CPU)
    S_j = jst.opStencil2D(nx, ny, offsets, jnp.asarray(coeffs))
    all_modes(S_t, S_j, nx * ny, rng, complex_=True)


def test_stencil_flags():
    S = lt.Stencil2DOperator(4, 4, [(0, 0), (0, 1)], [2.0, -1.0], **CPU)
    assert not S.symmetric  # the mirrored offset is missing
    S2 = lt.Stencil2DOperator(4, 4, [(0, -1), (0, 0), (0, 1)], [-1.0, 2.0, -1.0], **CPU)
    assert S2.symmetric and S2.hermitian
    with pytest.raises(lt.LinearOperatorException):
        lt.opStencil((4, 4), [(0, 0, 1)], [1.0], **CPU)
    with pytest.raises(lt.LinearOperatorException):
        lt.opStencil((4, 4), [(0, 0)], [1.0, 2.0], **CPU)


def test_stencil_3d_and_far_offsets(rng):
    g = (3, 4, 5)
    n = 60
    offsets = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
               (3, 0, 0), (0, -2, 4)]  # the last two reach past the grid's edge
    coeffs = np.array([6.0, -1, -1, -1, -1, -1, -1, 0.5, 0.25])
    S_j = jst.StencilOperator(g, offsets, jnp.asarray(coeffs))
    S_t = stencil_from_reference(S_j.grid_shape, offsets, np.asarray(S_j.coeffs), **CPU)
    dense = np.zeros((n, n))
    for k, off in enumerate(offsets):
        for idx in itertools.product(*(range(s) for s in g)):
            tgt = tuple(i + o for i, o in zip(idx, off))
            if all(0 <= t < s for t, s in zip(tgt, g)):
                dense[np.ravel_multi_index(idx, g), np.ravel_multi_index(tgt, g)] += coeffs[k]
    close(S_t.to_dense(), dense, rtol=1e-12)
    all_modes(S_t, S_j, n, rng)
