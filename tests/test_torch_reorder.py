"""The port's ``opPermutation`` and ``opSparse(reorder="rcm")`` against the JAX
reference, on the CPU.

Mirrors ``tests/test_reorder.py`` and the ``opPermutation`` cases of
``tests/test_special_ops.py``. Tolerances: a permutation moves values, so
its applies are exact; the RCM sandwich in f64 agrees with the reference
and with scipy to max|Δ| ≤ 1e-10·max|ref|; in f32 storage within
2e-4·max|ref| of scipy's f64 product, as the reference's test allows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu_torch.convert import to_numpy

MODES = ("N", "T", "C", "H")


def rel(got, ref) -> float:
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def scrambled_banded(n, bw, seed, symmetric=False):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(k)) for k in range(-bw, bw + 1)]
    A = sps.diags(diags, range(-bw, bw + 1), format="csr")
    if symmetric:
        A = ((A + A.T) * 0.5).tocsr()
    sigma = rng.permutation(n)
    return A[sigma][:, sigma].tocsr(), A


@pytest.mark.parametrize("n", [700, 20000, 70000])  # tiny, 3-stage, 5-stage routes
def test_permutation_operator(rng, n):
    perm = rng.permutation(n)
    P = lt.opPermutation(perm, device="cpu")
    Pj = lo.opPermutation(perm)
    assert len(P.stages) == len(Pj.stages)
    for s, sj in zip(P.stages, Pj.stages):
        assert np.array_equal(to_numpy(s), np.asarray(sj))  # the reference's program
    x = rng.standard_normal(n)
    xt = torch.from_numpy(x)
    assert np.array_equal(to_numpy(P * xt), x[perm])
    assert np.array_equal(to_numpy(P.T * (P * xt)), x)
    assert torch.equal(P.H * xt, P.T * xt)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    assert np.array_equal(to_numpy(P.T * xt), x[inv])
    xc = x + 1j * rng.standard_normal(n)
    assert np.array_equal(to_numpy(P * torch.from_numpy(xc)), xc[perm])
    x32 = torch.from_numpy(x.astype(np.float32))
    assert torch.equal(lt.matvec(P, x32), x32[torch.from_numpy(perm)])
    M = rng.standard_normal((n, 3))
    assert np.array_equal(to_numpy(P.matmat(torch.from_numpy(M))), M[perm])
    with pytest.raises(lt.LinearOperatorException):
        lt.opPermutation(np.zeros(5, int), device="cpu")


def test_permutation_in_algebra_and_conj_matmat(rng):
    n = 256
    perm = rng.permutation(n)
    P = lt.opPermutation(perm, device="cpu")
    M = rng.standard_normal((n, 3))
    assert np.array_equal(to_numpy(P.matmat(torch.from_numpy(M), mode="C")), M[perm])
    assert P.stages_inv is None  # the inverse program packs at the first T dispatch
    P.T * torch.from_numpy(rng.standard_normal(n))
    assert P.stages_inv is not None
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.05)
    x = rng.standard_normal(n)
    chain = P @ lt.LinearOperator(torch.from_numpy(A)) @ P.T
    assert rel(chain * torch.from_numpy(x), A[perm][:, perm] @ x) <= 1e-10
    moved = P.to("cpu")
    assert moved.stages[0].device.type == "cpu" and torch.equal(moved * torch.from_numpy(x),
                                                               P * torch.from_numpy(x))


def test_rcm_sandwich_all_modes():
    Asc, _ = scrambled_banded(300, 4, seed=3)
    op = lt.opSparse(Asc, format="auto", reorder="rcm", device="cpu")
    op_j = lo.opSparse(Asc, format="auto", reorder="rcm")
    assert isinstance(op, lt.ReorderedOperator)
    assert type(op.inner).__name__ == type(op_j.inner).__name__
    assert np.array_equal(to_numpy(op.P.perm), np.asarray(op_j.P.perm))
    rng = np.random.default_rng(0)
    Ad = Asc.toarray()
    for mode in MODES:
        v = rng.standard_normal(300)
        assert rel(op.matvec(torch.from_numpy(v), mode=mode),
                   op_j.matvec(jnp.asarray(v), mode=mode)) <= 1e-10, mode
    v = rng.standard_normal(300)
    assert rel(op * torch.from_numpy(v), Ad @ v) <= 1e-10
    M = rng.standard_normal((300, 5))
    assert rel(op.apply_matrix(torch.from_numpy(M), "N"), Ad @ M) <= 1e-10
    assert rel(op.apply_matrix(torch.from_numpy(M), "T"), Ad.T @ M) <= 1e-10
    assert rel(op.apply_matrix_t(torch.from_numpy(M.T.copy()), "N"), (Ad @ M).T) <= 1e-10
    assert rel(op.to_dense(), Ad) <= 1e-10


def test_rcm_recovers_band_structure():
    # a scrambled banded matrix lands on routed as it is, and on BSR after RCM
    Asc, _ = scrambled_banded(4096, 56, seed=7)
    op = lt.opSparse(Asc, format="auto", reorder="rcm", dtype=torch.float32, device="cpu")
    op_j = lo.opSparse(Asc, format="auto", reorder="rcm", dtype=np.float32)
    scrambled = lt.opSparse(Asc, format="auto", dtype=torch.float32, device="cpu")
    assert isinstance(scrambled, lt.RoutedCSROperator)
    assert isinstance(op.inner, lt.BSROperator)
    assert op.inner.data.block_cols.shape[1] <= 3
    assert op.inner.data.block_shape == op_j.inner.data.block_shape
    v = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    ref = Asc @ v.astype(np.float64)
    assert rel(op * torch.from_numpy(v), ref) <= 2e-4
    assert rel(op.T * torch.from_numpy(v), Asc.T @ v.astype(np.float64)) <= 2e-4


def test_rcm_symmetric_flags_and_cg():
    B = scrambled_banded(200, 3, seed=11, symmetric=True)[0]
    S = (B @ B.T + 10 * sps.eye(200)).tocsr()
    sigma = np.random.default_rng(2).permutation(200)
    Ssc = S[sigma][:, sigma].tocsr()
    op = lt.opSparse(Ssc, format="auto", reorder="rcm", symmetric=True, hermitian=True,
                     device="cpu")
    op_j = lo.opSparse(Ssc, format="auto", reorder="rcm", symmetric=True, hermitian=True)
    assert op.symmetric and op.hermitian
    b = np.random.default_rng(3).standard_normal(200)
    x, k, _ = lt.cg(op, torch.from_numpy(b), tol=1e-12, maxiter=400)
    xj, kj, _ = lo.cg(op_j, jnp.asarray(b), tol=1e-12, maxiter=400)
    assert abs(k - int(kj)) <= 1 and rel(x, xj) <= 1e-9
    assert rel(Ssc @ to_numpy(x), b) <= 1e-9


def test_rcm_rejects_rectangular_and_unknown():
    A = sps.random(30, 20, density=0.2, format="csr", random_state=0)
    with pytest.raises(lt.LinearOperatorException):
        lt.opSparse(A, reorder="rcm", device="cpu")
    Asq = sps.random(30, 30, density=0.2, format="csr", random_state=0)
    with pytest.raises(ValueError):
        lt.opSparse(Asq, reorder="amd", device="cpu")
    with pytest.raises(lt.LinearOperatorException, match="scipy sparse matrix or a dense"):
        lt.opSparse(lt.csr_from_dense(Asq.toarray(), device="cpu"), reorder="rcm")


def test_rcm_dense_input_and_tol():
    rng = np.random.default_rng(5)
    Ad = np.zeros((60, 60))
    for k in (-2, -1, 0, 1, 2):
        idx = np.arange(60 - abs(k))
        Ad[idx + max(0, -k), idx + max(0, k)] = rng.standard_normal(60 - abs(k))
    sigma = rng.permutation(60)
    Asc = Ad[sigma][:, sigma] + 1e-14  # noise below tol
    op = lt.opSparse(Asc, reorder="rcm", tol=1e-12, device="cpu")
    v = rng.standard_normal(60)
    assert rel(op * torch.from_numpy(v), Ad[sigma][:, sigma] @ v) <= 1e-9


def test_rcm_panel_protocol_T_mode():
    Asc, _ = scrambled_banded(150, 3, seed=41)
    op = lt.opSparse(Asc, reorder="rcm", device="cpu")
    Ut = np.random.default_rng(4).standard_normal((3, 150))
    got = op.apply_matrix_t(torch.from_numpy(Ut), mode="T")
    assert rel(got, (Asc.toarray().T @ Ut.T).T) <= 1e-10
