"""Where the port's factories build: the CUDA device unless asked for the CPU.

Without ``device=``, every factory that builds from host data (``opSparse``,
``opPermutation``, the L-BFGS operators, the ``convert`` functions,
``pack_routed_csr``, the format functions ``*_from_dense``/``*_from_parts``,
``opOnes``/``opZeros``, ``opRestriction``/``opExtension``,
``opDiagonal``/``LinearOperator`` given host data, and since slice 6 the
``laplacian_*`` builders, ``opDIA``/``dia_from_dense``, ``opStencil``/
``opStencil2D``, ``LSR1Operator``, the diagonal quasi-Newton operators,
``opCholesky``/``opLDL``/``opInverse``/``opHouseholder``/``opHermitian``
and ``kron`` given host data) takes the current CUDA device; with no CUDA device it
raises an error naming ``device="cpu"``, and never builds on the CPU
silently. ``device="cpu"`` builds on the CPU. Constructors that take
tensors follow their tensors.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu_torch as lt
from linops_tpu_torch import convert
from linops_tpu_torch.core.base import default_device
from linops_tpu_torch.sparse.routed import pack_routed_csr

A = sps.random(200, 200, density=0.03, format="csr", random_state=0)
PERM = np.random.default_rng(0).permutation(200)

FACTORIES = {
    "opSparse csr": lambda **kw: lt.opSparse(A, format="csr", **kw),
    "opSparse bsr": lambda **kw: lt.opSparse(A, format="bsr", block_shape=(8, 16), **kw),
    "opSparse routed": lambda **kw: lt.opSparse(A, format="routed", **kw),
    "opSparse auto": lambda **kw: lt.opSparse(A.toarray(), format="auto", **kw),
    "opSparse rcm": lambda **kw: lt.opSparse(A, reorder="rcm", **kw),
    "opPermutation": lambda **kw: lt.opPermutation(PERM, **kw),
    "PermutationOperator": lambda **kw: lt.PermutationOperator(PERM, **kw),
    "LBFGSOperator": lambda **kw: lt.LBFGSOperator(200, mem=3, **kw),
    "InverseLBFGSOperator": lambda **kw: lt.InverseLBFGSOperator(torch.float32, 200, **kw),
    "from_numpy": lambda **kw: convert.from_numpy(np.ones(3), **kw),
    "bsr_from_reference": lambda **kw: convert.bsr_from_reference(
        np.ones((2, 1, 8, 16)), np.zeros((2, 1), np.int32), (16, 16), **kw),
    "bsr_operator_from_reference": lambda **kw: convert.bsr_operator_from_reference(
        np.ones((2, 1, 8, 16)), np.zeros((2, 1), np.int32), (16, 16), **kw),
    "diagonal_from_reference": lambda **kw: convert.diagonal_from_reference(np.ones(4), **kw),
    "routed_from_reference": lambda **kw: convert.routed_from_reference(
        pack_routed_csr(A.data, A.indices, A.indptr, A.shape, to_device=False), **kw)[0],
    "pack_routed_csr": lambda **kw: pack_routed_csr(A.data, A.indices, A.indptr, A.shape,
                                                    **kw),
    "coo_from_dense": lambda **kw: lt.coo_from_dense(A.toarray(), **kw),
    "csr_from_dense": lambda **kw: lt.csr_from_dense(A.toarray(), **kw),
    "csr_from_parts": lambda **kw: lt.csr_from_parts(A.data, A.indices, A.indptr, A.shape, **kw),
    "bsr_from_dense": lambda **kw: lt.bsr_from_dense(A.toarray(), (8, 16), **kw),
    "ell_from_dense": lambda **kw: lt.ell_from_dense(A.toarray(), **kw),
    "ell_from_csr_parts": lambda **kw: lt.ell_from_csr_parts(A.data, A.indices, A.indptr,
                                                            A.shape, **kw),
    "opDiagonal": lambda **kw: lt.opDiagonal(np.ones(4), **kw),
    "opDiagonal rect": lambda **kw: lt.opDiagonal(4, 6, [1.0, 2.0, 3.0, 4.0], **kw),
    "LinearOperator": lambda **kw: lt.LinearOperator(np.ones((3, 4)), **kw),
    "opOnes": lambda **kw: lt.opOnes(3, 4, **kw),
    "opZeros": lambda **kw: lt.opZeros(3, 4, **kw),
    "opRestriction": lambda **kw: lt.opRestriction([0, 2], 4, **kw),
    "opExtension": lambda **kw: lt.opExtension(np.array([1, 3]), 4, **kw),
    "laplacian_1d": lambda **kw: lt.laplacian_1d(8, **kw),
    "laplacian_2d": lambda **kw: lt.laplacian_2d(4, 5, **kw),
    "laplacian_2d_dia": lambda **kw: lt.laplacian_2d_dia(4, 5, **kw),
    "opDIA": lambda **kw: lt.opDIA(np.ones((2, 6)), (0, 1), **kw),
    "dia_from_dense": lambda **kw: lt.dia_from_dense(np.eye(5), **kw),
    "opStencil": lambda **kw: lt.opStencil((3, 4), [(0, 0), (1, 0)], [2.0, -1.0], **kw),
    "opStencil2D": lambda **kw: lt.opStencil2D(3, 4, [(0, 0)], [2.0], **kw),
    "LSR1Operator": lambda **kw: lt.LSR1Operator(10, mem=3, **kw),
    "DiagonalPSB": lambda **kw: lt.DiagonalPSB(np.ones(5), **kw),
    "DiagonalAndrei": lambda **kw: lt.DiagonalAndrei(np.ones(5), **kw),
    "DiagonalBFGS": lambda **kw: lt.DiagonalBFGS(np.ones(5), **kw),
    "SpectralGradient": lambda **kw: lt.SpectralGradient(1.0, 5, **kw),
    "opCholesky": lambda **kw: lt.opCholesky(np.eye(4), **kw),
    "opLDL": lambda **kw: lt.opLDL(np.eye(4), **kw),
    "opInverse": lambda **kw: lt.opInverse(np.eye(4), **kw),
    "opHouseholder": lambda **kw: lt.opHouseholder(np.ones(4) / 2, **kw),
    "opHermitian": lambda **kw: lt.opHermitian(np.eye(4), **kw),
    "kron": lambda **kw: lt.kron(np.eye(2), np.ones((2, 2)), **kw),
    "KronOperator": lambda **kw: lt.KronOperator(np.eye(2), np.ones((2, 2)), **kw),
    "lsr1_state_from_reference": lambda **kw: convert.lsr1_state_from_reference(
        {f: np.zeros(()) if f in ("gamma", "opnorm_ub", "insert") else np.zeros((2, 4))
         for f in lt.LSR1State._fields}, **kw),
    "dia_from_reference": lambda **kw: convert.dia_from_reference(np.ones((1, 4)), (0,), **kw),
    "stencil_from_reference": lambda **kw: convert.stencil_from_reference(
        (2, 3), [(0, 0)], np.ones(1), **kw),
    "diagonal_qn_from_reference": lambda **kw: convert.diagonal_qn_from_reference(
        "DiagonalBFGS", np.ones(3), **kw),
}


def _device_of(built):
    if isinstance(built, torch.Tensor):
        return built.device
    if isinstance(built, lt.AbstractLinearOperator):
        return built.device
    if isinstance(built, tuple):
        for v in built:
            if isinstance(v, torch.Tensor):
                return v.device
            if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
                return v[0].device
    raise AssertionError(type(built))


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factories_raise_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lt.LinearOperatorException, match='device="cpu"'):
        FACTORIES[name]()


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factories_build_on_the_cpu_when_asked(name):
    assert _device_of(FACTORIES[name](device="cpu")) == torch.device("cpu")


def test_lbfgs_state_from_reference_follows_the_rule(monkeypatch):
    fields = {f: np.zeros(()) if f in ("gamma", "opnorm_ub", "insert") else np.zeros((2, 4))
              for f in lt.LBFGSState._fields}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lt.LinearOperatorException, match='device="cpu"'):
        convert.lbfgs_state_from_reference(fields)
    st = convert.lbfgs_state_from_reference(fields, device="cpu")
    assert all(getattr(st, f).device.type == "cpu" for f in st._fields)


def test_default_is_the_current_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert default_device() == torch.device("cuda", 0)
    assert default_device("cpu") == torch.device("cpu")


def test_tensor_constructors_follow_their_tensors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bsr = lt.bsr_from_dense(A.toarray(), (8, 16), device="cpu")
    assert lt.BSROperator(bsr).device == torch.device("cpu")
    csr = lt.csr_from_dense(A.toarray(), device="cpu")
    assert lt.opSparse(csr).device == torch.device("cpu")
    assert lt.opSparse(csr, format="routed").routed.vals.device.type == "cpu"
    assert lt.opDiagonal(torch.ones(3)).device == torch.device("cpu")
    M = lt.LinearOperator(torch.ones(3, 3))
    assert M.device == torch.device("cpu")
    # a bare host matrix in the algebra lands on the operator's device
    assert (M @ np.eye(3)).device == torch.device("cpu")
    # and so do the ones of op + x, the indices of a slice, a block's matrix
    assert (M + 2.0).op2.op.device == torch.device("cpu")
    assert M[0:2, 1].device == torch.device("cpu")
    assert lt.hcat(M, np.ones((3, 2))).device == torch.device("cpu")
    assert lt.opRestriction(torch.tensor([0, 1]), 3).device == torch.device("cpu")
    assert lt.ShiftedOperator(M, 2.0).sigma.device == torch.device("cpu")
