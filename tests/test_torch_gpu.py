"""The CUDA kernels K1/K2 and the port's dispatch, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card. They import no
jax, so they also run where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Kernel against plain version, same inputs on the card: max|Δ| ≤ 1e-5·max|y|
for f32 results (both accumulate in f32, in different orders), 1e-2 for
bf16 results (bf16 rounding of the output, 2^-8).
"""

import numpy as np
import pytest
import torch

import linops_tpu_torch as lt
from linops_tpu_torch.kernels import bsr_spmv as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def random_bsr(dev, nbrow, kmax, bm, bn, nbcol, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.randn((nbrow, kmax, bm, bn), generator=g, device=dev).to(dtype)
    cols = torch.randint(0, nbcol, (nbrow, kmax), generator=g, device=dev, dtype=torch.int32)
    return blocks, cols


@pytest.mark.parametrize("dims", [(40, 3, 8, 128, 7), (9, 2, 3, 130, 5), (6, 4, 128, 128, 3),
                                  (33, 5, 16, 16, 40), (5, 1, 1, 300, 2), (64, 8, 9, 33, 20)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_kernels_match_plain(dev, dims, dtypes):
    nbrow, kmax, bm, bn, nbcol = dims
    bdt, vdt = dtypes
    blocks, cols = random_bsr(dev, nbrow, kmax, bm, bn, nbcol, bdt)
    x = torch.randn((nbcol, bn), device=dev).to(vdt)
    u = torch.randn((nbrow, bm), device=dev).to(vdt)
    tol = 1e-5 if vdt == torch.float32 else 1e-2
    y = K.bsr_matvec_kernel(blocks, cols, x)
    o = K.bsr_rmatvec_kernel(blocks, cols, u, nbcol)
    torch.cuda.synchronize()
    assert y.dtype == vdt and o.dtype == vdt
    assert rel_err(y, K.bsr_matvec_plain(blocks, cols, x)) <= tol
    assert rel_err(o, K.bsr_rmatvec_plain(blocks, cols, u, nbcol)) <= tol
    assert torch.equal(o, K.bsr_rmatvec_kernel(blocks, cols, u, nbcol))  # deterministic


def test_empty_columns_and_pad_blocks(dev):
    nbcol = 6
    blocks, cols = random_bsr(dev, 10, 3, 8, 32, nbcol, torch.float32)
    cols = cols % 3  # block columns 3, 4, 5 are never referenced
    blocks[-2:] = 0
    cols[-2:] = 0  # reference-style pad rows: zero blocks at block column 0
    u = torch.randn((10, 8), device=dev)
    o = K.bsr_rmatvec_kernel(blocks, cols, u, nbcol)
    assert torch.count_nonzero(o[3:]) == 0
    assert rel_err(o, K.bsr_rmatvec_plain(blocks, cols, u, nbcol)) <= 1e-5


def test_operator_dispatch_on_cuda(dev):
    rng = np.random.default_rng(0)
    n = 300
    A = (rng.standard_normal((n, n + 20)) * (rng.random((n, n + 20)) < 0.1)).astype(np.float32)
    op = lt.BSROperator(lt.bsr_from_dense(A, (8, 64))).to(dev)
    assert op.col_perm.is_cuda
    A64 = torch.from_numpy(A).double().to(dev)
    v = torch.randn(n + 20, device=dev)
    u = torch.randn(n, device=dev)
    K.reset_launch_counts()
    for got, ref in ((op * v, A64 @ v.double()), (op.T * u, A64.T @ u.double()),
                     (op.H * u, A64.T @ u.double())):
        assert rel_err(got, ref) <= 1e-5
    assert K.launch_counts() == {"bsr_matvec": 1, "bsr_rmatvec": 2}
    y_plain = lt.BSROperator(op.data, backend="torch") * v
    y64 = op * v.double()  # an f64 result: the plain version, on the card
    assert K.launch_counts() == {"bsr_matvec": 1, "bsr_rmatvec": 2}
    assert rel_err(y_plain, y64) <= 1e-5
    with pytest.raises(lt.LinearOperatorException, match="backend='kernel' needs"):
        lt.BSROperator(op.data, backend="kernel") * v.double()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    blocks, cols = random_bsr(dev, 4, 2, 8, 16, 3, torch.float32)
    x = torch.randn((3, 16), device=dev)
    with pytest.raises(TypeError, match="f32/bf16"):
        K.bsr_matvec_kernel(blocks.double(), cols, x.double())
    with pytest.raises(TypeError, match="int32"):
        K.bsr_matvec_kernel(blocks, cols.long(), x)
    with pytest.raises(ValueError, match="is on"):
        K.bsr_matvec_kernel(blocks, cols, x.cpu())
    with pytest.raises(ValueError, match="vector blocks"):
        K.bsr_rmatvec_kernel(blocks, cols, torch.randn((5, 8), device=dev), 3)


def test_tf32_is_refused(dev):
    a = torch.randn((4, 4), device=dev)
    lt.check_f32_exact(a, a)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            lt.MatrixOperator(a) * torch.randn(4, device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
