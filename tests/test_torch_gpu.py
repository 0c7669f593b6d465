"""The CUDA kernels K1-K6 and the port's dispatch, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card. They import no
jax, so they also run where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Kernel against plain version, same inputs on the card: max|Δ| ≤ 1e-5·max|y|
for f32 results (both accumulate in f32, in different orders), 1e-2 for
bf16 results (bf16 rounding of the output, 2^-8). The transposes (K2, K4,
K6) must be bit-identical on a rerun.
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
    expected = {**dict.fromkeys(K.launch_counts(), 0), "bsr_matvec": 1, "bsr_rmatvec": 2}
    assert K.launch_counts() == expected
    y_plain = lt.BSROperator(op.data, backend="torch") * v
    y64 = op * v.double()  # an f64 result: the plain version, on the card
    assert K.launch_counts() == expected
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


# ----------------------------------------------------------------------------
# K3-K6: the window kernels
# ----------------------------------------------------------------------------

WINDOW_DIMS = [(256, 2, 8, 128), (96, 3, 16, 64), (64, 4, 3, 130)]
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
         (torch.bfloat16, torch.bfloat16)]


def window_case(dims, multi, seed=0):
    """Host arrays of a banded (or band + far cluster) BSR with packer-style
    pads (column 0, zero block) at the end of every fifth row."""
    nbrow, kmax, bm, bn = dims
    rng = np.random.default_rng(seed)
    nbcol = nbrow // 2 + 24
    cols = (np.arange(nbrow) // 2)[:, None] + np.arange(kmax)[None]
    if multi:
        cols[:, -1] = nbcol - 1 - np.arange(nbrow) % 3  # far cluster
    cols = np.sort(np.minimum(cols, nbcol - 1), axis=1).astype(np.int32)
    blocks = rng.standard_normal((nbrow, kmax, bm, bn)).astype(np.float32)
    cols[::5, -1] = 0
    blocks[::5, -1] = 0.0
    return blocks, cols, nbcol


@pytest.mark.parametrize("dims", WINDOW_DIMS)
@pytest.mark.parametrize("dtypes", PAIRS)
def test_windowed_kernels_match_plain(dev, dims, dtypes):
    blocks, cols, nbcol = window_case(dims, multi=False)
    q, cl, wb, xpb = K.bsr_window_plan(cols, 32, nbcol, wb_max=64, blocks=blocks)
    bdt, vdt = dtypes
    b = torch.from_numpy(blocks).to(dev, bdt)
    c, cl_t, q_t = (torch.from_numpy(a).to(dev) for a in (cols, cl, q))
    x = torch.randn((nbcol, dims[3]), device=dev).to(vdt)
    u = torch.randn((dims[0], dims[2]), device=dev).to(vdt)
    tol = 1e-5 if vdt == torch.float32 else 1e-2
    y = K.bsr_matvec_windowed_kernel(b, cl_t, q_t, x, wb=wb, x_pad_blocks=xpb)
    o = K.bsr_rmatvec_windowed_kernel(b, cl_t, q_t, u, wb=wb, x_pad_blocks=xpb, nbcol=nbcol)
    torch.cuda.synchronize()
    assert y.dtype == o.dtype == vdt
    assert rel_err(y, K.bsr_matvec_windowed_plain(b, cl_t, q_t, x, wb=wb, x_pad_blocks=xpb)) <= tol
    assert rel_err(y, K.bsr_matvec_plain(b, c, x)) <= tol
    assert rel_err(o, K.bsr_rmatvec_windowed_plain(b, cl_t, q_t, u, wb=wb, x_pad_blocks=xpb,
                                                   nbcol=nbcol)) <= tol
    assert rel_err(o, K.bsr_rmatvec_plain(b, c, u, nbcol)) <= tol
    assert torch.equal(o, K.bsr_rmatvec_windowed_kernel(b, cl_t, q_t, u, wb=wb, x_pad_blocks=xpb,
                                                        nbcol=nbcol))


@pytest.mark.parametrize("dims", WINDOW_DIMS)
@pytest.mark.parametrize("dtypes", PAIRS)
def test_multiwin_kernels_match_plain(dev, dims, dtypes):
    blocks, cols, nbcol = window_case(dims, multi=True)
    qm, wb, xpb = K.bsr_window_plan_multi(cols, 32, nbcol, wb_max=16, blocks=blocks)
    qt, vt, xpbt = K.bsr_window_plan_multi_t(cols, 32, nbcol, wb, 4, blocks=blocks)
    bdt, vdt = dtypes
    b = torch.from_numpy(blocks).to(dev, bdt)
    c, qm_t, qt_t, vt_t = (torch.from_numpy(a).to(dev) for a in (cols, qm, qt, vt))
    x = torch.randn((nbcol, dims[3]), device=dev).to(vdt)
    u = torch.randn((dims[0], dims[2]), device=dev).to(vdt)
    tol = 1e-5 if vdt == torch.float32 else 1e-2
    y = K.bsr_matvec_multiwin_kernel(b, c, qm_t, x, wb=wb, x_pad_blocks=xpb)
    t_args = (b, c, qt_t, vt_t, u)
    o = K.bsr_rmatvec_multiwin_kernel(*t_args, wb=wb, x_pad_blocks=xpbt, nbcol=nbcol)
    torch.cuda.synchronize()
    assert y.dtype == o.dtype == vdt
    assert rel_err(y, K.bsr_matvec_multiwin_plain(b, c, qm_t, x, wb=wb, x_pad_blocks=xpb)) <= tol
    assert rel_err(y, K.bsr_matvec_plain(b, c, x)) <= tol
    assert rel_err(o, K.bsr_rmatvec_multiwin_plain(*t_args, wb=wb, x_pad_blocks=xpbt,
                                                   nbcol=nbcol)) <= tol
    assert rel_err(o, K.bsr_rmatvec_plain(b, c, u, nbcol)) <= tol
    assert torch.equal(o, K.bsr_rmatvec_multiwin_kernel(*t_args, wb=wb, x_pad_blocks=xpbt,
                                                        nbcol=nbcol))


def test_untouched_columns_are_exactly_zero(dev):
    blocks, cols, nbcol = window_case((64, 2, 8, 32), multi=False)
    cols[32:] = np.where(cols[32:] != 0, cols[32:] + 12, 0)  # a jump over 12 block columns
    q, cl, wb, xpb = K.bsr_window_plan(cols, 16, nbcol + 12, wb_max=64, blocks=blocks)
    b, c, cl_t, q_t = (torch.from_numpy(a).to(dev) for a in (blocks, cols, cl, q))
    u = torch.randn((64, 8), device=dev)
    o = K.bsr_rmatvec_windowed_kernel(b, cl_t, q_t, u, wb=wb, x_pad_blocks=xpb, nbcol=nbcol + 12)
    ref = K.bsr_rmatvec_plain(b, c, u, nbcol + 12)
    assert torch.count_nonzero(o[ref.abs().sum(1) == 0]) == 0
    assert rel_err(o, ref) <= 1e-5


def test_window_dispatch_on_cuda(dev, monkeypatch):
    """A plan selects its kernels: banded K3/K4, multi K5/K6, not K1/K2."""
    monkeypatch.setattr(K, "BSR_PALLAS_MAX_X_ELEMS", 1024)
    monkeypatch.setattr(K, "_TILE_BYTES_TARGET", 65536)  # row groups of 32
    for multi, names in ((False, ("bsr_matvec_windowed", "bsr_rmatvec_windowed")),
                         (True, ("bsr_matvec_multiwin", "bsr_rmatvec_multiwin"))):
        # a cap of 32 block columns refuses the far cluster a banded window
        monkeypatch.setattr(K, "BSR_PALLAS_MAX_WINDOW_BLOCKS", 32 if multi else 192)
        blocks, cols, nbcol = window_case((256, 4, 8, 128), multi=multi)
        shape = (256 * 8, nbcol * 128)
        op = lt.BSROperator(lt.BSR(torch.from_numpy(blocks), torch.from_numpy(cols), shape)).to(dev)
        assert op.win_q is not None and (op.cols_local is None) == multi and op.t_perm.is_cuda
        v = torch.randn(shape[1], device=dev)
        u = torch.randn(shape[0], device=dev)
        K.reset_launch_counts()
        y, o = op * v, op.T * u
        expected = {**dict.fromkeys(K.launch_counts(), 0), names[0]: 1, names[1]: 1}
        assert K.launch_counts() == expected
        plain = lt.BSROperator(op.data, backend="torch")
        assert rel_err(y, plain * v) <= 1e-5 and rel_err(o, plain.T * u) <= 1e-5


def test_window_wrappers_reject_bad_plans(dev):
    blocks, cols, nbcol = window_case((64, 2, 8, 32), multi=False)
    q, cl, wb, xpb = K.bsr_window_plan(cols, 16, nbcol, wb_max=64, blocks=blocks)
    b, cl_t, q_t = (torch.from_numpy(a).to(dev) for a in (blocks, cl, q))
    x = torch.randn((nbcol, 32), device=dev)
    with pytest.raises(ValueError, match="int32"):
        K.bsr_matvec_windowed_kernel(b, cl_t, q_t.long(), x, wb=wb, x_pad_blocks=xpb)
    with pytest.raises(ValueError, match="do not divide"):
        K.bsr_matvec_windowed_kernel(b, cl_t, q_t[:3].contiguous(), x, wb=wb, x_pad_blocks=xpb)
    with pytest.raises(ValueError, match="shared memory"):
        K.bsr_matvec_windowed_kernel(b, cl_t, q_t, x, wb=1000, x_pad_blocks=xpb)
    with pytest.raises(ValueError, match="never decrease"):
        K.bsr_rmatvec_windowed_kernel(b, cl_t, q_t.flip(0).contiguous(),
                                      torch.randn((64, 8), device=dev), wb=wb,
                                      x_pad_blocks=xpb, nbcol=nbcol)


def test_window_backend_kernel_raises_off_cuda(monkeypatch):
    monkeypatch.setattr(K, "BSR_PALLAS_MAX_X_ELEMS", 1024)
    blocks, cols, nbcol = window_case((64, 2, 8, 128), multi=False)
    op = lt.BSROperator(lt.BSR(torch.from_numpy(blocks), torch.from_numpy(cols),
                               (512, nbcol * 128)), backend="kernel")
    assert op.win_q is not None
    with pytest.raises(lt.LinearOperatorException, match="backend='kernel' needs"):
        op * torch.ones(nbcol * 128)
    with pytest.raises(lt.LinearOperatorException, match="backend='kernel' needs"):
        op.T * torch.ones(512)
