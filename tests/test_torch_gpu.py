"""The CUDA kernels K1-K14 and the port's dispatch, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card. They import no
jax, so they also run where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Kernel against plain version, same inputs on the card: max|Δ| ≤ 1e-5·max|y|
for f32 results (both accumulate in f32, in different orders), 1e-2 for
bf16 results (bf16 rounding of the output, 2^-8). The transposes (K2, K4,
K6) must be bit-identical on a rerun. The lane kernels K7-K12: gathers and
products exact; lane-group sums (K10) within 1e-6·max|y| (f32) or 2^-7
(bf16); segment sums (K11, K12) within 8·eps_f32·Σ|window| per element, plus,
in bf16, one ulp of the result (2^-7·|y|: two f32 sums that differ slightly
can round to neighbouring bf16 values); K11/K12 bit-identical on a rerun.
K13 (the tiled combine) within 4·eps_f32·Σ|q| per row of its plain version
(plus one bf16 rounding of a bf16 result) and bit-identical on a rerun; K14
equal to its plain version and to K9 with C = 1.
"""

import numpy as np
import pytest
import torch

import linops_tpu_torch as lt
from linops_tpu_torch.kernels import bsr_spmv as K
from linops_tpu_torch.kernels import lane_gather as LG

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
    op = lt.BSROperator(lt.bsr_from_dense(A, (8, 64)))  # on the card by default
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


# ----------------------------------------------------------------------------
# K7-K12: the lane-gather kernels of the routed path
# ----------------------------------------------------------------------------

LANE_R0 = [128, 37, 300]  # a TPU tile multiple, and two ragged row counts


def lane_case(dev, r0, rep, dtype, seed=0):
    """(a, idx, vals, lo, hi) on the card: data (rep·r0, 128) in ``dtype``,
    shared int8 lane indices and values (r0, 128), and per-window segment
    boundaries of random contiguous runs (−1 = empty), as the pack makes them."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((rep * r0, 128)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, 128, (r0, 128)).astype(np.int8)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((r0, 128)).astype(np.float32)).to(dev, dtype)
    lo = np.full((r0, 128), -1, np.int8)
    hi = np.full((r0, 128), -1, np.int8)
    for i in range(r0):
        cuts = np.sort(rng.choice(np.arange(1, 128), 20, replace=False))
        starts, ends = np.r_[0, cuts], np.r_[cuts, 128] - 1
        keep = rng.random(starts.shape[0]) < 0.8  # some output lanes get no run
        outs = np.sort(rng.choice(128, keep.sum(), replace=False))
        hi[i, outs] = ends[keep]
        lo[i, outs] = starts[keep] - 1
    return (a, idx, vals, torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))


def segsum_bound(z, lo, rep, dtype, ref):
    """Elementwise limit for K11/K12 against the plain version: the prefix
    difference errs by about eps·Σ|window| (lane_gather.py:197-202 of the
    reference), plus one ulp of a bf16 result."""
    r0 = lo.shape[0]
    win = z.double().abs().reshape(rep, r0, 128).sum(2, keepdim=True).expand(rep, r0, 128)
    bound = 8 * torch.finfo(torch.float32).eps * win.reshape(rep * r0, 128)
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * ref.double().abs()
    return bound


@pytest.mark.parametrize("r0", LANE_R0)
@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_kernels_match_plain(dev, r0, rep, dtype):
    a, idx, vals, lo, hi = lane_case(dev, r0, rep, dtype)
    # gathers and products: exact (one rounding of an f32 product, both sides)
    out = LG.lane_gather(a, idx, rep=rep)
    assert out.dtype == dtype and torch.equal(out, LG.lane_gather_plain(a, idx, rep))
    out = LG.lane_gather_mul(a, idx, vals, rep=rep)
    assert torch.equal(out, LG.lane_gather_mul_plain(a, idx, vals, rep))
    out = LG.lane_gather_mul_t_batched(a, idx, vals, 1, r0, rep=rep)
    assert tuple(out.shape) == (rep * 128, r0)
    assert torch.equal(out, LG.lane_gather_mul_t_batched_plain(a, idx, vals, 1, r0, rep))
    # sums: f32 accumulation in another order
    for w in (1, 2, 4, 8, 32, 128):
        out = LG.lane_gather_sum(a, idx, w, rep=rep)
        ref = LG.lane_gather_sum_plain(a, idx, w, rep)
        assert tuple(out.shape) == (rep * r0, 128 // w)
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        assert rel_err(out, ref) <= tol, w
    out = LG.lane_segsum(a, lo, hi, rep=rep)
    ref = LG.lane_segsum_plain(a, lo, hi, rep)
    assert ((out.double() - ref.double()).abs() <= segsum_bound(a, lo, rep, dtype, ref)).all()
    assert torch.equal(out, LG.lane_segsum(a, lo, hi, rep=rep))  # deterministic
    out = LG.lane_gather_mul_segsum(a, idx, vals, lo, hi, rep=rep)
    ref = LG.lane_gather_mul_segsum_plain(a, idx, vals, lo, hi, rep)
    z = LG.lane_gather_mul_plain(a.float(), idx, vals.float(), rep)
    assert ((out.double() - ref.double()).abs() <= segsum_bound(z, lo, rep, dtype, ref)).all()
    assert torch.equal(out, LG.lane_gather_mul_segsum(a, idx, vals, lo, hi, rep=rep))


def test_lane_kernels_chunked_transpose_and_launch_counts(dev):
    C, m, rep = 3, 256, 2
    a, idx, vals, _, _ = lane_case(dev, C * m, rep, torch.float32, seed=1)
    LG.reset_launch_counts()
    out = LG.lane_gather_mul_t_batched(a, idx, vals, C, m, rep=rep)
    assert torch.equal(out, LG.lane_gather_mul_t_batched_plain(a, idx, vals, C, m, rep))
    assert LG.launch_counts() == {**dict.fromkeys(LG.launch_counts(), 0),
                                  "lane_gather_mul_t_batched": 1}


@pytest.mark.parametrize("data_dt,vals_dt", [(torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_lane_kernels_take_values_in_their_own_dtype(dev, data_dt, vals_dt):
    """K8/K9/K12 read bf16 values beside f32 data (and the reverse) and write
    f32; a shared operand is never converted or copied: misaligned, it raises."""
    r0, rep = 300, 2
    a, idx, vals, lo, hi = lane_case(dev, r0, rep, torch.float32, seed=2)
    a, vals = a.to(data_dt), vals.to(vals_dt)
    out = LG.lane_gather_mul(a, idx, vals, rep=rep)
    assert out.dtype == torch.float32
    assert torch.equal(out, LG.lane_gather_mul_plain(a, idx, vals, rep))
    out = LG.lane_gather_mul_t_batched(a, idx, vals, 1, r0, rep=rep)
    assert torch.equal(out, LG.lane_gather_mul_t_batched_plain(a, idx, vals, 1, r0, rep))
    out = LG.lane_gather_mul_segsum(a, idx, vals, lo, hi, rep=rep)
    ref = LG.lane_gather_mul_segsum_plain(a, idx, vals, lo, hi, rep)
    z = LG.lane_gather_mul_plain(a, idx, vals, rep)
    assert out.dtype == torch.float32
    assert ((out.double() - ref.double()).abs()
            <= segsum_bound(z, lo, rep, torch.float32, ref)).all()
    r = r0 - 1
    shifted = vals.reshape(-1)[1:1 + r * 128].view(r, 128)
    with pytest.raises(ValueError, match="aligned"):
        LG.lane_gather_mul(a[:r].contiguous(), idx[:r].contiguous(), shifted)


def test_routed_bf16_program_on_f32_data(dev):
    """A bf16 routed operator applied to f32 vectors runs the kernels in f32
    and agrees with the plain pipeline."""
    import scipy.sparse as sps

    from linops_tpu_torch.sparse.routed import routed_matvec, routed_rmatvec

    A = sps.random(6000, 5000, density=0.004, format="csr", random_state=5, dtype=np.float32)
    op = lt.opSparse(A, format="routed", dtype=torch.bfloat16, device=dev)
    assert op.routed.vals.dtype == torch.bfloat16
    v = torch.randn(5000, device=dev)
    u = torch.randn(6000, device=dev)
    LG.reset_launch_counts()
    y, o = routed_matvec(op.routed, v), routed_rmatvec(op.routed_t, u)
    assert y.dtype == o.dtype == torch.float32 and sum(LG.launch_counts().values()) > 0
    assert rel_err(y, routed_matvec(op.routed, v, use_kernel=False)) <= 1e-5
    assert rel_err(o, routed_rmatvec(op.routed_t, u, use_kernel=False)) <= 1e-5


def test_lane_wrappers_reject_what_the_kernels_do_not_take(dev):
    a, idx, vals, lo, hi = lane_case(dev, 64, 1, torch.float32)
    with pytest.raises(TypeError, match="f32/bf16"):
        LG.lane_gather(a.double(), idx)
    with pytest.raises(TypeError, match="int8"):
        LG.lane_gather(a, idx.long())
    with pytest.raises(ValueError, match="rows"):
        LG.lane_gather(a[:, :64].contiguous(), idx[:, :64].contiguous())
    with pytest.raises(ValueError, match="rep="):
        LG.lane_gather(a, idx, rep=2)
    with pytest.raises(ValueError, match="contiguous"):
        LG.lane_segsum(a.t().contiguous().t(), lo, hi)
    with pytest.raises(ValueError, match="is on"):
        LG.lane_gather_mul(a, idx, vals.cpu())
    with pytest.raises(ValueError, match="power of two"):
        LG.lane_gather_sum(a, idx, 3)


def test_routed_dispatch_on_cuda(dev):
    """opSparse(format="routed") on the card: forward through K8/K9 and the
    crossbars, the derived transpose through K12, plain pipeline agrees."""
    import scipy.sparse as sps

    from linops_tpu_torch.sparse.routed import routed_matvec, routed_rmatvec

    A = sps.random(5000, 4000, density=0.005, format="csr", random_state=3, dtype=np.float32)
    op = lt.opSparse(A, format="routed", device=dev)
    assert op.routed.vals.is_cuda and op.routed.vals.shape[1] > 128  # 5-stage
    v = torch.randn(4000, device=dev)
    u = torch.randn(5000, device=dev)
    LG.reset_launch_counts()
    y, o = op * v, op.T * u
    counts = LG.launch_counts()
    for name in ("lane_gather", "lane_gather_mul_t_batched", "lane_gather_sum",
                 "lane_gather_mul_segsum"):
        assert counts[name] > 0, counts
    A64 = torch.from_numpy(A.toarray()).double().to(dev)
    assert rel_err(y, A64 @ v.double()) <= 1e-5
    assert rel_err(o, A64.T @ u.double()) <= 1e-5
    LG.reset_launch_counts()
    y_plain = routed_matvec(op.routed, v, use_kernel=False)
    o_plain = routed_rmatvec(op.routed_t, u, use_kernel=False)
    assert sum(LG.launch_counts().values()) == 0
    assert rel_err(y, y_plain) <= 1e-5 and rel_err(o, o_plain) <= 1e-5


def test_permutation_on_cuda(dev):
    rng = np.random.default_rng(4)
    n = 70000  # 5-stage (padded to 131072 slots)
    perm = rng.permutation(n)
    P = lt.opPermutation(perm, device=dev)
    x = torch.randn(n, device=dev)
    LG.reset_launch_counts()
    pt = torch.from_numpy(perm).to(dev)
    assert torch.equal(P * x, x[pt])
    inv = torch.empty_like(pt)
    inv[pt] = torch.arange(n, device=dev)
    assert torch.equal(P.T * x, x[inv])
    counts = LG.launch_counts()
    assert counts["lane_gather"] > 0 and counts["lane_gather_sum"] == 2


def tiled_case(dev, T, K, rep, dtype, seed=0):
    """q (rep·T·K,) and a rowid (T, K) in any order within a tile, a third of
    the slots trash (−1)."""
    rng = np.random.default_rng(seed)
    rowid = rng.integers(0, 128, (T, K)).astype(np.int8)
    rowid[rng.random((T, K)) < 1 / 3] = -1
    q = torch.from_numpy(rng.standard_normal(rep * T * K).astype(np.float32)).to(dev, dtype)
    return q, torch.from_numpy(rowid).to(dev)


def tiled_bound(q, rowid, rep, ref):
    """4·eps_f32·Σ|q| over each row's slots, plus one ulp of a bf16 result."""
    T, K = rowid.shape
    rid = rowid.long()
    seg = torch.where(rid >= 0, torch.arange(T, device=rid.device)[:, None] * 128 + rid,
                      T * 128).reshape(-1)
    absq = torch.zeros((rep, T * 128 + 1), dtype=torch.float64, device=q.device)
    absq.index_add_(1, seg, q.double().abs().reshape(rep, T * K))
    bound = 4 * torch.finfo(torch.float32).eps * absq[:, :T * 128].reshape(-1)
    if q.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * ref.double().abs()
    return bound


@pytest.mark.parametrize("T,K", [(8, 384), (37, 1000), (5, 7)])
@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_combine_matches_plain(dev, T, K, rep, dtype):
    q, rowid = tiled_case(dev, T, K, rep, dtype)
    LG.reset_launch_counts()
    out = LG.tiled_combine(q, rowid, rep=rep)
    assert LG.launch_counts()["tiled_combine"] == 1
    ref = LG.tiled_combine_plain(q, rowid, rep)
    assert out.dtype == dtype and out.shape == ref.shape == (rep * T * 128,)
    assert ((out.double() - ref.double()).abs() <= tiled_bound(q, rowid, rep, ref)).all()
    assert torch.equal(out, LG.tiled_combine(q, rowid, rep=rep))  # the same bits


@pytest.mark.parametrize("m", [128, 300, 15360])
def test_lane_gather_mul_t_matches_plain_and_k9(dev, m):
    a, idx, vals, _, _ = lane_case(dev, m, 1, torch.float32, seed=3)
    LG.reset_launch_counts()
    out = LG.lane_gather_mul_t(a, idx, vals)
    assert LG.launch_counts()["lane_gather_mul_t"] == 1
    assert LG.launch_counts()["lane_gather_mul_t_batched"] == 0
    assert tuple(out.shape) == (128, m)
    assert torch.equal(out, LG.lane_gather_mul_t_plain(a, idx, vals))
    assert torch.equal(out, LG.lane_gather_mul_t_batched(a, idx, vals, 1, m))


def test_routed_program_without_bounds_runs_k13(dev):
    import scipy.sparse as sps

    from linops_tpu_torch.sparse.routed import routed_matmat, routed_matvec

    A = sps.random(5000, 4000, density=0.005, format="csr", random_state=3, dtype=np.float32)
    p = lt.opSparse(A, format="routed", device=dev).routed
    assert p.comb_lo is not None
    q = p._replace(comb_lo=None, comb_hi=None)
    v = torch.randn(4000, device=dev)
    LG.reset_launch_counts()
    y = routed_matvec(q, v)
    assert LG.launch_counts()["tiled_combine"] == 1 and LG.launch_counts()["lane_segsum"] == 0
    assert rel_err(y, routed_matvec(p, v)) <= 1e-5
    assert rel_err(y, routed_matvec(q, v, use_kernel=False)) <= 1e-5
    assert torch.equal(y, routed_matvec(q, v))
    X = torch.randn(4000, 3, device=dev)
    assert rel_err(routed_matmat(q, X), routed_matmat(p, X)) <= 1e-5


def test_tiled_combine_rejects_what_the_kernel_does_not_take(dev):
    q, rowid = tiled_case(dev, 8, 128, 1, torch.float32)
    with pytest.raises(TypeError, match="f32/bf16"):
        LG.tiled_combine(q.double(), rowid)
    with pytest.raises(TypeError, match="int8"):
        LG.tiled_combine(q, rowid.long())
    with pytest.raises(ValueError, match="rep"):
        LG.tiled_combine(q, rowid, rep=2)
    with pytest.raises(ValueError, match="is on"):
        LG.tiled_combine(q, rowid.cpu())
