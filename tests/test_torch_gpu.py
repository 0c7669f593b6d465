"""The CUDA kernels K1-K14 and the port's dispatch, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card. They import no
jax, so they also run where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Kernel against plain version, same inputs on the card: max|Δ| ≤ 1e-5·max|y|
for f32 results (both accumulate in f32, in different orders), 1e-2 for
bf16 results (bf16 rounding of the output, 2^-8). The transposes (K2, K4,
K6) must be bit-identical on a rerun; K2 also on a hot column (every block
row) cut into many chunks and beside empty columns, K6 (on K2's passes) on a
far cluster column every group but one visits, cut into many chunks, beside
columns no window visits. The lane kernels K7-K12: gathers and
products exact; lane-group sums (K10) within 1e-6·max|y| (f32) or 2^-7
(bf16); segment sums (K11, K12) within 8·eps_f32·Σ|window| per element, plus,
in bf16, one ulp of the result (2^-7·|y|: two f32 sums that differ slightly
can round to neighbouring bf16 values); K11/K12 bit-identical on a rerun.
K13 (the tiled combine) within 4·eps_f32·Σ|q| per row of its plain version
(plus one bf16 rounding of a bf16 result) and bit-identical on a rerun, and
equal bit for bit to an f32 walk of its order (each row's slots added in
slot order) for K up to 2049; K14 equal to its plain version and to K9 with
C = 1.

The fixed-order sums (``core/segsum.py``): COO, CSR and ELL applies in N and
T (vector and matrix), the plain K2 in f64, the f64 routed combine and a
restriction's transpose with repeated indices are bit-identical over five
reruns. The slice-6 operators (stencil, DIA, L-SR1, diagonal quasi-Newton)
on the card in f32 agree with the same operators on the CPU in f64 within
1e-5·max|y|.

Gradients (slice 7): a kernel apply's x-gradient is the explicit adjoint
apply bit for bit (the same kernel on the same cotangent), and launches one
transpose kernel; x-gradients against the plain backend's autograd within
1e-5·max|g| (f32 sums in other orders), block gradients within 1e-6 (f32;
one product per entry, the residual differs in its last bits) or 1e-2 (bf16
blocks: one bf16 rounding); window block gradients against the CPU's f64
autograd of the plain windowed versions within 1e-5. Routed value
gradients (slice 8) within 1e-5 of the plain pipeline's autograd; ``vmap``
over a kernel apply runs the kernels (bit for bit per member for K1/K2,
within 1e-6 for the routed matrix kind). The distributed layer at world
size 1 (NCCL): a sharded BSR apply bit for bit the unsharded one, through
K1/K2; kernel and sharded applies make no implicit host synchronisation.

The device loop (slice 9): a solve in captured blocks gives the count and
bits of the eager blocks and of the per-iteration loop (slice 1's CG over
K1/K2, a routed CG over K7, K9-K11), a cached solve captures nothing, a
replay makes no host synchronisation, and an L-BFGS push or an in-place edit
between solves leads to a new capture, never a stale replay.

E1, the small Hermitian eigensolver (slice 10), against its plain version
``torch.linalg.eigh`` on the same (not Hermitian: both read the lower
triangle) inputs, for f32, f64, c64 and c128 at m in {1, 2, 6, 24, 96, 150}
(c128 at 96 and everything at 150 works from global memory):
|Δλ| ≤ 50·eps·‖A‖₂ (the plain version run on the inputs widened to f64 or
c128: in f32 at m = 96 the plain version itself is about 200·eps off on
the H100), ‖AV − VΛ‖₂ ≤ 50·eps·‖A‖₂ and max|VᴴV − I| ≤ 50·eps
(eps of the working precision; eigenvectors are compared through these,
since sign, phase and vectors inside a cluster are not unique); a NaN input
ends with NaN out and leaves the other matrices of its batch alone.
LOBPCG, svds and normest on the device loop: the first, capturing and
cached solves give the same count and bits, the captured block holds E1,
and a replay under ``set_sync_debug_mode("error")`` raises nothing.

E2, the small least-squares solver (slice 14), against its plain version
(``torch.linalg.svd`` at ``jnp.linalg.lstsq``'s cutoff), for (m + 1) x m Hessenbergs in f32, f64, c64 and c128 at m in
{1, 2, 8, 30, 64, 120, 128}, and on both sides of each dtype's shared-memory
edge (m = 168 in f32, 119 in c64 and f64, 84 in c128; past it the global
workspace): the residual ‖H y − b‖ within 50·eps·‖b‖ of the plain
version's in the input's type, the singular values within
max(50, 4·sqrt(sweeps·m))·eps·σ_max of LAPACK's on the inputs widened to f64
or c128 (cuSOLVER's own stray further on these ill-conditioned inputs) (the roundings of the rotations each
column takes, a random walk; these Hessenbergs reach κ = 1e17); the columns
past a lucky breakdown give exact zeros in y, the zero matrix y = 0;
the same bits on a rerun, as each matrix alone, in a CUDA graph and under
``torch.func.vmap`` (one launch). GMRES in captured blocks (one restart a
block), over ``shard_operator`` at world size 1, and nested in a captured CG
as while nodes: the per-iteration loop's
count and bits, E2 in the captured graph, no cuSOLVER call and no sync in a
replay.
"""

import numpy as np
import pytest
import torch

import linops_tpu_torch as lt
from linops_tpu_torch.kernels import bsr_spmv as K
from linops_tpu_torch.kernels import lane_gather as LG
from linops_tpu_torch.kernels import small_eigh as E1
from linops_tpu_torch.kernels import small_lstsq as E2

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


@pytest.mark.parametrize("chunk_slots", [None, 1, 100])
@pytest.mark.parametrize("block", [(8, 128, 200, 3), (128, 128, 80, 2)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_k2_hot_and_empty_columns(dev, block, dtypes, chunk_slots):
    """A column every block row reaches (200 or 80 slots, at least 4 chunks'
    worth of the default plan: 16 slots of 8x128 f32, 1 of 128x128 f32; 1
    slot per chunk gives the combine pass hundreds of rows; 100 stages a
    chunk in two pieces) and two columns no slot reaches."""
    bm, bn, nbrow, kmax = block
    bdt, vdt = dtypes
    nbcol = 12
    blocks, cols = random_bsr(dev, nbrow, kmax, bm, bn, nbcol - 2, bdt, seed=5)
    cols[:, 0] = 4  # the hot column; 10 and 11 stay empty
    u = torch.randn((nbrow, bm), device=dev).to(vdt)
    size = bm * bn * blocks.element_size() if chunk_slots is None else 65536 // chunk_slots
    plan = K.bsr_column_plan(cols, nbcol, size)
    S = plan.chunk_slots
    assert int(plan.col_chunk[5] - plan.col_chunk[4]) >= -(-nbrow // S)
    o = K.bsr_rmatvec_kernel(blocks, cols, u, nbcol, plan=plan)
    torch.cuda.synchronize()
    assert o.dtype == vdt and torch.count_nonzero(o[10:]) == 0
    tol = 1e-5 if vdt == torch.float32 else 1e-2
    assert rel_err(o, K.bsr_rmatvec_plain(blocks, cols, u, nbcol)) <= tol
    o64 = K.bsr_rmatvec_plain(blocks.double(), cols, u.double(), nbcol)
    assert rel_err(o, o64) <= tol
    assert torch.equal(o, K.bsr_rmatvec_kernel(blocks, cols, u, nbcol, plan=plan))


def test_operator_dispatch_on_cuda(dev):
    rng = np.random.default_rng(0)
    n = 300
    A = (rng.standard_normal((n, n + 20)) * (rng.random((n, n + 20)) < 0.1)).astype(np.float32)
    op = lt.BSROperator(lt.bsr_from_dense(A, (8, 64)))  # on the card by default
    assert op.col_plan.perm.is_cuda and op.col_plan.chunk_ptr.is_cuda
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


@pytest.mark.parametrize("dtypes", PAIRS)
def test_k6_hot_and_empty_columns(dev, dtypes):
    """K6 on its column plan: a far cluster column that every group but one
    visits (that group's lane step invalid), cut into many chunks, and
    columns no window visits: the plain K6 and K2 within 1e-5 (1e-2 for a
    bf16 result), exact zeros where no window looks, the same bits on a
    rerun, one launch each."""
    nbrow, kmax, bm, bn = 512, 3, 8, 128
    nbcol = 600
    rng = np.random.default_rng(5)
    cols = np.zeros((nbrow, kmax), np.int32)
    for bi in range(nbrow):
        g = bi // 32
        band = g * 4
        clus = 590 if g != 3 else band + 2
        cols[bi] = sorted([band, band + 1, clus])
    blocks = rng.standard_normal((nbrow, kmax, bm, bn)).astype(np.float32)
    qm, wb, _ = K.bsr_window_plan_multi(cols, 32, nbcol, wb_max=16, blocks=blocks)
    qt, vt, xpbt = K.bsr_window_plan_multi_t(cols, 32, nbcol, wb, 4, blocks=blocks)
    assert vt.min() == 0
    bdt, vdt = dtypes
    b = torch.from_numpy(blocks).to(dev, bdt)
    c, qt_t, vt_t = (torch.from_numpy(a).to(dev) for a in (cols, qt, vt))
    u = torch.randn((nbrow, bm), device=dev).to(vdt)
    plan = K.bsr_multiwin_t_plan(c, qt_t, vt_t, wb, nbcol, block_bytes=65536 // 4)
    hot = int(plan.col_chunk[591] - plan.col_chunk[590])
    assert hot == -(-(nbrow - 32) // 4)
    args = (b, c, qt_t, vt_t, u)
    K.reset_launch_counts()
    o = K.bsr_rmatvec_multiwin_kernel(*args, wb=wb, x_pad_blocks=xpbt, nbcol=nbcol, index=plan)
    o2 = K.bsr_rmatvec_multiwin_kernel(*args, wb=wb, x_pad_blocks=xpbt, nbcol=nbcol, index=plan)
    torch.cuda.synchronize()
    assert K.launch_counts()["bsr_rmatvec_multiwin"] == 2 and torch.equal(o, o2)
    tol = 1e-5 if vdt == torch.float32 else 1e-2
    ref = K.bsr_rmatvec_multiwin_plain(*args, wb=wb, x_pad_blocks=xpbt, nbcol=nbcol)
    assert rel_err(o, ref) <= tol and rel_err(o, K.bsr_rmatvec_plain(b, c, u, nbcol)) <= tol
    assert torch.count_nonzero(o[ref.float().abs().sum(1) == 0]) == 0


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
        index = op.t_plan.perm if multi else op.t_perm
        assert op.win_q is not None and (op.cols_local is None) == multi and index.is_cuda
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


def walk_rows(q, rowid, rep):
    """K13's order on the card: each row's slots added in slot order, from
    zero, in f32, rounded once to q's dtype."""
    T, K = rowid.shape
    qf = q.float().reshape(rep, T, K)
    out = torch.zeros((rep, T, 128), device=q.device)
    rid = rowid.long()
    for k in range(K):
        t = torch.nonzero(rid[:, k] >= 0).reshape(-1)
        out[:, t, rid[t, k]] += qf[:, t, k]
    return out.reshape(-1).to(q.dtype)


@pytest.mark.parametrize("K", [1, 33, 640, 2049, 32768])
@pytest.mark.parametrize("rep", [1, 8])
@pytest.mark.parametrize("order", ["runs", "shuffled"])
def test_tiled_combine_runs_and_shuffled(dev, K, rep, order):
    """Runs as the pack makes them (rows in order, trash last), or shuffled
    rows with trash; K from 1 to TILED_MAX_K (odd K takes the scalar loads)."""
    rng = np.random.default_rng(K + rep)
    T = 3 if K > 4096 else 9
    rowid = np.full((T, K), -1, np.int8)
    for t in range(T):
        rows = np.sort(rng.integers(0, 128, K - K // 5)).astype(np.int8)
        rowid[t, :rows.size] = rows
        if order == "shuffled":
            rowid[t] = rng.permutation(rowid[t])
    rowid = torch.from_numpy(rowid).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.standard_normal(rep * T * K).astype(np.float32)).to(dev, dtype)
        out = LG.tiled_combine(q, rowid, rep=rep)
        ref = LG.tiled_combine_plain(q, rowid, rep)
        assert out.dtype == dtype and out.shape == ref.shape == (rep * T * 128,)
        assert ((out.double() - ref.double()).abs() <= tiled_bound(q, rowid, rep, ref)).all()
        assert torch.equal(out, LG.tiled_combine(q, rowid, rep=rep))
        if K <= 2049:
            assert torch.equal(out, walk_rows(q, rowid, rep))


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


def reruns_equal(fn, times=5):
    first = fn()
    torch.cuda.synchronize()
    return all(torch.equal(first, fn()) for _ in range(times - 1))


@pytest.mark.parametrize("fmt", ["coo", "csr", "ell"])
def test_fixed_order_sparse_applies_are_bit_identical(dev, fmt):
    import scipy.sparse as sps

    # a hot column and hot rows: many contributions into one sum
    A = sps.random(3000, 2500, density=0.01, format="lil", random_state=5, dtype=np.float32)
    A[:, 7] = np.random.default_rng(1).standard_normal((3000, 1)).astype(np.float32)
    A[11, :] = np.random.default_rng(2).standard_normal((1, 2500)).astype(np.float32)
    A = A.tocsr()
    op = lt.opSparse(A, format=fmt, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(2500, generator=g, device=dev)
    u = torch.randn(3000, generator=g, device=dev)
    V = torch.randn(2500, 4, generator=g, device=dev)
    U = torch.randn(3000, 4, generator=g, device=dev)
    A64 = torch.from_numpy(A.toarray()).double().to(dev)
    for fn, ref in ((lambda: op * v, A64 @ v.double()), (lambda: op.T * u, A64.T @ u.double()),
                    (lambda: op.matmat(V), A64 @ V.double()),
                    (lambda: op.matmat(U, mode="T"), A64.T @ U.double())):
        assert reruns_equal(fn)
        assert rel_err(fn(), ref) <= 1e-5


def test_fixed_order_plain_k2_f64_and_restriction(dev):
    blocks, cols = random_bsr(dev, 300, 4, 8, 128, 20, torch.float64, seed=3)
    cols[:, 0] = 5  # a hot column
    u = torch.randn((300, 8), dtype=torch.float64, device=dev)
    o = K.bsr_rmatvec_plain(blocks, cols, u, 20)
    assert reruns_equal(lambda: K.bsr_rmatvec_plain(blocks, cols, u, 20))
    op = lt.BSROperator(lt.BSR(blocks, cols, (2400, 2560)))
    uu = u.reshape(-1)
    assert torch.equal(op.T * uu, o.reshape(-1)) and reruns_equal(lambda: op.T * uu)
    idx = torch.randint(0, 50, (20000,), device=dev)
    R = lt.opRestriction(idx, 50)
    w = torch.randn(20000, device=dev)
    W = torch.randn(20000, 3, device=dev)
    assert reruns_equal(lambda: R.T * w) and reruns_equal(lambda: R.matmat(W, mode="T"))
    want = torch.zeros(50, dtype=torch.float64, device=dev).index_add_(0, idx, w.double())
    assert rel_err(R.T * w, want) <= 1e-6


def test_fixed_order_f64_routed_combine(dev):
    import scipy.sparse as sps

    from linops_tpu_torch.sparse.routed import routed_matvec

    T, Kt, rep = 40, 640, 2
    rowid = torch.randint(-1, LG.RADIX, (T, Kt), device=dev, dtype=torch.int32)
    q = torch.randn(rep * T * Kt, dtype=torch.float64, device=dev)
    assert reruns_equal(lambda: LG.tiled_combine_plain(q, rowid, rep))
    A = sps.random(5000, 4000, density=0.005, format="csr", random_state=3, dtype=np.float64)
    p = lt.opSparse(A, format="routed", device=dev).routed
    q64 = p._replace(comb_lo=None, comb_hi=None)
    v = torch.randn(4000, dtype=torch.float64, device=dev)
    LG.reset_launch_counts()
    y = routed_matvec(q64, v)
    assert sum(LG.launch_counts().values()) == 0  # f64: the plain pipeline
    assert reruns_equal(lambda: routed_matvec(q64, v))
    A64 = torch.from_numpy(A.toarray()).to(dev)
    assert rel_err(y, A64 @ v) <= 1e-12


def test_slice6_operators_on_card_match_cpu(dev):
    cpu = torch.device("cpu")
    g = 96
    n = g * g
    x = torch.randn(n, dtype=torch.float64)
    X = torch.randn(n, 6, dtype=torch.float64)
    for build in (lt.laplacian_2d, lt.laplacian_2d_dia):
        op32 = build(g, g, dtype=torch.float32, device=dev)
        op64 = build(g, g, dtype=torch.float64, device=cpu)
        assert rel_err((op32 * x.float().to(dev)).cpu(), op64 * x) <= 1e-5
        assert rel_err((op32.T * x.float().to(dev)).cpu(), op64.T * x) <= 1e-5
        assert rel_err(op32.apply_matrix_t(X.T.float().to(dev).contiguous()).cpu(),
                       op64.apply_matrix_t(X.T.contiguous())) <= 1e-5
        assert rel_err(op32.matmat(X.float().to(dev)).cpu(), op64.matmat(X)) <= 1e-5
    rng = np.random.default_rng(0)
    B32 = lt.LSR1Operator(torch.float32, n, mem=6, scaling=True, device=dev)
    B64 = lt.LSR1Operator(torch.float64, n, mem=6, scaling=True, device=cpu)
    Q32 = lt.DiagonalBFGS(np.ones(n, np.float32), device=dev)
    Q64 = lt.DiagonalBFGS(np.ones(n), device=cpu)
    for _ in range(8):
        s = rng.standard_normal(n)
        y = 2 * s + 0.5 * rng.standard_normal(n)
        B32.push(torch.from_numpy(s).float(), torch.from_numpy(y).float())
        B64.push(torch.from_numpy(s), torch.from_numpy(y))
        Q32.push(torch.from_numpy(s).float(), torch.from_numpy(y).float())
        Q64.push(torch.from_numpy(s), torch.from_numpy(y))
    assert B32.insert == B64.insert
    assert rel_err((B32 * x.float().to(dev)).cpu(), B64 * x) <= 1e-5
    assert rel_err(B32.diag().cpu(), B64.diag()) <= 1e-5
    assert rel_err(Q32.diag().cpu(), Q64.diag()) <= 1e-5


def test_checkpoint_roundtrip_on_card(dev, tmp_path):
    """save_operator / load_operator_state reload card state bit for bit:
    L-BFGS, L-SR1, diagonal QN, BSR and DIA operators."""
    from linops_tpu_torch.utils.checkpoint import _walk

    n = 4096
    g = torch.Generator(device=dev).manual_seed(7)

    def pushed(op, count=5):
        for _ in range(count):
            s = torch.randn(n, generator=g, device=dev)
            op.push(s, 2 * s + 0.5 * torch.randn(n, generator=g, device=dev))
        return op

    blocks, cols = random_bsr(dev, n // 8, 4, 8, 128, n // 128, torch.float32, seed=9)
    diags = torch.randn(3, n, generator=g, device=dev)
    cases = [
        (pushed(lt.LBFGSOperator(torch.float32, n, mem=4, device=dev)),
         lambda: lt.LBFGSOperator(torch.float32, n, mem=4, device=dev)),
        (pushed(lt.LSR1Operator(torch.float32, n, mem=4, scaling=True, device=dev)),
         lambda: lt.LSR1Operator(torch.float32, n, mem=4, scaling=True, device=dev)),
        (pushed(lt.DiagonalAndrei(torch.ones(n, device=dev)), 2),
         lambda: lt.DiagonalAndrei(torch.ones(n, device=dev))),
        (lt.BSROperator(lt.BSR(blocks, cols, (n, n))),
         lambda: lt.BSROperator(lt.BSR(torch.zeros_like(blocks), cols.clone(), (n, n)))),
        (lt.opDIA(diags, (-1, 0, 5)), lambda: lt.opDIA(torch.zeros_like(diags), (-1, 0, 5))),
    ]
    v = torch.randn(n, generator=g, device=dev)
    for i, (op, fresh) in enumerate(cases):
        path = str(tmp_path / f"op{i}.npz")
        lt.save_operator(path, op)
        back = lt.load_operator_state(path, fresh())
        a, _ = _walk(op, [], [])
        b, _ = _walk(back, [], [])
        assert len(a) == len(b) and all(x.is_cuda and torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(back @ v, op @ v)


# ----------------------------------------------------------------------------
# Slice 7: gradients through the kernel applies (core/ad.py)
# ----------------------------------------------------------------------------


def launches():
    return {k: v for k, v in {**K.launch_counts(), **LG.launch_counts()}.items() if v}


def reset_launches():
    K.reset_launch_counts()
    LG.reset_launch_counts()


@pytest.mark.parametrize("mode", ["N", "T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_gradients_on_card(dev, mode, dtype):
    """½‖op(A)x − b‖²: the x-gradient is the explicit adjoint apply bit for
    bit and launches one transpose kernel (K2 for N, K1 for T); x and block
    gradients agree with the plain backend's autograd (x 1e-5; blocks 1e-6
    in f32, 1e-2 for bf16 blocks, one bf16 rounding)."""
    nbrow, kmax, bm, bn, nbcol = 40, 3, 8, 128, 7
    blocks, cols = random_bsr(dev, nbrow, kmax, bm, bn, nbcol, dtype, seed=11)
    leaf = blocks.clone().requires_grad_(True)
    shape = (nbrow * bm - 5, nbcol * bn - 3)
    op = lt.BSROperator(lt.BSR(leaf, cols, shape))
    plain = lt.BSROperator(lt.BSR(leaf, cols, shape), backend="torch")
    n_in = shape[1] if mode == "N" else shape[0]
    b = torch.randn(shape[0] if mode == "N" else shape[1], device=dev)

    def loss(o, x):
        r = (o @ x if mode == "N" else o.T @ x) - b
        return 0.5 * torch.dot(r, r)

    x = torch.randn(n_in, device=dev, requires_grad=True)
    L = loss(op, x)
    reset_launches()
    gx, gB = torch.autograd.grad(L, (x, leaf))
    assert launches() == {("bsr_rmatvec" if mode == "N" else "bsr_matvec"): 1}
    with torch.no_grad():
        r = (op @ x if mode == "N" else op.T @ x) - b
        assert torch.equal(gx, op.T @ r if mode == "N" else op @ r)
    gx_p, gB_p = torch.autograd.grad(loss(plain, x), (x, leaf))
    assert gx.dtype == torch.float32 and gB.dtype == dtype
    assert rel_err(gx, gx_p) <= 1e-5
    assert rel_err(gB, gB_p) <= (1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("multi", [False, True])
def test_window_gradients_on_card(dev, monkeypatch, multi):
    """K3-K6 under autograd: x-gradients equal the explicit transpose (K4/K6)
    or forward (K3/K5) bit for bit; block gradients agree with autograd of
    the plain windowed versions, on the CPU in f64, within 1e-5."""
    monkeypatch.setattr(K, "BSR_PALLAS_MAX_X_ELEMS", 1024)
    monkeypatch.setattr(K, "_TILE_BYTES_TARGET", 65536)
    monkeypatch.setattr(K, "BSR_PALLAS_MAX_WINDOW_BLOCKS", 32 if multi else 192)
    blocks, cols, nbcol = window_case((256, 4, 8, 128), multi=multi)
    shape = (256 * 8, nbcol * 128)
    host = lt.BSROperator(lt.BSR(torch.from_numpy(blocks).double(), torch.from_numpy(cols),
                                 shape))
    op = host.to(dev)
    op.data = op.data._replace(blocks=op.data.blocks.float().requires_grad_(True))
    host.data = host.data._replace(blocks=host.data.blocks.requires_grad_(True))
    assert op.win_q is not None and (op.cols_local is None) == multi
    names = (("bsr_matvec_multiwin", "bsr_rmatvec_multiwin") if multi
             else ("bsr_matvec_windowed", "bsr_rmatvec_windowed"))
    for mode, want in (("N", names[1]), ("T", names[0])):
        n_in = shape[1] if mode == "N" else shape[0]
        x = torch.randn(n_in, device=dev, requires_grad=True)
        g = torch.randn(shape[0] if mode == "N" else shape[1], device=dev)
        y = op @ x if mode == "N" else op.T @ x
        reset_launches()
        gx, gB = torch.autograd.grad(y, (x, op.data.blocks), g)
        assert launches() == {want: 1}
        with torch.no_grad():
            assert torch.equal(gx, op.T @ g if mode == "N" else op @ g)
        xh = x.detach().double().cpu().requires_grad_(True)
        yh = host @ xh if mode == "N" else host.T @ xh
        gx_h, gB_h = torch.autograd.grad(yh, (xh, host.data.blocks), g.double().cpu())
        assert rel_err(gx.cpu(), gx_h) <= 1e-5 and rel_err(gB.cpu(), gB_h) <= 1e-5


def test_mixed_graph_gradient_on_card(dev):
    """(A + opDiagonal(d)) @ x: the kernel's share of the gradient is there."""
    blocks, cols = random_bsr(dev, 32, 3, 8, 128, 2, torch.float32, seed=12)
    op = lt.BSROperator(lt.BSR(blocks, cols, (256, 256)))
    d = torch.linspace(1.0, 2.0, 256, device=dev)
    x = torch.randn(256, device=dev, requires_grad=True)
    g = torch.randn(256, device=dev)
    (gx,) = torch.autograd.grad((op + lt.opDiagonal(d)) @ x, x, g)
    with torch.no_grad():
        assert rel_err(gx, op.T @ g + d * g) <= 1e-6
    gf = torch.func.grad(lambda v: torch.dot(g, (op + lt.opDiagonal(d)) @ v))(x.detach())
    assert rel_err(gf, gx) <= 1e-6


def test_routed_gradients_on_card(dev, monkeypatch):
    """The routed x-gradient is the explicit derived-transpose apply bit for
    bit (K12 in the backward, no forward kernel) and agrees with the plain
    pipeline's autograd within 1e-5; the value gradients of the forward
    program (N, and mat/panel kinds) and of the derived transpose (T) agree
    with the plain pipeline's autograd within 1e-5, routed back through K7
    and gathered by K8; a symmetric operator's backward runs its forward
    program."""
    import scipy.sparse as sps

    from linops_tpu_torch.sparse import routed as TR
    from linops_tpu_torch.sparse.routed import routed_matvec

    A = sps.random(5000, 4000, density=0.005, format="csr", random_state=3, dtype=np.float32)
    op = lt.opSparse(A, format="routed", device=dev)
    b = torch.randn(5000, device=dev)
    x = torch.randn(4000, device=dev, requires_grad=True)
    r = op @ x - b
    reset_launches()
    (gx,) = torch.autograd.grad(0.5 * torch.dot(r, r), x)
    c = launches()
    assert c.get("lane_gather_mul_segsum") == 1 and "lane_gather_mul_t_batched" not in c
    with torch.no_grad():
        assert torch.equal(gx, op.T @ (op @ x - b))
    r_p = routed_matvec(op.routed, x, use_kernel=False) - b
    (gx_p,) = torch.autograd.grad(0.5 * torch.dot(r_p, r_p), x)
    assert rel_err(gx, gx_p) <= 1e-5

    def value_grad(mode, kind, xin, g, slot):
        leaf = op._program_values()[slot].requires_grad_(True)
        f = {"vec": op.apply, "mat": op.apply_matrix, "panel": op.apply_matrix_t}[kind]
        (gv,) = torch.autograd.grad(f(xin, mode), leaf, g)
        leaf.requires_grad_(False)
        return gv

    cases = [("N", "vec", torch.randn(4000, device=dev), torch.randn(5000, device=dev), 0),
             ("T", "vec", torch.randn(5000, device=dev), torch.randn(4000, device=dev), 1),
             ("N", "mat", torch.randn(4000, 3, device=dev), torch.randn(5000, 3, device=dev), 0),
             ("N", "panel", torch.randn(3, 4000, device=dev), torch.randn(3, 5000, device=dev), 0)]
    for mode, kind, xin, g, slot in cases:
        reset_launches()
        got = value_grad(mode, kind, xin, g, slot)
        c = launches()
        assert c.get("lane_gather", 0) > 0 and c.get("lane_gather_mul", 0) > 0, c
        with monkeypatch.context() as mp:  # the plain pipeline, autograd into the values
            mp.setattr(TR, "_use_kernel", lambda uk, vals, x_: False if uk is None else bool(uk))
            want = value_grad(mode, kind, xin, g, slot)
        assert rel_err(got, want) <= 1e-5, (mode, kind)
    S = sps.random(3000, 3000, density=0.004, format="csr", random_state=4, dtype=np.float32)
    S = (S + S.T).tocsr()
    op_s = lt.opSparse(S, format="routed", symmetric=True, hermitian=True, device=dev)
    xs = torch.randn(3000, device=dev, requires_grad=True)
    g = torch.randn(3000, device=dev)
    (gs,) = torch.autograd.grad(op_s @ xs, xs, g)
    assert op_s.routed_t is None
    with torch.no_grad():
        assert torch.equal(gs, op_s @ g)


def test_routed_matrix_gradient_on_card(dev):
    """A routed matrix apply's gradient is the adjoint matrix apply."""
    import scipy.sparse as sps

    A = sps.random(3000, 2500, density=0.005, format="csr", random_state=5, dtype=np.float32)
    op = lt.opSparse(A, format="routed", device=dev)
    X = torch.randn(2500, 4, device=dev, requires_grad=True)
    G = torch.randn(3000, 4, device=dev)
    (gX,) = torch.autograd.grad(lt.matmat(op, X), X, G)
    with torch.no_grad():
        assert torch.equal(gX, lt.matmat(op, G, mode="T"))


def test_permutation_gradient_on_card(dev):
    n = 70000
    perm = np.random.default_rng(4).permutation(n)
    P = lt.opPermutation(perm, device=dev)
    x = torch.randn(n, device=dev, requires_grad=True)
    g = torch.randn(n, device=dev)
    pt = torch.from_numpy(perm).to(dev)
    inv = torch.empty_like(pt)
    inv[pt] = torch.arange(n, device=dev)
    y = P @ x
    reset_launches()
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, g[inv]) and launches().get("lane_gather_sum") == 1


def test_vmap_over_a_kernel_apply_raises_on_card(dev):
    """(The name is kept from when vmap over a kernel apply raised; it now
    runs.) vmap over 8 vectors: K1 once per member, the T apply as one K2p
    launch on the batch (a row panel), bit for bit the vector applies (K2p
    keeps K2's order per column); the routed N apply as a row panel (rep-8 kernels)
    within 1e-6 of the vector applies; a batch of operators (batched
    blocks) once per member through K1."""
    import scipy.sparse as sps

    blocks, cols = random_bsr(dev, 512, 4, 8, 128, 32, torch.float32, seed=13)
    op = lt.BSROperator(lt.BSR(blocks, cols, (4096, 4096)))
    V = torch.randn(8, 4096, device=dev)
    for mode, kernel, count in (("N", "bsr_matvec", 8), ("T", "bsr_rmatmat", 1)):
        reset_launches()
        Y = torch.func.vmap(lambda v: op.apply(v, mode))(V)
        assert launches().get(kernel) == count and launches().get("bsr_rmatvec", 0) == 0
        assert torch.equal(Y, torch.stack([op.apply(v, mode) for v in V]))
    A = sps.random(6000, 5000, density=0.004, format="csr", random_state=8, dtype=np.float32)
    routed = lt.opSparse(A, format="routed", device=dev)
    W = torch.randn(8, 5000, device=dev)
    reset_launches()
    Y = torch.func.vmap(lambda v: routed @ v)(W)
    assert launches().get("lane_gather_sum", 0) > 0
    assert rel_err(Y, torch.stack([routed @ w for w in W])) <= 1e-6
    Bs = torch.stack([blocks, 2 * blocks])
    x = torch.randn(4096, device=dev)
    Yb = torch.func.vmap(lambda b: lt.BSROperator(lt.BSR(b, cols, (4096, 4096))) @ x)(Bs)
    assert torch.equal(Yb[0], op @ x) and torch.equal(Yb[1], lt.BSROperator(
        lt.BSR(2 * blocks, cols, (4096, 4096))) @ x)


def _world_of_one():
    """This process as a world of one NCCL rank (idempotent) and its mesh."""
    from linops_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed()
    return make_mesh()


def test_sharded_bsr_world_of_one_on_card(dev):
    """A sharded BSR operator at world size 1 runs K1/K2 on its shard and
    equals the unsharded operator bit for bit."""
    from linops_tpu_torch.parallel import row_sharding, shard_operator

    mesh = _world_of_one()
    blocks, cols = random_bsr(dev, 1024, 8, 8, 128, 64, torch.float32, seed=15)
    op = lt.BSROperator(lt.BSR(blocks, cols, (8192, 8192)))
    op_sh = shard_operator(op, mesh)
    x = torch.randn(8192, device=dev)
    xs = row_sharding(mesh).place(x)
    reset_launches()
    y, yt = op_sh @ xs, op_sh.T @ xs
    assert launches() == {"bsr_matvec": 1, "bsr_rmatvec": 1}
    assert torch.equal(y.full_tensor(), op @ x) and torch.equal(yt.full_tensor(), op.T @ x)


def test_kernel_and_sharded_applies_read_nothing_back(dev):
    """The mirror of ``tests/test_no_transfers.py``: after a warm-up, the
    kernel applies (K1/K2, a routed operator, a permutation) and a sharded
    BSR apply make no implicit device-to-host synchronisation
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one). Solver
    loops read their stopping test once per block; a block's replay is
    checked in ``test_replay_raises_nothing_under_sync_debug_error``."""
    import scipy.sparse as sps

    from linops_tpu_torch.parallel import row_sharding, shard_operator

    mesh = _world_of_one()
    blocks, cols = random_bsr(dev, 256, 4, 8, 128, 16, torch.float32, seed=16)
    op = lt.BSROperator(lt.BSR(blocks, cols, (2048, 2048)))
    A = sps.random(3000, 3000, density=0.003, format="csr", random_state=9, dtype=np.float32)
    routed = lt.opSparse(A, format="routed", device=dev)
    P = lt.opPermutation(np.random.default_rng(5).permutation(70000), device=dev)
    op_sh = shard_operator(op, mesh)
    x, xr, xp = (torch.randn(n, device=dev) for n in (2048, 3000, 70000))
    xs = row_sharding(mesh).place(x)

    def applies():
        return (op @ x, op.T @ x, routed @ xr, routed.T @ xr, P @ xp, P.T @ xp, op_sh @ xs,
                op_sh.T @ xs)

    applies()  # warm-up: plans, builds, first launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = applies()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(t.full_tensor() if hasattr(t, "full_tensor") else t).all()
               for t in out)


def test_iterative_inverse_and_apply_linear_gradients_on_card(dev):
    """The implicit backward through a kernel-backed graph against the
    dense solve's gradient (1e-4: CG to 1e-6 in f32); apply_linear's
    backward is one K2 and gives the blocks no gradient."""
    blocks, cols = random_bsr(dev, 32, 3, 8, 128, 2, torch.float32, seed=14)
    blocks = blocks * 0.05
    B = lt.BSROperator(lt.BSR(blocks, cols, (256, 256)))
    Bd = lt.to_dense(B).double()
    d = torch.linspace(1.0, 2.0, 256, device=dev, requires_grad=True)
    b = torch.randn(256, device=dev, requires_grad=True)
    w = torch.randn(256, device=dev)
    A = lt.opDiagonal(d) @ (B.T @ B) @ lt.opDiagonal(d) + 2.0 * lt.opEye(256, dtype=torch.float32)
    inv = lt.opIterativeInverse(A, solver="cg", tol=1e-6, maxiter=500)
    gd, gb = torch.autograd.grad(torch.dot(w, inv @ b), (d, b))
    d64 = d.detach().double().requires_grad_(True)
    b64 = b.detach().double().requires_grad_(True)
    A64 = d64[:, None] * (Bd.T @ Bd) * d64[None, :] + 2.0 * torch.eye(256, device=dev,
                                                                      dtype=torch.float64)
    gd64, gb64 = torch.autograd.grad(torch.dot(w.double(), torch.linalg.solve(A64, b64)),
                                     (d64, b64))
    assert rel_err(gd, gd64) <= 1e-4 and rel_err(gb, gb64) <= 1e-4
    leaf = blocks.clone().requires_grad_(True)
    op = lt.BSROperator(lt.BSR(leaf, cols, (256, 256)))
    x = torch.randn(256, device=dev, requires_grad=True)
    y = lt.apply_linear(op, x)
    reset_launches()
    gx, gB = torch.autograd.grad(y, (x, leaf), w, allow_unused=True)
    assert launches() == {"bsr_rmatvec": 1} and gB is None
    with torch.no_grad():
        assert torch.equal(gx, op.T @ w)


# ---------------------------------------------------------------- slice 9: device loops


@pytest.fixture
def loop_mod():
    """``utils/loop.py`` with an empty cache, its settings restored after."""
    from linops_tpu_torch.utils import loop

    saved = loop.BLOCK, loop.CAPTURE
    loop.clear_cache()
    yield loop
    loop.BLOCK, loop.CAPTURE = saved
    loop.clear_cache()


def slice1_graph(dev, n=8192, seed=30):
    """Slice 1's graph D (BᵀB) D + 2·I over an 8x128 BSR operator, with an
    inverse L-BFGS preconditioner of 8 pairs (s, A s), and b."""
    blocks, cols = random_bsr(dev, n // 8, 8, 8, 128, n // 128, torch.float32, seed=seed)
    B = lt.BSROperator(lt.BSR(blocks * (8 * 128) ** -0.5, cols, (n, n)))
    D = lt.opDiagonal(torch.linspace(1.0, 2.0, n, device=dev))
    A = D @ (B.T @ B) @ D + 2.0 * lt.opEye(n, dtype=torch.float32)
    H = lt.InverseLBFGSOperator(torch.float32, n, mem=8, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for _ in range(8):
        s = torch.randn(n, generator=g, device=dev)
        H.push(s, A * s)
    return A, H, torch.randn(n, generator=g, device=dev)


def routed_spd(dev, n=6000, seed=32):
    """A routed SPD matrix R + Rᵀ + D (K7, K9-K11 in its apply) and b."""
    import scipy.sparse as sps

    R = sps.random(n, n, density=4.0 / n, format="csr", random_state=seed, dtype=np.float32)
    S = (R + R.T).tocsr()
    A = (S + sps.diags(np.asarray(abs(S).sum(axis=1)).ravel().astype(np.float32) + 1.0)).tocsr()
    op = lt.opSparse(A, format="routed", symmetric=True, hermitian=True, device=dev)
    return op, torch.randn(n, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def solve_modes(loop, solve):
    """(x, k, stats) of ``solve`` in eager blocks, in the per-iteration loop
    (blocks of 1), as the first solve of its signature on the graph path
    (the plain loop), as the second (it captures) and cached."""
    out = {}
    for name, (block, capture) in (("eager", (loop.BLOCK, False)), ("per_iteration", (1, False)),
                                   ("first", (loop.BLOCK, True)),
                                   ("capture", (loop.BLOCK, True)),
                                   ("cached", (loop.BLOCK, True))):
        saved = loop.BLOCK, loop.CAPTURE
        loop.BLOCK, loop.CAPTURE = block, capture
        if name == "first":
            loop.clear_cache()
        try:
            x, k, _ = solve()
        finally:
            loop.BLOCK, loop.CAPTURE = saved
        out[name] = (x, k, dict(loop.stats))
    return out


def traced_kernels(fn, want, tries=3) -> dict:
    """The port's kernels one call of fn ran, per device function, counted
    in a torch.profiler trace: the first of up to ``tries`` traces that
    counts ``want``, else the last (a trace can lose activity records, and
    never counts a kernel that did not run)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    syms = set(K.LAUNCH_SYMBOLS.values()) | set(LG.LAUNCH_SYMBOLS.values())
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(r"(\w+)[<(]", e.key)
            if m and m.group(1) in syms:
                out[m.group(1)] = out.get(m.group(1), 0) + e.count
        if out == want:
            break
    return out


@pytest.mark.parametrize("case", ["slice1", "routed"])
def test_graph_blocks_match_eager_blocks_bit_for_bit(dev, loop_mod, case):
    """Slice 1's preconditioned CG (K1/K2) and a routed CG (K7, K9-K11):
    the same count and the same bits from eager blocks, the per-iteration
    loop, the signature's first solve (the plain loop), its second (it
    captures) and a cached one; the cached solve captures nothing, and one
    replay runs the launches its capture recorded (a profiler trace counts
    them), which the wrappers' counts do not see again."""
    if case == "slice1":
        A, H, b = slice1_graph(dev)
        solve = lambda: lt.cg(A, b, M=H, tol=1e-5, maxiter=300)  # noqa: E731
        kernels, tables = ("bsr_matvec", "bsr_rmatvec"), K
    else:
        A, b = routed_spd(dev)
        solve = lambda: lt.cg(A, b, tol=1e-6, maxiter=300)  # noqa: E731
        kernels, tables = ("lane_gather", "lane_gather_sum"), LG
    solve()  # warm-up: plans and builds
    runs = solve_modes(loop_mod, solve)
    x0, k0, _ = runs["eager"]
    assert k0 > 2 * loop_mod.BLOCK
    for name, (x, k, st) in runs.items():
        assert k == k0 and torch.equal(x, x0), name
    assert runs["eager"][2]["path"] == "blocks"
    assert runs["first"][2]["path"] == "per_iteration" and runs["first"][2]["reads"] == k0 + 1
    assert runs["first"][2]["captures"] == 0 and runs["capture"][2]["captures"] == 1
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["captures"] == 0 and st["replays"] == st["blocks"]
    assert st["reads"] == st["blocks"] == -(-k0 // loop_mod.BLOCK)  # no initial read
    g = loop_mod.last_graph()
    assert all(g.launches.get(name, 0) > 0 for name in kernels), g.launches
    symbols = {**K.LAUNCH_SYMBOLS, **LG.LAUNCH_SYMBOLS}
    want = {}
    for name, c in g.launches.items():
        want[symbols[name]] = want.get(symbols[name], 0) + c
    assert traced_kernels(g.replay, want) == want
    tables.reset_launch_counts()
    A.apply(torch.zeros_like(b))  # the setup's r = b - A x0, eager in every solve
    setup = tables.launch_counts()
    tables.reset_launch_counts()
    solve()
    assert tables.launch_counts() == setup  # the replays added nothing


def test_replay_raises_nothing_under_sync_debug_error(dev, loop_mod):
    """A captured block holds no host synchronisation: a replay under
    ``set_sync_debug_mode("error")`` raises nothing; so does a shifted
    L-BFGS solve with σ on the card."""
    A, H, b = slice1_graph(dev)
    for _ in range(2):  # the second solve captures
        lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    g = loop_mod.last_graph()
    assert g is not None
    B = lt.LBFGSOperator(torch.float32, 4096, mem=5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(33)
    for _ in range(5):
        s = torch.randn(4096, generator=gen, device=dev)
        B.push(s, 2.0 * s + 0.1 * torch.randn(4096, generator=gen, device=dev))
    v = torch.randn(4096, generator=gen, device=dev)
    sigma = torch.tensor(0.5, device=dev)
    ref = {m: lt.solve_shifted_system(B, v, sigma, method=m) for m in ("compact", "ejm")}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
        out = {m: lt.solve_shifted_system(B, v, sigma, method=m) for m in ("compact", "ejm")}
        X = lt.solve_shifted_systems(B, v, torch.stack([sigma, 2 * sigma]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for m in out:
        assert torch.equal(out[m], ref[m])
    assert torch.equal(X[0], ref["compact"]) or rel_err(X[0], ref["compact"]) <= 1e-6


def test_push_between_solves_recaptures(dev, loop_mod):
    """An L-BFGS push replaces M's state tensors with new ones of the same
    layout: the next solve keeps its signature, copies the new state into
    the captured block's own and replays (no capture, no stale state), and
    gives a fresh eager solve's result bit for bit; a solve with no push
    since copies nothing. The state the caller held is unchanged."""
    A, H, b = slice1_graph(dev)
    for _ in range(3):
        lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    assert loop_mod.stats["path"] == "graph" and loop_mod.stats["captures"] == 0  # cached
    held = H.state
    copies = [t.clone() for t in held]
    s = torch.randn(A.nrow, generator=torch.Generator(device=dev).manual_seed(34), device=dev)
    H.push(s, A * s)
    x, k, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    st = dict(loop_mod.stats)
    assert st["path"] == "graph" and st["captures"] == 0 and st["replays"] > 0
    assert 0 < st["copied_bytes"] < st["static_bytes"]  # the state alone
    x2, k2, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    assert loop_mod.stats["captures"] == 0 and loop_mod.stats["copied_bytes"] == 0
    assert all(torch.equal(a, c) for a, c in zip(held, copies))
    loop_mod.CAPTURE = False
    x_e, k_e, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    assert k == k2 == k_e and torch.equal(x, x_e) and torch.equal(x2, x_e)


@pytest.mark.parametrize("case", ["lbfgs_reset", "lsr1", "diagonal", "sigma", "sigma_host"])
def test_state_updates_replay_bit_for_bit(dev, loop_mod, case):
    """Updates of each kind of state field between solves (an L-BFGS reset
    and pushes, L-SR1 pushes, diagonal QN pushes, new shifts σ, and σ
    assigned as a CPU scalar, which goes to the card): from the third solve
    on each replays with no capture, and every solve gives the per-iteration
    loop's count and bits."""
    n = 4096
    gen = torch.Generator(device=dev).manual_seed(36)
    d = torch.linspace(1.0, 10.0, n, device=dev)
    A = lt.opDiagonal(d)
    b = torch.randn(n, generator=gen, device=dev)
    if case in ("sigma", "sigma_host"):
        op, M = lt.ShiftedOperator(A, 0.5), None
    elif case == "lbfgs_reset":
        op, M = A, lt.InverseLBFGSOperator(torch.float32, n, mem=4, device=dev)
    elif case == "lsr1":
        op, M = lt.ShiftedOperator(lt.LSR1Operator(torch.float32, n, mem=4, device=dev), 20.0), None
    else:
        op, M = A, lt.DiagonalBFGS(torch.ones(n, device=dev))

    def update(i):
        if case == "sigma":
            op.set_sigma(0.5 + i)
            return
        if case == "sigma_host":
            op.sigma = torch.tensor(0.5 + i)
            assert op.sigma.is_cuda
            return
        target = M if M is not None else op.op
        if case == "lbfgs_reset" and i == 3:
            target.reset()
            return
        s = torch.randn(n, generator=gen, device=dev)
        target.push(s, (d if case != "lsr1" else 0.1 * d) * s)

    solve = (lambda: lt.minres(op, b, tol=1e-6, maxiter=400)) \
        if case in ("sigma", "sigma_host", "lsr1") \
        else (lambda: lt.cg(op, b, M=M, tol=1e-6, maxiter=400))
    for i in range(6):
        update(i)
        x, k, _ = solve()
        st = dict(loop_mod.stats)
        if i >= 2:
            assert st["path"] == "graph" and st["captures"] == 0 and st["replays"] > 0, (i, st)
        saved = loop_mod.BLOCK, loop_mod.CAPTURE
        loop_mod.BLOCK, loop_mod.CAPTURE = 1, False
        try:
            x1, k1, _ = solve()
        finally:
            loop_mod.BLOCK, loop_mod.CAPTURE = saved
        assert k == k1 and torch.equal(x, x1), (i, k, k1)
    assert lt.apply_cache_sizes()["graphs"] >= 1


def test_capture_runs_under_sync_debug_error(dev, loop_mod):
    """A capture runs with ``set_sync_debug_mode("error")``: a host read in an
    apply is refused where it would be baked into the graph, and the mode
    the caller had is back after, a failed capture included."""
    A, H, b = slice1_graph(dev, n=2048)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(2):
            lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
        assert loop_mod.stats["captures"] == 1
        assert torch.cuda.get_sync_debug_mode() == 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = 256
    d = torch.linspace(1.0, 2.0, n, device=dev)
    F = lt.FunctionOperator(n, n, lambda v: v * d[:1].item() + d * v, symmetric=True,
                            hermitian=True, dtype=torch.float32, capture_safe=True)
    rhs = torch.ones(n, device=dev)
    lt.cg(F, rhs, tol=1e-7, maxiter=100)
    with pytest.raises(RuntimeError, match="FunctionOperator"):
        lt.cg(F, rhs, tol=1e-7, maxiter=100)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_chain_timer_waits_for_the_card(dev):
    """``marginal_chain_time`` on a run that returns CUDA tensors, with no
    ``device=``, times with CUDA events and waits for each run: it agrees
    with the device time of the same chain measured by events around a
    synchronized run, where timing only the enqueue would report far less."""
    from linops_tpu_torch.utils import timing

    M = torch.randn(8192, 8192, device=dev)  # 268 MB a product: the card sets the pace
    v = torch.randn(8192, device=dev)

    def run(iters):
        x = v
        for _ in range(iters):
            x = torch.tanh(M @ x)
        return x

    per = timing.marginal_chain_time(run, iters_short=5, iters_long=105, reps=3)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    run(5)
    torch.cuda.synchronize()
    e0.record()
    run(100)
    e1.record()
    torch.cuda.synchronize()
    ref = e0.elapsed_time(e1) / 1e3 / 100
    assert 0.5 * ref <= per <= 2.0 * ref, (per, ref)


def test_in_place_edit_of_a_leaf_recaptures(dev, loop_mod):
    """An in-place edit bumps the leaf's version and keeps its layout: the
    next solve keeps the signature and replays after copying the edited
    leaf (and nothing else) into the block's copy (no stale replay, no
    capture), the one after copies nothing, and both give the eager result
    of the edited operator."""
    from linops_tpu_torch.core.base import capture_signature

    A, H, b = slice1_graph(dev)
    for _ in range(2):
        lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    assert loop_mod.stats["captures"] == 1
    leaf = next(t for t in capture_signature(A)[1] if t.ndim == 1 and t.numel() == A.nrow)  # d
    leaf.mul_(1.5)
    x, k, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    st = dict(loop_mod.stats)
    assert st["path"] == "graph" and st["captures"] == 0 and st["replays"] > 0
    assert st["copied_bytes"] == leaf.numel() * leaf.element_size()
    x2, k2, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    assert loop_mod.stats["captures"] == 0 and loop_mod.stats["copied_bytes"] == 0
    loop_mod.CAPTURE = False
    x_e, k_e, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
    assert k == k2 == k_e and torch.equal(x, x_e) and torch.equal(x2, x_e)


def test_fresh_operators_replay_bit_for_bit(dev, loop_mod):
    """An outer loop that builds slice 1's graph anew each step (new D, new
    blocks on one pattern through ``opSparse``, a fresh inverse L-BFGS):
    one capture for the structure, replays from the third step with every
    tensor copied into the block's copies, x and the count bit for bit the
    per-iteration loop's; the graph the block was captured with is dropped
    and its memory refilled with NaN before a replay."""
    n = 8192
    _, cols = random_bsr(dev, n // 8, 8, 8, 128, n // 128, torch.float32, seed=40)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(41), device=dev)

    def build(step):
        g = torch.Generator(device=dev).manual_seed(50 + step)
        blocks = torch.randn((n // 8, 8, 8, 128), generator=g, device=dev) * (8 * 128) ** -0.5
        B = lt.opSparse(lt.BSR(blocks, cols, (n, n)), format="bsr")
        D = lt.opDiagonal(1.0 + torch.rand(n, generator=g, device=dev))
        A = D @ (B.T @ B) @ D + 2.0 * lt.opEye(n, dtype=torch.float32)
        H = lt.InverseLBFGSOperator(torch.float32, n, mem=8, device=dev)
        for _ in range(8):
            s = torch.randn(n, generator=g, device=dev)
            H.push(s, A * s)
        return A, H, B

    junk = None
    for step in range(5):
        A, H, B = build(step)
        x, k, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
        st = dict(loop_mod.stats)
        saved = loop_mod.BLOCK, loop_mod.CAPTURE
        loop_mod.BLOCK, loop_mod.CAPTURE = 1, False
        try:
            x1, k1, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
        finally:
            loop_mod.BLOCK, loop_mod.CAPTURE = saved
        assert k == k1 and torch.equal(x, x1), (step, k, k1)
        assert st["captures"] == (1 if step == 1 else 0), (step, st)
        if step >= 2:
            assert st["path"] == "graph" and st["replays"] > 0 and st["copied_bytes"] > 0, st
        if step == 1:  # the captured graph's memory, refilled
            shapes = [(B.data.blocks.shape, B.data.blocks.dtype)]
            del A, H, B, x, x1
            torch.cuda.synchronize()
            junk = [torch.full(s_, float("nan"), dtype=dt, device=dev) for s_, dt in shapes]
    # one block; a signature per block length (the per-iteration runs' BLOCK 1 too)
    sizes = lt.apply_cache_sizes()
    assert sizes["graphs"] == 1 and sizes["signatures"] == 2 and junk is not None


def fresh_slice1(dev, cols, seed, n=8192):
    """Slice 1's graph over the BSR pattern ``cols`` with fresh values: new
    blocks, a new D, a fresh inverse L-BFGS with 8 pairs (s, A s)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.randn((n // 8, 8, 8, 128), generator=g, device=dev) * (8 * 128) ** -0.5
    B = lt.opSparse(lt.BSR(blocks, cols, (n, n)), format="bsr")
    D = lt.opDiagonal(1.0 + torch.rand(n, generator=g, device=dev))
    A = D @ (B.T @ B) @ D + 2.0 * lt.opEye(n, dtype=torch.float32)
    H = lt.InverseLBFGSOperator(torch.float32, n, mem=8, device=dev)
    for _ in range(8):
        s = torch.randn(n, generator=g, device=dev)
        H.push(s, A * s)
    return A, H


def _per_iteration(loop_mod, solve):
    saved = loop_mod.BLOCK, loop_mod.CAPTURE
    loop_mod.BLOCK, loop_mod.CAPTURE = 1, False
    try:
        return solve()
    finally:
        loop_mod.BLOCK, loop_mod.CAPTURE = saved


@pytest.mark.parametrize("limit", ["bound", "free"])
def test_copies_that_do_not_fit_capture_in_place(dev, loop_mod, monkeypatch, limit):
    """Where the operators' copies exceed the bound (or the share of free
    memory a new set may take), none is allocated: the block reads the
    operators' tensors in place and copies only the state, keyed by the
    tensors' identity. A push replays copying the state alone; a fresh
    operator is a new signature (no replay at its first solve); every solve
    gives the per-iteration loop's bits."""
    if limit == "bound":
        monkeypatch.setattr(loop_mod, "MIRROR_SHARE", 0.0)
    else:
        monkeypatch.setattr(loop_mod, "_free_bytes", lambda device: 1 << 20)
    n = 8192
    _, cols = random_bsr(dev, n // 8, 8, 8, 128, n // 128, torch.float32, seed=59)
    A, H = fresh_slice1(dev, cols, 60)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(58), device=dev)

    def solve(A, H):
        x, k, _ = lt.cg(A, b, M=H, tol=1e-6, maxiter=300)
        st = dict(loop_mod.stats)
        x1, k1, _ = _per_iteration(loop_mod, lambda: lt.cg(A, b, M=H, tol=1e-6, maxiter=300))
        assert k == k1 and torch.equal(x, x1), (k, k1)
        return st

    state = sum(t.numel() * t.element_size() for t in H.state)
    solve(A, H)
    st = solve(A, H)
    assert st["captures"] == 1 and 0 < st["static_bytes"] <= 2 * state, st
    s = torch.randn(A.nrow, generator=torch.Generator(device=dev).manual_seed(60), device=dev)
    H.push(s, A * s)
    st = solve(A, H)
    assert st["path"] == "graph" and st["replays"] > 0 and st["captures"] == 0, st
    assert 0 < st["copied_bytes"] <= state, st
    A2, H2 = fresh_slice1(dev, cols, 61)
    before = lt.apply_cache_sizes()["signatures"]
    st = solve(A2, H2)
    assert st["replays"] == 0 and lt.apply_cache_sizes()["signatures"] > before, st
    st = solve(A2, H2)
    assert st["captures"] == 1, st


def test_blocks_of_one_operator_share_their_copies(dev, loop_mod):
    """``matvec_chain``'s N and T blocks over one operator read one set of
    copies: a fresh operator's N chain copies it in, the T chain after it
    copies nothing, and the kept copies are one operator's bytes. Two
    operators of one structure in turn copy all of theirs at every solve
    (one set per structure); every chain is the per-iteration loop's."""
    n = 8192
    _, cols = random_bsr(dev, n // 8, 8, 8, 128, n // 128, torch.float32, seed=63)
    (A, _), (A2, _) = fresh_slice1(dev, cols, 64), fresh_slice1(dev, cols, 65)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(66), device=dev)
    sig = loop_mod._walk_ops((A,))
    held = sum(sig.tensors[i].numel() * sig.tensors[i].element_size() for i in sig.mirrored)
    shared = {id(t) for t in loop_mod._walk_ops((A2,)).tensors}
    full = sum(sig.tensors[i].numel() * sig.tensors[i].element_size() for i in sig.mirrored
               if id(sig.tensors[i]) not in shared)  # all but the pattern the two share

    def chain(op, mode):
        y = lt.matvec_chain(op, b, 8, mode=mode)
        st = dict(loop_mod.stats)
        y1 = _per_iteration(loop_mod, lambda: lt.matvec_chain(op, b, 8, mode=mode))
        assert torch.equal(y, y1), mode
        return st

    for _ in range(2):
        for mode in ("N", "T"):
            chain(A, mode)
    assert loop_mod._held(loop_mod._CACHE) == held
    st = [chain(A2, "N"), chain(A2, "T")]
    assert st[0]["copied_bytes"] == full and st[1]["copied_bytes"] == 0, st
    for op in (A, A2, A):
        st = chain(op, "N")
        assert st["path"] == "graph" and st["copied_bytes"] == full, st
    assert loop_mod._held(loop_mod._CACHE) == held


def test_a_capture_failure_names_the_operator(dev, loop_mod):
    """A FunctionOperator declared ``capture_safe=True`` whose apply reads
    the host fails at its capture (the second solve) with an error that
    names it; the solve never falls back to the eager loop. The capture is
    ended cleanly: a capture after it succeeds and matches eager blocks.
    Undeclared, the same operator takes the per-iteration loop."""
    n = 512
    d = torch.linspace(1.0, 2.0, n, device=dev)

    def reads_host(v):
        return v * float(d[0]) + d * v  # float() reads the card

    F = lt.FunctionOperator(n, n, reads_host, symmetric=True, hermitian=True,
                            dtype=torch.float32, capture_safe=True)
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(35), device=dev)
    x_first, k_first, _ = lt.cg(F, b, tol=1e-7, maxiter=100)  # the plain loop
    with pytest.raises(RuntimeError, match="FunctionOperator"):
        lt.cg(F, b, tol=1e-7, maxiter=100)
    F_plain = lt.FunctionOperator(n, n, reads_host, symmetric=True, hermitian=True,
                                  dtype=torch.float32)
    x, k, _ = lt.cg(F_plain, b, tol=1e-7, maxiter=100)
    assert loop_mod.stats["path"] == "per_iteration" and k == k_first
    assert torch.equal(x, x_first)
    A, H, b1 = slice1_graph(dev, n=2048)
    loop_mod.clear_cache()
    for _ in range(3):
        x1, k1, _ = lt.cg(A, b1, M=H, tol=1e-6, maxiter=300)
    assert loop_mod.stats["path"] == "graph" and loop_mod.stats["replays"] > 0
    loop_mod.CAPTURE = False
    x_e, k_e, _ = lt.cg(A, b1, M=H, tol=1e-6, maxiter=300)
    assert k1 == k_e and torch.equal(x1, x_e)


# ---------------------------------------------------------------- slice 10: E1 and the spectral loops


def hermitian_batch(dev, m, dtype, batch=3, seed=40):
    g = torch.Generator(device=dev).manual_seed(seed + m)
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32
    A = torch.randn((batch, m, m), generator=g, device=dev, dtype=rdt)
    if dtype.is_complex:
        A = torch.complex(A, torch.randn((batch, m, m), generator=g, device=dev, dtype=rdt))
    return A


def eigh_errors(A, w, V):
    """(max |Δλ| against torch.linalg.eigh of A widened to f64/c128,
    ‖AV − VΛ‖₂, max|VᴴV − I|), the first two over ‖A‖₂, all over the eps of
    A's precision; A's lower triangle read."""
    wide = torch.complex128 if A.is_complex() else torch.float64
    eps = torch.finfo(w.dtype).eps
    Ah = A.to(wide).tril()
    Ah = Ah + Ah.tril(-1).mH
    if Ah.is_complex():
        Ah.diagonal(dim1=-2, dim2=-1).imag.zero_()
    w_ref = torch.linalg.eigh(A.to(wide))[0].double()
    norm2 = w_ref.abs().amax(-1).clamp_min(1e-300)
    Vw = V.to(wide)
    dl = ((w.double() - w_ref).abs().amax(-1) / norm2).max() / eps
    res = (torch.linalg.matrix_norm(Ah @ Vw - Vw * w.to(wide)[..., None, :], ord=2)
           / norm2).max() / eps
    eye = torch.eye(A.shape[-1], dtype=wide, device=A.device)
    orth = (Vw.mH @ Vw - eye).abs().max() / eps
    return float(dl), float(res), float(orth)


@pytest.mark.parametrize("m", [1, 2, 6, 24, 96, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_small_eigh_matches_torch_eigh(dev, dtype, m):
    A = hermitian_batch(dev, m, dtype)
    E1.reset_launch_counts()
    w, V, sweeps = E1.small_eigh(A, sweeps=True)
    torch.cuda.synchronize()
    which = E1._NAMES[E1._KERNELS.index(E1.kernel_for(m, dtype))]
    assert E1.launch_counts()[which] == 1 and sum(E1.launch_counts().values()) == 1
    assert w.shape == (3, m) and V.shape == (3, m, m) and V.dtype == dtype
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    assert int(sweeps.max()) < 30
    dl, res, orth = eigh_errors(A, w, V)
    assert dl <= 50 and res <= 50 and orth <= 50, (dl, res, orth)
    w2, V2 = E1.small_eigh(A)
    assert torch.equal(w, w2) and torch.equal(V, V2)  # the same bits on a rerun


@pytest.mark.parametrize("kernel", ["blocked", "cluster"])
@pytest.mark.parametrize("m", [24, 32, 33, 48, 64, 96, 128, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_small_eigh_blocked_kernel(dev, dtype, m, kernel):
    """The blocked and cluster kernels, named, on a batch of mixed matrices
    (random, diagonal, a repeated eigenvalue, zero): within 50 eps of eigh,
    ascending, the same bits on a rerun and for each matrix alone (the
    cluster kernel refuses c128 above m = 128, where its buffers pass the
    shared memory); m up to 24 goes to the Jacobi kernel, above it to the
    cluster kernel where it fits, else to the blocked one."""
    g = torch.Generator(device=dev).manual_seed(47 + m)
    A = hermitian_batch(dev, m, dtype, batch=4)
    A[1] = torch.diag(torch.randn(m, generator=g, device=dev).to(dtype))
    Q = torch.linalg.qr(hermitian_batch(dev, m, dtype, batch=1, seed=48)[0])[0]
    A[2] = (Q * (torch.arange(m, device=dev) // 2 + 1).to(Q.dtype)) @ Q.mH
    A[3] = 0
    fits = kernel == "blocked" or dtype != torch.complex128 or m <= 128
    assert E1.kernel_for(m, dtype) == ("jacobi" if m <= 24 else "cluster"
                                       if dtype != torch.complex128 or m <= 128 else "blocked")
    if not fits:
        with pytest.raises(ValueError, match="cannot take"):
            E1.small_eigh(A, _kernel=kernel)
        return
    E1.reset_launch_counts()
    w, V, sweeps = E1.small_eigh(A, sweeps=True, _kernel=kernel)
    torch.cuda.synchronize()
    name = "small_eigh_" + kernel
    assert E1.launch_counts() == {n: int(n == name) for n in E1._NAMES}
    assert bool((w[:, 1:] >= w[:, :-1]).all()) and int(sweeps.max()) < 30
    dl, res, orth = eigh_errors(A, w, V)
    assert dl <= 50 and res <= 50 and orth <= 50, (dl, res, orth)
    w2, V2 = E1.small_eigh(A, _kernel=kernel)
    assert torch.equal(w, w2) and torch.equal(V, V2)
    for i in range(4):
        wi, Vi = E1.small_eigh(A[i:i + 1], _kernel=kernel)
        assert torch.equal(wi[0], w[i]) and torch.equal(Vi[0], V[i])


def test_small_eigh_blocked_in_a_graph(dev):
    """The dispatch's kernel at m = 96 (the cluster kernel) inside a CUDA
    graph: a replay gives the eager bits with no host synchronisation; an
    infinite entry gives NaN out with no sweep."""
    A = hermitian_batch(dev, 96, torch.float32, batch=1)
    w_e, V_e = E1.small_eigh(A)
    static = A.clone()
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        w_g, V_g = E1.small_eigh(static)
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(w_g, w_e) and torch.equal(V_g, V_e)
    A[0, 50, 7] = float("inf")
    w, V, sw = E1.small_eigh(A, sweeps=True)
    torch.cuda.synchronize()
    assert torch.isnan(w).all() and torch.isnan(V).all() and int(sw[0]) == 0


def test_small_eigh_nan_input_ends(dev):
    """A NaN matrix ends without a sweep, NaN out; its batch's other
    matrices are solved as alone."""
    A = hermitian_batch(dev, 24, torch.float32, batch=2)
    A_nan = A.clone()
    A_nan[1, 5, 3] = float("nan")
    w, V, sweeps = E1.small_eigh(A_nan, sweeps=True)
    torch.cuda.synchronize()
    assert torch.isnan(w[1]).all() and torch.isnan(V[1]).all() and int(sweeps[1]) == 0
    w0, V0 = E1.small_eigh(A[:1])
    assert torch.equal(w[0], w0[0]) and torch.equal(V[0], V0[0])
    w, V = E1.small_eigh(torch.full((6, 6), float("nan"), device=dev, dtype=torch.complex128))
    torch.cuda.synchronize()
    assert torch.isnan(w).all()


def test_small_eigh_captures_in_a_graph(dev):
    """E1 inside a CUDA graph: a replay gives the eager bits, with no host
    synchronisation."""
    A = hermitian_batch(dev, 6, torch.float32, batch=1)
    w_e, V_e = E1.small_eigh(A)
    static = A.clone()
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        w_g, V_g = E1.small_eigh(static)
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(w_g, w_e) and torch.equal(V_g, V_e)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_small_eigh_gradient_matches_eigh(dev, dtype):
    """Under autograd E1 launches inside an autograd node whose backward is
    eigh's: the gradient of a gauge-invariant loss of (w, |V|²) matches
    ``torch.linalg.eigh``'s on the CPU within 1e-9, and the launch counts."""
    A = hermitian_batch(dev, 6, dtype, batch=2)
    A = 0.5 * (A + A.mH)
    g = torch.Generator(device="cpu").manual_seed(45)
    cw = torch.randn((2, 6), generator=g, dtype=torch.float64)
    cV = torch.randn((2, 6, 6), generator=g, dtype=torch.float64)

    def grad(eigh, A):
        A = A.clone().requires_grad_()
        w, V = eigh(A)
        loss = (cw.to(A.device) * w).sum() + (cV.to(A.device) * V.abs() ** 2).sum()
        return torch.autograd.grad(loss, A)[0]

    E1.reset_launch_counts()
    g_card = grad(E1.small_eigh, A).cpu()
    assert E1.launch_counts()["small_eigh"] == 1
    g_cpu = grad(torch.linalg.eigh, A.cpu())
    assert (g_card - g_cpu).abs().max() <= 1e-9 * g_cpu.abs().max()


@pytest.mark.parametrize("basis", ["gram", "direct"])
def test_lobpcg_replays_in_captured_blocks(dev, loop_mod, basis):
    """LOBPCG (k = 2, largest) on a 64² stencil: the signature's first
    solve (the plain loop), its second (it captures) and a cached one give
    the same count and θ, X bits; the cached block holds E1 and no host
    synchronisation (a replay under sync-debug error). svds and normest of a
    BSR operator replay too."""
    S = lt.laplacian_2d(64, 64, device=dev)
    gen = torch.Generator(device=dev)

    def solve():
        gen.manual_seed(41)
        return lt.lobpcg(S, k=2, largest=True, tol=1e-5, maxiter=200, generator=gen,
                         basis=basis)

    runs = []
    for _ in range(3):
        th, X, res, it = solve()
        runs.append((th, X, it, dict(loop_mod.stats)))
    th0, X0, it0, st0 = runs[0]
    assert st0["path"] == "per_iteration" and 4 < it0 < 200
    for th, X, it, _ in runs[1:]:
        assert it == it0 and torch.equal(th, th0) and torch.equal(X, X0)
    assert runs[1][3]["captures"] == 1
    st = runs[2][3]
    assert st["path"] == "graph" and st["captures"] == 0 and st["reads"] == -(-it0 // 4)
    g = loop_mod.last_graph()
    per_iteration = 4 if basis == "gram" else 3  # SVQB of X (gram only), W and P; one RR
    assert g.launches.get("small_eigh", 0) == per_iteration * loop_mod.BLOCK
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    B = lt.BSROperator(lt.BSR(*random_bsr(dev, 64, 4, 8, 128, 4, torch.float32, seed=42),
                              (512, 512)))
    for fn in (lambda: lt.svds(B, k=2, tol=1e-4, maxiter=100,
                               generator=torch.Generator(device=dev).manual_seed(43))[:2],
               lambda: lt.normest(B, tol=1e-6, maxiter=200,
                                  generator=torch.Generator(device=dev).manual_seed(44))):
        outs = [fn() for _ in range(3)]
        assert loop_mod.stats["path"] == "graph" and loop_mod.stats["captures"] == 0
        for o in outs[1:]:
            assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                       for a, b in zip(o, outs[0]))


# --------------------------------------------------------------------------
# Slice 12: sharded and nested solves in captured blocks
# --------------------------------------------------------------------------


def graph_nodes(graph_ptr) -> dict:
    """A CUDA graph's nodes by type (``CUgraphNodeType``: 0 kernel, 13
    conditional), read through the driver API."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(vp(graph_ptr), None, ctypes.byref(count)) == 0
    nodes = (vp * count.value)()
    assert cu.cuGraphGetNodes(vp(graph_ptr), nodes, ctypes.byref(count)) == 0
    kinds = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)) == 0
        kinds[kind.value] = kinds.get(kind.value, 0) + 1
    return kinds


def test_sharded_cg_in_captured_blocks_at_world_size_one(dev, loop_mod):
    """Slice 1's preconditioned CG over ``shard_operator`` at world size 1
    (NCCL) runs in captured blocks: its count and x bit for bit the sharded
    per-iteration loop's (and the unsharded solve's), reads ⌈I/4⌉ on a
    cached solve, and a replay under sync-debug "error" raises nothing."""
    from linops_tpu_torch.parallel import row_sharding, shard_operator
    from linops_tpu_torch.parallel.comm import gather_full

    mesh = _world_of_one()
    A, H, b = slice1_graph(dev)
    A_sh, H_sh, b_sh = shard_operator(A, mesh), shard_operator(H, mesh), row_sharding(mesh).place(b)
    solve = lambda: lt.cg(A_sh, b_sh, M=H_sh, tol=1e-5, maxiter=300)  # noqa: E731
    runs = solve_modes(loop_mod, solve)
    x0, k0, _ = runs["per_iteration"]
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(gather_full(x), gather_full(x0)), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["captures"] == 0
    assert st["reads"] == -(-k0 // loop_mod.BLOCK)
    x_un, k_un, _ = lt.cg(A, b, M=H, tol=1e-5, maxiter=300)
    assert k_un == k0 and torch.equal(x_un, gather_full(x0))
    g = loop_mod.last_graph()
    assert g.launches.get("bsr_matvec", 0) > 0 and g.launches.get("bsr_rmatvec", 0) > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_sharded_gmres_in_captured_blocks_at_world_size_one(dev, loop_mod):
    """GMRES(8) over ``shard_operator`` at world size 1 (NCCL; a plain b,
    placed in the operator's layout, so x comes back split by rows) runs in
    captured blocks of one restart: its count and x bit for bit the
    per-iteration loop's and the unsharded solve's, one read per restart on
    a cached solve, E2 in the block."""
    from linops_tpu_torch.parallel import shard_operator
    from linops_tpu_torch.parallel.comm import gather_full, is_dtensor

    mesh = _world_of_one()
    A, _, b = slice1_graph(dev)
    A_sh = shard_operator(A, mesh)
    runs = solve_modes(loop_mod, lambda: lt.gmres(A_sh, b, tol=1e-5, restart=8, maxiter=30))
    x0, k0, _ = runs["per_iteration"]
    assert is_dtensor(x0) and any(p.is_shard() for p in x0.placements)
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(gather_full(x), gather_full(x0)), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["captures"] == 0 and st["reads"] == k0
    assert loop_mod.last_graph().launches.get("small_lstsq", 0) == 1
    x_un, k_un, _ = lt.gmres(A, b, tol=1e-5, restart=8, maxiter=30)
    assert k_un == k0 and torch.equal(x_un, gather_full(x0))


def test_gmres_on_dtensor_vectors_in_captured_blocks_at_world_size_one(dev, loop_mod):
    """GMRES(8) over ``shard_operator`` at world size 1 (NCCL) on DTensor
    vectors, its basis kept as this rank's rows: x in b's placement, its
    count and x bit for bit the per-iteration loop's, the plain-vector
    solve's and the unsharded solve's; one read per restart on a cached
    solve; E2 in the block; the plain-vector solve (its b placed in the
    operator's layout) replays the DTensor solve's block; a replay under
    sync-debug "error" raises nothing."""
    from linops_tpu_torch.parallel import row_sharding, shard_operator
    from linops_tpu_torch.parallel.comm import gather_full, is_dtensor

    mesh = _world_of_one()
    A, _, b = slice1_graph(dev)
    A_sh, b_sh = shard_operator(A, mesh), row_sharding(mesh).place(b)
    runs = solve_modes(loop_mod, lambda: lt.gmres(A_sh, b_sh, tol=1e-5, restart=8, maxiter=30))
    x0, k0, _ = runs["per_iteration"]
    assert is_dtensor(x0) and tuple(x0.placements) == tuple(b_sh.placements)
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(gather_full(x), gather_full(x0)), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["captures"] == 0 and st["reads"] == k0
    g = loop_mod.last_graph()
    assert g.launches.get("small_lstsq", 0) == 1
    blocks = len(loop_mod._DIST_CACHE)
    x_p, k_p, _ = lt.gmres(A_sh, b, tol=1e-5, restart=8, maxiter=30)  # plain b: the same key
    assert len(loop_mod._DIST_CACHE) == blocks and loop_mod.last_graph() is g
    assert loop_mod.stats["captures"] == 0 and loop_mod.stats["replays"] > 0
    x_un, k_un, _ = lt.gmres(A, b, tol=1e-5, restart=8, maxiter=30)
    assert k_p == k_un == k0 and torch.equal(gather_full(x_p), gather_full(x0))
    assert torch.equal(x_un, gather_full(x0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_sharded_lobpcg_in_captured_blocks_at_world_size_one(dev, loop_mod):
    """LOBPCG (k = 2, largest, tol 0, 12 iterations) over ``shard_operator``
    of the 2-D Laplacian at world size 1 (NCCL), its blocks this rank's
    rows: θ replicated and X split by rows, θ and X bit for bit the
    per-iteration loop's and the unsharded solve's in every mode, a cached
    solve replaying with the unsharded cached solve's reads, E1 in its
    block."""
    from linops_tpu_torch.parallel import shard_operator
    from linops_tpu_torch.parallel.comm import gather_full, is_dtensor

    mesh = _world_of_one()
    S = lt.laplacian_2d(256, 256, device=dev)
    S_sh = shard_operator(S, mesh)
    gen = torch.Generator(device=dev)

    def lob(op):
        gen.manual_seed(21)
        th, X, res, it = lt.lobpcg(op, k=2, largest=True, tol=0.0, maxiter=12, generator=gen)
        return (th, X), it, res

    runs = solve_modes(loop_mod, lambda: lob(S_sh))
    (th0, X0), k0, _ = runs["per_iteration"]
    assert is_dtensor(X0) and any(p.is_shard() for p in X0.placements)
    assert is_dtensor(th0) and all(p.is_replicate() for p in th0.placements)
    for name, ((th, X), k, _) in runs.items():
        assert k == k0 == 12, name
        assert torch.equal(gather_full(th), gather_full(th0)), name
        assert torch.equal(gather_full(X), gather_full(X0)), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["captures"] == 0
    assert loop_mod.last_graph().launches.get("small_eigh", 0) > 0
    un = solve_modes(loop_mod, lambda: lob(S))
    (th_un, X_un), k_un, st_un = un["cached"]
    assert k_un == k0 and st["reads"] == st_un["reads"]
    assert torch.equal(th_un, gather_full(th0)) and torch.equal(X_un, gather_full(X0))


@pytest.mark.parametrize("k", [2, 32])
def test_halo_block_applies_match_their_column_loops(dev, k):
    """The halo operators' block applies at world size 1 (NCCL), N and T,
    column and row panels: the 2-D stencil's (2048², a non-symmetric
    5-point stencil) bit for bit its column loop of vector applies in f32;
    the banded operator's (n = 4096, half-bandwidth 3) within 1e-6 of it (a
    dense product may reduce in another order than the vector's)."""
    from linops_tpu_torch.parallel import banded_partition, make_mesh2d, stencil_partition_2d
    from linops_tpu_torch.parallel.comm import gather_full

    mesh = _world_of_one()
    gen = torch.Generator(device=dev).manual_seed(k)
    g = 2048
    L2 = stencil_partition_2d(torch.tensor([4.0, -1.0, -1.5, -0.5, -1.0], device=dev), g, g,
                              make_mesh2d(1, 1))
    rng = np.random.default_rng(k)
    n = 4096
    A = sum(np.diag(rng.uniform(-1.0, 1.0, n - abs(o)), o) for o in range(-3, 4))
    hop = banded_partition(A.astype(np.float32), mesh)
    for op, exact in ((L2, True), (hop, False)):
        M = torch.randn((op.shape[0], k), generator=gen, device=dev)
        for mode in ("N", "T"):
            cols = torch.stack([gather_full(op.apply(M[:, j], mode)) for j in range(k)], dim=1)
            for Y in (gather_full(op.apply_matrix(M, mode)),
                      gather_full(op.apply_matrix_t(M.T.contiguous(), mode)).T):
                if exact:
                    assert torch.equal(Y, cols), (op, mode)
                else:
                    assert rel_err(Y, cols) <= 1e-6, (op, mode, rel_err(Y, cols))


def test_dtensor_push_then_captured_solve_at_world_size_one(dev, loop_mod):
    """Pushes of DTensor pairs into a sharded inverse L-BFGS preconditioner
    between captured CG solves at world size 1: the state keeps its
    placements, every solve after the capture replays (no new capture) and
    its x is bit for bit the per-iteration loop's after the same pushes."""
    from linops_tpu_torch.parallel import row_sharding, shard_operator
    from linops_tpu_torch.parallel.comm import gather_full

    mesh = _world_of_one()
    place = row_sharding(mesh).place
    A, H, b = slice1_graph(dev)
    A_sh, H_sh, b_sh = shard_operator(A, mesh), shard_operator(H, mesh), place(b)
    before = [str(getattr(t, "placements", None)) for t in H_sh.state]
    solve = lambda: lt.cg(A_sh, b_sh, M=H_sh, tol=1e-5, maxiter=300)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(77)
    loop_mod.clear_cache()
    solve()
    solve()  # captures
    for step in range(3):
        s_ = torch.randn(A.shape[0], generator=gen, device=dev)
        H_sh.push(place(s_), place(A * s_))
        assert [str(getattr(t, "placements", None)) for t in H_sh.state] == before
        x, k, _ = solve()
        assert loop_mod.stats["path"] == "graph" and loop_mod.stats["captures"] == 0, step
        saved = loop_mod.BLOCK, loop_mod.CAPTURE
        loop_mod.BLOCK, loop_mod.CAPTURE = 1, False
        try:
            x1, k1, _ = solve()
        finally:
            loop_mod.BLOCK, loop_mod.CAPTURE = saved
        assert k == k1 and torch.equal(gather_full(x), gather_full(x1)), step


@pytest.mark.parametrize("inner", ["cg", "minres"])
def test_nested_solve_is_a_while_node(dev, loop_mod, inner):
    """CG preconditioned by ``opIterativeInverse`` (an inner ``inner``
    solve over slice 1's graph): the captured block holds one conditional
    WHILE node per outer iteration, each body holding K1/K2 and the
    condition kernel; the outer count, the summed inner iterations and x are
    bit for bit the per-iteration loop's; a cached solve reads ⌈I/4⌉."""
    from linops_tpu_torch.kernels import graph_cond

    A, _, b = slice1_graph(dev, n=4096)
    M = lt.opIterativeInverse(A, tol=1e-2, maxiter=40, solver=inner)
    assert M.capture_safe

    def solve():
        M.reset_inner_iterations()
        x, k, r = lt.cg(A, b, M=M, tol=1e-5, maxiter=100)
        return x, (k, M.inner_iterations), r

    solve()
    runs = solve_modes(loop_mod, solve)
    x0, k0, _ = runs["per_iteration"]
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(x, x0), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["reads"] == -(-k0[0] // loop_mod.BLOCK)
    assert runs["capture"][2]["while_nodes"] == loop_mod.BLOCK
    g = loop_mod.last_graph()
    assert graph_nodes(g.graph.raw_cuda_graph()).get(13, 0) == loop_mod.BLOCK
    assert len(g.bodies) == loop_mod.BLOCK
    assert g.launches.get("while_condition", 0) == 2 * loop_mod.BLOCK
    assert all(graph_nodes(body).get(0, 0) > 0 for body in g.bodies)
    assert g.launches.get("bsr_matvec", 0) > 0
    graph_cond.reset_launch_counts()
    solve()
    assert graph_cond.launch_counts()["while_condition"] == 0  # a replay launches nothing


def test_while_node_condition_kernel_against_plain(dev, loop_mod):
    """The condition kernel in a while node counts a loop to the end its
    test sets, and not at all when started in a frozen outer iteration (the
    loop ANDs the outer mask into the test it hands the kernel): the plain
    version's count on the same inputs."""
    for limit, outer in ((7, True), (0, True), (5, False)):
        def cond(s, c):
            return s[0] < c[0]

        def body(s, c, k):
            return (s[0] + 1,)

        lim = torch.tensor(limit, device=dev)
        start = (torch.zeros((), dtype=torch.int64, device=dev),)
        want = limit if outer else 0
        mask = torch.tensor(outer, device=dev)  # made before the capture: a copy from the host

        def block(*bufs):
            loop_mod._OUTER.append(mask)
            try:
                (s,), k = loop_mod.device_while(cond, body, bufs[:1], 50, consts=bufs[1:])
            finally:
                loop_mod._OUTER.pop()
            return (s, k)

        g = loop_mod._Graph(block, start + (lim,), (), "test")
        s, k = g.run()
        torch.cuda.synchronize()
        assert int(s) == int(k) == want


def test_capture_failure_inside_a_while_body_names_the_operator(dev, loop_mod):
    """An inner operator that reads the host only inside a while node's body
    fails that capture, and the error names it; the card recovers."""
    from linops_tpu_torch.kernels import graph_cond

    A, _, b = slice1_graph(dev, n=4096)

    def prod(v):
        if graph_cond.open_bodies():
            float(v.sum())  # a host read, inside the body only
        return A @ v

    bad = lt.FunctionOperator(A.nrow, A.ncol, prod, dtype=torch.float32, symmetric=True,
                              hermitian=True, capture_safe=True)
    M = lt.opIterativeInverse(bad, tol=1e-2, maxiter=40, solver="cg")
    lt.cg(A, b, M=M, tol=1e-5, maxiter=50)  # the signature's first solve: the plain loop
    with pytest.raises(RuntimeError, match="while node.*FunctionOperator"):
        lt.cg(A, b, M=M, tol=1e-5, maxiter=50)
    x, k, _ = lt.cg(A, b, tol=1e-5, maxiter=50)
    assert k > 0 and torch.isfinite(x).all()


def lstsq_batch(dev, m, dtype, seed=140):
    """(m + 1) x m Hessenbergs and β e₁ on the card: two random, one of a
    lucky breakdown at step m // 2 (its later columns zero), one zero."""
    g = torch.Generator(device=dev).manual_seed(seed + m)
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32
    H = torch.randn((4, m + 1, m), generator=g, device=dev, dtype=rdt)
    if dtype.is_complex:
        H = torch.complex(H, torch.randn((4, m + 1, m), generator=g, device=dev, dtype=rdt))
    H = torch.triu(H, -1)
    H[2, :, m // 2 + 1:] = 0
    H[3] = 0
    b = torch.zeros((4, m + 1), device=dev, dtype=dtype)
    b[:, 0] = torch.rand(4, generator=g, device=dev) + 0.5
    return H.to(dtype), b


def lstsq_residuals(H, b, y):
    wide = torch.complex128 if H.is_complex() else torch.float64
    return torch.linalg.vector_norm(
        (H.to(wide) @ y.to(wide).unsqueeze(-1)).squeeze(-1) - b.to(wide), dim=-1)


@pytest.mark.parametrize("m", [1, 2, 8, 30, 64, 120, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_small_lstsq_matches_plain(dev, dtype, m):
    H, b = lstsq_batch(dev, m, dtype)
    E2.reset_launch_counts()
    y, s, sweeps = E2.small_lstsq(H, b, full=True)
    torch.cuda.synchronize()
    assert E2.launch_counts()["small_lstsq"] == 1
    assert y.shape == (4, m) and y.dtype == dtype and s.shape == (4, m)
    assert int(sweeps.max()) < 30
    eps = torch.finfo(s.dtype).eps
    y_p = E2.small_lstsq_plain(H, b)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    s_w = torch.linalg.svdvals(H.to(wide).cpu()).to(dev)  # LAPACK: cuSOLVER's is looser
    bn = torch.linalg.vector_norm(b.to(wide), dim=-1)
    assert bool((lstsq_residuals(H, b, y) <= lstsq_residuals(H, b, y_p) + 50 * eps * bn).all())
    # each column takes sweeps·(m − 1) rotations, whose roundings add up as a
    # random walk: random Hessenbergs reach κ = 1e17 at m = 128
    tol_s = max(50.0, 4.0 * (int(sweeps.max()) * m) ** 0.5) * eps
    assert float((s.double() - s_w).abs().max()) <= tol_s * float(s_w.max())
    assert not y[2, m // 2 + 1:].any() and not y[3].any() and not s[3].any()
    y2 = E2.small_lstsq(H, b)
    y3 = E2.small_lstsq(H[1:2], b[1:2])
    assert torch.equal(y, y2) and torch.equal(y[1], y3[0])


@pytest.mark.parametrize("dtype,last", [(torch.float32, 168), (torch.complex64, 119),
                                        (torch.float64, 119), (torch.complex128, 84)])
def test_small_lstsq_shared_memory_edge(dev, dtype, last):
    """GMRES's (m + 1) x m problem stays in shared memory to m = 168 in f32
    (no V), 119 in c64 and f64 (V kept for f64), 84 in c128; one column
    more takes the global workspace, and both meet the contract there."""
    assert E2.workspace_bytes(last + 1, last, dtype) == 0
    assert E2.workspace_bytes(last + 2, last + 1, dtype) > 0
    for m in (last, last + 1):
        H, b = lstsq_batch(dev, m, dtype)
        y, s, _ = E2.small_lstsq(H, b, full=True)
        eps = torch.finfo(s.dtype).eps
        wide = torch.complex128 if dtype.is_complex else torch.float64
        bn = torch.linalg.vector_norm(b.to(wide), dim=-1)
        y_p = E2.small_lstsq_plain(H, b)
        assert bool((lstsq_residuals(H, b, y) <= lstsq_residuals(H, b, y_p) + 50 * eps * bn).all())
        assert not y[2, m // 2 + 1:].any() and not y[3].any() and not s[3].any()


def test_small_lstsq_in_a_graph_and_under_vmap(dev):
    """A replay in a CUDA graph and a vmap over the batch give the eager
    bits; the replay makes no host synchronisation; vmap launches once."""
    H, b = lstsq_batch(dev, 30, torch.float32)
    y_e = E2.small_lstsq(H, b)
    Hs, bs = H.clone(), b.clone()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        y_g = E2.small_lstsq(Hs, bs)
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(y_g, y_e)
    E2.reset_launch_counts()
    y_v = torch.func.vmap(E2.small_lstsq)(H, b)
    assert torch.equal(y_v, y_e) and E2.launch_counts()["small_lstsq"] == 1


def test_gmres_in_captured_blocks(dev, loop_mod):
    """GMRES(8) on slice 1's graph plus a dense nonsymmetric part: every
    loop gives the per-iteration loop's restarts and bits, a cached solve
    reads once per restart and replays a block holding E2, with no sync in
    a replay."""
    A, _, b = slice1_graph(dev, n=4096)
    g = torch.Generator(device=dev).manual_seed(141)
    S = A + lt.MatrixOperator(torch.randn((4096, 4096), generator=g, device=dev) / 64.0)

    def solve():
        return lt.gmres(S, b, tol=1e-5, restart=8, maxiter=30)

    runs = solve_modes(loop_mod, solve)
    x0, k0, _ = runs["per_iteration"]
    assert 1 < k0 < 30
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(x, x0), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["reads"] == k0 and runs["capture"][2]["captures"] == 1
    gr = loop_mod.last_graph()
    assert gr.launches.get("small_lstsq", 0) == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gr.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_nested_gmres_is_a_while_node(dev, loop_mod):
    """CG preconditioned by ``opIterativeInverse(solver="gmres")`` over
    slice 1's graph: one while node per outer iteration, its body one
    restart with E2; the outer count, summed inner restarts and x bit for
    bit the per-iteration loop's; a cached solve reads ⌈I/4⌉."""
    A, _, b = slice1_graph(dev, n=4096)
    M = lt.opIterativeInverse(A, tol=1e-2, maxiter=30, solver="gmres")
    assert M.capture_safe

    def solve():
        M.reset_inner_iterations()
        x, k, r = lt.cg(A, b, M=M, tol=1e-5, maxiter=100)
        return x, (k, M.inner_iterations), r

    solve()
    runs = solve_modes(loop_mod, solve)
    x0, k0, _ = runs["per_iteration"]
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(x, x0), name
    st = runs["cached"][2]
    assert st["path"] == "graph" and st["reads"] == -(-k0[0] // loop_mod.BLOCK)
    g = loop_mod.last_graph()
    assert graph_nodes(g.graph.raw_cuda_graph()).get(13, 0) == loop_mod.BLOCK
    assert g.launches.get("small_lstsq", 0) == loop_mod.BLOCK
    assert g.launches.get("while_condition", 0) == 2 * loop_mod.BLOCK


# --------------------------------------------------------------------------
# opIterativeInverse's block apply as one panel solve
# --------------------------------------------------------------------------


@pytest.mark.parametrize("inner", ["cg", "gmres"])
def test_block_inverse_in_a_captured_solve_is_one_while_node(dev, loop_mod, inner):
    """A 4-RHS CG preconditioned by ``opIterativeInverse`` (its M applies
    are block applies): the captured block holds one while node per outer
    iteration for the 4 columns, not 4; the outer count, the summed inner
    iterations and X bit for bit the per-iteration loop's."""
    A, _, _ = slice1_graph(dev, n=4096)
    B = torch.randn((4096, 4), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    M = lt.opIterativeInverse(A, tol=1e-2, maxiter=30, solver=inner)

    def solve():
        M.reset_inner_iterations()
        X, k, r = lt.cg(A, B, M=M, tol=1e-5, maxiter=100)
        return X, (k, M.inner_iterations), r

    solve()
    runs = solve_modes(loop_mod, solve)
    x0, k0, _ = runs["per_iteration"]
    for name, (x, k, _) in runs.items():
        assert k == k0 and torch.equal(x, x0), name
    assert runs["capture"][2]["while_nodes"] == loop_mod.BLOCK
    g = loop_mod.last_graph()
    assert graph_nodes(g.graph.raw_cuda_graph()).get(13, 0) == loop_mod.BLOCK
    assert len(g.bodies) == loop_mod.BLOCK
    assert g.launches.get("while_condition", 0) == 2 * loop_mod.BLOCK
    if inner == "gmres":  # one restart a body, its 4 Hessenbergs in one E2 launch
        assert g.launches.get("small_lstsq", 0) == loop_mod.BLOCK


def test_gmres_panel_launches_e2_once_per_restart(dev, loop_mod):
    """A GMRES inverse's block apply of 5 columns (restarts of 30): one E2
    launch per restart of the panel, where the column loop launches one per
    column and restart; each column within 1e-5 of its vector apply with the
    same restarts; the cached block (one restart) records one E2 launch."""
    n = 3000
    g = torch.Generator(device=dev).manual_seed(9)
    Ad = torch.randn((n, n), generator=g, device=dev) / n ** 0.5 + 1.2 * torch.eye(n, device=dev)
    M = lt.opIterativeInverse(lt.LinearOperator(Ad), tol=1e-5, maxiter=150, solver="gmres")
    Bk = torch.randn((n, 5), generator=g, device=dev)
    loop_mod.CAPTURE = False  # eager blocks: every launch counted
    E2.reset_launch_counts()
    X, counts, _ = M._solve(Bk, "N", False)
    panel = E2.launch_counts()["small_lstsq"]
    vec = [M.solve_info(Bk[:, j]) for j in range(5)]
    assert counts.tolist() == [int(v[1]) for v in vec] and int(counts.max()) > 1
    assert panel == int(counts.max())
    assert E2.launch_counts()["small_lstsq"] - panel == int(counts.sum())
    assert rel_err(X, torch.stack([v[0] for v in vec], dim=1)) <= 1e-5
    loop_mod.CAPTURE = True
    loop_mod.clear_cache()
    M._solve(Bk, "N", False)  # the signature's first solve: the plain loop
    for _ in range(2):  # the capture, then a replay
        Y = M.apply_matrix(Bk)
    assert loop_mod.stats["replays"] > 0 and loop_mod.last_graph().launches["small_lstsq"] == 1
    assert torch.equal(Y, X)


# --------------------------------------------------------------------------
# The BSR operators' block transposes: K2p, K4p, K6p
# --------------------------------------------------------------------------

PANEL_KS = (1, 8, 33)


def column_loop(vector_apply, U):
    """The vector kernel on each column of U, stacked: what a panel kernel
    must equal bit for bit."""
    return torch.stack([vector_apply(U[:, j].contiguous()) for j in range(U.shape[1])], dim=1)


def check_panel(panel, plain, vector_apply, rows: int, vdt, dev):
    """A panel wrapper at k = 1, 8, 33: within tol of its plain version, the
    same bits on a rerun, bit for bit its vector kernel's column loop, and
    the same bits for a row panel's transposed view, which the result
    takes as its layout (rows of a row-major (k, n))."""
    tol = 1e-5 if vdt == torch.float32 else 1e-2
    for k in PANEL_KS:
        U = torch.randn((rows, k), device=dev).to(vdt)
        P = panel(U)
        torch.cuda.synchronize()
        assert P.dtype == vdt and P.shape[1] == k
        assert rel_err(P, plain(U)) <= tol, k
        assert torch.equal(P, panel(U)), k
        assert torch.equal(P, column_loop(vector_apply, U)), k
        Pr = panel(U.t().contiguous().t())
        assert Pr.t().is_contiguous() and torch.equal(Pr, P), k


@pytest.mark.parametrize("dims", [(40, 3, 8, 128, 7), (6, 4, 128, 128, 3), (33, 5, 16, 16, 40),
                                  (64, 8, 9, 33, 20)])
@pytest.mark.parametrize("dtypes", PAIRS)
def test_k2p_matches_plain_and_its_column_loop(dev, dims, dtypes):
    nbrow, kmax, bm, bn, nbcol = dims
    bdt, vdt = dtypes
    blocks, cols = random_bsr(dev, nbrow, kmax, bm, bn, nbcol, bdt)
    check_panel(lambda U: K.bsr_rmatmat_kernel(blocks, cols, U, nbcol),
                lambda U: K.bsr_rmatmat_plain(blocks, cols, U, nbcol),
                lambda u: K.bsr_rmatvec_kernel(blocks, cols, u.reshape(nbrow, bm), nbcol)
                .reshape(-1), nbrow * bm, vdt, dev)


@pytest.mark.parametrize("dims", WINDOW_DIMS)
@pytest.mark.parametrize("dtypes", PAIRS)
def test_k4p_k6p_match_plain_and_their_column_loops(dev, dims, dtypes):
    nbrow, _, bm, _ = dims
    bdt, vdt = dtypes
    blocks, cols, nbcol = window_case(dims, multi=False)
    q, cl, wb, xpb = K.bsr_window_plan(cols, 32, nbcol, wb_max=64, blocks=blocks)
    b = torch.from_numpy(blocks).to(dev, bdt)
    cl_t, q_t = (torch.from_numpy(a).to(dev) for a in (cl, q))
    win = dict(wb=wb, x_pad_blocks=xpb, nbcol=nbcol)
    check_panel(lambda U: K.bsr_rmatmat_windowed_kernel(b, cl_t, q_t, U, **win),
                lambda U: K.bsr_rmatmat_windowed_plain(b, cl_t, q_t, U, **win),
                lambda u: K.bsr_rmatvec_windowed_kernel(b, cl_t, q_t, u.reshape(nbrow, bm), **win)
                .reshape(-1), nbrow * bm, vdt, dev)
    blocks, cols, nbcol = window_case(dims, multi=True)
    qm, wb, _ = K.bsr_window_plan_multi(cols, 32, nbcol, wb_max=16, blocks=blocks)
    qt, vt, xpbt = K.bsr_window_plan_multi_t(cols, 32, nbcol, wb, 4, blocks=blocks)
    b = torch.from_numpy(blocks).to(dev, bdt)
    t_args = tuple(torch.from_numpy(a).to(dev) for a in (cols, qt, vt))
    win = dict(wb=wb, x_pad_blocks=xpbt, nbcol=nbcol)
    check_panel(lambda U: K.bsr_rmatmat_multiwin_kernel(b, *t_args, U, **win),
                lambda U: K.bsr_rmatmat_multiwin_plain(b, *t_args, U, **win),
                lambda u: K.bsr_rmatvec_multiwin_kernel(b, *t_args, u.reshape(nbrow, bm), **win)
                .reshape(-1), nbrow * bm, vdt, dev)


def test_block_transposes_launch_once_and_capture(dev):
    """A T block, an H row panel and an adjoint's N block of a BSR operator
    on the card launch K2p once each and K2 never, bit for bit the column
    loop; K2p recorded in a CUDA graph replays the eager bits."""
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((300, 320)) * (rng.random((300, 320)) < 0.1)).astype(np.float32)
    op = lt.BSROperator(lt.bsr_from_dense(A, (8, 64)))
    M = torch.randn((300, 6), device=dev)
    K.reset_launch_counts()
    Y = op.apply_matrix(M, "T")
    assert torch.equal(op.apply_matrix_t(M.t().contiguous(), "H"), Y.t())
    assert torch.equal(op.T.apply_matrix(M, "N"), Y)
    counts = K.launch_counts()
    assert counts["bsr_rmatmat"] == 3 and counts["bsr_rmatvec"] == 0
    assert torch.equal(Y, column_loop(lambda m: op.apply(m, "T"), M))
    assert rel_err(Y, torch.from_numpy(A).to(dev).double().T @ M.double()) <= 1e-5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op.apply_matrix(M, "T")
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        Yg = op.apply_matrix(M, "T")
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(Yg, Y)


def test_block_transpose_raises_rather_than_falls_back(dev, monkeypatch):
    """A T block whose panel kernel cannot launch (more column tiles than a
    grid takes) raises from the operator; so does a launch the library
    refuses; neither runs the column loop or the plain version."""
    op = lt.BSROperator(lt.BSR(torch.ones((1, 1, 1, 1), device=dev),
                               torch.zeros((1, 1), dtype=torch.int32, device=dev), (1, 1)))
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="bsr_rmatmat kernel launch failed"):
        op.apply_matrix(torch.ones((1, 8 * 65536), device=dev), "T")
    assert K.launch_counts()["bsr_rmatvec"] == 0

    lib = K._lib()

    class Refusing:
        def __getattr__(self, name):
            if name == "linops_bsr_rmatmat":
                return lambda *a: 1  # cudaErrorInvalidValue
            return getattr(lib, name)

    monkeypatch.setattr(K, "_lib", lambda: Refusing())
    with pytest.raises(RuntimeError, match="bsr_rmatmat kernel launch failed"):
        op.apply_matrix(torch.ones((1, 3), device=dev), "T")
    monkeypatch.setattr(K, "_lib", lambda: lib)
    assert K.launch_counts()["bsr_rmatvec"] == 0 and K.launch_counts()["bsr_rmatmat"] == 0
