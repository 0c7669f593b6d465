"""Parity of the port's large-x BSR path (window plans, K3-K6's plain
versions, the windowed ``BSROperator``) with the JAX reference, on the CPU.

- Planners: identical arrays to the reference planners for the same
  (block_cols, R, nbcol, wb_max, blocks), with both packages'
  ``BSR_PALLAS_MAX_WINDOW_BLOCKS`` set to one value.
- Kernel level, f32: the plain K3-K6 (what a CPU tensor runs) against the
  Pallas kernels in interpret mode on the same plan arrays; max|Δ| ≤
  1e-5·max|ref| (f32 accumulation in different orders). bf16 blocks: the port
  accumulates in f32 where the reference's transposes accumulate across
  groups in bf16, so both are held to an f32 oracle of the same bf16 values:
  1e-5 for an f32 result, 1e-2 for a bf16 result (bf16 rounding, 2^-8).
- Operator level: the windowed operator cases of ``tests/test_sparse.py``
  mirrored, ``BSR_PALLAS_MAX_X_ELEMS`` (and where that test shrinks them the
  window cap and the row-group tile) patched in both packages. Both
  operators carry the same plan. N/T/H applies agree to 1e-10·max|ref| in
  f64 (the reference's f64 applies take its XLA path) and to 3e-6·max|ref|
  in f32 (its interpret-mode window kernels).
- K5's lane rows and K4's slot index, emulated in numpy as the CUDA
  kernels use them (staged windows; partials per group, then a combine over
  the contiguous run of groups found by binary search), give the plain
  versions' products; K6's column plan, walked in its kernel's order as
  ``tests/test_torch_bsr.py`` walks K2's, gives the plain and the Pallas
  K6's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu.kernels.bsr_spmv as BK
import linops_tpu_torch as lt
from linops_tpu.sparse.formats import BSR as JBSR
from linops_tpu.sparse.ops import BSROperator as JBSROperator
from linops_tpu_torch.convert import bsr_operator_from_reference, from_numpy, to_numpy
from linops_tpu_torch.kernels import bsr_spmv as K


def rel_err(got, ref) -> float:
    got = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture
def caps(monkeypatch):
    """Set the planning caps of both packages to the same values."""
    def set_caps(x_elems=2048, window_blocks=None, tile=None):
        wb = K.BSR_PALLAS_MAX_WINDOW_BLOCKS if window_blocks is None else window_blocks
        for mod in (BK, K):
            monkeypatch.setattr(mod, "BSR_PALLAS_MAX_X_ELEMS", x_elems)
            monkeypatch.setattr(mod, "BSR_PALLAS_MAX_WINDOW_BLOCKS", wb)
            if tile is not None:
                monkeypatch.setattr(mod, "_TILE_BYTES_TARGET", tile)
    return set_caps


def both_ops(blocks, cols, shape, dtype=np.float32):
    op_j = JBSROperator(JBSR(blocks=jnp.asarray(blocks.astype(dtype)), block_cols=jnp.asarray(cols),
                             shape=shape), backend="pallas")
    op_t = lt.BSROperator(lt.BSR(torch.from_numpy(blocks.astype(dtype)), torch.from_numpy(cols),
                                 shape))
    return op_t, op_j


def assert_same_plan(op_t, op_j):
    for f in ("win_q", "cols_local", "win_q_t", "win_valid_t"):
        a, b = getattr(op_t, f), getattr(op_j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.int32 and np.array_equal(to_numpy(a), np.asarray(b)), f
    assert (op_t._wb, op_t._x_pad_blocks, op_t._x_pad_blocks_t) == \
        (op_j._wb, op_j._x_pad_blocks, op_j._x_pad_blocks_t)
    assert tuple(op_t.data.blocks.shape) == tuple(op_j.data.blocks.shape)


def check_applies(op_t, op_j, rng, tol, dtype=np.float32, modes=("N", "T", "H")):
    for mode in modes:
        v = rng.standard_normal(op_t.in_dim(mode)).astype(dtype)
        yj = op_j.matvec(jnp.asarray(v), mode=mode)
        yt = op_t.matvec(torch.from_numpy(v), mode=mode)
        assert rel_err(yt, yj) <= tol, mode


def dense_of(blocks, cols, shape):
    nbrow, kmax, bm, bn = blocks.shape
    D = np.zeros((nbrow * bm, -(-shape[1] // bn) * bn), np.float64)
    for bi in range(nbrow):
        for k in range(kmax):
            c = cols[bi, k]
            D[bi * bm:(bi + 1) * bm, c * bn:(c + 1) * bn] += blocks[bi, k]
    return D[:shape[0], :shape[1]]


def banded(rng, n=40 * 128, kmax=3, slope=37):
    """test_sparse.py:466-474: each 8-row stripe touches kmax adjacent block
    columns starting at a slowly sliding j0."""
    nbrow = n // 8
    j0 = (np.arange(nbrow) * slope / nbrow).astype(np.int64)
    cols = (j0[:, None] + np.arange(kmax)[None]).astype(np.int32)
    blocks = rng.standard_normal((nbrow, kmax, 8, 128)).astype(np.float32)
    return blocks, cols, (n, n)


def band_cluster(rng, nbrow=64, kmax=8, nbcol=64, drop_group=2):
    """test_sparse.py:613-621: a sliding 7-wide band plus a far cluster that
    one group skips."""
    cols = np.zeros((nbrow, kmax), np.int32)
    for bi in range(nbrow):
        g = bi // 16
        band = g * 3
        clus = 56 if g != drop_group else band + 7
        cols[bi] = sorted(list(range(band, band + kmax - 1)) + [clus])
    blocks = rng.standard_normal((nbrow, kmax, 8, 128)).astype(np.float32)
    return blocks, cols, (nbrow * 8, nbcol * 128)


# ----------------------------------------------------------------------------
# Planners and row groups
# ----------------------------------------------------------------------------


def test_row_rules_match_reference():
    for kmax in (1, 2, 3, 5, 8, 10, 25):
        for bm, bn, itemsize in ((8, 128, 4), (16, 128, 2), (8, 32, 8), (128, 128, 4)):
            assert K.bsr_row_pad(bm, kmax, bn, itemsize) == \
                BK.bsr_pallas_rows_per_program(bm, kmax, bn, itemsize)
            for nbrow in (64, 256, 4096, 3 * 512):
                assert K.bsr_window_rows(bm, kmax, bn, itemsize, nbrow) == \
                    BK.bsr_windowed_rows_per_program(bm, kmax, bn, itemsize, nbrow)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(np.asarray(x), np.asarray(y)) and np.asarray(x).dtype == np.asarray(y).dtype
               if isinstance(x, np.ndarray) else x == y for x, y in zip(a, b))


def test_multi_plan_units_match_reference(caps):
    caps()
    cols = np.stack([np.full(16, 3), np.full(16, 900)], axis=1).astype(np.int32)
    pt = K.bsr_window_plan_multi(cols, R=8, nbcol=1024, wb_max=64)
    assert pt is not None and _same(pt, BK.bsr_window_plan_multi(cols, R=8, nbcol=1024, wb_max=64))
    q, wb, xpb = pt
    for g in range(q.shape[1]):  # every real column lies in one lane's window
        for c in (3, 900):
            assert any(q[w, g] * wb <= c < (q[w, g] + 1) * wb for w in range(q.shape[0]))
    cols_s = (np.arange(16)[:, None] * 977 % 8000).astype(np.int32)
    assert K.bsr_window_plan_multi(cols_s, R=16, nbcol=8192, wb_max=8) is None
    assert BK.bsr_window_plan_multi(cols_s, R=16, nbcol=8192, wb_max=8) is None


def test_multi_t_plan_units_match_reference():
    R = 8
    cols = np.zeros((4 * R, 2), np.int32)
    for g in range(4):
        band = g // 2
        clus = 50 if g != 2 else band
        for r in range(R):
            cols[g * R + r] = sorted([band * 8 + 1, clus * 8 + 1])
    pt = K.bsr_window_plan_multi_t(cols, R=R, nbcol=512, wb=8, W=2)
    assert pt is not None and _same(pt, BK.bsr_window_plan_multi_t(cols, R=R, nbcol=512, wb=8, W=2))
    q_t, valid, _ = pt
    assert (np.diff(q_t, axis=1) >= 0).all() and valid.min() == 0  # a repeated lane step
    cols_d = np.zeros((6 * R, 1), np.int32)
    for g in range(6):
        cols_d[g * R:(g + 1) * R, 0] = (10 - g) * 8 + 1
    assert K.bsr_window_plan_multi_t(cols_d, R=R, nbcol=512, wb=8, W=4) is None
    assert BK.bsr_window_plan_multi_t(cols_d, R=R, nbcol=512, wb=8, W=4) is None


@pytest.mark.parametrize("blocks_on", ["numpy", "torch"])
def test_plan_refuses_real_col0_in_pad_slot(blocks_on):
    cols = np.array([[30, 0]] * 16, np.int32)
    real0 = np.ones((16, 2, 8, 16), np.float32)
    padded = real0.copy()
    padded[:, 1] = 0.0
    wrap = (lambda a: a) if blocks_on == "numpy" else torch.from_numpy
    for blocks in (None, real0, padded):
        pt = K.bsr_window_plan(cols, R=8, nbcol=64, blocks=None if blocks is None else wrap(blocks))
        assert _same(pt, BK.bsr_window_plan(cols, R=8, nbcol=64, blocks=blocks))
    assert K.bsr_window_plan(cols, R=8, nbcol=64, blocks=wrap(padded)) is not None
    unsorted = np.array([[30, 5]] * 16, np.int32)
    assert K.bsr_window_plan(unsorted, R=8, nbcol=64, blocks=wrap(real0)) is None


def _fuzz_cols(rng, nbrow, kmax, nbcol):
    """A random band (random slope and width) plus, in some rows, far
    clusters; pads (column 0) at the end of short rows; sorted per row."""
    kind = rng.integers(0, 3)
    slope = rng.uniform(0.05, 1.5)
    width = int(rng.integers(1, kmax + 1))
    n_clus = int(rng.integers(0, 3)) if kind else 0
    clusters = rng.integers(nbcol // 2, nbcol, size=max(n_clus, 1))
    cols = np.zeros((nbrow, kmax), np.int32)
    for r in range(nbrow):
        base = min(int(r * slope), nbcol - width)
        row = set(range(base, base + width))
        for c in clusters[:n_clus]:
            if rng.random() < 0.8:
                row.add(int(c) + int(rng.integers(0, 3)))
        row = sorted(c for c in row if c < nbcol)[:kmax]
        cols[r, :len(row)] = row
    blocks = np.zeros((nbrow, kmax, 2, 4), np.float32)
    for r in range(nbrow):  # real slots nonzero, pads zero
        n_real = max(1, int((cols[r, 1:] != 0).sum()) + 1)
        blocks[r, :n_real] = 1.0
    return cols, blocks


@pytest.mark.parametrize("seed", range(6))
def test_planners_fuzz_match_reference(caps, seed):
    caps(window_blocks=int(np.random.default_rng(seed).choice([16, 64, 192])))
    rng = np.random.default_rng(1000 + seed)
    for _ in range(8):
        nbrow = int(rng.choice([64, 128, 256]))
        kmax = int(rng.integers(1, 6))
        nbcol = int(rng.integers(64, 600))
        cols, blocks = _fuzz_cols(rng, nbrow, kmax, nbcol)
        R = int(rng.choice([8, 16, 32, 64]))
        wbm = int(rng.choice([8, 32, 128, K.BSR_PALLAS_MAX_WINDOW_BLOCKS]))
        for blk in (None, blocks):
            kw = dict(wb_max=wbm, blocks=blk)
            assert _same(K.bsr_window_plan(cols, R, nbcol, **kw),
                         BK.bsr_window_plan(cols, R, nbcol, **kw))
            pm = K.bsr_window_plan_multi(cols, R, nbcol, **kw)
            assert _same(pm, BK.bsr_window_plan_multi(cols, R, nbcol, **kw))
            if pm is not None:
                for W in sorted({pm[0].shape[0], 4}):
                    assert _same(K.bsr_window_plan_multi_t(cols, R, nbcol, pm[1], W, blocks=blk),
                                 BK.bsr_window_plan_multi_t(cols, R, nbcol, pm[1], W, blocks=blk))


# ----------------------------------------------------------------------------
# Plain K3-K6 against the Pallas kernels in interpret mode
# ----------------------------------------------------------------------------


def _kernel_case(rng, caps, multi):
    caps(tile=65536)
    if multi:
        blocks, cols, shape = band_cluster(rng)
    else:
        blocks, cols, shape = banded(rng, n=256 * 8, kmax=2, slope=90)
        shape = (shape[0], 96 * 128)
    nbrow, kmax, bm, bn = blocks.shape
    nbcol = -(-shape[1] // bn)
    R = BK.bsr_windowed_rows_per_program(bm, kmax, bn, 4, nbrow)
    assert R == K.bsr_window_rows(bm, kmax, bn, 4, nbrow) and nbrow // R >= 4
    return blocks, cols, nbcol, R


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_windowed_vs_pallas_interpret(rng, caps, dtype):
    blocks, cols, nbcol, R = _kernel_case(rng, caps, multi=False)
    q, cl, wb, xpb = BK.bsr_window_plan(cols, R, nbcol, wb_max=64)
    jb = jnp.asarray(blocks).astype(jnp.dtype(dtype))
    tb = from_numpy(np.asarray(jb.astype(jnp.float32)), dtype=getattr(torch, dtype), device="cpu")
    xb = rng.standard_normal((nbcol, 128)).astype(np.float32)
    ub = rng.standard_normal((blocks.shape[0], 8)).astype(np.float32)
    yj = BK.bsr_matvec_pallas_windowed(jb, jnp.asarray(cl), jnp.asarray(q), jnp.asarray(xb),
                                       wb=wb, x_pad_blocks=xpb, interpret=True)
    yt = K.bsr_matvec_windowed_kernel(tb, torch.from_numpy(cl), torch.from_numpy(q),
                                      torch.from_numpy(xb), wb=wb, x_pad_blocks=xpb)
    oj = BK.bsr_rmatvec_pallas_windowed(jb, jnp.asarray(cl), jnp.asarray(q), jnp.asarray(ub),
                                        wb=wb, x_pad_blocks=xpb, nbcol=nbcol, interpret=True)
    ot = K.bsr_rmatvec_windowed_kernel(tb, torch.from_numpy(cl), torch.from_numpy(q),
                                       torch.from_numpy(ub), wb=wb, x_pad_blocks=xpb, nbcol=nbcol)
    assert yt.dtype == ot.dtype == torch.float32
    D = dense_of(np.asarray(jb.astype(jnp.float32)), cols, (blocks.shape[0] * 8, nbcol * 128))
    assert rel_err(yt.reshape(-1), D @ xb.reshape(-1)) <= 1e-5
    assert rel_err(ot.reshape(-1), D.T @ ub.reshape(-1)) <= 1e-5
    if dtype == "float32":
        assert rel_err(yt, yj) <= 1e-5 and rel_err(ot, oj) <= 1e-5
    else:  # the reference's bf16 forward splits x in two passes (about 1e-5)
        assert rel_err(yt, yj) <= 3e-5 and rel_err(ot, oj) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_multiwin_vs_pallas_interpret(rng, caps, dtype):
    blocks, cols, nbcol, R = _kernel_case(rng, caps, multi=True)
    caps(tile=65536, window_blocks=16)
    qm, wb, xpb = BK.bsr_window_plan_multi(cols, R, nbcol, wb_max=16)
    qt, vt, xpbt = BK.bsr_window_plan_multi_t(cols, R, nbcol, wb, 4)
    assert vt.min() == 0  # the skipped cluster: a repeated, invalid lane step
    jb = jnp.asarray(blocks).astype(jnp.dtype(dtype))
    tb = from_numpy(np.asarray(jb.astype(jnp.float32)), dtype=getattr(torch, dtype), device="cpu")
    xb = rng.standard_normal((nbcol, 128)).astype(np.float32)
    ub = rng.standard_normal((blocks.shape[0], 8)).astype(np.float32)
    tdt = getattr(torch, dtype)
    yj = BK.bsr_matvec_pallas_multiwin(jb, jnp.asarray(cols), jnp.asarray(qm), jnp.asarray(xb),
                                       wb=wb, x_pad_blocks=xpb, interpret=True)
    yt = K.bsr_matvec_multiwin_kernel(tb, torch.from_numpy(cols), torch.from_numpy(qm),
                                      torch.from_numpy(xb), wb=wb, x_pad_blocks=xpb)
    ujt = torch.from_numpy(ub).to(tdt)  # a bf16 transpose in the all-bf16 case
    oj = BK.bsr_rmatvec_pallas_multiwin(jb, jnp.asarray(cols), jnp.asarray(qt), jnp.asarray(vt),
                                        jnp.asarray(ub).astype(jnp.dtype(dtype)), wb=wb,
                                        x_pad_blocks=xpbt, nbcol=nbcol, interpret=True)
    ot = K.bsr_rmatvec_multiwin_kernel(tb, torch.from_numpy(cols), torch.from_numpy(qt),
                                       torch.from_numpy(vt), ujt, wb=wb, x_pad_blocks=xpbt,
                                       nbcol=nbcol)
    assert yt.dtype == torch.float32 and ot.dtype == tdt
    D = dense_of(np.asarray(jb.astype(jnp.float32)), cols, (blocks.shape[0] * 8, nbcol * 128))
    u_used = ujt.double().numpy().reshape(-1)
    assert rel_err(yt.reshape(-1), D @ xb.reshape(-1)) <= 1e-5
    assert rel_err(ot.double().reshape(-1), D.T @ u_used) <= (1e-5 if dtype == "float32" else 1e-2)
    if dtype == "float32":
        assert rel_err(yt, yj) <= 1e-5 and rel_err(ot, oj) <= 1e-5
    else:  # reference: two-pass x split forward, bf16 accumulation across groups
        assert rel_err(yt, yj) <= 3e-5
        assert rel_err(ot.float(), np.asarray(oj.astype(jnp.float32))) <= 5e-2


# ----------------------------------------------------------------------------
# The windowed operator, mirrored from tests/test_sparse.py
# ----------------------------------------------------------------------------


def test_windowed_forward_banded(rng, caps):
    """test_sparse.py:458 — a banded pattern from scipy through
    opSparse(format="bsr") plans a banded window; a scattered one plans as
    the reference plans it (here the 40 block columns fit one window)."""
    caps()
    blocks, cols, shape = banded(rng)
    nbrow = blocks.shape[0]
    sp = sps.bsr_matrix((blocks.reshape(-1, 8, 128), cols.reshape(-1),
                         np.arange(nbrow + 1) * cols.shape[1]), shape=shape).tocsr()
    op_j = lo.opSparse(sp, format="bsr", block_shape=(8, 128), backend="pallas")
    op_t = lt.opSparse(sp, format="bsr", block_shape=(8, 128), device="cpu")
    assert op_t.win_q is not None and op_t.cols_local is not None and op_t._wb > 0
    assert_same_plan(op_t, op_j)
    check_applies(op_t, op_j, rng, 3e-6)
    v = rng.standard_normal(shape[1])
    assert rel_err(op_t * torch.from_numpy(v), sp @ v) <= 3e-6
    # scattered
    idx = rng.integers(0, 40, nbrow)
    S = sps.csr_matrix((np.ones(shape[0]), (np.arange(shape[0]),
                        ((idx.repeat(8) * 997) % 40) * 128 + rng.integers(0, 128, shape[0]))),
                       shape=shape)
    op2_t = lt.opSparse(S, format="bsr", block_shape=(8, 128), device="cpu")
    op2_j = lo.opSparse(S, format="bsr", block_shape=(8, 128), backend="pallas")
    assert_same_plan(op2_t, op2_j)
    v2 = rng.standard_normal(shape[1])
    assert rel_err(op2_t * torch.from_numpy(v2), S @ v2) <= 1e-12


def test_windowed_banded_f64(rng, caps):
    caps()
    blocks, cols, shape = banded(rng)
    op_t, op_j = both_ops(blocks.astype(np.float64), cols, shape, np.float64)
    assert op_t.cols_local is not None
    assert_same_plan(op_t, op_j)
    check_applies(op_t, op_j, rng, 1e-10, np.float64)


def test_multiwindow_forward_and_transpose(rng, caps):
    """test_sparse.py:492 — a band plus a far cluster: the banded plan
    refuses, the multi plan and its monotone-lane transpose plan carry both
    directions."""
    caps()
    nbrow, kmax, nbcol = 256, 3, 4608
    cols = np.zeros((nbrow, kmax), np.int32)
    for bi in range(nbrow):
        cols[bi] = sorted([bi // 8, bi // 8 + 1, 4400 + (bi % 16) * 8])
    blocks = rng.standard_normal((nbrow, kmax, 8, 128)).astype(np.float32)
    shape = (nbrow * 8, nbcol * 128)
    op_t, op_j = both_ops(blocks, cols, shape)
    assert op_t.win_q is not None and op_t.cols_local is None and op_t.win_q.dim() == 2
    assert op_t.win_q_t is not None and (np.diff(to_numpy(op_t.win_q_t), axis=1) >= 0).all()
    assert_same_plan(op_t, op_j)
    check_applies(op_t, op_j, rng, 3e-6, modes=("N", "T"))
    op64_t, op64_j = both_ops(blocks.astype(np.float64), cols, shape, np.float64)
    assert_same_plan(op64_t, op64_j)
    check_applies(op64_t, op64_j, rng, 1e-10, np.float64)


def test_multiwindow_transpose_groups(rng, caps):
    """test_sparse.py:598 — several groups, a repeated (invalid) lane step,
    revisits within a lane; columns nothing touches come out exactly zero."""
    caps(window_blocks=16, tile=65536)
    blocks, cols, shape = band_cluster(rng)
    op_t, op_j = both_ops(blocks, cols, shape)
    assert op_t.cols_local is None and op_t.win_q_t is not None
    assert_same_plan(op_t, op_j)
    D = dense_of(blocks, cols, shape)
    u = rng.standard_normal(shape[0]).astype(np.float32)
    yt = to_numpy(op_t.T * torch.from_numpy(u))
    ref = D.T @ u
    assert rel_err(yt, ref) <= 3e-6
    assert rel_err(yt, np.asarray(op_j.T @ jnp.asarray(u))) <= 3e-6
    assert np.abs(yt[ref == 0]).max(initial=0.0) == 0.0
    check_applies(op_t, op_j, rng, 3e-6, modes=("N",))


def test_windowed_transpose_jump(rng, caps):
    """test_sparse.py:662 — a band that jumps over windows: unvisited
    windows are exactly zero."""
    caps()
    n = 40 * 128
    nbrow = n // 8
    cols = np.where(np.arange(nbrow)[:, None] < nbrow // 2, 0, 30) + np.arange(2)[None]
    cols = cols.astype(np.int32)
    blocks = rng.standard_normal((nbrow, 2, 8, 128)).astype(np.float32)
    op_t, op_j = both_ops(blocks, cols, (n, n))
    assert_same_plan(op_t, op_j)
    u = rng.standard_normal(n).astype(np.float32)
    ref = dense_of(blocks, cols, (n, n)).T @ u
    if op_t.win_q is not None:
        yt = to_numpy(op_t.T * torch.from_numpy(u))
        assert rel_err(yt, ref) <= 3e-6
        assert np.abs(yt[ref == 0]).max(initial=0.0) == 0.0
    check_applies(op_t, op_j, rng, 3e-6, modes=("T",))


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
def test_multiwindow_bf16_blocks(rng, caps, vec_dtype):
    """test_sparse.py:739 — bf16 blocks through the multi-window transpose
    (and forward), against an f32 oracle of the same bf16 values."""
    caps(window_blocks=16, tile=65536)
    blocks, cols, shape = band_cluster(rng)
    b16 = torch.from_numpy(blocks).to(torch.bfloat16)
    op_t = lt.BSROperator(lt.BSR(b16, torch.from_numpy(cols), shape))
    op_j = JBSROperator(JBSR(jnp.asarray(blocks).astype(jnp.bfloat16), jnp.asarray(cols), shape),
                        backend="pallas")
    assert op_t.win_q_t is not None
    assert_same_plan(op_t, op_j)
    D = dense_of(b16.float().numpy(), cols, shape)
    vdt = getattr(torch, vec_dtype)
    tol = 1e-5 if vec_dtype == "float32" else 1e-2
    u = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32)).to(vdt)
    x = torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32)).to(vdt)
    yt, ot = op_t * x, op_t.T * u
    assert yt.dtype == ot.dtype == vdt
    assert rel_err(yt.double(), D @ x.double().numpy()) <= tol
    assert rel_err(ot.double(), D.T @ u.double().numpy()) <= tol


def test_all_bf16_apply(rng):
    """test_sparse.py:702 — bf16 blocks and a bf16 vector: the result stays
    bf16, accumulated in f32, within bf16 rounding of an f32 oracle of the
    same bf16 values (1e-2 of max|y|: the output's rounding, 2^-8)."""
    nbrow, kmax, nbcol = 16, 2, 4
    blocks = torch.from_numpy(rng.standard_normal((nbrow, kmax, 8, 128)).astype(np.float32))
    cols = rng.integers(0, nbcol, (nbrow, kmax)).astype(np.int32)
    shape = (nbrow * 8, nbcol * 128)
    op_t = lt.BSROperator(lt.BSR(blocks.to(torch.bfloat16), torch.from_numpy(cols), shape))
    op_j = JBSROperator(JBSR(jnp.asarray(blocks.numpy()).astype(jnp.bfloat16), jnp.asarray(cols),
                             shape), backend="pallas")
    D = dense_of(blocks.to(torch.bfloat16).double().numpy(), cols, shape)
    v = torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32)).to(torch.bfloat16)
    u = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32)).to(torch.bfloat16)
    y, o = op_t * v, op_t.T * u
    assert y.dtype == o.dtype == torch.bfloat16
    assert rel_err(y.double(), D @ v.double().numpy()) <= 1e-2
    assert rel_err(o.double(), D.T @ u.double().numpy()) <= 1e-2
    yj = op_j @ jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
    assert rel_err(y.double(), np.asarray(yj, np.float64)) <= 1e-2


def test_multiwindow_transpose_fuzz(rng, caps):
    """test_sparse.py:788 — random mostly-banded patterns: a plan the two
    packages agree on, or a refusal in both; planned transposes match."""
    caps(window_blocks=16, tile=65536)
    nbrow, kmax, nbcol = 64, 8, 64
    planned = 0
    for trial in range(6):
        cols = np.zeros((nbrow, kmax), np.int32)
        base_step = int(rng.integers(1, 4))
        n_clusters = int(rng.integers(0, 3))
        clusters = rng.integers(40, nbcol - 1, size=max(n_clusters, 1))
        for bi in range(nbrow):
            g = bi // 16
            band0 = min(g * base_step, nbcol - kmax - 1)
            row = list(range(band0, band0 + kmax - n_clusters))
            for c in clusters[:n_clusters]:
                row.append(int(c) if g != int(rng.integers(0, 4)) else band0 + kmax)
            cols[bi] = sorted(row)[:kmax]
        blocks = rng.standard_normal((nbrow, kmax, 8, 128)).astype(np.float32)
        op_t, op_j = both_ops(blocks, cols, (nbrow * 8, nbcol * 128))
        assert_same_plan(op_t, op_j)
        if op_t.win_q_t is None:
            continue
        planned += 1
        u = rng.standard_normal(nbrow * 8).astype(np.float32)
        ref = dense_of(blocks, cols, (nbrow * 8, nbcol * 128)).T @ u
        assert rel_err(op_t.T * torch.from_numpy(u), ref) <= 3e-6, trial
    assert planned >= 2


# ----------------------------------------------------------------------------
# Dispatch, carried plans, K4/K6's index
# ----------------------------------------------------------------------------


def test_dispatch_takes_the_plans_branch(rng, caps, monkeypatch):
    """CPU tensors run the plain version of the branch the plan selects:
    K3/K4 for a banded plan, K5/K6 for a multi plan; backend='torch' the
    plain K1/K2; no kernel launches on the CPU."""
    caps(window_blocks=16, tile=65536)
    ran = []
    for name in ("bsr_matvec_windowed_plain", "bsr_rmatvec_windowed_plain",
                 "bsr_matvec_multiwin_plain", "bsr_rmatvec_multiwin_plain"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name, **kw: ran.append(_n) or _fn(*a, **kw))
    K.reset_launch_counts()
    multi = lt.BSROperator(lt.BSR(*map(torch.from_numpy, band_cluster(rng)[:2]), (512, 8192)))
    b_blocks, b_cols, b_shape = banded(rng)
    band = lt.BSROperator(lt.BSR(torch.from_numpy(b_blocks), torch.from_numpy(b_cols), b_shape))
    for op in (band, multi):
        op * torch.ones(op.ncol)
        op.T * torch.ones(op.nrow)
    assert ran == ["bsr_matvec_windowed_plain", "bsr_rmatvec_windowed_plain",
                   "bsr_matvec_multiwin_plain", "bsr_rmatvec_multiwin_plain"]
    plain = lt.BSROperator(band.data, backend="torch")
    assert plain.win_q is None
    ran.clear()
    plain * torch.ones(plain.ncol)
    assert ran == [] and all(v == 0 for v in K.launch_counts().values())
    with pytest.raises(lt.LinearOperatorException, match="backend='kernel' needs"):
        lt.BSROperator(band.data, backend="kernel") * torch.ones(band.ncol)


def test_plain_transposes_build_their_order_once(rng, caps, monkeypatch):
    """Each operator's plain transpose (K4's, K6's or K2's plain version)
    builds its segment plan at its first apply and keeps it: later applies
    build none and give the same bits."""
    from linops_tpu_torch.sparse import ops as sparse_ops

    caps(window_blocks=16, tile=65536)
    built = []
    for mod in (K, sparse_ops):
        real = mod.segment_plan
        monkeypatch.setattr(mod, "segment_plan",
                            lambda *a, _f=real, **k: built.append(1) or _f(*a, **k))
    multi = lt.BSROperator(lt.BSR(*map(torch.from_numpy, band_cluster(rng)[:2]), (512, 8192)))
    b_blocks, b_cols, b_shape = banded(rng)
    band = lt.BSROperator(lt.BSR(torch.from_numpy(b_blocks), torch.from_numpy(b_cols), b_shape))
    plain = lt.BSROperator(band.data, backend="torch")
    for op in (band, multi, plain):
        built.clear()
        u = torch.from_numpy(rng.standard_normal(op.nrow).astype(np.float32))
        first = op.T * u
        assert torch.equal(op.T * u, first) and torch.equal(op.T * u, first)
        assert len(built) == 1


def test_no_plan_below_the_bound_or_for_wide_blocks(rng):
    blocks, cols, shape = banded(rng)  # 5120 x elements < 2e6: K1/K2
    assert lt.BSROperator(lt.BSR(torch.from_numpy(blocks), torch.from_numpy(cols), shape)).win_q is None


def test_carried_plan_equals_the_ports_own(rng, caps):
    caps(window_blocks=16, tile=65536)
    blocks, cols, shape = band_cluster(rng)
    op_j = JBSROperator(JBSR(jnp.asarray(blocks), jnp.asarray(cols), shape), backend="pallas")
    carried = bsr_operator_from_reference(
        np.asarray(op_j.data.blocks), np.asarray(op_j.data.block_cols), op_j.data.shape,
        win_q=np.asarray(op_j.win_q), cols_local=None, win_q_t=np.asarray(op_j.win_q_t),
        win_valid_t=np.asarray(op_j.win_valid_t), wb=op_j._wb, x_pad_blocks=op_j._x_pad_blocks,
        x_pad_blocks_t=op_j._x_pad_blocks_t, device="cpu")
    own = lt.BSROperator(lt.BSR(torch.from_numpy(blocks), torch.from_numpy(cols), shape))
    assert_same_plan(carried, op_j)
    assert_same_plan(own, op_j)
    u = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32))
    assert torch.equal(carried.T * u, own.T * u)
    with pytest.raises(lt.LinearOperatorException, match="needs win_q"):
        bsr_operator_from_reference(blocks, cols, shape, cols_local=np.zeros_like(cols), wb=8, device="cpu")


def _emulate_partials(blocks, u, perm, ptr, nrows):
    """Phase 1 of K4/K6 as the CUDA kernel runs it: partial row i sums its
    listed slots in order."""
    bm, bn = blocks.shape[2:]
    flat = blocks.reshape(-1, bm, bn)
    kmax = blocks.shape[1]
    P = np.zeros((nrows, bn))
    for i in range(nrows):
        for s in perm[ptr[i]:ptr[i + 1]]:
            P[i] += flat[s].T @ u[s // kmax]
    return P


def test_window_t_index_emulates_k4(rng, caps):
    caps(tile=65536)
    blocks, cols, nbcol, R = _kernel_case(rng, caps, multi=False)
    q, cl, wb, xpb = K.bsr_window_plan(cols, R, nbcol, wb_max=64)
    u = rng.standard_normal((blocks.shape[0], 8))
    perm, ptr = K.bsr_window_t_index(torch.from_numpy(cl), torch.from_numpy(q), wb)
    ngroups = q.shape[0]
    P = _emulate_partials(blocks.astype(np.float64), u, perm.numpy(), ptr.numpy(), ngroups * 2 * wb)
    out = np.zeros((nbcol, 128))
    for c in range(nbcol):  # phase 2: groups with q in {p-1, p}, in order
        p = c // wb
        for g in range(np.searchsorted(q, p - 1, "left"), np.searchsorted(q, p, "right")):
            out[c] += P[g * 2 * wb + c - q[g] * wb]
    ref = K.bsr_rmatvec_windowed_plain(torch.from_numpy(blocks).double(), torch.from_numpy(cl),
                                       torch.from_numpy(q), torch.from_numpy(u), wb=wb,
                                       x_pad_blocks=xpb, nbcol=nbcol)
    assert rel_err(out, ref.numpy()) <= 1e-12


def _k6_case(rng, caps):
    """The band + far cluster case on the reference's multi plans: one group
    skips the cluster (an invalid lane step), and block columns 16-55 and
    57-63 lie in no window; the cluster column 56 takes 48 slots."""
    blocks, cols, nbcol, R = _kernel_case(rng, caps, multi=True)
    caps(tile=65536, window_blocks=16)
    _, wb, _ = BK.bsr_window_plan_multi(cols, R, nbcol, wb_max=16)
    qt, vt, xpbt = BK.bsr_window_plan_multi_t(cols, R, nbcol, wb, 4)
    assert vt.min() == 0
    return blocks, cols, nbcol, wb, qt, vt, xpbt


@pytest.mark.parametrize("chunk_slots", [16, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiwin_t_index_emulates_k6(rng, caps, dtype, chunk_slots):
    """K6's column plan walked in the kernel's order (``_walk_plan``: each
    chunk's slots in order, a column of one chunk written by it, the others
    by the combine's warps in order), in f64: the plain K6 within 1e-12,
    the reference's Pallas K6 in interpret mode within 1e-5 (f32 blocks; bf16
    blocks against an f32 oracle of the same values, as the reference
    accumulates across groups in bf16), exact zeros in the columns no window
    visits; with 2 slots a chunk the cluster column runs over 24 chunks."""
    from test_torch_bsr import _walk_plan

    blocks, cols, nbcol, wb, qt, vt, xpbt = _k6_case(rng, caps)
    jb = jnp.asarray(blocks).astype(jnp.dtype(dtype))
    tb = from_numpy(np.asarray(jb.astype(jnp.float32)), dtype=getattr(torch, dtype), device="cpu")
    ub = rng.standard_normal((blocks.shape[0], 8)).astype(np.float32)
    ct, qtt, vtt, ut = (torch.from_numpy(a) for a in (cols, qt, vt, ub))
    plan = K.bsr_multiwin_t_plan(ct, qtt, vtt, wb, nbcol, block_bytes=65536 // chunk_slots)
    assert plan.chunk_slots == chunk_slots
    hot = plan.col_chunk[57] - plan.col_chunk[56]
    assert hot == -(-48 // chunk_slots)
    walked = _walk_plan(tb, ct, ut, nbcol, plan)
    plain = K.bsr_rmatvec_multiwin_plain(tb.double(), ct, qtt, vtt, ut.double(), wb=wb,
                                         x_pad_blocks=xpbt, nbcol=nbcol)
    assert rel_err(walked, plain.numpy()) <= 1e-12
    assert not walked[16:56].any() and not walked[57:].any()
    oj = BK.bsr_rmatvec_pallas_multiwin(jb, jnp.asarray(cols), jnp.asarray(qt), jnp.asarray(vt),
                                        jnp.asarray(ub), wb=wb, x_pad_blocks=xpbt, nbcol=nbcol,
                                        interpret=True)
    D = dense_of(np.asarray(jb.astype(jnp.float32)), cols, (blocks.shape[0] * 8, nbcol * 128))
    assert rel_err(walked.reshape(-1), D.T @ ub.reshape(-1).astype(np.float64)) <= 1e-12
    assert rel_err(walked, oj) <= (1e-5 if dtype == "float32" else 5e-2)


def test_multiwin_t_plan_invariants(rng, caps):
    """K6's column plan lists each slot once for every valid lane step whose
    window holds its block column (the plain K6's weight: none for the
    group that skips the cluster, two when two valid lanes repeat a
    window), by column and then by slot, in chunks of at most S slots of
    one column that cover the list once; ``combine_cols`` are the columns
    with no chunk or several. Walked, the repeated lane gives the plain
    K6's doubled sum."""
    from test_torch_bsr import _walk_plan

    blocks, cols, nbcol, wb, qt, vt, xpbt = _k6_case(rng, caps)
    for q_t, v_t in ((qt, vt), (np.concatenate([qt, qt[:1]]), np.concatenate([vt, vt[:1]]))):
        ct, qtt, vtt = (torch.from_numpy(np.ascontiguousarray(a)) for a in (cols, q_t, v_t))
        plan = K.bsr_multiwin_t_plan(ct, qtt, vtt, wb, nbcol, block_bytes=65536 // 4)
        weight = K._lane_weights(ct, qtt, wb, valid=vtt).reshape(-1).numpy()
        perm = plan.perm.numpy()
        assert np.array_equal(np.bincount(perm, minlength=weight.size), weight)
        key = cols.reshape(-1)[perm].astype(np.int64) * weight.size + perm
        assert (np.diff(key) >= 0).all()
        colptr, ptr = plan.colptr.numpy(), plan.chunk_ptr.numpy()
        chunk_col, col_chunk = plan.chunk_col.numpy(), plan.col_chunk.numpy()
        assert ptr[0] == 0 and ptr[-1] == perm.size and (np.diff(ptr) >= 1).all()
        assert (np.diff(ptr) <= plan.chunk_slots).all()
        for ch, c in enumerate(chunk_col):
            assert (cols.reshape(-1)[perm[ptr[ch]:ptr[ch + 1]]] == c).all()
            assert col_chunk[c] <= ch < col_chunk[c + 1]
        assert np.array_equal(np.diff(colptr), np.bincount(cols.reshape(-1)[perm], minlength=nbcol))
        assert np.array_equal(plan.combine_cols.numpy(), np.nonzero(np.diff(col_chunk) != 1)[0])
        ub = torch.from_numpy(rng.standard_normal((blocks.shape[0], 8)))
        tb = torch.from_numpy(blocks)
        walked = _walk_plan(tb, ct, ub, nbcol, plan)
        plain = K.bsr_rmatvec_multiwin_plain(tb.double(), ct, qtt, vtt, ub, wb=wb,
                                             x_pad_blocks=xpbt, nbcol=nbcol)
        assert rel_err(walked, plain.numpy()) <= 1e-12


def test_multiwin_index_emulates_k5(rng, caps):
    """K5's lane rows, used as the CUDA kernel uses them (each group's
    windows staged, zero past x; a slot reads row index[r,k], -1 adds
    nothing), give the plain K5's product; a column in two lanes' windows
    is refused."""
    caps(window_blocks=16, tile=65536)
    blocks, cols, shape = band_cluster(rng)
    nbcol = shape[1] // 128
    R = K.bsr_window_rows(8, 8, 128, 4, blocks.shape[0])
    qm, wb, xpb = K.bsr_window_plan_multi(cols, R, nbcol, wb_max=16)
    index = K.bsr_multiwin_index(torch.from_numpy(cols), torch.from_numpy(qm), wb).numpy()
    assert index.dtype == np.int32 and index.min() >= 0  # every slot in some window
    x = rng.standard_normal((nbcol, 128))
    W, ngroups = qm.shape
    y = np.zeros((blocks.shape[0], 8))
    for g in range(ngroups):
        xs = np.zeros((W * wb, 128))
        for w in range(W):
            rows = np.arange(qm[w, g] * wb, (qm[w, g] + 1) * wb)
            xs[w * wb:(w + 1) * wb][rows < nbcol] = x[rows[rows < nbcol]]
        for r in range(g * R, (g + 1) * R):
            for k in range(blocks.shape[1]):
                if index[r, k] >= 0:
                    y[r] += blocks[r, k] @ xs[index[r, k]]
    ref = K.bsr_matvec_multiwin_plain(torch.from_numpy(blocks).double(), torch.from_numpy(cols),
                                      torch.from_numpy(qm), torch.from_numpy(x), wb=wb,
                                      x_pad_blocks=xpb)
    assert rel_err(y, ref.numpy()) <= 1e-12
    dup = np.concatenate([qm, qm[:1]])  # a fifth lane repeating the first lane's windows
    with pytest.raises(ValueError, match="two windows"):
        K.bsr_multiwin_index(torch.from_numpy(cols), torch.from_numpy(dup), wb)


def test_t_index_refuses_decreasing_windows():
    cols_local = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="never decrease"):
        K.bsr_window_t_index(cols_local, torch.tensor([1, 0], dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="never decrease"):
        K.bsr_multiwin_t_plan(cols_local, torch.tensor([[2, 1]], dtype=torch.int32),
                              torch.ones((1, 2), dtype=torch.int32), 8, 24)


def test_banded_normal_equations_cg_both_packages(rng, caps):
    """A small banded normal-equations solve, (BᵀB + σI) x = b, with B on
    its window plan in both packages (f64): the same iteration count and
    x within 1e-10·max|x|."""
    caps()
    blocks, cols, shape = banded(rng, kmax=2)
    blocks = blocks.astype(np.float64) / np.sqrt(2 * 128)
    sigma = 1.0
    op_t, op_j = both_ops(blocks, cols, shape, np.float64)
    assert op_t.cols_local is not None
    assert_same_plan(op_t, op_j)
    At = op_t.T @ op_t + sigma * lt.opEye(shape[1], dtype=torch.float64)
    Aj = op_j.T @ op_j + sigma * lo.opEye(shape[1], dtype=jnp.float64)
    b = rng.standard_normal(shape[1])
    xt, kt, _ = lt.cg(At, torch.from_numpy(b), tol=1e-10, maxiter=200)
    xj, kj, _ = lo.cg(Aj, jnp.asarray(b), tol=1e-10, maxiter=200)
    assert kt == int(kj) and kt < 200
    assert rel_err(xt, xj) <= 1e-10


def test_plain_scatter_sums_in_f64(rng):
    """The plain window transposes sum into a column in f64 and round once:
    2^17 f32 contributions to one column land within an f32 rounding of the
    exact sum (summed in f32 they drift by about 1e-5 of it)."""
    n = 1 << 17
    blocks = torch.from_numpy(rng.standard_normal((n, 1, 1, 4)).astype(np.float32))
    u = torch.ones((n, 1), dtype=torch.float32)
    targets = torch.zeros((n, 1), dtype=torch.int64)
    out = K._scatter(blocks, u, targets, torch.ones((n, 1), dtype=torch.int32), 2)
    exact = blocks.double().sum(dim=(0, 1, 2))
    assert out.dtype == torch.float32 and torch.count_nonzero(out[1]) == 0
    assert float((out[0].double() - exact).abs().max() / exact.abs().max()) <= 2**-23


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library's name hashes its source and every local header it
    includes, so an edit to a shared header builds a new library."""
    from linops_tpu_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "_CSRC", str(tmp_path))
    assert sorted(build._sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    before = build._library_path("k")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert build._library_path("k") != before
