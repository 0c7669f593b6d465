"""Parity of the port's BSR operator and the plain versions of its kernels
with the JAX reference, on the CPU.

- Operator level, f64: ``BSROperator`` N/T/C/H and ``apply_matrix`` against
  the reference's; agreement max|Δ| ≤ 1e-10·max|ref|.
- Kernel level, f32: the plain K1/K2 (``bsr_matvec_plain`` /
  ``bsr_rmatvec_plain``, what a CPU tensor runs) against the Pallas kernels
  in interpret mode, nbrow padded to ``bsr_pallas_rows_per_program``;
  agreement 1e-5 relative (f32 accumulation on both sides).
- Kernel level, bf16 blocks: the reference forward uses the two-pass
  ``onehot_fast`` split of x (about 16 mantissa bits, 2^-17 ≈ 7.6e-6 relative
  per element; measured 2-4e-6 of max|y|), the port an exact gather, so the
  forward is held to 3e-5; the transpose has no split and is held to 1e-5.
- K2's column plan (``bsr_column_plan``): its invariants, and a walk of it
  in the CUDA kernel's order (chunks, then the combine pass) in f64, held to
  1e-12 of the plain transpose and to the tolerances above against the
  reference's Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.kernels import bsr_matvec_pallas, bsr_pallas_rows_per_program, bsr_rmatvec_pallas
from linops_tpu.sparse.formats import bsr_from_dense as jax_bsr_from_dense
from linops_tpu_torch.convert import bsr_from_reference, from_numpy, to_numpy
from linops_tpu_torch.kernels import bsr_spmv as K

MODES = ("N", "T", "C", "H")


def rel_err(got, ref) -> float:
    got = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor) else got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def sprand(rng, m, n, density=0.15, complex_=False):
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
    return A * (rng.random((m, n)) < density)


def both_ops(A, block_shape, **kw):
    op_j = lo.BSROperator(jax_bsr_from_dense(A, block_shape), backend="xla")
    op_t = lt.BSROperator(lt.bsr_from_dense(A, block_shape, device="cpu"), **kw)
    return op_j, op_t


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("shape,block", [((30, 50), (8, 16)), ((50, 30), (4, 8)),
                                         ((37, 53), (8, 16))])
def test_bsr_operator_modes_f64(rng, shape, block, complex_):
    A = sprand(rng, *shape, complex_=complex_)
    op_j, op_t = both_ops(A, block)
    assert op_t.shape == op_j.shape == shape
    for mode in MODES:
        v = rng.standard_normal(op_t.in_dim(mode))
        if complex_:
            v = v + 1j * rng.standard_normal(op_t.in_dim(mode))
        yj = op_j.matvec(jnp.asarray(v), mode=mode)
        yt = op_t.matvec(torch.from_numpy(v), mode=mode)
        assert rel_err(yt, yj) <= 1e-10, mode
        if mode in ("N", "T"):  # the blocked form (N) and the per-column fallback
            M = rng.standard_normal((op_t.in_dim(mode), 3))
            assert rel_err(op_t.matmat(torch.from_numpy(M), mode=mode),
                           op_j.matmat(jnp.asarray(M), mode=mode)) <= 1e-10, mode
    assert rel_err(op_t.to_dense(), A) <= 1e-12


def _padded_reference(rng, n, block, dtype):
    A = sprand(rng, n, n, 0.1).astype(np.float32)
    bsr = jax_bsr_from_dense(A, block)
    R = bsr_pallas_rows_per_program(block[0], bsr.blocks.shape[1], block[1],
                                    jnp.dtype(dtype).itemsize)
    pad = (-bsr.blocks.shape[0]) % R
    blocks = jnp.pad(bsr.blocks, ((0, pad), (0, 0), (0, 0), (0, 0))).astype(dtype)
    cols = jnp.pad(bsr.block_cols, ((0, pad), (0, 0)))
    return A, blocks, cols


@pytest.mark.parametrize("block", [(8, 32), (8, 128)])
@pytest.mark.parametrize("variant", ["onehot", "loop"])
def test_plain_kernels_vs_pallas_interpret_f32(rng, block, variant):
    n = 256
    A, blocks, cols = _padded_reference(rng, n, block, jnp.float32)
    bm, bn = block
    xb = rng.standard_normal((n // bn, bn)).astype(np.float32)
    ub = rng.standard_normal((blocks.shape[0], bm)).astype(np.float32)
    bt, ct = from_numpy(blocks, device="cpu"), from_numpy(cols, device="cpu")

    yj = bsr_matvec_pallas(blocks, cols, jnp.asarray(xb), interpret=True, variant=variant)
    yt = K.bsr_matvec_kernel(bt, ct, torch.from_numpy(xb))  # CPU tensors: the plain K1
    assert yt.dtype == torch.float32 and yt.shape == tuple(yj.shape)
    assert rel_err(yt, yj) <= 1e-5

    oj = bsr_rmatvec_pallas(blocks, cols, jnp.asarray(ub), n // bn, interpret=True)
    ot = K.bsr_rmatvec_kernel(bt, ct, torch.from_numpy(ub), n // bn)  # the plain K2
    assert ot.dtype == torch.float32 and ot.shape == tuple(oj.shape)
    assert rel_err(ot, oj) <= 1e-5
    assert rel_err(ot.reshape(-1)[:n], A.T.astype(np.float64) @ ub.reshape(-1)[:n]) <= 1e-5


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
def test_plain_kernels_vs_pallas_interpret_bf16_blocks(rng, vec_dtype):
    n = 512
    _, blocks, cols = _padded_reference(rng, n, (8, 128), jnp.bfloat16)
    xb = rng.standard_normal((n // 128, 128)).astype(np.float32)
    ub = rng.standard_normal((blocks.shape[0], 8)).astype(np.float32)
    jdt, tdt = jnp.dtype(vec_dtype), getattr(torch, vec_dtype)
    bt = from_numpy(blocks.astype(jnp.float32), dtype=torch.bfloat16, device="cpu")
    ct = from_numpy(cols, device="cpu")

    yj = bsr_matvec_pallas(blocks, cols, jnp.asarray(xb).astype(jdt), interpret=True,
                           variant="onehot_fast")  # what the reference runs for bf16
    yt = K.bsr_matvec_kernel(bt, ct, torch.from_numpy(xb).to(tdt))
    assert yt.dtype == tdt
    assert rel_err(yt, yj.astype(jnp.float32)) <= (3e-5 if vec_dtype == "float32" else 1e-2)

    oj = bsr_rmatvec_pallas(blocks, cols, jnp.asarray(ub).astype(jdt), n // 128, interpret=True)
    ot = K.bsr_rmatvec_kernel(bt, ct, torch.from_numpy(ub).to(tdt), n // 128)
    assert ot.dtype == tdt
    assert rel_err(ot, oj.astype(jnp.float32)) <= (1e-5 if vec_dtype == "float32" else 1e-2)


def test_reference_padded_data_f64(rng):
    """Data the reference padded (extra zero block rows at block column 0)
    crosses through convert and gives the reference's results."""
    n = 200
    A = sprand(rng, n, n + 9)
    op_j = lo.BSROperator(jax_bsr_from_dense(A, (8, 32)), backend="pallas")
    d = op_j.data
    assert d.blocks.shape[0] * 8 > n  # the reference did pad
    op_t = lt.BSROperator(bsr_from_reference(np.asarray(d.blocks), np.asarray(d.block_cols),
                                             d.shape, device="cpu"))
    for mode in ("N", "T"):
        v = rng.standard_normal(op_t.in_dim(mode))
        yj = lo.BSROperator(d, backend="xla").matvec(jnp.asarray(v), mode=mode)
        assert rel_err(op_t.matvec(torch.from_numpy(v), mode=mode), yj) <= 1e-10


def test_backend_names_and_dispatch(rng):
    A = sprand(rng, 32, 32).astype(np.float32)
    data = lt.bsr_from_dense(A, (8, 16), device="cpu")
    for name, canon in (("auto", "auto"), ("pallas", "kernel"), ("pallas_fast", "kernel"),
                        ("kernel", "kernel"), ("xla", "torch"), ("torch", "torch")):
        assert lt.BSROperator(data, backend=name)._backend == canon
    with pytest.raises(ValueError, match="unknown BSR backend"):
        lt.BSROperator(data, backend="mosaic")
    v = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    with pytest.raises(lt.LinearOperatorException, match="backend='kernel' needs"):
        lt.BSROperator(data, backend="kernel") * v  # no kernel off CUDA
    K.reset_launch_counts()
    y_auto = lt.BSROperator(data) * v
    y_plain = lt.BSROperator(data, backend="torch") * v
    assert torch.equal(y_auto, y_plain)  # CPU tensors take the plain version
    assert set(K.launch_counts()) >= {"bsr_matvec", "bsr_rmatvec"}
    assert all(n == 0 for n in K.launch_counts().values())


def test_kernel_dtype_rule():
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    assert K.kernel_dtypes(f32, f32) == (f32, f32)
    assert K.kernel_dtypes(bf16, f32) == (bf16, f32)
    assert K.kernel_dtypes(bf16, bf16) == (bf16, bf16)
    assert K.kernel_dtypes(f32, bf16) == (f32, f32)  # the vector is widened
    assert K.kernel_dtypes(f32, f64) is None
    assert K.kernel_dtypes(f64, f64) is None
    assert K.kernel_dtypes(torch.complex64, f32) is None


def test_bad_block_cols_rejected(rng):
    data = lt.bsr_from_dense(sprand(rng, 16, 32), (8, 16), device="cpu")
    bad = data._replace(block_cols=data.block_cols + 5)
    with pytest.raises(lt.LinearOperatorException, match="must lie in"):
        lt.BSROperator(bad)
    with pytest.raises(lt.LinearOperatorException, match="int32"):
        lt.BSROperator(data._replace(block_cols=data.block_cols.long()))
    with pytest.raises(lt.LinearOperatorException, match="shape mismatch"):
        lt.BSROperator(data) * torch.ones(31, dtype=torch.float64)


def test_column_index_orders_slots_by_column(rng):
    """K2's index: perm lists the flattened slots stably sorted by block
    column and colptr delimits each column; a transpose summed column by
    column in that order equals the plain transpose."""
    nbrow, kmax, nbcol, bm, bn = 13, 5, 9, 3, 4
    cols = torch.from_numpy(rng.integers(0, nbcol - 1, (nbrow, kmax)).astype(np.int32))
    perm, colptr = K.bsr_column_index(cols, nbcol)
    assert perm.dtype == colptr.dtype == torch.int32
    flat = cols.reshape(-1).numpy()
    p, c = perm.numpy(), colptr.numpy()
    assert c[0] == 0 and c[-1] == flat.size and c[-1] - c[-2] == 0  # last column empty
    assert np.array_equal(p, np.argsort(flat, kind="stable"))
    blocks = torch.from_numpy(rng.standard_normal((nbrow, kmax, bm, bn)))
    u = torch.from_numpy(rng.standard_normal((nbrow, bm)))
    out = torch.zeros((nbcol, bn), dtype=torch.float64)
    for col in range(nbcol):
        for slot in p[c[col]:c[col + 1]]:
            assert flat[slot] == col
            out[col] += blocks.reshape(-1, bm, bn)[slot].T @ u[slot // kmax]
    assert rel_err(out, K.bsr_rmatvec_plain(blocks, cols, u, nbcol).numpy()) <= 1e-12


def _check_plan(plan, cols, nbcol):
    """The plan's invariants: every slot in exactly one chunk, the chunks in
    column order, none longer than ``chunk_slots``, each column's chunk
    range, and the combine pass's columns."""
    S = plan.chunk_slots
    flat = cols.reshape(-1).numpy()
    perm = plan.perm.numpy()
    ptr, ccol, colc = plan.chunk_ptr.numpy(), plan.chunk_col.numpy(), plan.col_chunk.numpy()
    assert all(t.dtype == torch.int32 for t in plan[:-1])
    assert np.array_equal(np.sort(perm), np.arange(flat.size))  # each slot once
    assert ptr[0] == 0 and ptr[-1] == flat.size and ptr.size == ccol.size + 1
    lens = np.diff(ptr)
    assert (lens >= 1).all() and (lens <= S).all()
    assert (np.diff(ccol) >= 0).all()  # column order
    for ch in range(ccol.size):
        assert (flat[perm[ptr[ch]:ptr[ch + 1]]] == ccol[ch]).all()
    counts = np.bincount(flat, minlength=nbcol)
    assert np.array_equal(np.diff(colc), -(-counts // S))
    assert np.array_equal(np.diff(colc), np.bincount(ccol, minlength=nbcol))
    assert np.array_equal(plan.combine_cols.numpy(), np.flatnonzero(np.diff(colc) != 1))
    return lens


@pytest.mark.parametrize("case", ["random", "hot", "one column"])
def test_column_plan_cuts_columns_into_chunks(rng, case):
    """K2's chunk plan. A hot column of 10^4 slots is cut into 625 chunks of
    16 (8x128 f32 blocks); an operator of more than 8192·16 slots gets longer
    chunks, so that even a single column keeps at most 8192 of them."""
    if case == "random":
        nbrow, kmax, nbcol = 13, 5, 9
        cols = rng.integers(0, nbcol - 2, (nbrow, kmax))  # the last two columns are empty
    elif case == "hot":
        nbrow, kmax, nbcol = 10_000, 3, 40
        cols = rng.integers(0, 30, (nbrow, kmax))
        cols[:, 0] = 33  # a hot column of 10^4 slots; columns 30-32, 34-39 empty
    else:
        nbrow, kmax, nbcol = 60_000, 3, 4
        cols = np.zeros((nbrow, kmax))
    cols = torch.from_numpy(cols.astype(np.int32))
    plan = K.bsr_column_plan(cols, nbcol)
    lens = _check_plan(plan, cols, nbcol)
    colc = plan.col_chunk.numpy()
    if case == "hot":
        assert plan.chunk_slots == 16
        hot = slice(colc[33], colc[34])
        assert colc[34] - colc[33] == 625 and (lens[hot] == 16).all()
        assert {30, 31, 32, 33, 34, 39} <= set(plan.combine_cols.tolist())
    if case == "one column":
        assert plan.chunk_slots == -(-nbrow * kmax // 8192) == 22
        assert colc[1] == -(-nbrow * kmax // 22) <= 8192
    # wider blocks, shorter chunks: 64 KiB of 128x128 f32 is one slot
    wide = K.bsr_column_plan(cols, nbcol, block_bytes=128 * 128 * 4)
    assert wide.chunk_slots == max(1, -(-cols.numel() // 8192))
    _check_plan(wide, cols, nbcol)


def _walk_plan(blocks, cols, u, nbcol, plan):
    """K2 walked on the CPU in f64, in the CUDA kernel's order: pass 1 sums
    each chunk's slots in plan order (a column with one chunk is written
    there), pass 2 adds the partial rows of every other column as the
    combine kernel does (warp w of 8 takes rows w, w + 8, ... in order, then
    the eight sums in warp order; a column with no chunk gets zeros)."""
    nbrow, kmax, bm, bn = blocks.shape
    flat = blocks.reshape(-1, bm, bn).double()
    u = u.double()
    perm, ptr = plan.perm.tolist(), plan.chunk_ptr.tolist()
    ccol, colc = plan.chunk_col.tolist(), plan.col_chunk.tolist()
    out = torch.zeros((nbcol, bn), dtype=torch.float64)
    written = np.zeros(nbcol, np.int64)
    partial = []
    for ch, c in enumerate(ccol):
        acc = torch.zeros(bn, dtype=torch.float64)
        for slot in perm[ptr[ch]:ptr[ch + 1]]:
            acc = acc + flat[slot].T @ u[slot // kmax]
        partial.append(acc)
        if colc[c + 1] - colc[c] == 1:
            out[c], written[c] = acc, written[c] + 1
    for c in plan.combine_cols.tolist():
        rows = partial[colc[c]:colc[c + 1]]
        warps = [sum(rows[w::8], torch.zeros(bn, dtype=torch.float64)) for w in range(8)]
        out[c], written[c] = sum(warps, torch.zeros(bn, dtype=torch.float64)), written[c] + 1
    assert (written == 1).all()  # every column written once, by one of the passes
    return out


def _hot_cols(cols, nbcol):
    """The reference data's columns with a hot column (block column 1 in every
    real block row) and two empty ones (the last two)."""
    cols = np.asarray(cols) % (nbcol - 2)
    cols[:, 0] = 1
    return cols.astype(np.int32)


@pytest.mark.parametrize("block", [(8, 32), (8, 128)])
def test_plan_walk_matches_plain_and_pallas_interpret_f32(rng, block):
    n = 1024
    _, blocks, cols = _padded_reference(rng, n, block, jnp.float32)
    bm, bn = block
    nbcol = n // bn
    cols = _hot_cols(cols, nbcol)
    ub = rng.standard_normal((blocks.shape[0], bm)).astype(np.float32)
    bt, ct = from_numpy(blocks, device="cpu"), torch.from_numpy(cols)
    for S in (16, 2):  # the 8x128 f32 plan, and one that cuts the hot column into chunks
        plan = K.bsr_column_plan(ct, nbcol, block_bytes=65536 // S)
        walked = _walk_plan(bt, ct, torch.from_numpy(ub), nbcol, plan)
        plain = K.bsr_rmatvec_plain(bt.double(), ct, torch.from_numpy(ub).double(), nbcol)
        assert rel_err(walked, plain.numpy()) <= 1e-12
        oj = bsr_rmatvec_pallas(blocks, jnp.asarray(cols), jnp.asarray(ub), nbcol, interpret=True)
        assert rel_err(walked, oj) <= 1e-5


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
def test_plan_walk_matches_pallas_interpret_bf16_blocks(rng, vec_dtype):
    n = 512
    _, blocks, cols = _padded_reference(rng, n, (8, 128), jnp.bfloat16)
    nbcol = n // 128
    cols = _hot_cols(cols, nbcol)
    ub = rng.standard_normal((blocks.shape[0], 8)).astype(np.float32)
    jdt, tdt = jnp.dtype(vec_dtype), getattr(torch, vec_dtype)
    bt = from_numpy(blocks.astype(jnp.float32), dtype=torch.bfloat16, device="cpu")
    ct, ut = torch.from_numpy(cols), torch.from_numpy(ub).to(tdt)
    plan = K.bsr_column_plan(ct, nbcol, block_bytes=65536 // 2)
    walked = _walk_plan(bt, ct, ut, nbcol, plan)
    assert rel_err(walked, K.bsr_rmatvec_plain(bt.double(), ct, ut.double(), nbcol).numpy()) <= 1e-12
    oj = bsr_rmatvec_pallas(blocks, jnp.asarray(cols), jnp.asarray(ub).astype(jdt), nbcol,
                            interpret=True)
    assert rel_err(walked, oj.astype(jnp.float32)) <= (1e-5 if vec_dtype == "float32" else 1e-2)


def test_operator_to_device_keeps_index(rng):
    op = lt.BSROperator(lt.bsr_from_dense(sprand(rng, 24, 40), (8, 16), device="cpu"))
    moved = op.to("cpu")
    assert isinstance(moved.col_plan, K.BSRColumnPlan)
    assert moved.col_plan.perm is not None and moved.device == torch.device("cpu")
    v = torch.from_numpy(rng.standard_normal(24))
    assert torch.equal(moved.T * v, op.T * v)
