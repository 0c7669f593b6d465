"""Block applies of the port's BSR operator (``apply_matrix``, column blocks
(n, k); ``apply_matrix_t``, row panels (k, n)) against the reference's, on
the CPU.

The reference applies a T/C/H block as ``jax.vmap`` of its vector apply,
one batched ``pallas_call`` of K2, K4 or K6 (its N block is
``bsr_matmat``). The port runs one panel transpose per block apply (K2p,
K4p, K6p on the card, their plain versions here) and ``bsr_matmat`` for N.

- Values, f64 and c128: N/T/C/H at k = 1, 3, 8, column blocks and row
  panels, on the plain, banded (``cols_local``) and multi-window plans (the
  planning caps shrunk in both packages as ``tests/test_torch_window.py``
  shrinks them), on non-symmetric, symmetric and hermitian operators,
  against the reference's ``apply_matrix`` under x64: max|Δ| ≤
  1e-10·max|ref| (f64 sums in other orders).
- Values, f32: the port's plain panels against the reference's vmapped
  Pallas K2/K4/K6 in interpret mode, 1e-5 (f32 accumulation in other
  orders), and column j against the port's vector transpose of column j.
- Structure: one plain panel call per block apply and no vector transpose,
  where the reference's jaxpr of the same call holds one ``pallas_call``.
- Gradients in the blocks and in M, through ``KernelApply`` (the kernel
  branch forced on the CPU, as ``tests/test_torch_ad.py`` forces it),
  against the reference's vmapped apply under ``jax.vjp`` in torch's
  convention (``conj(jax_vjp(conj(g)))``), 1e-10 in f64.
- ``torch.func.vmap`` of a T vector apply runs the panel once.
- A one-column T block of the column plan takes K2 (the vector kernel), the
  window plans their panels; the column tile and the staging path the
  card's panel transposes take (``transpose_panel_tile``,
  ``transpose_panel_path``).

The forward panels (K1p, K3p, K5p on the card; here their plain versions:
``bsr_matmat`` and the K3/K5 plain versions on a panel) serve the N block
on the card, a symmetric (hermitian) operator's T (H) block, whose
reference is ``jax.vmap`` of its forward kernel, and ``torch.func.vmap`` of
an N apply:

- values of symmetric and hermitian operators on every plan, f64 and c128
  at 1e-10 (a square band + far cluster pattern for the multi-window plan);
  f32 against the reference's vmapped Pallas K1/K3/K5 in interpret mode,
  whose jaxpr holds one ``pallas_call``, at 1e-5, one plain forward panel
  per block apply;
- one forward wrapper call per N block, symmetric T block, row panel and N
  vmap on the kernel branch, and no vector kernel;
- gradients of the N and symmetric T blocks in the blocks and in M against
  the reference's, on the windowed plans too (the blocks' gradient weighs
  each slot as the plan's forward reads it), and gradcheck of the node;
- each plain forward panel's column j its vector plain version's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu.kernels.bsr_spmv as BK
import linops_tpu_torch as lt
from linops_tpu.sparse.formats import BSR as JBSR
from linops_tpu.sparse.formats import bsr_from_dense as jax_bsr_from_dense
from linops_tpu.sparse.ops import BSROperator as JBSROperator
from linops_tpu_torch.core.ad import KernelApply
from linops_tpu_torch.kernels import bsr_spmv as K
from linops_tpu_torch.sparse import ops as TO
from test_torch_window import band_cluster, banded

MODES = ("N", "T", "C", "H")
KS = (1, 3, 8)
PLANS = ("plain", "banded", "multi")


def host(a):
    return a.detach().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def rel_err(got, ref) -> float:
    got, ref = host(got).astype(np.complex128), host(ref).astype(np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def jax_vjp(f, primal, g):
    """conj(jax_vjp(conj(g))): the reference's pullback in torch's convention."""
    _, pull = jax.vjp(f, primal)
    return np.conj(np.asarray(pull(jnp.conj(jnp.asarray(g)))[0]))


@pytest.fixture
def caps(monkeypatch):
    """Set the planning caps of both packages to the same values."""
    def set_caps(window_blocks=None, tile=None):
        for mod in (BK, K):
            monkeypatch.setattr(mod, "BSR_PALLAS_MAX_X_ELEMS", 2048)
            if window_blocks is not None:
                monkeypatch.setattr(mod, "BSR_PALLAS_MAX_WINDOW_BLOCKS", window_blocks)
            if tile is not None:
                monkeypatch.setattr(mod, "_TILE_BYTES_TARGET", tile)
    return set_caps


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """The BSR kernel branch on CPU tensors: the wrappers, KernelApply
    included, take their plain versions (what a CUDA tensor runs, minus the
    launch)."""
    monkeypatch.setattr(TO.BSROperator, "_use_kernel", lambda self, v: self._backend != "torch")


def sprand(rng, m, n, density=0.25, complex_=False):
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
    return A * (rng.random((m, n)) < density)


def make_ops(rng, caps, plan, dtype, **flags):
    """(port operator, reference operator) on the same data. ``plain``: a
    60x100 (square 96x96 with a symmetry flag) matrix in 8x16 blocks, rows
    and columns padded; ``banded``/``multi``: the banded and band + far
    cluster patterns of ``tests/test_torch_window.py`` in 8x128 blocks,
    planned by both packages (the reference plans no complex window)."""
    cplx = np.dtype(dtype).kind == "c"
    if plan == "plain":
        A = sprand(rng, *((96, 96) if flags else (60, 100)), complex_=cplx).astype(dtype)
        if flags:
            A = A + (A.conj().T if flags.get("hermitian") else A.T)
        op_j = lo.BSROperator(jax_bsr_from_dense(A, (8, 16)), backend="xla", **flags)
        return lt.BSROperator(lt.bsr_from_dense(A, (8, 16), device="cpu"), **flags), op_j
    if plan == "banded":
        caps()
        blocks, cols, shape = banded(rng, n=24 * 128, slope=21)
    else:
        caps(window_blocks=16, tile=65536)
        blocks, cols, shape = square_multi(rng) if flags else band_cluster(rng)
    blocks = blocks.astype(dtype)
    if cplx:
        blocks = blocks + 1j * rng.standard_normal(blocks.shape)
    op_j = JBSROperator(JBSR(jnp.asarray(blocks), jnp.asarray(cols), shape), backend="pallas",
                        **flags)
    op_t = lt.BSROperator(lt.BSR(torch.from_numpy(blocks), torch.from_numpy(cols), shape),
                          **flags)
    assert op_t.win_q is not None and (op_t.cols_local is None) == (plan == "multi")
    assert plan == "banded" or op_t.win_q_t is not None
    return op_t, op_j


def square_multi(rng, nbcol=32, kmax=4):
    """A square band + far cluster pattern (8x128 blocks, groups of 16 block
    rows): a 3-wide band sliding over [0, 23] and block column 30, which one
    group skips; multi-window planned under ``caps(16, 65536)``."""
    nbrow = nbcol * 16
    cols = np.zeros((nbrow, kmax), np.int32)
    for bi in range(nbrow):
        g = bi // 16
        band = g * 22 // nbcol
        cols[bi] = list(range(band, band + kmax - 1)) + [30 if g != 2 else band + kmax - 1]
    blocks = rng.standard_normal((nbrow, kmax, 8, 128)).astype(np.float32)
    return blocks, cols, (nbrow * 8, nbrow * 8)


def block_input(rng, op, mode, k, dtype):
    M = rng.standard_normal((op.in_dim(mode), k))
    if np.dtype(dtype).kind == "c":
        M = M + 1j * rng.standard_normal(M.shape)
    return M.astype(dtype)


def check_block_values(rng, op_t, op_j, dtype, tol):
    """Every mode: the reference's block at k = 8, once; the port's column
    blocks and row panels at k = 1, 3, 8 against its first k columns."""
    for mode in MODES:
        M = block_input(rng, op_t, mode, max(KS), dtype)
        ref = np.asarray(op_j.apply_matrix(jnp.asarray(M), mode))
        for k in KS:
            Y = op_t.apply_matrix(torch.from_numpy(M[:, :k]), mode)
            Yt = op_t.apply_matrix_t(torch.from_numpy(M[:, :k].T.copy()), mode)
            assert tuple(Y.shape) == (op_t.out_dim(mode), k) and Y.dtype == Yt.dtype
            assert rel_err(Y, ref[:, :k]) <= tol, (mode, k)
            assert rel_err(Yt.t(), ref[:, :k]) <= tol, (mode, k, "rows")


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("plan", PLANS)
def test_block_values_match_reference(rng, caps, plan, dtype):
    op_t, op_j = make_ops(rng, caps, plan, dtype)
    check_block_values(rng, op_t, op_j, dtype, 1e-10)


@pytest.mark.parametrize("plan,flags,dtype", [
    ("plain", dict(symmetric=True), np.float64),
    ("plain", dict(hermitian=True), np.complex128),
    ("plain", dict(symmetric=True), np.complex128),
    ("banded", dict(symmetric=True), np.float64),
])
def test_symmetric_and_hermitian_blocks(rng, caps, monkeypatch, plan, flags, dtype):
    """A symmetric (hermitian) operator's T (H) block is its N block, as
    ``apply`` maps the modes in both packages: no transpose runs for it;
    its other transposed mode runs one panel transpose."""
    op_t, op_j = make_ops(rng, caps, plan, dtype, **flags)
    check_block_values(rng, op_t, op_j, dtype, 1e-10)
    panel = "bsr_rmatmat_plain" if plan == "plain" else "bsr_rmatmat_windowed_plain"
    calls = spy(monkeypatch, K, panel)
    folded = "T" if flags.get("symmetric") else "H"
    M = torch.from_numpy(block_input(rng, op_t, folded, 3, dtype))
    op_t.apply_matrix(M, folded)
    op_t.apply_matrix_t(M.t(), folded)
    assert calls == []
    op_t.apply_matrix(M, "H" if folded == "T" else "T")
    assert len(calls) == 1


def spy(monkeypatch, module, name):
    """Record each call of ``module.name`` (then run it)."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


PANEL_PLAIN = {"plain": "bsr_rmatmat_plain", "banded": "bsr_rmatmat_windowed_plain",
               "multi": "bsr_rmatmat_multiwin_plain"}
VECTOR_PLAIN = ("bsr_rmatvec_plain", "bsr_rmatvec_windowed_plain", "bsr_rmatvec_multiwin_plain")


def f32_ops(rng, caps, plan):
    """f32 operators for the interpret-mode comparison: the plain plan at
    the shape of the reference's own check (256², 8x128 blocks, Pallas K2)."""
    if plan == "plain":
        A = sprand(rng, 256, 256, 0.1).astype(np.float32)
        op_j = lo.BSROperator(jax_bsr_from_dense(A, (8, 128)), backend="pallas")
        return lt.BSROperator(lt.bsr_from_dense(A, (8, 128), device="cpu")), op_j
    return make_ops(rng, caps, plan, np.float32)


@pytest.mark.parametrize("plan", PLANS)
def test_f32_panels_match_pallas_interpret(rng, caps, monkeypatch, plan):
    """The port's plain panel (T and H blocks, k = 5) against the reference's
    vmapped Pallas kernel in interpret mode, whose jaxpr holds one
    ``pallas_call``; the port runs one plain panel and no vector transpose;
    column j against the port's vector T apply of column j."""
    op_t, op_j = f32_ops(rng, caps, plan)
    M = block_input(rng, op_t, "T", 5, np.float32)
    jaxpr = str(jax.make_jaxpr(lambda M_: op_j.apply_matrix(M_, "T"))(jnp.asarray(M)))
    assert jaxpr.count("pallas_call") == 1
    ref = np.asarray(op_j.apply_matrix(jnp.asarray(M), "T"))
    calls = spy(monkeypatch, K, PANEL_PLAIN[plan])
    vec = [spy(monkeypatch, K, name) for name in VECTOR_PLAIN]
    monkeypatch.setattr(TO, "bsr_rmatvec", K.bsr_rmatvec_plain)  # the name ops imported
    Y = op_t.apply_matrix(torch.from_numpy(M), "T")
    Yh = op_t.apply_matrix_t(torch.from_numpy(M.T.copy()), "H")
    assert len(calls) == 2 and not any(vec)
    assert Y.dtype == torch.float32
    assert rel_err(Y, ref) <= 1e-5 and rel_err(Yh.t(), ref) <= 1e-5
    cols = torch.stack([op_t.apply(torch.from_numpy(M[:, j].copy()), "T") for j in range(5)], 1)
    assert rel_err(Y, cols) <= 1e-6


@pytest.mark.parametrize("plan", PLANS)
def test_one_panel_launch_per_block_apply(rng, caps, monkeypatch, kernels_on_cpu, plan):
    """On the kernel branch: a T block, an H row panel and an adjoint
    node's N block (which hands its parent a T block) each call the plan's
    panel wrapper once and no vector wrapper; an N block calls none."""
    op_t, _ = make_ops(rng, caps, plan, np.float64)
    wrapper = {"plain": "bsr_rmatmat_kernel", "banded": "bsr_rmatmat_windowed_kernel",
               "multi": "bsr_rmatmat_multiwin_kernel"}[plan]
    calls = spy(monkeypatch, K, wrapper)
    vec = [spy(monkeypatch, K, name) for name in
           ("bsr_rmatvec_kernel", "bsr_rmatvec_windowed_kernel", "bsr_rmatvec_multiwin_kernel")]
    monkeypatch.setattr(TO, "bsr_rmatvec_kernel", K.bsr_rmatvec_kernel)
    M = torch.from_numpy(block_input(rng, op_t, "T", 6, np.float64))
    ref = op_t.apply_matrix(M, "T")
    assert len(calls) == 1
    assert torch.equal(op_t.apply_matrix_t(M.t(), "H"), ref.t()) and len(calls) == 2
    assert torch.equal(op_t.T.apply_matrix(M, "N"), ref) and len(calls) == 3
    op_t.apply_matrix(torch.from_numpy(block_input(rng, op_t, "N", 6, np.float64)), "N")
    assert len(calls) == 3 and not any(vec)
    cols = torch.stack([op_t.apply(M[:, j], "T") for j in range(6)], 1)
    assert rel_err(ref, cols) <= 1e-12


@pytest.mark.parametrize("plan", PLANS)
def test_block_gradients_match_reference(rng, caps, kernels_on_cpu, plan):
    """x (M) and block gradients of a T block apply, column and row forms,
    through the panel node (its backward: the N block for M, Σ_j u ⊗ x for
    the blocks) against the reference's vmapped apply; the plain plan also
    in N, and complex blocks (plain autograd) in H."""
    cases = [(np.float64, ("T", "N") if plan == "plain" else ("T",))]
    if plan == "plain":
        cases.append((np.complex128, ("H",)))
    for dtype, modes in cases:
        op_t, op_j = make_ops(rng, caps, plan, dtype)
        leaf = op_t.data.blocks.requires_grad_(True)
        leaf_j = op_j.data.blocks
        leaves, tdef = jax.tree_util.tree_flatten(op_j)
        at = next(i for i, v in enumerate(leaves) if v is leaf_j)

        def with_blocks(b, M_, mode):
            ls = list(leaves)
            ls[at] = b
            return jax.tree_util.tree_unflatten(tdef, ls).apply_matrix(M_, mode)

        for mode in modes:
            M = block_input(rng, op_t, mode, 3, dtype)
            G = block_input(rng, op_t, "T" if mode == "N" else "N", 3, dtype)
            Mt = torch.from_numpy(M).requires_grad_(True)
            Y = op_t.apply_matrix(Mt, mode)
            if dtype == np.float64 and mode != "N":
                assert type(Y.grad_fn).__name__ == "KernelApplyBackward"
            gM, gB = torch.autograd.grad(Y, (Mt, leaf), torch.from_numpy(G))
            ref_M = jax_vjp(lambda M_: op_j.apply_matrix(M_, mode), jnp.asarray(M), G)
            ref_B = jax_vjp(lambda b: with_blocks(b, jnp.asarray(M), mode), leaf_j, G)
            assert rel_err(gM, ref_M) <= 1e-10 and rel_err(gB, ref_B) <= 1e-10, mode
            Mr = torch.from_numpy(M.T.copy()).requires_grad_(True)
            gMr, gBr = torch.autograd.grad(op_t.apply_matrix_t(Mr, mode), (Mr, leaf),
                                           torch.from_numpy(G.T.copy()))
            assert rel_err(gMr.t(), ref_M) <= 1e-10 and rel_err(gBr, ref_B) <= 1e-10, mode


@pytest.mark.parametrize("kind", ["mat", "panel"])
def test_panel_node_gradcheck(rng, kind):
    """gradcheck and gradgradcheck of the panel node in x and blocks (a
    padded operator; the plain K2p and N block inside)."""
    op = lt.BSROperator(lt.bsr_from_dense(sprand(rng, 10, 13, 0.4), (4, 4), device="cpu"))
    blocks = op.data.blocks.clone().requires_grad_(True)
    X = torch.from_numpy(rng.standard_normal((10, 2) if kind == "mat" else (2, 10)))
    X.requires_grad_(True)

    def f(x_, b_):
        return KernelApply.apply(op, ("T", kind), x_, b_)

    assert torch.autograd.gradcheck(f, (X, blocks))
    assert torch.autograd.gradgradcheck(f, (X, blocks))


@pytest.mark.parametrize("plan", ["plain", "multi"])
def test_vmap_of_a_transpose_runs_the_panel_once(rng, caps, monkeypatch, kernels_on_cpu, plan):
    """``torch.func.vmap`` of a T vector apply takes the panel kind once
    (the reference's vmap is one batched ``pallas_call``); of an N apply,
    the forward panel once and no vector kernel."""
    op_t, _ = make_ops(rng, caps, plan, np.float64)
    wrapper = "bsr_rmatmat_kernel" if plan == "plain" else "bsr_rmatmat_multiwin_kernel"
    calls = spy(monkeypatch, K, wrapper)
    V = torch.from_numpy(rng.standard_normal((5, op_t.nrow)))
    Y = torch.func.vmap(lambda v: op_t.apply(v, "T"))(V)
    assert len(calls) == 1
    assert rel_err(Y, torch.stack([op_t.apply(v, "T") for v in V])) <= 1e-12
    fwd = spy(monkeypatch, TO, "bsr_matvec_kernel") if plan == "plain" else \
        spy(monkeypatch, K, "bsr_matvec_multiwin_kernel")
    panel = spy(monkeypatch, K, "bsr_matmat_kernel" if plan == "plain" else
                "bsr_matmat_multiwin_kernel")
    X = torch.from_numpy(rng.standard_normal((5, op_t.ncol)))
    Y = torch.func.vmap(lambda v: op_t.apply(v, "N"))(X)
    assert len(fwd) == 0 and len(panel) == 1 and len(calls) == 1
    assert rel_err(Y, torch.stack([op_t.apply(v, "N") for v in X])) <= 1e-12


def test_panel_plain_versions_equal_their_column_loops(rng, caps):
    """Each plain panel's column j equals its vector plain version of column
    j (f64, 1e-12); a row panel's transposed view gives the same values;
    a width-0 panel gives an empty result."""
    caps(window_blocks=16, tile=65536)
    blocks, cols, shape = band_cluster(rng)
    op = lt.BSROperator(lt.BSR(torch.from_numpy(blocks).double(), torch.from_numpy(cols), shape))
    d, nbcol = op.data, shape[1] // 128
    U = torch.from_numpy(rng.standard_normal((blocks.shape[0] * 8, 4)))
    mw = dict(wb=op._wb, x_pad_blocks=op._x_pad_blocks_t, nbcol=nbcol)
    args = (d.blocks, d.block_cols, op.win_q_t, op.win_valid_t)
    P = K.bsr_rmatmat_multiwin_kernel(*args, U, **mw)
    Pr = K.bsr_rmatmat_multiwin_kernel(*args, U.t().contiguous().t(), **mw)
    assert torch.equal(P, Pr)
    Q = K.bsr_rmatmat_kernel(d.blocks, d.block_cols, U, nbcol)
    for j in range(4):
        u = U[:, j].reshape(-1, 8)
        assert rel_err(P[:, j], K.bsr_rmatvec_multiwin_plain(*args, u, **mw).reshape(-1)) <= 1e-12
        assert rel_err(Q[:, j], K.bsr_rmatvec_plain(d.blocks, d.block_cols, u, nbcol)
                       .reshape(-1)) <= 1e-12
    assert K.bsr_rmatmat_kernel(d.blocks, d.block_cols, U[:, :0], nbcol).shape == (nbcol * 128, 0)


def test_panel_wrappers_have_no_kernel_off_cuda():
    """A panel wrapper given tensors on a device with no kernel raises
    (there is no fallback to the plain version but on the CPU)."""
    blocks = torch.zeros((2, 1, 4, 8), device="meta")
    cols = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    U = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.bsr_rmatmat_kernel(blocks, cols, U, 1)


@pytest.mark.parametrize("plan", PLANS)
def test_one_column_transpose_block_takes_the_vector_kernel(rng, caps, monkeypatch,
                                                           kernels_on_cpu, plan):
    """On the kernel branch a one-column T block (and an H row panel of one
    row) calls its plan's vector wrapper (K2, K4 or K6), bit for bit the
    vector apply, and no panel wrapper (the panels are slower than their
    vector kernels for one column on the card); k = 2 takes the panel on
    every plan."""
    op_t, _ = make_ops(rng, caps, plan, np.float64)
    panel = spy(monkeypatch, K, {"plain": "bsr_rmatmat_kernel",
                                 "banded": "bsr_rmatmat_windowed_kernel",
                                 "multi": "bsr_rmatmat_multiwin_kernel"}[plan])
    vector = spy(monkeypatch, K, {"plain": "bsr_rmatvec_kernel",
                                  "banded": "bsr_rmatvec_windowed_kernel",
                                  "multi": "bsr_rmatvec_multiwin_kernel"}[plan])
    monkeypatch.setattr(TO, "bsr_rmatvec_kernel", K.bsr_rmatvec_kernel)
    M = torch.from_numpy(block_input(rng, op_t, "T", 2, np.float64))
    Y = op_t.apply_matrix(M[:, :1], "T")
    Yh = op_t.apply_matrix_t(M[:, :1].t(), "H")
    assert len(panel) == 0 and len(vector) == 2
    assert torch.equal(Y[:, 0], op_t.apply(M[:, 0], "T")) and torch.equal(Yh, Y.t())
    op_t.apply_matrix(M, "T")
    assert len(panel) == 1 and len(vector) == 3


def test_transpose_panel_tile_and_path():
    """The column tile K2p, K4p and K6p take (8 columns for k <= 8, else 16)
    and the staging they run: bulk copies when a row
    of bn values is a multiple of 16 bytes on a 16-byte aligned base, else
    the ragged path's plain loads."""
    assert [K.transpose_panel_tile(k) for k in (1, 8, 9, 12, 16, 17, 32)] == [8, 8, 16, 16, 16,
                                                                               16, 16]
    f32 = torch.zeros((2, 3, 8, 128))
    assert K.transpose_panel_path(f32) == "ring"
    assert K.transpose_panel_path(torch.zeros((2, 3, 8, 12), dtype=torch.bfloat16)) == "ragged"
    assert K.transpose_panel_path(torch.zeros((2, 3, 8, 8), dtype=torch.bfloat16)) == "ring"
    assert K.transpose_panel_path(torch.zeros((2, 3, 8, 33))) == "ragged"
    shifted = torch.zeros(2 * 3 * 8 * 128 + 1)[1:].view(2, 3, 8, 128)
    assert K.transpose_panel_path(shifted) == "ragged"


# ---------------------------------------------------------------------------
# The forward panels (K1p, K3p, K5p)
# ---------------------------------------------------------------------------

# the plain forward of each plan, as ``BSROperator`` calls it off the card
# (the plain plan's is the name ops imported)
FWD_PLAIN = {"plain": (TO, "bsr_matmat"), "banded": (K, "bsr_matvec_windowed_plain"),
             "multi": (K, "bsr_matvec_multiwin_plain")}
FWD_WRAPPER = {"plain": "bsr_matmat_kernel", "banded": "bsr_matmat_windowed_kernel",
               "multi": "bsr_matmat_multiwin_kernel"}
FWD_VECTOR = ((TO, "bsr_matvec_kernel"), (K, "bsr_matvec_windowed_kernel"),
              (K, "bsr_matvec_multiwin_kernel"))
PANEL_WRAPPERS = ("bsr_rmatmat_kernel", "bsr_rmatmat_windowed_kernel",
                  "bsr_rmatmat_multiwin_kernel")


@pytest.mark.parametrize("plan,flags,dtype", [
    ("plain", dict(symmetric=True), np.float64),
    ("plain", dict(hermitian=True), np.complex128),
    ("banded", dict(symmetric=True), np.float64),
    ("multi", dict(symmetric=True), np.float64),
])
def test_symmetric_blocks_run_the_forward_panel(rng, caps, monkeypatch, plan, flags, dtype):
    """A symmetric (hermitian) operator's blocks in every mode against the
    reference's at 1e-10, the multi-window plan included; its T (H) block,
    column and row forms, is one pass of the plan's plain forward on the
    panel and no transpose."""
    op_t, op_j = make_ops(rng, caps, plan, dtype, **flags)
    assert (op_t.win_q is not None) == (plan != "plain")
    check_block_values(rng, op_t, op_j, dtype, 1e-10)
    mod, name = FWD_PLAIN[plan]
    calls = spy(monkeypatch, mod, name)
    panels = [spy(monkeypatch, K, n_) for n_ in PANEL_PLAIN.values()]
    folded = "T" if flags.get("symmetric") else "H"
    M = torch.from_numpy(block_input(rng, op_t, folded, 5, dtype))
    Y = op_t.apply_matrix(M, folded)
    assert len(calls) == 1
    assert torch.equal(op_t.apply_matrix_t(M.t(), folded), Y.t()) and len(calls) == 2
    assert not any(panels)


def f32_symmetric_ops(rng, caps, plan):
    """Symmetric f32 operators for the interpret-mode comparison of the
    forward: the plain plan a symmetric 256² matrix in 8x128 blocks (Pallas
    K1), the window plans as ``make_ops`` makes them (K3, K5)."""
    if plan == "plain":
        A = sprand(rng, 256, 256, 0.1)
        A = (A + A.T).astype(np.float32)
        op_j = lo.BSROperator(jax_bsr_from_dense(A, (8, 128)), backend="pallas", symmetric=True)
        return lt.BSROperator(lt.bsr_from_dense(A, (8, 128), device="cpu"), symmetric=True), op_j
    return make_ops(rng, caps, plan, np.float32, symmetric=True)


@pytest.mark.parametrize("plan", PLANS)
def test_f32_forward_panels_match_pallas_interpret(rng, caps, monkeypatch, plan):
    """A symmetric operator's T block (k = 5): the reference's vmapped Pallas
    forward in interpret mode, one ``pallas_call`` in its jaxpr; the port's
    one plain forward panel within 1e-5 of it (f32 sums in other orders),
    column j within 1e-6 of the port's vector N apply of column j."""
    op_t, op_j = f32_symmetric_ops(rng, caps, plan)
    M = block_input(rng, op_t, "T", 5, np.float32)
    jaxpr = str(jax.make_jaxpr(lambda M_: op_j.apply_matrix(M_, "T"))(jnp.asarray(M)))
    assert jaxpr.count("pallas_call") == 1
    ref = np.asarray(op_j.apply_matrix(jnp.asarray(M), "T"))
    mod, name = FWD_PLAIN[plan]
    calls = spy(monkeypatch, mod, name)
    Y = op_t.apply_matrix(torch.from_numpy(M), "T")
    assert len(calls) == 1 and Y.dtype == torch.float32
    assert rel_err(Y, ref) <= 1e-5
    cols = torch.stack([op_t.apply(torch.from_numpy(M[:, j].copy()), "N") for j in range(5)], 1)
    assert rel_err(Y, cols) <= 1e-6


@pytest.mark.parametrize("plan", PLANS)
def test_one_forward_panel_per_block_apply(rng, caps, monkeypatch, kernels_on_cpu, plan):
    """On the kernel branch: an N block, an N row panel, a symmetric
    operator's T block and ``torch.func.vmap`` of its N and T vector applies
    each call the plan's forward panel wrapper once, and no vector kernel
    and no panel transpose."""
    op_t, _ = make_ops(rng, caps, plan, np.float64, symmetric=True)
    calls = spy(monkeypatch, K, FWD_WRAPPER[plan])
    vec = [spy(monkeypatch, m_, n_) for m_, n_ in FWD_VECTOR]
    panels = [spy(monkeypatch, K, n_) for n_ in PANEL_WRAPPERS]
    M = torch.from_numpy(block_input(rng, op_t, "N", 6, np.float64))
    Y = op_t.apply_matrix(M, "N")
    assert len(calls) == 1
    assert torch.equal(op_t.apply_matrix_t(M.t(), "N"), Y.t()) and len(calls) == 2
    assert torch.equal(op_t.apply_matrix(M, "T"), Y) and len(calls) == 3
    V = torch.func.vmap(lambda v: op_t.apply(v, "N"))(M.t())
    assert torch.equal(V, Y.t()) and len(calls) == 4
    Vt = torch.func.vmap(lambda v: op_t.apply(v, "T"))(M.t())
    assert torch.equal(Vt, Y.t()) and len(calls) == 5
    assert not any(vec) and not any(panels)
    cols = torch.stack([op_t.apply(M[:, j], "N") for j in range(6)], 1)
    assert rel_err(Y, cols) <= 1e-12


@pytest.mark.parametrize("plan", PLANS)
def test_forward_block_gradients_match_reference(rng, caps, kernels_on_cpu, plan):
    """M and block gradients of a symmetric operator's N and T blocks,
    column and row forms, through the forward panel node (its backward: the
    T panel for M, Σ_j g ⊗ x over the slots the plan reads for the blocks)
    against the reference's vmapped apply under ``jax.vjp``, 1e-10."""
    op_t, op_j = make_ops(rng, caps, plan, np.float64, symmetric=True)
    leaf = op_t.data.blocks.requires_grad_(True)
    leaf_j = op_j.data.blocks
    leaves, tdef = jax.tree_util.tree_flatten(op_j)
    at = next(i for i, v in enumerate(leaves) if v is leaf_j)

    def with_blocks(b, M_, mode):
        ls = list(leaves)
        ls[at] = b
        return jax.tree_util.tree_unflatten(tdef, ls).apply_matrix(M_, mode)

    for mode in ("N", "T"):
        M = block_input(rng, op_t, mode, 3, np.float64)
        G = block_input(rng, op_t, "T" if mode == "N" else "N", 3, np.float64)
        Mt = torch.from_numpy(M).requires_grad_(True)
        Y = op_t.apply_matrix(Mt, mode)
        assert type(Y.grad_fn).__name__ == "KernelApplyBackward"
        gM, gB = torch.autograd.grad(Y, (Mt, leaf), torch.from_numpy(G))
        ref_M = jax_vjp(lambda M_: op_j.apply_matrix(M_, mode), jnp.asarray(M), G)
        ref_B = jax_vjp(lambda b: with_blocks(b, jnp.asarray(M), mode), leaf_j, G)
        assert rel_err(gM, ref_M) <= 1e-10 and rel_err(gB, ref_B) <= 1e-10, mode
        Mr = torch.from_numpy(M.T.copy()).requires_grad_(True)
        gMr, gBr = torch.autograd.grad(op_t.apply_matrix_t(Mr, mode), (Mr, leaf),
                                       torch.from_numpy(G.T.copy()))
        assert rel_err(gMr.t(), ref_M) <= 1e-10 and rel_err(gBr, ref_B) <= 1e-10, mode


@pytest.mark.parametrize("kind", ["mat", "panel"])
def test_forward_panel_node_gradcheck(rng, kind):
    """gradcheck and gradgradcheck of the forward panel node in x and blocks
    (a padded operator; the plain K1p and T panel inside)."""
    op = lt.BSROperator(lt.bsr_from_dense(sprand(rng, 10, 13, 0.4), (4, 4), device="cpu"))
    blocks = op.data.blocks.clone().requires_grad_(True)
    X = torch.from_numpy(rng.standard_normal((13, 2) if kind == "mat" else (2, 13)))
    X.requires_grad_(True)

    def f(x_, b_):
        return KernelApply.apply(op, ("N", kind), x_, b_)

    assert torch.autograd.gradcheck(f, (X, blocks))
    assert torch.autograd.gradgradcheck(f, (X, blocks))


def test_forward_plain_panels_equal_their_column_loops(rng, caps):
    """Each forward wrapper's plain version (CPU tensors) gives column j of
    its vector plain version of column j (f64, 1e-12), the same values
    through a row panel's view, and an empty result for a width-0 panel."""
    caps(window_blocks=16, tile=65536)
    blocks, cols, shape = band_cluster(rng)
    op = lt.BSROperator(lt.BSR(torch.from_numpy(blocks).double(), torch.from_numpy(cols), shape))
    caps()
    blocks_b, cols_b, shape_b = banded(rng, n=24 * 128, slope=21)
    op_b = lt.BSROperator(lt.BSR(torch.from_numpy(blocks_b).double(), torch.from_numpy(cols_b),
                                 shape_b))
    assert op.cols_local is None and op_b.cols_local is not None
    cases = []
    for o in (op, op_b):
        d = o.data
        plan = dict(wb=o._wb, x_pad_blocks=o._x_pad_blocks)
        if o.cols_local is None:
            args = (d.blocks, d.block_cols, o.win_q)
            cases.append((lambda X, a=args, p=plan: K.bsr_matmat_multiwin_kernel(*a, X, **p),
                          lambda x, a=args, p=plan: K.bsr_matvec_multiwin_plain(*a, x, **p), o))
        else:
            args = (d.blocks, o.cols_local, o.win_q)
            cases.append((lambda X, a=args, p=plan: K.bsr_matmat_windowed_kernel(*a, X, **p),
                          lambda x, a=args, p=plan: K.bsr_matvec_windowed_plain(*a, x, **p), o))
        cases.append((lambda X, d=d: K.bsr_matmat_kernel(d.blocks, d.block_cols, X),
                      lambda x, d=d: K.bsr_matvec_plain(d.blocks, d.block_cols, x), o))
    for panel, vector, o in cases:
        X = torch.from_numpy(rng.standard_normal((o.ncol, 4)))
        P = panel(X)
        assert P.shape == (o.data.blocks.shape[0] * 8, 4)
        assert torch.equal(P, panel(X.t().contiguous().t()))
        for j in range(4):
            y = vector(X[:, j].reshape(-1, 128)).reshape(-1)
            assert rel_err(P[:, j], y) <= 1e-12, j
        assert panel(X[:, :0]).shape == (o.data.blocks.shape[0] * 8, 0)


def test_forward_wrappers_have_no_kernel_off_cuda():
    """A forward panel wrapper given tensors on a device with no kernel
    raises (no fallback to the plain version but on the CPU)."""
    blocks = torch.zeros((2, 1, 4, 8), device="meta")
    cols = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    X = torch.zeros((8, 3), device="meta")
    q = torch.zeros((1,), dtype=torch.int32, device="meta")
    for call in (lambda: K.bsr_matmat_kernel(blocks, cols, X),
                 lambda: K.bsr_matmat_windowed_kernel(blocks, cols, q, X, wb=8, x_pad_blocks=16),
                 lambda: K.bsr_matmat_multiwin_kernel(blocks, cols, q[None], X, wb=8,
                                                      x_pad_blocks=16)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
