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
        blocks, cols, shape = band_cluster(rng)
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
    the vector kernel per member."""
    op_t, _ = make_ops(rng, caps, plan, np.float64)
    wrapper = "bsr_rmatmat_kernel" if plan == "plain" else "bsr_rmatmat_multiwin_kernel"
    calls = spy(monkeypatch, K, wrapper)
    V = torch.from_numpy(rng.standard_normal((5, op_t.nrow)))
    Y = torch.func.vmap(lambda v: op_t.apply(v, "T"))(V)
    assert len(calls) == 1
    assert rel_err(Y, torch.stack([op_t.apply(v, "T") for v in V])) <= 1e-12
    fwd = spy(monkeypatch, TO, "bsr_matvec_kernel") if plan == "plain" else \
        spy(monkeypatch, K, "bsr_matvec_multiwin_kernel")
    X = torch.from_numpy(rng.standard_normal((5, op_t.ncol)))
    torch.func.vmap(lambda v: op_t.apply(v, "N"))(X)
    assert len(fwd) == 5 and len(calls) == 1


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
