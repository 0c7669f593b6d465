"""AD in the port (``linops_tpu_torch/core/ad.py``) against the JAX
reference, on the CPU in f64.

Mirrors ``tests/test_ad.py`` (its 8 tests: gradients through the operator
graph, ``jvp``, gradients with respect to operator data, ``apply_linear``),
then adds what the port must also carry:

- x- and data-gradients through BSR (the plain K1/K2 and, with a forced
  window plan, the plain K3-K6), CSR, COO, ELL, routed (x and the program's
  values), ``opPermutation`` and the RCM sandwich, in every mode, real and
  complex;
- ``KernelApply``, the autograd node of a kernel branch, driven by the plain
  products on the CPU: ``gradcheck`` and ``gradgradcheck`` for x and blocks,
  and the operators' kernel branches forced on the CPU (the kernels' wrappers
  take their plain versions there) against plain autograd;
- the implicit backward of ``opIterativeInverse`` (the gradient part of
  ``tests/test_linalg_ops.py:205-240``) for x and operator data in modes
  N/T/H, against ``jax.grad`` and against the dense solve's gradient.

Convention: torch's cotangents are conjugate-Wirtinger. For a map linear in
an input, ``torch.autograd.grad(y, input, g)`` is ``conj(jax_vjp(conj(g)))``;
for a real-valued loss, torch's gradient is the conjugate of ``jax.grad``'s.
The comparisons go through that rule at rtol 1e-10 (a solve: 1e-8, set by
its tolerance), never a looser one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu.kernels.bsr_spmv as BK
import linops_tpu_torch as lt
from helpers import assert_close, simple_matrix
from linops_tpu.sparse.formats import BSR as JBSR
from linops_tpu.sparse.ops import BSROperator as JBSROperator
from linops_tpu_torch.core.ad import KernelApply, apply_linear
from linops_tpu_torch.kernels import bsr_spmv as K
from linops_tpu_torch.ops import permutation as TP
from linops_tpu_torch.sparse import ops as TO
from linops_tpu_torch.sparse import routed as TR

RTOL = 1e-10
MODES = ("N", "T", "C", "H")
CPU = dict(device="cpu")


def host(a):
    return a.detach().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, ref, rtol=RTOL):
    got, ref = host(got), host(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def rvec(rng, n, complex_=False):
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if complex_ else v


def t_(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def jax_vjp(f, primal, g):
    """conj(jax_vjp(conj(g))): the reference's pullback in torch's convention."""
    _, pull = jax.vjp(f, primal)
    return np.conj(np.asarray(pull(jnp.conj(jnp.asarray(g)))[0]))


def jax_leaf_vjp(op_j, leaf, apply, g):
    """The same for an operator leaf (its data), the rest of the pytree held."""
    leaves, tdef = jax.tree_util.tree_flatten(op_j)
    i = next(k for k, v in enumerate(leaves) if v is leaf)

    def f(val):
        ls = list(leaves)
        ls[i] = val
        return apply(jax.tree_util.tree_unflatten(tdef, ls))

    return jax_vjp(f, leaf, g)


# --------------------------------------------------------------------------
# test_ad.py, one to one
# --------------------------------------------------------------------------


def test_grad_matches_dense(rng):
    A = simple_matrix(np.float64, 8, 6, rng)
    x = rng.standard_normal(6)
    gj = jax.grad(lambda x_: jnp.sum(lo.LinearOperator(jnp.asarray(A)).apply(x_, "N")))(
        jnp.asarray(x))
    xt = t_(x, True)
    (gt,) = torch.autograd.grad(lt.LinearOperator(t_(A)).apply(xt, "N").sum(), xt)
    close(gt, gj)
    assert_close(gt.numpy(), A.T @ np.ones(8))


def test_grad_through_composite(rng):
    A = simple_matrix(np.float64, 6, 6, rng)
    d = rng.random(6) + 1.0
    x, w = rng.standard_normal(6), rng.standard_normal(6)
    chain_j = 2.0 * (lo.opDiagonal(jnp.asarray(d)) @ lo.LinearOperator(jnp.asarray(A))) + lo.opEye(6)
    chain_t = 2.0 * (lt.opDiagonal(t_(d)) @ lt.LinearOperator(t_(A))) + lt.opEye(6)
    gj = jax.grad(lambda x_: jnp.vdot(jnp.asarray(w), chain_j.apply(x_, "N")))(jnp.asarray(x))
    xt = t_(x, True)
    (gt,) = torch.autograd.grad(torch.dot(t_(w), chain_t.apply(xt, "N")), xt)
    close(gt, gj)
    assert_close(gt.numpy(), (2.0 * np.diag(d) @ A + np.eye(6)).T @ w)


def test_jvp_frule(rng):
    A = simple_matrix(np.float64, 7, 5, rng)
    x, dx = rng.standard_normal(5), rng.standard_normal(5)
    yj, dyj = jax.jvp(lambda x_: lo.LinearOperator(jnp.asarray(A)).apply(x_, "N"),
                      (jnp.asarray(x),), (jnp.asarray(dx),))
    op = lt.LinearOperator(t_(A))
    yt, dyt = torch.func.jvp(lambda x_: op.apply(x_, "N"), (t_(x),), (t_(dx),))
    close(yt, yj)
    close(dyt, dyj)
    assert_close(dyt.numpy(), A @ dx)


def test_grad_wrt_operator_data(rng):
    d = rng.random(5) + 1.0
    x = rng.standard_normal(5)
    gj = jax.grad(lambda d_: jnp.sum(lo.opDiagonal(d_).apply(jnp.asarray(x), "N") ** 2))(
        jnp.asarray(d))
    gt = torch.func.grad(lambda d_: (lt.opDiagonal(d_).apply(t_(x), "N") ** 2).sum())(t_(d))
    close(gt, gj)
    assert_close(gt.numpy(), 2 * d * x ** 2)


def test_apply_linear_vjp_is_adjoint(rng):
    """apply_linear: the backward is one adjoint apply and the operator's
    tensors get no gradient (the reference rrule)."""
    from linops_tpu.core.ad import apply_linear as jax_apply_linear

    A = simple_matrix(np.float64, 8, 6, rng)
    x, g = rng.standard_normal(6), rng.standard_normal(8)
    op_j = lo.LinearOperator(jnp.asarray(A))
    At = t_(A, True)
    op_t = lt.LinearOperator(At)
    xt = t_(x, True)
    y = apply_linear(op_t, xt, "N")
    dx, dA = torch.autograd.grad(y, (xt, At), t_(g), allow_unused=True)
    close(dx, jax_vjp(lambda x_: jax_apply_linear(op_j, x_, "N"), jnp.asarray(x), g))
    assert_close(dx.numpy(), A.T @ g)
    assert dA is None  # the operator is a constant
    assert lt.apply_linear is apply_linear


@pytest.mark.parametrize("mode", MODES)
def test_apply_linear_complex(rng, mode):
    """Native AD and apply_linear agree in every mode, and both are the
    reference's pullback under the conjugation rule."""
    from linops_tpu.core.ad import apply_linear as jax_apply_linear

    A = simple_matrix(np.complex128, 6, 6, rng)
    x, g = rvec(rng, 6, True), rvec(rng, 6, True)
    op_j, op_t = lo.LinearOperator(jnp.asarray(A)), lt.LinearOperator(t_(A))
    xt = t_(x, True)
    (dn,) = torch.autograd.grad(op_t.apply(xt, mode), xt, t_(g))
    (dc,) = torch.autograd.grad(apply_linear(op_t, xt, mode), xt, t_(g))
    close(dc, dn)
    close(dc, jax_vjp(lambda x_: jax_apply_linear(op_j, x_, mode), jnp.asarray(x), g))


def test_apply_linear_function_operator_uses_ctprod(rng):
    A = simple_matrix(np.float64, 6, 6, rng)
    At = t_(A)
    calls = {"t": 0}

    def tprod(u):
        calls["t"] += 1
        return At.T @ u

    op = lt.FunctionOperator(6, 6, lambda v: At @ v, tprod, dtype=torch.float64)
    g = torch.func.grad(lambda x_: apply_linear(op, x_, "N").sum())(t_(rng.standard_normal(6)))
    assert_close(g.numpy(), A.T @ np.ones(6))
    assert calls["t"] == 1  # one adjoint apply, through the user's tprod


def test_grad_through_lbfgs(rng):
    n = 10
    Hj = lo.InverseLBFGSOperator(n, mem=4)
    Ht = lt.InverseLBFGSOperator(n, mem=4, **CPU)
    for _ in range(4):
        s = rng.standard_normal(n)
        y = s + 0.1 * rng.standard_normal(n)
        Hj.push(jnp.asarray(s), jnp.asarray(y))
        Ht.push(t_(s), t_(y))
    x = rng.standard_normal(n)
    gj = jax.grad(lambda x_: jnp.sum(Hj.apply(x_, "N")))(jnp.asarray(x))
    xt = t_(x, True)
    (gt,) = torch.autograd.grad(Ht.apply(xt, "N").sum(), xt)
    close(gt, gj, rtol=1e-9)
    assert_close(gt.numpy(), np.asarray(Hj.to_dense()).T @ np.ones(n), rtol=1e-8)


# --------------------------------------------------------------------------
# Gradients through the sparse operators, against the reference
# --------------------------------------------------------------------------


def sprand(rng, m, n, density=0.25, complex_=False):
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
    return A * (rng.random((m, n)) < density)


def data_leaf(op, fmt):
    return op.data.blocks if fmt == "bsr" else op.data.vals


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", ["bsr", "csr", "coo", "ell"])
def test_sparse_gradients_match_jax(rng, fmt, mode, complex_):
    """x- and data-gradients of op(mode)·x, for every format."""
    A = sprand(rng, 30, 22, complex_=complex_)
    kw = dict(block_shape=(4, 8)) if fmt == "bsr" else {}
    op_j = lo.opSparse(A, format=fmt, backend="xla", **kw) if fmt == "bsr" else \
        lo.opSparse(A, format=fmt)
    op_t = lt.opSparse(A, format=fmt, **kw, **CPU)
    leaf_t = data_leaf(op_t, fmt).requires_grad_(True)
    n_in, n_out = op_t.in_dim(mode), op_t.out_dim(mode)
    x, g = rvec(rng, n_in, complex_), rvec(rng, n_out, complex_)
    xt = t_(x, True)
    gx, gd = torch.autograd.grad(op_t.apply(xt, mode), (xt, leaf_t), t_(g))
    close(gx, jax_vjp(lambda x_: op_j.apply(x_, mode), jnp.asarray(x), g))
    close(gd, jax_leaf_vjp(op_j, data_leaf(op_j, fmt), lambda o: o.apply(jnp.asarray(x), mode),
                           g))


@pytest.fixture
def caps(monkeypatch):
    """Both packages plan windows for small x (as tests/test_torch_window.py)."""
    def set_caps(window_blocks=None, tile=None):
        for mod in (BK, K):
            monkeypatch.setattr(mod, "BSR_PALLAS_MAX_X_ELEMS", 2048)
            if window_blocks is not None:
                monkeypatch.setattr(mod, "BSR_PALLAS_MAX_WINDOW_BLOCKS", window_blocks)
            if tile is not None:
                monkeypatch.setattr(mod, "_TILE_BYTES_TARGET", tile)
    return set_caps


def window_ops(rng, multi):
    """A banded BSR (plain K3/K4) or a band + far cluster (plain K5/K6), f64,
    in both packages with the same plan."""
    if multi:
        nbrow, kmax, nbcol = 64, 8, 64
        cols = np.zeros((nbrow, kmax), np.int32)
        for bi in range(nbrow):
            g = bi // 16
            cols[bi] = sorted(list(range(g * 3, g * 3 + kmax - 1)) + [56 if g != 2 else g * 3 + 7])
        shape = (nbrow * 8, nbcol * 128)
    else:
        n = 40 * 128
        j0 = (np.arange(n // 8) * 37 / (n // 8)).astype(np.int64)
        cols = (j0[:, None] + np.arange(3)[None]).astype(np.int32)
        shape = (n, n)
    blocks = rng.standard_normal(cols.shape + (8, 128))
    op_j = JBSROperator(JBSR(jnp.asarray(blocks), jnp.asarray(cols), shape), backend="pallas")
    op_t = lt.BSROperator(lt.BSR(torch.from_numpy(blocks), torch.from_numpy(cols), shape))
    return op_t, op_j


@pytest.mark.parametrize("multi", [False, True])
def test_windowed_bsr_gradients_match_jax(rng, caps, multi):
    caps(window_blocks=16, tile=65536) if multi else caps()
    op_t, op_j = window_ops(rng, multi)
    assert op_t.win_q is not None and (op_t.cols_local is None) == multi
    assert multi is False or op_t.win_q_t is not None
    leaf = op_t.data.blocks.requires_grad_(True)
    for mode in ("N", "T"):
        x, g = rng.standard_normal(op_t.in_dim(mode)), rng.standard_normal(op_t.out_dim(mode))
        xt = t_(x, True)
        gx, gB = torch.autograd.grad(op_t.apply(xt, mode), (xt, leaf), t_(g))
        close(gx, jax_vjp(lambda x_: op_j.apply(x_, mode), jnp.asarray(x), g))
        close(gB, jax_leaf_vjp(op_j, op_j.data.blocks,
                               lambda o: o.apply(jnp.asarray(x), mode), g))


def routed_pair(rng, symmetric=False):
    A = sps.random(300, 300 if symmetric else 260, density=0.03, format="csr", random_state=61)
    A.data[:] = rng.standard_normal(A.nnz)
    if symmetric:
        A = (A + A.T).tocsr()
    kw = dict(symmetric=symmetric, hermitian=symmetric)
    return A, lt.opSparse(A, format="routed", **kw, **CPU), lo.opSparse(A, format="routed", **kw)


@pytest.mark.parametrize("mode", MODES)
def test_routed_gradients_match_jax(rng, mode):
    """x and value gradients through the plain routed pipeline (forward
    program for N/C, the derived transpose for T/H)."""
    A, op_t, op_j = routed_pair(rng)
    transposed = mode in ("T", "H")
    leaf_t = op_t.routed_t.vals_pre if transposed else op_t.routed.vals
    leaf_j = op_j.routed_t.vals_pre if transposed else op_j.routed.vals
    leaf_t.requires_grad_(True)
    x, g = rng.standard_normal(op_t.in_dim(mode)), rng.standard_normal(op_t.out_dim(mode))
    xt = t_(x, True)
    gx, gv = torch.autograd.grad(op_t.apply(xt, mode), (xt, leaf_t), t_(g))
    close(gx, jax_vjp(lambda x_: op_j.apply(x_, mode), jnp.asarray(x), g))
    close(gv, jax_leaf_vjp(op_j, leaf_j, lambda o: o.apply(jnp.asarray(x), mode), g))
    close(gx, (A.T @ g) if mode == "N" else A @ g if transposed else A.T @ g)


def test_permutation_and_rcm_gradients_match_jax(rng):
    n = 700
    perm = rng.permutation(n)
    P_t, P_j = lt.opPermutation(perm, **CPU), lo.opPermutation(perm)
    B = sps.random(n, n, density=0.01, format="csr", random_state=7)
    B.data[:] = rng.standard_normal(B.nnz)
    S = (B + B.T + sps.identity(n)).tocsr()
    R_t = lt.opSparse(S, format="csr", reorder="rcm", **CPU)
    R_j = lo.opSparse(S, format="csr", reorder="rcm")
    for op_t, op_j in ((P_t, P_j), (R_t, R_j)):
        for mode in ("N", "T"):
            x, g = rng.standard_normal(n), rng.standard_normal(n)
            xt = t_(x, True)
            (gx,) = torch.autograd.grad(op_t.apply(xt, mode), xt, t_(g))
            close(gx, jax_vjp(lambda x_: op_j.apply(x_, mode), jnp.asarray(x), g))
    # the sandwich's inner values
    leaf = R_t.inner.data.vals.requires_grad_(True)
    x, g = rng.standard_normal(n), rng.standard_normal(n)
    (gv,) = torch.autograd.grad(R_t.apply(t_(x), "N"), leaf, t_(g))
    close(gv, jax_leaf_vjp(R_j, R_j.inner.data.vals, lambda o: o.apply(jnp.asarray(x), "N"), g))


# --------------------------------------------------------------------------
# KernelApply: the kernel branches' autograd node
# --------------------------------------------------------------------------


def bsr_case(rng, shape=(37, 45), block=(4, 8)):
    A = sprand(rng, *shape, density=0.3)
    return lt.BSROperator(lt.bsr_from_dense(A, block, **CPU)), A


@pytest.mark.parametrize("mode", MODES)
def test_kernel_apply_gradcheck(rng, mode):
    """gradcheck and gradgradcheck of the node for x and blocks, its applies
    the plain K1/K2 (what the wrappers run on CPU tensors)."""
    op, _ = bsr_case(rng)
    blocks = op.data.blocks.clone().requires_grad_(True)
    x = t_(rng.standard_normal(op.in_dim(mode)), True)

    def f(x_, b_):
        return KernelApply.apply(op, (mode, "vec"), x_, b_)

    assert torch.autograd.gradcheck(f, (x, blocks))
    assert torch.autograd.gradgradcheck(f, (x, blocks))


@pytest.mark.parametrize("multi", [False, True])
def test_kernel_apply_gradcheck_windowed(rng, caps, multi):
    caps(window_blocks=16, tile=65536) if multi else caps()
    op, _ = window_ops(rng, multi)
    blocks = op.data.blocks.clone().requires_grad_(True)
    for mode in ("N", "T"):
        x = t_(rng.standard_normal(op.in_dim(mode)), True)
        y = KernelApply.apply(op, (mode, "vec"), x, blocks)
        g = t_(rng.standard_normal(op.out_dim(mode)))
        gx, gB = torch.autograd.grad(y, (x, blocks), g)
        bl = op.data.blocks.detach().requires_grad_(True)
        op_p = lt.BSROperator(op.data._replace(blocks=bl), win_q=op.win_q,
                              cols_local=op.cols_local, win_q_t=op.win_q_t,
                              win_valid_t=op.win_valid_t, _wb=op._wb,
                              _x_pad_blocks=op._x_pad_blocks, _x_pad_blocks_t=op._x_pad_blocks_t)
        x2 = x.detach().requires_grad_(True)
        gx_p, gB_p = torch.autograd.grad(op_p.apply(x2, mode), (x2, bl), g)
        close(gx, gx_p, rtol=1e-12)
        close(gB, gB_p, rtol=1e-12)
    # gradcheck of x through the windowed node (fast mode: x has 5120 entries)
    x = t_(rng.standard_normal(op.ncol), True)
    assert torch.autograd.gradcheck(lambda x_: KernelApply.apply(op, ("N", "vec"), x_, blocks),
                                    (x,), fast_mode=True)


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """Send the operators' kernel branches through their wrappers on CPU
    tensors, where the wrappers take the plain versions: the path a CUDA
    tensor takes, KernelApply included, minus the launch."""
    monkeypatch.setattr(TO.BSROperator, "_use_kernel", lambda self, v: self._backend != "torch")
    monkeypatch.setattr(TR, "_use_kernel", lambda uk, vals, x: True if uk is None else bool(uk))
    monkeypatch.setattr(TP.PermutationOperator, "_use_kernel", lambda self, x: True)


def grad_fn_names(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(f).__name__ for f in seen}


def test_kernel_branches_go_through_the_node(rng, kernels_on_cpu):
    """Each kernel branch builds a KernelApply node when a gradient is
    wanted, and none under no_grad; the gradients equal plain autograd's;
    the backward leaves the counters as the plain path leaves them."""
    op, A = bsr_case(rng)
    A_r = sps.random(300, 260, density=0.03, format="csr", random_state=62)
    routed = lt.opSparse(A_r, format="routed", **CPU)
    P = lt.opPermutation(rng.permutation(700), **CPU)
    for o in (op, routed, P):
        for mode in ("N", "T"):
            x, g = rng.standard_normal(o.in_dim(mode)), rng.standard_normal(o.out_dim(mode))
            xt = t_(x, True)
            o.reset_counters()
            y = lt.matvec(o, xt, mode)
            assert "KernelApplyBackward" in grad_fn_names(y), type(o).__name__
            (gx,) = torch.autograd.grad(y, xt, t_(g))
            assert (o.nprod, o.ntprod, o.nctprod) == ((1, 0, 0) if mode == "N" else (0, 1, 0))
            with torch.no_grad():
                assert lt.matvec(o, t_(x), mode).grad_fn is None
                close(gx, lt.matvec(o, t_(g), "T" if mode == "N" else "N").numpy(), rtol=1e-12)
    # the routed matrix applies, through the _on_card seam
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "_on_card", lambda t: True)
        for mode in ("N", "T"):
            X = t_(rng.standard_normal((routed.in_dim(mode), 3)), True)
            G = t_(rng.standard_normal((routed.out_dim(mode), 3)))
            Y = lt.matmat(routed, X, mode)
            assert "KernelApplyBackward" in grad_fn_names(Y)
            (gX,) = torch.autograd.grad(Y, X, G)
            close(gX, lt.matmat(routed, G, "T" if mode == "N" else "N").detach().numpy(),
                  rtol=1e-12)
            Yt = routed.apply_matrix_t(X.t(), mode)
            (gXt,) = torch.autograd.grad(Yt, X, G.t())
            close(gXt, gX, rtol=1e-12)


def test_kernel_branch_blocks_gradient_and_second_derivative(rng, kernels_on_cpu):
    """Block gradients through the node equal plain autograd's (a BSR with
    padded rows and columns), and a Hessian-vector product works."""
    op, A = bsr_case(rng, shape=(35, 43))
    leaf = op.data.blocks.requires_grad_(True)
    plain = lt.BSROperator(op.data, backend="torch")
    for mode in MODES:
        x, g = rng.standard_normal(op.in_dim(mode)), rng.standard_normal(op.out_dim(mode))
        grads = []
        for o in (op, plain):
            xt = t_(x, True)
            grads.append(torch.autograd.grad(o.apply(xt, mode), (xt, leaf), t_(g)))
        close(grads[0][0], grads[1][0].numpy(), rtol=1e-12)
        close(grads[0][1], grads[1][1].numpy(), rtol=1e-12)
    x = t_(rng.standard_normal(43))
    v = t_(rng.standard_normal(43))
    hv = torch.autograd.functional.hvp(lambda x_: 0.5 * (op @ x_).pow(2).sum(), x, v)[1]
    close(hv, A.T @ (A @ v.numpy()), rtol=1e-12)


def test_kernel_branch_refusals_and_transforms(rng, kernels_on_cpu):
    """On the kernel path a routed value gradient is computed (it was refused
    before) and equals the plain pipeline's autograd, vmap over a kernel
    apply runs it per member (BSR) or as a row panel (routed), and
    torch.func.grad goes through."""
    A_r = sps.random(300, 260, density=0.03, format="csr", random_state=63)
    routed = lt.opSparse(A_r, format="routed", **CPU)
    x, g = t_(rng.standard_normal(260)), t_(rng.standard_normal(300))
    vals = routed.routed.vals.requires_grad_(True)
    assert "KernelApplyBackward" in grad_fn_names(routed @ x)
    (gv,) = torch.autograd.grad(routed @ x, vals, g)
    vals.requires_grad_(False)
    close(gv, plain_routed_value_grad(routed, "N", "vec", x, g, 0))
    with torch.no_grad():
        routed @ x  # no gradient wanted: no node
    op, A = bsr_case(rng)
    V = rng.standard_normal((3, op.ncol))
    close(torch.func.vmap(lambda v: op @ v)(t_(V)), V @ A.T, rtol=1e-12)
    W = rng.standard_normal((4, 260))
    close(torch.func.vmap(lambda v: routed @ v)(t_(W)), W @ A_r.T.toarray(), rtol=1e-12)
    g = torch.func.grad(lambda v: (op @ v).sum())(t_(rng.standard_normal(op.ncol)))
    close(g, A.T @ np.ones(op.nrow), rtol=1e-12)


def plain_routed_value_grad(op, mode, kind, x, g, slot):
    """The value gradient of ``op``'s routed apply by autograd through the
    plain pipeline (the kernel branch off, the matrix kinds on the routed
    layout), for the program value tensor ``slot``."""
    leaf = op._program_values()[slot]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "_use_kernel", lambda uk, vals, x_: False if uk is None else bool(uk))
        mp.setattr(TO, "_on_card", lambda t: True)
        leaf.requires_grad_(True)
        y = {"vec": op.apply, "mat": op.apply_matrix, "panel": op.apply_matrix_t}[kind](x, mode)
        (gv,) = torch.autograd.grad(y, leaf, g)
        leaf.requires_grad_(False)
    return gv


@pytest.mark.parametrize("kind", ["vec", "mat", "panel"])
@pytest.mark.parametrize("layout", ["3-stage", "5-stage", "symmetric", "repacked T", "complex"])
def test_routed_kernel_value_gradients(rng, kernels_on_cpu, monkeypatch, layout, kind):
    """The value gradient on the routed kernel path (g routed back to the
    slots through the inverse crossbars, times the phase-1 gather of x) in
    every mode: equal to autograd of the plain pipeline, padding slots
    included, and, for vectors, to jax's gradient of the reference's
    program values (rtol 1e-10). The forward program's values serve N and
    C, the derived transpose's (or a re-packed transpose's) T and H."""
    monkeypatch.setattr(TO, "_on_card", lambda t: True)  # the routed matrix kinds
    n, m = (2000, 1900) if layout == "5-stage" else (300, 260)
    sym = layout == "symmetric"
    A = sps.random(n, n if sym else m, density=(10.0 if n > 1000 else 4.0) / m, format="csr",
                   random_state=71)
    A.data[:] = rng.standard_normal(A.nnz)
    if layout == "complex":
        A = A.astype(np.complex128)
        A.data += 1j * rng.standard_normal(A.nnz)
    if sym:
        A = (A + A.T).tocsr()
    kw = dict(symmetric=sym, hermitian=sym)
    if layout == "repacked T":
        op = TO.RoutedCSROperator(lt.csr_from_parts(A.data, A.indices, A.indptr, A.shape,
                                                    **CPU), defer_transpose=True)
        op._ensure_transpose()
        assert isinstance(op.routed_t, TR.RoutedSpMV)
    else:
        op = lt.opSparse(A, format="routed", **kw, **CPU)
    assert len(op.routed.stages) == (4 if layout == "5-stage" else 2)
    op_j = lo.opSparse(A, format="routed", **kw) if layout != "repacked T" else None
    cplx = layout == "complex"
    for mode in MODES:
        slot = 0 if op._program_mode(mode) in ("N", "C") else 1
        ni, no = op.in_dim(mode), op.out_dim(mode)
        if kind == "vec":
            x, g = rvec(rng, ni, cplx), rvec(rng, no, cplx)
        else:
            x = rvec(rng, 3 * ni, cplx).reshape(3, ni)
            g = rvec(rng, 3 * no, cplx).reshape(3, no)
            if kind == "mat":
                x, g = x.T, g.T
        leaf = op._program_values()[slot].requires_grad_(True)
        y = {"vec": op.apply, "mat": op.apply_matrix, "panel": op.apply_matrix_t}[kind](
            t_(x), mode)
        assert "KernelApplyBackward" in grad_fn_names(y)
        (gv,) = torch.autograd.grad(y, leaf, t_(g))
        leaf.requires_grad_(False)
        close(gv, plain_routed_value_grad(op, mode, kind, t_(x), t_(g), slot))
        if op_j is not None and kind == "vec":
            prog_j = op_j.routed if slot == 0 else op_j.routed_t
            leaf_j = prog_j.vals if slot == 0 else prog_j.vals_pre
            close(gv, jax_leaf_vjp(op_j, leaf_j, lambda o: o.apply(jnp.asarray(x), mode), g))


# --------------------------------------------------------------------------
# The implicit backward of opIterativeInverse
# --------------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("mode", ["N", "T", "H"])
def test_iterative_inverse_gradients_match_jax(rng, mode, complex_):
    """∂/∂v and ∂/∂A of a real loss through op⁻¹ in mode: the port against
    jax.grad (conjugated, torch's convention) and against the dense solve's
    autograd. rtol 1e-8: the inner gmres stops at 1e-13."""
    n = 12
    A = rng.standard_normal((n, n)) + 6 * np.eye(n)
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    v, w = rvec(rng, n, complex_), rvec(rng, n, complex_)
    kw = dict(tol=1e-13, maxiter=400)

    def loss_j(A_, v_):
        x = lo.opIterativeInverse(lo.LinearOperator(A_), **kw).apply(v_, mode)
        return jnp.real(jnp.vdot(jnp.asarray(w), x))

    gA_j, gv_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(v))
    At, vt = t_(A, True), t_(v, True)
    x = lt.opIterativeInverse(lt.LinearOperator(At), **kw).apply(vt, mode)
    gA, gv = torch.autograd.grad(torch.real(torch.vdot(t_(w), x)), (At, vt))
    close(gA, np.conj(np.asarray(gA_j)), rtol=1e-8)
    close(gv, np.conj(np.asarray(gv_j)), rtol=1e-8)
    Ad, vd = t_(A, True), t_(v, True)
    Am = {"N": Ad, "T": Ad.T, "H": Ad.conj().T}[mode]
    gA_d, gv_d = torch.autograd.grad(torch.real(torch.vdot(t_(w), torch.linalg.solve(Am, vd))),
                                     (Ad, vd))
    close(gA, gA_d, rtol=1e-8)
    close(gv, gv_d, rtol=1e-8)


def test_iterative_inverse_gradient_review_findings(rng):
    """tests/test_linalg_ops.py:225-238: operator-data gradients of a
    hermitian inner solve (minres) match the dense solve's; a diagonal the
    graph holds twice is counted once; v alone wanting a gradient is enough."""
    n = 14
    S = rng.standard_normal((n, n))
    S = S @ S.T + 5 * np.eye(n)
    v = rng.standard_normal(n)

    def loss_j(A):
        inv = lo.opIterativeInverse(lo.LinearOperator(A, symmetric=True, hermitian=True),
                                    tol=1e-13, maxiter=400)
        return jnp.sum(inv @ jnp.asarray(v))

    gA_j = jax.grad(loss_j)(jnp.asarray(S))
    St = t_(S, True)
    inv = lt.opIterativeInverse(lt.LinearOperator(St, symmetric=True, hermitian=True),
                                tol=1e-13, maxiter=400)
    (gA,) = torch.autograd.grad((inv @ t_(v)).sum(), St)
    close(gA, gA_j, rtol=1e-8)
    # D S D + I with d held twice
    d = rng.random(n) + 1.0
    dt = t_(d, True)
    Dt = lt.opDiagonal(dt)
    inv2 = lt.opIterativeInverse(Dt @ lt.LinearOperator(t_(S)) @ Dt + lt.opEye(n), solver="cg",
                                 tol=1e-13, maxiter=400)
    (gd,) = torch.autograd.grad((inv2 @ t_(v)).sum(), dt)
    d64 = t_(d, True)
    Md = d64[:, None] * t_(S) * d64[None, :] + torch.eye(n, dtype=torch.float64)
    (gd_d,) = torch.autograd.grad(torch.linalg.solve(Md, t_(v)).sum(), d64)
    close(gd, gd_d, rtol=1e-8)
    vt = t_(v, True)
    (gv,) = torch.autograd.grad((inv @ vt).sum(), vt)
    close(gv, np.linalg.solve(S.T, np.ones(n)), rtol=1e-8)
    with torch.no_grad():
        assert (inv @ vt).grad_fn is None
