"""``torch.func.vmap`` over the port's operators and solvers, against
``jax.vmap`` of the reference (``tests/test_vmap_operators.py``), on the CPU
in f64.

A batch axis on an operator's tensors gives a batch of operators: the
applies and ``vmap(grad(...))`` run through ``torch.func.vmap``. The solvers
run under vmap as ``jax.vmap`` of a ``lax.while_loop`` does: every member
iterates until all have stopped, each frozen once its own test fails, with
per-member iteration counts (``utils/loop.py::device_while``); GMRES
builds its Arnoldi basis by stacking rows there. A kernel apply
under vmap (the kernel branches forced on the CPU, where the wrappers run
their plain versions) runs the kernel once per member, or the routed
matrix kind on the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt


def t_(a):
    return torch.from_numpy(np.asarray(a))


def test_vmap_diagonal_batch(rng):
    B, n = 5, 12
    ds = rng.standard_normal((B, n)) + 3.0
    vs = rng.standard_normal((B, n))
    ys_j = jax.vmap(lambda d, v: lo.opDiagonal(d) @ v)(jnp.asarray(ds), jnp.asarray(vs))
    ys_t = torch.func.vmap(lambda d, v: lt.opDiagonal(d) @ v)(t_(ds), t_(vs))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-15)
    np.testing.assert_allclose(ys_t.numpy(), ds * vs)


def test_vmap_graph_batch(rng):
    B, n = 4, 10
    As = rng.standard_normal((B, n, n))
    ds = rng.standard_normal((B, n))
    vs = rng.standard_normal((B, n))
    ys_j = jax.vmap(lambda A, d, v: (2.0 * lo.MatrixOperator(A) + lo.opDiagonal(d)) @ v)(
        jnp.asarray(As), jnp.asarray(ds), jnp.asarray(vs))
    ys_t = torch.func.vmap(lambda A, d, v: (2.0 * lt.MatrixOperator(A) + lt.opDiagonal(d)) @ v)(
        t_(As), t_(ds), t_(vs))
    oracle = 2.0 * np.einsum("bij,bj->bi", As, vs) + ds * vs
    np.testing.assert_allclose(ys_t.numpy(), oracle, atol=1e-12)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=1e-12)


def spd_batch(rng, B=6, n=14):
    As = rng.standard_normal((B, n, n))
    return np.einsum("bij,bkj->bik", As, As) + 10.0 * np.eye(n)[None], rng.standard_normal((B, n))


def test_vmap_batched_cg(rng):
    """B SPD systems, each with its own operator: torch.func.vmap(cg) solves
    the batch as jax.vmap(cg) does, with the same x and the same per-member
    iteration counts; outside vmap the count stays an int."""
    spd, bs = spd_batch(rng)

    def solve_j(A, b):
        return lo.cg(lo.MatrixOperator(A, symmetric=True, hermitian=True), b, tol=1e-12,
                     maxiter=200)

    def solve_t(A, b):
        return lt.cg(lt.MatrixOperator(A, symmetric=True, hermitian=True), b, tol=1e-12,
                     maxiter=200)

    xs_j, ks_j, _ = jax.vmap(solve_j)(jnp.asarray(spd), jnp.asarray(bs))
    xs_t, ks_t, res_t = torch.func.vmap(solve_t)(t_(spd), t_(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    assert res_t.shape == (spd.shape[0],)
    assert np.linalg.norm(np.einsum("bij,bj->bi", spd, xs_t.numpy()) - bs) < 1e-8
    _, k1, _ = solve_t(t_(spd[0]), t_(bs[0]))
    assert isinstance(k1, int) and k1 == int(ks_t[0])


@pytest.mark.parametrize("solver", ["bicgstab", "minres", "lsqr", "chebyshev"])
def test_vmap_batched_solvers(rng, solver):
    """The other solvers with a stopping test under vmap, and Chebyshev (no
    test: a fixed count), against jax.vmap of the reference: x within 1e-8
    relative and the same per-member counts."""
    spd, bs = spd_batch(rng)
    kw = {"bicgstab": dict(tol=1e-10, maxiter=200), "minres": dict(tol=1e-10, maxiter=200),
          "lsqr": dict(tol=1e-8, maxiter=200)}.get(solver, dict(iters=40))
    herm = dict(symmetric=True, hermitian=True)
    bounds = (5.0, 200.0) if solver == "chebyshev" else ()

    def solve(pkg, A, b):
        return getattr(pkg, solver)(pkg.MatrixOperator(A, **herm), b, *bounds, **kw)

    xs_j, ks_j, _ = jax.vmap(lambda A, b: solve(lo, A, b))(jnp.asarray(spd), jnp.asarray(bs))
    out_dims = (0, None, 0) if solver == "chebyshev" else 0
    xs_t, ks_t, _ = torch.func.vmap(lambda A, b: solve(lt, A, b), out_dims=out_dims)(
        t_(spd), t_(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(ks_t), (len(bs),)),
                                  np.broadcast_to(np.asarray(ks_j), (len(bs),)))


def test_vmap_batched_gmres(rng):
    """vmap(gmres): the Arnoldi basis built by stacking rows under vmap, the
    restarts stopping per member, against jax.vmap of the reference's gmres:
    x within 1e-8 relative and the same per-member restart counts."""
    B, n = 4, 14
    As = 4.0 * np.eye(n)[None] + rng.standard_normal((B, n, n)) / np.sqrt(n)
    As[0] += 2.0 * np.eye(n)  # members converge after different restart counts
    bs = rng.standard_normal((B, n))

    def solve(pkg, A, b):
        return pkg.gmres(pkg.MatrixOperator(A), b, tol=1e-10, restart=4, maxiter=30)

    xs_j, ks_j, _ = jax.vmap(lambda A, b: solve(lo, A, b))(jnp.asarray(As), jnp.asarray(bs))
    xs_t, ks_t, res_t = torch.func.vmap(lambda A, b: solve(lt, A, b))(t_(As), t_(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    assert len(set(ks_t.tolist())) > 1 and res_t.shape == (B,)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", As, xs_t.numpy()), bs, atol=1e-8)


def shared_operator_batch(rng, solver, B=6, n=14):
    """One operator and B right-hand sides whose solves stop after different
    counts (the first lies in a 2-dimensional invariant subspace): (A, bs,
    the solve, its loop's block). GMRES: a non-symmetric A, restarts of 4."""
    from linops_tpu_torch.utils import krylov, loop

    if solver == "gmres":
        A = 4.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
        w, V = np.linalg.eig(A)
        real = np.flatnonzero(np.abs(w.imag) < 1e-12)[:2]
        bs = rng.standard_normal((B, n))
        bs[0] = V[:, real].real.sum(axis=1) if len(real) == 2 else bs[0]
        return A, bs, lambda pkg, op_, b: pkg.gmres(op_, b, tol=1e-10, restart=4, maxiter=30), \
            krylov.GMRES_BLOCK
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + 10.0 * np.eye(n)
    V = np.linalg.eigh(A)[1]
    bs = rng.standard_normal((B, n))
    bs[0] = V[:, 0] + V[:, 3]
    return A, bs, lambda pkg, op_, b: getattr(pkg, solver)(op_, b, tol=1e-10, maxiter=200), \
        loop.BLOCK


@pytest.mark.parametrize("batch", ["rhs", "operator"])
@pytest.mark.parametrize("solver", ["cg", "minres", "bicgstab", "gmres"])
def test_vmap_solves_read_the_host_once_per_block(rng, monkeypatch, solver, batch):
    """A vmapped solve runs masked blocks of its loop's block (``loop.BLOCK``,
    GMRES one restart, ``krylov.GMRES_BLOCK``), one host read before the
    first and after each: at most ⌈I/block⌉ + 1 reads for I the largest
    member's count (iterations; GMRES restarts), where the per-iteration
    loop (a block of 1) makes I + 1. A vmap over the right-hand sides of one
    operator runs the members as a leading batch dimension
    (``stats["path"]`` "vmap_blocks": on the card these blocks are captured,
    "vmap_graph"); a vmap over the operators' own data (a batch of
    operators) keeps the eager path ("vmap"). x and the per-member counts
    are bit for bit the eager per-iteration loop's."""
    from linops_tpu_torch.utils import krylov, loop

    if batch == "rhs":
        A, bs, solve_with, block = shared_operator_batch(rng, solver)
        herm = {} if solver == "gmres" else dict(symmetric=True, hermitian=True)

        def solve(b):
            return solve_with(lt, lt.MatrixOperator(t_(A), **herm), b)

        args = (t_(bs),)
    else:
        if solver == "gmres":
            B, n = 4, 14
            As = 4.0 * np.eye(n)[None] + rng.standard_normal((B, n, n)) / np.sqrt(n)
            As[0] += 2.0 * np.eye(n)
            bs = rng.standard_normal((B, n))
            block = krylov.GMRES_BLOCK

            def solve(A, b):
                return lt.gmres(lt.MatrixOperator(A), b, tol=1e-10, restart=4, maxiter=30)
        else:
            As, bs = spd_batch(rng)
            As[0] += 40.0 * np.eye(As.shape[1])  # members stop after different counts
            block = loop.BLOCK

            def solve(A, b):
                op = lt.MatrixOperator(A, symmetric=True, hermitian=True)
                return getattr(lt, solver)(op, b, tol=1e-10, maxiter=200)

        args = (t_(As), t_(bs))
    path = "vmap_blocks" if batch == "rhs" else "vmap"

    def run(want):
        x, k, _ = torch.func.vmap(solve)(*args)
        assert loop.stats["path"] == want, loop.stats["path"]
        return x, k, loop.stats["reads"], loop.stats["blocks"]

    x, k, reads, blocks = run(path)
    monkeypatch.setattr(loop, "BLOCK", 1)
    monkeypatch.setattr(krylov, "GMRES_BLOCK", 1)
    x1, k1, reads1, _ = run(path)
    monkeypatch.setattr(loop, "_members", lambda *a: False)  # the eager per-iteration loop
    x0, k0, reads0, _ = run("vmap")
    top = int(k.max())
    assert torch.equal(x, x1) and torch.equal(k, k1) and len(set(k.tolist())) > 1
    assert torch.equal(x, x0) and torch.equal(k, k0)
    assert reads <= -(-top // block) + 1 and blocks == -(-top // block), (reads, blocks, top)
    assert reads1 == top + 1 and reads0 == top + 1


@pytest.mark.parametrize("solver", ["cg", "minres", "bicgstab", "gmres"])
def test_vmap_over_right_hand_sides_matches_the_reference(rng, solver):
    """vmap of a solve over the right-hand sides of one operator (the
    members as a leading batch dimension, "vmap_blocks") against jax.vmap
    of the reference's solver under x64: x within 1e-8 relative, the same
    per-member counts; the count a per-member tensor."""
    from linops_tpu_torch.utils import loop

    A, bs, solve_with, _ = shared_operator_batch(rng, solver)
    herm = {} if solver == "gmres" else dict(symmetric=True, hermitian=True)
    op_t = lt.MatrixOperator(t_(A), **herm)
    op_j = lo.MatrixOperator(jnp.asarray(A), **herm)
    xs_t, ks_t, res_t = torch.func.vmap(lambda b: solve_with(lt, op_t, b))(t_(bs))
    assert loop.stats["path"] == "vmap_blocks"
    xs_j, ks_j, _ = jax.vmap(lambda b: solve_with(lo, op_j, b))(jnp.asarray(bs))
    xs_j = np.asarray(xs_j)
    assert np.abs(xs_t.numpy() - xs_j).max() <= 1e-8 * np.abs(xs_j).max()
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    assert ks_t.shape == (len(bs),) and res_t.shape == (len(bs),)


def test_nested_vmap_keeps_the_eager_path(rng):
    """vmap of vmap of cg over right-hand sides: the inner loop's tensors
    are batched at two levels, so it runs the eager masked blocks ("vmap"),
    each member's x and count those of its own solve."""
    from linops_tpu_torch.utils import loop

    A, bs, solve_with, _ = shared_operator_batch(rng, "cg")
    op = lt.MatrixOperator(t_(A), symmetric=True, hermitian=True)
    bb = t_(np.stack([bs, 2.0 * bs[::-1]]))
    xs, ks, _ = torch.func.vmap(torch.func.vmap(lambda b: lt.cg(op, b, tol=1e-10, maxiter=200)))(bb)
    assert loop.stats["path"] == "vmap"
    for i in range(2):
        for j in range(len(bs)):
            x1, k1, _ = lt.cg(op, bb[i, j], tol=1e-10, maxiter=200)
            assert int(ks[i, j]) == k1
            assert torch.allclose(xs[i, j], x1, rtol=0, atol=1e-12 * float(x1.abs().max()))


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """The operators' kernel branches on CPU tensors (their wrappers take the
    plain versions there): KernelApply and its vmap rule run as on a card."""
    from linops_tpu_torch.ops import permutation as TP
    from linops_tpu_torch.sparse import ops as TO
    from linops_tpu_torch.sparse import routed as TR

    monkeypatch.setattr(TO.BSROperator, "_use_kernel", lambda self, v: self._backend != "torch")
    monkeypatch.setattr(TR, "_use_kernel", lambda uk, vals, x: True if uk is None else bool(uk))
    monkeypatch.setattr(TO, "_on_card", lambda t: True)
    monkeypatch.setattr(TP.PermutationOperator, "_use_kernel", lambda self, x: True)


def test_vmap_over_kernel_applies(rng, kernels_on_cpu, monkeypatch):
    """vmap over a kernel apply: a permutation runs the vector apply once
    per member, bit for bit; BSR N and T run their block apply once on the
    batch (a row panel: the forward panel, the block transpose; as the
    reference's vmap is one batched kernel), bit for bit that row panel's
    apply and within f64 rounding of the vector applies (on the CPU the
    plain panels sum in other orders than the plain vector applies; on the
    card K1p and K2p are bit for bit K1's and K2's column loops,
    ``tests/test_torch_gpu.py``); a routed operator runs its matrix
    kind on the batch (a row panel) and agrees with the vector applies; a
    batch of BSR operators (batched blocks) runs once per member."""
    import scipy.sparse as sps

    from linops_tpu_torch.kernels import bsr_spmv as K

    A = np.where(rng.random((40, 48)) < 0.3, rng.standard_normal((40, 48)), 0.0)
    op = lt.BSROperator(lt.bsr_from_dense(A, (4, 8), device="cpu"))
    for mode, name in (("N", "bsr_matmat_kernel"), ("T", "bsr_rmatmat_kernel")):
        panels = []
        panel_kernel = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, f=panel_kernel, **kw: panels.append(1) or f(*a, **kw))
        V = t_(rng.standard_normal((5, op.in_dim(mode))))
        Y = torch.func.vmap(lambda v: op.apply(v, mode))(V)
        assert panels == [1], mode
        vec = torch.stack([op.apply(v, mode) for v in V])
        assert torch.equal(Y, op.apply_matrix_t(V, mode))
        assert float((Y - vec).abs().max()) <= 1e-12 * float(vec.abs().max())
    P = lt.opPermutation(rng.permutation(700), device="cpu")
    V = t_(rng.standard_normal((3, 700)))
    assert torch.equal(torch.func.vmap(lambda v: P @ v)(V), torch.stack([P @ v for v in V]))
    R = sps.random(300, 260, density=0.03, format="csr", random_state=81)
    routed = lt.opSparse(R, format="routed", device="cpu")
    for mode in ("N", "T"):
        V = t_(rng.standard_normal((6, routed.in_dim(mode))))
        Y = torch.func.vmap(lambda v: routed.apply(v, mode))(V)
        ref = torch.stack([routed.apply(v, mode) for v in V])
        np.testing.assert_allclose(Y.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    blocks = op.data.blocks
    Bs = torch.stack([blocks, 2.0 * blocks, -blocks])
    x = t_(rng.standard_normal(48))

    def apply_one(b):
        return lt.BSROperator(lt.BSR(b, op.data.block_cols, op.data.shape)) @ x

    np.testing.assert_allclose(torch.func.vmap(apply_one)(Bs).numpy(),
                               np.stack([A @ x.numpy() * s for s in (1.0, 2.0, -1.0)]),
                               rtol=1e-12, atol=1e-12)


def test_vmap_composes_with_grad(rng):
    B, n = 3, 8
    ds = np.abs(rng.standard_normal((B, n))) + 1.0
    vs = rng.standard_normal((B, n))

    def loss_j(d, v):
        return jnp.sum((lo.opDiagonal(d) @ v) ** 2)

    def loss_t(d, v):
        return ((lt.opDiagonal(d) @ v) ** 2).sum()

    g_j = jax.vmap(jax.grad(loss_j))(jnp.asarray(ds), jnp.asarray(vs))
    g_t = torch.func.vmap(torch.func.grad(loss_t))(t_(ds), t_(vs))
    np.testing.assert_allclose(g_t.numpy(), 2.0 * ds * vs ** 2, rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)
