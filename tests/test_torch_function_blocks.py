"""``FunctionOperator`` block applies against the reference's, on the CPU in
f64: the reference's ``apply_matrix`` is ``jax.vmap`` of its vector apply
(one trace of the user's functions), and the port's is one
``torch.func.vmap`` of its vector apply, one call of the function per block.

- Values: N/T/H (and C), column blocks (n, k) and row panels (k, n), k = 1,
  3, 6, against the reference's ``apply_matrix`` at rtol 1e-10, for an
  operator given ``tprod`` and one given ``ctprod`` (the modes inferred
  from it), real and complex.
- One call of the function per block apply, where the column loop makes k.
- The fallback: a function ``torch.func.vmap`` cannot batch (one calling
  ``.item()``) takes the column loop, with one ``UserWarning`` naming the
  operator and the error for the operator's first block and none after; an
  error that is not vmap's propagates.
- DTensor blocks, in one 4-rank gloo world (1 x 4 mesh, rows split): a
  function of DTensor operations (pointwise, a product with a row-split
  DTensor matrix) applies a column block and a row panel in N and T in one
  call, the column loop's values (within 1e-12: the products' sums run in
  another order) and placements, and the reference's ``jax.vmap`` values on
  the whole arrays; a function that calls a DTensor method on its vector
  (``full_tensor``) takes the column loop with the named warning, the
  column loop's values bit for bit.
"""

import os
import traceback
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt

MODES = ("N", "T", "C", "H")


def operators(rng, complex_, adjoint):
    """(port operator, reference operator, the port's call log) on one 7x5
    matrix, given ``tprod`` (adjoint False) or ``ctprod`` (True)."""
    A = rng.standard_normal((7, 5))
    if complex_:
        A = A + 1j * rng.standard_normal((7, 5))
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    calls = []

    def logged(f):
        def g(v):
            calls.append(1)
            return f(v)
        return g

    dt = torch.complex128 if complex_ else torch.float64
    if adjoint:
        op_t = lt.FunctionOperator(7, 5, logged(lambda x: At @ x), None,
                                   logged(lambda y: At.conj().T @ y), dtype=dt)
        op_j = lo.FunctionOperator(7, 5, lambda x: Aj @ x, None, lambda y: Aj.conj().T @ y,
                                   dtype=Aj.dtype)
    else:
        op_t = lt.FunctionOperator(7, 5, logged(lambda x: At @ x), logged(lambda y: At.T @ y),
                                   dtype=dt)
        op_j = lo.FunctionOperator(7, 5, lambda x: Aj @ x, lambda y: Aj.T @ y, dtype=Aj.dtype)
    return op_t, op_j, calls


@pytest.mark.parametrize("complex_,adjoint", [(False, False), (True, False), (True, True)])
def test_blocks_match_the_reference(rng, complex_, adjoint):
    op_t, op_j, calls = operators(rng, complex_, adjoint)
    for mode in MODES:
        for k in (1, 3, 6):
            M = rng.standard_normal((op_t.in_dim(mode), k))
            if complex_:
                M = M + 1j * rng.standard_normal(M.shape)
            ref = np.asarray(op_j.apply_matrix(jnp.asarray(M), mode))
            ref_t = np.asarray(op_j.apply_matrix_t(jnp.asarray(M.T), mode))
            calls.clear()
            Y = op_t.apply_matrix(torch.from_numpy(M), mode)
            assert len(calls) == 1, (mode, k, len(calls))
            Yt = op_t.apply_matrix_t(torch.from_numpy(M.T.copy()), mode)
            assert len(calls) == 2, (mode, k, len(calls))
            scale = np.abs(ref).max()
            assert Y.shape == (op_t.out_dim(mode), k) and Yt.shape == (k, op_t.out_dim(mode))
            assert np.abs(Y.resolve_conj().numpy() - ref).max() <= 1e-10 * scale, (mode, k)
            assert np.abs(Yt.resolve_conj().numpy() - ref_t).max() <= 1e-10 * scale, (mode, k)


def test_an_unbatchable_function_takes_the_column_loop():
    """A function that calls ``.item()``: its first block warns once (the
    operator and vmap's error named) and loops; later blocks loop without a
    warning, and the values are the column loop's."""
    rng = np.random.default_rng(23)
    A = torch.from_numpy(rng.standard_normal((6, 6)))
    calls = []

    def prod(v):
        calls.append(1)
        return A @ v * (1.0 + 0.0 * float(v.sum().item()))

    op = lt.FunctionOperator(6, 6, prod, symmetric=True)
    M = torch.from_numpy(rng.standard_normal((6, 4)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Y = op.apply_matrix(M)
        Y2 = op.apply_matrix_t(M.t(), "T")
    msgs = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    assert len(msgs) == 1 and "Function operator 6x6" in msgs[0] and ".item()" in msgs[0]
    loop = torch.stack([A @ M[:, j] for j in range(4)], dim=1)
    assert torch.equal(Y, loop) and torch.equal(Y2, loop.t())
    assert len(calls) == 1 + 4 + 4  # the vmap attempt, then two column loops


def test_other_errors_propagate():
    """An error that is not vmap's, raised in the user's function, is not
    caught by the block apply."""
    def bad(v):
        raise RuntimeError("the user's own failure")

    op = lt.FunctionOperator(3, 3, bad)
    with pytest.raises(RuntimeError, match="the user's own failure"):
        op.apply_matrix(torch.zeros((3, 2), dtype=torch.float64))
    with pytest.raises(RuntimeError, match="the user's own failure"):  # no fallback recorded
        op.apply_matrix(torch.zeros((3, 2), dtype=torch.float64))


# --------------------------------------------------------------------------
# DTensor blocks (one 4-rank gloo world for the file's DTensor tests)
# --------------------------------------------------------------------------

WORLD = 4
N_DT, K_DT = 16, 5


def dtensor_arrays():
    rng = np.random.default_rng(2207)
    return (rng.standard_normal((N_DT, N_DT)), rng.standard_normal(N_DT),
            rng.standard_normal((N_DT, K_DT)))


def dtensor_blocks():
    """The rank side: mode -> (block result gathered whole, its placements,
    calls, the column loop's result and placements, the row panel's
    result), and the fallback's results; f64 on a 1 x 4 CPU mesh."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from linops_tpu_torch.core.base import LinearOperator
    from linops_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    A, d, X = (torch.from_numpy(a) for a in dtensor_arrays())
    Ad, dd, Xd = (distribute_tensor(t, mesh, [Shard(0)]) for t in (A, d, X))
    calls = []

    def logged(f):
        def g(v):
            calls.append(1)
            return f(v)
        return g

    op = lt.FunctionOperator(N_DT, N_DT, logged(lambda v: dd * v + Ad @ v),
                             logged(lambda u: dd * u + Ad.T @ u), dtype=torch.float64)
    out = {}
    for mode in ("N", "T"):
        calls.clear()
        Y = op.apply_matrix(Xd, mode)
        n_calls = len(calls)
        Yr = op.apply_matrix_t(Xd.t(), mode)
        n_calls_t = len(calls) - n_calls
        loop = LinearOperator.apply_matrix(op, Xd, mode)
        out[mode] = (Y.full_tensor().numpy(), str(Y.placements), n_calls, n_calls_t,
                     loop.full_tensor().numpy(), str(loop.placements), Yr.full_tensor().numpy())
    gathered = []

    def whole(v):  # a DTensor method on the vector: vmap hands over a plain tensor
        gathered.append(1)
        return distribute_tensor(A @ v.full_tensor(), mesh, [Shard(0)])

    op2 = lt.FunctionOperator(N_DT, N_DT, whole, symmetric=True, dtype=torch.float64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Y2 = op2.apply_matrix(Xd)
        Y3 = op2.apply_matrix(Xd)
    msgs = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    loop2 = LinearOperator.apply_matrix(op2, Xd)
    out["fallback"] = (Y2.full_tensor().numpy(), Y3.full_tensor().numpy(),
                       loop2.full_tensor().numpy(), msgs, len(gathered))
    return out


def world_main():
    try:
        return {"dtensor_blocks": ("ok", dtensor_blocks())}
    except Exception:
        return {"dtensor_blocks": ("error", traceback.format_exc())}


@pytest.fixture(scope="module")
def world():
    from linops_tpu_torch.parallel import launch

    status, value = launch.run(os.path.abspath(__file__) + ":world_main", WORLD,
                               backend="gloo", timeout=600)[0]["dtensor_blocks"]
    if status != "ok":
        pytest.fail(f"the DTensor block cases failed in the world:\n{value}")
    return value


@pytest.mark.parametrize("mode", ["N", "T"])
def test_dtensor_block_is_one_call(world, mode):
    """A DTensor column block and a row panel: one call of the function
    each, the column loop's values and placements, the reference's jax.vmap
    values."""
    A, d, X = dtensor_arrays()
    op_j = lo.FunctionOperator(N_DT, N_DT, lambda v: jnp.asarray(d) * v + jnp.asarray(A) @ v,
                               lambda u: jnp.asarray(d) * u + jnp.asarray(A).T @ u,
                               dtype=jnp.float64)
    ref = np.asarray(op_j.apply_matrix(jnp.asarray(X), mode))
    Y, placements, n_calls, n_calls_t, loop, loop_placements, Yr = world[mode]
    assert n_calls == 1 and n_calls_t == 1
    assert placements == loop_placements, (placements, loop_placements)
    scale = np.abs(ref).max()
    assert np.abs(Y - loop).max() <= 1e-12 * scale
    assert np.abs(Y - ref).max() <= 1e-12 * scale
    assert np.abs(Yr - ref.T).max() <= 1e-12 * scale


def test_dtensor_method_takes_the_column_loop(world):
    """A function that calls ``full_tensor`` on its vector: vmap refuses
    it, so the block warns once and takes the column loop (the attempt,
    then one call per column, twice), the loop's values bit for bit."""
    Y2, Y3, loop, msgs, n_gathered = world["fallback"]
    assert len(msgs) == 1 and "Function operator 16x16" in msgs[0]
    assert "full_tensor" in msgs[0]
    assert np.array_equal(Y2, loop) and np.array_equal(Y3, loop)
    assert n_gathered == 1 + K_DT + K_DT + K_DT  # the attempt, two blocks, the loop
