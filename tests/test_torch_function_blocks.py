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
"""

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
