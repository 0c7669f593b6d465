"""Operators backed by a callable object (``tests/test_callable.py``) in the
port against the reference, on the CPU in f64."""

import jax.numpy as jnp
import numpy as np
import torch

import linops_tpu as lo
import linops_tpu_torch as lt


class Flip:
    """A callable class as the product function (the reference's Flip)."""

    def __call__(self, x):
        return -x


def both():
    return (lt.LinearOperator(torch.float64, 2, 2, True, True, Flip()),
            lo.LinearOperator(jnp.float64, 2, 2, True, True, Flip()))


def test_callable_operator():
    op, opj = both()
    ones = np.ones(2)
    for view in (lambda o: o, lambda o: o.H, lambda o: o.T):
        got = view(op) * torch.from_numpy(ones)
        np.testing.assert_array_equal(got.numpy(), -ones)
        np.testing.assert_array_equal(got.numpy(), np.asarray(view(opj) * jnp.asarray(ones)))


def test_callable_repeated_applies():
    """The reference checks that repeated applies hit its jit cache; the port
    has none. Repeated applies give the same result, and the counter counts
    each."""
    op, _ = both()
    v = torch.ones(2, dtype=torch.float64)
    first = op.matvec(v)
    for _ in range(5):
        assert torch.equal(op.matvec(v), first)
    assert op.nprod == 6


def test_callable_mul_axpby():
    op, opj = both()
    out = lt.mul(op, torch.ones(2, dtype=torch.float64), 2.0, 3.0,
                 torch.full((2,), 10.0, dtype=torch.float64))
    np.testing.assert_allclose(out.numpy(), 2.0 * (-1.0) + 3.0 * 10.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        lo.mul(opj, jnp.ones(2), 2.0, 3.0, jnp.full(2, 10.0))))
