"""The port's shifted L-BFGS solves (``linops_tpu_torch/qn/shifted_solve.py``)
against the JAX reference's, on the CPU in f64.

Mirrors ``tests/test_solve_shifted_system.py`` (9 tests): the same pairs,
pushed into an L-BFGS operator of each package (states built by a push, so
the Grams and a/b vectors the solves read are the ones a push keeps), the
same right-hand side and σ. Each case keeps the reference test's oracle and
adds parity: the port's x within 1e-8·‖x_ref‖ of the reference's. The
reference setup's uniform random pairs are nearly parallel, so the small
Woodbury system is ill-conditioned and rounding in another order moves x
by a few 1e-9 of its norm. The reference's jit test
becomes its eager counterpart: a σ given as a tensor, and a second σ that
rebuilds nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linops_tpu.qn import InverseLBFGSOperator as JInverse
from linops_tpu.qn import LBFGSOperator as JLBFGS
from linops_tpu.qn import shifted_solve as JS
import linops_tpu_torch as lt


def pair_ops(n, mem, scaling, inverse_too=False):
    ops = (JLBFGS(n, mem=mem, scaling=scaling), lt.LBFGSOperator(n, mem=mem, scaling=scaling,
                                                                 device="cpu"))
    if inverse_too:
        ops += (JInverse(n, mem=mem, scaling=False),
                lt.InverseLBFGSOperator(n, mem=mem, scaling=False, device="cpu"))
    return ops


def push_all(ops, s, y):
    for op in ops:
        op.push(jnp.asarray(s) if type(op).__module__.startswith("linops_tpu.") else s, y)


def setup_test_val(rng, mem=5, n=100, scaling=False, sigma=0.1):
    """The reference setup: ten pushes of uniform random pairs into B (and H),
    b = B x + σx so the answer is x."""
    Bj, Bt, Hj, Ht = pair_ops(n, mem, scaling, inverse_too=True)
    for _ in range(10):
        s, y = rng.random(n), rng.random(n)
        push_all((Bj, Bt, Hj, Ht), s, y)
    x = rng.standard_normal(n)
    b = np.asarray(Bj * jnp.asarray(x)) + sigma * x
    return (Bj, Bt), (Hj, Ht), b, sigma, x


def close(got, ref, rtol=1e-8):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.linalg.norm(got - ref) <= rtol * np.linalg.norm(ref)


def test_default_setup(rng):
    (Bj, Bt), _, b, sigma, x_true = setup_test_val(rng, n=100, mem=5)
    x = lt.solve_shifted_system(Bt, torch.from_numpy(b), sigma)
    assert x.shape == (100,) and torch.isfinite(x).all()
    close(x, JS.solve_shifted_system(Bj, b, sigma))
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-6, rtol=1e-6)


def test_scaled_operator(rng):
    (Bj, Bt), _, b, sigma, x_true = setup_test_val(rng, n=60, mem=5, scaling=True)
    x = lt.solve_shifted_system(Bt, b, sigma)  # numpy b is taken too
    close(x, JS.solve_shifted_system(Bj, b, sigma))
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-6, rtol=1e-6)


def test_negative_sigma_raises(rng):
    (Bj, Bt), _, b, _, _ = setup_test_val(rng, n=100, mem=5)
    for solve, B in ((JS.solve_shifted_system, Bj), (lt.solve_shifted_system, Bt)):
        with pytest.raises(ValueError):
            solve(B, b, -0.1)


def test_inverse_operator_rejected(rng):
    for solve, H in ((JS.solve_shifted_system, JInverse(10, mem=3)),
                     (lt.solve_shifted_system, lt.InverseLBFGSOperator(10, mem=3, device="cpu"))):
        with pytest.raises(ValueError):
            solve(H, np.ones(10), 0.1)


def test_ldiv(rng):
    (Bj, Bt), (Hj, Ht), b, _, x_true = setup_test_val(rng, n=100, mem=5, sigma=0.0)
    x = lt.ldiv(Bt, torch.from_numpy(b))
    close(x, JS.ldiv(Bj, b))
    np.testing.assert_allclose(x.numpy(), (Ht * torch.from_numpy(b)).numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-6, rtol=1e-6)


def test_partial_memory(rng):
    n, mem = 30, 8
    Bj, Bt = pair_ops(n, mem, scaling=False)
    for _ in range(3):  # fewer pushes than mem
        push_all((Bj, Bt), rng.random(n), rng.random(n))
    x = rng.standard_normal(n)
    sigma = 0.25
    b = np.asarray(Bj * jnp.asarray(x)) + sigma * x
    got = lt.solve_shifted_system(Bt, torch.from_numpy(b), sigma)
    close(got, JS.solve_shifted_system(Bj, b, sigma))
    np.testing.assert_allclose(got.numpy(), x, atol=1e-6, rtol=1e-6)


def test_compact_equals_ejm_and_dense(rng):
    """compact == EJM == a dense solve over partial, full and wrapped rings,
    with and without scaling; each against the reference's same method."""
    n, mem = 40, 6
    for scaling in (False, True):
        for pushes in (2, mem, mem + 4):
            Bj, Bt = pair_ops(n, mem, scaling)
            for _ in range(pushes):
                s = rng.standard_normal(n)
                push_all((Bj, Bt), s, s + 0.3 * rng.standard_normal(n))
            b = rng.standard_normal(n)
            Bd = Bt.to_dense().numpy()
            for sigma in (0.0, 0.37):
                x_d = np.linalg.solve(Bd + sigma * np.eye(n), b)
                x_c = lt.solve_shifted_system(Bt, torch.from_numpy(b), sigma)
                close(x_c, JS.solve_shifted_system(Bj, b, sigma))
                np.testing.assert_allclose(x_c.numpy(), x_d, rtol=1e-9, atol=1e-9)
                if sigma > 0 or pushes >= mem:
                    x_e = lt.solve_shifted_system(Bt, torch.from_numpy(b), sigma, method="ejm")
                    close(x_e, JS.solve_shifted_system(Bj, b, sigma, method="ejm"))
                    np.testing.assert_allclose(x_e.numpy(), x_d, rtol=1e-8, atol=1e-8)
                else:
                    with pytest.raises(ValueError, match="degenerate"):
                        lt.solve_shifted_system(Bt, torch.from_numpy(b), sigma, method="ejm")


def test_batched_sigmas(rng):
    n, mem = 30, 5
    Bj, Bt = pair_ops(n, mem, scaling=True)
    for _ in range(7):
        s = rng.standard_normal(n)
        push_all((Bj, Bt), s, s + 0.2 * rng.standard_normal(n))
    b = rng.standard_normal(n)
    sigmas = np.array([0.0, 0.1, 1.0, 10.0])
    X = lt.solve_shifted_systems(Bt, torch.from_numpy(b), sigmas)
    assert tuple(X.shape) == (4, n)
    close(X, JS.solve_shifted_systems(Bj, b, sigmas))
    Bd = Bt.to_dense().numpy()
    for i, sg in enumerate(sigmas):
        np.testing.assert_allclose(X[i].numpy(), np.linalg.solve(Bd + sg * np.eye(n), b),
                                   rtol=1e-9, atol=1e-10)
        close(X[i], lt.solve_shifted_system(Bt, torch.from_numpy(b), float(sg)).numpy(),
              rtol=1e-12)
    with pytest.raises(ValueError):
        lt.solve_shifted_systems(Bt, b, [-0.1, 0.2])


def test_sigma_as_tensor_rebuilds_nothing(rng):
    """The reference's jit test, eagerly: σ as a 0-dim tensor (as a
    trust-region loop would hold it), and a second σ on the same operator
    leaves its state untouched."""
    (Bj, Bt), _, b, sigma, x_true = setup_test_val(rng, n=50, mem=5)
    state = Bt.state
    x = lt.solve_shifted_system(Bt, torch.from_numpy(b), torch.tensor(sigma))
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-6, rtol=1e-6)
    x2 = lt.solve_shifted_system(Bt, torch.from_numpy(b), torch.tensor(2 * sigma))
    close(x2, JS.solve_shifted_system(Bj, b, 2 * sigma))
    assert Bt.state is state
    sols = lt.solve_shifted_systems(Bt, torch.from_numpy(b), torch.tensor([sigma, 2 * sigma]))
    close(sols[0], x.numpy(), rtol=1e-12)
