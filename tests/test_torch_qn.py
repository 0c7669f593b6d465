"""Parity of the port's L-SR1 and diagonal quasi-Newton operators with the JAX
reference, in f64 on the CPU (mirrors test_lsr1.py and test_diag.py).

The same pair stream goes through both packages: every field of the L-SR1
state after every push (the a-vectors once materialized), the compact and
a-form applies, ``diag``, the norm bound, rejection, scaling, reset, and a
state carried across through ``convert``; each diagonal update after each
push. Agreement: max|Δ| ≤ 1e-10·max|ref| per field (BASELINE.md's f64
tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from helpers import simple_vector
from linops_tpu.qn import diagonal as jd
from linops_tpu.qn import lsr1 as jl
from linops_tpu_torch.convert import diagonal_qn_from_reference, lsr1_state_from_reference
from linops_tpu_torch.qn import lsr1 as tl

RTOL = 1e-10
CPU = dict(device="cpu")


def close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.size == 0:
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    assert err <= rtol * scale, f"{what}: max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def assert_state(st_t, st_j, what=""):
    for f in jl.LSR1State._fields:
        close(getattr(st_t, f), getattr(st_j, f), what=f"{what} {f}")


def dense_sr1(B, s, y):
    ymBs = y - B @ s
    denom = np.dot(ymBs, s)
    if abs(denom) >= 1.0e-8 + 1.0e-8 * np.linalg.norm(s) * np.linalg.norm(ymBs):
        B = B + np.outer(ymBs, ymBs) / denom
    return B


# --------------------------------------------------------------------------
# L-SR1
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("lazy_a", [False, True])
def test_lsr1_states_and_applies(rng, scaling, lazy_a):
    n, mem = 20, 4
    op_t = lt.LSR1Operator(n, mem=mem, scaling=scaling, lazy_a=lazy_a, **CPU)
    op_j = jl.LSR1Operator(n, mem=mem, scaling=scaling, lazy_a=lazy_a)
    for i in range(mem + 3):  # through a wrapped ring
        s = rng.standard_normal(n)
        y = 2.0 * s + 0.5 * rng.standard_normal(n) if i % 3 else rng.standard_normal(n)
        op_t.push(torch.from_numpy(s), torch.from_numpy(y))
        op_j.push(jnp.asarray(s), jnp.asarray(y))
        assert op_t.insert == op_j.insert
        v = rng.standard_normal(n)
        close(op_t @ torch.from_numpy(v), op_j @ jnp.asarray(v), what=f"apply {i}")
        M = rng.standard_normal((n, 3))
        close(lt.matmat(op_t, torch.from_numpy(M)), lo.matmat(op_j, jnp.asarray(M)))
    close(op_t.diag(), op_j.diag(), what="diag")
    assert abs(op_t.opnorm_upper_bound - op_j.opnorm_upper_bound) <= RTOL * abs(
        op_j.opnorm_upper_bound)
    assert_state(op_t.state, op_j._materialized_state(), "after diag")
    assert op_t.scaling_factor == pytest.approx(op_j.scaling_factor, rel=1e-12)


def test_lsr1_basic_rejection_and_reset():
    n, mem = 10, 5
    B = lt.LSR1Operator(n, mem=mem, scaling=False, **CPU)
    eps = np.finfo(np.float64).eps
    for _ in range(2):  # run again after reset
        assert B.insert == 0
        assert np.linalg.norm(B.to_dense().numpy() - np.eye(n)) <= eps
        s = torch.from_numpy(simple_vector(np.float64, n))
        B.push(s, B * s)  # y = B s: y − Bs = 0 is rejected
        assert B.insert == 0
        for i in range(1, mem + 3):
            B.push(torch.ones(n, dtype=torch.float64) * i,
                   torch.cat([torch.tensor([float(i)]), torch.ones(n - 1, dtype=torch.float64)]))
        assert lt.check_hermitian(B)
        close(B.diag(), np.diag(B.to_dense().numpy()), rtol=1e-8)
        v = torch.from_numpy(simple_vector(np.float64, n))
        assert float(torch.linalg.vector_norm(B * v - v)) > 1e-8
        assert np.linalg.norm(B.to_dense().numpy(), 2) <= B.opnorm_upper_bound + 1e-8
        B.reset()
        assert B.scaling_factor == 1.0
        assert float(torch.linalg.vector_norm(B * v - v)) < 1e-8


def test_lsr1_vs_dense_sr1(rng):
    n = 10
    LB = lt.LSR1Operator(n, mem=n, scaling=False, **CPU)
    B = np.eye(n)
    for _ in range(n):
        s, y = rng.standard_normal(n), rng.standard_normal(n)
        B = dense_sr1(B, s, y)
        LB.push(torch.from_numpy(s), torch.from_numpy(y))
        assert np.linalg.norm(LB.to_dense().numpy() - B) < 1e-8 * np.linalg.norm(B)
        assert np.linalg.norm(LB.diag().numpy() - np.diag(B)) < 1e-8 * np.linalg.norm(np.diag(B))
    assert np.linalg.norm(B, 2) <= LB.opnorm_upper_bound + 1e-8


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_lsr1_dtypes(dt):
    n = 10
    B = lt.LSR1Operator(dt, n, mem=5, **CPU)
    B.push(torch.ones(n), 2 * torch.ones(n))
    assert B.dtype == dt and B.state.S.dtype == dt
    assert (B * torch.from_numpy(simple_vector(np.float64, n)).to(dt)).dtype == dt
    with pytest.raises(lt.LinearOperatorException):
        lt.LSR1Operator(torch.complex128, n, **CPU)


def test_lsr1_indefinite_and_modes(rng):
    n = 12
    B = lt.LSR1Operator(n, mem=6, scaling=False, **CPU)
    for _ in range(6):
        B.push(torch.from_numpy(rng.standard_normal(n)), torch.from_numpy(rng.standard_normal(n)))
    Bd = B.to_dense().numpy()
    np.testing.assert_allclose(Bd, Bd.T, rtol=1e-12)
    v = rng.standard_normal(n)
    np.testing.assert_allclose((B.T * torch.from_numpy(v)).numpy(), Bd.T @ v, rtol=1e-10)
    np.testing.assert_allclose((B.H * torch.from_numpy(v)).numpy(), Bd.T @ v, rtol=1e-10)


def test_lsr1_compact_equals_a_form(rng):
    n, mem = 24, 5
    for scaling in (False, True):
        for pushes in (0, 2, mem, mem + 3):
            lazy = lt.LSR1Operator(n, mem=mem, scaling=scaling, **CPU)
            eager = lt.LSR1Operator(n, mem=mem, scaling=scaling, lazy_a=False, **CPU)
            for _ in range(pushes):
                s, y = torch.from_numpy(rng.standard_normal(n)), torch.from_numpy(
                    rng.standard_normal(n))
                lazy.push(s, y)
                eager.push(s, y)
            x = torch.from_numpy(rng.standard_normal(n))
            X = torch.from_numpy(rng.standard_normal((n, 3)))
            st = lazy._materialized_state()
            close(tl.lsr1_apply_compact(st, x), tl.lsr1_apply(st, x))
            close(tl.lsr1_apply_compact(st, X), tl.lsr1_apply(st, X))
            for f in tl.LSR1State._fields:
                close(getattr(st, f), getattr(eager.state, f), what=f)


def test_lsr1_state_from_reference_and_derived_minv(rng):
    """A reference state carried across applies as the reference's; a
    hand-edited state is refreshed the way the push refreshes it (Minv is
    derived from S, Y, ys, γ and insert)."""
    n, mem = 16, 4
    op_j = jl.LSR1Operator(n, mem=mem, scaling=True)
    for _ in range(mem + 1):
        s = rng.standard_normal(n)
        op_j.push(jnp.asarray(s), jnp.asarray(2.0 * s + 0.3 * rng.standard_normal(n)))
    st_j = op_j._materialized_state()
    fields = {f: np.asarray(getattr(st_j, f)) for f in st_j._fields}
    op_t = lt.LSR1Operator(n, mem=mem, scaling=True, **CPU)
    op_t.state = lsr1_state_from_reference(fields, **CPU)
    v = rng.standard_normal(n)
    close(op_t @ torch.from_numpy(v), op_j @ jnp.asarray(v))
    close(op_t.diag(), op_j.diag())
    # a hand-edited γ: refresh Minv as the push does, and the applies agree
    st = op_t.state._replace(gamma=op_t.state.gamma * 2)
    op_t.state = st._replace(Minv=tl._compact_minv(st))
    st_j2 = st_j._replace(gamma=st_j.gamma * 2)
    st_j2 = st_j2._replace(Minv=jl._compact_minv(st_j2))
    close(tl.lsr1_apply_compact(op_t.state, torch.from_numpy(v)),
          jl.lsr1_apply_compact(st_j2, jnp.asarray(v)))


def test_lsr1_scaling_matches_dense(rng):
    n = 8
    B = lt.LSR1Operator(n, mem=n, scaling=True, **CPU)
    s, y = rng.standard_normal(n), rng.standard_normal(n)
    B.push(torch.from_numpy(s), torch.from_numpy(y))
    if B.insert == 1:
        gamma = np.dot(y, s) / np.dot(y, y)
        assert abs(B.scaling_factor - gamma) < 1e-12
        np.testing.assert_allclose(B.to_dense().numpy(), dense_sr1(np.eye(n) / gamma, s, y),
                                   rtol=1e-10)


# --------------------------------------------------------------------------
# diagonal quasi-Newton (test_diag.py)
# --------------------------------------------------------------------------

x0 = np.array([-1.0, 1.0, -1.0])
x1 = x0 + np.array([1.0, 0.0, 1.0])
GRADS = {
    "f": lambda x: 2 * np.array([x[0], x[1], x[2]]),
    "g": lambda x: np.array([np.exp(x[0]), 1.0, -np.sin(x[2])]),
    "h": lambda x: np.array([2 * x[0] * x[1] * x[2] ** 3, x[0] ** 2 * x[2] ** 3,
                             3 * x[0] ** 2 * x[1] * x[2] ** 2]),
}
CLASSES = ["DiagonalPSB", "DiagonalAndrei", "DiagonalBFGS"]


@pytest.mark.parametrize("grad", sorted(GRADS))
@pytest.mark.parametrize("cls", CLASSES + ["SpectralGradient"])
def test_diagonal_updates_match_reference(grad, cls):
    s = x1 - x0
    y = GRADS[grad](x1) - GRADS[grad](x0)
    if cls == "SpectralGradient":
        op_t, op_j = lt.SpectralGradient(1.0, 3, **CPU), jd.SpectralGradient(1.0, 3)
    else:
        d0 = np.array([1.0, -1.0, 1.0])
        op_t, op_j = getattr(lt, cls)(d0, **CPU), getattr(jd, cls)(jnp.asarray(d0))
    for _ in range(3):  # repeated pushes compound the update
        op_t.push(torch.from_numpy(s), torch.from_numpy(y))
        op_j.push(jnp.asarray(s), jnp.asarray(y))
        close(op_t.diag(), op_j.diag(), what=cls)
        v = np.array([0.5, -2.0, 3.0])
        close(op_t @ torch.from_numpy(v), op_j @ jnp.asarray(v))
    if cls in ("DiagonalPSB", "DiagonalAndrei"):
        fresh = getattr(lt, cls)(np.array([1.0, -1.0, 1.0]), **CPU)
        fresh.push(torch.from_numpy(s), torch.from_numpy(y))  # the weak secant equation
        assert abs(float(torch.dot(torch.from_numpy(s), fresh * torch.from_numpy(s)))
                   - np.dot(s, y)) <= 1e-10


def test_diagonal_qn_reset_zero_s_and_sigma(rng):
    op = lt.DiagonalPSB(np.array([1.0, 2.0, 3.0]), **CPU)
    op.push(torch.tensor([1.0, 0.5, 0.0], dtype=torch.float64),
            torch.tensor([2.0, 1.0, 0.5], dtype=torch.float64))
    op @ torch.ones(3, dtype=torch.float64)
    op.reset()
    assert torch.equal(op.diag(), torch.ones(3, dtype=torch.float64)) and op.nprod == 0
    with pytest.raises(ValueError, match="s=0"):
        op.push(torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        lt.SpectralGradient(0.0, 3, **CPU)
    assert lt.SpectralGradient(2.5, 4, **CPU).sigma == 2.5


@pytest.mark.parametrize("cls", CLASSES)
def test_diagonal_qn_is_operator_and_carried_across(rng, cls):
    n = 30
    d = rng.random(n) + 0.5
    op_j = getattr(jd, cls)(jnp.asarray(d))
    s, y = rng.standard_normal(n), rng.standard_normal(n) + 2.0
    op_j.push(jnp.asarray(s), jnp.asarray(y))
    op_t = diagonal_qn_from_reference(cls, np.asarray(op_j.d), **CPU)
    assert type(op_t).__name__ == cls and op_t.symmetric and op_t.hermitian
    M = rng.standard_normal((n, 2))
    for mode in ("N", "T", "H"):
        close(lt.matmat(op_t, torch.from_numpy(M), mode=mode),
              lo.matmat(op_j, jnp.asarray(M), mode=mode))
    op_t.push(torch.from_numpy(s), torch.from_numpy(y))
    op_j.push(jnp.asarray(s), jnp.asarray(y))
    close(op_t.diag(), op_j.diag())
