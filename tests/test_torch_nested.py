"""Nested solves in the port's solve loop (``linops_tpu_torch/utils/loop.py``):
an ``opIterativeInverse`` preconditioner whose inner solve runs inside the
outer solver's masked blocks, as the reference nests its inner
``lax.while_loop`` in the outer one (``linops_tpu/ops/linalg_ops.py``), in
f64 on the CPU; and the plain version of the while node's condition kernel
(``kernels/graph_cond.py``).

Against the per-iteration loop (``loop.BLOCK = 1``): the outer iterations,
the inner iterations summed over the solve and x bit for bit. Against the
reference: iterations ±1 and x within 1e-8·‖x‖, as the solver tests hold
them (the inner solves are inexact, tol 1e-3).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu_torch.kernels import graph_cond
from linops_tpu_torch.utils import loop

CPU = dict(device="cpu")
HERM = dict(symmetric=True, hermitian=True)


def spd(rng, n, hi=100.0):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, hi, n)) @ Q.T


def nested_case(inner, seed=3, n=40):
    """(S, the port's A, its preconditioner opIterativeInverse(S + 5·I), b)."""
    rng = np.random.default_rng(seed)
    S = spd(rng, n)
    A = lt.LinearOperator(torch.from_numpy(S), **HERM, **CPU)
    shifted = lt.LinearOperator(torch.from_numpy(S + 5.0 * np.eye(n)), **HERM, **CPU)
    M = lt.opIterativeInverse(shifted, tol=1e-3, maxiter=30, solver=inner)
    return S, A, M, rng.standard_normal(n)


@pytest.mark.parametrize("inner", ["cg", "minres", "bicgstab"])
@pytest.mark.parametrize("outer", ["cg", "minres"])
def test_nested_solve_runs_in_masked_blocks(monkeypatch, outer, inner):
    """The outer solve takes the blocked path (one read per block of 4), and
    gives the per-iteration loop's outer iterations, summed inner iterations
    and x bit for bit; the reference's nested solve agrees."""
    S, A, M, b = nested_case(inner)
    runs = {}
    for block in (1, 4):
        monkeypatch.setattr(loop, "BLOCK", block)
        M.reset_inner_iterations()
        x, k, _ = getattr(lt, outer)(A, torch.from_numpy(b), tol=1e-10, maxiter=200, M=M)
        runs[block] = (x, k, M.inner_iterations, dict(loop.stats))
    (x1, k1, i1, _), (x4, k4, i4, st) = runs[1], runs[4]
    assert st["path"] == "blocks" and st["reads"] == -(-k4 // 4) + 1
    assert k4 == k1 and i4 == i1 > k4 and torch.equal(x4, x1)
    n = S.shape[0]
    Mj = lo.opIterativeInverse(lo.LinearOperator(jnp.asarray(S + 5.0 * np.eye(n)), **HERM),
                               tol=1e-3, maxiter=30, solver=inner)
    xj, kj, _ = getattr(lo, outer)(lo.LinearOperator(jnp.asarray(S), **HERM), jnp.asarray(b),
                                   tol=1e-10, maxiter=200, M=Mj)
    xj = np.asarray(xj)
    assert abs(k4 - int(kj)) <= 1
    assert np.linalg.norm(x4.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_loop_in_a_frozen_iteration_runs_none(monkeypatch):
    """A loop started in a masked iteration ANDs its mask: in the frozen
    iterations of an outer block it runs no iteration, so the inner counts of
    the active iterations are the per-iteration loop's."""

    def solve(block):
        monkeypatch.setattr(loop, "BLOCK", block)
        inner_counts = []

        def body(state, consts, k):
            (_, inner), k2 = loop.device_while(lambda s, c: s[1] < 5, lambda s, c, j: (s[0], s[1] + 1),
                                               (state[0], torch.zeros((), dtype=torch.int64)), 50)
            inner_counts.append(k2)
            return state[0] + 1.0, state[1] + inner

        (x, total), k = loop.device_while(lambda s, c: s[0] < 2.0, body,
                                          (torch.zeros(()), torch.zeros((), dtype=torch.int64)), 10)
        return k, int(total), inner_counts

    assert solve(1) == (2, 10, [5, 5])
    assert solve(4) == (2, 10, [5, 5, 0, 0])  # the block's last two iterations are frozen


def nested_gmres_case(outer, seed=3, n=40):
    """(the outer operator's matrix, the port's outer operator, its
    preconditioner opIterativeInverse(matrix + 5·I) on GMRES, b): for an
    outer CG the SPD S and ``solver="gmres"``; for an outer BiCGSTAB S plus a
    skew part and ``solver="auto"`` (GMRES on a non-hermitian operator). The
    inner solves run to 1e-10 with restarts of 30, up to 2 of them."""
    rng = np.random.default_rng(seed)
    S = spd(rng, n)
    flags, solver = (HERM, "gmres") if outer == "cg" else ({}, "auto")
    if outer == "bicgstab":
        K = rng.standard_normal((n, n))
        S = S + 2.0 * (K - K.T)
    A = lt.LinearOperator(torch.from_numpy(S), **flags, **CPU)
    shifted = lt.LinearOperator(torch.from_numpy(S + 5.0 * np.eye(n)), **flags, **CPU)
    M = lt.opIterativeInverse(shifted, tol=1e-10, maxiter=60, solver=solver)
    return S, A, M, flags, solver, rng.standard_normal(n)


@pytest.mark.parametrize("outer", ["cg", "bicgstab"])
def test_nested_gmres_runs_in_masked_blocks(monkeypatch, outer):
    """An inner GMRES (its restarts on ``loop.device_while``, one a block)
    inside an outer CG or BiCGSTAB: the outer solve takes the blocked path
    (one read per block of 4) with the per-iteration loop's outer
    iterations, summed inner restarts (more than one in some applies) and x
    bit for bit; the reference's nested solve agrees."""
    S, A, M, flags, solver, b = nested_gmres_case(outer)
    assert M.capture_safe
    runs = {}
    for block in (1, 4):
        monkeypatch.setattr(loop, "BLOCK", block)
        M.reset_inner_iterations()
        x, k, _ = getattr(lt, outer)(A, torch.from_numpy(b), tol=1e-10, maxiter=200, M=M)
        runs[block] = (x, k, M.inner_iterations, dict(loop.stats))
    (x1, k1, i1, st1), (x4, k4, i4, st) = runs[1], runs[4]
    assert st["path"] == st1["path"] == "blocks" and st["reads"] == -(-k4 // 4) + 1
    applies = k4 * (1 if outer == "cg" else 2)
    assert k4 == k1 and i4 == i1 > applies and torch.equal(x4, x1)
    n = S.shape[0]
    Mj = lo.opIterativeInverse(lo.LinearOperator(jnp.asarray(S + 5.0 * np.eye(n)), **flags),
                               tol=1e-10, maxiter=60, solver=solver)
    xj, kj, _ = getattr(lo, outer)(lo.LinearOperator(jnp.asarray(S), **flags), jnp.asarray(b),
                                   tol=1e-10, maxiter=200, M=Mj)
    xj = np.asarray(xj)
    assert abs(k4 - int(kj)) <= 1
    assert np.linalg.norm(x4.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


@pytest.mark.parametrize("which", ["timed_inner", "sparse_inverse"])
def test_preconditioners_that_read_the_host_take_the_per_iteration_path(which):
    """An inner operator that is not capture-safe (a timer) and a host
    factorization (``opSparseInverse``) keep the outer solve on the
    per-iteration loop."""
    S, A, _, b = nested_case("cg")
    n = S.shape[0]
    shifted = lt.LinearOperator(torch.from_numpy(S + 5.0 * np.eye(n)), **HERM, **CPU)
    M = {"timed_inner": lambda: lt.opIterativeInverse(lt.TimedOperator(shifted), tol=1e-3,
                                                      maxiter=30, solver="cg"),
         "sparse_inverse": lambda: lt.opSparseInverse(sps.csc_matrix(S + 5.0 * np.eye(n)),
                                                      symm=True)}[which]()
    assert not M.capture_safe
    x, k, _ = lt.cg(A, torch.from_numpy(b), tol=1e-10, maxiter=200, M=M)
    assert loop.stats["path"] == "per_iteration" and loop.stats["reads"] == k + 1


def test_iterative_inverse_capture_safety_follows_its_solver():
    """``capture_safe``: true for every inner solver over a capture-safe
    operator (all run on ``loop.device_while``), ``"auto"`` on a hermitian
    one (MINRES) and on a nonsymmetric one (GMRES) included; false over a
    host-bound inner operator."""
    rng = np.random.default_rng(5)
    S = spd(rng, 12)
    herm = lt.LinearOperator(torch.from_numpy(S), **HERM, **CPU)
    general = lt.LinearOperator(torch.from_numpy(S + np.triu(S, 1)), **CPU)
    for solver in ("cg", "minres", "bicgstab", "gmres", "auto"):
        assert lt.opIterativeInverse(herm, solver=solver).capture_safe
    for solver in ("bicgstab", "gmres", "auto"):  # auto: gmres
        assert lt.opIterativeInverse(general, solver=solver).capture_safe
    for solver in ("cg", "gmres"):
        assert not lt.opIterativeInverse(lt.TimedOperator(herm), solver=solver).capture_safe


def test_inner_iterations_are_summed_and_reset():
    """``inner_iterations`` adds each apply's inner solve; a reset zeroes it."""
    _, _, M, b = nested_case("cg")
    v = torch.from_numpy(b)
    _, k, _ = M.solve_info(v)
    M.apply(v)
    assert M.inner_iterations == 2 * k > 0
    M.reset_inner_iterations()
    assert M.inner_iterations == 0


def test_while_condition_kernel_is_registered():
    """The condition kernel's launch count is registered with the loop, and
    its device function is defined in its CUDA source."""
    src = (pathlib.Path(graph_cond.__file__).parent / "csrc" / "graph_cond.cu").read_text()
    defined = set(re.findall(r"__global__\s+void\s+(\w+)", src))
    assert any(t is graph_cond._LAUNCHES for t in loop._LAUNCH_TABLES)
    assert set(graph_cond.LAUNCH_SYMBOLS) == set(graph_cond._LAUNCHES)
    assert set(graph_cond.LAUNCH_SYMBOLS.values()) <= defined


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("shape", [(), (1,), (1, 1)])
def test_while_condition_plain_version(act, shape):
    """On CPU tensors the wrapper returns the plain version, the value the
    kernel gives the node's condition: act, as a 0-dim bool; it takes one
    bool of any shape."""
    a = torch.tensor(act).reshape(shape)
    before = graph_cond.launch_counts()["while_condition"]
    got = graph_cond.set_while_condition(0, a)
    assert got.dtype == torch.bool and got.shape == () and bool(got) == act
    assert torch.equal(got, graph_cond.while_condition_plain(a))
    assert graph_cond.launch_counts()["while_condition"] == before  # no launch on the CPU
    with pytest.raises(TypeError):
        graph_cond.set_while_condition(0, torch.ones(2, dtype=torch.bool))
    with pytest.raises(TypeError):
        graph_cond.set_while_condition(0, torch.tensor(1))
