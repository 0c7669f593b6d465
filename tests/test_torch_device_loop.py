"""The device-resident solve loop (``linops_tpu_torch/utils/loop.py``) on the
CPU, where its masked blocks run eagerly, against the plain per-iteration
loop and against the JAX reference in f64.

For each solver the same numpy inputs go through:

- the port with blocks of ``loop.BLOCK`` iterations;
- the port with ``loop.BLOCK = 1`` (one masked iteration per host read,
  the per-iteration loop): the iteration count and every bit of x and of
  the residual must be the same (a frozen iteration changes nothing);
- the reference (``jax.jit`` + ``lax.while_loop``): the same count and x
  within 1e-10·‖x‖.

The cases put the stop in the middle of a block, at ``maxiter`` in the
middle of a block, and at b = 0 (no block runs), and count the host reads:
one for the initial test and one per block, ⌈iterations/BLOCK⌉ + 1 in all
(GMRES counts restarts, in blocks of its own ``krylov.GMRES_BLOCK``, one
restart by default: one read per restart, plus the initial test; the tests
set it with ``BLOCK``). Solves over an operator
that is not ``capture_safe`` (a ``FunctionOperator`` unless declared) take
the per-iteration path. The shifted L-BFGS solves take σ as a tensor, as
the trust-region loop of example 04 holds it. The graph cache's bookkeeping
and the kernel modules' launch tables are checked here too; the captures
themselves run in the ``gpu``-marked tests of ``tests/test_torch_gpu.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.qn import shifted_solve as JS
from linops_tpu_torch.utils import krylov, loop


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def spd(rng, n, cond=50.0):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, cond, n)) @ Q.T


def nonsym(rng, n):
    return np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n)


def indefinite(rng, n):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.linspace(1.0, 20.0, n) * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    return (Q * d) @ Q.T


def pair(A, **kw):
    return lo.LinearOperator(jnp.asarray(A), **kw), lt.LinearOperator(t_(A), **kw)


HERM = dict(symmetric=True, hermitian=True)


def cases(rng):
    """name -> (solver, (reference op, port op), b, keyword arguments, extra
    positional arguments)."""
    n = 40
    S = spd(rng, n)
    b = rng.standard_normal(n)
    Bm = rng.standard_normal((n, 3))
    Mdiag = 1.0 / np.diag(S)
    return {
        "cg": ("cg", pair(S, **HERM), b, dict(tol=1e-10, maxiter=200), ()),
        "cg_preconditioned": ("cg", pair(S, **HERM), b, dict(tol=1e-10, maxiter=200),
                              ("M", Mdiag)),
        "cg_multi": ("cg", pair(S, **HERM), Bm, dict(tol=1e-10, maxiter=200), ()),
        "minres": ("minres", pair(indefinite(rng, n), **HERM), b, dict(tol=1e-10, maxiter=300),
                   ()),
        "minres_multi": ("minres", pair(indefinite(rng, n), **HERM), Bm,
                         dict(tol=1e-10, maxiter=300), ()),
        "bicgstab": ("bicgstab", pair(nonsym(rng, n)), b, dict(tol=1e-10, maxiter=200), ()),
        "lsqr": ("lsqr", pair(rng.standard_normal((200, n))), rng.standard_normal(200),
                 dict(tol=1e-8, maxiter=200), ()),
        "lsqr_damped": ("lsqr", pair(rng.standard_normal((200, n))), rng.standard_normal(200),
                        dict(tol=1e-8, maxiter=200, damp=0.5), ()),
        "gmres": ("gmres", pair(nonsym(rng, n)), b, dict(tol=1e-10, restart=8, maxiter=20), ()),
    }


def run(pkg, solver, op, b, kw, extra):
    kw = dict(kw)
    if extra and extra[0] == "M":
        kw["M"] = pkg.opDiagonal(jnp.asarray(extra[1]) if pkg is lo else t_(extra[1]))
    b = jnp.asarray(b) if pkg is lo else t_(b)
    return getattr(pkg, solver)(op, b, **kw)


def port_blocks(monkeypatch, block, *args):
    monkeypatch.setattr(loop, "BLOCK", block)
    monkeypatch.setattr(krylov, "GMRES_BLOCK", block)  # GMRES's own block length
    out = run(lt, *args)
    return out, dict(loop.stats)


@pytest.mark.parametrize("name", ["cg", "cg_preconditioned", "cg_multi", "minres",
                                  "minres_multi", "bicgstab", "lsqr", "lsqr_damped", "gmres"])
def test_blocks_match_per_iteration_loop_and_reference(rng, monkeypatch, name):
    solver, (opj, opt), b, kw, extra = cases(rng)[name]
    (x1, k1, r1), st1 = port_blocks(monkeypatch, 1, solver, opt, b, kw, extra)
    (x4, k4, r4), st4 = port_blocks(monkeypatch, 4, solver, opt, b, kw, extra)
    assert isinstance(k4, int) and k4 == k1
    assert torch.equal(x4, x1) and torch.equal(r4, r1)
    xj, kj, _ = run(lo, solver, opj, b, kw, extra)
    assert k4 == int(kj)
    xj = np.asarray(xj)
    assert np.linalg.norm(x4.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)
    assert st4["path"] == "blocks" and st4["blocks"] == math.ceil(k4 / 4)
    assert st4["reads"] == st4["blocks"] + 1
    assert st1["path"] == "blocks" and st1["reads"] == k1 + 1


def test_bicgstab_breakdown_stops_mid_block(monkeypatch):
    """A skew-symmetric operator whose r̂·v is exactly 0 (one 2x2 rotation
    block) breaks BiCGSTAB down in its first iteration: the blocked loop
    stops where the per-iteration loop does, with the same bits, no NaN,
    and the reference's count and residual."""
    K = np.array([[0.0, 1.0], [-1.0, 0.0]])
    opj, opt = pair(K)
    b = np.array([1.0, 2.0])
    kw = dict(tol=1e-10, maxiter=50)
    (x1, k1, r1), _ = port_blocks(monkeypatch, 1, "bicgstab", opt, b, kw, ())
    (x4, k4, r4), st = port_blocks(monkeypatch, 4, "bicgstab", opt, b, kw, ())
    assert k4 == k1 == 1 and torch.equal(x4, x1) and torch.equal(r4, r1)
    assert torch.isfinite(x4).all() and torch.isfinite(r4)
    assert st["blocks"] == 1 and st["reads"] == 2
    xj, kj, rj = run(lo, "bicgstab", opj, b, kw, ())
    assert k4 == int(kj)
    np.testing.assert_allclose(x4.numpy(), np.asarray(xj), rtol=1e-10, atol=0)
    np.testing.assert_allclose(float(r4), float(rj), rtol=1e-10)


@pytest.mark.parametrize("maxiter", [1, 5, 6, 8])
def test_maxiter_in_the_middle_of_a_block(rng, monkeypatch, maxiter):
    """Stopped by ``maxiter`` inside a block: the count is maxiter, the
    iterate the per-iteration loop's, the reference's."""
    n = 40
    opj, opt = pair(spd(rng, n, cond=1e4), **HERM)
    b = rng.standard_normal(n)
    kw = dict(tol=1e-14, maxiter=maxiter)
    (x1, k1, _), _ = port_blocks(monkeypatch, 1, "cg", opt, b, kw, ())
    (x4, k4, _), st = port_blocks(monkeypatch, 4, "cg", opt, b, kw, ())
    assert k1 == k4 == maxiter and torch.equal(x4, x1)
    assert st["blocks"] == math.ceil(maxiter / 4) and st["reads"] == st["blocks"] + 1
    xj, kj, _ = run(lo, "cg", opj, b, kw, ())
    assert int(kj) == maxiter
    assert np.linalg.norm(x4.numpy() - np.asarray(xj)) <= 1e-10 * np.linalg.norm(xj)


@pytest.mark.parametrize("solver", ["cg", "minres", "bicgstab", "lsqr", "cg_multi",
                                    "minres_multi"])
def test_zero_rhs_runs_no_block(rng, solver):
    """b = 0: zero iterations, x = 0, one host read (the initial test) and
    no block."""
    n = 16
    A = spd(rng, n)
    name = solver.replace("_multi", "")
    b = np.zeros((n, 2) if solver.endswith("multi") else n)
    x, k, _ = getattr(lt, name)(lt.LinearOperator(t_(A), **HERM), t_(b), tol=1e-10)
    assert k == 0 and not x.abs().any()
    assert loop.stats["blocks"] == 0 and loop.stats["reads"] == 1
    xj, kj, _ = getattr(lo, name)(lo.LinearOperator(jnp.asarray(A), **HERM), jnp.asarray(b),
                                  tol=1e-10)
    assert int(kj) == 0


def test_host_reads_counted_per_block(rng, monkeypatch):
    """A CG of k iterations reads the host ⌈k/BLOCK⌉ + 1 times, for several
    block lengths."""
    n = 40
    opt = lt.LinearOperator(t_(spd(rng, n)), **HERM)
    b = t_(rng.standard_normal(n))
    for block in (1, 2, 3, 4, 7):
        monkeypatch.setattr(loop, "BLOCK", block)
        _, k, _ = lt.cg(opt, b, tol=1e-10, maxiter=200)
        assert loop.stats["reads"] == loop.stats["blocks"] + 1 == math.ceil(k / block) + 1


@pytest.mark.parametrize("solver", ["chebyshev", "matvec_chain", "power_iteration"])
@pytest.mark.parametrize("iters", [0, 3, 9])
def test_fori_solvers_match_plain_loop_and_reference(rng, monkeypatch, solver, iters):
    """The loops with no test (``device_fori``) read nothing, and give the
    bits of a one-iteration block and the reference's values."""
    n = 30
    S = spd(rng, n, cond=20.0)
    opj, opt = pair(S, **HERM)
    b = rng.standard_normal(n)
    args = {"chebyshev": (1.0, 20.0), "matvec_chain": (), "power_iteration": ()}[solver]
    kw = {"chebyshev": dict(iters=iters), "matvec_chain": dict(iters=iters),
          "power_iteration": dict(iters=iters)}[solver]

    def port():
        loop.stats.clear()
        out = getattr(lt, solver)(opt, t_(b), *args, **kw)
        assert loop.stats.get("reads", 0) == 0
        return out if isinstance(out, tuple) else (out,)

    monkeypatch.setattr(loop, "BLOCK", 1)
    one = port()
    monkeypatch.setattr(loop, "BLOCK", 4)
    four = port()
    for a, c in zip(one, four):
        assert (a == c) if isinstance(a, int) else torch.equal(a, c)
    ref = getattr(lo, solver)(opj, jnp.asarray(b), *args, **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, c in zip(four, ref):
        c = np.asarray(c)
        a = np.asarray(a)
        assert np.linalg.norm(a - c) <= 1e-10 * max(np.linalg.norm(c), 1e-300)


def test_operators_that_are_not_capture_safe_take_the_per_iteration_path(rng):
    """``capture_safe`` is declared from the graph: a host factorization, a
    timer or anything holding one takes the per-iteration loop (one read per
    iteration), the rest the blocked one. A nested solve on ``device_while``
    (``cg``, and ``gmres``, whose restarts run there too) is capture-safe
    since its loop runs inside the outer block: the blocked path."""
    import scipy.sparse as sp

    n = 30
    S = spd(rng, n)
    A = lt.LinearOperator(t_(S), **HERM)
    b = t_(rng.standard_normal(n))
    sparse_inv = lt.opSparseInverse(sp.csc_matrix(S + np.eye(n)), symm=True)
    shifted = A + 1.0 * lt.opEye(n, dtype=torch.float64)
    iter_inv = lt.opIterativeInverse(shifted, tol=1e-12, solver="cg")
    gmres_inv = lt.opIterativeInverse(shifted, tol=1e-12, solver="gmres")
    timed = lt.TimedOperator(A)
    assert A.capture_safe and (A @ A + 2.0 * A).capture_safe
    for op in (iter_inv, gmres_inv):
        assert op.capture_safe and (A + op).capture_safe
    for op in (sparse_inv, timed):
        assert not op.capture_safe and not (A + op).capture_safe
    x_ref, k_ref, _ = lt.cg(A, b, tol=1e-10, maxiter=200)
    assert loop.stats["path"] == "blocks"
    x, k, _ = lt.cg(A, b, tol=1e-10, maxiter=200, M=sparse_inv)
    assert loop.stats["path"] == "per_iteration" and loop.stats["reads"] == k + 1
    assert torch.linalg.vector_norm(x - x_ref) <= 1e-8 * torch.linalg.vector_norm(x_ref)
    for M in (iter_inv, gmres_inv):
        x, k, _ = lt.cg(A, b, tol=1e-10, maxiter=200, M=M)
        assert loop.stats["path"] == "blocks" and loop.stats["reads"] == -(-k // loop.BLOCK) + 1
        assert torch.linalg.vector_norm(x - x_ref) <= 1e-8 * torch.linalg.vector_norm(x_ref)
    x, k, _ = lt.cg(timed, b, tol=1e-10, maxiter=200)
    assert loop.stats["path"] == "per_iteration" and k == k_ref and torch.equal(x, x_ref)


def test_capture_key_follows_pushes_and_in_place_edits(rng):
    """The key a captured block is cached under changes with a Python
    coefficient, and not with an apply, a push or an in-place edit: every
    tensor is keyed by layout (the push's new state tensors have the old
    ones' layout, an edit keeps it), and a captured block replays over its
    own copies, into which it copies a new or edited tensor
    (``loop._Mirrors``)."""
    from linops_tpu_torch.core.base import capture_signature

    def capture_key(op):
        return capture_signature(op)[0]

    n = 20
    H = lt.InverseLBFGSOperator(n, mem=3, device="cpu", dtype=torch.float64)
    d = t_(rng.random(n) + 1.0)
    D = lt.opDiagonal(d)
    graph = 2.0 * D
    keys = [capture_key(H), capture_key(graph)]
    H.apply(t_(rng.standard_normal(n)))
    graph.apply(t_(rng.standard_normal(n)))
    assert [capture_key(H), capture_key(graph)] == keys
    state = H.state
    H.push(t_(rng.standard_normal(n)), t_(rng.standard_normal(n) + 3.0))
    assert H.state is not state
    assert capture_key(H) == keys[0]
    mirrors = loop._Mirrors(capture_signature(graph), torch.device("cpu"))
    d.mul_(2.0)
    assert capture_key(graph) == keys[1]
    assert mirrors.refresh(capture_signature(graph).tensors) == d.numel() * d.element_size()
    assert capture_key(3.0 * D) != capture_key(2.0 * D)


def lbfgs_pair(rng, n=60, mem=6):
    """A forward L-BFGS model of an SPD matrix in both packages (pairs
    (s, H s): a well-conditioned model)."""
    from linops_tpu.qn import LBFGSOperator as JLBFGS

    H = spd(rng, n, cond=10.0)
    Bj, Bt = JLBFGS(n, mem=mem), lt.LBFGSOperator(n, mem=mem, device="cpu")
    for _ in range(mem + 2):
        s = rng.standard_normal(n)
        Bj.push(jnp.asarray(s), jnp.asarray(H @ s))
        Bt.push(s, H @ s)
    return Bj, Bt, rng.standard_normal(n)


@pytest.mark.parametrize("method", ["compact", "ejm"])
def test_shifted_solve_with_a_tensor_sigma(rng, method):
    """σ as a 0-dim tensor against the reference's σ, both methods; a
    negative Python or CPU σ still raises."""
    Bj, Bt, b = lbfgs_pair(rng)
    for sigma in (0.3, 2.5):
        x = lt.solve_shifted_system(Bt, t_(b), torch.tensor(sigma, dtype=torch.float64),
                                    method=method)
        xj = np.asarray(JS.solve_shifted_system(Bj, jnp.asarray(b), sigma, method=method))
        assert np.linalg.norm(x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)
    for bad in (-0.1, torch.tensor(-0.1, dtype=torch.float64)):
        with pytest.raises(ValueError):
            lt.solve_shifted_system(Bt, t_(b), bad, method=method)


def test_shifted_systems_with_tensor_sigmas(rng):
    Bj, Bt, b = lbfgs_pair(rng)
    sig = np.array([0.0, 0.4, 3.0])
    X = lt.solve_shifted_systems(Bt, t_(b), t_(sig))
    Xj = np.asarray(JS.solve_shifted_systems(Bj, jnp.asarray(b), jnp.asarray(sig)))
    assert np.linalg.norm(X.numpy() - Xj) <= 1e-10 * np.linalg.norm(Xj)
    with pytest.raises(ValueError):
        lt.solve_shifted_systems(Bt, t_(b), t_(np.array([0.2, -0.1])))


def test_ejm_slot_order_is_gathered_on_the_device():
    """The EJM recursion reads no ring index back (``int(state.insert)``
    is gone): its source holds no host conversion of the state."""
    import inspect

    from linops_tpu_torch.qn import shifted_solve as TS

    src = inspect.getsource(TS._solve_shifted)
    assert "int(" not in src and ".item()" not in src and "torch.remainder" in src


def test_function_operator_is_captured_only_when_declared_safe(rng):
    """A ``FunctionOperator`` runs arbitrary code: by default it is not
    capture-safe and its solves take the per-iteration loop; declared with
    ``capture_safe=True`` (also through ``LinearOperator(dtype, ...)``) they
    take the blocks. Same count and bits either way, the reference's x."""
    n = 30
    S = spd(rng, n)
    St = t_(S)
    b = rng.standard_normal(n)

    def prod(v):
        return St @ v

    plain = lt.FunctionOperator(n, n, prod, symmetric=True, hermitian=True)
    safe = lt.LinearOperator(torch.float64, n, n, True, True, prod, capture_safe=True)
    assert not plain.capture_safe and safe.capture_safe
    assert not (plain + 1.0 * lt.opEye(n, dtype=torch.float64)).capture_safe
    x1, k1, _ = lt.cg(plain, t_(b), tol=1e-10, maxiter=200)
    assert loop.stats["path"] == "per_iteration" and loop.stats["reads"] == k1 + 1
    x4, k4, _ = lt.cg(safe, t_(b), tol=1e-10, maxiter=200)
    assert loop.stats["path"] == "blocks" and loop.stats["reads"] == math.ceil(k4 / 4) + 1
    assert k1 == k4 and torch.equal(x1, x4)
    xj, kj, _ = lo.cg(lo.LinearOperator(jnp.asarray(S), **HERM), jnp.asarray(b), tol=1e-10,
                      maxiter=200)
    assert k4 == int(kj)
    assert np.linalg.norm(x4.numpy() - np.asarray(xj)) <= 1e-10 * np.linalg.norm(xj)


def test_kernel_launch_tables_are_registered_with_the_loop():
    """Each kernel module registers its launch counts with ``loop.py`` (a
    capture lists what it recorded from them), and names, for each kernel,
    a device function of its CUDA source that each launch runs once (how a
    profiler trace of a replay is counted)."""
    import pathlib
    import re

    from linops_tpu_torch.kernels import bsr_spmv, lane_gather

    csrc = pathlib.Path(bsr_spmv.__file__).parent / "csrc"
    src = "\n".join(p.read_text() for p in csrc.glob("*.cu"))
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src))
    for mod in (bsr_spmv, lane_gather):
        assert any(t is mod._LAUNCHES for t in loop._LAUNCH_TABLES)
        assert set(mod.LAUNCH_SYMBOLS) == set(mod._LAUNCHES)
        assert set(mod.LAUNCH_SYMBOLS.values()) <= defined, defined


def test_loop_cache_remembers_a_signature_then_holds_its_graph(monkeypatch):
    """One LRU holds both kinds of entry: a signature seen once (its next
    solve captures) and a captured block; remembering a captured signature
    keeps its block, and the least recently used entry goes first."""
    monkeypatch.setattr(loop, "_CACHE", type(loop._CACHE)())
    t = (torch.zeros(3),)

    def key(i):
        return loop._key("while", ("case", i), (), t)

    assert loop._lookup(key(0)) == (False, None)
    loop._remember("while", ("case", 0), (), t)
    assert loop._lookup(key(0)) == (True, None)
    block = object()
    loop._store(key(0), block)
    loop._remember("while", ("case", 0), (), t)
    assert loop._lookup(key(0)) == (True, block)
    for i in range(1, loop._CACHE_SIZE):
        loop._remember("while", ("case", i), (), t)
    loop._lookup(key(0))  # recently used: stays
    loop._remember("while", ("case", loop._CACHE_SIZE), (), t)
    assert len(loop._CACHE) == loop._CACHE_SIZE
    assert loop._lookup(key(0)) == (True, block) and loop._lookup(key(1)) == (False, None)


# ----------------------------------------------------------------------------
# LOBPCG and normest over an operator that is not capture-safe (their blocked
# loops are held in tests/test_torch_eig.py and tests/test_torch_estimate.py)
# ----------------------------------------------------------------------------


def spectrum(rng, n, lam, complex_=False):
    Z = rng.standard_normal((n, n))
    if complex_:
        Z = Z + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(Z)
    A = (Q * lam) @ Q.conj().T
    return (A + A.conj().T) / 2


def test_spectral_loops_over_an_undeclared_function_operator_run_per_iteration(rng):
    """A FunctionOperator that is not declared capture-safe sends LOBPCG and
    normest to the per-iteration loop (one read per iteration), with the
    blocked loop's results."""
    n = 40
    A = spectrum(rng, n, np.linspace(1.0, 30.0, n))
    At = t_(A)
    zero = lt.opDiagonal(torch.zeros(n, dtype=torch.float64))  # puts the sum on the CPU
    safe = lt.FunctionOperator(n, n, lambda v: At @ v, dtype=torch.float64, symmetric=True,
                               hermitian=True, capture_safe=True) + zero
    plain = lt.FunctionOperator(n, n, lambda v: At @ v, dtype=torch.float64, symmetric=True,
                                hermitian=True) + zero
    assert safe.hermitian and safe.capture_safe and not plain.capture_safe
    X0 = t_(rng.standard_normal((n, 2)))
    out = {}
    for tag, op in (("safe", safe), ("plain", plain)):
        th, X, _, it = lt.lobpcg(op, k=2, X0=X0, tol=1e-8, maxiter=200)
        st = dict(loop.stats)
        e, c = lt.normest(op, tol=1e-10, maxiter=500, generator=torch.Generator().manual_seed(1))
        out[tag] = (th, X, it, st, e, c, dict(loop.stats))
    th, X, it, st, e, c, ste = out["plain"]
    assert st["path"] == ste["path"] == "per_iteration"
    assert st["reads"] == it + 1 and ste["reads"] == c + 1
    ths, Xs, its, sts, es, cs, stes = out["safe"]
    assert sts["path"] == stes["path"] == "blocks"
    assert it == its and torch.equal(th, ths) and torch.equal(X, Xs) and (e, c) == (es, cs)
