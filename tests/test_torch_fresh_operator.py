"""Fresh operators of one structure share one captured solve, as the
reference's jit cache shares one compiled loop per treedef, in f64 on the
CPU.

The reference jits every solver with the operator as a pytree argument, so
a new operator over new arrays of the same structure reuses the compiled
loop (``jax`` ``_cache_size()`` stays put). The port keys its solve loop's
cache by ``core/base.py::capture_signature``: classes, static fields, the
tensors' layouts and the sharing and aliasing pattern, never ids or
addresses; a captured block replays over its own copies of the operators'
tensors (``utils/loop.py::_Mirrors``), into which it copies a fresh
operator's. Here: every solver over a fresh operator each step (the
signature count flat after the first, x and θ the reference's within 1e-10);
sparse operators with new values on one pattern; the aliasing pattern in the
key; and the key's completeness: a graph pointed at the copies of another
operator of the same structure gives that operator's answer, for every
capture-safe operator class the port exports. The 4-rank gloo world's
fresh sharded operators are in ``tests/test_torch_parallel.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.utils import eig as JE
from linops_tpu.utils import krylov as JK
from linops_tpu_torch.core.base import capture_signature
from linops_tpu_torch.utils import loop

RTOL = 1e-10
CPU = dict(device="cpu")
N = 16
STEPS = 4


def t_(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * scale, f"{what}: max|Δ| {err:.3e} > {RTOL:g}·{scale:.3e}"


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty loop cache for the test (the module's own is put back)."""
    monkeypatch.setattr(loop, "_CACHE", type(loop._CACHE)())


def spd(rng, n, cond=10.0):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, cond, n)) @ Q.T


# ----------------------------------------------------------------------------
# 1. every solver, a fresh operator each step
# ----------------------------------------------------------------------------


def _values(name, step):
    """The arrays of step ``step``'s operator and right-hand side."""
    r = np.random.default_rng(1000 + step)
    n = N
    out = dict(d=r.random(n) + 0.5, e=r.random(n) + 1.0, b=r.standard_normal(n))
    if name in ("gmres", "bicgstab"):
        out["M"] = np.eye(n) * 4.0 + 0.3 * r.standard_normal((n, n))
    else:
        out["M"] = spd(r, n)
    if name == "lsqr":
        out["R"] = r.standard_normal((n + 6, n))
        out["d2"] = r.random(n + 6) + 0.5
        out["b"] = r.standard_normal(n + 6)
    if name == "lobpcg":
        out["X0"] = r.standard_normal((n, 2))
    return out


def _graph(pkg, arr, v, name):
    """The step's operator, in ``pkg`` (``lt`` or ``lo``), arrays by ``arr``."""
    herm = name not in ("gmres", "bicgstab")
    M = pkg.LinearOperator(arr(v["M"]), symmetric=herm, hermitian=herm)
    if name == "lsqr":
        return pkg.opDiagonal(arr(v["d2"])) @ pkg.LinearOperator(arr(v["R"])) @ \
            pkg.opDiagonal(arr(v["d"]))
    if name == "lobpcg":  # flagged hermitian: M + E
        return M + pkg.opDiagonal(arr(v["e"]))
    D = pkg.opDiagonal(arr(v["d"]))
    return D @ M @ D + pkg.opDiagonal(arr(v["e"]))  # D reached twice


def _solve(pkg, A, v, name, arr):
    """(the step's result to compare, the jitted reference function whose
    cache the step uses)."""
    b = arr(v["b"])
    if name == "cg":
        return pkg.cg(A, b, tol=1e-12, maxiter=200)[0], JK.cg
    if name == "minres":
        return pkg.minres(A, b, tol=1e-12, maxiter=200)[0], JK.minres
    if name == "gmres":
        return pkg.gmres(A, b, tol=1e-12, restart=8, maxiter=20)[0], JK.gmres
    if name == "bicgstab":
        return pkg.bicgstab(A, b, tol=1e-12, maxiter=200)[0], JK.bicgstab
    if name == "lsqr":
        return pkg.lsqr(A, b, tol=1e-12, maxiter=200)[0], JK.lsqr
    if name == "chebyshev":
        return pkg.chebyshev(A, b, 0.4, 80.0, iters=30)[0], JK.chebyshev
    if name == "matvec_chain":
        return pkg.matvec_chain(A, b, 9), JK.matvec_chain
    if name == "lobpcg":
        return pkg.lobpcg(A, k=2, X0=arr(v["X0"]), tol=1e-9, maxiter=200)[0], JE._lobpcg_jit
    # nested: cg preconditioned by an inexact cg inverse of a fresh operator
    Minv = pkg.opIterativeInverse(A, tol=1e-3, maxiter=6, solver="cg")
    return pkg.cg(A, b, tol=1e-12, maxiter=200, M=Minv)[0], JK.cg


SOLVERS = ["cg", "minres", "gmres", "bicgstab", "lsqr", "chebyshev", "matvec_chain", "lobpcg",
           "nested"]


@pytest.mark.parametrize("name", SOLVERS)
def test_fresh_operators_add_no_signature(name, fresh_cache):
    """Each step builds the operator anew from new arrays of one structure
    and solves: after the first step the port's signature count stays put,
    as the reference's jit cache does in the same steps, and each x (θ for
    LOBPCG) is the reference's within 1e-10."""
    sizes, ref_sizes = [], []
    for step in range(STEPS):
        v = _values(name, step)
        x_t, _ = _solve(lt, _graph(lt, t_, v, name), v, name, t_)
        x_j, fn = _solve(lo, _graph(lo, jnp.asarray, v, name), v, name, jnp.asarray)
        close(x_t, x_j, what=f"{name} step {step}")
        sizes.append(lt.apply_cache_sizes()["signatures"])
        ref_sizes.append(fn._cache_size())
    assert sizes[0] >= 1 and sizes[1:] == sizes[:1] * (STEPS - 1), sizes
    assert ref_sizes[1:] == ref_sizes[:1] * (STEPS - 1), ref_sizes


def test_fresh_graph_keys_alike_and_replays_its_copies():
    """Two fresh graphs of one structure have one key; a block's copies made
    from the first and refreshed from the second apply the second's values,
    copying every tensor once and nothing on a repeat."""
    r = np.random.default_rng(5)
    ops = [lt.opDiagonal(t_(r.random(N) + 1.0)) @ (lt.opEye(N) + lt.opDiagonal(t_(r.random(N))))
           for _ in range(2)]
    sig = [capture_signature(op) for op in ops]
    assert sig[0].key == sig[1].key
    mirrors = loop._Mirrors(sig[0], torch.device("cpu"))
    assert mirrors.refresh(sig[0].tensors) == 0
    assert mirrors.refresh(sig[1].tensors) == 2 * N * 8
    assert mirrors.refresh(sig[1].tensors) == 0
    v = t_(r.standard_normal(N))
    with mirrors.swapped(sig[0]):
        got = ops[0].apply(v)
    assert torch.equal(got, ops[1].apply(v))


def test_mirror_bound_turns_old_blocks_back(monkeypatch, fresh_cache):
    """A new mirror set must fit under one bound beside the sets both caches
    keep: the least recently used blocks of the solve's own cache are turned
    back into signatures seen once to make room (a set two blocks share
    counts once, and goes with the last of them); a set over the bound is
    refused with nothing dropped; a rank-local solve never drops a
    distributed block, and a distributed one decides by its own cache alone,
    then frees the rank-local cache past the bound."""
    monkeypatch.setattr(loop, "_DIST_CACHE", type(loop._DIST_CACHE)())

    class Block:  # what the bound reads of a captured block
        def __init__(self, m):
            self.mirrors, self.bound = m, []

    def held(n):
        return type("M", (), {"bytes": n})()

    shared = held(30)
    blocks = [Block(held(40)), Block(shared), Block(shared), Block(held(20))]
    for i, g in enumerate(blocks):
        loop._store(("case", i), g)

    def kept():
        return [loop._mirrors(loop._CACHE[("case", i)]) is not None for i in range(4)]

    assert loop._held(loop._CACHE) == 90
    assert not loop._make_room(101, False, 100) and kept() == [True] * 4
    assert loop._make_room(50, False, 100) and kept() == [False, True, True, True]
    assert loop._make_room(70, False, 100) and kept() == [False, False, False, True]
    assert loop._held(loop._CACHE) == 20
    loop._store(("dist", 0), Block(held(60)), dist=True)
    assert not loop._make_room(50, False, 100)  # 60 held apart: the local set is refused
    assert loop._held(loop._DIST_CACHE) == 60 and kept()[3]
    assert loop._make_room(30, True, 100) and kept()[3] is False
    assert loop._held(loop._DIST_CACHE) == 60
    assert lt.apply_cache_sizes()["signatures"] == 5 and lt.apply_cache_sizes()["graphs"] == 1


def test_copies_over_the_bound_read_the_operator_in_place(monkeypatch, fresh_cache):
    """Copies that do not fit are not made: a set over the bound, or over
    ``FREE_SHARE`` of the free memory, is refused before any copy is
    allocated; one that fits is shared by the kept blocks of one operators'
    key.
    A structure marked as not fitting is looked up by its key and the
    identity of the tensors a block reads in place: the same operator after
    a push keeps its key (the state is still copied), a fresh operator or
    an in-place edit gets another."""
    r = np.random.default_rng(8)
    cpu = torch.device("cpu")

    def graph():
        B = lt.InverseLBFGSOperator(N, mem=2, **CPU)
        B.push(r.standard_normal(N), r.random(N) + 1.0)
        return lt.opDiagonal(t_(r.random(N) + 1.0)) @ B, B

    A, B = graph()
    sig = loop._walk_ops((A,))
    need = sum(sig.tensors[i].numel() * sig.tensors[i].element_size() for i in sig.mirrored)
    monkeypatch.setattr(loop, "_free_bytes", lambda device: 10 * need)
    monkeypatch.setattr(loop, "_mirror_limit", lambda device: need - 1)
    assert loop._mirror_set(sig, sig.mirrored, False, cpu, ()) is None
    monkeypatch.setattr(loop, "_mirror_limit", lambda device: 10 * need)
    monkeypatch.setattr(loop, "_free_bytes", lambda device: 2 * need - 1)
    assert loop._mirror_set(sig, sig.mirrored, False, cpu, ()) is None
    monkeypatch.setattr(loop, "_free_bytes", lambda device: 2 * need)
    m = loop._mirror_set(sig, sig.mirrored, False, cpu, ())
    assert m is not None and m.bytes == need
    loop._store(("kept",), type("Block", (), {"mirrors": m})())
    assert loop._mirror_set(loop._walk_ops((graph()[0],)), sig.mirrored, False, cpu, ()) is m
    state = loop._mirror_set(sig, sig.state, False, cpu, (), check=False)
    assert state is not m and 0 < state.bytes < need and set(state.index) == set(sig.state)

    b = t_(r.standard_normal(N))
    ckey = loop._key("while", ("case",), sig.key, (b,))
    loop._store(ckey, loop._Unmirrored())
    key, seen, g = loop._find("while", ("case",), sig, (b,), False)
    assert key[0] == "bound" and key[1] == ckey and not seen and g is None
    B.push(r.standard_normal(N), r.random(N) + 1.0)
    assert loop._find("while", ("case",), loop._walk_ops((A,)), (b,), False)[0] == key
    assert loop._find("while", ("case",), loop._walk_ops((graph()[0],)), (b,), False)[0] != key
    A.op1.d.mul_(2.0)
    assert loop._find("while", ("case",), loop._walk_ops((A,)), (b,), False)[0] != key


# ----------------------------------------------------------------------------
# 2. sparse operators: new values on one pattern
# ----------------------------------------------------------------------------


def _pattern(seed, n=40, density=0.15):
    r = np.random.default_rng(seed)
    A = sps.random(n, n, density=density, random_state=np.random.RandomState(seed), format="csr")
    A = A + A.T + sps.eye(n) * 4.0
    return A.tocsr(), r


def _with_values(A, r):
    B = A.copy()
    B.data = r.standard_normal(B.nnz)
    return B


@pytest.mark.parametrize("fmt", ["csr", "bsr"])
def test_sparse_new_values_same_signature(fmt):
    """``opSparse`` over new values on one pattern (a user's Newton step)
    gives one key, with the lazy plans built before it is taken; the
    applies are the reference's. A pattern of other layouts (more stored
    entries, more block slots) gives another key."""
    A, r = _pattern(3, n=96, density=0.004)
    kw = dict(format=fmt, **CPU) if fmt == "csr" else dict(format="bsr", block_shape=(8, 8), **CPU)
    jkw = dict(format=fmt) if fmt == "csr" else dict(format="bsr", block_shape=(8, 8))
    keys = []
    v = r.standard_normal(A.shape[0])
    for _ in range(3):
        B = _with_values(A, r)
        op = lt.opSparse(B, **kw)
        keys.append(capture_signature(op).key)
        opj = lo.opSparse(B, **jkw)
        for mode in ("N", "T"):
            close(op.matvec(t_(v), mode=mode), opj.matvec(jnp.asarray(v), mode=mode),
                  what=f"{fmt} {mode}")
        assert capture_signature(op).key == keys[-1]  # the applies built nothing new
    assert keys[1:] == keys[:1] * 2
    wider, _ = _pattern(4, n=96, density=0.3)
    assert capture_signature(lt.opSparse(_with_values(wider, r), **kw)).key != keys[0]


def test_aliasing_pattern_is_in_the_key():
    """One tensor under two nodes and two tensors of one layout are other
    graphs (a block captured with one copy for both must not take two); one
    node reached twice and two equal nodes are too."""
    r = np.random.default_rng(6)
    d, d2 = t_(r.random(N)), t_(r.random(N))
    M = lt.LinearOperator(t_(r.standard_normal((N, N))))

    def two(a, b):  # two nodes, each holding the tensor given
        return lt.MatrixOperator(a) + lt.MatrixOperator(b)

    A, A2 = t_(r.standard_normal((N, N))), t_(r.standard_normal((N, N)))
    shared, apart = two(A, A), two(A, A2)
    assert shared.op1.A is shared.op2.A and apart.op1.A is not apart.op2.A
    assert capture_signature(shared).key != capture_signature(apart).key
    assert capture_signature(two(A2, A2)).key == capture_signature(shared).key
    assert capture_signature(two(A2, A)).key == capture_signature(apart).key
    D = lt.opDiagonal(d)
    assert capture_signature(D @ M @ D).key != \
        capture_signature(lt.opDiagonal(d) @ M @ lt.opDiagonal(d)).key


# ----------------------------------------------------------------------------
# 3. key completeness: every capture-safe class the port exports
# ----------------------------------------------------------------------------


def _flip(v):
    return -v


def _makers():
    """name -> build(rng): an operator whose structure does not depend on
    rng, with values that do."""
    n = 12

    def mat(r, m=n, k=n):
        return lt.LinearOperator(t_(r.standard_normal((m, k))))

    def sym(r):
        return lt.LinearOperator(t_(spd(r, n)), symmetric=True, hermitian=True)

    def pattern(r, fmt, **kw):
        A, _ = _pattern(11, n=n, density=0.3)
        return lt.opSparse(_with_values(A, r), format=fmt, **kw, **CPU)

    def lbfgs(cls, r, **kw):
        op = cls(n, mem=3, **kw, **CPU)
        for _ in range(4):
            s = r.standard_normal(n)
            op.push(s, 2.0 * s + 0.1 * r.standard_normal(n))
        return op

    def diag_qn(cls, r):
        op = cls(t_(r.random(n) + 0.5))
        for _ in range(3):
            op.push(r.random(n) + 0.1, r.random(n))
        return op

    return {
        "MatrixOperator": mat,
        "FunctionOperator": lambda r: lt.FunctionOperator(n, n, _flip, symmetric=True,
                                                          dtype=torch.float64,
                                                          capture_safe=True),
        "Scale": lambda r: 2.5 * mat(r),
        "Sum": lambda r: mat(r) + mat(r),
        "Compose": lambda r: mat(r) @ mat(r),
        "AdjointOperator": lambda r: lt.adjoint(mat(r)),
        "TransposeOperator": lambda r: lt.transpose(mat(r)),
        "ConjugateOperator": lambda r: lt.conj(mat(r)),
        "Eye": lambda r: lt.opEye(n) @ mat(r),
        "UniversalEye": lambda r: mat(r) + lt.opEye() @ mat(r),
        "Ones": lambda r: lt.opOnes(n, n, **CPU) + mat(r),
        "Zeros": lambda r: lt.opZeros(n, n, **CPU) + mat(r),
        "DiagonalOperator": lambda r: lt.opDiagonal(t_(r.standard_normal(n))),
        "RestrictionOperator": lambda r: lt.opRestriction(r.choice(n, 7, replace=False), n,
                                                          **CPU).H @ mat(r, 7, n),
        "HCatOperator": lambda r: lt.hcat(mat(r, n, 5), mat(r, n, 7)),
        "VCatOperator": lambda r: lt.vcat(mat(r, 5, n), mat(r, 7, n)),
        "BlockDiagonalOperator": lambda r: lt.BlockDiagonalOperator(mat(r, 5, 5), mat(r, 7, 7)),
        "ShiftedOperator": lambda r: lt.ShiftedOperator(sym(r), float(r.random())),
        "PermutationOperator": lambda r: lt.opPermutation(r.permutation(n), **CPU),
        "KronOperator": lambda r: lt.kron(mat(r, 3, 3), mat(r, 4, 4)),
        "InverseOperator": lambda r: lt.opInverse(t_(spd(r, n)), **CPU),
        "CholeskyOperator": lambda r: lt.opCholesky(t_(spd(r, n)), **CPU),
        "LDLOperator": lambda r: lt.opLDL(t_(spd(r, n)), **CPU),
        "HouseholderOperator": lambda r: lt.opHouseholder(t_(r.standard_normal(n)), **CPU),
        "HermitianOperator": lambda r: lt.opHermitian(t_(r.standard_normal(n)),
                                                      t_(r.standard_normal((n, n))), **CPU),
        "IterativeInverseOperator": lambda r: lt.opIterativeInverse(sym(r), tol=1e-12,
                                                                    maxiter=40, solver="cg"),
        "COOOperator": lambda r: pattern(r, "coo"),
        "CSROperator": lambda r: pattern(r, "csr"),
        "ELLOperator": lambda r: pattern(r, "ell"),
        "BSROperator": lambda r: pattern(r, "bsr", block_shape=(4, 4)),
        "RoutedCSROperator": lambda r: pattern(r, "routed"),
        "ReorderedOperator": lambda r: pattern(r, "csr", reorder="rcm"),
        "DIAOperator": lambda r: lt.opDIA(t_(r.standard_normal((3, n))), (-1, 0, 2), **CPU),
        "StencilOperator": lambda r: lt.opStencil((n,), (-1, 0, 1),
                                                  t_(r.standard_normal((3, n))), **CPU),
        "Stencil2DOperator": lambda r: lt.opStencil2D(4, 3, ((0, 1), (0, 0), (1, 0)),
                                                      t_(r.standard_normal((3, 4, 3))),
                                                      **CPU),
        "LBFGSOperator": lambda r: lbfgs(lt.LBFGSOperator, r),
        "InverseLBFGSOperator": lambda r: lbfgs(lt.InverseLBFGSOperator, r),
        "LSR1Operator": lambda r: lbfgs(lt.LSR1Operator, r),
        "DiagonalPSB": lambda r: diag_qn(lt.DiagonalPSB, r),
        "DiagonalAndrei": lambda r: diag_qn(lt.DiagonalAndrei, r),
        "DiagonalBFGS": lambda r: diag_qn(lt.DiagonalBFGS, r),
        "SpectralGradient": lambda r: lt.SpectralGradient(float(r.random()) + 0.5, n, **CPU),
        "NystromPreconditioner": lambda r: lt.NystromPreconditioner(
            t_(np.linalg.qr(r.standard_normal((n, 3)))[0]), t_(r.random(3) + 1.0), 0.1),
    }


MAKERS = _makers()


def test_every_capture_safe_class_has_a_maker():
    """The completeness test below covers every operator class the package
    exports, but those that are never capture-safe (a host factor, a
    timer)."""
    exported = {getattr(lt, name) for name in lt.__all__
                if isinstance(getattr(lt, name), type)
                and issubclass(getattr(lt, name), lt.AbstractLinearOperator)}
    never = {lt.AbstractLinearOperator, lt.TimedOperator, lt.SparseInverseOperator,
             lt.DiagonalQNOperator}  # DiagonalQNOperator: the family's base
    assert exported - never == {getattr(lt, name) for name in MAKERS}


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_key_completeness_swap(name):
    """Operator A pointed at the copies of operator B's tensors (a captured
    block's mirrors, made from A and refreshed from B, of one key) applies
    as B in every mode and solves as B: nothing an apply reads escapes the
    key and the copies."""
    A, B = (MAKERS[name](np.random.default_rng(s)) for s in (20, 21))
    v = t_(np.random.default_rng(22).standard_normal(A.ncol))
    u = t_(np.random.default_rng(23).standard_normal(A.nrow))
    want = {}
    for op in (A, B):  # every mode once: packs what a first T apply packs
        want = {m: op.matvec(v if m in ("N", "C") else u, mode=m) for m in ("N", "T", "H", "C")}
    sa, sb = capture_signature(A), capture_signature(B)
    assert sa.key == sb.key, name
    assert A.capture_safe
    mirrors = loop._Mirrors(sa, torch.device("cpu"))
    assert mirrors.refresh(sb.tensors) > 0 or not sa.mirrored  # B's tensors in A's copies
    with mirrors.swapped(capture_signature(A)):
        for m in ("N", "T", "H", "C"):
            got = A.matvec(v if m in ("N", "C") else u, mode=m)
            assert torch.allclose(got, want[m], rtol=1e-12, atol=1e-12), (name, m)
        if A.nrow == A.ncol:
            got = lt.matvec_chain(A, v, 3, normalize=False)
    if A.nrow == A.ncol:
        assert torch.allclose(got, lt.matvec_chain(B, v, 3, normalize=False), rtol=1e-12,
                              atol=1e-12), name
