"""Spectral routines, estimators and checks on distributed operators, on a
4-rank gloo world on the CPU (and a 1-rank one), against the reference on
its 8 virtual devices (``tests/conftest.py``), in f64.

Three hermitian positive-definite operators of n = 64: ``shard_operator``
of a dense ``G Gᵀ + 64 I``, ``banded_partition`` of a band-3 matrix, and
``stencil_partition_2d`` of an anisotropic 8 × 8 five-point stencil (its
vectors in the mesh's blocked order: results are compared in the grid's
natural order). Each rank runs every case below (torch and the port only,
no jax); rank 0 returns numpy results, placements, collective counts and
whether every rank's results were the same bits.

- With one generator seeded alike on every rank: each routine's values
  against the unsharded port call on the same matrix in the operator's
  layout (rtol 1e-10 unless stated), its outputs' placements against the
  reference's, the same values at world size 1 and 4.
- With no generator: every rank returns the same bits (one seed agreed
  for the call), within the routine's tolerance of the truth.
- LOBPCG from a numpy X0 and constraint Y (plain, and placed as DTensors
  with a DTensor preconditioner) against the reference's θ and subspace;
  the estimators against the exact trace, diagonal and log-determinant;
  svds and rsvd against ``numpy.linalg.svd``.
- A plain input to a distributed operator (``op * v``, ``cg``,
  ``matvec_chain``, ``power_iteration``): the reference's placement.
- The collectives of one LOBPCG iteration, one svds iteration and one
  probe batch: the operator's own and a few all-reduces, no all-gather of
  an (n, ·) block.
"""

import hashlib
import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
RTOL = 1e-10
N = 64
CPU = dict(device="cpu")
GRID = (8, 8, [4.0, -1.0, -1.0, -0.7, -0.7])  # grid and symmetric anisotropic coefficients
KINDS = ("shard", "banded", "stencil2d")
SEED = 17
# iterations allowed to LOBPCG, svds and normest: enough to converge from any
# start (the dense matrix's two smallest eigenvalues lie 0.07 % apart; the
# stencil's two largest singular values 3 %)
MAXITER = 1000
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def t_(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), f"max|Δ| {err:.3e} > {rtol:g}·max|ref|"


def dense_spd(seed=0, n=N):
    """The Motivation's operator: G Gᵀ + 64 I."""
    G = np.random.default_rng(seed).standard_normal((n, n))
    return G @ G.T + 64.0 * np.eye(n)


def banded_spd(seed=1, n=N, band=3):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for k in range(1, band + 1):
        d = rng.uniform(-1.0, 1.0, n - k)
        A += np.diag(d, k) + np.diag(d, -k)
    return A + np.diag(np.abs(A).sum(axis=1) + 1.0)


def stencil_dense():
    """The 5-point stencil of ``GRID`` as a dense matrix, row-major grid."""
    ny, nx, (c, cn, cs, cw, ce) = GRID
    A = np.zeros((ny * nx, ny * nx))
    for i in range(ny):
        for j in range(nx):
            r = i * nx + j
            A[r, r] = c
            for di, dj, w in ((-1, 0, cn), (1, 0, cs), (0, -1, cw), (0, 1, ce)):
                if 0 <= i + di < ny and 0 <= j + dj < nx:
                    A[r, (i + di) * nx + j + dj] = w
    return A


def natural_matrix(kind):
    return {"shard": dense_spd, "banded": banded_spd, "stencil2d": stencil_dense}[kind]()


def kind_of_placements(placements) -> str:
    """The port's placement: ``row`` when some mesh dimension splits the
    rows, ``replicated`` when none does."""
    names = [type(p).__name__ for p in placements]
    if any(n == "Shard" for n in names):
        return "row"
    assert all(n == "Replicate" for n in names), names
    return "replicated"


def kind_of_sharding(arr) -> str:
    """The reference's placement of an output, in the same words (a Python
    number: its type's name)."""
    if not hasattr(arr, "sharding"):
        return type(arr).__name__
    sh = arr.sharding
    if sh.is_fully_replicated:
        return "replicated"
    assert sh.shard_shape(arr.shape)[0] < arr.shape[0], sh
    return "row"


# --------------------------------------------------------------------------
# The rank side
# --------------------------------------------------------------------------


def distributed_ops(mesh):
    """kind -> (the distributed operator, the unsharded port operator on
    the same matrix in its layout, the layout index of each natural row,
    a function placing a natural-order block in the operator's layout)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import (NamedSharding, P, banded_partition, make_mesh2d,
                                           row_sharding, shard_operator, stencil_partition_2d)

    W = mesh.size()
    ident = np.arange(N)
    row = row_sharding(mesh).place
    out = {"shard": (shard_operator(lt.LinearOperator(t_(dense_spd()), symmetric=True,
                                                      hermitian=True, **CPU), mesh),
                     dense_spd(), ident, row),
           "banded": (banded_partition(banded_spd(), mesh, symmetric=True, hermitian=True),
                      banded_spd(), ident, row)}
    ny, nx, coeffs = GRID
    py = 2 if W == 4 else 1
    L2 = stencil_partition_2d(t_(coeffs), ny, nx, make_mesh2d(py, W // py, device="cpu"))
    lay = L2.vec_to_grid(torch.arange(N, dtype=torch.float64)).reshape(-1).long().numpy()
    inv = np.argsort(lay)  # natural index of each layout index
    A_lay = stencil_dense()[np.ix_(inv, inv)]
    place2 = NamedSharding(L2.mesh, P(("gy", "gx"))).place
    out["stencil2d"] = (L2, A_lay, lay, lambda X: place2(X[inv] if X.ndim == 1 else X[inv, :]))
    return {k: (op, lt.LinearOperator(t_(A), symmetric=True, hermitian=True, **CPU), lay, pl)
            for k, (op, A, lay, pl) in out.items()}


def gen(seed=SEED):
    return torch.Generator().manual_seed(seed)


def routines():
    """name -> call(op, generator): the routines of the Motivation table."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.utils.eig import nystrom_preconditioner

    def nystrom(o, g):
        P = nystrom_preconditioner(o, 8, generator=g)
        return P.U, P.lam

    return {
        "lobpcg": lambda o, g: lt.lobpcg(o, k=2, maxiter=MAXITER, generator=g),
        "svds": lambda o, g: lt.svds(o, k=2, maxiter=MAXITER, generator=g),
        "rsvd": lambda o, g: lt.rsvd(o, k=2, generator=g),
        "estimate_diagonal": lambda o, g: lt.estimate_diagonal(o, generator=g),
        "estimate_trace": lambda o, g: lt.estimate_trace(o, generator=g),
        "estimate_logdet": lambda o, g: lt.estimate_logdet(o, probes=64, lanczos_steps=40,
                                                           generator=g),
        "nystrom_preconditioner": nystrom,
        "normest": lambda o, g: lt.normest(o, tol=1e-12, maxiter=MAXITER, generator=g),
        "check_ctranspose": lambda o, g: lt.check_ctranspose(o, g),
        "check_hermitian": lambda o, g: lt.check_hermitian(o, g),
    }


ROUTINES = ("lobpcg", "svds", "rsvd", "estimate_diagonal", "estimate_trace", "estimate_logdet",
            "nystrom_preconditioner", "normest", "check_ctranspose", "check_hermitian")


def describe(x, lay):
    """An output as (placement kind, value): a tensor whose rows are the
    operator's in natural row order (gathered), a number as it is."""
    from linops_tpu_torch.parallel.comm import gather_full, is_dtensor

    if isinstance(x, tuple):
        return tuple(describe(y, lay) for y in x)
    if not isinstance(x, torch.Tensor):
        return type(x).__name__, x
    kind = kind_of_placements(x.placements) if is_dtensor(x) else "plain"
    v = gather_full(x).detach().numpy()
    if v.ndim and v.shape[0] == N:
        v = v[lay]
    return kind, v


def digest(value) -> str:
    """The bits of a result, for comparing ranks."""
    h = hashlib.sha256()
    for kind, v in (value if isinstance(value[0], tuple) else (value,)):
        h.update(repr(kind).encode())
        h.update(np.asarray(v).tobytes() if not isinstance(v, (bool, int, float)) else
                 repr(v).encode())
    return h.hexdigest()


def same_on_every_rank(value) -> bool:
    import torch.distributed as dist

    mine = digest(value)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return all(d == mine for d in every)


@case
def seeded_routines(mesh):
    """Every routine with one generator seeded alike on every rank, over
    each distributed operator and its unsharded twin."""
    out = {}
    for kind, (op, op_un, lay, _) in distributed_ops(mesh).items():
        r = {}
        for name, call in routines().items():
            got = describe(call(op, gen()), lay)
            r[name] = dict(got=got, un=describe(call(op_un, gen()), lay),
                           same=same_on_every_rank(got))
        out[kind] = r
    return out


@case
def default_generator(mesh):
    """Every routine with no generator: one seed agreed for the call."""
    out = {}
    for kind, (op, _, lay, _) in distributed_ops(mesh).items():
        r = {}
        for name, call in routines().items():
            got = describe(call(op, None), lay)
            r[name] = dict(got=got, same=same_on_every_rank(got))
        out[kind] = r
    return out


def given_blocks(kind):
    """A numpy-seeded start X0 (n, 2) and the constraint Y: the eigenvector
    of the smallest eigenvalue (LOBPCG then finds the next two), natural
    order."""
    X0 = np.random.default_rng(23).standard_normal((N, 2))
    return X0, np.linalg.eigh(natural_matrix(kind))[1][:, :1]


@case
def lobpcg_from_given_blocks(mesh):
    """LOBPCG from a numpy-seeded X0 and constraint Y, plain and placed as
    DTensors in the operator's layout (with a DTensor Jacobi preconditioner
    for the placed call, where the operator is a sharded one)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    out = {}
    for kind, (op, op_un, lay, place) in distributed_ops(mesh).items():
        X0, Y = given_blocks(kind)
        inv = np.argsort(lay)
        X0l, Yl = X0[inv], Y[inv]  # the natural blocks in the operator's layout
        d = 1.0 / np.diag(natural_matrix(kind))[inv]
        M = shard_operator(lt.opDiagonal(t_(d)), mesh) if kind != "stencil2d" else \
            lt.opDiagonal(t_(d))
        call = lambda o, x0, y, m=None: lt.lobpcg(o, k=2, X0=x0, Y=y, M=m,  # noqa: E731
                                                  maxiter=500)
        plain = describe(call(op, t_(X0l), t_(Yl)), lay)
        placed = describe(call(op, place(t_(X0)), place(t_(Y)), M), lay)
        out[kind] = dict(plain=plain, placed=placed,
                         un=describe(call(op_un, t_(X0l), t_(Yl)), lay),
                         un_m=describe(call(op_un, t_(X0l), t_(Yl), lt.opDiagonal(t_(d))), lay),
                         same=same_on_every_rank(placed))
    return out


@case
def plain_inputs(mesh):
    """A plain vector given to a distributed operator counts as replicated:
    ``op * v``, ``op.T * v``, ``cg``, ``matvec_chain`` and
    ``power_iteration``, against the unsharded calls."""
    import linops_tpu_torch as lt

    v = np.random.default_rng(29).standard_normal(N)
    out = {}
    for kind, (op, op_un, lay, _) in distributed_ops(mesh).items():
        vl = t_(v[np.argsort(lay)])
        calls = {"N": lambda o: o * vl, "T": lambda o: o.T * vl,
                 "cg": lambda o: lt.cg(o, vl, tol=1e-12, maxiter=200),
                 "matvec_chain": lambda o: lt.matvec_chain(o, vl, 3),
                 "power_iteration": lambda o: lt.power_iteration(o, vl, 5)}
        out[kind] = {name: dict(got=describe(c(op), lay), un=describe(c(op_un), lay))
                     for name, c in calls.items()}
    return out


@case
def collectives(mesh):
    """The collectives of one block apply, one LOBPCG iteration (gram and
    direct bases), one svds iteration and one probe batch."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts
    from linops_tpu_torch.utils import loop

    def per_iteration(call):
        # masked blocks of loop.BLOCK iterations: one block against two
        one, two = (collective_counts(lambda: call(m)) for m in (loop.BLOCK, 2 * loop.BLOCK))
        return {c: (two[c] - one[c]) / loop.BLOCK for c in one}

    out = {}
    for kind, (op, _, _, place) in distributed_ops(mesh).items():
        block = place(t_(np.random.default_rng(31).standard_normal((N, 6))))
        # the adjoint through the public entry, which makes a pending partial
        # sum whole, as the reference's compiled apply returns it
        r = {"apply": collective_counts(lambda: op.apply_matrix(block, "N")),
             "apply_h": collective_counts(lambda: lt.matmat(op, block, "H"))}
        for basis in ("gram", "direct"):
            r["lobpcg_" + basis] = per_iteration(
                lambda m: lt.lobpcg(op, k=2, tol=0.0, maxiter=m, basis=basis, generator=gen()))
        r["svds"] = per_iteration(lambda m: lt.svds(op, k=2, tol=0.0, maxiter=m,
                                                    generator=gen()))
        r["hutchinson"] = collective_counts(
            lambda: lt.estimate_trace(op, probes=6, method="hutchinson", generator=gen()))
        r["diagonal"] = collective_counts(lambda: lt.estimate_diagonal(op, probes=6,
                                                                       generator=gen()))
        r["seed"] = collective_counts(lambda: lt.estimate_diagonal(op, probes=6))
        out[kind] = r
    return out


@case
def solve_keys(mesh):
    """The loop cache's keys of LOBPCG, svds and normest over the sharded
    dense operator (two solves each) and over its unsharded twin (two
    more): one key each side, never shared (the row blocks' layout is in
    LOBPCG's key, normest's DTensor state in its own)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.utils import loop

    op, op_un, _, _ = distributed_ops(mesh)["shard"]
    calls = {"lobpcg": lambda o: lt.lobpcg(o, k=2, tol=0.0, maxiter=8, generator=gen()),
             "svds": lambda o: lt.svds(o, k=2, tol=0.0, maxiter=8, generator=gen()),
             "normest": lambda o: lt.normest(o, tol=0.0, maxiter=8, generator=gen())}
    out = {}
    for name, call in calls.items():
        loop.clear_cache()
        call(op), call(op)
        dist = set(loop._DIST_CACHE)
        call(op_un), call(op_un)
        out[name] = dict(dist=len(dist), local=len(loop._CACHE), shared=len(dist & set(loop._CACHE)),
                         dist_after=len(loop._DIST_CACHE))
    loop.clear_cache()
    return out


def world_main():
    """Run in each rank of the world: every case, in order."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dist.get_world_size(), device="cpu")
    out = {}
    for name, fn in CASES.items():
        try:
            out[name] = ("ok", fn(mesh))
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out if dist.get_rank() == 0 else None


# --------------------------------------------------------------------------
# The pytest side
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    """The 4-rank world's results and the 1-rank world's."""
    from linops_tpu_torch.parallel import launch

    target = os.path.abspath(__file__) + ":world_main"
    return {w: launch.run(target, w, backend="gloo", timeout=600)[0] for w in (WORLD, 1)}


@pytest.fixture(scope="module")
def world(worlds):
    return worlds[WORLD]


def result(world, name):
    status, value = world[name]
    if status != "ok":
        pytest.fail(f"case {name} failed in the world:\n{value}")
    return value


@pytest.fixture(scope="module")
def ref():
    """The reference package and its distributed operators on its
    8-device mesh (the stencil on a (4, 2) mesh)."""
    import jax
    import jax.numpy as jnp

    import linops_tpu as lo
    from linops_tpu.parallel import (banded_partition, make_mesh, make_mesh2d, row_sharding,
                                     shard_operator, stencil_partition_2d)

    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    mesh = make_mesh(8)
    ny, nx, coeffs = GRID
    L2 = stencil_partition_2d(jnp.asarray(coeffs), ny, nx, make_mesh2d(4, 2))
    lay = np.asarray(L2.vec_to_grid(jnp.arange(N, dtype=jnp.float64))).reshape(-1).astype(int)
    ops = {"shard": (shard_operator(lo.LinearOperator(dense_spd(), symmetric=True,
                                                      hermitian=True), mesh), np.arange(N)),
           "banded": (banded_partition(banded_spd(), mesh, symmetric=True, hermitian=True),
                      np.arange(N)),
           "stencil2d": (L2, lay)}
    return lo, mesh, ops, lambda v: jax.device_put(jnp.asarray(v), row_sharding(mesh))


def reference_call(lo, name, op):
    import jax

    from linops_tpu.utils.eig import nystrom_preconditioner

    key = jax.random.PRNGKey(0)
    if name == "nystrom_preconditioner":
        P = nystrom_preconditioner(op, 8, key=key)
        return P.U, P.lam
    fn = getattr(lo, name)
    kw = {"lobpcg": dict(k=2, maxiter=300), "svds": dict(k=2, maxiter=300),
          "rsvd": dict(k=2)}.get(name, {})
    if name.startswith("check_"):
        return fn(op, key=key)
    return fn(op, key=key, **kw)


def _items(value):
    return value if isinstance(value[0], tuple) else (value,)


def kinds_of(value):
    return tuple(kind for kind, _ in _items(value))


def values_of(value):
    return [v for _, v in _items(value)]


def subspace(X):
    Q, _ = np.linalg.qr(np.asarray(X))
    return Q @ Q.T


@pytest.mark.parametrize("name", ROUTINES)
@pytest.mark.parametrize("kind", KINDS)
def test_placements_match_the_reference(world, ref, kind, name):
    """Every output comes back in the reference's placement: blocks split
    as the reference splits them, small results replicated, scalars as
    Python numbers."""
    lo, _, ops, _ = ref
    got = result(world, "seeded_routines")[kind][name]["got"]
    want = reference_call(lo, name, ops[kind][0])
    want = want if isinstance(want, tuple) else (want,)
    assert kinds_of(got) == tuple(kind_of_sharding(w) for w in want)


def up_to_sign(a, b):
    """Block ``a`` with each column's sign turned to match ``b``'s (an
    eigenvector's or singular vector's sign is free)."""
    a, b = np.asarray(a), np.asarray(b)
    return a * np.where(np.sum(a * b, axis=0) < 0, -1.0, 1.0)


def agree(name, got, want):
    """A routine's outputs against another call's. rtol 1e-10, except: the
    iterative solvers' vectors (up to sign) and residual norms within their
    stopping tolerance (1e-6 relative to θ or s) and their counts within two
    (a stopping test near its threshold moves with rounding: the banded
    matrix's second and third singular values lie about 1 % apart);
    normest's count within one."""
    got, want = values_of(got), values_of(want)
    assert len(got) == len(want)
    if name in ("lobpcg", "svds"):
        lam = got[0] if name == "lobpcg" else got[1]
        scale = max(1.0, float(np.abs(lam).max()))
        close(lam, want[0] if name == "lobpcg" else want[1])
        blocks = (1,) if name == "lobpcg" else (0, 2)
        for i in blocks:
            close(up_to_sign(got[i], want[i]), want[i], 1e-4)
        res = got[-2]
        assert np.abs(res - want[-2]).max() <= 1e-6 * scale
        assert abs(got[-1] - want[-1]) <= 2
        return
    for i, (a, b) in enumerate(zip(got, want)):
        if name == "normest" and i == 1:
            assert abs(a - b) <= 1
        elif isinstance(a, (bool, int)):
            assert a == b
        elif np.ndim(a) == 2:
            close(up_to_sign(a, b), b)
        else:
            close(a, b)


@pytest.mark.parametrize("name", ROUTINES)
@pytest.mark.parametrize("kind", KINDS)
def test_seeded_call_matches_the_unsharded_call(world, kind, name):
    """One generator seeded alike: the unsharded call's values (``agree``),
    the same bits on every rank."""
    r = result(world, "seeded_routines")[kind][name]
    assert r["same"]
    agree(name, r["got"], r["un"])


@pytest.mark.parametrize("name", ROUTINES)
def test_world_size_1_gives_the_unsharded_bits(worlds, name):
    """At world size 1 the sharded dense operator's call is the unsharded
    call bit for bit, placements aside (its twin applies the same matrix
    product; the halo operators' arithmetic differs from a dense product)."""
    r = result(worlds[1], "seeded_routines")["shard"][name]
    for a, b in zip(values_of(r["got"]), values_of(r["un"])):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("name", ROUTINES)
@pytest.mark.parametrize("kind", ("shard", "banded"))
def test_one_generator_gives_one_result_at_world_size_1_and_4(worlds, kind, name):
    """The same generator at world size 1 and 4: the same values
    (``agree``) in the same placements (the whole block is drawn on every
    rank and each keeps its rows)."""
    four = result(worlds[WORLD], "seeded_routines")[kind][name]["got"]
    one = result(worlds[1], "seeded_routines")[kind][name]["got"]
    assert kinds_of(four) == kinds_of(one)
    agree(name, four, one)


def rsvd_bound(A, U, s, V):
    """The reference test's bound: ‖A − U diag(s) Vᵀ‖_F within 3 times the
    best rank-k error."""
    sv = np.linalg.svd(A, compute_uv=False)
    best = np.sqrt(np.sum(sv[len(s):] ** 2))
    assert np.linalg.norm(A - (U * s) @ V.T) < 3 * best + 1e-10
    assert np.all(s <= sv[:len(s)] * (1 + 1e-10))


def truth(kind):
    A = natural_matrix(kind)
    lam = np.linalg.eigvalsh(A)
    return A, lam


def residual_floor(A, X, theta):
    """The rounding of one residual column ‖A x − x θ‖ evaluated in f64, by
    column: n eps (‖|A|‖₂ + |θ|) ‖x‖ (Higham's γ_n bound). LOBPCG reports
    the residual of its recurrence's A X, the check takes a fresh product,
    and near convergence the two differ by up to this much whatever the
    algorithm: the reference's LOBPCG misses ``1.01 res`` alone on the same
    starting blocks as the port's (``tests/torch_lobpcg_reference_draws.py``)."""
    eps = np.finfo(np.float64).eps
    return (A.shape[0] * eps * (np.linalg.norm(np.abs(A), 2) + np.abs(theta))
            * np.linalg.norm(X, axis=0))


@pytest.mark.parametrize("name", ROUTINES)
@pytest.mark.parametrize("kind", KINDS)
def test_default_generator_is_one_draw_for_every_rank(world, kind, name):
    """No generator: every rank returns the same bits (before the seed was
    agreed each rank drew its own block, and a sharded apply mixed rows of
    four different blocks), and the value is right within the routine's
    tolerance."""
    r = result(world, "default_generator")[kind][name]
    assert r["same"]
    A, lam = truth(kind)
    vals = values_of(r["got"])
    if name == "lobpcg":  # converged to tol 1e-6: residual and θ within it
        theta, X, res, it = vals
        assert it < MAXITER and np.all(res <= 1e-6 * np.maximum(np.abs(theta), 1.0))
        assert np.all(np.linalg.norm(A @ X - X * theta, axis=0)
                      <= 1.01 * res + residual_floor(A, X, theta))
        assert np.all(np.abs(theta - lam[:2]) <= res)
    elif name == "svds":
        U, s, V, res, _ = vals
        assert np.all(np.abs(s - lam[::-1][:2]) <= 1e-6 * s[0])
        close(A @ V, U * s, 1e-6)
    elif name == "rsvd":
        rsvd_bound(A, *vals)
    elif name == "estimate_diagonal":
        d, se = vals
        assert np.all(np.abs(d - np.diag(A)) <= 6 * np.maximum(se, 1e-12))
    elif name == "estimate_trace":
        est, se = vals
        assert abs(est - np.trace(A)) <= 6 * max(se, 1e-10)
    elif name == "estimate_logdet":
        est, se = vals
        assert abs(est - np.sum(np.log(lam))) <= 6 * max(se, 1e-10)
    elif name == "nystrom_preconditioner":  # Â ≼ A: each eigenvalue below A's
        U, lam_n = vals
        assert np.all(np.isfinite(U)) and lam_n[-1] > 0
        assert np.all(lam_n <= lam[::-1][:len(lam_n)] * (1 + 1e-10))
        close(U.T @ U, np.eye(U.shape[1]), 1e-10)
    elif name == "normest":  # converged to tol 1e-12
        e, _ = vals
        assert abs(e - lam[-1]) <= 1e-10 * lam[-1]
    else:
        assert vals == [True]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", ["plain", "placed"])
def test_lobpcg_from_given_blocks_matches_the_reference(world, ref, kind, form):
    """LOBPCG from a numpy X0 and constraint Y: the unsharded call's θ and
    X, the reference's θ and subspace (the placed call with a DTensor
    preconditioner against the reference's with the same M), X split by
    rows and θ replicated as the reference's."""
    import jax.numpy as jnp

    lo, _, ops, _ = ref
    r = result(world, "lobpcg_from_given_blocks")[kind]
    got = r[form]
    un = r["un_m"] if form == "placed" else r["un"]
    close(got[0][1], un[0][1])
    close(subspace(got[1][1]), subspace(un[1][1]), 1e-5)
    op_j, lay_j = ops[kind]
    X0, Y = given_blocks(kind)
    inv = np.argsort(lay_j)
    M = lo.opDiagonal(jnp.asarray(1.0 / np.diag(natural_matrix(kind))[inv])) \
        if form == "placed" else None
    th_j, X_j, _, _ = lo.lobpcg(op_j, k=2, X0=jnp.asarray(X0[inv]), Y=jnp.asarray(Y[inv]), M=M,
                                maxiter=500)
    close(got[0][1], np.asarray(th_j))
    close(got[0][1], truth(kind)[1][1:3], 1e-8)
    close(subspace(got[1][1]), subspace(np.asarray(X_j)[lay_j]), 1e-5)
    assert (got[0][0], got[1][0]) == (kind_of_sharding(th_j), kind_of_sharding(X_j))
    assert r["same"]


@pytest.mark.parametrize("kind", KINDS)
def test_estimators_against_the_exact_values(world, kind):
    """Trace and diagonal within 6 standard errors of the exact ones, the
    log-determinant within 6 (the reference test's tolerance), with one
    seeded generator."""
    r = result(world, "seeded_routines")[kind]
    A, lam = truth(kind)
    est, se = values_of(r["estimate_trace"]["got"])
    assert abs(est - np.trace(A)) <= 6 * max(se, 1e-10)
    d, sed = values_of(r["estimate_diagonal"]["got"])
    assert np.all(np.abs(d - np.diag(A)) <= 6 * np.maximum(sed, 1e-12))
    est, se = values_of(r["estimate_logdet"]["got"])
    assert abs(est - np.sum(np.log(lam))) <= 6 * max(se, 1e-10)


@pytest.mark.parametrize("name", ["svds", "rsvd"])
@pytest.mark.parametrize("kind", KINDS)
def test_singular_values_against_numpy(world, kind, name):
    """svds' s within its stopping tolerance of ``numpy.linalg.svd``'s;
    rsvd within the reference test's bound (two power iterations of a
    randomized range leave a slowly decaying spectrum's s approximate)."""
    r = result(world, "seeded_routines")[kind][name]
    A = natural_matrix(kind)
    s_np = np.linalg.svd(A, compute_uv=False)[:2]
    if name == "svds":
        assert np.all(np.abs(values_of(r["got"])[1] - s_np) <= 1e-6 * s_np[0])
    else:
        rsvd_bound(A, *values_of(r["got"]))


PLAIN_INPUTS = ("N", "T", "cg", "matvec_chain", "power_iteration")


@pytest.mark.parametrize("name", PLAIN_INPUTS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_input_comes_back_in_the_reference_placement(world, ref, kind, name):
    """A plain vector given to a distributed operator counts as replicated:
    the unsharded call's values, each output in the reference's placement
    (x and the vectors split by rows, a residual norm or eigenvalue
    replicated)."""
    import jax.numpy as jnp

    lo, _, ops, _ = ref
    q = result(world, "plain_inputs")[kind][name]
    got, un = q["got"], q["un"]
    got, un = (got, un) if isinstance(got[0], tuple) else ((got,), (un,))
    for i, ((_, a), (_, b)) in enumerate(zip(got, un)):
        if isinstance(a, (bool, int)):
            assert a == b
        elif name == "cg" and i == 2:  # residual norms at the rounding level of ‖b‖
            assert max(a, b) <= 1e-12 * np.linalg.norm(got[0][1]) * 1e3
        else:
            close(a, b)
    op_j, lay_j = ops[kind]
    v = jnp.asarray(np.random.default_rng(29).standard_normal(N)[np.argsort(lay_j)])
    want = {"N": lambda: op_j * v, "T": lambda: op_j.T * v,
            "cg": lambda: lo.cg(op_j, v, tol=1e-12, maxiter=200),
            "matvec_chain": lambda: lo.matvec_chain(op_j, v, 3),
            "power_iteration": lambda: lo.power_iteration(op_j, v, 5)}[name]()
    want = want if isinstance(want, tuple) else (want,)
    kinds = tuple(kind_of_sharding(w) for w in want)
    if name == "cg":  # the count is a Python int in the port (its convention for counts)
        kinds = (kinds[0], "int", kinds[2])
    assert tuple(k for k, _ in got) == kinds


@pytest.mark.parametrize("kind", KINDS)
def test_collectives_per_iteration_and_probe_batch(world, kind):
    """One LOBPCG iteration issues the operator's own collectives for its
    one (n, 3k) block apply, and all-reduces of small Grams and norms only
    (the gram basis: the joint Gram and the residual norms; the direct
    basis: its Gram–Schmidt and SVQB Grams too); one svds iteration the
    Gram operator's two applies (over the dense sharded operator its block
    is replicated: one all-reduce of the adjoint's partial sums) and the
    same small all-reduces; one probe batch the operator's collectives and
    one all-reduce of the per-probe sums. No all-gather beyond the sharded
    dense apply's own gather of its input: no (n, ·) block is gathered. A
    reduction over a mesh of d dimensions is one all-reduce per dimension;
    a seed agreed for the call is one more."""
    r = result(world, "collectives")[kind]
    op = r["apply"]
    d = 2 if kind == "stencil2d" else 1
    # a halo operator's block apply is one exchange of k-wide strips, as the
    # reference's vmapped apply: 2 and 4 collective-permutes for the 6 columns
    halo = {"banded": {"collective-permute": 2}, "stencil2d": {"collective-permute": 4}}
    assert op == dict(dict.fromkeys(op, 0), **{"shard": {"all-gather": 1}, **halo}[kind])
    assert r["apply_h"] == dict(dict.fromkeys(op, 0),
                                **{"shard": {"all-reduce": 1}, **halo}[kind])
    assert r["lobpcg_gram"] == dict(op, **{"all-reduce": 2 * d})
    assert r["lobpcg_direct"] == dict(op, **{"all-reduce": 8 * d})
    svds = dict.fromkeys(op, 0)
    svds.update({"all-reduce": 1} if kind == "shard" else
                {"collective-permute": 2 * op["collective-permute"], "all-reduce": 2 * d})
    assert r["svds"] == svds
    assert r["hutchinson"] == dict(op, **{"all-reduce": d})
    assert r["diagonal"] == op
    assert r["seed"] == dict(op, **{"all-reduce": d})


def test_seed_agreement_issues_nothing_at_world_size_1(worlds):
    """At world size 1 a fresh generator issues no collective."""
    r = result(worlds[1], "collectives")["shard"]
    assert r["seed"] == r["diagonal"]


@pytest.mark.parametrize("name", ["lobpcg", "svds", "normest"])
def test_distributed_and_plain_solves_take_their_own_keys(world, name):
    """A repeated distributed solve keeps one key (on the card it replays
    its captured block) and the unsharded solve over the same matrix takes
    another: a block never serves both."""
    r = result(world, "solve_keys")[name]
    assert r == dict(dist=1, local=1, shared=0, dist_after=1), r
