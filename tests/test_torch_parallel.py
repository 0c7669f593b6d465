"""The distributed layer of the port (``linops_tpu_torch/parallel``) on a
4-rank gloo world on the CPU, against the reference on its 8 virtual
devices (``tests/test_parallel.py``, one test here per test there) in f64.

One world serves the whole file: a module fixture starts 4 rank processes
(``parallel/launch.py``), each runs every case below (``CASES``: torch and
the port only, no jax) and rank 0 returns numpy results; each test then
checks its case against the reference, computed here. Tolerances: rtol
1e-10 against the reference; sharded against unsharded in the port, BSR and
ELL forwards bit for bit (each row is the unsharded row's sum), transposes
and dots rtol 1e-12 (another sum order).
"""

import os
import traceback
import warnings

import numpy as np
import pytest
import torch

WORLD = 4
RTOL = 1e-10
CPU = dict(device="cpu")
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def t_(a):
    return torch.from_numpy(np.asarray(a))


def full(y):
    from linops_tpu_torch.parallel.comm import gather_full

    return gather_full(y).detach().numpy()


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), f"max|Δ| {err:.3e} > {rtol:g}·max|ref|"


def dense_pair(seed, n=32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)), rng.standard_normal(n)


def lbfgs_pairs(seed, n, count=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        s = rng.standard_normal(n)
        out.append((s, s + 0.1 * rng.standard_normal(n)))
    return out


def sparse_case(seed, n=32):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    A.flat[rng.permutation(n * n)[:4 * n]] = rng.standard_normal(4 * n)
    return A, rng.standard_normal(n)


def bsr_case(seed, bm=2, bn=4, nb=32):
    rng = np.random.default_rng(seed)
    Ab = np.kron(rng.standard_normal((nb // bm, nb // bn)) > 0.5, np.ones((bm, bn)))
    return Ab * rng.standard_normal((nb, nb)), rng.standard_normal(nb)


def spectral_case(seed, n=64):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1.0, 50.0, n)
    return (Q * lam) @ Q.T, lam, rng.standard_normal(n)


# --------------------------------------------------------------------------
# The rank side: every rank runs every case; rank 0's numpy results return
# --------------------------------------------------------------------------


def _place(mesh, v):
    from linops_tpu_torch.parallel import row_sharding

    return row_sharding(mesh).place(t_(v))


@case
def row_partitioned_matrix(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts, shard_operator

    A, v = dense_pair(1)
    op = lt.MatrixOperator(t_(A), **CPU)
    op_sh = shard_operator(op, mesh)
    vs = _place(mesh, v)
    return dict(y=full(op_sh * vs), yt=full(op_sh.T * vs), y_un=(op * t_(v)).numpy(),
                yt_un=(op.T * t_(v)).numpy(), placements=str(op_sh.A.placements),
                counts=collective_counts(lambda: op_sh.apply(vs, "N")))


@case
def sharded_composite_graph(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    A, v = dense_pair(2)
    d = np.random.default_rng(3).standard_normal(32) + 2.0
    chain = 2.0 * (lt.MatrixOperator(t_(A), **CPU) @ lt.opDiagonal(t_(d))) + \
        lt.opEye(32, dtype=torch.float64)
    return dict(y=full(shard_operator(chain, mesh) * _place(mesh, v)))


@case
def sharded_lbfgs(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    H = lt.InverseLBFGSOperator(64, mem=4, dtype=torch.float64, **CPU)
    for s, y in lbfgs_pairs(4, 64):
        H.push(t_(s), t_(y))
    H_sh = shard_operator(H, mesh)
    v = np.random.default_rng(5).standard_normal(64)
    return dict(y=full(H_sh * _place(mesh, v)), y_un=(H * t_(v)).numpy(),
                placements=str(H_sh.state.S.placements))


@case
def sharded_vector_io(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import row_sharding, shard_operator

    d, v = dense_pair(6)[1] + 2.0, np.random.default_rng(7).standard_normal(32)
    op = shard_operator(lt.opDiagonal(t_(d)), mesh)
    out = op.apply(row_sharding(mesh).place(t_(v)), "N")
    return dict(y=full(out), placements=str(out.placements),
                want=str(tuple(row_sharding(mesh).placements)))


@case
def dryrun_multichip_entry(mesh):
    from linops_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(WORLD, device="cpu")  # this world: the rank runs here


@case
def sharded_stencil(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    nx, ny = 32, 16
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 5 coefficients do not split: replicated
        L = shard_operator(lt.laplacian_2d(nx, ny, dtype=torch.float64, **CPU), mesh)
    rng = np.random.default_rng(8)
    v, b = rng.standard_normal(nx * ny), rng.standard_normal(nx * ny)
    out = L.apply(_place(mesh, v), "N")
    A = L + 0.5 * lt.opEye(nx * ny, dtype=torch.float64)
    x, it, res = lt.cg(A, _place(mesh, b), tol=1e-10, maxiter=500)
    return dict(y=full(out), placements=str(out.placements), x=full(x), res=float(full(res)))


@case
def sharded_lbfgs_push_matches_unsharded(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator
    from linops_tpu_torch.parallel.comm import gather_full
    from linops_tpu_torch.qn.lbfgs import _push_plain

    n = 64
    H = lt.InverseLBFGSOperator(n, mem=4, dtype=torch.float64, **CPU)
    pairs = lbfgs_pairs(9, n, 4)
    for s, y in pairs[:3]:
        H.push(t_(s), t_(y))
    H_sh = shard_operator(H, mesh)
    s, y = pairs[3]
    ref = _push_plain(H.state, t_(s), t_(y), scaling=True, inverse=True)
    got = H_sh.push(_place(mesh, s), _place(mesh, y)).state  # the public push, DTensor pairs
    return dict(fields=list(ref._fields), ref=[a.numpy() for a in ref],
                got=[gather_full(a).numpy() for a in got], placements=str(got.S.placements))


@case
def sharded_sparse_operators(mesh):
    import scipy.sparse as sps

    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts, shard_operator

    A, v = sparse_case(10)
    vs = _place(mesh, v)
    out = {}
    for fmt in ("csr", "coo"):
        op = lt.opSparse(sps.csr_matrix(A), format=fmt, **CPU)
        op_sh = shard_operator(op, mesh)
        out[fmt] = dict(y=full(op_sh * vs), yt=full(op_sh.T * vs),
                        placements=str(op_sh.data.vals.placements))
    Ab, w = bsr_case(11)
    opb = lt.opSparse(Ab, format="bsr", block_shape=(2, 4), **CPU)
    opb_sh = shard_operator(opb, mesh)
    ws = _place(mesh, w)
    out["bsr"] = dict(y=full(opb_sh * ws), yt=full(opb_sh.T * ws), y_un=(opb * t_(w)).numpy(),
                      yt_un=(opb.T * t_(w)).numpy(),
                      placements=str(opb_sh.data.blocks.placements),
                      counts_n=collective_counts(lambda: opb_sh.apply(ws, "N")),
                      counts_t=collective_counts(lambda: opb_sh.apply(ws, "T")))
    return out


@case
def sharded_bsr_panels(mesh):
    """A row-sharded BSR operator's H block (one panel transpose on this
    rank's rows, then one reduction) at k = 1, 3, 8: the values of the
    column and row forms and the collectives of each; and one svds
    iteration over the operator, per block of the device loop."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts, shard_operator
    from linops_tpu_torch.utils import loop

    Ab, _ = bsr_case(12)
    op = lt.opSparse(Ab, format="bsr", block_shape=(2, 4), **CPU)
    op_sh = shard_operator(op, mesh)
    rng = np.random.default_rng(13)
    out = {}
    for k in (1, 3, 8):
        M = rng.standard_normal((32, k))
        Ms = _place(mesh, M)
        out[k] = dict(y=full(op_sh.apply_matrix(Ms, "H")),
                      y_rows=full(op_sh.apply_matrix_t(t_(M.T.copy()), "H")),
                      y_un=op.apply_matrix(t_(M), "H").numpy(),
                      counts=collective_counts(lambda: op_sh.apply_matrix(Ms, "H")),
                      counts_rows=collective_counts(
                          lambda: op_sh.apply_matrix_t(t_(M.T.copy()), "H")))
    one, two = (collective_counts(lambda: lt.svds(op_sh, k=2, tol=0.0, maxiter=m,
                                                  generator=torch.Generator().manual_seed(5)))
                for m in (loop.BLOCK, 2 * loop.BLOCK))
    out["svds"] = {c: (two[c] - one[c]) / loop.BLOCK for c in one}
    return out


@case
def sharded_replication_warns(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    n = 16 * WORLD + 1
    H = lt.InverseLBFGSOperator(n, mem=2, dtype=torch.float64, **CPU)
    s, y = lbfgs_pairs(12, n, 1)[0]
    H.push(t_(s), t_(y))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        H_sh = shard_operator(H, mesh)
    v = np.random.default_rng(13).standard_normal(n)
    return dict(warnings=[str(w.message) for w in caught], y=full(H_sh * t_(v)),
                dense=H.to_dense().numpy(), v=v)


@case
def sharded_ell(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    A, v = sparse_case(14)
    op = lt.opSparse(A, format="ell", **CPU)
    op_sh = shard_operator(op, mesh)
    vs = _place(mesh, v)
    rng = np.random.default_rng(15)
    B = np.zeros((33, 33))
    B[:16, :16] = rng.standard_normal((16, 16))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        opB_sh = shard_operator(lt.opSparse(B, format="ell", **CPU), mesh)
    w = rng.standard_normal(33)
    return dict(y=full(op_sh * vs), y_un=(op * t_(v)).numpy(), yt=full(op_sh.T * vs),
                placements=str(op_sh.data.vals.placements),
                warnings=[str(c.message) for c in caught], yB=full(opB_sh * t_(w)), B=B, w=w)


@case
def spectral_suite_on_sharded_operator(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    A, lam, b = spectral_case(16)
    op = lt.LinearOperator(t_(A), symmetric=True, hermitian=True, **CPU)
    op_sh = shard_operator(op, mesh)
    th, X, res, it = lt.lobpcg(op_sh, k=2, tol=1e-9, maxiter=400,
                               generator=torch.Generator().manual_seed(0))
    t_sh, _ = lt.estimate_trace(op_sh, probes=60, generator=torch.Generator().manual_seed(1))
    t_un, _ = lt.estimate_trace(op, probes=60, generator=torch.Generator().manual_seed(1))
    y_sh = lt.funm_apply(op_sh, torch.exp, t_(b), lanczos_steps=A.shape[0])
    y_un = lt.funm_apply(op, torch.exp, t_(b), lanczos_steps=A.shape[0])
    return dict(theta=full(th), trace_sh=float(t_sh), trace_un=float(t_un),
                y_sh=full(y_sh), y_un=y_un.numpy())


@case
def structural_flags_survive_sharding(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator

    A, _ = dense_pair(17)
    H = lt.LinearOperator(t_(A), **CPU).hermitianized()
    H_sh = shard_operator(H, mesh)
    th, X, res, it = lt.lobpcg(H_sh, k=1, tol=1e-6, maxiter=200,
                               generator=torch.Generator().manual_seed(0))
    return dict(hermitian=H_sh.hermitian, symmetric=H_sh.symmetric, theta=full(th),
                lam_min=float(np.linalg.eigvalsh((A + A.T) / 2)[0]))


@case
def shard_routed_and_permutation_operators(mesh):
    import scipy.sparse as sps

    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts, shard_operator

    rng = np.random.default_rng(18)
    A = sps.random(512, 512, density=0.02, format="csr", random_state=3)
    A.data[:] = rng.standard_normal(A.nnz)
    op = lt.opSparse(A, format="routed", **CPU)
    op._ensure_transpose()
    sop = shard_operator(op, mesh)
    v = rng.standard_normal(512)
    vs = _place(mesh, v)
    perm = rng.permutation(512)
    P = shard_operator(lt.opPermutation(perm, **CPU), mesh)
    return dict(y=full(sop * vs), yt=full(sop.T * vs), y_un=(op * t_(v)).numpy(),
                yt_un=(op.T * t_(v)).numpy(), A=A.toarray(), v=v, yp=full(P * vs),
                perm=P.perm.numpy(), counts=collective_counts(lambda: sop.apply(vs, "N")))


@case
def sharding_propagation_through_constructors(mesh):
    """``tests/test_storage_propagation.py``'s sharding case."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator
    from linops_tpu_torch.parallel.comm import is_dtensor

    rng = np.random.default_rng(19)
    n = 16 * 8
    mat = rng.standard_normal((n, n)).astype(np.float32)
    vec = rng.standard_normal(n).astype(np.float32)
    graph = 2.0 * (lt.LinearOperator(t_(mat), **CPU) @ lt.opDiagonal(t_(vec))) + \
        lt.LinearOperator(t_(mat), **CPU).T
    sharded = shard_operator(graph, mesh)
    leaves = []

    def walk(op):
        for f in type(op)._fields_tensors:
            val = getattr(op, f)
            if isinstance(val, lt.AbstractLinearOperator):
                walk(val)
            elif isinstance(val, torch.Tensor):
                leaves.append((tuple(val.shape), is_dtensor(val),
                               str(getattr(val, "placements", None))))

    walk(sharded)
    v = rng.standard_normal(n).astype(np.float32)
    return dict(leaves=leaves, y=full(sharded * t_(v)), mat=mat, vec=vec, v=v)


@case
def sharded_window_bsr(mesh):
    """A windowed BSR operator (banded plan: K3/K4's plain versions on the
    CPU) split by row groups, against the unsharded one."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.kernels import bsr_spmv as K
    from linops_tpu_torch.parallel import shard_operator

    old = K.BSR_PALLAS_MAX_X_ELEMS
    K.BSR_PALLAS_MAX_X_ELEMS = 256
    try:
        import scipy.sparse as sps

        n = 16384  # 4 row groups of 512 block rows: one per rank
        rng = np.random.default_rng(20)
        A = sps.diags([rng.standard_normal(n - abs(kd)).astype(np.float32)
                       for kd in range(-3, 4)], list(range(-3, 4)), format="csr")
        op = lt.opSparse(A, format="bsr", block_shape=(8, 128), **CPU)
        kind = "banded" if op.cols_local is not None else ("multi" if op.win_q is not None
                                                           else "none")
        op_sh = shard_operator(op, mesh)
        v = rng.standard_normal(n).astype(np.float32)
        vs = _place(mesh, v)
        return dict(kind=kind, y=full(op_sh * vs), yt=full(op_sh.T * vs),
                    y_un=(op * t_(v)).numpy(), yt_un=(op.T * t_(v)).numpy(),
                    groups=int(op.win_q.shape[-1]) if op.win_q is not None else 0,
                    local_groups=int(op_sh._placement.local.win_q.shape[-1])
                    if op.win_q is not None else 0)
    finally:
        K.BSR_PALLAS_MAX_X_ELEMS = old


@case
def solvers_on_sharded_operator(mesh):
    """Every Krylov solver through a sharded SPD operator against the same
    solve unsharded, on DTensor vectors, with the path the sharded solve's
    loop took."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import shard_operator
    from linops_tpu_torch.utils import loop

    A, _, b = spectral_case(21, n=32)
    op = lt.MatrixOperator(t_(A), symmetric=True, hermitian=True, **CPU)
    op_sh = shard_operator(op, mesh)
    bs = _place(mesh, b)
    out = {}
    for name, call in (
            ("cg", lambda o, v: lt.cg(o, v, tol=1e-10, maxiter=200)),
            ("minres", lambda o, v: lt.minres(o, v, tol=1e-10, maxiter=200)),
            ("bicgstab", lambda o, v: lt.bicgstab(o, v, tol=1e-10, maxiter=200)),
            ("gmres", lambda o, v: lt.gmres(o, v, tol=1e-10, restart=10, maxiter=20)),
            ("chebyshev", lambda o, v: lt.chebyshev(o, v, 1.0, 50.0, iters=40)),
            ("power_iteration", lambda o, v: lt.power_iteration(o, v, iters=30))):
        sh = call(op_sh, bs)
        path = loop.stats["path"]
        un = call(op, t_(b))
        out[name] = dict(sh=[full(t) if torch.is_tensor(t) else t for t in sh],
                         un=[t.numpy() if torch.is_tensor(t) else t for t in un], path=path)
    return out


SOLVERS = ("cg", "minres", "bicgstab", "chebyshev", "gmres")
BLOCK_OPS = ("slice1", "banded", "stencil2d")


def slice1_case(seed=41, n=64):
    """Slice 1's graph at a small size: D (BᵀB) D + 2·I with B a 2x4-block
    sparse matrix, pairs (s, A s) for its inverse L-BFGS preconditioner (mem
    4), a right-hand side, and A densely (for the spectral bounds)."""
    rng = np.random.default_rng(seed)
    B = np.kron(rng.random((n // 2, n // 4)) < 0.4, np.ones((2, 4))) * rng.standard_normal((n, n))
    d = np.linspace(1.0, 2.0, n)
    A = d[:, None] * (B.T @ B) * d[None, :] + 2.0 * np.eye(n)
    pairs = []
    for _ in range(4):
        s = rng.standard_normal(n)
        pairs.append((s, A @ s))
    return B, d, pairs, rng.standard_normal(n), A


def banded_spd(seed=42, n=64, band=3):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for k in range(1, band + 1):
        o = rng.uniform(-1.0, 1.0, n - k)
        A += np.diag(o, k) + np.diag(o, -k)
    A += np.diag(np.abs(A).sum(axis=1) + 1.0)
    return A, rng.standard_normal(n)


STENCIL = (8, 8, [4.0, -1.0, -1.0, -1.0, -1.0])  # grid and coefficients


def spectral_bounds(A):
    lam = np.linalg.eigvalsh(A)
    return float(lam[0]) * 0.99, float(lam[-1]) * 1.01


def laplace_2d(ny, nx):
    T = lambda m: 2.0 * np.eye(m) - np.eye(m, k=1) - np.eye(m, k=-1)  # noqa: E731
    return np.kron(T(ny), np.eye(nx)) + np.kron(np.eye(ny), T(nx))


def block_solve(name, op, M, b, bounds):
    import linops_tpu_torch as lt

    if name == "chebyshev":
        return lt.chebyshev(op, b, *bounds, iters=40)
    return getattr(lt, name)(op, b, tol=1e-12, maxiter=400, M=M)


@case
def solves_in_masked_blocks(mesh):
    """cg, minres, bicgstab, chebyshev and gmres over
    slice 1's graph and its inverse L-BFGS preconditioner through
    ``shard_operator``, over
    ``banded_partition`` and over ``stencil_partition_2d`` (a (2, 2) mesh):
    in the per-iteration loop (``BLOCK`` 1) and in blocks of 4 (the default),
    each with its path, iterations, x and collectives (per apply before and
    after the solves, and per solve)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import (banded_partition, collective_counts, make_mesh2d,
                                           shard_operator, stencil_partition_2d)
    from linops_tpu_torch.utils import loop

    Bd, d, pairs, b1, A1 = slice1_case()
    B = lt.opSparse(Bd, format="bsr", block_shape=(2, 4), **CPU)
    D = lt.opDiagonal(t_(d))
    A = D @ (B.T @ B) @ D + 2.0 * lt.opEye(Bd.shape[0], dtype=torch.float64)
    H = lt.InverseLBFGSOperator(Bd.shape[0], mem=4, dtype=torch.float64, **CPU)
    for s_, y_ in pairs:
        H.push(t_(s_), t_(y_))
    Ab, bb = banded_spd()
    ny, nx, coeffs = STENCIL
    mesh2 = make_mesh2d(2, 2, device="cpu")
    L2 = stencil_partition_2d(t_(coeffs), ny, nx, mesh2)
    bs = np.random.default_rng(43).standard_normal((ny, nx))
    from linops_tpu_torch.parallel import NamedSharding, P

    ops = {"slice1": (shard_operator(A, mesh), shard_operator(H, mesh), _place(mesh, b1),
                      spectral_bounds(A1)),
           "banded": (banded_partition(Ab, mesh, symmetric=True, hermitian=True), None,
                      _place(mesh, bb), spectral_bounds(Ab)),
           "stencil2d": (L2, None,
                         NamedSharding(mesh2, P(("gy", "gx"))).place(L2.grid_to_vec(t_(bs))),
                         spectral_bounds(laplace_2d(ny, nx)))}
    out = {}
    block = loop.BLOCK
    try:
        for kind, (op, M, b, bounds) in ops.items():
            per_apply = [collective_counts(lambda: op.apply(b, "N"))]
            for name in SOLVERS:
                runs = {}
                for blk in (1, block):
                    loop.BLOCK = blk
                    got = {}
                    counts = collective_counts(
                        lambda: got.setdefault("r", block_solve(name, op, M, b, bounds)))
                    x, k, _ = got["r"]
                    x = op.vec_to_grid(x).reshape(-1) if kind == "stencil2d" else x
                    runs[blk] = dict(x=full(x), k=k, path=loop.stats["path"], counts=counts)
                out[(kind, name)] = runs
            per_apply.append(collective_counts(lambda: op.apply(b, "N")))
            out[(kind, "per_apply")] = per_apply
    finally:
        loop.BLOCK = block
    return out


@case
def distributed_signatures_outlive_rank_local_solves(mesh):
    """A distributed solve's signature, then twice the cache's size of
    rank-local solves on rank 0 alone, then the distributed solve again: per
    rank, whether its signature stayed in the distributed cache, and the
    sizes of both caches."""
    import torch.distributed as dist

    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import banded_partition
    from linops_tpu_torch.utils import loop

    loop.clear_cache()
    Ab, bb = banded_spd()
    op = banded_partition(Ab, mesh, symmetric=True, hermitian=True)
    b = _place(mesh, bb)
    lt.cg(op, b, tol=1e-12, maxiter=400)
    key = next(iter(loop._DIST_CACHE))
    if dist.get_rank() == 0:
        for i in range(2 * loop._CACHE_SIZE):
            A, v = banded_spd(seed=50 + i, n=8 + i)
            lt.cg(lt.LinearOperator(t_(A), symmetric=True, hermitian=True), t_(v), tol=1e-12,
                  maxiter=100)
    kept = key in loop._DIST_CACHE
    lt.cg(op, b, tol=1e-12, maxiter=400)
    mine = (kept, len(loop._DIST_CACHE), len(loop._CACHE))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    loop.clear_cache()
    return every


@case
def fresh_sharded_operators_hit_alike(mesh):
    """An outer loop that shards a fresh operator each step (new values on
    one band, through ``banded_partition``, and new blocks on one pattern
    through ``shard_operator``): per rank and step, whether the solve's
    signature was in the distributed cache before it (a hit), the cache's
    size after, and x. Then the key's completeness across ranks: a step's
    operator pointed at the block copies of the next step's (made from one,
    refreshed from the other) applies as the next one."""
    import torch.distributed as dist

    import linops_tpu_torch as lt
    from linops_tpu_torch.core.base import capture_signature
    from linops_tpu_torch.parallel import banded_partition, shard_operator
    from linops_tpu_torch.utils import loop

    loop.clear_cache()
    Bd, _ = bsr_case(12, nb=64)
    pattern = Bd != 0
    hits, sizes, xs, ops = [], [], [], {}
    for step in range(4):
        Ab, bb = banded_spd(seed=60 + step)
        rng = np.random.default_rng(70 + step)
        blocks = lt.opSparse(pattern * rng.standard_normal(Bd.shape), format="bsr",
                             block_shape=(2, 4), **CPU)
        A = banded_partition(Ab, mesh, symmetric=True, hermitian=True)
        B = shard_operator(blocks, mesh)
        ops.setdefault("halo", []).append(A)
        ops.setdefault("bsr", []).append(B)
        b = _place(mesh, bb)
        for op in (A, B.T @ B + 2.0 * lt.opEye(Bd.shape[0], dtype=torch.float64)):
            before = set(loop._DIST_CACHE)
            x, _, _ = lt.cg(op, b, tol=1e-12, maxiter=400)
            hits.append(len(set(loop._DIST_CACHE) - before) == 0)
            sizes.append(len(loop._DIST_CACHE))
            xs.append((full(x), Ab, bb))  # the band's solve first
    swaps = {}
    v = _place(mesh, np.random.default_rng(80).standard_normal(Bd.shape[0]))
    for kind, (first, second) in ((k, o[:2]) for k, o in ops.items()):
        sa, sb = capture_signature(first), capture_signature(second)
        mirrors = loop._Mirrors(sa, torch.device("cpu"))
        mirrors.refresh(sb.tensors)
        want = [full(second.apply(v, m)) for m in ("N", "T")]
        with mirrors.swapped(capture_signature(first)):
            got = [full(first.apply(v, m)) for m in ("N", "T")]
        swaps[kind] = (sa.key == sb.key, all(np.array_equal(g, w) for g, w in zip(got, want)))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (hits, sizes))
    loop.clear_cache()
    return {"every": every, "x": xs[-2][0],
            "x_ref": np.linalg.solve(xs[-2][1], xs[-2][2]), "swaps": swaps}


@case
def mirror_decisions_agree_across_ranks(mesh):
    """Whether a distributed block's copies fit, per rank: a sharded
    operator's tensors as the bound counts them (each at its largest
    shard), their bytes on this rank, and the free-memory answer with one
    rank short of room and with all in room (``loop._free_bytes`` patched
    per rank)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from linops_tpu_torch.core.base import _local
    from linops_tpu_torch.utils import loop

    # rows that 4 ranks split unevenly (17, 17, 17, 15)
    tensors = [distribute_tensor(torch.zeros(66, 3, dtype=torch.float64), mesh, [Shard(0)]),
               distribute_tensor(torch.zeros(66, dtype=torch.float32), mesh, [Shard(0)])]
    counted = sum(loop._shard_bytes(t) for t in tensors)
    local = sum(_local(t).numel() * t.element_size() for t in tensors)
    rank, answers = dist.get_rank(), []
    saved = loop._free_bytes
    try:
        for short in (0, None):
            loop._free_bytes = lambda device: local if rank == short else 4 * local
            answers.append(loop._free_fits(local, True, torch.device("cpu"), tensors))
    finally:
        loop._free_bytes = saved
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (counted, local, answers))
    return every


@case
def scaling_report_on_the_world(mesh):
    """The harness on 4 ranks at a small slab (its collective audits assert
    inside)."""
    from linops_tpu_torch.parallel import scaling_report

    return scaling_report(m_per_dev=256)


def world_main():
    """Run in each rank of the 4-rank world: every case, in order."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import make_mesh

    mesh = make_mesh(WORLD, device="cpu")
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
def world():
    from linops_tpu_torch.parallel import launch

    return launch.run(os.path.abspath(__file__) + ":world_main", WORLD, backend="gloo",
                      timeout=600)[0]


def result(world, name):
    status, value = world[name]
    if status != "ok":
        pytest.fail(f"case {name} failed in the world:\n{value}")
    return value


@pytest.fixture(scope="module")
def ref():
    """The reference package and its 8-device mesh."""
    import jax

    import linops_tpu as lo
    from linops_tpu.parallel import make_mesh

    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return lo, make_mesh(8)


def test_parallel_all_matches_reference():
    import linops_tpu.parallel as ref_parallel
    import linops_tpu_torch.parallel as port_parallel

    assert port_parallel.__all__ == ref_parallel.__all__
    for name in port_parallel.__all__:
        assert hasattr(port_parallel, name), name


def test_row_partitioned_matrix(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel import shard_operator

    r = result(world, "row_partitioned_matrix")
    A, v = dense_pair(1)
    op_j = shard_operator(lo.MatrixOperator(A), mesh)
    close(r["y"], np.asarray(op_j * v))
    close(r["yt"], np.asarray(op_j.T * v))
    close(r["y"], r["y_un"], 1e-12)
    close(r["yt"], r["yt_un"], 1e-12)
    assert r["placements"] == "(Shard(dim=0),)"
    assert r["counts"]["all-gather"] == 1  # x gathered for the row-split product


def test_sharded_composite_graph(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel import shard_operator

    A, v = dense_pair(2)
    d = np.random.default_rng(3).standard_normal(32) + 2.0
    chain = 2.0 * (lo.MatrixOperator(A) @ lo.opDiagonal(d)) + lo.opEye(32)
    close(result(world, "sharded_composite_graph")["y"],
          np.asarray(shard_operator(chain, mesh) * v))


def test_sharded_lbfgs(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel import shard_operator

    r = result(world, "sharded_lbfgs")
    H = lo.InverseLBFGSOperator(64, mem=4)
    for s, y in lbfgs_pairs(4, 64):
        H.push(s, y)
    v = np.random.default_rng(5).standard_normal(64)
    close(r["y"], np.asarray(shard_operator(H, mesh) * v))
    close(r["y"], r["y_un"], 1e-12)
    assert r["placements"] == "(Shard(dim=1),)"  # memory split along n


def test_sharded_vector_io(world):
    r = result(world, "sharded_vector_io")
    d, v = dense_pair(6)[1] + 2.0, np.random.default_rng(7).standard_normal(32)
    close(r["y"], d * v)
    assert r["placements"] == r["want"] == "(Shard(dim=0),)"


def test_dryrun_multichip_entry(world):
    r = result(world, "dryrun_multichip_entry")
    assert r["ranks"] == WORLD and np.isfinite(r["x_norm"]) and r["halo_chain_finite"]
    assert r["halo_collectives_per_apply"]["collective-permute"] == 2
    assert r["halo_collectives_per_apply"]["all-gather"] == 0
    assert r["halo2d_collectives_per_apply"]["collective-permute"] == 4
    assert r["halo2d_collectives_per_apply"]["all-gather"] == 0


def test_sharded_stencil(world, ref):
    lo, _ = ref
    import jax.numpy as jnp

    r = result(world, "sharded_stencil")
    nx, ny = 32, 16
    L = lo.laplacian_2d(nx, ny, dtype=jnp.float64)
    rng = np.random.default_rng(8)
    v, b = rng.standard_normal(nx * ny), rng.standard_normal(nx * ny)
    close(r["y"], np.asarray(L.to_dense()) @ v)
    assert r["placements"] == "(Shard(dim=0),)"
    assert r["res"] < 1e-8
    x_j, _, _ = lo.cg(L + 0.5 * lo.opEye(nx * ny, dtype=jnp.float64), jnp.asarray(b),
                      tol=1e-10, maxiter=500)
    close(r["x"], np.asarray(x_j), 1e-8)


def test_sharded_lbfgs_push_matches_unsharded(world, ref):
    lo, mesh = ref
    import jax.numpy as jnp
    from linops_tpu.parallel import shard_operator
    from linops_tpu.qn.lbfgs import _push_plain

    r = result(world, "sharded_lbfgs_push_matches_unsharded")
    n = 64
    H = lo.InverseLBFGSOperator(n, mem=4)
    pairs = lbfgs_pairs(9, n, 4)
    for s, y in pairs[:3]:
        H.push(s, y)
    s, y = pairs[3]
    st_j = _push_plain(shard_operator(H, mesh).state, jnp.asarray(s), jnp.asarray(y),
                       scaling=True, inverse=True)
    for name, got, mine, theirs in zip(r["fields"], r["got"], r["ref"], st_j):
        np.testing.assert_allclose(got, mine, rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(theirs), rtol=RTOL, atol=1e-12, err_msg=name)
    assert r["placements"] == "(Shard(dim=1),)"  # pushed memory stays split along n


def test_sharded_sparse_operators(world, ref):
    lo, mesh = ref
    import scipy.sparse as sps
    from linops_tpu.parallel import shard_operator

    r = result(world, "sharded_sparse_operators")
    A, v = sparse_case(10)
    for fmt in ("csr", "coo"):
        op_j = shard_operator(lo.opSparse(sps.csr_matrix(A), format=fmt), mesh)
        close(r[fmt]["y"], np.asarray(op_j * v))
        close(r[fmt]["yt"], np.asarray(op_j.T * v))
        assert r[fmt]["placements"] == "(Shard(dim=0),)"
    Ab, w = bsr_case(11)
    opb_j = shard_operator(lo.opSparse(Ab, format="bsr", block_shape=(2, 4)), mesh)
    rb = r["bsr"]
    close(rb["y"], np.asarray(opb_j * w))
    close(rb["yt"], np.asarray(opb_j.T * w))
    np.testing.assert_array_equal(rb["y"], rb["y_un"])  # each row: the unsharded row's sum
    close(rb["yt"], rb["yt_un"], 1e-12)
    assert rb["placements"] == "(Shard(dim=0),)"
    assert rb["counts_n"]["all-gather"] == 1 and rb["counts_n"]["reduce-scatter"] == 0
    assert rb["counts_t"]["reduce-scatter"] == 1 and rb["counts_t"]["all-gather"] == 0


def test_sharded_bsr_panels(world, ref):
    """A row-sharded BSR operator's H block is one panel transpose per rank
    and one reduction for every k (a reduce-scatter for a split block, an
    all-reduce for a plain row panel), as the reference's vmapped apply
    reduces once; its values are the reference's and the unsharded
    operator's. One svds iteration over it makes the Gram operator's two
    collectives, whatever the block width."""
    lo, mesh = ref
    from linops_tpu.parallel import shard_operator

    r = result(world, "sharded_bsr_panels")
    Ab, _ = bsr_case(12)
    op_j = shard_operator(lo.opSparse(Ab, format="bsr", block_shape=(2, 4)), mesh)
    rng = np.random.default_rng(13)
    for k in (1, 3, 8):
        M = rng.standard_normal((32, k))
        rk = r[k]
        close(rk["y"], np.asarray(op_j.apply_matrix(M, "H")))
        close(rk["y"], rk["y_un"], 1e-12)
        close(rk["y_rows"].T, rk["y_un"], 1e-12)
        assert rk["counts"] == dict(dict.fromkeys(rk["counts"], 0), **{"reduce-scatter": 1})
        assert rk["counts_rows"] == dict(dict.fromkeys(rk["counts"], 0), **{"all-reduce": 1})
    assert r["svds"] == dict(dict.fromkeys(r["svds"], 0), **{"all-gather": 1,
                                                             "reduce-scatter": 1})


def test_sharded_replication_warns(world):
    r = result(world, "sharded_replication_warns")
    assert any("REPLICATED" in w for w in r["warnings"]), r["warnings"]
    close(r["y"], r["dense"] @ r["v"])


def test_sharded_ell(world, ref):
    lo, mesh = ref
    from linops_tpu.parallel import shard_operator

    r = result(world, "sharded_ell")
    A, v = sparse_case(14)
    close(r["y"], np.asarray(shard_operator(lo.opSparse(A, format="ell"), mesh) * v))
    np.testing.assert_array_equal(r["y"], r["y_un"])
    close(r["yt"], A.T @ v)
    assert r["placements"] == "(Shard(dim=0),)"
    assert any("replicated" in w for w in r["warnings"]), r["warnings"]
    close(r["yB"], r["B"] @ r["w"])


def test_spectral_suite_on_sharded_operator(world, ref):
    lo, mesh = ref
    import jax
    from linops_tpu.parallel import shard_operator

    r = result(world, "spectral_suite_on_sharded_operator")
    A, lam, b = spectral_case(16)
    np.testing.assert_allclose(r["theta"], lam[:2], rtol=1e-7)
    th_j, _, _, _ = lo.lobpcg(shard_operator(lo.LinearOperator(A, symmetric=True,
                                                               hermitian=True), mesh),
                              k=2, tol=1e-9, maxiter=400, key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(r["theta"], np.asarray(th_j), rtol=1e-7)
    assert abs(r["trace_sh"] - r["trace_un"]) < 1e-12 * abs(r["trace_un"])  # same probes
    close(r["y_sh"], r["y_un"], 1e-12)
    y_j = np.asarray(lo.funm_apply(lo.LinearOperator(A, symmetric=True, hermitian=True),
                                   jax.numpy.exp, b, lanczos_steps=A.shape[0]))
    close(r["y_sh"], y_j, 1e-9)


def test_structural_flags_survive_sharding(world):
    r = result(world, "structural_flags_survive_sharding")
    assert r["hermitian"] and r["symmetric"]
    assert np.isfinite(r["theta"][0])
    assert abs(r["theta"][0] - r["lam_min"]) < 1e-4 * max(1.0, abs(r["lam_min"]))


def test_ici_projection_model():
    """The projection with the H100's figures (``scaling_bench.py``): the
    halo2d and row-split paths meet 75 % at production sizes; the halo's
    break-even slab size does reach 75 %, and the verdict is the conjunction."""
    from linops_tpu_torch.parallel.scaling_bench import ici_projection

    p = ici_projection(n_devices=8, m_per_dev=2048, band=3)
    assert p["halo2d_weak"] >= 0.75
    assert p["gspmd_strong"] >= 0.75
    m75 = p["halo_weak_rows_per_dev_for_75pct"]
    assert 0 < m75 < 10_000_000
    assert ici_projection(n_devices=8, m_per_dev=m75 + 1, band=3)[
        f"halo_weak_harness_m{m75 + 1}"] >= 0.75 - 1e-6
    assert p["meets_baseline_75pct_at_production_sizes"] == (
        p["halo_weak_m1e6"] >= 0.75 and p["halo2d_weak"] >= 0.75 and p["gspmd_strong"] >= 0.75)


def test_shard_routed_and_permutation_operators(world):
    r = result(world, "shard_routed_and_permutation_operators")
    close(r["y"], r["A"] @ r["v"], 1e-11)
    close(r["yt"], r["A"].T @ r["v"], 1e-11)
    np.testing.assert_array_equal(r["y"], r["y_un"])  # the replica's apply, unchanged
    np.testing.assert_array_equal(r["yt"], r["yt_un"])
    np.testing.assert_array_equal(r["yp"], r["v"][r["perm"]])
    assert r["counts"]["all-gather"] == 1  # the input gathered to the replicas


def test_sharding_propagation_through_constructors(world):
    r = result(world, "sharding_propagation_through_constructors")
    for shape, sharded, placements in r["leaves"]:
        if int(np.prod(shape)) > 4:
            assert sharded and "Shard(dim=0)" in placements, (shape, placements)
    dense = 2.0 * (r["mat"].astype(np.float64) @ np.diag(r["vec"])) + r["mat"].T
    np.testing.assert_allclose(r["y"], dense @ r["v"], rtol=2e-4)


def test_sharded_window_bsr(world):
    r = result(world, "sharded_window_bsr")
    assert r["kind"] == "banded" and r["groups"] == WORLD * r["local_groups"]
    np.testing.assert_array_equal(r["y"], r["y_un"])
    close(r["yt"], r["yt_un"], 1e-6)  # f32: another sum order of the same products


@pytest.mark.parametrize("solver", ["cg", "minres", "bicgstab", "gmres", "chebyshev",
                                    "power_iteration"])
def test_solvers_on_sharded_operator(world, solver):
    """Each solver on a sharded operator: the unsharded solve's result and
    iterations (dots reduce in another order: rtol 1e-10); power iteration's
    eigenvalue and vector; each in the loop's masked blocks (GMRES's restarts
    too, one a block)."""
    r = result(world, "solvers_on_sharded_operator")[solver]
    assert r["path"] == "blocks"
    for got, want in zip(r["sh"][:2], r["un"][:2]):
        if isinstance(want, int):
            assert got == want
        else:
            close(got, want, 1e-10)


def reference_block_solve(lo, mesh8, kind, name):
    """The same solve by the reference on its 8 virtual devices (the 2-D
    stencil on a (4, 2) mesh), x as the port returns it (the stencil's as
    its grid, flattened)."""
    import jax.numpy as jnp
    from linops_tpu.parallel import (banded_partition, make_mesh2d, shard_operator,
                                     stencil_partition_2d)

    M = None
    if kind == "slice1":
        Bd, d, pairs, b, A1 = slice1_case()
        B = lo.opSparse(Bd, format="bsr", block_shape=(2, 4))
        D = lo.opDiagonal(jnp.asarray(d))
        op = shard_operator(D @ (B.T @ B) @ D + 2.0 * lo.opEye(Bd.shape[0]), mesh8)
        H = lo.InverseLBFGSOperator(Bd.shape[0], mem=4)
        for s_, y_ in pairs:
            H.push(jnp.asarray(s_), jnp.asarray(y_))
        M, bounds = shard_operator(H, mesh8), spectral_bounds(A1)
    elif kind == "banded":
        Ab, b = banded_spd()
        op, bounds = banded_partition(Ab, mesh8, symmetric=True, hermitian=True), spectral_bounds(Ab)
    else:
        ny, nx, coeffs = STENCIL
        op = stencil_partition_2d(jnp.asarray(coeffs), ny, nx, make_mesh2d(4, 2))
        b = op.grid_to_vec(jnp.asarray(np.random.default_rng(43).standard_normal((ny, nx))))
        bounds = spectral_bounds(laplace_2d(ny, nx))
    b = jnp.asarray(b)
    if name == "chebyshev":
        x = lo.chebyshev(op, b, *bounds, iters=40)[0]
    else:
        x = getattr(lo, name)(op, b, tol=1e-12, maxiter=400, M=M)[0]
    return np.asarray(op.vec_to_grid(x)).reshape(-1) if kind == "stencil2d" else np.asarray(x)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind", BLOCK_OPS)
def test_solves_in_masked_blocks(world, ref, kind, solver):
    """A solve over a sharded, halo or 2-D halo operator takes the loop's
    masked blocks on the CPU (gloo collectives cannot be captured), with the
    per-iteration loop's (``BLOCK`` 1) iterations and x bit for bit; the
    collectives of one apply are what they were before the solves (halo: 2
    exchange rounds, 2-D: 4, neither an all-gather); a Chebyshev solve over a
    halo operator issues no all-reduce; x is the reference's solve on its 8
    virtual devices within rtol 1e-10."""
    lo, mesh8 = ref
    r = result(world, "solves_in_masked_blocks")
    one, four = r[(kind, solver)][1], r[(kind, solver)][4]
    assert four["path"] == "blocks" and one["path"] == "blocks"
    assert four["k"] == one["k"]
    np.testing.assert_array_equal(four["x"], one["x"])
    before, after = r[(kind, "per_apply")]
    assert before == after
    if kind != "slice1":
        assert before["all-gather"] == 0
        assert before["collective-permute"] == {"banded": 2, "stencil2d": 4}[kind]
        if solver == "chebyshev":
            assert four["counts"]["all-reduce"] == one["counts"]["all-reduce"] == 0
    close(four["x"], reference_block_solve(lo, mesh8, kind, solver), RTOL)


def test_distributed_signatures_outlive_rank_local_solves(world):
    """Distributed signatures have a cache of their own: rank-local solves on
    one rank (more of them than the cache holds) evict nothing from it, so
    every rank keeps the same distributed entries and decides alike whether
    to capture."""
    every = result(world, "distributed_signatures_outlive_rank_local_solves")
    assert [kept for kept, _, _ in every] == [True] * WORLD
    assert {n_dist for _, n_dist, _ in every} == {1}
    assert every[0][2] > 0 and [n_local for _, _, n_local in every[1:]] == [0] * (WORLD - 1)


def test_fresh_sharded_operators_hit_alike(world):
    """Fresh sharded operators of one structure each step: the first step's
    solves miss and later steps' hit, the same on every rank, the
    distributed cache holds one entry per structure, x is the dense solve's,
    and a sharded operator pointed at another's block copies applies as
    that one (the placements' local operators are in the key)."""
    r = result(world, "fresh_sharded_operators_hit_alike")
    every = r["every"]
    assert all(e == every[0] for e in every[1:]), every
    hits, sizes = every[0]
    assert hits == [False, False] + [True] * (len(hits) - 2), hits
    assert sizes == [1] + [2] * (len(sizes) - 1), sizes
    np.testing.assert_allclose(r["x"], r["x_ref"], rtol=1e-8, atol=1e-10)
    assert r["swaps"] == {"halo": (True, True), "bsr": (True, True)}, r["swaps"]


def test_mirror_decisions_agree_across_ranks(world):
    """Every rank decides alike whether a distributed block's copies fit:
    the bound counts a DTensor at its largest shard on every rank (at least
    any rank's own bytes), and one rank short of free memory makes every
    rank refuse the copies, while room on all makes every rank take them."""
    every = result(world, "mirror_decisions_agree_across_ranks")
    counted = {c for c, _, _ in every}
    assert len(counted) == 1 and counted.pop() == max(n for _, n, _ in every), every
    assert len({n for _, n, _ in every}) > 1, every  # the shards differ
    assert [a for _, _, a in every] == [[False, True]] * WORLD, every


def test_scaling_report_on_the_world(world):
    """``scaling_report`` on the 4-rank world: 2 exchange rounds per halo
    apply, 4 per 2-D halo apply on the (2, 2) mesh, no all-gather in either;
    the row-split dense operator gathers x once. CPU times: not the card's."""
    r = result(world, "scaling_report_on_the_world")
    assert r["n_devices"] == WORLD and r["platform"] == "cpu"
    assert r["halo_collectives_per_apply"]["collective-permute"] == 2
    assert r["halo2d_mesh"] == [2, 2]
    assert r["halo2d_collectives_per_apply"]["collective-permute"] == 4
    assert r["halo2d_collectives_per_apply"]["all-gather"] == 0
    assert r["gspmd_collectives_per_apply"]["all-gather"] == 1
    assert all(r[k] > 0 for k in r if k.endswith("_us_per_apply_ndev"))
