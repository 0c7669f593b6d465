"""DTensor vectors wherever the reference takes a sharded array, on a 4-rank
gloo world on the CPU, against the reference on its 8 virtual devices
(``tests/conftest.py``) with ``b`` placed by ``jax.device_put(b,
row_sharding(mesh))``, in f64.

One world serves the file (``parallel/launch.py``): each rank runs every
case below (torch and the port only, no jax) and rank 0 returns numpy
results, placements and collective counts. Each test holds a case against
the unsharded port call (rtol 1e-10: dots reduce in another order) and the
reference (rtol 1e-10), and the result's placement against the reference's
sharding: row-split (``PartitionSpec('shard')``, or split along its rows
over part of the mesh) or replicated (``PartitionSpec()``).

- GMRES, ``opIterativeInverse(solver="gmres")`` and BiCGSTAB with the
  ``"auto"`` inverse as M over ``shard_operator``, ``banded_partition`` and
  ``stencil_partition_2d`` (all three non-symmetric, so ``"auto"`` takes
  GMRES); the collectives of one Arnoldi step pinned: the operator's own,
  one all-reduce of the projections and one of the norm, no all-gather of
  the basis.
- ``funm_apply``'s Lanczos basis on a DTensor ``b``.
- L-BFGS (plain, damped forward, damped inverse) and L-SR1 pushes of
  DTensor pairs into sharded state, which keeps its placements; shifted
  solves (compact and EJM, one σ and several) on that state.
- Plain operators and preconditioners given a DTensor: diagonal, dense,
  Kronecker, Nyström, ``matvec_chain``; CG and MINRES with a plain Jacobi M,
  CG with the Nyström preconditioner of the sharded operator.
"""

import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
RTOL = 1e-10
N = 64
CPU = dict(device="cpu")
STENCIL = (8, 8, [4.0, -1.2, -0.8, -1.1, -0.9])  # grid and non-symmetric coefficients
SIGMAS = (0.0, 0.5, 3.0)
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


def nonsymmetric(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n), rng.standard_normal(n)


def spd(seed, n=N):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, 20.0, n)) @ Q.T, rng.standard_normal(n)


def banded(seed, n=N, band=3):
    """A non-symmetric band-3 matrix, diagonally dominant."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for k in range(1, band + 1):
        A += np.diag(rng.uniform(-1.0, 1.0, n - k), k) + np.diag(rng.uniform(-1.0, 1.0, n - k), -k)
    A += np.diag(np.abs(A).sum(axis=1) + 1.0)
    return A, rng.standard_normal(n)


def qn_pairs(seed, n=N, count=6):
    rng = np.random.default_rng(seed)
    return [(s, s + 0.1 * rng.standard_normal(n)) for s in
            (rng.standard_normal(n) for _ in range(count))]


def kind_of_placements(placements) -> str:
    """The port's placement of a vector: ``row`` when some mesh dimension
    splits its rows, ``replicated`` when none does."""
    names = [type(p).__name__ for p in placements]
    if any(n == "Shard" for n in names):
        return "row"
    assert all(n == "Replicate" for n in names), names
    return "replicated"


def kind_of_sharding(arr) -> str:
    """The reference's placement of an array, in the same words."""
    sh = arr.sharding
    if sh.is_fully_replicated:
        return "replicated"
    assert sh.shard_shape(arr.shape)[0] < arr.shape[0], sh
    return "row"


# --------------------------------------------------------------------------
# The rank side
# --------------------------------------------------------------------------


def _full(y):
    from linops_tpu_torch.parallel.comm import gather_full

    return gather_full(y).detach().numpy()


def _out(y):
    """A DTensor result: its values and placement kind."""
    from linops_tpu_torch.parallel.comm import is_dtensor

    assert is_dtensor(y), type(y)
    return dict(y=_full(y), kind=kind_of_placements(y.placements))


def distributed_ops(mesh):
    """kind -> (the distributed operator, b as its DTensor, b whole as the
    operator's layout orders it, the unsharded port operator). The 2-D
    stencil's layout follows its mesh (the port's (2, 2), the reference's
    (4, 2)): its results are compared as grids (``as_grid``)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import (NamedSharding, P, banded_partition, make_mesh2d,
                                           row_sharding, shard_operator, stencil_partition_2d)

    A, b = nonsymmetric(1)
    Ab, bb = banded(2)
    ny, nx, coeffs = STENCIL
    mesh2 = make_mesh2d(2, 2, device="cpu")
    L2 = stencil_partition_2d(t_(coeffs), ny, nx, mesh2)
    place2 = NamedSharding(mesh2, P(("gy", "gx"))).place
    bs = L2.grid_to_vec(t_(np.random.default_rng(3).standard_normal((ny, nx))))
    # the stencil as a dense matrix in its own layout, one unit vector at a time
    cols = [_full(L2.apply(place2(t_(np.eye(ny * nx)[j])), "N")) for j in range(ny * nx)]
    place = row_sharding(mesh).place
    return {"shard": (shard_operator(lt.MatrixOperator(t_(A), **CPU), mesh), place(t_(b)),
                      b, lt.MatrixOperator(t_(A), **CPU)),
            "banded": (banded_partition(Ab, mesh), place(t_(bb)), bb,
                       lt.MatrixOperator(t_(Ab), **CPU)),
            "stencil2d": (L2, place2(bs), bs.numpy(),
                          lt.MatrixOperator(t_(np.stack(cols, axis=1)), **CPU))}


@case
def gmres_on_dtensor_vectors(mesh):
    """GMRES, the GMRES inverse and BiCGSTAB with the "auto" inverse as M,
    on DTensor vectors over the three distributed operators; the
    collectives of one apply, of one Arnoldi step (one restart of 8 steps
    less one of 4, over 4) and of the whole GMRES solve."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts

    out = {}
    for kind, (op, b, b_whole, op_un) in distributed_ops(mesh).items():
        r = {}
        grid = (lambda v: op.vec_to_grid(v).reshape(-1).numpy()) if kind == "stencil2d" else _full
        gm = lambda o, v: lt.gmres(o, v, tol=1e-12, restart=10, maxiter=20)  # noqa: E731
        got = {}
        r["counts"] = collective_counts(lambda: got.setdefault("x", gm(op, b)))
        x, k, res = got["x"]
        x_un, k_un, _ = gm(op_un, t_(b_whole))
        r["gmres"] = dict(_out(x), k=k, un=x_un.numpy(), k_un=k_un, res=float(_full(res)),
                          grid=grid(x))
        one = [collective_counts(lambda: lt.gmres(op, b, tol=0.0, restart=m, maxiter=1))
               for m in (4, 8)]
        r["per_step"] = {c: (one[1][c] - one[0][c]) / 4 for c in one[0]}
        r["per_apply"] = collective_counts(lambda: op.apply(b, "N"))
        inv = lt.opIterativeInverse(op, solver="gmres", tol=1e-12, maxiter=60)
        y = inv * b
        r["inverse"] = dict(_out(y), grid=grid(y),
                            un=(lt.opIterativeInverse(op_un, solver="gmres", tol=1e-12,
                                                      maxiter=60) * t_(b_whole)).numpy())
        M = lt.opIterativeInverse(op, solver="auto", tol=1e-2, maxiter=30)
        M_un = lt.opIterativeInverse(op_un, solver="auto", tol=1e-2, maxiter=30)
        x, k, _ = lt.bicgstab(op, b, tol=1e-12, maxiter=200, M=M)
        x_un, k_un, _ = lt.bicgstab(op_un, t_(b_whole), tol=1e-12, maxiter=200, M=M_un)
        r["auto"] = dict(_out(x), grid=grid(x), k=k, un=x_un.numpy(), k_un=k_un,
                         solver=M._resolved(op),
                         inner=M.inner_iterations, inner_un=M_un.inner_iterations)
        out[kind] = r
    return out


@case
def funm_apply_on_dtensor(mesh):
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import collective_counts, row_sharding, shard_operator

    S, b = spd(4)
    op = lt.LinearOperator(t_(S), symmetric=True, hermitian=True, **CPU)
    op_sh = shard_operator(op, mesh)
    bd = row_sharding(mesh).place(t_(b))
    got = {}
    counts = collective_counts(
        lambda: got.setdefault("y", lt.funm_apply(op_sh, torch.exp, bd, lanczos_steps=20)))
    return dict(_out(got["y"]), un=lt.funm_apply(op, torch.exp, t_(b), lanczos_steps=20).numpy(),
                counts=counts, per_apply=collective_counts(lambda: op_sh.apply(bd, "N")))


def _state(op):
    from linops_tpu_torch.parallel.comm import gather_full

    return {f: gather_full(getattr(op.state, f)).numpy() for f in op.state._fields}


def _placements(op):
    return {f: str(getattr(getattr(op.state, f), "placements", None)) for f in op.state._fields}


@case
def quasi_newton_on_sharded_state(mesh):
    """Pushes of DTensor pairs into sharded L-BFGS (plain, damped forward,
    damped inverse) and L-SR1 operators, against the same pushes unsharded;
    the placements of every state field before and after; shifted solves
    on the pushed forward model (compact at each σ and at once, EJM)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import row_sharding, shard_operator

    place = row_sharding(mesh).place
    rng = np.random.default_rng(5)
    g = rng.standard_normal(N)
    models = {"plain": lambda: lt.LBFGSOperator(N, mem=4, dtype=torch.float64, **CPU),
              "damped_forward": lambda: lt.LBFGSOperator(N, mem=4, damped=True,
                                                         dtype=torch.float64, **CPU),
              "damped_inverse": lambda: lt.InverseLBFGSOperator(N, mem=4, damped=True,
                                                                dtype=torch.float64, **CPU),
              "lsr1": lambda: lt.LSR1Operator(N, mem=4, dtype=torch.float64, **CPU)}
    out = {}
    for name, make in models.items():
        un = make()
        sh = shard_operator(make(), mesh)
        before = _placements(sh)
        for i, (s, y) in enumerate(qn_pairs(6)):
            if name == "damped_inverse":
                alpha = 0.5 + 0.1 * i
                un.push(t_(s), t_(y), alpha, t_(g))
                sh.push(place(t_(s)), place(t_(y)), alpha, place(t_(g)))
            else:
                un.push(t_(s), t_(y))
                sh.push(place(t_(s)), place(t_(y)))
        v = rng.standard_normal(N)
        out[name] = dict(state=_state(sh), state_un=_state(un), before=before, v=v,
                         after=_placements(sh), apply=_out(sh * place(t_(v))),
                         apply_un=(un * t_(v)).numpy())
        if name == "plain":
            b = rng.standard_normal(N)
            bd = place(t_(b))
            out["shifted"] = {
                "compact": [_out(lt.solve_shifted_system(sh, bd, s_)) for s_ in SIGMAS],
                "compact_un": [lt.solve_shifted_system(un, t_(b), s_).numpy() for s_ in SIGMAS],
                "ejm": [_out(lt.solve_shifted_system(sh, bd, s_, method="ejm"))
                        for s_ in SIGMAS[1:]],
                "ejm_un": [lt.solve_shifted_system(un, t_(b), s_, method="ejm").numpy()
                           for s_ in SIGMAS[1:]],
                "batch": _out(lt.solve_shifted_systems(sh, bd, list(SIGMAS))),
                "batch_un": lt.solve_shifted_systems(un, t_(b), list(SIGMAS)).numpy(),
                "b": b}
            out["g"] = g
    return out


@case
def plain_operators_given_dtensor(mesh):
    """Plain operators and preconditioners applied to a DTensor: their
    values and placements, and the solves that use them."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import row_sharding, shard_operator
    from linops_tpu_torch.utils.eig import nystrom_preconditioner

    place = row_sharding(mesh).place
    A, b = nonsymmetric(7)
    S, _ = spd(8)
    rng = np.random.default_rng(9)
    d = rng.uniform(1.0, 2.0, N)
    B = rng.standard_normal((8, 8))
    bd, bt = place(t_(b)), t_(b)
    dense = lt.MatrixOperator(t_(A), **CPU)
    kr = lt.kron(lt.opEye(8, dtype=torch.float64), lt.MatrixOperator(t_(B), **CPU))
    S_op = lt.LinearOperator(t_(S), symmetric=True, hermitian=True, **CPU)
    S_sh = shard_operator(S_op, mesh)
    M = lt.opDiagonal(t_(d))
    out = {"diag": dict(_out(lt.opDiagonal(t_(d)) * bd), un=(M * bt).numpy()),
           "dense": dict(_out(dense * bd), un=(dense * bt).numpy()),
           "mul": dict(_out(lt.mul(dense, bd, alpha=2.0, beta=0.5, res=bd)),
                       un=lt.mul(dense, bt, alpha=2.0, beta=0.5, res=bt).numpy()),
           "kron": dict(_out(kr * bd), un=(kr * bt).numpy()),
           "chain": dict(_out(lt.matvec_chain(dense, bd, 3)),
                         un=lt.matvec_chain(dense, bt, 3).numpy())}
    for name, solver in (("cg", lt.cg), ("minres", lt.minres)):
        x, k, _ = solver(S_sh, bd, tol=1e-12, maxiter=200, M=M)
        x_un, k_un, _ = solver(S_op, bt, tol=1e-12, maxiter=200, M=M)
        out[name] = dict(_out(x), k=k, un=x_un.numpy(), k_un=k_un)
    P_sh = nystrom_preconditioner(S_sh, 8, generator=torch.Generator().manual_seed(0))
    P_un = nystrom_preconditioner(S_op, 8, generator=torch.Generator().manual_seed(0))
    out["nystrom"] = dict(_out(P_sh * bd), un=(P_un * bt).numpy(), U=_full(P_sh.U),
                          lam=_full(P_sh.lam))
    x, k, _ = lt.cg(S_sh, bd, tol=1e-12, maxiter=200, M=P_sh)
    x_un, k_un, _ = lt.cg(S_op, bt, tol=1e-12, maxiter=200, M=P_un)
    out["nystrom_cg"] = dict(_out(x), k=k, un=x_un.numpy(), k_un=k_un, U=out["nystrom"]["U"],
                             lam=out["nystrom"]["lam"])
    out["inputs"] = dict(A=A, b=b, S=S, d=d, B=B)
    return out


@case
def solve_keys_on_dtensor_vectors(mesh):
    """The loop cache's keys: GMRES over one sharded operator on a plain and
    on a DTensor b (one key: a plain b given to a distributed operator is
    placed in its layout, so both are the same DTensor solve), and a sharded CG
    preconditioned by a sharded inverse L-BFGS across pushes of DTensor
    pairs (one key: the state is keyed by layout and placement, which the
    pushes keep), with x against the same pushes unsharded."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.core.base import capture_signature
    from linops_tpu_torch.parallel import row_sharding, shard_operator
    from linops_tpu_torch.utils import loop

    place = row_sharding(mesh).place
    loop.clear_cache()
    A, b = nonsymmetric(10)
    op = shard_operator(lt.MatrixOperator(t_(A), **CPU), mesh)
    x_p = lt.gmres(op, t_(b), tol=1e-12, restart=10, maxiter=20)[0]
    x_d = lt.gmres(op, place(t_(b)), tol=1e-12, restart=10, maxiter=20)[0]
    gmres_keys = [k for k in loop._DIST_CACHE if k[1][0] == "gmres"]
    S, _ = spd(11)
    S_op = lt.LinearOperator(t_(S), symmetric=True, hermitian=True, **CPU)
    S_sh = shard_operator(S_op, mesh)
    H = lt.InverseLBFGSOperator(N, mem=4, dtype=torch.float64, **CPU)
    H_un = lt.InverseLBFGSOperator(N, mem=4, dtype=torch.float64, **CPU)
    H_sh = shard_operator(H, mesh)
    keys, sizes, xs = [], [], []
    for s_, y_ in qn_pairs(12):
        H_sh.push(place(t_(s_)), place(t_(y_)))
        H_un.push(t_(s_), t_(y_))
        keys.append(capture_signature((S_sh, H_sh)).key)
        x = lt.cg(S_sh, place(t_(b)), tol=1e-12, maxiter=200, M=H_sh)[0]
        sizes.append(len(loop._DIST_CACHE))
        xs.append((_full(x), lt.cg(S_op, t_(b), tol=1e-12, maxiter=200, M=H_un)[0].numpy()))
    loop.clear_cache()
    return dict(gmres_keys=len(set(gmres_keys)), gmres=(_full(x_p), _full(x_d)),
                same_key=all(k == keys[0] for k in keys), sizes=sizes, xs=xs)


@case
def loop_state_keeps_its_layout(mesh):
    """Each solver's ``device_while`` on DTensor vectors (over a sharded
    operator; BiCGSTAB and CG with the GMRES inverse as M too): whether the
    state and constants it returns have the signature they came in with
    (plain flags and scalars stay plain, DTensors keep their placements),
    which the captured path needs to find its block again."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import row_sharding, shard_operator
    from linops_tpu_torch.utils import loop

    A, b = nonsymmetric(13)
    S, _ = spd(14)
    op = shard_operator(lt.MatrixOperator(t_(A), **CPU), mesh)
    sym = shard_operator(lt.LinearOperator(t_(S), symmetric=True, hermitian=True, **CPU), mesh)
    bd = row_sharding(mesh).place(t_(b))
    M = lt.opIterativeInverse(op, solver="gmres", tol=1e-2, maxiter=10)
    seen = []
    orig = loop._device_while

    def spy(cond, body, state, consts, maxiter, go, ops, key, block, *rest):
        out, k = orig(cond, body, state, consts, maxiter, go, ops, key, block, *rest)
        seen.append((str(key), loop._signature(tuple(state) + tuple(consts))
                     == loop._signature(tuple(out) + tuple(consts))))
        return out, k

    loop._device_while = spy
    try:
        lt.cg(sym, bd, tol=1e-10, maxiter=50)
        lt.minres(sym, bd, tol=1e-10, maxiter=50)
        lt.bicgstab(op, bd, tol=1e-10, maxiter=50)
        lt.gmres(op, bd, tol=1e-10, restart=8, maxiter=5)
        lt.lsqr(op, bd, tol=1e-10, maxiter=50)
        lt.bicgstab(op, bd, tol=1e-10, maxiter=50, M=M)
    finally:
        loop._device_while = orig
    return seen


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
    """The reference package, its 8-device mesh and a row placement."""
    import jax

    import linops_tpu as lo
    from linops_tpu.parallel import make_mesh, row_sharding

    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    mesh = make_mesh(8)
    return lo, mesh, lambda v: jax.device_put(jax.numpy.asarray(v), row_sharding(mesh))


def reference_ops(lo, mesh, place):
    """kind -> (the reference's distributed operator, b placed as the
    reference places it)."""
    import jax.numpy as jnp
    from linops_tpu.parallel import banded_partition, make_mesh2d, shard_operator, \
        stencil_partition_2d

    A, b = nonsymmetric(1)
    Ab, bb = banded(2)
    ny, nx, coeffs = STENCIL
    L2 = stencil_partition_2d(jnp.asarray(coeffs), ny, nx, make_mesh2d(4, 2))
    bs = L2.grid_to_vec(jnp.asarray(np.random.default_rng(3).standard_normal((ny, nx))))
    return {"shard": (shard_operator(lo.MatrixOperator(A), mesh), place(b)),
            "banded": (banded_partition(Ab, mesh), place(bb)),
            "stencil2d": (L2, bs)}


def as_grid(kind, op_j, x_j):
    """The reference's result as the world's ``grid`` entry holds the port's."""
    return np.asarray(op_j.vec_to_grid(x_j)).reshape(-1) if kind == "stencil2d" else \
        np.asarray(x_j)


KINDS = ("shard", "banded", "stencil2d")


@pytest.mark.parametrize("kind", KINDS)
def test_gmres_on_dtensor_vectors(world, ref, kind):
    """GMRES on a DTensor b: x in b's placement, the unsharded solve's
    restarts and x, the reference's x and placement."""
    lo, mesh, place = ref
    r = result(world, "gmres_on_dtensor_vectors")[kind]["gmres"]
    op_j, b_j = reference_ops(lo, mesh, place)[kind]
    x_j, k_j, _ = lo.gmres(op_j, b_j, tol=1e-12, restart=10, maxiter=20)
    assert r["k"] == r["k_un"] == int(k_j)
    close(r["y"], r["un"])
    close(r["grid"], as_grid(kind, op_j, x_j))
    assert r["kind"] == kind_of_sharding(x_j) == "row"
    assert r["res"] <= 1e-12 * np.linalg.norm(np.asarray(b_j)) * 10


@pytest.mark.parametrize("kind", KINDS)
def test_gmres_collectives_per_arnoldi_step(world, kind):
    """One Arnoldi step issues the operator's own collectives, one
    all-reduce of the projections and one of the norm, and nothing else:
    the basis is never gathered."""
    r = result(world, "gmres_on_dtensor_vectors")[kind]
    op, step = r["per_apply"], r["per_step"]
    assert op["all-gather"] == {"shard": 1, "banded": 0, "stencil2d": 0}[kind]
    assert op["collective-permute"] == {"shard": 0, "banded": 2, "stencil2d": 4}[kind]
    # a reduction over a mesh of d dimensions is one all-reduce per dimension
    dims = 2 if kind == "stencil2d" else 1
    want = dict(op, **{"all-reduce": op["all-reduce"] + 2 * dims})
    assert step == want, (step, op)
    # the whole solve: one apply for the first residual, then per restart one
    # for its residual, one per step (restart 10) and one for the new residual
    applies = 1 + r["gmres"]["k"] * (1 + 10 + 1)
    assert r["counts"]["all-gather"] == op["all-gather"] * applies
    assert r["counts"]["collective-permute"] == op["collective-permute"] * applies


@pytest.mark.parametrize("kind", KINDS)
def test_gmres_inverse_on_dtensor_vectors(world, ref, kind):
    """``opIterativeInverse(op, solver="gmres") * b`` on a DTensor."""
    lo, mesh, place = ref
    r = result(world, "gmres_on_dtensor_vectors")[kind]["inverse"]
    op_j, b_j = reference_ops(lo, mesh, place)[kind]
    y_j = lo.opIterativeInverse(op_j, solver="gmres", tol=1e-12, maxiter=60) * b_j
    close(r["y"], r["un"])
    close(r["grid"], as_grid(kind, op_j, y_j))
    assert r["kind"] == kind_of_sharding(y_j) == "row"


@pytest.mark.parametrize("kind", KINDS)
def test_bicgstab_with_auto_inverse_on_dtensor_vectors(world, ref, kind):
    """BiCGSTAB preconditioned by the "auto" inverse (GMRES: the operators
    are not symmetric) on a DTensor b: the unsharded solve's iterations,
    inner restarts and x; the reference's x and placement."""
    lo, mesh, place = ref
    r = result(world, "gmres_on_dtensor_vectors")[kind]["auto"]
    op_j, b_j = reference_ops(lo, mesh, place)[kind]
    M_j = lo.opIterativeInverse(op_j, solver="auto", tol=1e-2, maxiter=30)
    x_j, k_j, _ = lo.bicgstab(op_j, b_j, tol=1e-12, maxiter=200, M=M_j)
    assert r["solver"] == "gmres"
    assert r["k"] == r["k_un"] == int(k_j) and r["inner"] == r["inner_un"]
    close(r["y"], r["un"])
    close(r["grid"], as_grid(kind, op_j, x_j))
    assert r["kind"] == kind_of_sharding(x_j) == "row"


def test_funm_apply_on_dtensor(world, ref):
    """``funm_apply`` on a DTensor b: the plain call's result in b's
    placement, its Lanczos basis never gathered (the only all-gathers are
    the sharded operator's own)."""
    lo, mesh, place = ref
    from linops_tpu.parallel import shard_operator
    import jax.numpy as jnp

    r = result(world, "funm_apply_on_dtensor")
    S, b = spd(4)
    op_j = shard_operator(lo.LinearOperator(S, symmetric=True, hermitian=True), mesh)
    y_j = lo.funm_apply(op_j, jnp.exp, place(b), lanczos_steps=20)
    close(r["y"], r["un"])
    close(r["y"], np.asarray(y_j))
    assert r["kind"] == kind_of_sharding(y_j) == "row"
    assert r["counts"]["all-gather"] == 20 * r["per_apply"]["all-gather"]


QN_MODELS = ("plain", "damped_forward", "damped_inverse", "lsr1")


def reference_qn(lo, mesh, place, name, pairs, g):
    from linops_tpu.parallel import shard_operator

    make = {"plain": lambda: lo.LBFGSOperator(N, mem=4),
            "damped_forward": lambda: lo.LBFGSOperator(N, mem=4, damped=True),
            "damped_inverse": lambda: lo.InverseLBFGSOperator(N, mem=4, damped=True),
            "lsr1": lambda: lo.LSR1Operator(N, mem=4)}[name]
    op = shard_operator(make(), mesh)
    for i, (s, y) in enumerate(pairs):
        if name == "damped_inverse":
            op.push(place(s), place(y), 0.5 + 0.1 * i, place(g))
        else:
            op.push(place(s), place(y))
    return op


@pytest.mark.parametrize("name", QN_MODELS)
def test_quasi_newton_push_on_sharded_state(world, ref, name):
    """DTensor pairs pushed into sharded state: every field the unsharded
    push's and the reference's, every field's placement what it was before
    the pushes (memories split along n), and the pushed model's apply."""
    lo, mesh, place = ref
    r = result(world, "quasi_newton_on_sharded_state")
    q = r[name]
    op_j = reference_qn(lo, mesh, place, name, qn_pairs(6), r["g"])
    assert q["after"] == q["before"]
    assert q["before"]["S"] == "(Shard(dim=1),)" and q["before"]["Y"] == "(Shard(dim=1),)"
    for f, got in q["state"].items():
        np.testing.assert_allclose(got, q["state_un"][f], rtol=1e-12, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(got, np.asarray(getattr(op_j.state, f)), rtol=RTOL,
                                   atol=1e-12, err_msg=f)
    y_j = op_j * place(q["v"])
    close(q["apply"]["y"], q["apply_un"])
    close(q["apply"]["y"], np.asarray(y_j))
    assert q["apply"]["kind"] == kind_of_sharding(y_j) == "row"


@pytest.mark.parametrize("method", ["compact", "ejm", "batch"])
def test_shifted_solves_on_sharded_state(world, ref, method):
    """``solve_shifted_system[s]`` on the sharded model with a DTensor b:
    the unsharded solves' x and the reference's, in b's placement."""
    lo, mesh, place = ref
    r = result(world, "quasi_newton_on_sharded_state")
    sh = r["shifted"]
    op_j = reference_qn(lo, mesh, place, "plain", qn_pairs(6), r["g"])
    b_j = place(sh["b"])
    if method == "batch":
        y_j = lo.solve_shifted_systems(op_j, b_j, np.asarray(SIGMAS))
        close(sh["batch"]["y"], sh["batch_un"])
        close(sh["batch"]["y"], np.asarray(y_j))
        assert sh["batch"]["kind"] == "row" and not y_j.sharding.is_fully_replicated
        return
    sigmas = SIGMAS if method == "compact" else SIGMAS[1:]
    for got, un, s_ in zip(sh[method], sh[method + "_un"], sigmas):
        y_j = lo.solve_shifted_system(op_j, b_j, s_, method=method)
        close(got["y"], un)
        close(got["y"], np.asarray(y_j))
        assert got["kind"] == kind_of_sharding(y_j) == "row"


PLAIN_CALLS = ("diag", "dense", "mul", "kron", "chain", "cg", "minres", "nystrom", "nystrom_cg")


@pytest.mark.parametrize("name", PLAIN_CALLS)
def test_plain_operators_given_dtensor(world, ref, name):
    """A plain operator or preconditioner given a DTensor returns a DTensor
    in the reference's placement (a diagonal, Kronecker or Nyström apply
    keeps the rows split, a dense product is replicated), with the plain
    call's values and the reference's."""
    lo, mesh, place = ref
    import jax.numpy as jnp
    from linops_tpu.parallel import shard_operator
    from linops_tpu.utils.eig import NystromPreconditioner

    r = result(world, "plain_operators_given_dtensor")
    q, inp = r[name], r["inputs"]
    b_j = place(inp["b"])
    dense = lo.MatrixOperator(inp["A"])
    S_sh = shard_operator(lo.LinearOperator(inp["S"], symmetric=True, hermitian=True), mesh)
    M = lo.opDiagonal(inp["d"])
    y_j = {"diag": lambda: M * b_j,
           "dense": lambda: dense * b_j,
           "mul": lambda: lo.mul(dense, b_j, alpha=2.0, beta=0.5, res=b_j),
           "kron": lambda: lo.kron(lo.opEye(8), lo.MatrixOperator(inp["B"])) * b_j,
           "chain": lambda: lo.matvec_chain(dense, b_j, 3),
           "cg": lambda: lo.cg(S_sh, b_j, tol=1e-12, maxiter=200, M=M)[0],
           "minres": lambda: lo.minres(S_sh, b_j, tol=1e-12, maxiter=200, M=M)[0],
           "nystrom": lambda: NystromPreconditioner(jnp.asarray(q["U"]),
                                                   jnp.asarray(q["lam"])) * b_j,
           "nystrom_cg": lambda: lo.cg(S_sh, b_j, tol=1e-12, maxiter=200, M=NystromPreconditioner(
               jnp.asarray(q["U"]), jnp.asarray(q["lam"])))[0]}[name]()
    close(q["y"], q["un"])
    close(q["y"], np.asarray(y_j))
    assert q["kind"] == kind_of_sharding(y_j)
    # α·A b + β·b: the sum with the row-split b is row-split in both
    assert q["kind"] == ("replicated" if name == "dense" else "row")
    if name in ("cg", "minres", "nystrom_cg"):
        assert q["k"] == q["k_un"]


def test_solve_keys_on_dtensor_vectors(world):
    """A plain-vector and a DTensor GMRES over one sharded operator take one
    cache key (the plain b is placed in the operator's layout, so both carry
    the same DTensor state) and agree; pushes of
    DTensor pairs keep a preconditioned CG's key (the loop cache does not
    grow), and each solve after a push is the unsharded model's."""
    r = result(world, "solve_keys_on_dtensor_vectors")
    assert r["gmres_keys"] == 1
    close(r["gmres"][1], r["gmres"][0])
    assert r["same_key"] and len(set(r["sizes"])) == 1, r["sizes"]
    for got, want in r["xs"]:
        close(got, want)


def test_loop_state_keeps_its_layout(world):
    """Every while loop of a solve on DTensor vectors returns the state
    signature it started with: a flag made plain stays plain, a DTensor
    keeps its placements (on the card a solve whose key moved would never
    replay its captured block)."""
    seen = result(world, "loop_state_keeps_its_layout")
    assert {k for k, _ in seen} >= {"('cg',)", "('minres',)", "('bicgstab',)", "('gmres', 8)",
                                    "('lsqr',)"}, seen
    assert all(same for _, same in seen), seen
