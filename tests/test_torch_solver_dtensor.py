"""The vector solvers on DTensor vectors, on a 4-rank gloo world on the CPU:
the collectives of one iteration against those of the reference's jitted
solve on 4 of its virtual devices, in f64.

One operator: ``banded_partition`` of a band-3 hermitian positive-definite
matrix of n = 64 on a 1 x 4 mesh in both packages, b split as the
operator's vectors are. For cg, minres, bicgstab, gmres (one restart of 16
steps), lsqr and chebyshev:

- the all-reduces of one iteration (tol 0, so every iteration runs: those
  of ``fn(maxiter=8)`` less those of ``fn(maxiter=4)``, over 4; GMRES one
  restart, Chebyshev one step) against the reference's: those of the while
  loop of its jitted solve (its body and condition; GMRES's Arnoldi loop
  times the restart length, ``tests/test_torch_iterinv_dtensor.py``'s
  ``loop_all_reduces``). Each dot of one point is reduced with the others
  of that point and made whole before it meets a split vector, so one
  iteration makes no all-gather and no reduce-scatter. CG makes one
  all-reduce fewer than the reference: it reduces ⟨r, z⟩ and ‖r‖², the
  dots of one point, together, where the reference's loop takes ‖r‖² again
  in its condition;
- x against the port's unsharded solve on the same matrix, within 1e-10
  (f64 sums in other orders), and split as b is.

As in ``tests/test_torch_iterinv_dtensor.py``: one world for the file,
every case run in each rank without jax, numpy results back from rank 0.
"""

import functools
import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
N = 64
SOLVERS = ("cg", "minres", "bicgstab", "gmres", "lsqr", "chebyshev")
RESTART = 16
# the fewer all-reduces per iteration than the reference (see the docstring)
FEWER = {"cg": 1}
RTOL = 1e-10


def banded_spd(n=N, band=3):
    rng = np.random.default_rng(1)
    A = np.zeros((n, n))
    for k in range(1, band + 1):
        d = rng.uniform(-1.0, 1.0, n - k)
        A += np.diag(d, k) + np.diag(d, -k)
    return A + np.diag(np.abs(A).sum(axis=1) + 1.0)


def rhs():
    return np.random.default_rng(2107).standard_normal(N)


def bounds():
    w = np.linalg.eigvalsh(banded_spd())
    return float(w[0]) * 0.99, float(w[-1]) * 1.01


def solve(pkg, solver, op, b, its, tol=0.0):
    """``pkg``'s solver on (op, b), ``its`` iterations at tol 0 (GMRES:
    restarts of RESTART steps; Chebyshev: steps)."""
    if solver == "chebyshev":
        return pkg.chebyshev(op, b, *bounds(), iters=its)
    if solver == "gmres":
        return pkg.gmres(op, b, tol=tol, restart=RESTART, maxiter=its)
    return getattr(pkg, solver)(op, b, tol=tol, maxiter=its)


# --------------------------------------------------------------------------
# The rank side
# --------------------------------------------------------------------------


def vector_solves():
    """solver -> (the collectives of one iteration, x of a 12-iteration
    solve gathered whole, its placements, the unsharded port's x)."""
    import torch.distributed as dist

    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import banded_partition, collective_counts, make_mesh
    from linops_tpu_torch.parallel.comm import gather_full, layout_of

    mesh = make_mesh(WORLD, device="cpu")
    op = banded_partition(banded_spd(), mesh, symmetric=True, hermitian=True)
    op_un = lt.LinearOperator(torch.tensor(banded_spd()), symmetric=True, hermitian=True,
                              device="cpu")
    b = layout_of(op).place(torch.from_numpy(rhs()))
    out = {}
    for solver in SOLVERS:
        a, c = (1, 2) if solver == "gmres" else (4, 8)
        ca, cc = (collective_counts(lambda it=it: solve(lt, solver, op, b, it)) for it in (a, c))
        its = 1 if solver == "gmres" else 12
        x = solve(lt, solver, op, b, its)[0]
        x_un = solve(lt, solver, op_un, torch.from_numpy(rhs()), its)[0]
        out[solver] = dict(per_iteration={k: (cc[k] - ca[k]) / (c - a) for k in ca},
                           x=gather_full(x).numpy(), x_un=x_un.numpy(),
                           placements=[type(p).__name__ for p in getattr(x, "placements", ())])
    return out if dist.get_rank() == 0 else None


def world_main():
    import torch.distributed as dist

    out = {}
    for fn in (vector_solves,):
        try:
            out[fn.__name__] = ("ok", fn())
        except Exception:
            out[fn.__name__] = ("error", traceback.format_exc())
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


@functools.lru_cache(maxsize=None)
def reference_per_iteration(solver):
    """The all-reduces of one iteration (GMRES: restart) of the reference's
    jitted solve over ``banded_partition`` on 4 virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import linops_tpu as lo
    from linops_tpu.parallel import banded_partition, make_mesh
    from test_torch_iterinv_dtensor import loop_all_reduces

    if jax.device_count() < WORLD:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    mesh = make_mesh(WORLD)
    op = banded_partition(banded_spd(), mesh, symmetric=True, hermitian=True)
    b = jax.device_put(jnp.asarray(rhs()), NamedSharding(mesh, P(tuple(mesh.axis_names))))
    its = 2 if solver == "gmres" else 8
    text = jax.jit(lambda v: solve(lo, solver, op, v, its)).lower(b).compile().as_text()
    return loop_all_reduces(text, RESTART)


@pytest.mark.parametrize("solver", SOLVERS)
def test_collectives_per_iteration_match_the_reference(world, solver):
    """One iteration's all-reduces: the reference's (CG one fewer); no
    all-gather and no reduce-scatter."""
    got = result(world, "vector_solves")[solver]["per_iteration"]
    want = reference_per_iteration(solver)
    assert got["all-reduce"] == want - FEWER.get(solver, 0), (got, want)
    assert got["all-gather"] == 0 and got["reduce-scatter"] == 0, got


@pytest.mark.parametrize("solver", SOLVERS)
def test_dtensor_solves_match_the_unsharded_solve(world, solver):
    """x of the DTensor solve against the unsharded port's, split as b."""
    r = result(world, "vector_solves")[solver]
    err = float(np.abs(r["x"] - r["x_un"]).max())
    assert err <= RTOL * float(np.abs(r["x_un"]).max()), err
    assert r["placements"] == ["Shard"]
