"""Block applies of ``opIterativeInverse`` over distributed operators, on a
4-rank gloo world on the CPU, against the reference's ``apply_matrix`` (a
``jax.vmap`` of its vector apply) on 4 of its virtual devices, in f64.

Three hermitian positive-definite operators of n = 64, each on the same
mesh shape on both sides, so both keep their vectors in the same layout:
``shard_operator`` of a dense ``G Gᵀ + 64 I`` and ``banded_partition`` of a
band-3 matrix on a 1 x 4 mesh, ``stencil_partition_2d`` of an anisotropic
8 x 8 five-point stencil on a 2 x 2 mesh. For each inner solver (cg, minres,
bicgstab, gmres), k = 1, 3 and 6, a column panel (``apply_matrix``) and a
row panel (``apply_matrix_t``) of this rank's rows, given as a DTensor split
as the operator's vectors are (and at k = 3 as a plain tensor):

- its values against the reference's at rtol 1e-10 and against the port's
  unsharded block apply on the same matrix;
- its result split as the operator's vectors are, as the reference's is;
- the all-reduces of one inner iteration (of one GMRES restart) of a
  column panel at k = 1 and 6, and of a row panel at k = 6, equal to the
  reference's: those in the while loop of its vmapped apply's HLO (its
  body and condition, GMRES's Arnoldi loop times the restart length), the
  same for every k. That is one all-reduce per reduction for the k
  vectors (per mesh dimension: DTensor reduces over a 2-D mesh in two),
  two reductions of one point in one (as XLA combines them), but for CG:
  with no preconditioner its ⟨r, z⟩ is ‖r‖², which the port reduces once
  and the reference twice, so the port's CG has one all-reduce fewer;
  every collective no more often than in one vector solve of the port
  (whose DTensor redistributions add some), no all-gather of a panel
  beyond the operator's own. The reference's HLO collective counts of its vmapped apply are
  likewise the same for every k and equal to its vector apply's.

As in ``tests/test_torch_halo_panels.py``: one world for the file, every
case run in each rank without jax, numpy results back from rank 0.
"""

import functools
import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
RTOL = 1e-10
N = 64
KS = (1, 3, 6)
KINDS = ("shard", "banded", "stencil2d")
SOLVERS = ("cg", "minres", "bicgstab", "gmres")
FORMS = ("column dtensor", "column plain", "row dtensor", "row plain")
# inner budgets: GMRES one restart of 16 steps (full GMRES at n = 64 takes
# more, but these operators converge in fewer)
KW = {"cg": dict(tol=1e-10, maxiter=60), "minres": dict(tol=1e-10, maxiter=60),
      "bicgstab": dict(tol=1e-10, maxiter=60), "gmres": dict(tol=1e-10, maxiter=16)}
GRID = (8, 8, [4.0, -1.0, -1.0, -0.7, -0.7])  # symmetric anisotropic coefficients
RESTART = min(30, KW["gmres"]["maxiter"])  # the GMRES inverse's restart length


def dense_spd(n=N):
    G = np.random.default_rng(0).standard_normal((n, n))
    return G @ G.T + 64.0 * np.eye(n)


def banded_spd(n=N, band=3):
    rng = np.random.default_rng(1)
    A = np.zeros((n, n))
    for k in range(1, band + 1):
        d = rng.uniform(-1.0, 1.0, n - k)
        A += np.diag(d, k) + np.diag(d, -k)
    return A + np.diag(np.abs(A).sum(axis=1) + 1.0)


def panel(k):
    """The (n, k) column panel of the calls with k columns (the first k of
    one), in the operators' vector layout."""
    return np.random.default_rng(1910).standard_normal((N, max(KS)))[:, :k].copy()


# --------------------------------------------------------------------------
# The rank side
# --------------------------------------------------------------------------


def port_ops():
    """kind -> (the distributed operator, the unsharded port operator on
    the same matrix in its layout)."""
    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel import (banded_partition, make_mesh, make_mesh2d,
                                           shard_operator, stencil_partition_2d)
    from linops_tpu_torch.parallel.comm import gather_full

    mesh = make_mesh(WORLD, device="cpu")
    ny, nx, coeffs = GRID
    L2 = stencil_partition_2d(torch.tensor(coeffs, dtype=torch.float64), ny, nx,
                              make_mesh2d(2, 2, device="cpu"))
    eye = torch.eye(N, dtype=torch.float64)
    L2_dense = torch.stack([gather_full(L2.apply(eye[:, j], "N")) for j in range(N)], dim=1)
    herm = dict(symmetric=True, hermitian=True, device="cpu")
    ops = {"shard": (shard_operator(lt.LinearOperator(torch.tensor(dense_spd()), **herm), mesh),
                     dense_spd()),
           "banded": (banded_partition(banded_spd(), mesh, symmetric=True, hermitian=True),
                      banded_spd()),
           "stencil2d": (L2, L2_dense.numpy())}
    return {k: (op, lt.LinearOperator(torch.tensor(A), **herm)) for k, (op, A) in ops.items()}


def given(op, form, M):
    """The panel of ``form``: a column panel (n, k) or a row panel (k, n),
    a DTensor split as the operator's vectors are or a plain tensor."""
    from linops_tpu_torch.parallel.comm import layout_of

    t = torch.from_numpy(M)
    if form.endswith("dtensor"):
        t = layout_of(op).place(t)
    return t.T if form.startswith("row") else t


def placements(Y):
    return [type(p).__name__ + str(getattr(p, "dim", "")) for p in Y.placements]


def per_iteration(fn, a, b):
    """The collectives of one iteration: those of ``fn(b)`` less those of
    ``fn(a)``, over b − a."""
    from linops_tpu_torch.parallel import collective_counts

    ca, cb = collective_counts(lambda: fn(a)), collective_counts(lambda: fn(b))
    return {c: (cb[c] - ca[c]) / (b - a) for c in ca}


def panel_solves():
    """(kind, solver, k, form) -> the block apply's value (column
    orientation, whole), its placements, the unsharded port's value;
    (kind, solver, k, "per iteration") -> the all-reduces of one inner
    iteration of the panel solve (tol 0, every vector active);
    (kind, solver, "vector") -> the same of one vector solve."""
    import torch.distributed as dist

    import linops_tpu_torch as lt
    from linops_tpu_torch.parallel.comm import gather_full
    from linops_tpu_torch.utils import krylov

    out = {}
    for kind, (op, op_un) in port_ops().items():
        for solver in SOLVERS:
            inv = lt.opIterativeInverse(op, solver=solver, **KW[solver])
            inv_un = lt.opIterativeInverse(op_un, solver=solver, **KW[solver])
            for k in KS:
                M = panel(k)
                want = inv_un.apply_matrix(torch.from_numpy(M)).numpy()
                for form in FORMS if k == 3 else FORMS[::2]:  # plain panels at k = 3
                    rows = form.startswith("row")
                    Y = (inv.apply_matrix_t if rows else inv.apply_matrix)(given(op, form, M))
                    whole = gather_full(Y)
                    out[kind, solver, k, form] = dict(
                        y=(whole.T if rows else whole).numpy(), un=want,
                        placements=placements(Y), shape=tuple(Y.shape))
                for rows in ((False, True) if k == max(KS) else (False,) if k == 1 else ()):
                    Xd = given(op, ("row" if rows else "column") + " dtensor", M)
                    kw = dict(restart=RESTART) if solver == "gmres" else {}
                    a, b = (1, 2) if solver == "gmres" else (4, 8)
                    out[kind, solver, k, rows, "per iteration"] = per_iteration(
                        lambda it: krylov._solve_panel(solver, op, Xd, rows=rows, tol=0.0,
                                                       maxiter=it, **kw), a, b)
            b0 = given(op, "column dtensor", panel(1))[:, 0]
            if solver == "gmres":
                vec = lambda it: krylov.gmres(op, b0, tol=0.0, restart=RESTART, maxiter=it)  # noqa
                out[kind, solver, "vector"] = per_iteration(vec, 1, 2)
            else:
                vec = lambda it: getattr(krylov, solver)(op, b0, tol=0.0, maxiter=it)  # noqa
                out[kind, solver, "vector"] = per_iteration(vec, 4, 8)
    return out if dist.get_rank() == 0 else None


def world_main():
    import torch.distributed as dist

    out = {}
    for fn in (panel_solves,):
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
def reference_ops():
    import jax
    import jax.numpy as jnp

    import linops_tpu as lo
    from linops_tpu.parallel import (banded_partition, make_mesh, make_mesh2d, shard_operator,
                                     stencil_partition_2d)

    if jax.device_count() < WORLD:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    mesh, mesh2 = make_mesh(WORLD), make_mesh2d(2, 2)
    ny, nx, coeffs = GRID
    herm = dict(symmetric=True, hermitian=True)
    return {"shard": (shard_operator(lo.LinearOperator(jnp.asarray(dense_spd()), **herm), mesh),
                      mesh),
            "banded": (banded_partition(banded_spd(), mesh, **herm), mesh),
            "stencil2d": (stencil_partition_2d(jnp.asarray(coeffs), ny, nx, mesh2), mesh2)}


def _placed(mesh, M, rows):
    """``M`` split as the operator's vectors are (its columns for a row panel)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = tuple(mesh.axis_names)
    spec = (P(None, axes) if rows else P(axes, None)) if M.ndim == 2 else P(axes)
    return jax.device_put(jnp.asarray(M), NamedSharding(mesh, spec))


@functools.lru_cache(maxsize=None)
def reference_call(kind, solver, k, rows):
    """The reference's block apply of the same panel, split as its
    operator's vectors are: (the value in the column orientation, whether
    its result splits the vectors, the HLO collective counts)."""
    import jax

    import linops_tpu as lo
    from linops_tpu.parallel.introspect import hlo_collective_counts

    op, mesh = reference_ops()[kind]
    inv = lo.opIterativeInverse(op, solver=solver, **KW[solver])
    M = _placed(mesh, panel(k).T if rows else panel(k), rows)
    fn = jax.jit((lambda X: inv.apply_matrix_t(X, "N")) if rows else
                 (lambda X: inv.apply_matrix(X, "N")))
    compiled = fn.lower(M).compile()
    y = compiled(M)
    split = y.sharding.shard_shape(y.shape)[int(rows)] < y.shape[int(rows)]
    y = np.asarray(y)
    return (y.T if rows else y), split, hlo_collective_counts(compiled.as_text())


@functools.lru_cache(maxsize=None)
def reference_vector(kind, solver):
    """The HLO collective counts of the reference's vector apply."""
    import jax

    import linops_tpu as lo
    from linops_tpu.parallel.introspect import hlo_collective_counts

    op, mesh = reference_ops()[kind]
    inv = lo.opIterativeInverse(op, solver=solver, **KW[solver])
    b = _placed(mesh, panel(1)[:, 0], False)
    return hlo_collective_counts(jax.jit(lambda v: inv.apply(v, "N")).lower(b).compile().as_text())


CALLS = [(k, form) for k in KS for form in (FORMS if k == 3 else FORMS[::2])]


@pytest.mark.parametrize("k,form", CALLS)
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind", KINDS)
def test_block_apply_matches_the_reference(world, kind, solver, k, form):
    """The values at rtol 1e-10 of the reference's vmapped block apply (the
    first k columns of its k = 6 call) and of the unsharded port's; the
    result split as the operator's vectors are, as the reference's."""
    r = result(world, "panel_solves")[kind, solver, k, form]
    rows = form.startswith("row")
    want, split, _ = reference_call(kind, solver, max(KS), rows)
    got = r["y"]
    assert got.shape == (N, k)
    for ref in (want[:, :k], r["un"]):
        err = float(np.abs(got - ref).max())
        assert err <= RTOL * float(np.abs(ref).max()), f"max|Δ| {err:.3e}"
    assert split
    assert r["shape"] == ((k, N) if rows else (N, k))
    assert f"Shard{int(rows)}" in r["placements"]


def hlo_computations(text) -> dict:
    """An optimized HLO module's computations: name -> its lines."""
    import re

    out, cur = {}, None
    for line in text.split("\n"):
        m = re.match(r"^(?:ENTRY )?%([\w.\-]+) ", line)
        if m and line.rstrip().endswith("{"):
            cur = out[m.group(1)] = []
        elif line.strip() == "}":
            cur = None
        elif cur is not None:
            cur.append(line)
    return out


def loop_all_reduces(text, trips: int) -> int:
    """The all-reduces one iteration of the outermost while loop of an HLO
    module runs: those of its body and its condition, a nested while's
    (GMRES's Arnoldi loop) ``trips`` times over."""
    import re

    comps = hlo_computations(text)
    pat = re.compile(r"\ball-reduce(?:-start)?(?:\.\d+)?\(")
    loops = {name: [re.search(r"condition=%([\w.\-]+), body=%([\w.\-]+)", ln).groups()
                     for ln in lines if " while(" in ln] for name, lines in comps.items()}

    def total(name):
        return (sum(len(pat.findall(ln)) for ln in comps[name])
                + sum(trips * (total(c) + total(b)) for c, b in loops[name]))

    entry = next(n for n in comps if not any(n in (c, b) for ws in loops.values()
                                             for c, b in ws) and loops[n])
    (cond, body), = loops[entry]
    return total(cond) + total(body)


@functools.lru_cache(maxsize=None)
def reference_per_iteration(kind, solver, k):
    """The all-reduces of one iteration (GMRES: restart) of the reference's
    vmapped apply of a k-column panel split as its operator's vectors are."""
    import jax

    import linops_tpu as lo

    op, mesh = reference_ops()[kind]
    inv = lo.opIterativeInverse(op, solver=solver, **KW[solver])
    M = _placed(mesh, panel(k), False)
    text = jax.jit(lambda X: inv.apply_matrix(X, "N")).lower(M).compile().as_text()
    return loop_all_reduces(text, RESTART)


@pytest.mark.parametrize("rows", [False, True], ids=["columns", "rows"])
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind", KINDS)
def test_all_reduces_per_inner_iteration_do_not_depend_on_k(world, kind, solver, rows):
    """The port: the all-reduces of one inner iteration (GMRES: restart) of
    a block apply the reference's (those of the while loop of its vmapped
    apply, the same for k = 1 and 6; one per mesh dimension on the 2-D
    mesh; CG one fewer, its ‖r‖² being its ⟨r, z⟩) for k = 1 and 6; every
    collective no more often than in one vector solve. The reference: its
    vmapped apply compiles to the same collectives for every k as its vector
    apply."""
    r = result(world, "panel_solves")
    vec = r[kind, solver, "vector"]
    want = reference_per_iteration(kind, solver, max(KS))
    assert want > 0 and reference_per_iteration(kind, solver, 1) == want
    # DTensor reduces over a mesh of d dimensions with one all-reduce per dimension
    dims = 2 if kind == "stencil2d" else 1
    fewer = 1 if solver == "cg" else 0
    for k in (1, max(KS)) if not rows else (max(KS),):
        got = r[kind, solver, k, rows, "per iteration"]
        assert got["all-reduce"] == dims * (want - fewer), (k, got, want)
        assert all(got[c] <= vec[c] for c in got), (k, got, vec)
    ref_vec = reference_vector(kind, solver)
    for k in (1, max(KS)):
        assert reference_call(kind, solver, k, rows)[2] == ref_vec, k
