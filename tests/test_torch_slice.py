"""The port's slice 1 as a whole, against the JAX reference on the CPU:

- the main path's graph D (BᵀB) D + σI over a BSR operator, solved by CG
  with an inverse L-BFGS preconditioner, in f64: the same iteration count,
  and x within 1e-10·max|x| (the two sum in different orders, so the
  iterates drift apart by rounding only);
- the step of ``__graft_entry__.entry()`` in f32, within 1e-5·max|x|
  (f32 rounding of sums over n = 8192 in different orders);
- slice 3's path: CG on an unstructured SPD matrix A = R + Rᵀ + D through
  ``opSparse(format="auto", symmetric=True)`` (the Clos-routed operator),
  in f64: the same iteration count (±1) and x within 1e-9·max|x|; the
  operator's N and T applies within 1e-10 of the reference's;
- slice 4's path, small: a saddle-point system
  ``vcat(hcat(A, Bᵀ), hcat(B, opZeros))`` (A = I + L a 2-D Laplacian through
  ``opSparse(format="bsr", symmetric=True)``, B an ``opRestriction``) under
  MINRES, a shifted non-symmetric routed operator under GMRES and BiCGSTAB,
  LSQR with damping on a 2:1 rectangular routed operator (its transpose the
  derived one), and multi-RHS CG over the routed matrix apply (reached on
  the CPU through the ``_on_card`` seam); in f64, iterations equal (±1) and
  x within 1e-8·‖x‖ of the reference's;
- ``import linops_tpu_torch`` (and each module of slices 3, 4 and 6) leaves
  jax and the JAX package out of ``sys.modules``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.sparse.formats import bsr_from_dense as jax_bsr_from_dense
from linops_tpu_torch.convert import bsr_from_reference, diagonal_from_reference, from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max())


def _graph(pkg, D, bsr_data, sigma, dtype):
    B = pkg.BSROperator(bsr_data)
    return D @ (B.T @ B) @ D + sigma * pkg.opEye(D.nrow, dtype=dtype)


def test_main_path_graph_cg_lbfgs_f64(rng):
    n, mem, sigma = 512, 6, 2.0
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02) / 3.0
    d = np.linspace(1.0, 2.0, n)
    bsr_j = jax_bsr_from_dense(A, (8, 128))
    Dj = lo.opDiagonal(jnp.asarray(d))
    Aj = _graph(lo, Dj, bsr_j, sigma, jnp.float64)
    # the port's diagonal and blocks are carried across from the reference's
    At = _graph(lt, diagonal_from_reference(np.asarray(Dj.d), device="cpu"),
                bsr_from_reference(np.asarray(bsr_j.blocks), np.asarray(bsr_j.block_cols),
                                   bsr_j.shape, device="cpu"), sigma, torch.float64)
    dense = np.diag(d) @ A.T @ A @ np.diag(d) + sigma * np.eye(n)

    Hj = lo.InverseLBFGSOperator(n, mem=mem)
    Ht = lt.InverseLBFGSOperator(n, mem=mem, device="cpu")
    for _ in range(mem):
        s = rng.standard_normal(n)
        Hj.push(jnp.asarray(s), Aj * jnp.asarray(s))
        Ht.push(torch.from_numpy(s), At * torch.from_numpy(s))
    b = rng.standard_normal(n)

    xj, kj, rj = lo.cg(Aj, jnp.asarray(b), tol=1e-10, maxiter=300, M=Hj)
    xt, kt, rt = lt.cg(At, torch.from_numpy(b), tol=1e-10, maxiter=300, M=Ht)
    assert kt == int(kj) and kt < 300
    assert rel_err(xt, xj) <= 1e-10
    assert float(rt) <= 1e-10 * np.linalg.norm(b)
    assert rel_err(dense @ xt.numpy(), b) <= 1e-9

    # matvec_chain on the same graph
    v = rng.standard_normal(n)
    assert rel_err(lt.matvec_chain(At, torch.from_numpy(v), 5),
                   lo.matvec_chain(Aj, jnp.asarray(v), 5)) <= 1e-10
    assert rel_err(lt.matvec_chain(At.T, torch.from_numpy(v), 3, normalize=False),
                   lo.matvec_chain(Aj, jnp.asarray(v), 3, mode="T", normalize=False)) <= 1e-10


def test_cg_without_preconditioner_and_with_x0(rng):
    n = 40
    Q = rng.standard_normal((n, n))
    M = Q @ Q.T + n * np.eye(n)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    xj, kj, _ = lo.cg(lo.LinearOperator(jnp.asarray(M)), jnp.asarray(b), jnp.asarray(x0),
                      tol=1e-12, maxiter=100)
    xt, kt, _ = lt.cg(lt.LinearOperator(torch.from_numpy(M)), torch.from_numpy(b),
                      torch.from_numpy(x0), tol=1e-12, maxiter=100)
    assert kt == int(kj)
    assert rel_err(xt, xj) <= 1e-10


def test_entry_step_matches_graft_entry():
    """``__graft_entry__.entry()``'s step, rebuilt in the port from the same
    numbers, against the reference's jitted ``fn``."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge

    fn, args = ge.entry()
    ref = np.asarray(jax.jit(fn)(*args))

    n = 8192
    f32 = torch.float32
    rng = np.random.default_rng(0)  # entry()'s pair stream
    d1 = from_numpy(jnp.linspace(1.0, 2.0, n, dtype=jnp.float32), device="cpu")
    d2 = from_numpy(jnp.linspace(0.5, 1.5, n, dtype=jnp.float32), device="cpu")
    H = lt.InverseLBFGSOperator(f32, n, mem=8, device="cpu")
    for _ in range(8):
        s = rng.standard_normal(n).astype(np.float32)
        y = (s + 0.1 * rng.standard_normal(n)).astype(np.float32)
        H.push(s, y)
    A = 2.0 * (lt.opDiagonal(d1) @ (lt.opEye(n, dtype=f32) + lt.opDiagonal(d2)))
    x = torch.zeros(n, dtype=f32)
    b = torch.ones(n, dtype=f32)
    r = b - A.apply(x, "N")
    z = H.apply(r, "N")
    got = x + (torch.vdot(r, z) / torch.vdot(z, A.apply(z, "N"))) * z
    assert got.dtype == f32 and ref.dtype == np.float32
    assert rel_err(got, ref.astype(np.float64)) <= 1e-5


def spd_unstructured(n, per_row, seed):
    """A = R + Rᵀ + D: R with Poisson(per_row) uniform columns per row and
    normal values, D making A strictly diagonally dominant (chip_smoke's
    slice-3 matrix, small)."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    counts = rng.poisson(per_row, n)
    rows = np.repeat(np.arange(n), counts)
    R = sps.csr_matrix((rng.standard_normal(counts.sum()), (rows, rng.integers(0, n, counts.sum()))),
                       shape=(n, n))
    S = (R + R.T).tocsr()
    return (S + sps.diags(np.asarray(abs(S).sum(axis=1)).ravel() + 1.0)).tocsr()


def test_slice3_path_cg_on_routed_unstructured_f64():
    A = spd_unstructured(3000, 4, seed=7)
    op_t = lt.opSparse(A, format="auto", symmetric=True, device="cpu")
    op_j = lo.opSparse(A, format="auto", symmetric=True)
    assert isinstance(op_t, lt.RoutedCSROperator) and isinstance(op_j, lo.RoutedCSROperator)
    assert op_t.routed.vals.shape[1] > 128  # a 5-stage route
    rng = np.random.default_rng(8)
    b = rng.standard_normal(3000)
    xj, kj, _ = lo.cg(op_j, jnp.asarray(b), tol=1e-10, maxiter=500)
    xt, kt, _ = lt.cg(op_t, torch.from_numpy(b), tol=1e-10, maxiter=500)
    assert abs(kt - int(kj)) <= 1 and kt < 500
    assert rel_err(xt, xj) <= 1e-9
    assert np.linalg.norm(A @ xt.numpy() - b) <= 1e-9 * np.linalg.norm(b)
    v = rng.standard_normal(3000)
    for mode in ("N", "T"):
        assert rel_err(op_t.matvec(torch.from_numpy(v), mode=mode),
                       op_j.matvec(jnp.asarray(v), mode=mode)) <= 1e-10


def laplacian(g):
    """I + L, L the 5-point Laplacian on a g x g grid (scipy CSR, f64)."""
    import scipy.sparse as sps

    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    eye = sps.identity(g)
    return (sps.kron(eye, t) + sps.kron(t, eye) + sps.identity(g * g)).tocsr()


def unstructured(n_r, n_c, per_row, seed):
    """Poisson(per_row) uniform columns per row, normal values (scipy CSR)."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    counts = rng.poisson(per_row, n_r)
    rows = np.repeat(np.arange(n_r), counts)
    A = sps.csr_matrix((rng.standard_normal(counts.sum()),
                        (rows, rng.integers(0, n_c, counts.sum()))), shape=(n_r, n_c))
    A.sum_duplicates()
    return A


def same_x(got, ref, k_got, k_ref, slack=1):
    assert abs(int(k_got) - int(k_ref)) <= slack, (int(k_got), int(k_ref))
    assert np.linalg.norm(got.numpy() - np.asarray(ref)) <= 1e-8 * np.linalg.norm(ref)


def test_slice4_saddle_point_minres_f64():
    g = 24
    Ad = laplacian(g)
    n = g * g
    idx = np.arange(0, n, 8)
    p = idx.size
    A_j = lo.opSparse(Ad, format="bsr", symmetric=True)
    A_t = lt.opSparse(Ad, format="bsr", symmetric=True, device="cpu")
    B_j, B_t = lo.opRestriction(jnp.asarray(idx), n), lt.opRestriction(idx, n, device="cpu")
    K_j = lo.vcat(lo.hcat(A_j, B_j.T), lo.hcat(B_j, lo.opZeros(p, p)))
    K_t = lt.vcat(lt.hcat(A_t, B_t.T), lt.hcat(B_t, lt.opZeros(p, p, device="cpu")))
    rng = np.random.default_rng(30)
    b = rng.standard_normal(n + p)
    xj, kj, _ = lo.minres(K_j, jnp.asarray(b), tol=1e-10, maxiter=1000)
    xt, kt, _ = lt.minres(K_t, torch.from_numpy(b), tol=1e-10, maxiter=1000)
    same_x(xt, xj, kt, kj)
    Kd = np.block([[Ad.toarray(), np.eye(n)[idx].T], [np.eye(n)[idx], np.zeros((p, p))]])
    assert np.linalg.norm(Kd @ xt.numpy() - b) <= 1e-8 * np.linalg.norm(b)
    v = torch.from_numpy(rng.standard_normal(50))
    pad = torch.zeros(n + p, dtype=torch.float64)
    pad[n - 20:n + 30] = v
    assert rel_err(K_t[100:n + 40, n - 20:n + 30] * v, (K_t * pad)[100:n + 40].numpy()) <= 1e-12


def test_slice4_shifted_routed_gmres_and_bicgstab_f64():
    Ad = unstructured(3000, 3000, 4, seed=31)
    A_j, A_t = lo.opSparse(Ad, format="routed"), lt.opSparse(Ad, format="routed", device="cpu")
    assert isinstance(A_t, lt.RoutedCSROperator)
    S_j, S_t = lo.ShiftedOperator(A_j, 8.0), lt.ShiftedOperator(A_t, 8.0)
    b = np.random.default_rng(32).standard_normal(3000)
    xj, kj, _ = lo.gmres(S_j, jnp.asarray(b), tol=1e-10, restart=30, maxiter=20)
    xt, kt, rt = lt.gmres(S_t, torch.from_numpy(b), tol=1e-10, restart=30, maxiter=20)
    same_x(xt, xj, kt, kj)
    Sd = Ad + 8.0 * np.eye(3000)
    assert np.linalg.norm(Sd @ xt.numpy() - b) <= 1e-9 * np.linalg.norm(b)
    xj, kj, _ = lo.bicgstab(S_j, jnp.asarray(b), tol=1e-10, maxiter=200)
    xt, kt, _ = lt.bicgstab(S_t, torch.from_numpy(b), tol=1e-10, maxiter=200)
    same_x(xt, xj, kt, kj)


def test_slice4_rectangular_routed_lsqr_f64():
    Ad = unstructured(4000, 2000, 8, seed=33)
    A_j, A_t = lo.opSparse(Ad, format="routed"), lt.opSparse(Ad, format="routed", device="cpu")
    assert A_t.routed_t is not None  # the 2:1 matrix passes the skew guard
    b = np.random.default_rng(34).standard_normal(4000)
    xj, kj, aj = lo.lsqr(A_j, jnp.asarray(b), damp=1e-3, tol=1e-10, maxiter=500)
    xt, kt, at = lt.lsqr(A_t, torch.from_numpy(b), damp=1e-3, tol=1e-10, maxiter=500)
    same_x(xt, xj, kt, kj)
    x = xt.numpy()
    r = b - Ad @ x
    assert np.linalg.norm(Ad.T @ r - 1e-6 * x) <= 1e-8 * np.linalg.norm(Ad.T @ b)


def test_slice4_multi_rhs_cg_on_the_routed_matrix_apply(monkeypatch):
    from linops_tpu.sparse import ops as JO
    from linops_tpu_torch.sparse import ops as TO

    Ad = spd_unstructured(2000, 4, seed=35)
    A_j = lo.opSparse(Ad, format="routed", symmetric=True)
    A_t = lt.opSparse(Ad, format="routed", symmetric=True, device="cpu")
    monkeypatch.setattr(TO, "_on_card", lambda t: True)
    monkeypatch.setattr(JO, "_on_tpu", lambda: True)
    assert A_t.matrix_path("N") == "routed"
    B = np.random.default_rng(36).standard_normal((2000, 8))
    Xj, kj, rj = lo.cg(A_j, jnp.asarray(B), tol=1e-10, maxiter=500)
    Xt, kt, rt = lt.cg(A_t, torch.from_numpy(B), tol=1e-10, maxiter=500)
    same_x(Xt, Xj, kt, kj)
    assert tuple(rt.shape) == (8,)
    assert np.all(np.linalg.norm(Ad @ Xt.numpy() - B, axis=0)
                  <= 1e-9 * np.linalg.norm(B, axis=0))


def test_import_does_not_load_jax():
    code = ("import sys, linops_tpu_torch, linops_tpu_torch.convert, "
            "linops_tpu_torch.sparse.routed, linops_tpu_torch.sparse.routing, "
            "linops_tpu_torch.sparse.reorder, linops_tpu_torch.ops.permutation, "
            "linops_tpu_torch.kernels.lane_gather, linops_tpu_torch.native, "
            "linops_tpu_torch.ops.eye, linops_tpu_torch.ops.cat, "
            "linops_tpu_torch.ops.restriction, linops_tpu_torch.ops.shifted, "
            "linops_tpu_torch.utils.krylov, linops_tpu_torch.qn.shifted_solve, "
            "linops_tpu_torch.utils.loop, "
            "linops_tpu_torch.core.segsum, linops_tpu_torch.ops.kron, "
            "linops_tpu_torch.ops.timed, linops_tpu_torch.ops.linalg_ops, "
            "linops_tpu_torch.ops.sparse_factor, linops_tpu_torch.qn.lsr1, "
            "linops_tpu_torch.qn.diagonal, linops_tpu_torch.sparse.dia, "
            "linops_tpu_torch.sparse.stencil, linops_tpu_torch.utils.rng, "
            "linops_tpu_torch.utils.timing, linops_tpu_torch.utils.checks, "
            "linops_tpu_torch.utils.norm, linops_tpu_torch.utils.estimate, "
            "linops_tpu_torch.utils.eig, linops_tpu_torch.utils.checkpoint, "
            "linops_tpu_torch.kernels.small_eigh, "
            "linops_tpu_torch.kernels.small_lstsq, "
            "linops_tpu_torch.core.ad, linops_tpu_torch.parallel, "
            "linops_tpu_torch.parallel.mesh, linops_tpu_torch.parallel.sharded, "
            "linops_tpu_torch.parallel.halo, linops_tpu_torch.parallel.halo2d, "
            "linops_tpu_torch.parallel.init, linops_tpu_torch.parallel.introspect, "
            "linops_tpu_torch.parallel.comm, linops_tpu_torch.parallel.scaling_bench, "
            "linops_tpu_torch.parallel.launch, linops_tpu_torch.parallel.dryrun, "
            "linops_tpu_torch.core.base, linops_tpu_torch.sparse.ops\n"
            "import glob, importlib.util\n"
            "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))  # not run\n"
            "examples = sorted(glob.glob('examples/torch/*.py'))\n"
            "assert len(examples) == 9, examples\n"
            "for i, f in enumerate(examples):  # the ported examples, imported, not run\n"
            "    spec = importlib.util.spec_from_file_location(f'example_{i}', f)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
            "assert not any(m == 'linops_tpu' or m.startswith('linops_tpu.') "
            "for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
