"""The port's slice 1 as a whole, against the JAX reference on the CPU:

- the main path's graph D (BᵀB) D + σI over a BSR operator, solved by CG
  with an inverse L-BFGS preconditioner, in f64: the same iteration count,
  and x within 1e-10·max|x| (the two sum in different orders, so the
  iterates drift apart by rounding only);
- the step of ``__graft_entry__.entry()`` in f32, within 1e-5·max|x|
  (f32 rounding of sums over n = 8192 in different orders);
- ``import linops_tpu_torch`` leaves jax out of ``sys.modules``.
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
    At = _graph(lt, diagonal_from_reference(np.asarray(Dj.d)),
                bsr_from_reference(np.asarray(bsr_j.blocks), np.asarray(bsr_j.block_cols),
                                   bsr_j.shape), sigma, torch.float64)
    dense = np.diag(d) @ A.T @ A @ np.diag(d) + sigma * np.eye(n)

    Hj = lo.InverseLBFGSOperator(n, mem=mem)
    Ht = lt.InverseLBFGSOperator(n, mem=mem)
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
    d1 = from_numpy(jnp.linspace(1.0, 2.0, n, dtype=jnp.float32))
    d2 = from_numpy(jnp.linspace(0.5, 1.5, n, dtype=jnp.float32))
    H = lt.InverseLBFGSOperator(f32, n, mem=8)
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


def test_import_does_not_load_jax():
    code = ("import sys, linops_tpu_torch, linops_tpu_torch.convert; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
