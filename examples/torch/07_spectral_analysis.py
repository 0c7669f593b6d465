"""Matrix-free spectral analysis of an operator graph.

The PyTorch port of ``examples/07_spectral_analysis.py``: on a discrete
Schroedinger operator (a 48² Laplacian plus a strongly varying diagonal
potential, never densified), LOBPCG extremal eigenpairs with and without a
Jacobi preconditioner, a Hutch++ trace, diagonal probes, the opnorm
estimate with its LOBPCG cross-check, the heat kernel by Lanczos and a
Nyström-preconditioned CG, on the CUDA device unless ``main`` is given the
CPU. LOBPCG runs on ``utils/loop.py``'s device loop: on a CUDA device its
iterations replay as CUDA graphs, with the small eigenproblems in E1
(``kernels/small_eigh.py``).

The random draws (the potential, start blocks, probes, the spike basis and
the right-hand side) come from torch generators seeded as the reference
seeds its keys (0 ... 6); they are not the reference's numbers.
``potential=`` takes the reference's potential instead, so that both
examples run on one operator.

Run: python examples/torch/07_spectral_analysis.py [--device cpu]
"""

import argparse
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

ng = 48
n = ng * ng


def main(device=None, potential=None):
    dev = default_device(device, "example 07")
    f64 = torch.float64

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # A graph-structured hermitian operator: 2-D Laplacian + a strongly
    # varying diagonal potential (a discrete Schroedinger operator)
    if potential is None:
        potential = 0.5 + 50.0 * torch.rand(n, generator=gen(0), dtype=f64, device=dev) ** 4
    else:
        potential = torch.tensor(np.array(potential), dtype=f64, device=dev)
    A = lt.laplacian_2d(ng, ng, dtype=f64, device=dev) + lt.opDiagonal(potential)
    assert A.hermitian

    # --- extremal eigenpairs (ground states), Jacobi-preconditioned -----------
    M = lt.opDiagonal(1.0 / (4.0 + potential))
    theta, X, res, iters_m = lt.lobpcg(A, k=4, tol=1e-8, maxiter=500, M=M, generator=gen(1))
    print(f"lowest 4 eigenvalues: {theta.cpu().numpy()}  ({iters_m} iterations)")
    _, _, _, iters = lt.lobpcg(A, k=4, tol=1e-8, maxiter=500, generator=gen(1))
    print(f"without the Jacobi preconditioner: {iters} iterations")

    # --- trace: exact value is 4n + sum(potential) -----------------------------
    tr_true = 4.0 * n + float(torch.sum(potential))
    est, se = lt.estimate_trace(A, probes=96, generator=gen(2))
    print(f"trace: hutch++ {est:.2f} +- {se:.2f}   (exact {tr_true:.2f})")

    # --- diagonal probes --------------------------------------------------------
    d_est, d_se = lt.estimate_diagonal(A, probes=256, generator=gen(3))
    d_true = 4.0 + potential
    err = float(torch.max(torch.abs(d_est - d_true)))
    print(f"diagonal probes: max err {err:.3f} (off-diagonal mass bounds the rate)")

    # --- opnorm: Lanczos, with the LOBPCG fallback on clustered edges ----------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        nrm, ok = lt.estimate_opnorm(A, generator=gen(4))
    th_top, _, res_top, _ = lt.lobpcg(A, k=1, largest=True, tol=1e-8, maxiter=500,
                                      generator=gen(4))
    print(f"opnorm: {nrm:.4f} (converged: {ok}); "
          f"direct lobpcg agrees: {float(th_top[0]):.4f}")

    # --- matrix functions: the heat kernel exp(-t A) b by Lanczos --------------
    b = torch.zeros(n, dtype=f64, device=dev)
    b[n // 2 + ng // 2] = 1.0  # point source
    u = lt.funm_apply(A, lambda x: torch.exp(-0.25 * x), b, lanczos_steps=40)
    print(f"heat kernel: mass {float(torch.sum(u)):.4f}, peak {float(torch.max(u)):.4f} "
          f"(diffused from a point source, no matrix ever formed)")

    # --- randomized Nystrom preconditioner accelerating CG ---------------------
    # a PSD operator with a decaying spectrum: low-rank spike + damped base
    g5 = gen(5)
    Uspike = torch.linalg.qr(torch.randn((n, 24), generator=g5, dtype=f64, device=dev))[0]
    w = 200.0 * 2.0 ** -torch.arange(24, dtype=f64, device=dev)
    spike = lt.LinearOperator(Uspike * w) @ lt.LinearOperator(Uspike.T.contiguous())
    Apd = (0.05 * A + spike).hermitianized()
    rhs = torch.randn(n, generator=g5, dtype=f64, device=dev)
    P = lt.nystrom_preconditioner(Apd, rank=30, generator=gen(6))
    x_plain, it_plain, _ = lt.cg(Apd, rhs, tol=1e-10, maxiter=2000)
    x_nys, it_nys, _ = lt.cg(Apd, rhs, tol=1e-10, maxiter=2000, M=P)
    print(f"nystrom-preconditioned cg: {it_nys} iterations (plain: {it_plain})")
    return {"theta": theta, "res": res, "iters_m": iters_m, "iters": iters, "trace": (est, se),
            "tr_true": tr_true, "diag": (d_est, d_se), "diag_err": err, "opnorm": (nrm, ok),
            "th_top": float(th_top[0]), "res_top": float(res_top[0]), "u": u,
            "it_nys": it_nys, "it_plain": it_plain,
            "cg_residual": float(torch.linalg.vector_norm(Apd @ x_nys - rhs)
                                 / torch.linalg.vector_norm(rhs))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
