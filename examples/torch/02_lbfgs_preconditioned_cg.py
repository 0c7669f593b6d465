"""Quasi-Newton operators: L-BFGS as a CG preconditioner, shifted solves.

The PyTorch port of ``examples/02_lbfgs_preconditioned_cg.py``: the same
SPD system (cond 200), plain CG against CG preconditioned by an inverse
L-BFGS operator built from (s, A s) probes, a shifted solve with a forward
L-BFGS model, and a checkpoint round trip (into a temporary directory), on
the CUDA device unless ``main`` is given the CPU.

Run: python examples/torch/02_lbfgs_preconditioned_cg.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

n = 400


def main(device=None):
    dev = default_device(device, "example 02")
    f64 = torch.float64
    rng = np.random.default_rng(1)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A_dense = Q @ np.diag(np.linspace(1, 200, n)) @ Q.T  # SPD, cond 200
    A = lt.LinearOperator(torch.as_tensor(A_dense, device=dev), symmetric=True, hermitian=True)
    b = torch.as_tensor(rng.standard_normal(n), device=dev)

    # Plain CG
    x0, it0, res0 = lt.cg(A, b, tol=1e-8, maxiter=500)
    print(f"CG:              {it0:3d} iterations, residual {float(res0):.2e}")

    # Build an inverse L-BFGS preconditioner from (s, As) probes
    H = lt.InverseLBFGSOperator(n, mem=20, dtype=f64, device=dev)
    for _ in range(20):
        s = rng.standard_normal(n)
        H.push(s, A_dense @ s)  # y = A s  (secant pairs of the quadratic)

    x1, it1, res1 = lt.cg(A, b, tol=1e-8, maxiter=500, M=H)
    print(f"L-BFGS-PCG:      {it1:3d} iterations, residual {float(res1):.2e}")

    # Forward L-BFGS models A itself; solve a shifted trust-region system
    B = lt.LBFGSOperator(n, mem=20, dtype=f64, device=dev)
    for _ in range(20):
        s = rng.standard_normal(n)
        B.push(s, A_dense @ s)
    sigma = 0.5
    x = lt.solve_shifted_system(B, b, sigma)
    resid = torch.linalg.vector_norm(B * x + sigma * x - b) / torch.linalg.vector_norm(b)
    print(f"(B + sigma I)x=b residual: {float(resid):.2e}")

    # Checkpoint and restore
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lbfgs_state.npz")
        lt.save_operator(path, B)
        B2 = lt.LBFGSOperator(n, mem=20, dtype=f64, device=dev)
        lt.load_operator_state(path, B2)
    print("restored push count:", B2.insert, "== original:", B.insert)
    return {"x0": x0, "it0": it0, "res0": float(res0), "x1": x1, "it1": it1,
            "res1": float(res1), "x_shifted": x, "resid": float(resid),
            "insert": (int(B2.insert), int(B.insert)), "restored_apply": B2 * b, "apply": B * b}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
