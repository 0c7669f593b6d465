"""Rectangular operators and LSQR: matrix-free least squares.

The PyTorch port of ``examples/05_least_squares.py``: a downsampling
measurement model written as the operator graph R @ Blur (a DIA blur and a
restriction; no dense matrix is formed), and the damped least-squares
reconstruction by ``lsqr`` on ``utils/loop.py``'s device loop (one host read
per block of iterations; on a CUDA device each block a CUDA-graph replay),
checked against the dense Tikhonov normal equations; on the CUDA device
unless ``main`` is given the CPU.

Run: python examples/torch/05_least_squares.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

n = 4096  # signal length
m = n // 2  # number of measurements


def main(device=None):
    dev = default_device(device, "example 05")
    f64 = torch.float64
    # Blur: symmetric tridiagonal smoothing as a DIA (banded) operator
    blur = lt.opDIA(torch.stack([torch.full((n,), 0.25, dtype=f64, device=dev),
                                 torch.full((n,), 0.5, dtype=f64, device=dev),
                                 torch.full((n,), 0.25, dtype=f64, device=dev)]),
                    offsets=(-1, 0, 1))

    # Subsampling: every 2nd sample, as a restriction operator (neighboring
    # measurements share blur support, so the normal equations are coupled)
    rows = torch.arange(0, n, 2, device=dev)
    A = lt.opRestriction(rows, n, device=dev) @ blur  # (m, n) lazy graph
    print("model:", A.shape, "graph:", type(A).__name__)

    # Ground truth: a few steps
    rng = np.random.default_rng(0)
    x_true = np.zeros(n)
    for _ in range(12):
        i, j = sorted(rng.integers(0, n, 2))
        x_true[i:j] += rng.standard_normal()
    b = A.apply(torch.as_tensor(x_true, device=dev), "N")
    b = b + 0.01 * torch.as_tensor(rng.standard_normal(m), device=dev)  # measurement noise

    # Damped LSQR on the device loop
    x, iters, arnorm = lt.lsqr(A, b, damp=0.05, tol=1e-10, maxiter=400)
    res = float(torch.linalg.vector_norm(A.apply(x, "N") - b))
    print(f"lsqr: {iters} iterations, ||Ax-b|| = {res:.4f}, "
          f"||A'r|| est = {float(arnorm):.2e}")

    # Oracle check against the dense normal equations
    Ad = A.to_dense().cpu().numpy()
    bh = b.cpu().numpy()
    x_ref = np.linalg.solve(Ad.T @ Ad + 0.05 ** 2 * np.eye(n), Ad.T @ bh)
    err = np.linalg.norm(x.cpu().numpy() - x_ref) / np.linalg.norm(x_ref)
    print(f"vs dense Tikhonov oracle: rel err {err:.2e}")
    assert err < 1e-6
    print("ok")
    return {"x": x, "iters": iters, "arnorm": float(arnorm), "res": res, "err": err, "b": b}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
