"""Trust-region subproblem loop with sigma on the device.

The PyTorch port of ``examples/04_trust_region_on_device.py``: the same
L-BFGS model of a convex quadratic's Hessian and the same Levenberg search,
growing sigma until the shifted step fits the radius. sigma is a tensor the
loop itself produces; the search runs on ``utils/loop.py::device_while``, so
the host reads the stopping test once per block of iterations (on a CUDA
device each block is a CUDA-graph replay), and the shifted solve reads
nothing back.

Run: python examples/torch/04_trust_region_on_device.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.qn.shifted_solve import solve_shifted_system  # noqa: E402
from linops_tpu_torch.utils import loop  # noqa: E402

n, mem = 200, 8


def build_model(device):
    """A forward L-BFGS model of H = A Aᵀ/n + I after 12 gradient steps on
    ½xᵀHx − 1ᵀx (f64, from numpy's seed 0), and the last gradient."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))
    H_true = A @ A.T / n + np.eye(n)
    B = lt.LBFGSOperator(n, mem=mem, dtype=torch.float64, device=device)
    x = np.zeros(n)
    g = H_true @ x - np.ones(n)
    for _ in range(12):
        step = -0.1 * g
        x_new = x + step
        g_new = H_true @ x_new - np.ones(n)
        B.push(step, g_new - g)
        x, g = x_new, g_new
    return B, torch.as_tensor(g, device=device)


def tr_subproblem(op, grad, radius, maxiter: int = 1000):
    """Solve min gᵀp + ½pᵀBp s.t. ‖p‖ ≤ radius by a Levenberg search on the
    device: grow sigma until the shifted step fits the radius. Returns
    (p, sigma), sigma a 0-dim tensor on grad's device."""
    radius = torch.as_tensor(radius, dtype=grad.dtype, device=grad.device)

    def cond(state, consts):
        _, p = state
        return torch.linalg.vector_norm(p) > consts[0]

    def body(state, consts, _):
        sigma, _ = state
        sigma = sigma * 2.0 + 0.1
        return sigma, solve_shifted_system(op, -consts[1], sigma)

    p0 = solve_shifted_system(op, -grad, 0.0)
    sigma0 = torch.zeros((), dtype=grad.dtype, device=grad.device)
    (sigma, p), _ = loop.device_while(cond, body, (sigma0, p0), maxiter, consts=(radius, grad),
                                      ops=(op,), key=("tr_subproblem",))
    return p, sigma


def main(device):
    B, g = build_model(device)
    p, sigma = tr_subproblem(B, g, 0.5)
    step_norm = float(torch.linalg.vector_norm(p))
    print(f"step norm {step_norm:.4f} (radius 0.5), final sigma {float(sigma):.3f}, "
          f"{loop.stats['reads']} host reads, path {loop.stats['path']}")
    assert step_norm <= 0.5 + 1e-9
    # the step solves the shifted system for the returned sigma
    dense = B.to_dense().cpu().numpy()
    resid = (dense + float(sigma) * np.eye(n)) @ p.cpu().numpy() + g.cpu().numpy()
    assert np.linalg.norm(resid) < 1e-8 * max(1.0, np.linalg.norm(g.cpu().numpy()))
    print("on-device trust-region subproblem: OK")
    return p, sigma, resid


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(torch.device(ap.parse_args().device))
