"""Tour of the lazy operator algebra.

The PyTorch port of ``examples/01_operator_algebra.py``: the same leaf
operators (matrix-backed, diagonal, function-backed), the same expression
graph, its adjoint, slices, blocks, a Kronecker product and the counters,
on the CUDA device unless ``main`` is given the CPU.

Run: python examples/torch/01_operator_algebra.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

n = 6


def main(device=None):
    dev = default_device(device, "example 01")
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    d = torch.arange(1.0, n + 1, dtype=torch.float64, device=dev)

    # Leaf operators
    M = lt.LinearOperator(A)  # matrix-backed
    D = lt.opDiagonal(d)
    F = lt.LinearOperator(torch.float32, n, n, True, True, lambda v: v.flip(0))  # noqa: F841

    # Algebra builds a graph; nothing is computed yet
    expr = 2.0 * (D @ M) + M.T - lt.opEye(n, dtype=torch.float64) \
        + lt.ShiftedOperator(D, 0.5)

    v = torch.ones(n, dtype=torch.float64, device=dev)
    y, yH, dense = expr * v, expr.H * v, expr.to_dense()
    print("expr * v      =", y)
    print("expr' * v     =", yH)  # adjoint derived symbolically
    print("dense(expr)   =\n", dense)

    # Slicing returns operators, never materialized rows
    sub = expr[torch.arange(3), torch.arange(4)]
    print("slice shape   =", sub.shape, type(sub).__name__)

    # Block structure
    blk = lt.BlockDiagonalOperator(M, D)
    cat = lt.hcat(M, D)
    print("blockdiag     =", blk.shape, " hcat =", cat.shape)

    # Kronecker products stay lazy (vec-trick applies)
    K = lt.kron(M, D)
    kv = K * torch.ones(n * n, dtype=torch.float64, device=dev)
    print("kron shape    =", K.shape, "; K*ones =", kv[:4], "...")

    # Counters mirror the reference's nprod/ntprod/nctprod
    expr.reset_counters()
    _ = expr * v
    _ = expr.T * v
    print(repr(expr))
    return {"y": y, "yH": yH, "dense": dense, "sub_shape": sub.shape,
            "sub_dense": sub.to_dense(), "blk_shape": blk.shape, "cat_shape": cat.shape,
            "kron_shape": K.shape, "kron_ones": kv, "counters": expr.counters}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
