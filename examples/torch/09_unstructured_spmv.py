"""Unstructured sparse operators: routed SpMV, permutations, RCM.

The PyTorch port of ``examples/09_unstructured_spmv.py``: a scattered
matrix through ``opSparse(format="auto")`` (the Clos-routed pipeline, whose
crossbars run the lane kernels K7-K12 on the card in f32), its adjoint and
a normal-equations chain; a permutation operator; an RCM conjugation of a
banded mesh pattern by the native reorder, by hand and as
``opSparse(reorder="rcm")``; on the CUDA device unless ``main`` is given
the CPU.

Run: python examples/torch/09_unstructured_spmv.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch import native  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

n = 4096


def rel(got, ref) -> float:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def main(device=None):
    dev = default_device(device, "example 09")
    out = {}
    rng = np.random.default_rng(0)

    # --- a genuinely scattered matrix (16 random nnz per row) -------------------
    A = sp.random(n, n, density=16 / n, format="csr", random_state=0)
    A.data[:] = rng.standard_normal(A.nnz)

    op = lt.opSparse(A, format="auto", device=dev)  # scattered -> Clos-routed
    print(f"auto picked: {type(op).__name__}")

    x = rng.standard_normal(n)
    xt = torch.as_tensor(x, device=dev)
    out["forward"] = rel(op * xt, A @ x)
    print("forward  rel err:", out["forward"])
    out["adjoint"] = rel(op.T * xt, A.T @ x)
    print("adjoint  rel err:", out["adjoint"])

    # routed operators participate in the full algebra
    chain = 2.0 * (op.T @ op) + lt.opEye(n, dtype=op.dtype)
    out["chain"] = rel(chain * xt, 2.0 * (A.T @ (A @ x)) + x)
    print("normal-equations chain rel err:", out["chain"])

    # --- permutations as first-class operators ----------------------------------
    perm = rng.permutation(n)
    P = lt.opPermutation(perm, device=dev)
    out["perm_exact"] = bool(np.array_equal((P * xt).cpu().numpy(), x[perm]))
    out["perm_roundtrip"] = bool(np.allclose((P.T * (P * xt)).cpu().numpy(), x))
    print("P x == x[perm]:", out["perm_exact"])
    print("Pᵀ P x == x   :", out["perm_roundtrip"])

    # RCM conjugation: P A Pᵀ is banded for mesh-like patterns, and the whole
    # conjugated operator is still a lazy graph applied on the device
    mesh = sp.diags([np.ones(n - 64), np.ones(n), np.ones(n - 64)], [-64, 0, 64], format="csr")
    if native.available():
        rcm = native.rcm_permutation(mesh.indices, mesh.indptr, n)
        Pr = lt.opPermutation(np.asarray(rcm, np.int64), device=dev)
        opm = lt.opSparse(mesh.tocsr(), format="csr", device=dev)
        banded = Pr @ opm @ Pr.T
        out["rcm"] = rel(banded * xt, mesh.toarray()[rcm][:, rcm] @ x)
        print("RCM-conjugated apply rel err:", out["rcm"])

    # One-keyword version: opSparse(reorder="rcm") computes the RCM
    # permutation, reorders on the host, builds the inner operator through
    # the auto-format pipeline (banded patterns land on BSR) and returns the
    # sandwich Pᵀ·op(A[perm][:,perm])·P; flags carry over.
    if native.available():
        sigma = rng.permutation(n)
        scrambled = mesh[sigma][:, sigma].tocsr()
        op_re = lt.opSparse(scrambled, format="auto", reorder="rcm", symmetric=True, device=dev)
        out["reorder"] = rel(op_re * xt, scrambled @ x)
        out["inner"] = type(op_re.inner).__name__
        print("reorder='rcm' inner:", out["inner"], "| apply rel err:", out["reorder"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
