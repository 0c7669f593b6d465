"""Hold the reference's LOBPCG and the port's to the residual check of
``tests/test_torch_spectral_dtensor.py::test_default_generator_is_one_draw_for_every_rank``
on the same starting blocks.

    python tests/torch_lobpcg_reference_draws.py DRAWS [--kind banded]

Draw i is an (n, 2) starting block from numpy's generator seeded i. Both
packages run ``lobpcg(A, k=2, X0=block, maxiter=1000)`` (tol 1e-6) in f64 on
the CPU, on the test's matrix of that kind as an unsharded hermitian
operator, and each result is held to the test's check ‖A X − X θ‖ ≤ 1.01 res
column by column, as it stood alone and with the rounding floor of the
residual's evaluation added (``residual_floor`` there). Prints one JSON
line: the draws, the misses of each package under each bound, the draws
both miss, and the smallest reported residual of a miss.
A miss by the reference's LOBPCG on a draw means the check asks more than
the algorithm gives (the reported residual comes from the recurrence, not
a fresh apply; near rounding the two differ by more than 1 %). Not
collected by pytest.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def cases():
    spec = importlib.util.spec_from_file_location(
        "_spectral_cases", os.path.join(HERE, "test_torch_spectral_dtensor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(sd, A, theta, X, res, floor):
    """The columns that miss ‖A x − x θ‖ ≤ 1.01 res (+ the floor)."""
    theta, X, res = (np.asarray(a, dtype=np.float64) for a in (theta, X, res))
    bound = 1.01 * res + (sd.residual_floor(A, X, theta) if floor else 0.0)
    return np.linalg.norm(A @ X - X * theta, axis=0) > bound


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("draws", type=int)
    ap.add_argument("--kind", default="banded")
    a = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import linops_tpu as lo
    import linops_tpu_torch as lt

    sd = cases()
    A = sd.natural_matrix(a.kind)
    herm = dict(symmetric=True, hermitian=True)
    op_j = lo.MatrixOperator(jnp.asarray(A), **herm)
    op_t = lt.MatrixOperator(torch.from_numpy(A), **herm)
    out = {bound: {"reference": 0, "port": 0, "both": 0} for bound in ("1.01 res", "with floor")}
    smallest = None
    for i in range(a.draws):
        X0 = np.random.default_rng(i).standard_normal((A.shape[0], 2))
        th_j, X_j, res_j, _ = lo.lobpcg(op_j, k=2, X0=jnp.asarray(X0), maxiter=1000)
        th_t, X_t, res_t, _ = lt.lobpcg(op_t, k=2, X0=torch.from_numpy(X0), maxiter=1000)
        res_j, res_t = np.asarray(res_j), res_t.numpy()
        for bound, floor in (("1.01 res", False), ("with floor", True)):
            miss_j = check(sd, A, th_j, X_j, res_j, floor)
            miss_t = check(sd, A, th_t.numpy(), X_t.numpy(), res_t, floor)
            out[bound]["reference"] += bool(miss_j.any())
            out[bound]["port"] += bool(miss_t.any())
            out[bound]["both"] += bool(miss_j.any() and miss_t.any())
            for miss, r in ((miss_j, res_j), (miss_t, res_t)):
                if miss.any() and not floor:
                    m = float(r[miss].min())
                    smallest = m if smallest is None else min(smallest, m)
    print(json.dumps(dict(kind=a.kind, draws=a.draws, missed=out,
                          smallest_missed_residual=smallest)), flush=True)


if __name__ == "__main__":
    main()
