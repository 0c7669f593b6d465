"""Count how often LOBPCG with no generator misses the checks of
``tests/test_torch_spectral_dtensor.py::test_default_generator_is_one_draw_for_every_rank``.

    python tests/torch_lobpcg_draws.py WORLDS DRAWS [--root TREE]

Each of WORLDS 4-rank gloo worlds makes DRAWS calls of that file's LOBPCG
routine, with no generator, on each of its distributed operators: every
call seeds itself from OS entropy (``utils/rng.py::fresh_generator``), so
each is a fresh draw. Each result is held to the test's checks (iterations,
residual against tol, ‖A X − X θ‖ within 1.01 times the reported residual,
θ within it of the true eigenvalues). ``--root`` names the tree whose
package and test file are loaded (default: this checkout), so two commits
can be compared. One JSON line per world: draws so far and misses per
operator and check. Not collected by pytest; it imports no jax.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def cases(root):
    spec = importlib.util.spec_from_file_location(
        "_spectral_cases", os.path.join(root, "tests", "test_torch_spectral_dtensor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def world(root, draws):
    """Run in each rank: ``draws`` LOBPCG calls per operator; rank 0
    returns the described results."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import make_mesh

    sd = cases(root)
    ops = sd.distributed_ops(make_mesh(dist.get_world_size(), device="cpu"))
    call = sd.routines()["lobpcg"]
    out = [{kind: sd.describe(call(op, None), lay) for kind, (op, _, lay, _) in ops.items()}
           for _ in range(draws)]
    return out if dist.get_rank() == 0 else None


def misses(sd, kind, got):
    """The test's checks that this draw misses."""
    A, lam = sd.truth(kind)
    theta, X, res, it = sd.values_of(got)
    checks = {"iterations": it < sd.MAXITER,
              "tol": np.all(res <= 1e-6 * np.maximum(np.abs(theta), 1.0)),
              "residual": np.all(np.linalg.norm(A @ X - X * theta, axis=0) <= 1.01 * res),
              "theta": np.all(np.abs(theta - lam[:2]) <= res)}
    return [name for name, ok in checks.items() if not ok]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("worlds", type=int)
    ap.add_argument("draws", type=int)
    ap.add_argument("--root", default=os.path.dirname(HERE))
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from linops_tpu_torch.parallel import launch

    sd = cases(root)
    total, missed = 0, {}
    for _ in range(a.worlds):
        for draw in launch.run(os.path.abspath(__file__) + ":world", 4, args=(root, a.draws),
                               backend="gloo", timeout=1800)[0]:
            total += 1
            for kind, got in draw.items():
                for check in misses(sd, kind, got):
                    key = f"{kind} {check}"
                    missed[key] = missed.get(key, 0) + 1
        print(json.dumps(dict(root=root, draws=total, missed=missed)), flush=True)


if __name__ == "__main__":
    main()
