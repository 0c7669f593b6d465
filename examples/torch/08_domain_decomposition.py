"""2-D domain decomposition: a Poisson solve and eigenmodes across a mesh.

The PyTorch port of ``examples/08_domain_decomposition.py``: the (ny, nx)
grid tiles over a (gy, gx) mesh of ranks (``linops_tpu_torch.parallel``),
each apply moving only four one-cell edge strips between neighbours (four
exchange rounds, no all-gather: the collective count below is the
contract); CG and LOBPCG run over the decomposed operator. One process per
device: the reference's 4 x 2 mesh needs a world of 8 (``--device cpu``
starts a gloo world of 8 through ``parallel.launch``); on one card ``main()``
starts a world of one NCCL rank and tiles the grid over a 1 x 1 mesh.

Run: python examples/torch/08_domain_decomposition.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

ny, nx = 64, 32


def main(device=None):
    """Runs in every rank of a process group (one NCCL rank is started on
    the card when none is up); prints and returns rank 0's results. The mesh
    is the reference's 4 x 2 in a world of 8 or more, else world x 1."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import (P, NamedSharding, collective_counts,
                                           initialize_distributed, make_mesh2d,
                                           stencil_partition_2d)
    from linops_tpu_torch.parallel.comm import gather_full

    dev = default_device(device, "example 08")
    if not dist.is_initialized():
        initialize_distributed(backend="gloo" if dev.type == "cpu" else None)
    world = dist.get_world_size()
    lines = []

    def say(*args):
        lines.append(" ".join(str(a) for a in args))
        if dist.get_rank() == 0:
            print(lines[-1])

    shape = (4, 2) if world >= 8 else (world, 1)
    mesh = make_mesh2d(*shape, device=dev.type)
    L = stencil_partition_2d(torch.tensor([4.0, -1.0, -1.0, -1.0, -1.0], dtype=torch.float64),
                             ny, nx, mesh)
    say(L)
    blocked = NamedSharding(mesh, P(("gy", "gx")))  # each rank holds its tile's block

    # the apply's collective schedule is an explicit, testable contract
    ones = blocked.place(L.grid_to_vec(torch.ones((ny, nx), dtype=torch.float64, device=dev)))
    counts = collective_counts(lambda: L @ ones)
    say(f"collectives per apply: {counts.get('collective-permute', 0)} permutes, "
        f"{counts.get('all-gather', 0)} gathers")

    # Poisson problem: point source in grid space -> blocked vector layout
    F = torch.zeros((ny, nx), dtype=torch.float64, device=dev)
    F[ny // 2, nx // 2] = 1.0
    b = blocked.place(L.grid_to_vec(F))
    x, iters, res = lt.cg(L, b, tol=1e-10, maxiter=2000)
    U = L.vec_to_grid(x)
    say(f"poisson: {iters} CG iterations, residual {float(res):.2e}, "
        f"peak potential {float(torch.max(U)):.4f}")

    # lowest eigenmodes of the decomposed Laplacian vs the analytic spectrum
    theta, X, rnorm, it = lt.lobpcg(L, k=2, tol=1e-8, maxiter=800,
                                    generator=torch.Generator(device=dev).manual_seed(0))
    hy, hx = np.pi / (ny + 1), np.pi / (nx + 1)
    lam0 = 4 - 2 * np.cos(hy) - 2 * np.cos(hx)
    theta = gather_full(theta).cpu().numpy()
    say(f"ground modes: {theta} (analytic lambda_0 = {lam0:.6f}, {it} iterations)")
    return {"mesh": shape, "counts": dict(counts), "x": gather_full(x).cpu().numpy(),
            "U": U.cpu().numpy(), "iters": iters, "res": float(res), "theta": theta,
            "resnorms": gather_full(rnorm).cpu().numpy(), "lobpcg_iters": it, "lam0": lam0,
            "lines": lines}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args().device
    if device == "cpu":  # a gloo world of 8 processes: the reference's 4 x 2 mesh
        from linops_tpu_torch.parallel import launch

        print("\n".join(launch.run(os.path.abspath(__file__) + ":main", 8, args=("cpu",),
                                   backend="gloo")[0]["lines"]))
    else:
        main(device)
