"""Sparse operators and sharding over a device mesh.

The PyTorch port of ``examples/03_sparse_and_sharded.py``: one random
sparse matrix as CSR and as 8x128 BSR, the spectral norm by power iteration
on BᵀB, then ``linops_tpu_torch.parallel``: an operator graph row-sharded
over a 1-D mesh with a matvec chain on it, and a banded operator with
explicit halo exchanges. One process per device: on the card a world of
one NCCL rank (``main()`` starts it), on the CPU a gloo world of several
processes (``--device cpu`` starts 8 through ``parallel.launch``).

Run: python examples/torch/03_sparse_and_sharded.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

n = 1024


def main(device=None):
    """Runs in every rank of a process group (one NCCL rank is started on
    the card when none is up); prints and returns rank 0's results."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import (banded_partition, initialize_distributed,
                                           make_mesh, row_sharding, shard_operator)
    from linops_tpu_torch.parallel.comm import gather_full

    dev = default_device(device, "example 03")
    if not dist.is_initialized():
        initialize_distributed(backend="gloo" if dev.type == "cpu" else None)
    lines = []

    def say(*args):
        lines.append(" ".join(str(a) for a in args))
        if dist.get_rank() == 0:
            print(lines[-1])

    rng = np.random.default_rng(2)
    # --- sparse formats -------------------------------------------------------
    A = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02)).astype(np.float32)
    S_csr = lt.opSparse(A, format="csr", device=dev)
    S_bsr = lt.opSparse(A, format="bsr", device=dev)  # 8x128 blocks
    v = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    y = S_csr * v
    rel = float(torch.linalg.vector_norm(y - S_bsr * v) / torch.linalg.vector_norm(y))
    say("csr nnz:", S_csr.nnz, " rel err csr vs bsr:", rel)

    # spectral norm of the sparse operator, on the device
    lam, _ = lt.power_iteration(S_bsr.T @ S_bsr, v, iters=100)
    norm2 = float(torch.sqrt(lam.real))
    say("||A||_2 ~", norm2, " vs dense:", float(np.linalg.norm(A, 2)))

    # --- sharding over a device mesh ------------------------------------------
    world = dist.get_world_size()
    mesh = make_mesh(min(world, 8), device=dev.type)
    # any operator graph row-partitions generically
    chain = 2.0 * (lt.LinearOperator(torch.as_tensor(A, device=dev))
                   @ lt.opDiagonal(torch.abs(v) + 1))
    chain_sh = shard_operator(chain, mesh)
    vs = row_sharding(mesh).place(v)
    out = gather_full(lt.matvec_chain(chain_sh, vs, 50))
    say("sharded chain finite:", bool(torch.isfinite(out).all()))

    # banded operators use explicit halo exchange (point-to-point sends)
    band = np.zeros((n, n), np.float32)
    for k in range(-3, 4):
        band += np.diag(rng.standard_normal(n - abs(k)).astype(np.float32), k)
    op = banded_partition(band, mesh)
    yb = gather_full(op * vs).cpu().numpy()
    ref = band @ v.cpu().numpy()
    halo_err = float(np.linalg.norm(yb - ref) / np.linalg.norm(ref))
    say("halo matvec rel err:", halo_err)
    return {"nnz": int(S_csr.nnz), "rel": rel, "norm2": norm2, "chain": out.cpu().numpy(),
            "halo_err": halo_err, "world": world, "lines": lines}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args().device
    if device == "cpu":  # a gloo world of 8 processes
        from linops_tpu_torch.parallel import launch

        print("\n".join(launch.run(os.path.abspath(__file__) + ":main", 8, args=("cpu",),
                                   backend="gloo")[0]["lines"]))
    else:
        main(device)
