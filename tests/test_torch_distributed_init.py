"""Multi-process bring-up of the port's distributed layer
(``linops_tpu_torch/parallel/init.py``), mirroring
``tests/test_distributed_init.py``: two real OS processes joined over a
localhost coordinator (gloo), ``initialize_distributed`` called twice in
each (idempotent), ``runtime_info``, a mesh over both processes, one sharded
operator apply checked by each rank on its own shard, and one cross-process
collective. Then ``dryrun_multichip`` launching its own two ranks.
"""

import os

import numpy as np

import torch


def bring_up_rank():
    """Each rank (joined by the launcher through ``initialize_distributed``):
    a second initialization is a no-op; the apply and the collective span
    both processes."""
    import torch.distributed as dist

    from linops_tpu_torch import opDiagonal
    from linops_tpu_torch.parallel import (initialize_distributed, make_mesh, row_sharding,
                                           runtime_info, shard_operator)

    initialize_distributed(None, dist.get_world_size(), dist.get_rank(), backend="gloo")
    info = runtime_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == info["process_count"] * info["local_devices"], info
    ndev = info["global_devices"]
    n = 16 * ndev
    mesh = make_mesh(device="cpu")
    dh = (np.arange(n, dtype=np.float32) % 7.0) + 1.0
    xh = np.linspace(0.5, 1.5, n, dtype=np.float32)
    sh = row_sharding(mesh)
    op = shard_operator(opDiagonal(torch.from_numpy(dh)), mesh)
    y = op @ sh.place(torch.from_numpy(xh))
    # every rank checks its own shard against the oracle
    r = dist.get_rank()
    m = n // ndev
    np.testing.assert_allclose(y.to_local().numpy(), (dh * xh)[r * m:(r + 1) * m], rtol=1e-6)
    # one cross-process collective: the sum over both ranks' pieces
    g = float(sh.place(torch.from_numpy(xh)).sum().full_tensor())
    np.testing.assert_allclose(g, float(xh.sum()), rtol=1e-5)
    return dict(info=info, rank=r)


def test_two_process_bringup():
    from linops_tpu_torch.parallel import launch

    results = launch.run(os.path.abspath(__file__) + ":bring_up_rank", 2, backend="gloo",
                         timeout=300)
    assert [res["rank"] for res in results] == [0, 1]
    assert all(res["info"]["platform"] == "cpu" for res in results)


def test_dryrun_multichip_launches_its_ranks():
    """The port's ``dryrun_multichip`` from a process outside any world: it
    starts two gloo ranks and returns rank 0's summary."""
    from linops_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and np.isfinite(out["x_norm"])
    assert out["halo_collectives_per_apply"]["collective-permute"] == 2
    assert out["halo_collectives_per_apply"]["all-gather"] == 0
    assert out["halo2d_mesh"] == [1, 2]
    assert out["halo2d_collectives_per_apply"]["collective-permute"] == 2
