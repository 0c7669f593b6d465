"""``dryrun_multichip``: one distributed step over an n-rank mesh, as
``__graft_entry__.py::dryrun_multichip`` runs it in the reference.

Shards a row-partitioned operator graph and an inverse L-BFGS state over
the mesh, runs one preconditioned CG-style step and an L-BFGS push on them
(the push against the unsharded one), a halo-exchange chain, a routed
operator and a permutation sandwiched into the sharded algebra, an RCM
sandwich, and a 2-D grid decomposition, auditing the collectives of the
halo applies. Its ranks are local processes (``launch.run``: gloo on the
CPU, NCCL on CUDA devices); a process already in a world of n ranks runs
its rank here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """Run the step on ``n_ranks`` ranks (CUDA devices and NCCL unless
    ``device="cpu"``: gloo). Returns rank 0's summary."""
    if dist.is_initialized() and dist.get_world_size() == n_ranks:
        return dryrun_rank(device)
    from .launch import run

    backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    return run("linops_tpu_torch.parallel.dryrun:dryrun_rank", n_ranks, args=(device,),
               backend=backend)[0]


def dryrun_rank(device=None) -> dict:
    """This rank's part of the step; every rank of the world calls it."""
    import scipy.sparse as sps

    import linops_tpu_torch as lt
    from ..qn.lbfgs import _push_common, inverse_apply
    from ..utils.krylov import matvec_chain
    from .comm import gather_full, plain_as_replicated
    from .halo import _mesh_device, banded_partition
    from .halo2d import make_mesh2d, stencil_partition_2d
    from .introspect import collective_counts
    from .mesh import NamedSharding, P, make_mesh, row_sharding
    from .sharded import shard_operator

    n_dev = dist.get_world_size()
    mesh = make_mesh(n_dev, device=device)
    dev = _mesh_device(mesh)
    place = row_sharding(mesh).place
    n = 16 * n_dev  # tiny but divisible
    f32 = torch.float32
    rng = np.random.default_rng(0)

    def up(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # row-partitioned dense operator composed with a dimension-split diagonal
    M = np.eye(n, dtype=np.float32) * 2.0 + 0.01 * rng.standard_normal((n, n)).astype(np.float32)
    M = (M + M.T) / 2
    A = lt.MatrixOperator(up(M), symmetric=True, hermitian=True)
    D = lt.opDiagonal(torch.linspace(1.0, 2.0, n, dtype=f32, device=dev))
    chain = lt.ShiftedOperator(A @ D.T @ D, 0.1)  # (A D² + σI), lazy graph
    chain_sh = shard_operator(chain, mesh)

    # distributed L-BFGS: memory split along the operator dimension
    H = lt.InverseLBFGSOperator(f32, n, mem=4, device=dev)
    for _ in range(4):
        s = rng.standard_normal(n).astype(np.float32)
        H.push(up(s), up(s + 0.1 * rng.standard_normal(n)))
    H_sh = shard_operator(H, mesh)

    def train_step(chain_op, H_state, x, b, s_new, y_new):
        # a distributed preconditioned CG-style step, then the state update
        with plain_as_replicated():
            r = b - chain_op.apply(x, "N")
            z = inverse_apply(H_state, r)
            denom = torch.vdot(z, chain_op.apply(z, "N"))
            alpha = torch.where(denom != 0, torch.vdot(r, z) / denom, torch.zeros_like(denom))
            H_new = _push_common(H_state, s_new, y_new, torch.vdot(y_new, s_new), scaling=True,
                                 inverse=True)
            return x + alpha * z, H_new

    x = place(torch.zeros(n, dtype=f32, device=dev))
    b = place(torch.ones(n, dtype=f32, device=dev))
    s_np = rng.standard_normal(n).astype(np.float32)
    y_np = s_np + 0.1 * rng.standard_normal(n).astype(np.float32)
    s_new, y_new = place(up(s_np)), place(up(y_np))
    step_counts = collective_counts(train_step, chain_sh, H_sh.state, x, b, s_new, y_new)
    x1, H1 = train_step(chain_sh, H_sh.state, x, b, s_new, y_new)
    x1 = gather_full(x1)
    assert torch.isfinite(x1).all(), "non-finite step"

    # the sharded push gives the unsharded push's state
    ref = _push_common(H.state, up(s_np), up(y_np), torch.vdot(up(y_np), up(s_np)), scaling=True,
                       inverse=True)
    for name, a, c in zip(ref._fields, ref, H1):
        np.testing.assert_allclose(gather_full(c).cpu().numpy(), a.cpu().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"sharded push diverged on {name}")

    # halo exchange: a banded operator driven by a matvec chain
    band = np.zeros((n, n), np.float32)
    for kd in range(-2, 3):
        band += np.diag(rng.standard_normal(n - abs(kd)).astype(np.float32), kd)
    halo_op = banded_partition(band, mesh)
    hx = gather_full(matvec_chain(halo_op, b, 5))
    got = gather_full(halo_op.matvec(b)).cpu().numpy()
    assert np.allclose(got, band @ np.ones(n, np.float32), atol=1e-4), "halo matvec mismatch"
    halo_counts = collective_counts(lambda: halo_op.apply(b, "N"))
    if n_dev > 1:
        assert halo_counts["collective-permute"] == 2, halo_counts
    assert halo_counts["all-gather"] == 0, halo_counts

    # a routed operator and a permutation inside the sharded algebra
    Asp = sps.random(n, n, density=min(0.5, 4.0 / n), format="csr", random_state=0)
    if Asp.nnz == 0:
        Asp = sps.csr_matrix(np.eye(n, dtype=np.float32))
    Asp.data[:] = rng.standard_normal(Asp.nnz)
    r_op = shard_operator(lt.opSparse(Asp.astype(np.float32), format="routed", device=dev), mesh)
    perm_op = shard_operator(lt.opPermutation(rng.permutation(n), device=dev), mesh)
    conj_chain = perm_op @ r_op @ perm_op.T + lt.opEye(n, dtype=f32)
    got_r = gather_full(conj_chain @ b).cpu().numpy()
    Pm = perm_op.perm.cpu().numpy()
    ref_r = Asp.toarray()[Pm][:, Pm] @ np.ones(n) + 1.0
    assert np.allclose(got_r, ref_r, atol=1e-4), "routed/permutation mismatch"

    # the RCM-reordered sandwich: the permutations replicate, the inner shards
    bd = sps.diags([np.ones(n - 1), 2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1], format="csr")
    sig = rng.permutation(n)
    scr = bd[sig][:, sig].tocsr().astype(np.float32)
    re_op = shard_operator(lt.opSparse(scr, format="auto", reorder="rcm", symmetric=True,
                                       device=dev), mesh)
    got_re = gather_full(re_op @ b).cpu().numpy()
    assert np.allclose(got_re, scr @ np.ones(n), atol=1e-4), "reordered mismatch"
    assert re_op.symmetric, "reordered flags lost under sharding"

    # 2-D grid decomposition: 4 exchange rounds, no gather, the stencil's values
    py2 = next(d for d in range(int(n_dev ** 0.5), 0, -1) if n_dev % d == 0)
    px2 = n_dev // py2
    mesh2 = make_mesh2d(py2, px2, device=device)
    ny2, nx2 = 8 * py2, 8 * px2
    L2 = stencil_partition_2d(torch.tensor([4.0, -1.0, -1.0, -1.0, -1.0], dtype=f32), ny2, nx2,
                              mesh2)
    U2 = np.random.default_rng(0).standard_normal((ny2, nx2)).astype(np.float32)
    v2 = NamedSharding(mesh2, P(tuple(mesh2.mesh_dim_names))).place(L2.grid_to_vec(up(U2)))
    y2 = L2.vec_to_grid(L2 @ v2).cpu().numpy()
    y2_ref = (lt.laplacian_2d(ny2, nx2, dtype=f32, device=dev) @ up(U2.reshape(-1)))
    assert np.allclose(y2, y2_ref.cpu().numpy().reshape(ny2, nx2), atol=1e-4), \
        "halo2d apply mismatch"
    h2_counts = collective_counts(lambda: L2 @ v2)
    h2_expected = 2 * int(py2 > 1) + 2 * int(px2 > 1)
    assert h2_counts["collective-permute"] == h2_expected, (h2_counts, h2_expected)
    assert h2_counts["all-gather"] == 0, h2_counts
    return {"ranks": n_dev, "x_norm": float(torch.linalg.vector_norm(x1)),
            "H_insert": int(gather_full(H1.insert)),
            "halo_chain_finite": bool(torch.isfinite(hx).all()),
            "halo_collectives_per_apply": halo_counts, "train_step_collectives": step_counts,
            "halo2d_mesh": [py2, px2], "halo2d_collectives_per_apply": h2_counts}
