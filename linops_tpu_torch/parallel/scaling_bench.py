"""Multi-device scaling harness (counterpart of
``linops_tpu/parallel/scaling_bench.py``).

Runs the distributed matvec chains on the current process group's mesh
against the same per-device work on one device:

- **halo**: ``banded_partition`` (``halo.py``), WEAK scaling: the slab size
  m per device stays fixed while n = m·P grows. Asserts exactly 2
  ``collective-permute`` rounds and no all-gather per apply (P > 1).
- **halo2d**: ``stencil_partition_2d`` on the squarest (py, px) mesh, weak
  scaling at a fixed 512² tile: 4 rounds (2 per axis longer than one).
- **gspmd**: a row-split dense operator through ``shard_operator``, STRONG
  scaling at fixed n.

The one-device baseline is the same work on this rank's device with no
exchange (the interior product; the tile's centre and in-tile terms; the
unsharded dense operator). Times are marginal seconds per apply
(``utils/timing.py``: CUDA events on a card), each rank timing itself;
the report is this rank's. Efficiency is FLOP-normalized per-device
throughput against the one-device run (ideal 1.0).

``ici_projection`` projects efficiency at production sizes from the
portable quantities (collective counts, per-device bytes) and a device's
memory rate, link rate and link latency, passed in; the reference's
constants were a TPU's and are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import marginal_chain_time as _chain_time

__all__ = ["scaling_report", "ici_projection"]

# The H100 SXM's memory streaming ceiling in bytes/s, as measured by
# chip_smoke.py phase 13g (a 1 GiB device-to-device copy: 2 bytes moved per
# byte copied) on an NVIDIA H100 80GB HBM3 at 700 W.
H100_HBM_BPS = 3.02e12
# NVLink 4 on the H100 SXM: 900 GB/s of bidirectional bandwidth per GPU
# (NVIDIA H100 Tensor Core GPU datasheet), 450 GB/s each way.
H100_NVLINK_BPS = 450e9
# NVIDIA publishes no NVLink latency figure; 2 µs per exchange round is an
# assumption of the order NCCL point-to-point transfers take between two
# GPUs. Pass a measured latency where one exists.
H100_LINK_LATENCY_S = 2e-6


def _banded(n, band, rng, dtype):
    A = np.zeros((n, n), dtype)
    for kd in range(-band, band + 1):
        A += np.diag(rng.standard_normal(n - abs(kd)).astype(dtype), kd)
    return A


def scaling_report(n_devices: int = None, m_per_dev: int = 2048, band: int = 3) -> dict:
    """Measure the distributed chains and audit their collectives on this
    rank; returns the report dict. ``n_devices`` must be the process
    group's size (default)."""
    import torch.distributed as dist

    from ..core.dense import MatrixOperator
    from ..utils.krylov import matvec_chain
    from .comm import from_local
    from .halo import _mesh_device, banded_partition
    from .halo2d import make_mesh2d, stencil_partition_2d
    from .introspect import collective_counts
    from .mesh import make_mesh, row_sharding
    from .sharded import shard_operator

    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"scaling_report runs on the whole world ({world} ranks)")
    mesh = make_mesh(n_devices, device="cpu" if dist.get_backend() == "gloo" else None)
    dev = _mesh_device(mesh)
    rng = np.random.default_rng(0)
    dtype = np.float32
    report = {"n_devices": n_devices, "m_per_dev": m_per_dev, "band": band}

    def run(op, v, iters):
        return matvec_chain(op, v, iters)

    def timed(op, v):
        return _chain_time(run, op, v, device=dev)

    def up(a):
        return torch.from_numpy(a).to(dev)

    # --- halo path: WEAK scaling (m fixed per device) ----------------------
    n = m_per_dev * n_devices
    A = _banded(n, band, rng, dtype)
    op = banded_partition(A, mesh)
    v = row_sharding(mesh).place(up(rng.standard_normal(n).astype(dtype)))
    A1 = A[:m_per_dev, :m_per_dev]
    t1 = timed(MatrixOperator(up(A1)), up(rng.standard_normal(m_per_dev).astype(dtype)))
    tn = timed(op, v)
    h = op.halo
    report["halo_us_per_apply_1dev"] = t1 * 1e6
    report["halo_us_per_apply_ndev"] = tn * 1e6
    counts = collective_counts(lambda: op.apply(v, "N"))
    report["halo_collectives_per_apply"] = counts
    if n_devices > 1:  # one device exchanges nothing
        assert counts["collective-permute"] == 2, counts
        assert counts["all-gather"] == 0, counts
    flops_1 = 2 * m_per_dev * m_per_dev
    flops_n = 2 * (m_per_dev * m_per_dev + (2 * m_per_dev * h if n_devices > 1 else 0))
    report["halo_weak_scaling_efficiency"] = (flops_n / tn) / (flops_1 / t1)

    # --- halo2d grid decomposition: WEAK scaling (tile fixed) --------------
    py = next(d for d in range(int(n_devices ** 0.5), 0, -1) if n_devices % d == 0)
    px = n_devices // py
    tile = 512  # the reference's per-device tile side
    mesh2 = make_mesh2d(py, px, device="cpu" if dev.type == "cpu" else None)
    lap = np.asarray([4.0, -1.0, -1.0, -1.0, -1.0], dtype)
    L2 = stencil_partition_2d(up(lap), tile * py, tile * px, mesh2)
    from torch.distributed.tensor import Shard

    w2 = from_local(up(rng.standard_normal(tile * tile).astype(dtype)), mesh2,
                    [Shard(0), Shard(0)], (L2.nrow,))
    u1 = up(rng.standard_normal((tile, tile)).astype(dtype))
    c = up(lap)

    def tile_apply(_, u, iters):  # one device's tile with Dirichlet zeros around it
        for _ in range(iters):
            z = torch.zeros_like(u[:1])
            y = c[0] * u + c[1] * torch.cat([z, u[:-1]]) + c[2] * torch.cat([u[1:], z])
            zc = torch.zeros_like(u[:, :1])
            y = y + c[3] * torch.cat([zc, u[:, :-1]], 1) + c[4] * torch.cat([u[:, 1:], zc], 1)
            u = y / torch.linalg.vector_norm(y)
        return u

    t1 = _chain_time(tile_apply, None, u1, device=dev)
    tn = timed(L2, w2)
    report["halo2d_us_per_apply_1dev"] = t1 * 1e6
    report["halo2d_us_per_apply_ndev"] = tn * 1e6
    counts = collective_counts(lambda: L2.apply(w2, "N"))
    report["halo2d_mesh"] = [py, px]
    report["halo2d_collectives_per_apply"] = counts
    expected = 2 * int(py > 1) + 2 * int(px > 1)
    if expected:  # a one-wide axis exchanges nothing
        assert counts["collective-permute"] == expected, counts
        assert counts["all-gather"] == 0, counts
    report["halo2d_weak_scaling_efficiency"] = t1 / tn

    # --- row-split dense operator: STRONG scaling (n fixed) ----------------
    A = _banded(n, band, rng, dtype)
    x = rng.standard_normal(n).astype(dtype)
    t1 = timed(MatrixOperator(up(A)), up(x))
    op = shard_operator(MatrixOperator(up(A)), mesh)
    vx = row_sharding(mesh).place(up(x))
    tn = timed(op, vx)
    report["gspmd_us_per_apply_1dev"] = t1 * 1e6
    report["gspmd_us_per_apply_ndev"] = tn * 1e6
    report["gspmd_collectives_per_apply"] = collective_counts(lambda: op.apply(vx, "N"))
    report["gspmd_strong_scaling_efficiency"] = t1 / (n_devices * tn)
    report["platform"] = "gpu" if dev.type == "cuda" else "cpu"
    return report


def ici_projection(n_devices: int = 8, m_per_dev: int = 2048, band: int = 3,
                   tile2d: int = 2048, n_strong: int = 65536, *,
                   hbm_bps: float = H100_HBM_BPS, link_bps: float = H100_NVLINK_BPS,
                   link_latency_s: float = H100_LINK_LATENCY_S) -> dict:
    """Project multi-device scaling efficiency from the collective counts
    the harness asserts and per-device byte volumes, with a device's memory
    rate ``hbm_bps``, per-direction link rate ``link_bps`` and per-round
    latency ``link_latency_s`` (defaults: the H100 SXM figures above). The
    reference's model:

    - halo (1-D banded, weak): per apply each device streams its
      (m, 2·band+1) slab once and exchanges 2 rounds of band·4 B;
    - halo2d (5-point stencil, weak): about 7·tile²·4 B of streams against
      4 edge rounds of tile·4 B;
    - row-split dense (strong): (n²/P)·4 B of matrix traffic against a ring
      all-gather of (P−1)/P · n·4 B over the slowest link.
    """
    out = {"model": "per-device memory-bound compute vs link transfers; counts audited "
                    "by the harness",
           "link_bw_gbps": link_bps / 1e9, "link_lat_us": link_latency_s * 1e6,
           "hbm_bw_gbps": hbm_bps / 1e9}
    P = max(int(n_devices), 2)
    b = 4  # f32

    def halo_eff(m):
        compute = m * (2 * band + 1 + 2) * b / hbm_bps
        comm = 2 * max(band * b / link_bps, link_latency_s)
        return compute / (compute + comm)

    out["halo_weak_harness_m%d" % m_per_dev] = halo_eff(m_per_dev)
    out["halo_weak_m1e6"] = halo_eff(1_000_000)
    comm = 2 * link_latency_s
    out["halo_weak_rows_per_dev_for_75pct"] = int(3 * comm * hbm_bps / ((2 * band + 3) * b))

    compute = 7 * tile2d * tile2d * b / hbm_bps
    comm = 4 * max(tile2d * b / link_bps, link_latency_s)
    out["halo2d_weak"] = compute / (compute + comm)

    compute = (n_strong * n_strong // P) * b / hbm_bps
    gather = (P - 1) / P * n_strong * b / link_bps + (P - 1) * link_latency_s
    out["gspmd_strong"] = compute / (compute + gather)

    out["meets_baseline_75pct_at_production_sizes"] = bool(
        out["halo_weak_m1e6"] >= 0.75 and out["halo2d_weak"] >= 0.75
        and out["gspmd_strong"] >= 0.75)
    return out
