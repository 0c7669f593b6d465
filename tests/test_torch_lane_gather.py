"""The plain versions of the lane-gather kernels K7-K12
(``linops_tpu_torch/kernels/lane_gather.py``) against the reference's Pallas
kernels run in interpret mode, on the CPU.

Shapes take the reference's ``pallas_call`` branch: R0 a multiple of 128
rows, 128 lanes, w in {1, 8, 32}; rep 1 and 3; f32 and bf16 data (bf16
crosses between the packages as f32, which is exact). Tolerances:

- gathers and products (K7, K8, K9): equal. A bf16·bf16 product is exact in
  f32, so one rounding in either package gives the same bf16.
- lane-group sums (K10): max|Δ| ≤ 1e-6·max|y| in f32; in bf16 the reference
  accumulates in bf16 while the port rounds an f32 sum once, so ≤ 2^-6·max|y|.
- segment sums (K11, K12): the reference takes a prefix difference, so its
  error is about eps·Σ|window| (``lane_gather.py:197-202`` of the
  reference) with eps that of its working type; the limit is
  8·eps_f32·Σ|window| per element, and in bf16, where the reference's
  prefix is bf16, eps_bf16·Σ|window| more plus one bf16 rounding of the
  result.
- the tiled combine (K13): the CUDA kernel's order (each row's slots added
  one after another in slot order, from zero, in f32) walked on the CPU: in
  f64 within 1e-12 of the plain version, in f32 within 4·eps_f32·Σ|q| per
  row of the reference (plus one bf16 rounding of a bf16 result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linops_tpu.kernels import lane_gather as JL
from linops_tpu_torch.kernels import lane_gather as LG

R0 = 256


def data(rng, rows, dtype):
    """(numpy f32 values exactly representable in ``dtype``, jax array,
    torch tensor)."""
    x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    if dtype == "bf16":
        x = x.to(torch.bfloat16)
        host = x.float().numpy()
        return host, jnp.asarray(host, jnp.bfloat16), x
    return x.numpy(), jnp.asarray(x.numpy()), x


def bounds(rng, r0):
    """Per-window contiguous segment boundaries as the pack makes them:
    runs of lanes, some output lanes empty (−1)."""
    lo = np.full((r0, 128), -1, np.int8)
    hi = np.full((r0, 128), -1, np.int8)
    for i in range(r0):
        cuts = np.sort(rng.choice(np.arange(1, 128), 24, replace=False))
        starts, ends = np.r_[0, cuts], np.r_[cuts, 128] - 1
        keep = rng.random(starts.shape[0]) < 0.8
        outs = np.sort(rng.choice(128, int(keep.sum()), replace=False))
        hi[i, outs] = ends[keep]
        lo[i, outs] = starts[keep] - 1
    return lo, hi


def as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().astype(np.float64)


def jnp_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


CASES = [(rep, dt) for rep in (1, 3) for dt in ("f32", "bf16")]


@pytest.mark.parametrize("rep,dt", CASES)
def test_gathers_and_products_equal_the_reference(rep, dt):
    rng = np.random.default_rng(rep)
    _, aj, at = data(rng, rep * R0, dt)
    _, vj, vt = data(rng, R0, dt)
    idx = rng.integers(0, 128, (R0, 128)).astype(np.int8)
    ij, it = jnp.asarray(idx), torch.from_numpy(idx)
    got = LG.lane_gather(at, it, rep=rep)
    assert got.dtype == at.dtype
    np.testing.assert_array_equal(as_np(got), jnp_np(JL.lane_gather(aj, ij, rep=rep,
                                                                    interpret=True)))
    np.testing.assert_array_equal(as_np(LG.lane_gather_mul(at, it, vt, rep=rep)),
                                  jnp_np(JL.lane_gather_mul(aj, ij, vj, rep=rep, interpret=True)))
    C, m = 2, R0 // 2
    got = LG.lane_gather_mul_t_batched(at, it, vt, C, m, rep=rep)
    assert tuple(got.shape) == (rep * C * 128, m)
    np.testing.assert_array_equal(
        as_np(got), jnp_np(JL.lane_gather_mul_t_batched(aj, ij, vj, C=C, m=m, rep=rep,
                                                         interpret=True)))


@pytest.mark.parametrize("rep,dt", CASES)
@pytest.mark.parametrize("w", [1, 8, 32])
def test_lane_gather_sum_matches_the_reference(rep, dt, w):
    rng = np.random.default_rng(10 * w + rep)
    _, aj, at = data(rng, rep * R0, dt)
    idx = rng.integers(0, 128, (R0, 128)).astype(np.int8)
    got = LG.lane_gather_sum(at, torch.from_numpy(idx), w, rep=rep)
    ref = jnp_np(JL.lane_gather_sum(aj, jnp.asarray(idx), w, rep=rep, interpret=True))
    assert tuple(got.shape) == (rep * R0, 128 // w) and got.dtype == at.dtype
    tol = 1e-6 if dt == "f32" else 2.0 ** -6
    assert np.abs(as_np(got) - ref).max() <= tol * np.abs(ref).max()


def segsum_limit(z, rep, ref, dt):
    win = np.abs(z).reshape(rep, R0, 128).sum(axis=2, keepdims=True)
    limit = 8 * np.finfo(np.float32).eps * np.broadcast_to(win, (rep, R0, 128))
    limit = limit.reshape(rep * R0, 128)
    if dt == "bf16":
        eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
        limit = (limit + eps_bf16 * np.broadcast_to(win, (rep, R0, 128)).reshape(rep * R0, 128)
                 + 2.0 ** -8 * np.abs(ref))
    return limit


@pytest.mark.parametrize("rep,dt", CASES)
def test_segment_sums_match_the_reference(rep, dt):
    rng = np.random.default_rng(20 + rep)
    qh, qj, qt = data(rng, rep * R0, dt)
    vh, vj, vt = data(rng, R0, dt)
    lo, hi = bounds(rng, R0)
    idx = rng.integers(0, 128, (R0, 128)).astype(np.int8)
    loj, hij, ij = jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(idx)
    lot, hit, it = torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(idx)

    got = as_np(LG.lane_segsum(qt, lot, hit, rep=rep))
    ref = jnp_np(JL.lane_segsum(qj, loj, hij, rep=rep, interpret=True))
    assert (np.abs(got - ref) <= segsum_limit(qh, rep, ref, dt)).all()

    got = as_np(LG.lane_gather_mul_segsum(qt, it, vt, lot, hit, rep=rep))
    ref = jnp_np(JL.lane_gather_mul_segsum(qj, ij, vj, loj, hij, rep=rep, interpret=True))
    z = np.take_along_axis(qh.reshape(rep, R0, 128), idx.astype(np.int64)[None], axis=2)
    z = (z * vh[None]).reshape(rep * R0, 128)
    assert (np.abs(got - ref) <= segsum_limit(z, rep, ref, dt)).all()


def test_plain_versions_take_any_width_and_dtype():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2 * 5, 64)) + 1j * rng.standard_normal((10, 64)))
    idx = torch.from_numpy(rng.integers(0, 64, (5, 64)).astype(np.int8))
    got = LG.lane_gather(a, idx, rep=2)
    want = np.take_along_axis(a.numpy().reshape(2, 5, 64), idx.numpy().astype(np.int64)[None], 2)
    assert np.array_equal(got.numpy(), want.reshape(10, 64))
    assert LG.lane_gather_sum(a.real.contiguous(), idx, 4, rep=2).shape == (10, 16)
    assert LG.launch_counts() == dict.fromkeys(LG.launch_counts(), 0)  # CPU: no kernel


def test_wrappers_check_their_arguments():
    a = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="power of two"):
        LG.lane_gather_sum(a, torch.zeros(128, 128, dtype=torch.int8), 3)
    with pytest.raises(ValueError, match="no kernel for device"):
        LG.lane_gather(a.to("meta"), torch.zeros(128, 128, dtype=torch.int8, device="meta"))


def tiled_case(rng, T, K, rep, dt):
    """q (rep·T·K,) and a rowid (T, K) in any order within a tile, with
    trash slots (−1): rows drawn at random, a third of the slots trash."""
    rowid = rng.integers(0, 128, (T, K)).astype(np.int8)
    rowid[rng.random((T, K)) < 1 / 3] = -1
    qh, qj, qt = data(rng, rep * T * K // 128, dt)
    return rowid, qh.reshape(-1), qj.reshape(-1), qt.reshape(-1)


@pytest.mark.parametrize("T", [8, 16])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tiled_combine_matches_the_reference(T, dt):
    """K13's plain version against the reference's one-hot kernel in
    interpret mode: per row, |Δ| ≤ 4·eps_f32·Σ|q| over the row's slots. In
    bf16 the reference sums in bf16, so the port (an f32 sum rounded once)
    is held against the reference run on the same values in f32, plus one
    bf16 rounding of the result."""
    rng = np.random.default_rng(T)
    K = 384
    rowid, qh, qj, qt = tiled_case(rng, T, K, 1, dt)
    got = LG.tiled_combine(qt, torch.from_numpy(rowid))
    assert got.dtype == qt.dtype and tuple(got.shape) == (T * 128,)
    ref = jnp_np(JL.tiled_combine(jnp.asarray(qh), jnp.asarray(rowid), interpret=True))
    absq = np.zeros(T * 128)
    rid = rowid.astype(np.int64)
    keep = rid >= 0
    np.add.at(absq, (np.arange(T)[:, None] * 128 + rid)[keep], np.abs(qh.reshape(T, K))[keep])
    limit = 4 * np.finfo(np.float32).eps * absq
    if dt == "bf16":
        limit = limit + 2.0 ** -8 * np.abs(ref)
    assert (np.abs(as_np(got) - ref) <= limit).all()
    # the same sums, repeated: rep = 3 over one shared rowid
    rowid, qh, _, qt = tiled_case(rng, T, K, 3, dt)
    got = LG.tiled_combine(qt, torch.from_numpy(rowid), rep=3)
    for j in range(3):
        ref = jnp_np(JL.tiled_combine(jnp.asarray(qh[j * T * K:(j + 1) * T * K]),
                                      jnp.asarray(rowid), interpret=True))
        part = as_np(got[j * T * 128:(j + 1) * T * 128])
        assert np.abs(part - ref).max() <= 4 * np.finfo(np.float32).eps * (
            np.abs(qh).max() * K) + (2.0 ** -8 * np.abs(ref).max() if dt == "bf16" else 0)


def walk_rows(q, rowid, rep, dtype):
    """K13's order: each row's slots added one after another in slot order,
    from zero, in ``dtype``; q (rep·T·K,) -> (rep·T·128,)."""
    T, K = rowid.shape
    q = q.reshape(rep, T, K).to(dtype)
    out = torch.zeros((rep, T, 128), dtype=dtype)
    rid = rowid.long()
    for k in range(K):  # slot order; one slot per tile at a time
        t = torch.nonzero(rid[:, k] >= 0).reshape(-1)
        out[:, t, rid[t, k]] += q[:, t, k]
    return out.reshape(-1)


def mixed_rowid(rng, T, K):
    """Tiles of every kind K13 must take: all trash; one row holding the
    whole tile; runs as the pack makes them (rows in order, trash last);
    shuffled rows with a third of the slots trash."""
    rowid = np.full((T, K), -1, np.int8)
    rowid[1] = 77
    for t in range(2, T):
        rows = np.sort(rng.integers(0, 128, K - K // 4)).astype(np.int8)
        rowid[t, :rows.size] = rows
        if t >= T // 2:
            rowid[t] = rng.permutation(rowid[t])
            rowid[t, rng.random(K) < 1 / 3] = -1
    return rowid


@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tiled_combine_order_walk(rep, dt):
    """K13's summation order, walked on the CPU, against the plain version
    (f64, 1e-12) and the reference's one-hot kernel in interpret mode (f32
    sums, the limits of ``test_tiled_combine_matches_the_reference``)."""
    rng = np.random.default_rng(rep)
    T, K = 8, 384
    rowid = mixed_rowid(rng, T, K)
    qh, _, qt = data(rng, rep * T * K // 128, dt)
    qh, qt = qh.reshape(-1), qt.reshape(-1)
    rt = torch.from_numpy(rowid)
    walked64 = walk_rows(qt, rt, rep, torch.float64)
    plain64 = LG.tiled_combine_plain(qt.double(), rt, rep)
    assert float((walked64 - plain64).abs().max()) <= 1e-12 * float(plain64.abs().max())
    assert torch.count_nonzero(walked64.reshape(rep, T, 128)[:, 0]) == 0  # the all-trash tile
    walked = walk_rows(qt, rt, rep, torch.float32).to(qt.dtype)  # rounded once, as K13
    for j in range(rep):
        qj = qh[j * T * K:(j + 1) * T * K]
        ref = jnp_np(JL.tiled_combine(jnp.asarray(qj), jnp.asarray(rowid), interpret=True))
        absq = np.zeros(T * 128)
        rid = rowid.astype(np.int64)
        keep = rid >= 0
        np.add.at(absq, (np.arange(T)[:, None] * 128 + rid)[keep], np.abs(qj.reshape(T, K))[keep])
        limit = 4 * np.finfo(np.float32).eps * absq
        if dt == "bf16":
            limit = limit + 2.0 ** -8 * np.abs(ref)
        assert (np.abs(as_np(walked[j * T * 128:(j + 1) * T * 128]) - ref) <= limit).all()


@pytest.mark.parametrize("m", [128, 256, 384])
def test_lane_gather_mul_t_matches_the_reference_exactly(m):
    """K14's plain version equals the reference kernel bit for bit in f32."""
    rng = np.random.default_rng(m)
    xh, xj, xt = data(rng, m, "f32")
    vh, vj, vt = data(rng, m, "f32")
    idx = rng.integers(0, 128, (m, 128)).astype(np.int8)
    got = LG.lane_gather_mul_t(xt, torch.from_numpy(idx), vt)
    assert tuple(got.shape) == (128, m) and got.is_contiguous()
    ref = np.asarray(JL.lane_gather_mul_t(xj, jnp.asarray(idx), vj, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    # and it is K9 for one chunk and one repeat
    assert torch.equal(got, LG.lane_gather_mul_t_batched(xt, torch.from_numpy(idx), vt, 1, m))
