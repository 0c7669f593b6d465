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
