"""E2's plain version (``linops_tpu_torch/kernels/small_lstsq.py``,
``small_lstsq_plain``) against the reference's call, ``jnp.linalg.lstsq``
at its default cutoff, on the CPU, on inputs made with numpy from a seed:

- random (m + 1) x m upper Hessenbergs (GMRES's H) and β e₁, in f32, f64,
  c64 and c128 for m in {1, 2, 8, 30}, batched (the plain version takes a
  batch as the kernel does);
- the Hessenbergs of a lucky breakdown (the columns past step j exactly
  zero), whose entries of y past j are exactly 0 in both;
- the zero matrix, whose y is 0 in both (a zero singular value is dropped,
  never inverted).

Tolerances: ‖Δy‖ ≤ 1e-10·‖y‖ in f64 and c128; in f32 and c64 the two SVDs
(LAPACK through torch, and XLA's) round differently, so y may move by its
condition: ‖Δy‖ ≤ 50·eps_f32·κ·‖y‖, κ = σ_max/σ_min over the kept singular
values, and the residual ‖H y − b‖ within 50·eps_f32·‖b‖ of the
reference's. The singular values within 50·eps·σ_max. The wrapper takes
the plain version for CPU tensors (no launch) and under ``torch.func.vmap``;
the kernel itself runs in ``tests/test_torch_e2_emulation.py`` and, on a
card, ``tests/test_torch_gpu.py``."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linops_tpu_torch.kernels import small_lstsq as E2
from linops_tpu_torch.utils import loop

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def hessenberg(rng, m, dtype, batch=3):
    H = np.triu(rng.standard_normal((batch, m + 1, m)), -1)
    if np.issubdtype(dtype, np.complexfloating):
        H = H + 1j * np.triu(rng.standard_normal((batch, m + 1, m)), -1)
    b = np.zeros((batch, m + 1))
    b[:, 0] = rng.random(batch) + 0.5
    return H.astype(dtype), b.astype(dtype)


def reference(a, b):
    """``jnp.linalg.lstsq``'s (y, σ) for each matrix of the batch."""
    return [tuple(np.asarray(t) for t in jnp.linalg.lstsq(jnp.asarray(ai), jnp.asarray(bi))[::3])
            for ai, bi in zip(a, b)]


def check(a, b, y, s):
    eps = np.finfo(a.real.dtype).eps
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    for ai, bi, yi, si, (y_ref, s_ref) in zip(a, b, y.numpy(), s.numpy(), reference(a, b)):
        assert yi.dtype == a.dtype and si.dtype == a.real.dtype
        np.testing.assert_allclose(si, s_ref, rtol=0, atol=50 * eps * max(s_ref[0], 1e-300))
        ny = max(np.linalg.norm(y_ref), 1e-300)
        if eps < 1e-10:
            assert np.linalg.norm(yi - y_ref) <= 1e-10 * ny
            continue
        kept = s_ref[(s_ref > 0) & (s_ref >= eps * max(ai.shape) * s_ref[0])]
        kappa = kept[0] / kept[-1] if kept.size else 1.0
        assert np.linalg.norm(yi - y_ref) <= 50 * eps * kappa * ny
        res = np.linalg.norm(ai.astype(wide) @ yi.astype(wide) - bi.astype(wide))
        res_ref = np.linalg.norm(ai.astype(wide) @ y_ref.astype(wide) - bi.astype(wide))
        assert res <= res_ref + 50 * eps * max(np.linalg.norm(bi), 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 8, 30])
def test_plain_version_matches_jnp_lstsq(rng, dtype, m):
    a, b = hessenberg(rng, m, dtype)
    y, s, sweeps = E2.small_lstsq_plain(torch.from_numpy(a), torch.from_numpy(b), full=True)
    assert tuple(y.shape) == (3, m) and tuple(s.shape) == (3, m) and sweeps is None
    check(a, b, y, s)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lucky_breakdown_gives_exact_zeros(rng, dtype):
    """H after a breakdown at Arnoldi step j: its columns past j are zero
    (V[j+1] = 0), and the SVD cutoff gives exact zeros in those entries of
    y, in both packages; the rest meets the contract."""
    m, j = 10, 4
    a, b = hessenberg(rng, m, dtype)
    a[:, :, j:] = 0.0
    a[1, j + 1:, :] = 0.0
    y = E2.small_lstsq_plain(torch.from_numpy(a), torch.from_numpy(b))
    s = torch.linalg.svdvals(torch.from_numpy(a))
    assert not y[:, j:].any()
    for y_ref, _ in reference(a, b):
        assert not y_ref[j:].any()
    check(a, b, y, s)


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_matrix_gives_zero(dtype):
    """The zero matrix (a residual that is already 0: β = 0 too, or not):
    y = 0 in both, with no NaN (a zero singular value is dropped)."""
    a = np.zeros((2, 5, 4), dtype)
    b = np.zeros((2, 5), dtype)
    b[1, 0] = 1.0
    y = E2.small_lstsq_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(y, torch.zeros_like(y))
    for y_ref, s_ref in reference(a, b):
        assert not y_ref.any() and not s_ref.any()


def test_wrapper_takes_the_plain_version_on_the_cpu(rng):
    """CPU tensors: the plain version's bits, no launch; under vmap too."""
    a, b = hessenberg(rng, 6, np.float64, batch=4)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    before = E2.launch_counts()
    y = E2.small_lstsq(at, bt)
    assert torch.equal(y, E2.small_lstsq_plain(at, bt))
    y_v = torch.func.vmap(E2.small_lstsq)(at, bt)
    assert torch.allclose(y_v, y, rtol=1e-12, atol=0)
    assert E2.launch_counts() == before
    check(a, b, y, torch.linalg.svdvals(at))


def test_kernel_is_registered():
    """The kernel's launch count is registered with the loop, and its device
    function is defined in its CUDA source."""
    src = (pathlib.Path(E2.__file__).parent / "csrc" / "small_lstsq.cu").read_text()
    defined = set(re.findall(r"__global__\s+void\s+(\w+)", src))
    assert any(t is E2._LAUNCHES for t in loop._LAUNCH_TABLES)
    assert set(E2.LAUNCH_SYMBOLS) == set(E2._LAUNCHES)
    assert set(E2.LAUNCH_SYMBOLS.values()) <= defined
