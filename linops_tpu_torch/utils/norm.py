"""Operator norm estimation.

Counterpart of ``linops_tpu/utils/norm.py``:

- ``normest``: power iteration on SᴴS on ``utils/loop.py::device_while``
  (one host read per block of masked iterations; on a CUDA device each
  block a CUDA-graph replay), as the reference's one compiled
  ``lax.while_loop`` (``_normest_loop`` takes its start vector and reseed
  noise explicitly);
- ``estimate_opnorm``: a tiny dense fallback, Lanczos with full
  reorthogonalization on hermitian operators, Lanczos on the Gram operator
  otherwise, retries that double the Krylov dimension, then one LOBPCG
  solve, and ``(nan, False)`` when all of that fails.

On a distributed operator the start vectors are drawn whole from one seed
on every rank and placed in the operator's layout (``parallel/comm.py``);
the estimates are the same on every rank.
"""

from __future__ import annotations

import warnings

import torch

from ..core.base import LinearOperatorException
from ..core.dense import aslinearoperator
from ..parallel import comm
from . import loop
from .estimate import _device, _lanczos_tridiag, _probe_dtype, _real, _tridiag
from .rng import fresh_generator

__all__ = ["normest", "estimate_opnorm"]


def _real_eps(dtype) -> float:
    return torch.finfo(_real(dtype)).eps


def _normest_loop(op, v0, reseed_noise, tol: float, maxiter: int):
    """The power iteration of ``normest`` from start ``v0`` (length m), at
    most ``maxiter + 1`` steps as the reference's; returns (estimate,
    iterations) as Python numbers, read once the loop has ended. A zero
    first image stops it before any step (a device ``where``, no read)."""
    x = op.apply(v0, "H")
    e0 = torch.linalg.vector_norm(x)
    x = x / torch.where(e0 == 0, torch.ones_like(e0), e0)
    tol_t = torch.full((), float(tol), dtype=e0.dtype, device=e0.device)

    def cond(state, consts):
        _, e, e_prev = state
        return torch.abs(e - e_prev) > consts[0] * e

    def body(state, consts, _):
        x, e, _ = state
        Sx = op.apply(x, "N")
        # reseed on an exactly zero image
        Sx = torch.where(torch.all(Sx == 0), consts[1], Sx)
        x = op.apply(Sx, "H")
        normx = torch.linalg.vector_norm(x)
        return x / normx, normx / torch.linalg.vector_norm(Sx), e

    (_, e, _), cnt = loop.device_while(cond, body, (x, e0, torch.zeros_like(e0)), maxiter + 1,
                                       consts=(tol_t, reseed_noise), ops=(op,),
                                       key=("normest",))
    return float(comm.gather_full(e)), cnt


def _placed(op, v, domain: bool = False):
    """A whole start vector, the same on every rank, in the operator's
    layout (its range's, or with ``domain`` its domain's); a plain call
    keeps it as it is."""
    lay = comm.layout_of(op, domain=domain)
    return v if lay is None else lay.place(v)


@comm.dtensor_entry
def normest(op, tol: float = -1, maxiter: int = 100, generator=None):
    """Estimate the 2-norm of ``op`` by power iteration on SᴴS from a
    sign-randomized all-ones start. Returns ``(estimate, iterations)``; warns
    when ``maxiter`` runs out."""
    op = aslinearoperator(op)
    m, _ = op.shape
    dt = _probe_dtype(op)
    if tol == -1:
        tol = _real_eps(dt)
    dev = _device(op, "normest")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    rdt = _real(dt)
    signs = torch.where(torch.randn(m, generator=g, device=dev, dtype=rdt) < 0, -1.0, 1.0)
    v0 = signs.to(dt)
    noise = torch.randn(m, generator=g, device=dev, dtype=rdt).to(dt)
    e, cnt = _normest_loop(op, _placed(op, v0), _placed(op, noise), tol, maxiter)
    if cnt > maxiter:
        warnings.warn(f"normest did not converge (maxiter={maxiter}, tol={tol})")
    return e, cnt


def _lanczos_extreme(op, v0, ncv: int, gram: bool):
    """Lanczos with two full reorthogonalization sweeps; (theta, resid) of
    the largest-|.| Ritz pair of ``op`` (hermitian) or of AᴴA (``gram``)."""
    def matvec(x):
        if gram:
            return op.apply(op.apply(x, "N"), "H")
        return op.apply(x, "N")

    v = v0 / torch.linalg.vector_norm(v0)
    _, alphas, betas = _lanczos_tridiag(matvec, v, ncv, reorth=True, passes=2)
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
    idx = torch.argmax(torch.abs(evals))
    return evals[idx], torch.abs(betas[-1] * evecs[-1, idx])


@comm.dtensor_entry
def estimate_opnorm(op, max_attempts: int = 3, tiny_dense_threshold: int = 5, ncv: int = 20,
                    generator=None, rtol: float = None, lobpcg_fallback: bool = True):
    """Estimate the operator 2-norm; returns ``(norm, success)``. Tiny:
    dense; hermitian: Lanczos on the operator; otherwise Lanczos on AᴴA;
    retries double the Krylov dimension, then (``lobpcg_fallback``) one
    LOBPCG solve; exhaustion gives ``(nan, False)``."""
    op = aslinearoperator(op)
    m, n = op.shape
    dt = _probe_dtype(op)
    if rtol is None:
        rtol = _real_eps(dt) ** 0.5
    if min(m, n) <= tiny_dense_threshold:
        A = op.to_dense().to(dt)
        if op.hermitian:
            return float(torch.max(torch.abs(torch.linalg.eigvalsh(A)))), True
        return float(torch.max(torch.linalg.svdvals(A))), True
    dev = _device(op, "estimate_opnorm")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    rdt = _real(dt)
    hermitian = op.hermitian and m == n
    gram = not hermitian
    dim = m if hermitian else n
    for attempt in range(max_attempts):
        k = min(dim, ncv * (2 ** attempt))
        v0 = torch.randn(dim, generator=g, device=dev, dtype=rdt).to(dt)
        theta, resid = _lanczos_extreme(op, _placed(op, v0, domain=gram), int(k), gram)
        theta_f, resid_f = float(theta), float(resid)
        est = abs(theta_f) if hermitian else max(theta_f, 0.0) ** 0.5
        if resid_f <= rtol * max(abs(theta_f), 1e-30) or k >= dim:
            return est, True
        warnings.warn(f"estimate_opnorm: Lanczos residual {resid_f:.2e} too large with "
                      f"ncv={k}; retrying")
    if lobpcg_fallback:
        # a small block captures a clustered extremal eigenvalue that stalls
        # single-vector Lanczos
        from .eig import _GramOperator, lobpcg

        kb = max(1, min(4, min(m, n) // 3))

        def converged(th, res):
            return float(res[0]) <= rtol * max(abs(float(th[0])), 1.0)

        try:
            if hermitian:
                ends = []
                for largest in (True, False):
                    th, _, res, _ = lobpcg(op, k=kb, largest=largest, tol=rtol,
                                           maxiter=20 * ncv, generator=g)
                    if not converged(th, res):
                        break
                    ends.append(abs(float(th[0])))
                if len(ends) == 2:
                    return max(ends), True
            else:
                th, _, res, _ = lobpcg(_GramOperator(op, "right" if n <= m else "left"),
                                       k=kb, largest=True, tol=rtol, maxiter=20 * ncv,
                                       generator=g)
                if converged(th, res):
                    return max(float(th[0]), 0.0) ** 0.5, True
        except (LinearOperatorException, ValueError, FloatingPointError,
                torch.linalg.LinAlgError) as e:
            warnings.warn(f"estimate_opnorm: lobpcg fallback failed: {e}")
    return float("nan"), False
