"""Stochastic trace, diagonal and spectral-sum estimation, and f(A) b.

Counterpart of ``linops_tpu/utils/estimate.py``:

- ``estimate_trace``: Hutch++ (Meyer, Musco, Musco & Woodruff 2021) or
  plain Hutchinson over an (n, k) Rademacher block, one ``apply_matrix``
  per block;
- ``estimate_diagonal``: the Bekas/Kokiopoulou/Saad probe estimator;
- ``estimate_spectral_sum`` / ``estimate_logdet``: stochastic Lanczos
  quadrature (Ubaru, Chen & Saad 2017), every probe's recurrence run side
  by side as one column block;
- ``funm_apply``: ``f(A) b`` by Lanczos with full reorthogonalization.

The probe blocks come from ``generator`` (``utils/rng.py``); the helpers
``_hutchinson``, ``_hutchpp``, ``_diag_probes`` and ``_slq`` take them
explicitly. ``f`` is a torch callable (``torch.log``, ``torch.exp``)
applied to the Ritz values. Each Lanczos step is one operator apply and
no host read.

On a distributed operator a probe block is drawn whole from one seed on
every rank and placed in the operator's layout (``parallel/comm.py``):
each rank keeps its rows, every sum over rows is a local sum and one
all-reduce, and no block is gathered (Hutch++'s sketch basis is a QR of
the rows: the local QRs' R factors are reduced, one all-reduce, and
factored again). ``estimate_diagonal`` returns its rows split; the scalar
estimates are the same on every rank.
"""

from __future__ import annotations

import math

import torch

from ..core.base import LinearOperatorException, default_device
from ..core.dense import aslinearoperator
from ..core.precision import pmatmul
from ..parallel import comm
from .rng import fresh_generator

__all__ = ["estimate_trace", "estimate_diagonal", "estimate_spectral_sum", "estimate_logdet",
           "funm_apply"]


def _probe_dtype(op):
    """The operator's dtype when it is floating, else f64."""
    dt = op.dtype
    return dt if (dt.is_floating_point or dt.is_complex) else torch.float64


def _real(dt):
    return torch.empty((), dtype=dt).real.dtype


def _device(op, what):
    return op.device if op.device is not None else default_device(None, what)


def _rademacher(g, shape, dtype, device):
    """Real ±1 probes (E[g gᵀ] = I is all the estimators need, and real
    probes keep the quadratic forms unbiased for complex A)."""
    signs = torch.randint(0, 2, shape, generator=g, device=device)
    return (2 * signs - 1).to(_real(dtype)).to(dtype)


def _std(x, dim=None):
    """Population standard deviation, as ``jnp.std``."""
    return torch.std(x, dim=dim, correction=0) if dim is not None else torch.std(
        x, correction=0)


def _probes(op, G):
    """(the rows of G, of op·G, and the row steps): G may be a DTensor in
    the operator's layout (``comm.Rows``), or a plain block."""
    R = comm.rows_of(G)
    return R.local(G), R.local(op.apply_matrix(G, "N")), R


def _orth(Y, R):
    """An orthonormal basis of the columns of Y (this rank's rows): its
    QR, or for rows split over ranks the local QRs' R factors stacked and
    summed (one all-reduce) and factored again."""
    if R.pieces == 1:
        return torch.linalg.qr(Y)[0]
    Q1, R1 = torch.linalg.qr(Y)
    r, m = R1.shape
    stack = torch.zeros((R.pieces * m, m), dtype=R1.dtype, device=R1.device)
    stack[R.index * m: R.index * m + r] = R1
    Q2, _ = torch.linalg.qr(R.psum(stack))
    return pmatmul(Q1, Q2[R.index * m: R.index * m + r])


def _hutchinson(op, G):
    G, AG, R = _probes(op, G)
    samples = R.psum(torch.sum(G.conj() * AG, dim=0))
    k = samples.shape[0]
    est = torch.mean(samples)
    se = _std(samples.real) / math.sqrt(k) if k > 1 else torch.zeros((), dtype=samples.real.dtype)
    return est, se


def _hutchpp(op, S, G):
    _, AS, R = _probes(op, S)
    G = R.local(G)
    Q = _orth(AS, R)  # (n, m) orthonormal sketch basis
    AQ = R.local(op.apply_matrix(R.dtensor(Q), "N"))
    t_lowrank = R.psum(torch.sum(Q.conj() * AQ))  # tr(Qᴴ A Q), exact
    # deflated probes g' = (I − Q Qᴴ) g estimate tr((I−P) A (I−P))
    Gd = G - pmatmul(Q, R.psum(pmatmul(Q.conj().T, G)))
    AGd = R.local(op.apply_matrix(R.dtensor(Gd), "N"))
    samples = R.psum(torch.sum(Gd.conj() * AGd, dim=0))
    k = samples.shape[0]
    est = t_lowrank + torch.mean(samples)
    se = _std(samples.real) / math.sqrt(k) if k > 1 else torch.zeros((), dtype=samples.real.dtype)
    return est, se


def _square(op, what):
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(f"{what} requires a square operator, got shape {(m, n)}")
    return n


def _drawn(op, block):
    """A whole probe block, the same on every rank, in the operator's
    layout (each rank keeps its rows); a plain call keeps it as it is."""
    lay = comm.layout_of(op)
    return block if lay is None else lay.place(block)


@comm.dtensor_entry
def estimate_trace(op, *, probes: int = 36, generator=None, method: str = "hutchpp"):
    """Estimate ``tr(op)`` with ``probes`` operator-block columns in all.
    Returns ``(estimate, stderr)``: the standard error of the stochastic part
    (for Hutch++ the sketched part is exact). ``method``: ``"hutchpp"``
    (a third of the probes sketch, a third apply the sketch basis, the rest
    estimate the deflated residual) or ``"hutchinson"``."""
    op = aslinearoperator(op)
    n = _square(op, "trace")
    if probes < 1:
        raise ValueError("probes must be >= 1")
    dt = _probe_dtype(op)
    dev = _device(op, "estimate_trace")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    if method == "hutchinson":
        est, se = _hutchinson(op, _drawn(op, _rademacher(g, (n, probes), dt, dev)))
    elif method == "hutchpp":
        if probes < 3:
            raise ValueError("hutchpp needs probes >= 3 (sketch + sketch-apply + residual); "
                             "use method='hutchinson' for smaller budgets")
        m_s = max(1, min(probes // 3, n))
        m_g = probes - 2 * m_s
        S = _rademacher(g, (n, m_s), dt, dev)
        G = _rademacher(g, (n, m_g), dt, dev)
        est, se = _hutchpp(op, _drawn(op, S), _drawn(op, G))
    else:
        raise ValueError(f"unknown method {method!r} (hutchpp | hutchinson)")
    if op.dtype.is_complex:
        return complex(est), float(se)
    return float(est.real), float(se)


def _diag_probes(op, G):
    G, AG, R = _probes(op, G)
    samples = G.conj() * AG  # (n, k) per-probe diagonal draws
    k = samples.shape[1]
    est = torch.mean(samples, dim=1)
    if k > 1:
        se = _std(samples.real, dim=1) / math.sqrt(k)
    else:
        se = torch.zeros(est.shape, dtype=samples.real.dtype, device=est.device)
    return R.dtensor(est), R.dtensor(se)


@comm.dtensor_entry
def estimate_diagonal(op, *, probes: int = 64, generator=None):
    """Estimate ``diag(op)``. Returns ``(diag, stderr)`` tensors of length n
    (on a distributed operator, DTensors in its layout)."""
    op = aslinearoperator(op)
    n = _square(op, "diagonal estimation")
    if probes < 1:
        raise ValueError("probes must be >= 1")
    dt = _probe_dtype(op)
    dev = _device(op, "estimate_diagonal")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    return _diag_probes(op, _drawn(op, _rademacher(g, (n, probes), dt, dev)))


# ---------------------------------------------------------------------------
# Lanczos: the one recurrence behind SLQ, funm_apply and estimate_opnorm
# ---------------------------------------------------------------------------


def _lanczos_tridiag(matvec, v0, m, reorth, passes: int = 1):
    """``m`` steps of Lanczos on hermitian ``matvec`` from unit-norm ``v0``.
    Returns ``(V, alphas, betas)``: V the (m, n) basis when ``reorth`` (each
    step reorthogonalized against it ``passes`` times), else a (1, n)
    placeholder. ``v0`` may be an (n, k) block of unit columns: then k
    recurrences run side by side (``matvec`` takes the block), V is (m, n,
    k) and alphas/betas (m, k). On an invariant subspace the recurrence goes
    inert (beta = 0). A DTensor ``v0`` keeps this rank's rows of V
    (``comm.Rows``): its products reduce by one all-reduce each, and it is
    never gathered."""
    R = comm.rows_of(v0)
    vec = v0.ndim == 1
    v = R.local(v0)
    v = v[:, None] if vec else v
    mv = ((lambda X: R.local(matvec(R.dtensor(X[:, 0])))[:, None]) if vec
          else (lambda X: R.local(matvec(R.dtensor(X)))))
    n, k = v.shape
    dt, rdt = v.dtype, _real(v.dtype)
    alphas = torch.zeros((m, k), dtype=rdt, device=v.device)
    betas = torch.zeros((m, k), dtype=rdt, device=v.device)
    V = torch.zeros((m if reorth else 1, n, k), dtype=dt, device=v.device)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((k,), dtype=rdt, device=v.device)
    for j in range(m):
        if reorth:
            V[j] = v
        w = mv(v) - beta_prev.to(dt) * v_prev
        alpha = R.psum(torch.sum(v.conj() * w, dim=0)).real
        w = w - alpha.to(dt) * v
        if reorth:
            for _ in range(passes):
                coef = R.psum(torch.einsum("jnk,nk->jk", V.conj(), w))
                w = w - torch.einsum("jnk,jk->nk", V, coef)
        beta = R.norm(w, dim=0)
        pos = beta > 0
        v_next = torch.where(pos, w / torch.where(pos, beta, torch.ones_like(beta)).to(dt),
                             torch.zeros_like(w))
        alphas[j] = alpha
        betas[j] = beta
        v_prev, v, beta_prev = v, v_next, beta
    if vec:
        return V[..., 0], alphas[:, 0], betas[:, 0]
    return V, alphas, betas


def _tridiag(alphas, betas):
    """The (…, m, m) Lanczos tridiagonal of (…, m) alphas and betas."""
    T = torch.diag_embed(alphas)
    off = torch.diag_embed(betas[..., :-1], offset=1)
    return T + off + off.transpose(-1, -2)


def _slq(op, V0, m, reorth, f):
    """Per-probe m-step Lanczos and Gauss quadrature; V0 (n, k) has unit
    columns. Returns the k per-probe estimates of vᴴ f(A) v."""
    rdt = _real(V0.dtype)
    _, alphas, betas = _lanczos_tridiag(lambda X: op.apply_matrix(X, "N"), V0, m, reorth)
    theta, U = torch.linalg.eigh(_tridiag(alphas.T, betas.T))  # (k, m), (k, m, m)
    w = U[:, 0, :] ** 2  # Gauss weights: squared e1 components
    # zero-weight nodes (decoupled after early termination) must not
    # evaluate f at their spurious theta
    cut = torch.finfo(rdt).eps * m * 10
    live = w > cut
    safe = torch.where(live, theta, torch.ones_like(theta))
    return torch.sum(torch.where(live, w * f(safe), torch.zeros_like(w)), dim=1)


def _hermitian_square(op, what):
    op = aslinearoperator(op)
    n = _square(op, what)
    if not op.hermitian:
        raise LinearOperatorException(f"{what} requires a hermitian operator (set "
                                      "hermitian=True if the operator is known hermitian)")
    return op, n


@comm.dtensor_entry
def estimate_spectral_sum(op, f, *, probes: int = 16, lanczos_steps: int = 30,
                          generator=None, reorth: bool = None):
    """Estimate ``tr(f(op))`` of a hermitian operator by stochastic Lanczos
    quadrature. ``reorth`` (full reorthogonalization, an (m, n) basis per
    probe) is on by default when the bases fit 256 MiB. Returns
    ``(estimate, stderr)``; ``log`` and ``1/x`` need a positive-definite
    operator."""
    op, n = _hermitian_square(op, "estimate_spectral_sum")
    if probes < 1 or lanczos_steps < 1:
        raise ValueError("probes and lanczos_steps must be >= 1")
    m = int(min(lanczos_steps, n))
    dt = _probe_dtype(op)
    dev = _device(op, "estimate_spectral_sum")
    g = generator if generator is not None else fresh_generator(dev, like=(op,))
    if reorth is None:
        itemsize = torch.empty((), dtype=dt).element_size()
        reorth = probes * m * n * itemsize <= 256 * 1024 * 1024
    G = _rademacher(g, (n, probes), dt, dev)
    V0 = G / torch.linalg.vector_norm(G, dim=0, keepdim=True)
    samples = n * _slq(op, _drawn(op, V0), m, bool(reorth), f)
    est = torch.mean(samples)
    se = _std(samples) / math.sqrt(probes) if probes > 1 else torch.zeros_like(est)
    return float(est), float(se)


def estimate_logdet(op, *, probes: int = 16, lanczos_steps: int = 30, generator=None,
                    reorth: bool = None):
    """Estimate ``log det(op)`` of a hermitian positive-definite operator
    (``tr(log op)`` by SLQ). A non-PD operator gives NaN."""
    return estimate_spectral_sum(op, torch.log, probes=probes, lanczos_steps=lanczos_steps,
                                 generator=generator, reorth=reorth)


def _funm(op, b, m, f):
    rdt = _real(b.dtype)
    nrm = torch.linalg.vector_norm(b)
    v0 = b / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    # full reorthogonalization: the result lives in the basis
    V, alphas, betas = _lanczos_tridiag(lambda v: op.apply(v, "N"), v0, m, reorth=True)
    theta, U = torch.linalg.eigh(_tridiag(alphas, betas))
    e1w = U[0, :]
    cut = torch.finfo(rdt).eps * m * 10
    live = torch.abs(e1w) > cut
    fv = f(torch.where(live, theta, torch.ones_like(theta)))
    fw = torch.where(live, fv, torch.zeros_like(fv))
    coeffs = pmatmul(U.to(fw.dtype), fw * e1w)
    out = comm.rows_of(b).dtensor(pmatmul(V.T, coeffs))
    return torch.where(nrm > 0, nrm * out, torch.zeros_like(out))


@comm.dtensor_entry
def funm_apply(op, f, b, *, lanczos_steps: int = 30):
    """``f(op) @ b`` for a hermitian operator by ``lanczos_steps`` of Lanczos
    with full reorthogonalization; exact once the Krylov space captures b's
    spectral content. A DTensor ``b`` gives a DTensor in its placement (the
    basis kept as this rank's rows)."""
    op, n = _hermitian_square(op, "funm_apply")
    if lanczos_steps < 1:
        raise ValueError("lanczos_steps must be >= 1")
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=_device(op, "funm_apply"))
    b = b.to(torch.promote_types(_probe_dtype(op), b.dtype))
    if tuple(b.shape) != (n,):
        raise LinearOperatorException(f"b must have shape ({n},), got {tuple(b.shape)}")
    return _funm(op, b, int(min(lanczos_steps, n)), f)
