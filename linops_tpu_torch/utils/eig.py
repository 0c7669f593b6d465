"""LOBPCG block eigensolver, singular triplets, randomized SVD and the
Nyström preconditioner, for hermitian (or, through the Gram operator, any)
operators.

Counterpart of ``linops_tpu/utils/eig.py``. LOBPCG (Knyazev 2001) keeps the
reference's design: every iteration applies the operator afresh to the raw
(3k, n) basis [X | W | P] (panels are carried as row panels through
``apply_matrix_t``), solves a (3k)² Rayleigh–Ritz problem, and keeps block
identity through blockwise orthonormalization (X orthonormal, W and P
Gram–Schmidt'ed against the earlier blocks twice, then SVQB'd by
Stathopoulos & Wu's method). Directions with negligible weight are zeroed
and pushed past the Gershgorin edge so the selection never picks them.
``basis="gram"`` (the default) does that orthonormalization in coefficient
space on one fresh (6k)² joint Gram per iteration; ``basis="direct"`` on
the big panels. Each reference ``lax.while_loop`` is a host loop here, with
one stopping-test read per iteration (the convention of
``utils/krylov.py``); the returned iteration count is the reference's.

``basis="gram"`` squares the basis condition number, so hold f32 runs to
well-conditioned problems.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException
from ..core.dense import aslinearoperator
from ..core.precision import pmatmul
from .estimate import _device, _probe_dtype, _real
from .rng import fresh_generator

__all__ = ["lobpcg", "svds", "rsvd", "nystrom_preconditioner", "NystromPreconditioner"]


def _H(X):
    return X.conj().T


def _svqb_transform_g(G):
    """The SVQB orthonormalizing transform from a column Gram matrix G:
    ``(T, clipped)`` with S @ T orthonormal; ``clipped`` marks directions
    of negligible weight (their columns of S @ T are about zero)."""
    m = G.shape[0]
    rdt = _real(G.dtype)
    eps = torch.finfo(rdt).eps
    tiny = torch.tensor(torch.finfo(rdt).tiny * 100, dtype=rdt, device=G.device)
    d = torch.diagonal(G).real
    dmax = torch.max(d)
    # scale-invariant column keep: only hard zeros drop here
    keep = d > torch.maximum(dmax * 1e-28, tiny)
    Dinv = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, d, torch.ones_like(d))),
                       torch.zeros_like(d))
    Gn = Dinv[:, None].to(G.dtype) * G * Dinv[None, :].to(G.dtype)
    w, V = torch.linalg.eigh(Gn)
    clipped = w < torch.maximum(torch.max(w) * (m * 10) * eps, tiny)
    winv = torch.where(clipped, torch.zeros_like(w),
                       1.0 / torch.sqrt(torch.where(clipped, torch.ones_like(w), w)))
    T = (Dinv[:, None].to(V.dtype) * V) * winv[None, :].to(V.dtype)
    return T.to(G.dtype), clipped


def _svqb_transform(S):
    return _svqb_transform_g(pmatmul(_H(S), S))


def _svqb(S):
    """Orthonormalize the columns of S: ``(Q, T, clipped)`` with Q = S @ T."""
    T, clipped = _svqb_transform(S)
    return pmatmul(S, T), T, clipped


def _svqb_t(St):
    """Row-panel SVQB: orthonormalize the rows of St (k, n); ``(Tᵀ St,
    clipped)``."""
    T, clipped = _svqb_transform_g(pmatmul(St.conj(), St.T))
    return pmatmul(T.T, St), clipped


def _rr_from_H(H, clipped, k: int, largest: bool):
    """Rayleigh–Ritz selection of k pairs from the projected matrix H."""
    H = 0.5 * (H + _H(H))
    # clipped directions go just past the Gershgorin edge
    big = 2.0 * torch.max(torch.sum(torch.abs(H), dim=1)) + 1.0
    sign = -1.0 if largest else 1.0
    H = H + torch.diag(torch.where(clipped, sign * big, torch.zeros_like(big))).to(H.dtype)
    w, C = torch.linalg.eigh(H)
    m = w.shape[0]
    idx = (torch.arange(m - 1, m - 1 - k, -1, device=w.device) if largest
           else torch.arange(k, device=w.device))
    return w.real[idx], C[:, idx]


def _gs_t(Yt, Zt, passes: int = 2):
    """Gram–Schmidt of the rows of Yt against the orthonormal rows of Zt."""
    for _ in range(passes):
        Yt = Yt - pmatmul(pmatmul(Yt, _H(Zt)), Zt)
    return Yt


def _not_converged(res, theta, kc: int, tol: float) -> bool:
    """The stopping test: one host read per iteration."""
    return bool(torch.max(res[:kc] / torch.clamp(torch.abs(theta[:kc]), min=1.0)) > tol)


def _lobpcg_start(op, X0, Yct, k, largest):
    deflate = (lambda Bt: _gs_t(Bt, Yct)) if Yct is not None else (lambda Bt: Bt)
    Xt, clip0 = _svqb_t(deflate(X0.T))
    AXt = op.apply_matrix_t(Xt, "N")
    theta, C = _rr_from_H(pmatmul(Xt.conj(), AXt.T), clip0, k, largest)
    return pmatmul(C.T, Xt), pmatmul(C.T, AXt), theta, deflate


def _lobpcg_gram(op, Mop, X0, Yc, tol, k, maxiter, largest, k_conv=None):
    """LOBPCG with the basis kept in coefficient space: per iteration one
    fresh image of the raw basis, one joint (6k)² Gram of [S; A S] and one
    fused update; the orthonormalization is (6k)² arithmetic."""
    rdt = _real(X0.dtype)
    Yct = Yc.T if Yc is not None else None
    Xt, AXt, theta, deflate = _lobpcg_start(op, X0, Yct, k, largest)
    Pt = torch.zeros_like(Xt)
    kw = dict(dtype=X0.dtype, device=X0.device)
    eyek, zk = torch.eye(k, **kw), torch.zeros((k, k), **kw)
    kc = k if k_conv is None else k_conv

    def small_gs(E, G, Zc, passes=2):
        # rows of E @ S_raw against rows of Zc @ S_raw through the Gram G
        Gb = G.conj()
        for _ in range(passes):
            E = E - pmatmul(pmatmul(pmatmul(E, Gb), _H(Zc)), Zc)
        return E

    res = torch.full((k,), float("inf"), dtype=rdt, device=X0.device)
    it = 0
    while it < maxiter and _not_converged(res, theta, kc, tol):
        Rt = AXt - theta[:, None].to(Xt.dtype) * Xt
        Wt = deflate(Mop.apply_matrix_t(Rt, "N") if Mop is not None else Rt)
        St = torch.cat([Xt, Wt, Pt], dim=0)  # raw basis (3k, n)
        ASt = op.apply_matrix_t(St, "N")  # fresh image
        B = torch.cat([St, ASt], dim=0)  # (6k, n)
        G6 = pmatmul(B.conj(), B.T)
        G, H = G6[: 3 * k, : 3 * k], G6[: 3 * k, 3 * k:]
        Tx, cX = _svqb_transform_g(G[:k, :k])
        Ex = pmatmul(Tx.T, torch.cat([eyek, zk, zk], dim=1))
        Ew1 = small_gs(torch.cat([zk, eyek, zk], dim=1), G, Ex)
        Tw, cW = _svqb_transform_g(pmatmul(pmatmul(Ew1.conj(), G), Ew1.T))
        Ew = pmatmul(Tw.T, Ew1)
        Exw = torch.cat([Ex, Ew], dim=0)
        Ep1 = small_gs(torch.cat([zk, zk, eyek], dim=1), G, Exw)
        Tp, cP = _svqb_transform_g(pmatmul(pmatmul(Ep1.conj(), G), Ep1.T))
        Ep = pmatmul(Tp.T, Ep1)
        E = torch.cat([Ex, Ew, Ep], dim=0)  # (3k, 3k)
        clipped = torch.cat([cX, cW, cP])
        theta, C = _rr_from_H(pmatmul(pmatmul(E.conj(), H), E.T), clipped, k, largest)
        CE = pmatmul(C.T, E)  # new X rows in raw coordinates
        Cp = C.clone()
        Cp[:k] = 0  # implicit P: the W + P part of the new X
        CpE = pmatmul(Cp.T, E)
        z3 = torch.zeros_like(CE)
        M_small = torch.cat([torch.cat([CE, z3], dim=1), torch.cat([CpE, z3], dim=1),
                             torch.cat([z3, CE], dim=1)], dim=0)  # (3k, 6k)
        OUT = pmatmul(M_small, B)
        Xt, Pt, AXt = OUT[:k], OUT[k: 2 * k], OUT[2 * k:]
        # residuals from the materialized Ritz pieces (the small-space formula
        # cancels in f32 near convergence)
        res = torch.linalg.vector_norm(AXt - theta[:, None].to(Xt.dtype) * Xt, dim=1).to(rdt)
        it += 1
    return theta, Xt.T, res, it


def _lobpcg_direct(op, Mop, X0, Yc, tol, k, maxiter, largest, k_conv=None):
    """LOBPCG with the blockwise orthonormalization on the (·, n) panels."""
    rdt = _real(X0.dtype)
    Yct = Yc.T if Yc is not None else None
    Xt, AXt, theta, deflate = _lobpcg_start(op, X0, Yct, k, largest)
    Pt = torch.zeros_like(Xt)
    kc = k if k_conv is None else k_conv
    res = torch.full((k,), float("inf"), dtype=rdt, device=X0.device)
    it = 0
    while it < maxiter and _not_converged(res, theta, kc, tol):
        Rt = AXt - theta[:, None].to(Xt.dtype) * Xt
        Wt = Mop.apply_matrix_t(Rt, "N") if Mop is not None else Rt
        Wt = _gs_t(deflate(Wt), Xt)
        Wt, cW = _svqb_t(Wt)
        XWt = torch.cat([Xt, Wt], dim=0)
        Pbt, cP = _svqb_t(_gs_t(Pt, XWt))
        St = torch.cat([XWt, Pbt], dim=0)  # (3k, n)
        clipped = torch.cat([torch.zeros((k,), dtype=torch.bool, device=X0.device), cW, cP])
        ASt = op.apply_matrix_t(St, "N")  # fresh image
        theta, C = _rr_from_H(pmatmul(St.conj(), ASt.T), clipped, k, largest)
        Cp = C.clone()
        Cp[:k] = 0
        OUT = pmatmul(torch.cat([C, Cp], dim=1).T, St)  # (2k, n)
        Xt, Pt = OUT[:k], OUT[k:]
        AXt = pmatmul(C.T, ASt)
        res = torch.linalg.vector_norm(AXt - theta[:, None].to(Xt.dtype) * Xt, dim=1)
        it += 1
    return theta, Xt.T, res, it


def lobpcg(op, k: int = 1, X0=None, *, largest: bool = False, tol: float = 1e-6,
           maxiter: int = 200, M=None, Y=None, generator=None, block_size=None,
           basis: str = "gram"):
    """Extremal eigenpairs of a hermitian operator by LOBPCG.

    Returns ``(theta, X, resnorms, iters)``: k eigenvalues (smallest by
    default, ``largest=True`` for the other end), the (n, k) eigenvector
    block, the residual norms ‖A x − θ x‖ and the iteration count;
    converged when every resnorm ≤ tol·max(|θ|, 1). ``M`` approximates A⁻¹;
    ``X0`` (n, k) seeds the block (else a normal block from ``generator``);
    ``Y`` (n, j) constrains the search to the complement of its span;
    ``block_size`` ≥ k runs a wider internal block whose extra pairs are
    dropped. ``basis``: ``"gram"`` (default) or ``"direct"``."""
    if basis not in ("gram", "direct"):
        raise ValueError(f"unknown basis {basis!r} (use 'gram' or 'direct')")
    op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(f"lobpcg requires a square operator, got {(m, n)}")
    if not op.hermitian:
        raise LinearOperatorException("lobpcg requires a hermitian operator (set "
                                      "hermitian=True if the operator is known hermitian)")
    if not 1 <= 3 * k <= n:
        raise ValueError(f"k={k} out of range for n={n} (the [X|W|P] basis needs 3k <= n)")
    if M is not None:
        M = aslinearoperator(M)
        if M.shape != (n, n):
            raise LinearOperatorException(f"preconditioner must have shape {(n, n)}, "
                                          f"got {M.shape}")
    k_int = k
    if block_size is not None:
        k_int = int(block_size)
        if k_int < k:
            raise ValueError(f"block_size={k_int} must be >= k={k}")
        if 3 * k_int > n:
            raise ValueError(f"block_size={k_int} out of range for n={n} "
                             f"(needs 3*block_size <= n)")
    dt = _probe_dtype(op)
    rdt = _real(dt)
    dev = _device(op, "lobpcg")
    g = generator
    if X0 is None:
        g = g if g is not None else fresh_generator(dev)
        X0 = torch.randn((n, k), generator=g, device=dev, dtype=rdt).to(dt)
    else:
        X0 = torch.as_tensor(X0, device=dev).to(dt)
        if tuple(X0.shape) != (n, k):
            raise LinearOperatorException(f"X0 must have shape {(n, k)}, got {tuple(X0.shape)}")
        # a rank-deficient start would seed X with a zero direction
        gev = torch.linalg.eigvalsh(pmatmul(_H(X0), X0))
        thresh = (100 * k + 10 * n ** 0.5) * torch.finfo(rdt).eps
        if float(gev[0]) <= float(gev[-1]) * thresh:
            raise LinearOperatorException(
                "X0 is numerically rank-deficient; provide k linearly independent start "
                "vectors (or pass X0=None for a random block)")
    if Y is not None:
        Y = torch.as_tensor(Y, device=dev).to(dt)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.ndim != 2 or Y.shape[0] != n:
            raise LinearOperatorException(f"Y must have shape (n, j) = ({n}, j), "
                                          f"got {tuple(Y.shape)}")
        if 3 * k + Y.shape[1] > n:
            raise ValueError(f"constraint block too wide: 3k + j = {3 * k + Y.shape[1]} > n = {n}")
        Y, _, clipY = _svqb(Y)
        if bool(torch.any(clipY)):
            raise LinearOperatorException("constraint block Y is numerically rank-deficient")
    if k_int > k:  # pad the internal block with random extra columns
        g = g if g is not None else fresh_generator(dev)
        X0 = torch.cat([X0, torch.randn((n, k_int - k), generator=g, device=dev,
                                        dtype=rdt).to(dt)], dim=1)
    impl = _lobpcg_gram if basis == "gram" else _lobpcg_direct
    theta, X, res, it = impl(op, M, X0, Y, float(tol), k_int, int(maxiter), bool(largest),
                             k_conv=k)
    return theta[:k], X[:, :k], res[:k], int(it)


class _GramOperator(LinearOperator):
    """``AᴴA`` (side="right") or ``AAᴴ`` (side="left") as a hermitian
    positive semi-definite node (a ``Compose`` would drop the flag)."""

    _fields_tensors = ("base",)
    _fields_static = ("side",)

    def __init__(self, base: LinearOperator, side: str = "right"):
        super().__init__()
        if side not in ("right", "left"):
            raise ValueError("side must be 'right' or 'left'")
        self.base = base
        self.side = side

    @property
    def nrow(self):
        return self.base.ncol if self.side == "right" else self.base.nrow

    @property
    def ncol(self):
        return self.nrow

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def hermitian(self):
        return True

    @property
    def symmetric(self):
        return not self.dtype.is_complex

    def _gram(self, v, batched: bool):
        ap = self.base.apply_matrix if batched else self.base.apply
        if self.side == "right":
            return ap(ap(v, "N"), "H")
        return ap(ap(v, "H"), "N")

    def apply(self, v, mode: str = "N"):
        if mode in ("N", "H"):
            return self._gram(v, False)
        return self._gram(v.conj(), False).conj()

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "H"):
            return self._gram(M, True)
        return self._gram(M.conj(), True).conj()

    def _name(self):
        return f"Gram({self.side}) of"


def svds(op, k: int = 1, *, largest: bool = True, tol: float = 1e-6, maxiter: int = 200,
         generator=None):
    """Extremal singular triplets by LOBPCG on the smaller Gram operator.
    Returns ``(U, s, V, resnorms, iters)`` with ``op @ V ≈ U * s``."""
    op = aslinearoperator(op)
    m, n = op.shape
    side = "right" if n <= m else "left"
    theta, X, gres, it = lobpcg(_GramOperator(op, side), k=k, largest=largest, tol=tol,
                                maxiter=maxiter, generator=generator)
    s = torch.sqrt(torch.clamp(theta, min=0.0))
    safe = torch.clamp(s, min=torch.finfo(s.dtype).tiny * 1e3).to(X.dtype)
    if side == "right":
        V = X
        U = op.apply_matrix(V, "N") / safe[None, :]
    else:
        U = X
        V = op.apply_matrix(U, "H") / safe[None, :]
    return U, s, V, gres / safe.real, it


def _rsvd(op, G, power_iters: int):
    Y = op.apply_matrix(G, "N")  # (m, l)
    # subspace iteration with QR between passes (Halko-Martinsson-Tropp Alg 4.4)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Qz, _ = torch.linalg.qr(op.apply_matrix(Q, "H"))
        Y = op.apply_matrix(Qz, "N")
    Q, _ = torch.linalg.qr(Y)  # (m, l) orthonormal range basis
    B = op.apply_matrix(Q, "H")  # (n, l): Bᴴ = Qᴴ A
    Us, s, Vh = torch.linalg.svd(_H(B), full_matrices=False)
    return pmatmul(Q, Us), s, _H(Vh)


def rsvd(op, k: int, *, oversample: int = 10, power_iters: int = 2, generator=None):
    """Randomized top-k SVD (Halko, Martinsson & Tropp 2011): ``(U, s, V)``
    with ``op ≈ U diag(s) Vᴴ``, from 2·power_iters + 2 block applies of
    width k + oversample."""
    op = aslinearoperator(op)
    m, n = op.shape
    if not 1 <= k <= min(m, n):
        raise ValueError(f"k={k} out of range for shape {(m, n)}")
    if oversample < 0 or power_iters < 0:
        raise ValueError("oversample and power_iters must be >= 0")
    l = int(min(k + oversample, min(m, n)))
    dt = _probe_dtype(op)
    dev = _device(op, "rsvd")
    g = generator if generator is not None else fresh_generator(dev)
    G = torch.randn((n, l), generator=g, device=dev, dtype=_real(dt)).to(dt)
    U, s, V = _rsvd(op, G, int(power_iters))
    return U[:, :k], s[:k], V[:, :k]


class NystromPreconditioner(LinearOperator):
    """The randomized Nyström preconditioner (Frangella, Tropp & Udell 2023)
    from a rank-l sketch A ≈ U diag(lam) Uᴴ:
    ``P⁻¹ v = (lam_r + mu) U ((lam + mu)⁻¹ ⊙ Uᴴ v) + (v − U Uᴴ v)``,
    lam_r the smallest kept eigenvalue, mu the shift of the system."""

    _fields_tensors = ("U", "lam")
    _fields_static = ("_mu",)

    def __init__(self, U, lam, mu: float = 0.0):
        super().__init__()
        self.U = U
        self.lam = lam
        self._mu = float(mu)

    @property
    def nrow(self):
        return self.U.shape[0]

    @property
    def ncol(self):
        return self.U.shape[0]

    @property
    def dtype(self):
        return self.U.dtype

    @property
    def hermitian(self):
        return True

    @property
    def symmetric(self):
        return not self.dtype.is_complex

    def _pinv_apply(self, v):
        lam = self.lam
        den = torch.clamp(lam + self._mu, min=torch.finfo(lam.dtype).tiny * 100)
        scale = (lam[-1] + self._mu) / den  # lam sorted descending
        Uv = pmatmul(_H(self.U), v)
        sc = scale.to(v.dtype) if v.ndim == 1 else scale[:, None].to(v.dtype)
        return pmatmul(self.U, sc * Uv) + (v - pmatmul(self.U, Uv))

    def apply(self, v, mode: str = "N"):
        if mode in ("N", "H"):
            return self._pinv_apply(v)
        return self._pinv_apply(v.conj()).conj()

    def apply_matrix(self, M, mode: str = "N"):
        return self.apply(M, mode)

    def _name(self):
        return f"NystromPreconditioner(rank={self.lam.shape[0]}, mu={self._mu})"


def _nystrom_sketch(op, Om):
    Y = op.apply_matrix(Om, "N")  # (n, l)
    # stability shift nu ~ sqrt(n) eps ‖Y‖ (FTU23 Alg 2.1)
    rdt = _real(Y.dtype)
    nu = Y.shape[0] ** 0.5 * torch.finfo(rdt).eps * torch.linalg.norm(Y)
    Ynu = Y + nu.to(Y.dtype) * Om
    G = pmatmul(_H(Om), Ynu)
    G = 0.5 * (G + _H(G))
    C, info = torch.linalg.cholesky_ex(G)
    if int(info) != 0:
        # not PSD: NaN, as the reference's factor leaves it (torch's SVD
        # refuses non-finite input)
        nan = float("nan")
        return torch.full_like(Om, nan), torch.full((Om.shape[1],), nan, dtype=rdt,
                                                     device=Om.device)
    B = torch.linalg.solve_triangular(C, _H(Ynu), upper=False)
    Us, s, _ = torch.linalg.svd(_H(B), full_matrices=False)
    return Us, torch.clamp(s * s - nu, min=0.0)


def nystrom_preconditioner(op, rank: int, *, mu: float = 0.0, oversample: int = 10,
                           generator=None):
    """A ``NystromPreconditioner`` of a hermitian PSD operator from one
    (n, rank + oversample) sketch apply, truncated to the sketch's
    numerical rank. A non-PSD operator surfaces as NaNs."""
    op = aslinearoperator(op)
    m, n = op.shape
    if m != n:
        raise LinearOperatorException(f"nystrom_preconditioner requires a square operator, "
                                      f"got {(m, n)}")
    if not op.hermitian:
        raise LinearOperatorException("nystrom_preconditioner requires a hermitian (PSD) "
                                      "operator")
    if not 1 <= rank <= n:
        raise ValueError(f"rank={rank} out of range for n={n}")
    if mu < 0:
        raise ValueError("mu must be >= 0")
    l = int(min(rank + oversample, n))
    dt = _probe_dtype(op)
    dev = _device(op, "nystrom_preconditioner")
    g = generator if generator is not None else fresh_generator(dev)
    Om = torch.randn((n, l), generator=g, device=dev, dtype=_real(dt)).to(dt)
    Us, lam = _nystrom_sketch(op, Om)
    eps = torch.finfo(lam.dtype).eps
    lam0 = float(lam[0])
    r_eff = int(torch.sum(lam > lam0 * n * eps)) if lam0 > 0 else 0
    if r_eff == 0:
        raise LinearOperatorException("nystrom_preconditioner: the sketch found numerical "
                                      "rank 0 (operator is ~zero or not PSD)")
    rank = min(rank, r_eff)
    return NystromPreconditioner(Us[:, :rank], lam[:rank], mu)
