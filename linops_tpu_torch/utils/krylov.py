"""Krylov methods: the matvec chain, CG (one or several right-hand sides),
GMRES, MINRES (one or several right-hand sides), BiCGSTAB, LSQR, power
iteration and Chebyshev iteration.

Counterpart of ``linops_tpu/utils/krylov.py``: the same recurrences, the same
stopping tests and the same returned tuples. Where the reference runs each
solve as one ``lax.while_loop``/``fori_loop`` on the device, the port runs
its loops on ``utils/loop.py``: masked iterations in blocks, one host read
per block (none for Chebyshev, power iteration and the matvec chain), each
block a CUDA-graph replay on the card. The counts and bits are those of a
plain per-iteration loop. Every solver works on the operator's device, in
``promote(b, op)``; a preconditioner's output is cast to that dtype. The
reference's TPU residency hint (``chain_resident``) has no counterpart.
Under ``torch.func.vmap`` the solvers with a stopping test stop as
``jax.vmap`` of a while loop does (``loop.device_while``).

GMRES keeps the reference's scheme: one Arnoldi cycle of ``restart`` steps
with full (classical Gram-Schmidt) orthogonalization against the whole
basis, then the small least-squares problem with the reference's cutoff
(``kernels/small_lstsq.py``: on the card E2, a kernel that reads nothing
back; on the CPU the SVD), and it counts restarts, not iterations. A
restart is one masked iteration of ``loop.device_while`` in blocks of
``GMRES_BLOCK`` (one) restart: the whole solve replays as captured blocks,
one host read per restart, and nested in another solve (an
``opIterativeInverse`` on GMRES) it is a CUDA while node.

Every solver is a public entry of ``parallel/comm.py``'s rule
(``dtensor_entry``): given a DTensor vector it runs with plain operators,
preconditioners and scalars counted as replicated, and returns x in b's
placement; a plain b given with a distributed operator is placed in the
operator's layout first, so x comes back there (the reference's
``P('shard')`` for a row-partitioned operator). GMRES then keeps this rank's rows of its Arnoldi basis
(``comm.Rows``): each step's projections are one local product and one
all-reduce of the (m + 1)-vector, its norm one more, and the basis is never
gathered.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator
from ..core.precision import pcolumn_dot, pmatmul, pvdot
from ..kernels.small_lstsq import small_lstsq
from ..parallel import comm
from . import loop

__all__ = ["matvec_chain", "cg", "gmres", "minres", "bicgstab", "lsqr", "chebyshev",
           "power_iteration"]

# restarts per masked block of GMRES: a frozen restart (past convergence)
# costs a whole Arnoldi cycle, so a longer block would waste up to its length
# less one cycles, against one host read per restart saved
GMRES_BLOCK = 1


@comm.dtensor_entry
def matvec_chain(op: LinearOperator, v, iters: int = 100, mode: str = "N",
                 normalize: bool = True):
    """Apply ``op`` ``iters`` times (normalizing each step by default to keep
    magnitudes bounded), with no host read. Returns the final vector."""

    def body(state, _):
        x = op.apply(state[0], mode)
        return (x / torch.linalg.vector_norm(x),) if normalize else (x,)

    return loop.device_fori(body, (v,), iters, ops=(op,), key=("matvec_chain", mode,
                                                               normalize))[0]


def _setup(op, b, M=None):
    """(b in the solver dtype, that dtype, its real dtype, the preconditioner
    as a function)."""
    dt = torch.promote_types(b.dtype, op.dtype)
    rdt = torch.empty((), dtype=dt).real.dtype

    def prec(v, matrix=False):
        if M is None:
            return v
        return (M.apply_matrix(v, "N") if matrix else M.apply(v, "N")).to(dt)

    return b.to(dt), dt, rdt, prec


def _nonzero(x):
    """x, with exact zeros replaced by 1 (the reference's guarded divisor)."""
    return torch.where(x == 0, torch.ones_like(x), x)


@comm.dtensor_entry
def cg(op: LinearOperator, b, x0=None, *, tol: float = 1e-8, maxiter: int = 100,
       M: LinearOperator = None):
    """Conjugate gradients on a symmetric positive-definite operator, with an
    optional preconditioner ``M ≈ A⁻¹`` (e.g. an ``InverseLBFGSOperator``).
    Stops when ‖r‖ ≤ tol·‖b‖ or after ``maxiter`` iterations. Returns
    (x, iterations, final residual norm as a 0-dim tensor).

    A 2-D ``b`` of shape (n, k) solves the k systems at once over
    ``apply_matrix`` (``_cg_multi``) and returns per-column residual norms."""
    if b.ndim == 2:
        return _cg_multi(op, b, x0, tol=tol, maxiter=maxiter, M=M)
    b, dt, _, prec = _setup(op, b, M)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    r = b - op.apply(x, "N")
    z = prec(r)
    p = z
    rz = pvdot(r, z)
    tol2 = (tol * torch.linalg.vector_norm(b)) ** 2
    rr = pvdot(r, r).real

    def body(state, consts, _):
        x, r, p, rz, _ = state
        Ap = op.apply(p, "N")
        alpha = rz / pvdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = pvdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, pvdot(r, r).real

    (x, _, _, _, rr), k = loop.device_while(lambda s, c: s[4] > c[0], body, (x, r, p, rz, rr),
                                            maxiter, consts=(tol2,), ops=(op, M), key=("cg",))
    return x, k, torch.sqrt(rr)


def _cg_multi(op: LinearOperator, B, X0=None, *, tol: float = 1e-8, maxiter: int = 100,
              M: LinearOperator = None):
    """Multi-RHS CG: k independent per-column recurrences over
    ``apply_matrix`` (each operator read serves the k columns). A column
    that has converged or broken down freezes (its α is 0), so a late column
    cannot poison an early one. Returns (X, iterations, per-column residual
    norms)."""
    B, dt, _, prec = _setup(op, B, M)
    X = torch.zeros_like(B) if X0 is None else X0.to(dt)
    R = B - op.apply_matrix(X, "N")
    Z = prec(R, matrix=True)
    P = Z
    rz = pcolumn_dot(R, Z)
    tol2 = (tol * torch.linalg.vector_norm(B, dim=0)) ** 2
    act = pcolumn_dot(R, R).real > tol2

    def body(state, consts, _):
        X, R, P, rz, act = state
        AP = op.apply_matrix(P, "N")
        pAp = pcolumn_dot(P, AP)
        zero = torch.zeros_like(rz)
        alpha = torch.where(act, rz / torch.where(act & (pAp != 0), pAp, torch.ones_like(pAp)),
                            zero)
        X = X + P * alpha[None, :]
        R = R - AP * alpha[None, :]
        Z = prec(R, matrix=True)
        rz_new = pcolumn_dot(R, Z)
        beta = torch.where(act & (rz != 0), rz_new / _nonzero(rz), zero)
        P = Z + P * beta[None, :]
        return X, R, P, rz_new, pcolumn_dot(R, R).real > consts[0]

    (X, R, *_), k = loop.device_while(lambda s, c: s[4].any(), body, (X, R, P, rz, act), maxiter,
                                      consts=(tol2,), ops=(op, M), key=("cg_multi",))
    return X, k, torch.sqrt(pcolumn_dot(R, R).real)


@comm.dtensor_entry
def gmres(op: LinearOperator, b, x0=None, *, tol: float = 1e-8, restart: int = 30,
          maxiter: int = 10, M: LinearOperator = None):
    """Restarted GMRES(m) for general square operators, with an optional
    left preconditioner ``M ≈ A⁻¹``. Each restart cycle runs ``restart``
    Arnoldi steps with full orthogonalization, then solves the small
    least-squares problem (``small_lstsq``: E2 on the card). Stops when
    ‖b − Ax‖ ≤ tol·‖b‖ or after ``maxiter`` cycles. Returns (x, restarts
    used, final residual norm).

    The restarts run on ``loop.device_while`` in blocks of ``GMRES_BLOCK``,
    as the reference runs them in one ``lax.while_loop``: on the card a
    cached solve replays one captured restart per host read (Arnoldi, E2 and
    the residual; the basis written in place, in the block's memory), and a
    GMRES nested in another solve's captured block is a CUDA while node. The
    Arnoldi cycle writes its basis in place; under ``torch.func.vmap`` it
    stacks the rows instead (vmap cannot write a batched row in place), and
    the restarts stop per member as ``jax.vmap`` of a while loop does."""
    n = b.shape[0]
    b, dt, _, prec = _setup(op, b, M)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    m = min(restart, n)
    bnorm = torch.linalg.vector_norm(b)
    tol_abs = tol * _nonzero(bnorm)

    R = comm.rows_of(b)  # a DTensor b: this rank's rows of the basis

    def arnoldi(x, b):
        """(V, H, β) of one cycle from x (every tensor it reads is an
        argument or made here: it may be captured). V holds this rank's
        rows of the basis (all of it for a plain b)."""
        rows = torch.arange(m + 1, device=b.device)
        zero = torch.zeros((), dtype=dt, device=b.device)
        r = prec(b - op.apply(x, "N"))
        if loop._batched(r):  # functional: rows stacked, columns of H stacked
            beta = torch.linalg.vector_norm(r)
            Vrows = [r / _nonzero(beta)]
            cols = []
            for j in range(m):
                V = torch.stack(Vrows + [torch.zeros_like(r)] * (m + 1 - len(Vrows)))
                w = prec(op.apply(Vrows[j], "N"))
                hcol = torch.where(rows <= j, pmatmul(V.conj(), w), zero)
                w = w - pmatmul(V.T, hcol)
                hj1 = torch.linalg.vector_norm(w)
                Vrows.append(w / _nonzero(hj1))
                cols.append(torch.where(rows == j + 1, hj1.to(dt), hcol))
            return torch.stack(Vrows), torch.stack(cols, dim=1), beta
        r = R.local(r)
        beta = R.norm(r)
        V = torch.zeros((m + 1, r.shape[0]), dtype=dt, device=b.device)
        H = torch.zeros((m + 1, m), dtype=dt, device=b.device)
        V[0] = r / _nonzero(beta)
        for j in range(m):
            w = R.local(prec(op.apply(R.dtensor(V[j]), "N")))
            hcol = torch.where(rows <= j, R.psum(pmatmul(V.conj(), w)), zero)
            w = w - pmatmul(V.T, hcol)
            hj1 = R.norm(w)
            V[j + 1] = w / _nonzero(hj1)
            H[:, j] = hcol
            H[j + 1, j] = hj1
        return V, H, beta

    def body(state, consts, _):
        x, _ = state
        b = consts[0]
        V, H, beta = arnoldi(x, b)
        e1 = torch.where(torch.arange(m + 1, device=b.device) == 0, beta.to(dt), 0.0)
        x = x + R.dtensor(pmatmul(V[:m].T, small_lstsq(H, e1)))
        return x, torch.linalg.vector_norm(b - op.apply(x, "N"))

    res = torch.linalg.vector_norm(b - op.apply(x, "N"))
    (x, res), k = loop.device_while(lambda s, c: s[1] > c[1], body, (x, res), maxiter,
                                    consts=(b, tol_abs), ops=(op, M), key=("gmres", m),
                                    block=GMRES_BLOCK)
    return x, k, res


class _MinresState:
    """The Paige–Saunders recurrence's scalars for k columns (0-dim for one):
    previous β, current β, d̄, ε, φ̄, cos, sin."""

    PHIBAR = 4  # position of φ̄ in ``fields()``

    def __init__(self, beta1, rdt):
        zero = torch.zeros_like(beta1, dtype=rdt)
        self.oldb, self.beta, self.dbar, self.epsln = zero, beta1, zero, zero
        self.phibar, self.cs, self.sn = beta1, -torch.ones_like(zero), zero

    def fields(self) -> tuple:
        return self.oldb, self.beta, self.dbar, self.epsln, self.phibar, self.cs, self.sn

    @classmethod
    def of(cls, fields):
        s = cls.__new__(cls)
        s.oldb, s.beta, s.dbar, s.epsln, s.phibar, s.cs, s.sn = fields
        return s


def _minres_step(op, s: _MinresState, V, R1, R2, W, W2, k, dt, eps, prec, cdot, matrix,
                 act=None):
    """One Lanczos step and Givens update, for one vector or k columns
    (per-column scalars broadcast over rows). Returns the new vectors
    (Y, R1, R2, W, W2) and phi, the solution step's coefficient. ``k`` is
    the iteration's index (a 0-dim tensor): step 0 has no previous vector."""
    expand = (lambda t: t[None, :]) if matrix else (lambda t: t)
    safe_beta = _nonzero(s.beta)
    Y = op.apply_matrix(V, "N") if matrix else op.apply(V, "N")
    Y = torch.where(k >= 1, Y - expand(s.beta / _nonzero(s.oldb)).to(dt) * R1, Y)
    alfa = cdot(V, Y).real  # real for a hermitian operator
    Y = Y - expand(alfa / safe_beta).to(dt) * R2
    R1, R2 = R2, Y
    Y = prec(R2, matrix=matrix)
    s.oldb = s.beta
    s.beta = torch.sqrt(torch.clamp_min(cdot(R2, Y).real, 0.0))
    # the previous Givens rotation on the new Lanczos column, then the next one
    oldeps = s.epsln
    delta = s.cs * s.dbar + s.sn * alfa
    gbar = s.sn * s.dbar - s.cs * alfa
    s.epsln = s.sn * s.beta
    s.dbar = -s.cs * s.beta
    gamma = torch.clamp_min(torch.sqrt(gbar * gbar + s.beta * s.beta), eps)
    s.cs = gbar / gamma
    s.sn = s.beta / gamma
    phi = s.cs * s.phibar
    if act is None:
        s.phibar = s.sn * s.phibar
    else:  # frozen columns stop moving
        phi = torch.where(act, phi, torch.zeros_like(phi))
        s.phibar = torch.where(act, s.sn * s.phibar, s.phibar)
    W1, W2 = W2, W
    W = (V - expand(oldeps).to(dt) * W1 - expand(delta).to(dt) * W2) / expand(gamma).to(dt)
    return Y, R1, R2, W, W2, expand(phi).to(dt)


@comm.dtensor_entry
def minres(op: LinearOperator, b, x0=None, *, tol: float = 1e-8, maxiter: int = 100,
           M: LinearOperator = None):
    """MINRES (Paige–Saunders) for symmetric or hermitian, possibly
    indefinite operators, with an optional SPD preconditioner ``M ≈ A⁻¹``.
    Stops when the preconditioned residual estimate φ̄ ≤ tol·β₁ or after
    ``maxiter`` iterations. Returns (x, iterations, φ̄).

    A 2-D ``b`` of shape (n, k) solves the k systems at once over
    ``apply_matrix`` (``_minres_multi``) and returns per-column φ̄."""
    if b.ndim == 2:
        return _minres_multi(op, b, x0, tol=tol, maxiter=maxiter, M=M)
    b, dt, rdt, prec = _setup(op, b, M)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    eps = torch.finfo(rdt).eps
    R1 = b - op.apply(x, "N")
    Y = prec(R1)
    beta1 = torch.sqrt(torch.clamp_min(pvdot(R1, Y).real, 0.0))
    tol_abs = tol * _nonzero(beta1)
    s0 = _MinresState(beta1, rdt)

    def body(state, consts, k):
        x, Y, R1, R2, W, W2, *scalars = state
        s = _MinresState.of(scalars)
        V = Y / _nonzero(s.beta).to(dt)
        Y, R1, R2, W, W2, phi = _minres_step(op, s, V, R1, R2, W, W2, k, dt, eps, prec, pvdot,
                                             matrix=False)
        return (x + phi * W, Y, R1, R2, W, W2, *s.fields())

    init = (x, Y, R1, R1, torch.zeros_like(b), torch.zeros_like(b), *s0.fields())
    state, k = loop.device_while(lambda st, c: st[6 + _MinresState.PHIBAR] > c[0], body, init,
                                 maxiter, consts=(tol_abs,), ops=(op, M), key=("minres",))
    return state[0], k, state[6 + _MinresState.PHIBAR]


def _minres_multi(op: LinearOperator, B, X0=None, *, tol: float = 1e-8, maxiter: int = 100,
                  M: LinearOperator = None):
    """Multi-RHS MINRES: k independent Paige–Saunders recurrences over
    ``apply_matrix``; a converged column freezes its solution update (φ = 0).
    Returns (X, iterations, per-column φ̄)."""
    B, dt, rdt, prec = _setup(op, B, M)
    X = torch.zeros_like(B) if X0 is None else X0.to(dt)
    eps = torch.finfo(rdt).eps
    R1 = B - op.apply_matrix(X, "N")
    Y = prec(R1, matrix=True)
    beta1 = torch.sqrt(torch.clamp_min(pcolumn_dot(R1, Y).real, 0.0))
    tol_abs = tol * _nonzero(beta1)
    s0 = _MinresState(beta1, rdt)

    def body(state, consts, k):
        X, Y, R1, R2, W, W2, *scalars = state
        s = _MinresState.of(scalars)
        act = s.phibar > consts[0]
        V = Y / _nonzero(s.beta)[None, :].to(dt)
        Y, R1, R2, W, W2, phi = _minres_step(op, s, V, R1, R2, W, W2, k, dt, eps, prec,
                                             pcolumn_dot, matrix=True, act=act)
        return (X + phi * W, Y, R1, R2, W, W2, *s.fields())

    init = (X, Y, R1, R1, torch.zeros_like(B), torch.zeros_like(B), *s0.fields())
    state, k = loop.device_while(
        lambda st, c: (st[6 + _MinresState.PHIBAR] > c[0]).any(), body, init, maxiter,
        consts=(tol_abs,), ops=(op, M), key=("minres_multi",))
    return state[0], k, state[6 + _MinresState.PHIBAR]


@comm.dtensor_entry
def bicgstab(op: LinearOperator, b, x0=None, *, tol: float = 1e-8, maxiter: int = 100,
             M: LinearOperator = None):
    """BiCGSTAB (van der Vorst) for general square operators, with an
    optional right preconditioner ``M ≈ A⁻¹``: two operator applies (and two
    M applies) per iteration. Stops when ‖r‖ ≤ tol·‖b‖, after ``maxiter``
    iterations, or at a breakdown (ρ = r̂·r, r̂·v or ω about 0, e.g. a
    skew-symmetric A): then the last iterate stays, with its true residual
    norm, so non-convergence shows as ``res > tol·‖b‖``, never as NaN.
    Returns (x, iterations, final residual norm)."""
    b, dt, rdt, prec = _setup(op, b, M)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    tiny = torch.finfo(rdt).tiny ** 0.5  # catches exact and denormal zeros
    r = b - op.apply(x, "N")
    rhat = r  # the shadow residual, fixed
    one = torch.ones((), dtype=dt, device=b.device)
    tol_abs = tol * _nonzero(torch.linalg.vector_norm(b))
    brk = torch.zeros((), dtype=torch.bool, device=b.device)

    def body(state, consts, _):
        x, r, p, v, rho, alpha, omega, brk = state
        rhat, _, one = consts
        rho_new = pvdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + beta * (p - omega * v)
        phat = prec(p_new)
        v_new = op.apply(phat, "N")
        rhv = pvdot(rhat, v_new)
        brk = (rho_new.abs() <= tiny) | (rhv.abs() <= tiny)
        alpha_new = rho_new / torch.where(brk, one, rhv)
        s = r - alpha_new * v_new
        shat = prec(s)
        t = op.apply(shat, "N")
        tt = pvdot(t, t)
        omega_new = pvdot(t, s) / _nonzero(tt)
        brk = brk | (omega_new.abs() <= tiny)
        # on a breakdown the iterate freezes (the loop test ends the solve)
        return (torch.where(brk, x, x + alpha_new * phat + omega_new * shat),
                torch.where(brk, r, s - omega_new * t), torch.where(brk, p, p_new),
                torch.where(brk, v, v_new), torch.where(brk, rho, rho_new),
                torch.where(brk, alpha, alpha_new), torch.where(brk, omega, omega_new), brk)

    def cond(state, consts):
        return (torch.linalg.vector_norm(state[1]) > consts[1]) & ~state[7]

    zero = torch.zeros_like(b)
    (x, r, *_), k = loop.device_while(cond, body, (x, r, zero, zero, one, one, one, brk),
                                      maxiter, consts=(rhat, tol_abs, one), ops=(op, M),
                                      key=("bicgstab",))
    return x, k, torch.linalg.vector_norm(r)


@comm.dtensor_entry
def lsqr(op: LinearOperator, b, *, damp: float = 0.0, tol: float = 1e-8, maxiter: int = 100):
    """LSQR (Paige–Saunders): min ‖Ax − b‖² + damp²‖x‖² for a general
    (rectangular) operator by Golub–Kahan bidiagonalization; it needs only
    the N and adjoint applies. Stops when the ‖Aᴴr‖ estimate ≤ tol·‖Aᴴb‖ or
    after ``maxiter`` iterations. Returns (x, iterations, ‖Aᴴr‖ estimate)."""
    b, dt, rdt, _ = _setup(op, b)
    n = op.shape[1]
    dampf = torch.tensor(damp, dtype=rdt, device=b.device)

    def nrm(v):
        return torch.linalg.vector_norm(v).to(rdt)

    beta = nrm(b)
    u = b / _nonzero(beta).to(dt)
    v = op.apply(u, "H")
    alpha = nrm(v)
    v = v / _nonzero(alpha).to(dt)
    arnorm = alpha * beta  # ‖Aᴴb‖, the scale of the stopping test
    tol_abs = tol * _nonzero(arnorm)
    x = torch.zeros((n,), dtype=dt, device=b.device)

    def body(state, consts, _):
        x, u, v, w, phibar, rhobar, alpha, _ = state
        dampf = consts[0]
        # bidiagonalization step
        u = op.apply(v, "N") - alpha.to(dt) * u
        beta = nrm(u)
        u = u / _nonzero(beta).to(dt)
        v = op.apply(u, "H") - beta.to(dt) * v
        alpha = nrm(v)
        v = v / _nonzero(alpha).to(dt)
        # eliminate the damping term (a rotation into the rhobar row)
        rhobar1 = torch.sqrt(rhobar * rhobar + dampf * dampf)
        phibar1 = (rhobar / rhobar1) * phibar
        # QR rotation on the lower-bidiagonal column
        rho = torch.sqrt(rhobar1 * rhobar1 + beta * beta)
        c, s_ = rhobar1 / rho, beta / rho
        theta = s_ * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s_ * phibar1
        x = x + (phi / rho).to(dt) * w
        w = v - (theta / rho).to(dt) * w
        # (rhobar, phibar) are defined up to a joint sign flip: take |·|
        return x, u, v, w, phibar, rhobar, alpha, (phibar * alpha * c).abs()

    state, k = loop.device_while(lambda st, c: st[7] > c[1], body,
                                 (x, u, v, v, beta, alpha, alpha, arnorm), maxiter,
                                 consts=(dampf, tol_abs), ops=(op,), key=("lsqr",))
    return state[0], k, state[7]


@comm.dtensor_entry
def power_iteration(op: LinearOperator, v0, iters: int = 50):
    """Largest-|eigenvalue| estimate of a square operator by power
    iteration (no host read). Returns (eigenvalue estimate, eigenvector)."""
    v = v0 / torch.linalg.vector_norm(v0)
    lam = torch.zeros((), dtype=v.dtype, device=v.device)

    def body(state, _):
        v, _ = state
        w = op.apply(v, "N")
        return w / torch.linalg.vector_norm(w), pvdot(v, w)

    v, lam = loop.device_fori(body, (v, lam), iters, ops=(op,), key=("power_iteration",))
    return comm.rows_of(v).replicated(lam), v  # on DTensors: λ replicated, as the reference's


@comm.dtensor_entry
def chebyshev(op: LinearOperator, b, lam_min, lam_max, x0=None, *, iters: int = 50,
              M: LinearOperator = None):
    """Chebyshev iteration for SPD operators with spectral bounds
    ``0 < lam_min <= lam(A) <= lam_max`` (of ``M A`` when preconditioned).
    The loop has no inner products, so it reads nothing back: a fixed
    ``iters`` steps, then the residual norm once. Classical form (Saad,
    algorithm 12.1) with the first-step special case β₁ = (cα)²/2. Returns
    (x, iters, final residual norm)."""
    b, dt, rdt, prec = _setup(op, b, M)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    lam_min = torch.as_tensor(lam_min, dtype=rdt, device=b.device)
    lam_max = torch.as_tensor(lam_max, dtype=rdt, device=b.device)
    d = (lam_max + lam_min) / 2.0
    c = (lam_max - lam_min) / 2.0
    if iters >= 1:
        r = prec(b - op.apply(x, "N"))
        alpha = 1.0 / d
        p = r
        x = x + alpha.to(dt) * p
    if iters >= 2:
        r = r - alpha.to(dt) * prec(op.apply(p, "N"))
        beta = 0.5 * (c * alpha) ** 2
        alpha = 1.0 / (d - beta / alpha)
        p = r + beta.to(dt) * p
        x = x + alpha.to(dt) * p

        def body(state, consts):
            x, r, p, alpha = state
            d, c = consts
            r = r - alpha.to(dt) * prec(op.apply(p, "N"))
            beta = (c * alpha / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = r + beta.to(dt) * p
            return x + alpha.to(dt) * p, r, p, alpha

        x, *_ = loop.device_fori(body, (x, r, p, alpha), iters - 2, consts=(d, c), ops=(op, M),
                                 key=("chebyshev",))
    return x, max(iters, 0), torch.linalg.vector_norm(b - op.apply(x, "N"))
