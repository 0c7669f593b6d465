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

``_solve_panel`` runs cg, minres, bicgstab or gmres on the k vectors of a
panel (an (n, k) block of columns or a (k, n) block of rows) as one loop,
as ``jax.vmap`` of the vector solve does: each vector keeps its own
recurrence, tolerance and count and freezes once its own test fails, and
the operator is applied to the whole panel at each step, with one
reduction (one all-reduce on a DTensor panel) for the k vectors. It is
``opIterativeInverse``'s block apply; public ``cg``/``minres`` with a 2-D
``b`` keep the reference's multi-RHS forms.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException
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


def _dots(*pairs) -> tuple:
    """⟨a, b⟩ (conjugating a) of the vector pairs of one point of a
    recurrence. On DTensor vectors their pending sums are stacked and made
    whole in one all-reduce (``comm.made_whole``; as XLA combines the
    reference's reductions of one point), so no scalar meets a split vector
    with a sum pending; on plain tensors each is ``pvdot``'s, unchanged."""
    d = [pvdot(a, b) for a, b in pairs]
    if not comm.is_dtensor(d[0]):
        return tuple(d)
    return tuple(comm.made_whole(torch.stack(d)).unbind(0))


def _dot(a, b):
    return _dots((a, b))[0]


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
    rz, rr = _dots((r, z), (r, r))
    tol2 = (tol * torch.linalg.vector_norm(b)) ** 2
    rr = rr.real

    def body(state, consts, _):
        x, r, p, rz, _ = state
        Ap = op.apply(p, "N")
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new, rr = _dots((r, z), (r, r))
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, rr.real

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
        return _arnoldi(lambda v: R.local(prec(op.apply(R.dtensor(v), "N"))), R.local(r), R, m)

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


def _arnoldi(apply, r, R: comm.Rows, m: int):
    """(V, H, β) of one Arnoldi cycle of m steps with full orthogonalization
    from r, this rank's rows of one residual (rows,) or of k of them (k,
    rows) (``R`` their ``comm.Rows``). ``apply`` maps a basis vector (or the
    k of them) to this rank's rows of its image. The basis V ((m + 1, rows),
    or (k, m + 1, rows)) is written in place; each step's projections are one
    local product and one all-reduce, its norm one more."""
    dt = r.dtype
    many = r.ndim == 2
    norm = R.norm_t if many else R.norm

    def mv(A, x):  # A (..., p, q) times x (..., q)
        return pmatmul(A, x[..., None])[..., 0] if many else pmatmul(A, x)

    rows = torch.arange(m + 1, device=r.device)
    zero = torch.zeros((), dtype=dt, device=r.device)
    beta = norm(r)
    V = torch.zeros((*r.shape[:-1], m + 1, r.shape[-1]), dtype=dt, device=r.device)
    H = torch.zeros((*r.shape[:-1], m + 1, m), dtype=dt, device=r.device)
    V[..., 0, :] = r / _nonzero(beta)[..., None].to(dt)
    for j in range(m):
        w = apply(V[..., j, :])
        hcol = torch.where(rows <= j, R.psum(mv(V.conj(), w)), zero)
        w = w - mv(V.transpose(-1, -2), hcol)
        hj1 = norm(w)
        V[..., j + 1, :] = w / _nonzero(hj1)[..., None].to(dt)
        H[..., :, j] = hcol
        H[..., j + 1, j] = hj1
    return V, H, beta


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


def _minres_step(apply, s: _MinresState, V, R1, R2, W, W2, k, dt, eps, prec, cdot, expand,
                 act=None):
    """One Lanczos step and Givens update, for one vector or k of them
    (``apply`` the operator's apply, ``cdot`` the per-vector dot, ``expand``
    broadcasts a per-vector scalar over its vector). Returns the new vectors
    (Y, R1, R2, W, W2) and phi, the solution step's coefficient. ``k`` is
    the iteration's index (a 0-dim tensor): step 0 has no previous vector."""
    safe_beta = _nonzero(s.beta)
    Y = apply(V)
    Y = torch.where(k >= 1, Y - expand(s.beta / _nonzero(s.oldb)).to(dt) * R1, Y)
    alfa = cdot(V, Y).real  # real for a hermitian operator
    Y = Y - expand(alfa / safe_beta).to(dt) * R2
    R1, R2 = R2, Y
    Y = prec(R2)
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
    beta1 = torch.sqrt(torch.clamp_min(_dot(R1, Y).real, 0.0))
    tol_abs = tol * _nonzero(beta1)
    s0 = _MinresState(beta1, rdt)

    def body(state, consts, k):
        x, Y, R1, R2, W, W2, *scalars = state
        s = _MinresState.of(scalars)
        V = Y / _nonzero(s.beta).to(dt)
        Y, R1, R2, W, W2, phi = _minres_step(lambda V: op.apply(V, "N"), s, V, R1, R2, W, W2,
                                             k, dt, eps, prec, _dot, lambda t: t)
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
        Y, R1, R2, W, W2, phi = _minres_step(
            lambda V: op.apply_matrix(V, "N"), s, V, R1, R2, W, W2, k, dt, eps,
            lambda R: prec(R, matrix=True), pcolumn_dot, lambda t: t[None, :], act=act)
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
        rho_new = _dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + beta * (p - omega * v)
        phat = prec(p_new)
        v_new = op.apply(phat, "N")
        rhv = _dot(rhat, v_new)
        brk = (rho_new.abs() <= tiny) | (rhv.abs() <= tiny)
        alpha_new = rho_new / torch.where(brk, one, rhv)
        s = r - alpha_new * v_new
        shat = prec(s)
        t = op.apply(shat, "N")
        tt, ts = _dots((t, t), (t, s))
        omega_new = ts / _nonzero(tt)
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


# ----------------------------------------------------------------------------
# Panel solves: k systems of one operator as one loop (opIterativeInverse's
# block apply)
# ----------------------------------------------------------------------------


class _Panel:
    """k vectors kept as one panel: an (n, k) block of columns, or with
    ``rows`` a (k, n) block of rows, applied by the operator's
    ``apply_matrix`` or ``apply_matrix_t`` (one pass over the operator for
    the k of them). ``dots`` and ``norm`` reduce each vector: on a DTensor
    panel one all-reduce for the k vectors (and for every pair ``dots`` is
    given, as XLA combines the reference's reductions), made whole at once
    so that nothing after it communicates. ``c`` broadcasts a per-vector
    scalar (k,) over its vector, ``keep`` freezes the vectors whose flag is
    off in every state entry it is given (panels and per-vector scalars)."""

    def __init__(self, op, rows: bool):
        self.op, self.rows, self.axis = op, rows, int(rows)

    def apply(self, P):
        return self.op.apply_matrix_t(P, "N") if self.rows else self.op.apply_matrix(P, "N")

    def dots(self, *pairs) -> tuple:
        d = [pcolumn_dot(U, V, dim=self.axis) for U, V in pairs]
        return tuple(comm._whole_sums(d[0] if len(d) == 1 else torch.stack(d)).reshape(
            len(d), -1).unbind(0))

    def dot(self, U, V):
        return self.dots((U, V))[0]

    def norm(self, P):
        return torch.linalg.vector_norm(P, dim=self.axis)

    def c(self, s):
        return s[:, None] if self.rows else s[None, :]

    def keep(self, act, new, old) -> tuple:
        return tuple(torch.where(act if b.ndim == 1 else self.c(act), a, b)
                     for a, b in zip(new, old))


def _panel_while(pn: _Panel, test, body, state: tuple, maxiter: int, consts: tuple, key,
                 block=None):
    """``body`` on the k vectors of a panel in one ``loop.device_while``, as
    ``jax.vmap`` of the vector solve's ``lax.while_loop`` runs it: each
    vector keeps its own recurrence and count, and freezes once its own
    ``test`` (a (k,) flag) fails or its count reaches ``maxiter``; the loop
    runs while any vector is active, in masked blocks of ``block``
    iterations (``loop.BLOCK`` when None). ``body(state, consts, j, act)``
    leaves the vectors whose ``act`` is off as they were (every iteration the
    loop's mask freezes has them all off, so the loop's own ``where`` is
    skipped). The state carries the per-vector count and flag. Returns
    (state, per-vector counts)."""
    act = comm.gather_full(test(state, consts))  # replicated: every rank holds it whole
    act = act & (maxiter > 0)
    count = torch.zeros(act.shape, dtype=torch.int64, device=act.device)

    def step(s, c, j):
        *s, count, act = s
        new = body(tuple(s), c, j, act)
        count = count + act.to(torch.int64)
        return (*new, count, act & test(new, c) & (count < maxiter))

    out, _ = loop.device_while(lambda s, c: s[-1].any(), step, (*state, count, act), maxiter,
                               consts=consts, ops=(pn.op,), key=key, block=block, keeps=True)
    return out[:-2], out[-2]


def _cg_panel(pn: _Panel, B, tol, maxiter):
    """``cg`` (no preconditioner, from 0) on each vector of B. A frozen
    vector's step sizes are 0, so its x and r keep their bits."""
    X = torch.zeros_like(B)
    R = B - pn.apply(X)
    rz = pn.dot(R, R)
    tol2 = (tol * pn.norm(B)) ** 2

    def body(state, consts, _, act):
        X, R, P, rz = state
        AP = pn.apply(P)
        alpha = pn.c(torch.where(act, rz / pn.dot(P, AP), 0.0))
        X = torch.addcmul(X, alpha, P)
        R = torch.addcmul(R, -alpha, AP)
        rz_new = pn.dot(R, R)  # also ‖r‖², with no preconditioner
        P = torch.addcmul(R, pn.c(torch.where(act, rz_new / rz, 0.0)), P)
        return X, R, P, torch.where(act, rz_new, rz)

    (X, _, _, rz), count = _panel_while(pn, lambda s, c: s[3].real > c[0], body, (X, R, R, rz),
                                        maxiter, (tol2,), ("cg_panel", pn.rows))
    return X, count, torch.sqrt(rz.real)


def _minres_panel(pn: _Panel, B, tol, maxiter):
    """``minres`` (no preconditioner, from 0) on each vector of B."""
    dt = B.dtype
    rdt = torch.empty((), dtype=dt).real.dtype
    eps = torch.finfo(rdt).eps
    X = torch.zeros_like(B)
    R1 = B - pn.apply(X)
    beta1 = torch.sqrt(torch.clamp_min(pn.dot(R1, R1).real, 0.0))
    tol_abs = tol * _nonzero(beta1)
    s0 = _MinresState(beta1, rdt)

    def body(state, consts, k, act):
        X, Y, R1, R2, W, W2, *scalars = state
        s = _MinresState.of(scalars)
        V = Y / pn.c(_nonzero(s.beta)).to(dt)
        Y, R1, R2, W, W2, phi = _minres_step(pn.apply, s, V, R1, R2, W, W2, k, dt, eps,
                                             lambda R: R, pn.dot, pn.c)
        return pn.keep(act, (X + phi * W, Y, R1, R2, W, W2, *s.fields()), state)

    init = (X, R1, R1, R1, torch.zeros_like(B), torch.zeros_like(B), *s0.fields())
    state, count = _panel_while(pn, lambda st, c: st[6 + _MinresState.PHIBAR] > c[0], body,
                                init, maxiter, (tol_abs,), ("minres_panel", pn.rows))
    return state[0], count, state[6 + _MinresState.PHIBAR]


def _bicgstab_panel(pn: _Panel, B, tol, maxiter):
    """``bicgstab`` (no preconditioner, from 0) on each vector of B, with
    its breakdown rule per vector: the last iterate stays."""
    rdt = torch.empty((), dtype=B.dtype).real.dtype
    tiny = torch.finfo(rdt).tiny ** 0.5
    X = torch.zeros_like(B)
    R = B - pn.apply(X)
    tol_abs = tol * _nonzero(pn.norm(B))
    one = torch.ones(tol_abs.shape, dtype=B.dtype, device=tol_abs.device)
    brk = torch.zeros(tol_abs.shape, dtype=torch.bool, device=tol_abs.device)

    def body(state, consts, _, act):
        X, R, P, V, rho, alpha, omega, brk = state
        rhat, _, one = consts
        rho_new = pn.dot(rhat, R)
        beta = (rho_new / rho) * (alpha / omega)
        P_new = R + pn.c(beta) * (P - pn.c(omega) * V)
        V_new = pn.apply(P_new)
        rhv = pn.dot(rhat, V_new)
        brk_new = (rho_new.abs() <= tiny) | (rhv.abs() <= tiny)
        alpha_new = rho_new / torch.where(brk_new, one, rhv)
        S = R - pn.c(alpha_new) * V_new
        T = pn.apply(S)
        tt, ts = pn.dots((T, T), (T, S))
        omega_new = ts / _nonzero(tt)
        brk_new = brk_new | (omega_new.abs() <= tiny)
        new = (X + pn.c(alpha_new) * P_new + pn.c(omega_new) * S, S - pn.c(omega_new) * T, P_new,
               V_new, rho_new, alpha_new, omega_new)
        # on a breakdown the vector keeps its last iterate (its test then fails)
        return (*pn.keep(act & ~brk_new, new, state[:7]), torch.where(act, brk_new, brk))

    def test(state, consts):
        return (pn.norm(state[1]) > consts[1]) & ~state[7]

    zero = torch.zeros_like(B)
    (X, R, *_), count = _panel_while(pn, test, body, (X, R, zero, zero, one, one, one, brk),
                                     maxiter, (R, tol_abs, one), ("bicgstab_panel", pn.rows))
    return X, count, pn.norm(R)


def _gmres_panel(pn: _Panel, B, tol, restart, maxiter):
    """``gmres`` (no preconditioner, from 0) on each vector of B: each
    restart runs the k Arnoldi cycles at once over one basis buffer (k, m +
    1, this rank's rows) written in place, and solves the k Hessenberg
    least-squares problems in one batched ``small_lstsq`` (one E2 launch per
    restart on the card). A vector's restarts stop once its own residual
    test fails; one restart a block, as ``GMRES_BLOCK``."""
    n = B.shape[pn.axis]
    dt = B.dtype
    m = min(restart, n)
    tol_abs = tol * _nonzero(pn.norm(B))
    R = _panel_rows(B, pn.rows)
    # the panel as (k, this rank's rows), and back
    local = (lambda P: R.local_t(P)) if pn.rows else (lambda P: R.local(P).T)
    whole = (lambda L: R.dtensor_t(L)) if pn.rows else (lambda L: R.dtensor(L.T))

    def body(state, consts, _, act):
        X, _ = state
        B = consts[0]
        V, H, beta = _arnoldi(lambda P: local(pn.apply(whole(P))), local(B - pn.apply(X)), R, m)
        e1 = torch.where(torch.arange(m + 1, device=B.device) == 0, beta[:, None].to(dt), 0.0)
        y = small_lstsq(H, e1)
        X = X + whole(pmatmul(V[:, :m].transpose(1, 2), y[:, :, None])[..., 0])
        return pn.keep(act, (X, pn.norm(B - pn.apply(X))), state)

    X = torch.zeros_like(B)
    (X, res), count = _panel_while(pn, lambda s, c: s[1] > c[1], body,
                                   (X, pn.norm(B - pn.apply(X))), maxiter, (B, tol_abs),
                                   ("gmres_panel", pn.rows, m), block=GMRES_BLOCK)
    return X, count, res


def _panel_rows(B, rows: bool):
    """``comm.Rows`` of a DTensor panel's vectors (a row panel's columns
    split as a column panel's rows are), the identity steps for a plain one."""
    if not comm.is_dtensor(B):
        return comm.rows_of(B)
    from torch.distributed.tensor import Shard

    vector = [Shard(0) if p.is_shard() else p for p in B.placements]
    return comm.Rows(layout=comm.Layout(B.device_mesh, vector), n=B.shape[int(rows)])


@comm.dtensor_entry(place=False)
def _solve_panel(name: str, op: LinearOperator, B, *, rows: bool = False, tol: float = 1e-8,
                maxiter: int = 100, restart: int = 30):
    """The solver ``name`` ("cg", "minres", "bicgstab", "gmres"; no
    preconditioner, from 0) on the k vectors of an (n, k) column panel B, or
    with ``rows`` of a (k, n) row panel, as one loop: what ``jax.vmap`` of
    the vector solve computes (each vector its own recurrence, tolerance
    and count, frozen once its own test fails), with the operator applied to
    the panel once per step (``apply_matrix``/``apply_matrix_t``). The
    iterative inverse's block apply. Returns (X, per-vector iterations
    (restarts for GMRES), per-vector residuals as the vector solve returns
    them). A plain panel given with a distributed operator is placed in the
    operator's layout first (a row panel split along its columns)."""
    if B.ndim != 2 or B.shape[int(rows)] != op.ncol:
        raise LinearOperatorException(
            f"_solve_panel: expected a {'(k, n)' if rows else '(n, k)'} panel with "
            f"n = {op.ncol}, got {tuple(B.shape)}")
    lay = comm.layout_of(op)
    if lay is not None and not comm.is_dtensor(B):
        from torch.distributed.tensor import Shard

        B = (comm.Layout(lay.mesh, [Shard(1) if p.is_shard() else p for p in lay.placements])
             if rows else lay).place(B)
    B = B.to(torch.promote_types(B.dtype, op.dtype))
    pn = _Panel(op, rows)
    if name == "gmres":
        return _gmres_panel(pn, B, tol, restart, maxiter)
    return {"cg": _cg_panel, "minres": _minres_panel, "bicgstab": _bicgstab_panel}[name](
        pn, B, tol, maxiter)


@comm.dtensor_entry
def lsqr(op: LinearOperator, b, *, damp: float = 0.0, tol: float = 1e-8, maxiter: int = 100):
    """LSQR (Paige–Saunders): min ‖Ax − b‖² + damp²‖x‖² for a general
    (rectangular) operator by Golub–Kahan bidiagonalization; it needs only
    the N and adjoint applies. Stops when the ‖Aᴴr‖ estimate ≤ tol·‖Aᴴb‖ or
    after ``maxiter`` iterations. Returns (x, iterations, ‖Aᴴr‖ estimate)."""
    b, dt, rdt, _ = _setup(op, b)
    dampf = torch.tensor(damp, dtype=rdt, device=b.device)

    def nrm(v):  # whole on DTensor vectors before it meets one
        return comm.made_whole(torch.linalg.vector_norm(v)).to(rdt)

    beta = nrm(b)
    u = b / _nonzero(beta).to(dt)
    v = op.apply(u, "H")
    alpha = nrm(v)
    v = v / _nonzero(alpha).to(dt)
    arnorm = alpha * beta  # ‖Aᴴb‖, the scale of the stopping test
    tol_abs = tol * _nonzero(arnorm)
    x = torch.zeros_like(v)  # in v's layout: x comes back split as the reference's

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
