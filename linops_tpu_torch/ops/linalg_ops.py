"""Factorization-backed operators and the iterative inverse.

Counterpart of ``linops_tpu/ops/linalg_ops.py``: ``opInverse`` solves afresh
on every apply; ``opCholesky`` and ``opLDL`` factor once at construction and
every apply is a pair of triangular solves; ``opHouseholder`` and
``opHermitian`` are matrix-free. ``opIterativeInverse`` runs an inner Krylov
solve (``utils/krylov.py``) per apply.

Matched on purpose: the Cholesky factor of a matrix that is not positive
definite is NaN, as ``jnp.linalg.cholesky`` leaves it (``cholesky_ex``
reports without a host read). ``opLDL`` factors with partial-pivoted LU, as
the reference does, which handles the same symmetric indefinite systems.

Matrices given as host data go to ``device=``, the CUDA device by default
(``device="cpu"`` for the CPU); a tensor keeps its device.
"""

from __future__ import annotations

import torch

from ..core.base import LinearOperator, LinearOperatorException, compose_modes, default_device
from ..core.precision import check_f32_exact, pmatmul, pvdot

__all__ = [
    "InverseOperator",
    "IterativeInverseOperator",
    "CholeskyOperator",
    "LDLOperator",
    "HouseholderOperator",
    "HermitianOperator",
    "opInverse",
    "opIterativeInverse",
    "opCholesky",
    "opLDL",
    "opHouseholder",
    "opHermitian",
]


def _tensor(M, device, what):
    if isinstance(M, torch.Tensor) and device is None:
        return M
    return torch.as_tensor(M, device=default_device(device, what))


def _square(M, what):
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise LinearOperatorException(f"{what} requires a square matrix")
    return M


def _cols(b):
    """(b as a column block, undo): the solvers take (n, k) right-hand sides."""
    if b.ndim == 1:
        return b[:, None], lambda x: x[:, 0]
    return b, lambda x: x


def _conj(x):
    return x.conj() if x.is_complex() else x


class InverseOperator(LinearOperator):
    """``M⁻¹`` as an operator; each apply solves with M."""

    _fields_tensors = ("M",)
    _fields_static = ("_symmetric", "_hermitian")

    def __init__(self, M, *, symmetric: bool = False, hermitian: bool = False, device=None):
        super().__init__()
        self.M = _square(_tensor(M, device, "opInverse"), "opInverse")
        self._symmetric = bool(symmetric)
        self._hermitian = bool(hermitian)

    @property
    def nrow(self):
        return self.M.shape[0]

    @property
    def ncol(self):
        return self.M.shape[1]

    @property
    def dtype(self):
        return self.M.dtype

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return self._hermitian

    def _solve(self, A, b):
        check_f32_exact(A, b)
        dt = torch.promote_types(A.dtype, b.dtype)
        return torch.linalg.solve(A.to(dt), b.to(dt))

    def _prod(self, v):
        return self._solve(self.M, v)

    def _tprod(self, u):
        return self._solve(self.M.T, u)

    def _ctprod(self, w):
        return self._solve(_conj(self.M).T, w)

    def apply_matrix(self, M, mode: str = "N"):
        if mode == "N":
            return self._solve(self.M, M)
        if mode == "T":
            return self._solve(self.M.T, M)
        if mode == "H":
            return self._solve(_conj(self.M).T, M)
        return _conj(self._solve(self.M, _conj(M)))

    def _name(self):
        return "Inverse operator"


class _FactoredInverse(LinearOperator):
    """Shared by the Cholesky and LDL inverses: hermitian by construction,
    symmetric for real data; T goes through conj(M⁻¹ conj(u))."""

    _fields_static = ("_symmetric",)

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        return self._solve(v)

    def _ctprod(self, w):
        return self._solve(w)

    def _tprod(self, u):
        if self._symmetric:
            return self._solve(u)
        return _conj(self._solve(_conj(u)))

    def apply_matrix(self, M, mode: str = "N"):
        if mode in ("N", "H") or (mode == "T" and self._symmetric):
            return self._solve(M)
        return _conj(self._solve(_conj(M)))


class CholeskyOperator(_FactoredInverse):
    """Inverse of a hermitian positive-definite matrix through its Cholesky
    factor, computed once. A matrix that is not positive definite leaves a
    NaN factor (and NaN applies), as the reference's does."""

    _fields_tensors = ("L",)

    def __init__(self, M, *, check: bool = False, device=None):
        super().__init__()
        M = _square(_tensor(M, device, "opCholesky"), "opCholesky")
        if check:
            from ..utils.checks import check_hermitian, check_positive_definite

            if not check_hermitian(M):
                raise LinearOperatorException("matrix is not Hermitian")
            if not check_positive_definite(M):
                raise LinearOperatorException("matrix is not positive definite")
        L, info = torch.linalg.cholesky_ex(M)
        self.L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
        self._symmetric = not M.is_complex()

    @property
    def nrow(self):
        return self.L.shape[0]

    @property
    def ncol(self):
        return self.L.shape[0]

    @property
    def dtype(self):
        return self.L.dtype

    def _solve(self, b):
        B, back = _cols(b)
        check_f32_exact(self.L, B)
        dt = torch.promote_types(self.L.dtype, B.dtype)
        return back(torch.cholesky_solve(B.to(dt), self.L.to(dt), upper=False))

    def _name(self):
        return "Cholesky inverse operator"


class LDLOperator(_FactoredInverse):
    """Inverse of a symmetric (possibly indefinite) matrix, factored once
    with partial-pivoted LU (``torch.linalg.lu_factor``), as the reference
    factors it."""

    _fields_tensors = ("lu", "piv")

    def __init__(self, M, *, check: bool = False, device=None):
        super().__init__()
        M = _square(_tensor(M, device, "opLDL"), "opLDL")
        if check:
            from ..utils.checks import check_hermitian

            if not check_hermitian(M):
                raise LinearOperatorException("matrix is not Hermitian")
        self.lu, self.piv = torch.linalg.lu_factor(M)
        self._symmetric = not M.is_complex()

    @property
    def nrow(self):
        return self.lu.shape[0]

    @property
    def ncol(self):
        return self.lu.shape[0]

    @property
    def dtype(self):
        return self.lu.dtype

    def _solve(self, b):
        B, back = _cols(b)
        check_f32_exact(self.lu, B)
        dt = torch.promote_types(self.lu.dtype, B.dtype)
        return back(torch.linalg.lu_solve(self.lu.to(dt), self.piv, B.to(dt)))

    def _name(self):
        return "LDL inverse operator"


class HouseholderOperator(LinearOperator):
    """``x -> (I - 2 h hᴴ) x``, a self-adjoint reflector."""

    _fields_tensors = ("h",)
    _fields_static = ()

    def __init__(self, h, *, device=None):
        super().__init__()
        h = _tensor(h, device, "opHouseholder")
        if h.ndim != 1:
            raise LinearOperatorException("opHouseholder requires a vector")
        self.h = h

    @property
    def nrow(self):
        return self.h.shape[0]

    @property
    def ncol(self):
        return self.h.shape[0]

    @property
    def dtype(self):
        return self.h.dtype

    @property
    def symmetric(self):
        return not self.h.is_complex()

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        return v - 2.0 * pvdot(self.h, v) * self.h

    def _ctprod(self, w):
        return self._prod(w)

    def apply_matrix(self, M, mode: str = "N"):
        h = self.h
        if mode in ("N", "H"):
            return M - 2.0 * pmatmul(h[:, None], pmatmul(_conj(h)[None, :], M))
        return super().apply_matrix(M, mode)

    def _name(self):
        return "Householder operator"


class HermitianOperator(LinearOperator):
    """Hermitian operator from a diagonal ``d`` and the strict lower
    triangle L of ``A``: ``y = d ⊙ v + L v + Lᴴ v``."""

    _fields_tensors = ("d", "L")
    _fields_static = ("_symmetric",)

    def __init__(self, d, A=None, *, device=None):
        super().__init__()
        if A is None:
            A = _tensor(d, device, "opHermitian")
            d = torch.diagonal(A)
        A = _tensor(A, device, "opHermitian")
        d = _tensor(d, device, "opHermitian").to(A.device)
        if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] != d.shape[0]:
            raise LinearOperatorException("shape mismatch")
        self.d = d
        self.L = torch.tril(A, -1)
        self._symmetric = not (A.is_complex() or d.is_complex())

    @property
    def nrow(self):
        return self.d.shape[0]

    @property
    def ncol(self):
        return self.d.shape[0]

    @property
    def dtype(self):
        return torch.promote_types(self.d.dtype, self.L.dtype)

    @property
    def symmetric(self):
        return self._symmetric

    @property
    def hermitian(self):
        return True

    def _prod(self, v):
        L = self.L
        lv = pmatmul(L, v)
        if L.is_complex() or v.is_complex():
            lhv = pmatmul(_conj(v), L).conj()  # Lᴴ v without forming Lᴴ
        else:
            lhv = pmatmul(v, L)
        return self.d * v + lv + lhv

    def apply_matrix(self, M, mode: str = "N"):
        L = self.L
        if mode in ("N", "H"):
            return self.d[:, None] * M + pmatmul(L, M) + pmatmul(_conj(L).T, M)
        Mc = _conj(M)
        return _conj(self.d[:, None] * Mc + pmatmul(L, Mc) + pmatmul(_conj(L).T, Mc))

    def _name(self):
        return "Hermitian operator"


def opInverse(M, *, symm: bool = False, herm: bool = False, device=None):
    return InverseOperator(M, symmetric=symm, hermitian=herm, device=device)


def opCholesky(M, check: bool = False, *, device=None):
    return CholeskyOperator(M, check=check, device=device)


def opLDL(M, check: bool = False, *, device=None):
    return LDLOperator(M, check=check, device=device)


def opHouseholder(h, *, device=None):
    return HouseholderOperator(h, device=device)


def opHermitian(d, A=None, *, device=None):
    return HermitianOperator(d, A, device=device)


def _op_tensors(x, out):
    """Every tensor an operator graph holds (the implicit backward's
    candidates for operator-data gradients)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, LinearOperator):
        for f in type(x)._fields_tensors:
            _op_tensors(getattr(x, f), out)
    elif isinstance(x, tuple):
        for v in x:
            _op_tensors(v, out)
    return out


class _ImplicitSolve(torch.autograd.Function):
    """``x = A_mode⁻¹ v`` by the inner Krylov solve, differentiated
    implicitly (the reference's rule, ``linops_tpu/ops/linalg_ops.py:522-534``,
    in torch's conjugate-Wirtinger convention): the v-gradient is one more
    solve, ``w = A_{H∘mode}⁻¹ g``, and the operator tensors' gradient is the
    pullback of one apply ``A_mode(tensors) x`` against ``−w``. The inner
    loop itself is never differentiated. For a panel (``panel`` False for
    columns, True for rows; None for a vector) both are panel forms: the
    backward is one panel solve, and the pullback is that of one panel apply,
    summed over the vectors, as ``jax.grad`` gives it through the
    reference's vmapped ``custom_vjp``."""

    @staticmethod
    def forward(node, v, mode, panel, *tensors):
        return node._solve(v, mode, panel)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        node, _, mode, panel, *tensors = inputs
        ctx.node, ctx.mode, ctx.panel, ctx.tensors = node, mode, panel, tensors
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        node, mode, panel = ctx.node, ctx.mode, ctx.panel
        w = node._solve(g, compose_modes("H", mode), panel)[0]
        needs = ctx.needs_input_grad[4:]
        d_tensors = [None] * len(needs)
        wanted = [t for t, need in zip(ctx.tensors, needs) if need]
        if wanted:
            inner = node._inner(mode)
            with torch.enable_grad():
                y = (inner.apply(x.detach(), "N") if panel is None else
                     inner.apply_matrix_t(x.detach(), "N") if panel else
                     inner.apply_matrix(x.detach(), "N"))
                grads = iter(torch.autograd.grad(y, wanted, -w, allow_unused=True))
            d_tensors = [next(grads) if need else None for need in needs]
        return (None, w if ctx.needs_input_grad[1] else None, None, None, *d_tensors)


class IterativeInverseOperator(LinearOperator):
    """``op⁻¹`` for any square operator: each apply runs an inner Krylov
    solve (``utils/krylov.py``) on the operator's device.

    ``solver``: ``"auto"`` picks ``minres`` for flagged-hermitian operators
    and ``gmres`` otherwise; ``"cg"`` and ``"bicgstab"`` are opt-ins.
    ``maxiter`` is a total inner-iteration budget (split into restart
    cycles for gmres). Non-convergence is silent by design (an inexact
    inverse is still a preconditioner); ``solve_info`` returns the inner
    solve's iterations and residual.

    Gradients, as in the reference, come from implicit differentiation
    (``_ImplicitSolve``): with respect to v one more inner solve, with
    respect to the wrapped operator's tensors the pullback of one apply. The
    inner loop runs without autograd.

    Inside an outer solve the inner loop runs as the reference nests its
    ``lax.while_loop``: in the outer solver's masked blocks on the CPU (in a
    frozen outer iteration it runs no iteration), and on the card as one
    CUDA while node inside the outer solver's captured block
    (``utils/loop.py``), so the whole nested solve replays with one host read
    per outer block. Every inner solver runs on ``loop.device_while`` (GMRES,
    ``"auto"`` on a non-hermitian operator, one restart a block: Arnoldi, its
    least-squares step on the card by E2, the residual), so this holds
    whenever the wrapped operator is capture-safe (``capture_safe``).
    ``inner_iterations`` sums the inner iterations of every apply (GMRES:
    restarts) since ``reset_inner_iterations()`` (a 0-dim counter on the
    operator's device that each apply, captured or not, adds into, read when
    asked).

    A block (``apply_matrix`` of an (n, k) column panel, ``apply_matrix_t``
    of a (k, n) row panel) is one panel solve, as the reference's
    ``apply_matrix``, a ``jax.vmap`` of the vector apply, is one batched
    inner loop (``utils/krylov.py::_solve_panel``): every vector keeps its
    own tolerance, count and budget and freezes once its own test fails, the
    loop runs while any vector is active, and the operator is applied to the
    whole panel at each step. So a block apply is one inner loop whatever k
    is (one while node inside a captured outer block; for GMRES one E2
    launch per restart for the k Hessenbergs), and each vector is its
    vector apply within rounding. ``inner_iterations`` adds the vectors'
    counts, as k vector applies would. There is no column loop to fall back
    to: a block apply that cannot run as one panel solve raises.
    """

    _fields_tensors = ("op",)
    _fields_static = ("_tol", "_maxiter", "_solver")
    _fields_written = ("_iters",)  # every apply adds its inner iterations into it

    _SOLVERS = ("auto", "cg", "minres", "bicgstab", "gmres")

    def __init__(self, op, *, tol: float = 1e-8, maxiter: int = 100, solver: str = "auto"):
        super().__init__()
        if not isinstance(op, LinearOperator):
            from ..core.dense import aslinearoperator

            op = aslinearoperator(op)
        if op.nrow != op.ncol:
            raise LinearOperatorException("opIterativeInverse requires a square operator")
        if solver not in self._SOLVERS:
            raise ValueError(f"solver must be one of {self._SOLVERS}")
        self.op = op
        self._tol = float(tol)
        self._maxiter = int(maxiter)
        self._solver = solver
        self._iters = torch.zeros((), dtype=torch.int64, device=op.device or "cpu")

    def _resolved(self, inner) -> str:
        if self._solver == "auto":
            return "minres" if inner.hermitian else "gmres"
        return self._solver

    @property
    def inner_iterations(self) -> int:
        """Inner iterations summed over every apply since the last
        ``reset_inner_iterations()`` (one host read)."""
        return int(self._iters)

    def reset_inner_iterations(self) -> None:
        self._iters.zero_()  # in place: a captured block adds into it

    def _tally(self, k, device) -> None:
        """Add one apply's inner iterations (a number, or inside a capture a
        0-dim count on the device) into the counter on the device. A
        tensorless operator's counter moves to the device of its first
        apply, which is eager: a signature's first solve never captures."""
        from ..utils import loop

        if isinstance(k, torch.Tensor) and loop._batched(k):
            return  # under vmap: per-member counts, not summed
        if self._iters.device != device:
            self._iters = self._iters.to(device)
        self._iters.add_(k)

    def to(self, device) -> "IterativeInverseOperator":
        new = super().to(device)
        new._iters = torch.zeros((), dtype=torch.int64, device=device)  # its own count
        return new

    @property
    def nrow(self):
        return self.op.nrow

    @property
    def ncol(self):
        return self.op.nrow

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def symmetric(self):
        return self.op.symmetric

    @property
    def hermitian(self):
        return self.op.hermitian

    def _inner(self, mode: str):
        from ..core.adjoint import adjoint, conj, transpose

        return {"N": lambda: self.op, "T": lambda: transpose(self.op),
                "H": lambda: adjoint(self.op), "C": lambda: conj(self.op)}[mode]()

    def solve_info(self, v, mode: str = "N"):
        """The inner solve with its diagnostics: ``(x, iterations, final
        residual norm)``."""
        return self._solve(v, mode, None)

    def _solve(self, v, mode: str, panel):
        """The inner solve of a vector (``panel`` None), or the panel solve
        of an (n, k) column panel (False) or a (k, n) row panel (True), with
        its diagnostics (per vector for a panel)."""
        from ..utils import krylov

        inner = self._inner(mode)
        name = self._resolved(inner)
        kw = dict(tol=self._tol, maxiter=self._maxiter)
        if name == "gmres":
            restart = max(1, min(30, self._maxiter))
            kw = dict(tol=self._tol, restart=restart, maxiter=max(1, self._maxiter // restart))
        with torch.no_grad():
            if panel is None:
                out = getattr(krylov, name)(inner, v, **kw)
            else:
                out = krylov._solve_panel(name, inner, v, rows=panel, **kw)
        self._tally(out[1] if panel is None else out[1].sum(), out[0].device)
        return out

    def _apply(self, v, mode: str, panel):
        if torch.is_grad_enabled():
            # each tensor once, however often the graph holds it
            needs = list({id(t): t for t in _op_tensors(self.op, []) if t.requires_grad}.values())
            if needs or v.requires_grad:
                return _ImplicitSolve.apply(self, v, mode, panel, *needs)
        return self._solve(v, mode, panel)[0]

    def apply(self, v, mode: str = "N"):
        return self._apply(v, mode, None)

    def apply_matrix(self, M, mode: str = "N"):
        """One panel solve for the k columns of M (the class docstring)."""
        return self._apply(M, mode, False)

    def apply_matrix_t(self, Mt, mode: str = "N"):
        """One panel solve for the k rows of Mt, kept as rows."""
        return self._apply(Mt, mode, True)

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return f"IterativeInverse({self._solver}, tol={self._tol}) of"


def opIterativeInverse(op, *, tol: float = 1e-8, maxiter: int = 100, solver: str = "auto"):
    return IterativeInverseOperator(op, tol=tol, maxiter=maxiter, solver=solver)
