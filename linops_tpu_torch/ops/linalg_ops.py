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

from ..core.base import LinearOperator, LinearOperatorException, default_device
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
    """Every tensor an operator graph holds (for the backward guard)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, LinearOperator):
        for f in type(x)._fields_tensors:
            _op_tensors(getattr(x, f), out)
    elif isinstance(x, tuple):
        for v in x:
            _op_tensors(v, out)
    return out


class _NoImplicitBackward(torch.autograd.Function):
    """Passes the inner solve's result through; a backward raises."""

    @staticmethod
    def forward(ctx, x, *inputs):
        return x.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "IterativeInverseOperator has no backward yet: its implicit "
            "differentiation arrives with the port's AD slice (core/ad.py); "
            "the inner Krylov loop is not differentiated")


class IterativeInverseOperator(LinearOperator):
    """``op⁻¹`` for any square operator: each apply runs an inner Krylov
    solve (``utils/krylov.py``) on the operator's device.

    ``solver``: ``"auto"`` picks ``minres`` for flagged-hermitian operators
    and ``gmres`` otherwise; ``"cg"`` and ``"bicgstab"`` are opt-ins.
    ``maxiter`` is a total inner-iteration budget (split into restart
    cycles for gmres). Non-convergence is silent by design (an inexact
    inverse is still a preconditioner); ``solve_info`` returns the inner
    solve's iterations and residual.

    Forward only for now: the reference differentiates the solve
    implicitly; here the inner loop runs without autograd, and a backward
    through the result raises ``NotImplementedError`` until the AD slice.
    """

    _fields_tensors = ("op",)
    _fields_static = ("_tol", "_maxiter", "_solver")

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
        from ..utils import krylov

        inner = self._inner(mode)
        name = self._solver
        if name == "auto":
            name = "minres" if inner.hermitian else "gmres"
        with torch.no_grad():
            if name == "gmres":
                restart = max(1, min(30, self._maxiter))
                return krylov.gmres(inner, v, tol=self._tol, restart=restart,
                                    maxiter=max(1, self._maxiter // restart))
            return getattr(krylov, name)(inner, v, tol=self._tol, maxiter=self._maxiter)

    def apply(self, v, mode: str = "N"):
        x = self.solve_info(v, mode)[0]
        if torch.is_grad_enabled():
            needs = [t for t in _op_tensors(self.op, [v]) if t.requires_grad]
            if needs:
                x = _NoImplicitBackward.apply(x, *needs)
        return x

    def _has_tprod(self):
        return True

    def _has_ctprod(self):
        return True

    def _name(self):
        return f"IterativeInverse({self._solver}, tol={self._tol}) of"


def opIterativeInverse(op, *, tol: float = 1e-8, maxiter: int = 100, solver: str = "auto"):
    return IterativeInverseOperator(op, tol=tol, maxiter=maxiter, solver=solver)
