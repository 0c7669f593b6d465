"""Limited-memory SR1 operator with ring-buffer state, in PyTorch.

Counterpart of ``linops_tpu/qn/lsr1.py``; the state, the applies and the
push compute what the reference computes.

- The compact form is the hot apply: ``B = I/γ + U M⁻¹ Uᵀ`` with
  ``U = Y − S/γ`` (oldest → newest) and ``M = D + L + Lᵀ − SᵀS/γ`` from the
  Gram pieces SᵀY and SᵀS, which every push updates by one row and column;
  ``M⁻¹`` (``Minv``) is derived state, refreshed by every push, so an apply
  runs no factorization.
- The a-form ``B v = v/γ + Σ aᵢ(aᵢᵀv)/⟨aᵢ,sᵢ⟩`` is the parity path and
  serves ``diag`` and the norm bound. With ``lazy_a=True`` (the default) a
  push skips its O(mem²·n) recompute (``_recompute_all_a``, a host loop over
  the slots) until ``diag``, ``opnorm_upper_bound``, ``ensure_a`` or a save
  asks for it; any state swap marks the a-vectors stale.
- The acceptance test is the reference's: well-definedness
  ``|⟨y−Bs, s⟩| ≥ ε(1 + ‖y−Bs‖‖s‖)``, and with ``scaling`` sufficient
  curvature and the scaling condition. A rejected push rewrites its slot's
  values (a ``torch.where``), so a push never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.base import LinearOperator, LinearOperatorException, default_device
from ..core.precision import pdot, pmatmul
from ..parallel import comm
from .lbfgs import _elem, _oldest_first, _row, _set_col, _set_row, _where0

__all__ = ["LSR1State", "LSR1Operator", "lsr1_apply", "lsr1_apply_compact", "lsr1_diag"]


class LSR1State(NamedTuple):
    """The L-SR1 memory; field order and shapes are the reference's, so a
    state crosses field by field. Ring indices are 0-based."""

    S: torch.Tensor  # (mem, n)
    Y: torch.Tensor  # (mem, n)
    ys: torch.Tensor  # (mem,) curvature; 0 marks an empty slot
    A: torch.Tensor  # (mem, n) rank-1 vectors aᵢ = yᵢ − B₍ᵢ₋₁₎sᵢ
    as_: torch.Tensor  # (mem,) ⟨aᵢ, sᵢ⟩
    SY: torch.Tensor  # (mem, mem) Gram SᵀY (slot order)
    SS: torch.Tensor  # (mem, mem) Gram SᵀS
    gamma: torch.Tensor  # () scaling factor
    insert: torch.Tensor  # () int32 next ring slot
    opnorm_ub: torch.Tensor  # () upper bound on ‖B‖₂ (a-form)
    Minv: torch.Tensor  # (mem, mem) inverse of the compact middle M (oldest → newest)


def _init_state(n: int, mem: int, dtype, device) -> LSR1State:
    kw = dict(dtype=dtype, device=device)
    return LSR1State(
        S=torch.zeros((mem, n), **kw), Y=torch.zeros((mem, n), **kw),
        ys=torch.zeros((mem,), **kw), A=torch.zeros((mem, n), **kw),
        as_=torch.zeros((mem,), **kw), SY=torch.zeros((mem, mem), **kw),
        SS=torch.zeros((mem, mem), **kw), gamma=torch.ones((), **kw),
        insert=torch.zeros((), dtype=torch.int32, device=device),
        opnorm_ub=torch.ones((), **kw), Minv=torch.eye(mem, **kw))


def _safe_div(num, den):
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _col(x, X):
    """A per-slot vector shaped to broadcast against ``A @ X``."""
    return x if X.dim() == 1 else x[:, None]


def lsr1_apply(state: LSR1State, x):
    """a-form: B v = v/γ + Aᵀ((A v)/as), empty slots masked out; ``x`` a
    vector or an (n, k) block."""
    coef = _where0(_col(state.ys != 0, x), _safe_div(pmatmul(state.A, x), _col(state.as_, x)))
    return x / state.gamma + pmatmul(state.A.T, coef)


def _compact_M(state: LSR1State):
    """The middle M = D + L + Lᵀ − SᵀS/γ (Byrd-Nocedal-Schnabel 1994,
    thm 5.1), oldest → newest, with a unit diagonal on empty slots; plus
    (order, valid)."""
    order = _oldest_first(state)
    valid = state.ys[order] != 0
    vmask2 = valid[:, None] & valid[None, :]
    SY_o = _where0(vmask2, state.SY[order][:, order])
    SS_o = _where0(vmask2, state.SS[order][:, order])
    L = torch.tril(SY_o, diagonal=-1)
    M = torch.diag(torch.diagonal(SY_o)) + L + L.T - SS_o / state.gamma
    M = _where0(vmask2, M) + torch.diag(torch.where(valid, 0.0, 1.0).to(M.dtype))
    return M, order, valid


def _compact_minv(state: LSR1State):
    """The push-time inverse of the compact middle, empty slots zeroed."""
    M, _, valid = _compact_M(state)
    return _where0(valid[:, None] & valid[None, :], comm.on_whole(torch.linalg.inv, M))


def lsr1_apply_compact(state: LSR1State, x):
    """Compact product B v = v/γ + Uᵀ M⁻¹ (U v): equal to the a-form on
    accepted pairs, with no a-vectors; ``x`` a vector or an (n, k) block.
    U = Y − S/γ (oldest → newest, empty slots zeroed) is never built: U v
    comes from S v and Y v, and Uᵀc from Sᵀc' and Yᵀc' with c' the
    coefficients in slot order, so an apply reads S and Y twice each."""
    order = _oldest_first(state)
    valid = _col(state.ys[order] != 0, x)
    Ux = _where0(valid, pmatmul(state.Y, x)[order] - pmatmul(state.S, x)[order] / state.gamma)
    coef = pmatmul(state.Minv, Ux)  # zero on empty slots: Minv's rows there are zero
    c_slot = torch.zeros_like(coef).index_copy(0, order, coef)
    return x / state.gamma + pmatmul(state.Y.T, c_slot) - pmatmul(state.S.T, c_slot) / state.gamma


def lsr1_diag(state: LSR1State):
    """diag(B) = 1/γ + Σ aᵢ²/⟨aᵢ,sᵢ⟩ over the a-form."""
    coef = _where0(state.ys != 0, _safe_div(torch.ones_like(state.as_), state.as_))
    return 1.0 / state.gamma + pmatmul(coef, state.A ** 2)


def _push(state: LSR1State, s, y, *, scaling: bool, with_a: bool = True) -> LSR1State:
    """Guarded SR1 push. ``with_a=False`` maintains S, Y and the Grams only
    (O(mem·n)) and leaves the a-vectors to ``_recompute_all_a``; acceptance
    then reads the compact Bs."""
    mem = state.S.shape[0]
    eps = torch.finfo(state.S.dtype).eps
    Bs = lsr1_apply(state, s) if with_a else lsr1_apply_compact(state, s)
    ymBs = y - Bs
    ys = pdot(y, s)
    s_norm = torch.linalg.vector_norm(s)
    yy = pdot(y, y)
    accept = torch.abs(pdot(ymBs, s)) >= eps + eps * torch.linalg.vector_norm(ymBs) * s_norm
    if scaling:
        y_norm = torch.sqrt(yy)
        sufficient_curvature = torch.abs(ys) >= eps * y_norm * s_norm
        gamma_new = _safe_div(ys, yy)
        resid = torch.linalg.vector_norm(y - _safe_div(s, gamma_new))
        accept = accept & sufficient_curvature & (resid >= eps * y_norm * s_norm)

    ins = state.insert
    # a rejected push rewrites the slot's existing values
    s = torch.where(accept, s, _row(state.S, ins))
    y = torch.where(accept, y, _row(state.Y, ins))
    S = _set_row(state.S, ins, s)
    Y = _set_row(state.Y, ins, y)
    ysv = _set_row(state.ys, ins, torch.where(accept, ys, _elem(state.ys, ins)))
    gamma = torch.where(accept, gamma_new, state.gamma) if scaling else state.gamma
    ins_new = torch.where(accept, torch.remainder(ins + 1, mem), ins).to(torch.int32)

    # one row and column each of SᵀY and SᵀS (idempotent when rejected)
    SY = _set_col(_set_row(state.SY, ins, pmatmul(Y, s)), ins, pmatmul(S, y))
    ss_vec = pmatmul(S, s)
    SS = _set_col(_set_row(state.SS, ins, ss_vec), ins, ss_vec)

    new = LSR1State(S=S, Y=Y, ys=ysv, A=state.A, as_=state.as_, SY=SY, SS=SS, gamma=gamma,
                    insert=ins_new, opnorm_ub=state.opnorm_ub, Minv=state.Minv)
    new = new._replace(Minv=_compact_minv(new))
    if with_a:
        new = _recompute_all_a(new)
    return new


def _recompute_all_a(state: LSR1State) -> LSR1State:
    """Every rank-1 a-vector and the norm bound from (S, Y, ys, γ), oldest
    → newest: a host loop of mem steps, each two (mem, n) mat-vecs."""
    mem = state.S.shape[0]
    order = _oldest_first(state)
    S_ord, Y_ord = state.S[order], state.Y[order]
    valid = state.ys[order] != 0
    gamma = state.gamma
    idx = torch.arange(mem, device=order.device)
    A_ord = torch.zeros_like(S_ord)
    as_ord = torch.zeros_like(state.ys)
    for i in range(mem):
        s_i = S_ord[i]
        a = Y_ord[i] - s_i / gamma
        coef = _where0((idx < i) & valid, _safe_div(pmatmul(A_ord, s_i), as_ord))
        a = a - pmatmul(A_ord.T, coef)
        a = _where0(valid[i], a)
        A_ord = A_ord.clone()
        A_ord[i] = a
        as_ord = as_ord.clone()
        as_ord[i] = pdot(a, s_i)
    A_new = torch.zeros_like(A_ord).index_copy(0, order, A_ord)
    as_new = torch.zeros_like(as_ord).index_copy(0, order, as_ord)
    ub = torch.where(gamma != 0, 1.0 / torch.abs(torch.where(gamma != 0, gamma,
                                                             torch.ones_like(gamma))),
                     torch.ones_like(gamma))
    contrib = _where0(valid & (as_ord != 0),
                      _safe_div(torch.sum(A_ord ** 2, dim=1), torch.abs(as_ord)))
    return state._replace(A=A_new, as_=as_new, opnorm_ub=ub + torch.sum(contrib))


class LSR1Operator(LinearOperator):
    """Limited-memory SR1 approximation, forward form. Symmetric but in
    general indefinite.

    ``LSR1Operator(n, mem=5, scaling=False, lazy_a=True, device=None)`` or
    ``LSR1Operator(dtype, n, ...)`` (f64 by default). The state lives on
    ``device``: the CUDA device by default, ``device="cpu"`` for the CPU.
    Every ``push``/``reset`` swaps ``self.state`` for a new state."""

    _fields_tensors = ("state",)
    _fields_static = ("_n", "_mem", "_scaling", "_dtype", "_lazy_a")
    _fields_state = ("state",)  # a push or reset swaps in a new state

    def __init__(self, *args, mem: int = 5, scaling: bool = False, dtype=None,
                 lazy_a: bool = True, device=None):
        super().__init__()
        if len(args) == 2:
            dt, n = args
        elif len(args) == 1:
            dt, n = (dtype if dtype is not None else torch.float64), args[0]
        else:
            raise TypeError("LSR1Operator(n) or LSR1Operator(dtype, n)")
        if dt.is_complex:
            raise LinearOperatorException(
                "complex L-SR1 is not supported: the acceptance tests assume "
                "real inner products")
        self._n = int(n)
        self._mem = max(int(mem), 1)
        self._scaling = bool(scaling)
        self._dtype = dt
        self._lazy_a = bool(lazy_a)
        self.state = _init_state(self._n, self._mem, dt,
                                 default_device(device, type(self).__name__))
        object.__setattr__(self, "_a_fresh", True)  # empty memory is fresh

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "state":
            # any state swap (push, restore, user assignment) makes the
            # a-vectors stale; internal paths re-mark freshness after
            object.__setattr__(self, "_a_fresh", False)

    def _materialized_state(self) -> LSR1State:
        """State with fresh a-vectors, recomputed and kept when stale."""
        if getattr(self, "_a_fresh", False):
            return self.state
        self.state = _recompute_all_a(self.state)
        object.__setattr__(self, "_a_fresh", True)
        return self.state

    def ensure_a(self) -> "LSR1Operator":
        """Materialize the a-form if lazy pushes deferred it."""
        self._materialized_state()
        return self

    def _before_save(self):
        self.ensure_a()

    @property
    def nrow(self):
        return self._n

    @property
    def ncol(self):
        return self._n

    @property
    def dtype(self):
        return self._dtype

    @property
    def symmetric(self):
        return True

    @property
    def hermitian(self):
        return True

    @property
    def mem(self):
        return self._mem

    @property
    def scaling(self):
        return self._scaling

    @property
    def insert(self) -> int:
        return int(self.state.insert)

    @property
    def scaling_factor(self) -> float:
        return float(self.state.gamma)

    @property
    def opnorm_upper_bound(self) -> float:
        return float(self._materialized_state().opnorm_ub)

    def _prod(self, v):
        return lsr1_apply_compact(self.state, v)

    def apply_matrix(self, M, mode: str = "N"):
        # symmetric and real: every mode is the forward product
        return lsr1_apply_compact(self.state, M)

    @comm.dtensor_entry
    def push(self, s, y):
        """Guarded SR1 insert; silently rejects a pair that fails the
        well-definedness, curvature or scaling conditions. DTensor pairs
        push into a sharded operator's state, which keeps its placements."""
        dt, dev = self._dtype, self.state.S.device
        s = torch.as_tensor(s, dtype=dt, device=dev)
        y = torch.as_tensor(y, dtype=dt, device=dev)
        # an eager push's acceptance reads the a-form: materialize first
        base = self.state if self._lazy_a else self._materialized_state()
        new = _push(base, s, y, scaling=self._scaling, with_a=not self._lazy_a)
        self.state = comm.keep_placements(new, base) if comm.is_dtensor(base.S) else new
        if not self._lazy_a:
            object.__setattr__(self, "_a_fresh", True)
        return self

    def diag(self):
        return lsr1_diag(self._materialized_state())

    def reset(self):
        """Zero the memory and counters."""
        self.state = _init_state(self._n, self._mem, self._dtype, self.state.S.device)
        object.__setattr__(self, "_a_fresh", True)
        self.reset_counters()
        return self

    def _name(self):
        return "LSR1 operator"
