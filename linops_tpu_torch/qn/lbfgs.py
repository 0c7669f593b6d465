"""Limited-memory BFGS operators with ring-buffer state, in PyTorch.

Counterpart of ``linops_tpu/qn/lbfgs.py``; the state, the applies and the
pushes compute what the reference computes:

- The {s, y} memory is stacked ``(mem, n)`` tensors in an ``LBFGSState``
  NamedTuple. Updates are out of place: a push returns a new state, as in
  the reference. The ring insert position is a 0-dim int32 tensor on the
  state's device, and the curvature gate is a ``torch.where``, so a push
  never waits for the device.
- The hot applies are the compact (Byrd–Nocedal–Schnabel) forms: two
  ``(2mem, n)`` passes plus one ``(2mem)²`` mat-vec with the middle matrix
  ``G`` that every push refreshes for both forms.
- The two-loop recursion (``inverse_apply``) and the a/b forward form
  (``forward_apply``) are kept as parity paths.
- Empty slots have ys = 0 and drop out by masking.

Semantics: curvature rejection ys ≤ eps, Powell damping with σ₂/σ₃ for
both forms, scaling γ = ys/yᵀy, the tracked operator-norm upper bound,
forward-only ``diag``, ``reset``, and lazy a-vectors (``lazy_ab``) that any
state swap invalidates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.base import LinearOperator, LinearOperatorException, default_device
from ..core.precision import pdot, pmatmul
from ..parallel import comm

__all__ = [
    "LBFGSState",
    "LBFGSOperator",
    "InverseLBFGSOperator",
    "inverse_apply",
    "forward_apply",
    "inverse_apply_compact",
    "forward_apply_compact",
    "forward_diag",
]


class LBFGSState(NamedTuple):
    """The L-BFGS memory. Ring indices are 0-based; field order and shapes
    are the reference's, so a state crosses field by field."""

    S: torch.Tensor  # (mem, n) step history
    Y: torch.Tensor  # (mem, n) gradient-difference history
    ys: torch.Tensor  # (mem,)  curvatures <y, s>; 0 marks an empty slot
    A: torch.Tensor  # (mem, n) forward-form 'a' vectors ((0, n) for inverse)
    B: torch.Tensor  # (mem, n) forward-form 'b' vectors ((0, n) for inverse)
    norm_b2: torch.Tensor  # (mem,) ‖bᵢ‖² ((0,) for inverse)
    SY: torch.Tensor  # (mem, mem) Gram SᵀY: SY[i, j] = <sᵢ, yⱼ>
    YY: torch.Tensor  # (mem, mem) Gram YᵀY
    SS: torch.Tensor  # (mem, mem) Gram SᵀS
    gamma: torch.Tensor  # () scaling factor γ
    insert: torch.Tensor  # () int32 next ring slot
    opnorm_ub: torch.Tensor  # () upper bound on ‖B‖₂ (forward form)
    G: torch.Tensor  # (2, 2mem, 2mem) compact middles: [0] forward, [1] inverse


def _init_state(n: int, mem: int, dtype, inverse: bool, device=None) -> LBFGSState:
    fmem = 0 if inverse else mem
    kw = dict(dtype=dtype, device=device)
    return LBFGSState(
        S=torch.zeros((mem, n), **kw),
        Y=torch.zeros((mem, n), **kw),
        ys=torch.zeros((mem,), **kw),
        A=torch.zeros((fmem, n), **kw),
        B=torch.zeros((fmem, n), **kw),
        norm_b2=torch.zeros((fmem,), **kw),
        SY=torch.zeros((mem, mem), **kw),
        YY=torch.zeros((mem, mem), **kw),
        SS=torch.zeros((mem, mem), **kw),
        gamma=torch.ones((), **kw),
        insert=torch.zeros((), dtype=torch.int32, device=device),
        opnorm_ub=torch.ones((), **kw),
        G=torch.zeros((2, 2 * mem, 2 * mem), **kw),
    )


# ----------------------------------------------------------------------------
# Small helpers (device-side ring indexing, no host sync)
# ----------------------------------------------------------------------------


def _safe_inv(x):
    nz = x != 0
    return torch.where(nz, 1.0 / torch.where(nz, x, torch.ones_like(x)), torch.zeros_like(x))


def _idx(i):
    return i.reshape(1).long()


def _row(X, i):
    return X.index_select(0, _idx(i))[0]


def _elem(x, i):
    return x.index_select(0, _idx(i))[0]


def _set_row(X, i, value):
    """X with row i replaced by ``value``: a select on a one-hot row mask,
    which DTensor shards as any elementwise op (it has no rule for an
    indexed write)."""
    hit = (torch.arange(X.shape[0], device=X.device) == _idx(i)).reshape(-1, *[1] * (X.ndim - 1))
    return torch.where(hit, value.reshape(1, *X.shape[1:]).to(X.dtype), X)


def _set_col(X, i, value):
    """X with column i replaced by ``value`` (as ``_set_row``)."""
    hit = torch.arange(X.shape[1], device=X.device) == _idx(i)
    return torch.where(hit[None, :], value.reshape(X.shape[0], 1).to(X.dtype), X)


def _oldest_first(state: LBFGSState):
    """Slot order oldest → newest: the oldest surviving pair sits at
    ``insert`` (the next slot to write)."""
    mem = state.S.shape[0]
    return torch.remainder(state.insert.long() + torch.arange(mem, device=state.S.device), mem)


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


# ----------------------------------------------------------------------------
# Pure applies
# ----------------------------------------------------------------------------


def inverse_apply(state: LBFGSState, x):
    """Two-loop recursion H v (Nocedal & Wright Procedure 7.4). Empty slots
    have ρ = 0 and drop out."""
    mem = state.S.shape[0]
    rho = _safe_inv(state.ys)
    q = x.to(torch.promote_types(x.dtype, state.S.dtype))
    ins = state.insert.long()
    alph = [None] * mem
    for i in range(mem):
        k = torch.remainder(ins - i - 1, mem)
        ak = _elem(rho, k) * pdot(_row(state.S, k), q)
        q = q - ak * _row(state.Y, k)
        alph[i] = (k, ak)
    q = q * state.gamma
    for i in range(mem):
        # loop 2 visits slots oldest → newest, the reverse of loop 1
        k, ak = alph[mem - 1 - i]
        beta = ak - _elem(rho, k) * pdot(_row(state.Y, k), q)
        q = q + beta * _row(state.S, k)
    return q


def _block(rows):
    return torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)


def _compact_middle(state: LBFGSState, inverse: bool):
    """The (2mem, 2mem) middle matrix G of the compact-form apply:

      forward:  B v = θ v + Wᵀ G W v,   W = [θS; Y],  θ = 1/γ
      inverse:  H v = γ v + Wᵀ G W v,   W = [S; γY]

    (rows of W in oldest → newest order). Forward (BNS 1994 thm 2.3, Schur
    complement of the −D block): with L = strict lower of SᵀY, D = its
    diagonal, M = θSᵀS + L D⁻¹ Lᵀ,

      G = −[[M⁻¹, M⁻¹ L D⁻¹], [D⁻¹Lᵀ M⁻¹, D⁻¹Lᵀ M⁻¹ L D⁻¹ − D⁻¹]]

    Inverse (BNS 1994 eq. 2.6, R = upper of SᵀY):

      G = [[R⁻ᵀ(D + γYᵀY)R⁻¹, −R⁻ᵀ], [−R⁻¹, 0]]

    Empty slots get a unit R/M diagonal, and their G rows/cols are zeroed.
    Maintained at push time, so the applies run no factorization."""
    mem = state.S.shape[0]
    order = _oldest_first(state)
    valid = state.ys[order] != 0
    vmask2 = valid[:, None] & valid[None, :]
    gamma = state.gamma
    SY_o = _where0(vmask2, state.SY[order][:, order])
    eye = torch.eye(mem, dtype=SY_o.dtype, device=SY_o.device)
    fix = torch.diag(torch.where(valid, 0.0, 1.0).to(SY_o.dtype))
    if inverse:
        YY_o = _where0(vmask2, state.YY[order][:, order])
        R = torch.triu(SY_o) + fix
        D = _where0(valid, torch.diagonal(SY_o))
        Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
        Rinv = _where0(vmask2, Rinv)
        B11 = pmatmul(Rinv.T, D[:, None] * Rinv + gamma * pmatmul(YY_o, Rinv))
        return _block([[B11, -Rinv.T], [-Rinv, torch.zeros_like(Rinv)]])
    SS_o = _where0(vmask2, state.SS[order][:, order])
    theta = 1.0 / gamma
    L = torch.tril(SY_o, diagonal=-1)
    d_inv = _safe_inv(torch.diagonal(SY_o))  # 0 on empty slots
    Ldi = L * d_inv[None, :]
    M = theta * SS_o + pmatmul(Ldi, L.T) + fix
    # M is not SPD when the pairs fit no forward form (e.g. a damped inverse
    # push): the forward middle is then NaN, as jnp.linalg.cholesky leaves it;
    # the inverse middle is unaffected. cholesky_ex reports without a sync.
    C, info = torch.linalg.cholesky_ex(M)
    C = torch.where(info == 0, C, torch.full_like(C, float("nan")))
    Minv = _where0(vmask2, torch.cholesky_solve(eye, C))
    MLdi = pmatmul(Minv, Ldi)
    G22 = -pmatmul(Ldi.T, MLdi) + torch.diag(d_inv)
    return _block([[-Minv, -MLdi], [-MLdi.T, G22]])


def _forward_compact_parts(state: LBFGSState):
    """The forward compact form B = θI − U K⁻¹ Uᵀ, U = [θS Y],
    K = [[θSᵀS, L], [Lᵀ, −D]] (L the strict lower triangle of SᵀY, D its
    diagonal; BNS 1994 thm 2.3), in oldest → newest order, for the shifted
    solves: (θ, K, W = Uᵀ as (2mem, n), SᵀS, SᵀY, YᵀY, valid). Built from
    the push-maintained Grams; empty slots get a unit K diagonal and zero
    Gram rows and columns."""
    order = _oldest_first(state)
    valid = state.ys[order] != 0
    vmask2 = valid[:, None] & valid[None, :]
    theta = 1.0 / state.gamma
    SY_o = _where0(vmask2, state.SY[order][:, order])
    SS_o = _where0(vmask2, state.SS[order][:, order])
    YY_o = _where0(vmask2, state.YY[order][:, order])
    L = torch.tril(SY_o, diagonal=-1)
    K = _block([[theta * SS_o, L], [L.T, -torch.diag(torch.diagonal(SY_o))]])
    valid2 = torch.cat([valid, valid])
    K = _where0(valid2[:, None] & valid2[None, :], K) + torch.diag(
        torch.where(valid2, 0.0, 1.0).to(K.dtype))
    W = torch.cat([theta * state.S[order], state.Y[order]], dim=0)
    return theta, K, W, SS_o, SY_o, YY_o, valid


def _compact_apply(state: LBFGSState, x, inverse: bool):
    """One (2mem, n) pass over W, one (2mem)² mat-vec with ``state.G``, one
    pass over Wᵀ:  forward  B v = θv + Wᵀ G (W v),  W = [θS; Y];
    inverse  H v = γv + Wᵀ G (W v),  W = [S; γY]  (rows oldest → newest).
    ``x`` may be a vector (n,) or a column block (n, k)."""
    order = _oldest_first(state)
    S, Y = state.S.index_select(0, order), state.Y.index_select(0, order)
    if inverse:
        scale = state.gamma
        W = torch.cat([S, scale * Y], dim=0)
    else:
        scale = 1.0 / state.gamma
        W = torch.cat([scale * S, Y], dim=0)
    coef = pmatmul(state.G[1 if inverse else 0], pmatmul(W, x))
    return scale * x + pmatmul(W.T, coef)


def inverse_apply_compact(state: LBFGSState, x):
    """Compact-representation inverse apply (BNS 1994): the two-loop
    recursion's result from two (2mem, n) passes and no sequential loop."""
    return _compact_apply(state, x, inverse=True)


def forward_apply_compact(state: LBFGSState, x):
    """Compact-representation forward apply (BNS 1994 thm 2.3): the a/b
    form's result from two (2mem, n) passes."""
    return _compact_apply(state, x, inverse=False)


def forward_apply(state: LBFGSState, x):
    """B v = v/γ + Bᵀ(B v) − Aᵀ(A v) over the a/b vectors (parity path)."""
    q = x / state.gamma
    return q + pmatmul(state.B.T, pmatmul(state.B, x)) - pmatmul(state.A.T, pmatmul(state.A, x))


def forward_diag(state: LBFGSState):
    """diag(B) = 1/γ + Σ bᵢ² − aᵢ²."""
    return 1.0 / state.gamma + torch.sum(state.B ** 2 - state.A ** 2, dim=0)


# ----------------------------------------------------------------------------
# Pure push
# ----------------------------------------------------------------------------


def _a_recursion(S_ord, B_ord, valid, gamma, order):
    """Forward-form a-vectors over oldest → newest slots: each step is two
    batched (mem, n) mat-vecs. Returns them in slot order."""
    mem = S_ord.shape[0]
    idx = torch.arange(mem, device=S_ord.device)
    A_ord = torch.zeros_like(B_ord)
    for i in range(mem):
        s_i = S_ord[i]
        mask = (idx < i) & valid
        bs = _where0(mask, pmatmul(B_ord, s_i))
        as_ = _where0(mask, pmatmul(A_ord, s_i))
        a = s_i / gamma + pmatmul(B_ord.T, bs) - pmatmul(A_ord.T, as_)
        denom = torch.sqrt(pdot(s_i, a))
        a = a / torch.where(denom != 0, denom, torch.ones_like(denom))
        A_ord = A_ord.clone()
        A_ord[i] = torch.where(valid[i], a, torch.zeros_like(a))
    return torch.zeros_like(A_ord).index_copy(0, order, A_ord)


def _recompute_all_a(state: LBFGSState) -> LBFGSState:
    """Recompute every forward-form a-vector from (S, ys, B, γ): the
    deferred half of a lazy push."""
    order = _oldest_first(state)
    A_new = _a_recursion(state.S[order], state.B[order], state.ys[order] != 0,
                         state.gamma, order)
    return state._replace(A=A_new)


def _push_common(state: LBFGSState, s, y, ys, *, scaling: bool, inverse: bool,
                 with_ab: bool = True, accept=None) -> LBFGSState:
    """Insert a pair. ``with_ab=False`` (lazy a-vectors) maintains only the
    b row, ‖b‖², the norm bound and the Grams. ``accept`` (a bool tensor or
    None = always) gates the row writes: a rejected push rewrites the
    slot's existing values and leaves insert, γ and the bound as they were."""
    mem = state.S.shape[0]
    ins = state.insert
    if accept is not None:
        s = torch.where(accept, s, _row(state.S, ins))
        y = torch.where(accept, y, _row(state.Y, ins))
        ys = torch.where(accept, ys, _elem(state.ys, ins))
    S = _set_row(state.S, ins, s)
    Y = _set_row(state.Y, ins, y)
    ysv = _set_row(state.ys, ins, ys)

    # Grams: one row + column each of SᵀY, YᵀY, SᵀS
    SY = _set_col(_set_row(state.SY, ins, pmatmul(Y, s)), ins, pmatmul(S, y))
    yy_vec = pmatmul(Y, y)
    YY = _set_col(_set_row(state.YY, ins, yy_vec), ins, yy_vec)
    ss_vec = pmatmul(S, s)
    SS = _set_col(_set_row(state.SS, ins, ss_vec), ins, ss_vec)

    gamma = state.gamma
    ub = state.opnorm_ub
    if scaling:
        yy = pdot(y, y)
        gamma_new = ys / torch.where(yy != 0, yy, torch.ones_like(yy))
        ub_new = ub - _safe_inv(gamma) + _safe_inv(gamma_new)
        if accept is None:
            gamma, ub = gamma_new, ub_new
        else:
            gamma = torch.where(accept, gamma_new, gamma)
            ub = torch.where(accept, ub_new, ub)

    if inverse:
        A, B, nb2 = state.A, state.B, state.norm_b2
    else:
        # guard: a gated-away (empty-slot) rewrite may carry ys = 0
        b_row = y / torch.sqrt(torch.where(ys != 0, ys, torch.ones_like(ys)))
        nb2_new = pdot(b_row, b_row)
        ub = ub - _elem(state.norm_b2, ins) + nb2_new
        nb2 = _set_row(state.norm_b2, ins, nb2_new)
        B = _set_row(state.B, ins, b_row)
        if with_ab:
            order = torch.remainder(ins.long() + 1 + torch.arange(mem, device=S.device), mem)
            A = _a_recursion(S[order], B[order], ysv[order] != 0, gamma, order)
        else:
            A = state.A

    ins_new = torch.remainder(ins + 1, mem).to(torch.int32)
    if accept is not None:
        ins_new = torch.where(accept, ins_new, ins).to(torch.int32)
    new = LBFGSState(S=S, Y=Y, ys=ysv, A=A, B=B, norm_b2=nb2, SY=SY, YY=YY, SS=SS,
                     gamma=gamma, insert=ins_new, opnorm_ub=ub, G=state.G)
    # refresh both compact middles, so either operator form can apply the state
    return new._replace(G=_compact_middles(new))


_MIDDLE_FIELDS = ("ys", "SY", "YY", "SS", "gamma", "insert")


def _compact_middles(state: LBFGSState):
    """Both compact middles, stacked. They read only the small (mem, mem)
    and (mem,) fields: of a sharded state (DTensor leaves,
    ``parallel.shard_operator``) each rank factors its own whole copy of
    them and the result is replicated (``comm.on_whole``)."""

    def middles(*fields):
        small = state._replace(**dict(zip(_MIDDLE_FIELDS, fields)))
        return torch.stack([_compact_middle(small, False), _compact_middle(small, True)])

    return comm.on_whole(middles, *(getattr(state, f) for f in _MIDDLE_FIELDS))


def _push_plain(state, s, y, *, scaling, inverse, with_ab=True):
    """Undamped push with curvature rejection ys ≤ eps."""
    ys = pdot(y, s)
    eps = torch.finfo(state.S.dtype).eps
    return _push_common(state, s, y, ys, scaling=scaling, inverse=inverse,
                        with_ab=with_ab, accept=ys > eps)


def _powell_blend(s, y, ys, Bs, sigma2, sigma3):
    """Powell's damped update."""
    sBs = pdot(s, Bs)
    lo = ys < (1 - sigma2) * sBs
    hi = ys > (1 + sigma3) * sBs
    one = torch.ones_like(sBs)
    theta = torch.where(
        lo,
        sigma2 * sBs / torch.where(sBs - ys != 0, sBs - ys, one),
        torch.where(hi, sigma3 * sBs / torch.where(ys - sBs != 0, ys - sBs, one), one),
    )
    damp = lo | hi
    y_d = torch.where(damp, theta * y + (1 - theta) * Bs, y)
    ys_d = torch.where(damp, theta * ys + (1 - theta) * sBs, ys)
    return y_d, ys_d


def _push_damped_forward(state, s, y, sigma2, sigma3, *, scaling, with_ab=True):
    """Damped forward push: Bs from the compact form, Powell blend, always
    insert."""
    Bs = forward_apply_compact(state, s)
    y_d, ys_d = _powell_blend(s, y, pdot(y, s), Bs, sigma2, sigma3)
    return _push_common(state, s, y_d, ys_d, scaling=scaling, inverse=False,
                        with_ab=with_ab)


def _push_damped_inverse(state, s, y, alpha, g, sigma2, sigma3, *, scaling):
    """Damped inverse push: Bs = −α g, Powell blend, always insert."""
    Bs = -alpha * g
    y_d, ys_d = _powell_blend(s, y, pdot(y, s), Bs, sigma2, sigma3)
    return _push_common(state, s, y_d, ys_d, scaling=scaling, inverse=True)


# ----------------------------------------------------------------------------
# Operator classes
# ----------------------------------------------------------------------------


class LBFGSOperator(LinearOperator):
    """Limited-memory BFGS approximation (forward form).

    ``LBFGSOperator(n, mem=5, scaling=True, damped=False, device=None)`` or
    ``LBFGSOperator(dtype, n, ...)``. Symmetric positive definite by
    construction. The state lives on ``device``: the CUDA device by default,
    ``device="cpu"`` for the CPU. Every ``push``/``reset`` swaps ``self.state`` for a new
    state.
    """

    _fields_tensors = ("state",)
    _fields_static = ("_n", "_mem", "_scaling", "_damped", "_inverse", "_dtype",
                      "_sigma2", "_sigma3", "_lazy_ab")
    _fields_state = ("state",)  # a push or reset swaps in a new state

    _is_inverse_ctor = False

    def __init__(self, *args, mem: int = 5, scaling: bool = True, damped: bool = False,
                 sigma2: float = 0.99, sigma3: float = 10.0, dtype=None,
                 lazy_ab: bool = True, device=None):
        super().__init__()
        if len(args) == 2:
            dt, n = args
        elif len(args) == 1:
            dt, n = (dtype if dtype is not None else torch.float64), args[0]
        else:
            raise TypeError("LBFGSOperator(n) or LBFGSOperator(dtype, n)")
        if dt.is_complex:
            raise LinearOperatorException(
                "complex L-BFGS is not supported: the curvature tests and "
                "Gram updates assume real inner products"
            )
        self._n = int(n)
        self._mem = max(int(mem), 1)
        self._scaling = bool(scaling)
        self._damped = bool(damped)
        self._inverse = bool(type(self)._is_inverse_ctor)
        self._dtype = dt
        self._sigma2 = float(sigma2)
        self._sigma3 = float(sigma3)
        # lazy a-vectors (forward form only): pushes skip the O(mem²·n)
        # recompute; diag and the a/b form trigger it on demand
        self._lazy_ab = bool(lazy_ab) and not self._inverse
        device = default_device(device, type(self).__name__)
        self.state = _init_state(self._n, self._mem, dt, self._inverse, device)
        object.__setattr__(self, "_ab_fresh", True)  # empty memory is fresh

    # --- metadata ---
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
    def inverse(self):
        return self._inverse

    @property
    def damped(self):
        return self._damped

    @property
    def scaling(self):
        return self._scaling

    @property
    def insert(self) -> int:
        """0-based ring insert position."""
        return int(self.state.insert)

    @property
    def scaling_factor(self) -> float:
        return float(self.state.gamma)

    @property
    def opnorm_upper_bound(self) -> float:
        """Tracked upper bound for ‖Bₖ‖₂."""
        return float(self.state.opnorm_ub)

    # --- apply ---
    def _prod(self, v):
        if self._inverse:
            return inverse_apply_compact(self.state, v)
        return forward_apply_compact(self.state, v)

    def apply_matrix(self, M, mode: str = "N"):
        # symmetric and real: all four modes coincide, and the compact
        # applies take (n, k) blocks as they are
        return self._prod(M)

    # --- state updates ---
    @comm.dtensor_entry
    def push(self, s, y, *args):
        """Insert a {s, y} pair.

        Forms: ``push(s, y)``; damped forward also accepts ``push(s, y, Bs)``
        (Bs is recomputed; kept for call-form parity); damped inverse
        requires ``push(s, y, alpha, g[, Bs])``. DTensor pairs push into a
        sharded operator's state, which keeps its placements.
        """
        old = self.state
        dt, dev = self.dtype, self.state.S.device
        s = torch.as_tensor(s, dtype=dt, device=dev)
        y = torch.as_tensor(y, dtype=dt, device=dev)
        with_ab = not self._lazy_ab
        if len(args) == 0:
            if self._damped:
                if self._inverse:
                    raise ValueError("damped inverse L-BFGS requires push(s, y, alpha, g)")
                self.state = _push_damped_forward(
                    self.state, s, y, self._sigma2, self._sigma3,
                    scaling=self._scaling, with_ab=with_ab)
            else:
                self.state = _push_plain(self.state, s, y, scaling=self._scaling,
                                         inverse=self._inverse, with_ab=with_ab)
        elif len(args) == 1:
            if not self._damped:
                raise ValueError("push(s, y, Bs) requires a damped operator")
            if self._inverse:
                raise ValueError("push(s, y, Bs) is for forward operators; use push(s, y, alpha, g)")
            self.state = _push_damped_forward(
                self.state, s, y, self._sigma2, self._sigma3,
                scaling=self._scaling, with_ab=with_ab)
        elif len(args) in (2, 3):
            if not self._damped:
                raise ValueError("push(s, y, alpha, g) requires a damped operator")
            if not self._inverse:
                raise ValueError("push(s, y, alpha, g) is for inverse operators; use push(s, y, Bs)")
            alpha = torch.as_tensor(args[0], dtype=dt, device=dev)
            g = torch.as_tensor(args[1], dtype=dt, device=dev)
            self.state = _push_damped_inverse(self.state, s, y, alpha, g, self._sigma2,
                                              self._sigma3, scaling=self._scaling)
        else:
            raise TypeError("push(s, y[, Bs] | [, alpha, g[, Bs]])")
        if comm.is_dtensor(old.S):
            self.state = comm.keep_placements(self.state, old)
        # the state assignment cleared _ab_fresh; an eager (or inverse) push
        # maintained the a/b form in-line
        if not self._lazy_ab:
            object.__setattr__(self, "_ab_fresh", True)
        return self

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "state":
            # ANY state swap (push, restore, user assignment) invalidates
            # the deferred a-vectors; internal paths re-mark freshness after
            object.__setattr__(self, "_ab_fresh", False)

    def _materialized_state(self) -> LBFGSState:
        """State with fresh a-vectors, recomputed and kept when stale."""
        if self._inverse or getattr(self, "_ab_fresh", False):
            return self.state
        self.state = _recompute_all_a(self.state)
        object.__setattr__(self, "_ab_fresh", True)
        return self.state

    def ensure_ab(self) -> "LBFGSOperator":
        """Materialize the forward a/b vectors if a lazy push deferred them."""
        self._materialized_state()
        return self

    def _before_save(self):
        self.ensure_ab()

    def diag(self):
        """Diagonal of a forward L-BFGS approximation."""
        if self._inverse:
            raise LinearOperatorException(
                "only the diagonal of a forward L-BFGS approximation is available")
        return forward_diag(self._materialized_state())

    def reset(self):
        """Zero the memory and counters."""
        self.state = _init_state(self._n, self._mem, self.dtype, self._inverse,
                                 self.state.S.device)
        object.__setattr__(self, "_ab_fresh", True)
        self.reset_counters()
        return self

    def _name(self):
        return ("Inverse " if self._inverse else "") + "LBFGS operator"


class InverseLBFGSOperator(LBFGSOperator):
    """Inverse-form limited-memory BFGS."""

    _is_inverse_ctor = True
