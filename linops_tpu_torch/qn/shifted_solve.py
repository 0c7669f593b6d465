"""Shifted L-BFGS systems: (B + σI) x = b for a forward L-BFGS operator B.

Counterpart of ``linops_tpu/qn/shifted_solve.py`` (Erway, Jain and Marcia,
"Shifted L-BFGS systems", Optim. Methods Softw. 29(5), 2014). Two methods:

- ``compact`` (default): Woodbury on the forward compact form,
  (B + σI)⁻¹ b = b/c + U (cK − UᵀU)⁻¹ Uᵀb / c with c = θ + σ: two
  (2·mem, n) passes and one (2·mem)² dense solve. Exact for every σ ≥ 0,
  σ = 0 on a partly filled ring included. ``solve_shifted_systems`` solves
  several σ at once and shares both passes among them.
- ``ejm``: the EJM recursion, 2·mem sequential rank-1 corrections (a host
  loop of small tensor ops that reads nothing back). At σ = 0 on a partly filled ring it is
  degenerate (the oldest pair's unit a-vector makes 1 − x₀⟨a, p⟩ = 0), and
  it raises there; prefer ``compact``.

The compact method reads the state's Grams (SᵀS, SᵀY, YᵀY), which every push
keeps; the EJM method reads the a/b vectors, materialized first if a lazy
push deferred them. Everything runs on the state's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.base import _local
from ..core.precision import pdot, pmatmul
from ..parallel import comm
from .lbfgs import LBFGSOperator, LBFGSState, _forward_compact_parts

__all__ = ["solve_shifted_system", "solve_shifted_systems", "ldiv"]


def _solve_shifted(state: LBFGSState, b, sigma):
    """The EJM recursion. The pair of step i (0-based) is slot
    (insert + i//2 + 1) mod mem, gathered on the device (no read of
    ``insert``); even steps use its a-vector, odd steps its b-vector, with
    signs +1 and −1."""
    mem, n = state.S.shape
    dt = b.dtype
    R = comm.rows_of(b)  # sharded state and a DTensor b: this rank's rows
    x0 = _local(1.0 / (1.0 / state.gamma + sigma))
    bl = R.local(b)
    x = x0 * bl
    two_mem = 2 * mem
    t_signs = torch.where(torch.arange(two_mem, device=b.device) % 2 == 0, 1.0, -1.0).to(dt)
    slots = torch.remainder(state.insert.long() + torch.arange(1, mem + 1, device=b.device), mem)
    P = torch.zeros((two_mem, bl.shape[0]), dtype=dt, device=b.device)
    v = torch.zeros((two_mem,), dtype=dt, device=b.device)
    for i in range(two_mem):
        sign = 1.0 if i % 2 == 0 else -1.0
        u = R.local((state.A if sign == 1.0 else state.B).index_select(
            0, slots[i // 2:i // 2 + 1])[0])
        # p_i = x0·u + Σ_{t<i} sign_t·v_t·⟨p_t, u⟩·p_t, one (2mem, n) pass each way
        c = torch.zeros_like(v)
        c[:i] = t_signs[:i] * v[:i] * R.psum(pmatmul(P[:i], u))
        p_i = x0 * u + pmatmul(P.T, c)
        v_i = 1.0 / (1.0 - sign * R.psum(pdot(u, p_i)))
        x = x + sign * v_i * R.psum(pdot(p_i, bl)) * p_i
        P[i] = p_i
        v[i] = v_i
    return R.dtensor(x)


def _solve_shifted_compact(state: LBFGSState, b, sigmas):
    """Woodbury on the forward compact form for a vector of shifts:
    returns (len(sigmas), n). The two (2·mem, n) passes, Uᵀb and U·coef, are
    shared by every σ."""
    theta, K, W, SS_o, SY_o, YY_o, valid = _forward_compact_parts(state)
    c = theta + sigmas  # (S,)
    UtU = torch.cat([torch.cat([theta ** 2 * SS_o, theta * SY_o], dim=1),
                     torch.cat([theta * SY_o.T, YY_o], dim=1)], dim=0)
    Mk = c[:, None, None] * K[None] - UtU[None]
    # a unit diagonal on empty coordinates keeps each system nonsingular
    valid2 = torch.cat([valid, valid])
    fix = torch.diag(torch.where(valid2, 0.0, 1.0).to(Mk.dtype))
    Mk = torch.where((valid2[:, None] & valid2[None, :])[None], Mk, torch.zeros_like(Mk)) + fix
    Utb = pmatmul(W, b)  # (2mem,)
    # solve_ex: no host sync for an error check (a singular system gives
    # non-finite values, as the reference's jnp.linalg.solve does)
    coef = comm.on_whole(lambda Mk, Utb: torch.linalg.solve_ex(
        Mk, Utb.expand(Mk.shape[0], -1).unsqueeze(-1))[0].squeeze(-1), Mk, Utb)
    return b[None, :] / c[:, None] + pmatmul(coef, W) / c[:, None]


def _check(B: LBFGSOperator, what: str):
    if B.inverse:
        raise ValueError(f"{what} requires a forward L-BFGS operator")


def _host_values(x):
    """σ as numpy when it can be read without waiting on the device (a
    Python number, a sequence, numpy, a CPU tensor), else None: a σ on the
    card, or one under a ``torch.func`` transform, is the counterpart of the
    reference's traced σ (``_is_concrete``), left unchecked."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or torch._C._functorch.is_functorch_wrapped_tensor(x):
            return None
        return x.detach().numpy()
    return np.asarray(x)


@comm.dtensor_entry
def solve_shifted_system(B: LBFGSOperator, b, sigma, *, method: str = "compact"):
    """Solve ``(B + σI) x = b`` for a forward L-BFGS operator B and σ ≥ 0.
    ``method="compact"`` (default) is the Woodbury solve, ``method="ejm"``
    the Erway-Jain-Marcia recursion. Returns x (n,) on B's device.

    σ may be a tensor on the card (a trust-region loop's own value): then
    nothing is read back, and σ ≥ 0 is the caller's contract, as under the
    reference's jit. A Python or CPU σ is checked."""
    _check(B, "solve_shifted_system")
    host = _host_values(sigma)
    if host is not None and float(host) < 0:
        raise ValueError("σ must be nonnegative")
    dev = B.state.S.device
    b = torch.as_tensor(b, dtype=B.dtype, device=dev)
    sigma_t = torch.as_tensor(sigma, dtype=B.dtype, device=dev)
    if method == "compact":
        return _solve_shifted_compact(B.state, b, sigma_t.reshape(1))[0]
    if method == "ejm":
        state = B._materialized_state()
        if host is not None and float(host) == 0 and bool((state.ys == 0).any()):
            raise ValueError(
                "EJM is degenerate at sigma=0 on a partially-filled ring (the oldest pair's "
                "unit a-vector makes 1 - x0<a,p> = 0); use the default compact method")
        return _solve_shifted(state, b, sigma_t)
    raise ValueError(f"unknown method {method!r}")


@comm.dtensor_entry
def solve_shifted_systems(B: LBFGSOperator, b, sigmas):
    """Solve ``(B + σᵢI) x = b`` for a batch of shifts at once (the compact
    solve, both (2·mem, n) passes shared). Returns (len(sigmas), n). Shifts
    on the card are not read back (see ``solve_shifted_system``)."""
    _check(B, "solve_shifted_systems")
    host = _host_values(sigmas)
    if host is not None and bool((host < 0).any()):
        raise ValueError("σ must be nonnegative")
    dev = B.state.S.device
    sig = torch.as_tensor(sigmas, dtype=B.dtype, device=dev).reshape(-1)
    b = torch.as_tensor(b, dtype=B.dtype, device=dev)
    return _solve_shifted_compact(B.state, b, sig)


def ldiv(B: LBFGSOperator, b):
    """Solve ``B x = b`` (the σ = 0 case)."""
    return solve_shifted_system(B, b, 0.0)
