"""Parity of the port's L-BFGS module with the JAX reference, in f64 on the
CPU: the state after every push (all 13 fields), the compact and two-loop /
a-b applies, damping, rejection, diag, reset, lazy a-vectors, and a state
carried across through ``convert``. Agreement: max|Δ| ≤ 1e-10·max|ref|
per field (BASELINE.md's f64 tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.qn import lbfgs as jq
from linops_tpu_torch.convert import lbfgs_state_from_reference
from linops_tpu_torch.qn import lbfgs as tq

RTOL = 1e-10


def assert_rel(got, ref, rtol=RTOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.size == 0:
        return
    # NaNs must sit where the reference has them (a forward middle of pairs
    # that fit no forward form); the rest is compared
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan), f"{what}: NaN pattern differs"
    if nan.all():
        return
    got, ref = got[~nan], ref[~nan]
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    assert err <= rtol * scale, f"{what}: max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def assert_state(st_t, st_j, what=""):
    for f in jq.LBFGSState._fields:
        assert_rel(getattr(st_t, f), getattr(st_j, f), what=f"{what} {f}")


def pairs(rng, n, count, bad_at=()):
    out = []
    for i in range(count):
        s = rng.standard_normal(n)
        y = -s if i in bad_at else s + 0.3 * rng.standard_normal(n)  # -s: ys < 0, rejected
        out.append((s, y))
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("lazy_ab", [False, True])
def test_plain_push_states_and_applies(rng, inverse, scaling, lazy_ab):
    n, mem = 24, 4
    pj = jq.InverseLBFGSOperator if inverse else jq.LBFGSOperator
    pt = tq.InverseLBFGSOperator if inverse else tq.LBFGSOperator
    op_j = pj(n, mem=mem, scaling=scaling, lazy_ab=lazy_ab)
    op_t = pt(n, mem=mem, scaling=scaling, lazy_ab=lazy_ab)
    v = rng.standard_normal(n)
    for i, (s, y) in enumerate(pairs(rng, n, mem + 3, bad_at=(2,))):
        op_j.push(jnp.asarray(s), jnp.asarray(y))
        op_t.push(torch.from_numpy(s), torch.from_numpy(y))
        if i in (0, mem - 1, mem + 2):  # partial, full and wrapped ring
            st_j, st_t = op_j.state, op_t.state
            if not inverse:
                st_j, st_t = op_j._materialized_state(), op_t._materialized_state()
            assert_state(st_t, st_j, f"push {i}")
            assert op_t.insert == op_j.insert
            assert_rel(op_t * torch.from_numpy(v), op_j * jnp.asarray(v), what="apply")
            if inverse:
                assert_rel(tq.inverse_apply(st_t, torch.from_numpy(v)),
                           jq.inverse_apply(st_j, jnp.asarray(v)), what="two-loop")
            else:
                assert_rel(tq.forward_apply(st_t, torch.from_numpy(v)),
                           jq.forward_apply(st_j, jnp.asarray(v)), what="a/b form")
                assert_rel(op_t.diag(), op_j.diag(), what="diag")
    assert op_t.opnorm_upper_bound == pytest.approx(op_j.opnorm_upper_bound, rel=1e-10)
    assert op_t.scaling_factor == pytest.approx(op_j.scaling_factor, rel=1e-10)


def test_compact_applies_equal_reference_forms(rng):
    """Both compact applies (and their (n, k) block form) against the
    reference's, on a state pushed by the reference and carried across."""
    n, mem = 30, 5
    op_j = jq.LBFGSOperator(n, mem=mem)
    for s, y in pairs(rng, n, mem + 2):
        op_j.push(jnp.asarray(s), jnp.asarray(y))
    st_t = lbfgs_state_from_reference({f: np.asarray(getattr(op_j.state, f))
                                       for f in jq.LBFGSState._fields})
    v = rng.standard_normal(n)
    M = rng.standard_normal((n, 3))
    for fj, ft in ((jq.forward_apply_compact, tq.forward_apply_compact),
                   (jq.inverse_apply_compact, tq.inverse_apply_compact)):
        assert_rel(ft(st_t, torch.from_numpy(v)), fj(op_j.state, jnp.asarray(v)))
        assert_rel(ft(st_t, torch.from_numpy(M)), fj(op_j.state, jnp.asarray(M)))
    # the carried state drives the port's operator; its G serves both forms
    op_t = tq.InverseLBFGSOperator(n, mem=mem)
    op_t.state = st_t
    assert_rel(op_t * torch.from_numpy(v), jq.inverse_apply(op_j.state, jnp.asarray(v)))
    assert_rel(op_t.matmat(torch.from_numpy(M)),
               jnp.stack([jq.inverse_apply(op_j.state, jnp.asarray(M[:, j])) for j in range(3)], 1))


@pytest.mark.parametrize("inverse", [False, True])
def test_damped_push(rng, inverse):
    n, mem = 20, 3
    cls_j = jq.InverseLBFGSOperator if inverse else jq.LBFGSOperator
    cls_t = tq.InverseLBFGSOperator if inverse else tq.LBFGSOperator
    op_j = cls_j(n, mem=mem, damped=True, lazy_ab=False)
    op_t = cls_t(n, mem=mem, damped=True, lazy_ab=False)
    for s, y in pairs(rng, n, mem + 2, bad_at=(1,)):
        if inverse:
            alpha, g = 0.7, rng.standard_normal(n)
            op_j.push(jnp.asarray(s), jnp.asarray(y), alpha, jnp.asarray(g))
            op_t.push(torch.from_numpy(s), torch.from_numpy(y), alpha, torch.from_numpy(g))
        else:
            op_j.push(jnp.asarray(s), jnp.asarray(y))
            op_t.push(torch.from_numpy(s), torch.from_numpy(y))
        assert_state(op_t.state, op_j.state, "damped")


def test_lazy_ab_invalidation_and_reset(rng):
    n, mem = 16, 3
    op = tq.LBFGSOperator(n, mem=mem)
    assert op._ab_fresh
    for s, y in pairs(rng, n, 2):
        op.push(torch.from_numpy(s), torch.from_numpy(y))
    assert not op._ab_fresh and float(op.state.A.abs().max()) == 0.0  # deferred
    op.ensure_ab()
    assert op._ab_fresh and float(op.state.A.abs().max()) > 0.0
    op.state = op.state  # any state swap invalidates
    assert not op._ab_fresh
    op.reset()
    assert op._ab_fresh and op.insert == 0 and op.nprod == 0
    assert float(op.state.S.abs().max()) == 0.0


def test_errors():
    with pytest.raises(lt.LinearOperatorException, match="complex"):
        tq.LBFGSOperator(torch.complex128, 4)
    with pytest.raises(ValueError, match="alpha, g"):
        tq.InverseLBFGSOperator(4, damped=True).push(torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="requires a damped"):
        tq.LBFGSOperator(4).push(torch.ones(4), torch.ones(4), torch.ones(4))
    with pytest.raises(lt.LinearOperatorException, match="only the diagonal"):
        tq.InverseLBFGSOperator(4).diag()
    op = tq.InverseLBFGSOperator(torch.float32, 6, mem=2)
    assert op.dtype == torch.float32 and op.state.S.dtype == torch.float32
    assert op.state.insert.dtype == torch.int32
