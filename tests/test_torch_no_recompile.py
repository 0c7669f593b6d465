"""The reference's no-recompile contract on the port, in f64 on the CPU
(mirrors tests/test_shifted_operator.py::test_shifted_mutable_sigma,
test_lbfgs.py::test_lbfgs_no_recompile, test_lsr1.py::test_lsr1_no_recompile,
test_diag.py::test_no_recompile_across_pushes,
test_eig.py::test_lobpcg_no_recompile_across_calls and
test_callable.py::test_callable_no_recompile).

The reference traces its state, so a σ update or a push reuses its jit
cache. The port compiles a solve's iterations into CUDA graphs keyed by
``core/base.py::capture_signature``, which sees every tensor by layout (a
host scalar in a field updates replace, ``_fields_state``, too), so the
key, and with it ``apply_cache_sizes()``, stays the same across updates,
while the values the port computes stay the reference's (max|Δ| ≤
1e-10·max|ref|). The updates keep value semantics: a state the caller holds
is never written. Also here: the captured block's static copies of the
operators' tensors (``utils/loop.py::_Mirrors``), which run on the CPU too,
and the chain timer's syncs (``utils/timing.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu_torch.core.base import capture_signature
from linops_tpu_torch.utils import loop, timing

RTOL = 1e-10
CPU = dict(device="cpu")


def close(got, ref, rtol=RTOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{what}: max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def key(op):
    return capture_signature(op)[0]


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty loop cache for the test (the module's own is put back)."""
    monkeypatch.setattr(loop, "_CACHE", type(loop._CACHE)())


def spd(rng, n, cond=20.0):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, cond, n)) @ Q.T


def test_shifted_mutable_sigma_keeps_the_key(rng, fresh_cache):
    """σ updates change the applied value as the reference's do and keep
    the capture key, the same σ set twice included; solves over the shifted
    operator add no signature."""
    n = 12
    H = spd(rng, n)
    v = rng.standard_normal(n)
    op_t = lt.ShiftedOperator(lt.LinearOperator(H, symmetric=True, hermitian=True, **CPU), 0.0)
    op_j = lo.ShiftedOperator(lo.LinearOperator(H, symmetric=True, hermitian=True), 0.0)
    k0 = key(op_t)
    close(op_t @ torch.from_numpy(v), np.asarray(op_j @ jnp.asarray(v)), what="σ 0")
    sizes0 = lo.apply_cache_sizes()
    for sigma in (2.5, 2.5, 0.75):
        op_t.set_sigma(sigma)
        op_j.set_sigma(sigma)
        close(op_t @ torch.from_numpy(v), np.asarray(op_j @ jnp.asarray(v)), what=f"σ {sigma}")
        close(op_t @ torch.from_numpy(v), (H + sigma * np.eye(n)) @ v, what="dense")
        assert key(op_t) == k0
        assert op_t.hermitian
    assert lo.apply_cache_sizes()["apply"] == sizes0["apply"]
    b = torch.from_numpy(rng.standard_normal(n))
    lt.cg(op_t, b, tol=1e-12, maxiter=100)
    sizes = lt.apply_cache_sizes()
    for sigma in (1.0, 3.0, 3.0):
        op_t.set_sigma(sigma)
        x, _, _ = lt.cg(op_t, b, tol=1e-12, maxiter=100)
        close(x, np.linalg.solve(H + sigma * np.eye(n), b.numpy()), rtol=1e-8, what="cg")
    assert lt.apply_cache_sizes() == sizes and sizes["signatures"] == 1


def test_assigned_sigma_goes_to_the_operator(rng, fresh_cache):
    """Assigning ``op.sigma`` a number, or a tensor in a narrower dtype,
    stores a 0-dim tensor in the operator's dtype on its device, as
    ``set_sigma`` does: the key stays, a tensor the caller holds is not the
    one stored, and applies and solves follow each new σ as the reference's
    do."""
    n = 12
    H = spd(rng, n)
    v = rng.standard_normal(n)
    b = torch.from_numpy(rng.standard_normal(n))
    op_t = lt.ShiftedOperator(lt.LinearOperator(H, symmetric=True, hermitian=True, **CPU), 0.0)
    op_j = lo.ShiftedOperator(lo.LinearOperator(H, symmetric=True, hermitian=True), 0.0)
    k0 = key(op_t)
    lt.cg(op_t, b, tol=1e-12, maxiter=100)
    sizes = lt.apply_cache_sizes()
    for sigma in (2.5, torch.tensor(0.75, dtype=torch.float32), torch.tensor(-0.5),
                  torch.tensor(3, dtype=torch.int64)):
        op_t.sigma = sigma
        value = float(sigma)
        op_j.set_sigma(value)
        assert op_t.sigma.dtype == torch.float64 and op_t.sigma.device == op_t.op.device
        assert op_t.sigma is not sigma and op_t.hermitian and key(op_t) == k0
        close(op_t @ torch.from_numpy(v), np.asarray(op_j @ jnp.asarray(v)), what=f"σ {value}")
        x, _, _ = lt.cg(op_t, b, tol=1e-12, maxiter=100)
        close(x, np.linalg.solve(H + value * np.eye(n), b.numpy()), rtol=1e-8, what="cg")
    assert lt.apply_cache_sizes() == sizes and sizes["signatures"] == 1


def test_static_state_lives_on_the_block_device():
    """A captured block's copy of a state field (and of every other tensor)
    is made on the block's device, whatever device the operator's tensor is
    on: a host scalar in the graph would be read at capture and its later
    values never seen. Its refresh copies a new value across."""
    op = lt.ShiftedOperator(lt.LinearOperator(np.eye(3), **CPU), 0.5)
    sig = capture_signature(op)
    mirrors = loop._Mirrors(sig, torch.device("meta"))
    assert all(s.device.type == "meta" for s in mirrors.static.values())
    with mirrors.swapped(sig):
        assert op.sigma.device.type == "meta"
    assert mirrors.refresh(capture_signature(op).tensors) == 0
    op.set_sigma(1.5)
    assert mirrors.refresh(capture_signature(op).tensors) == 8


def test_complex_sigma_hermitian_flag(rng):
    """The hermitian flag follows a complex σ as the reference's does; it is
    found when σ is set (by ``set_sigma`` or assignment), not per read."""
    n = 6
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = A + A.conj().T
    op_t = lt.ShiftedOperator(lt.LinearOperator(A, hermitian=True, **CPU), 1.0)
    op_j = lo.ShiftedOperator(lo.LinearOperator(A, hermitian=True), 1.0)
    k0 = key(op_t)
    for sigma in (2.0, 1.0 + 0.5j, 3.0 + 0j):
        op_t.set_sigma(sigma)
        op_j.set_sigma(sigma)
        assert op_t.hermitian == op_j.hermitian == (sigma.imag == 0 if isinstance(sigma, complex)
                                                    else True)
    op_t.sigma = torch.tensor(1.0 - 2.0j, dtype=torch.complex128)
    assert not op_t.hermitian
    assert key(op_t)[:1] == k0[:1]
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    op_j.set_sigma(1.0 - 2.0j)
    close(op_t.H @ torch.from_numpy(v), np.asarray(op_j.H @ jnp.asarray(v)), what="H")


def _pairs(rng, n, count, H=None):
    H = spd(rng, n) if H is None else H
    out = []
    for _ in range(count):
        s = rng.standard_normal(n)
        out.append((s, H @ s))
    return out


LBFGS_FORMS = ["forward", "inverse", "forward_damped", "inverse_damped"]


def _lbfgs(form, n, mem):
    inverse, damped = form.startswith("inverse"), form.endswith("damped")
    cls_t = lt.InverseLBFGSOperator if inverse else lt.LBFGSOperator
    cls_j = lo.InverseLBFGSOperator if inverse else lo.LBFGSOperator
    return (cls_t(n, mem=mem, damped=damped, **CPU), cls_j(n, mem=mem, damped=damped),
            inverse and damped)


def _push_both(Bt, Bj, s, y, inverse_damped):
    if inverse_damped:  # push(s, y, alpha, g): Bs = −α g
        Bt.push(s, y, 0.5, -2.0 * s)
        Bj.push(jnp.asarray(s), jnp.asarray(y), 0.5, jnp.asarray(-2.0 * s))
    else:
        Bt.push(s, y)
        Bj.push(jnp.asarray(s), jnp.asarray(y))


@pytest.mark.parametrize("form", LBFGS_FORMS)
def test_lbfgs_key_across_pushes_reset_and_checkpoint(rng, tmp_path, form):
    """Six pushes, a reset and a checkpoint round trip keep the capture key
    of every L-BFGS form, while the applies follow the reference's."""
    n, mem = 30, 4
    Bt, Bj, inv_damped = _lbfgs(form, n, mem)
    k0 = key(Bt)
    x = rng.standard_normal(n)
    for s, y in _pairs(rng, n, 6):
        _push_both(Bt, Bj, s, y, inv_damped)
        assert key(Bt) == k0
        close(Bt @ torch.from_numpy(x), np.asarray(Bj @ jnp.asarray(x)), what=form)
    path = str(tmp_path / "b.npz")
    lt.save_operator(path, Bt)
    before = (Bt @ torch.from_numpy(x)).clone()
    Bt.reset()
    assert key(Bt) == k0
    lt.load_operator_state(path, Bt)
    assert key(Bt) == k0
    assert torch.equal(Bt @ torch.from_numpy(x), before)


def test_lsr1_key_across_pushes_and_reset(rng):
    """Mirror of the reference's L-SR1 no-recompile test: six pushes and a
    reset keep the key; the applies follow the reference's."""
    n, mem = 30, 5
    Bt, Bj = lt.LSR1Operator(n, mem=mem, **CPU), lo.LSR1Operator(n, mem=mem)
    k0 = key(Bt)
    x = rng.standard_normal(n)
    for _ in range(6):
        s, y = rng.random(n), rng.random(n)
        Bt.push(s, y)
        Bj.push(jnp.asarray(s), jnp.asarray(y))
        assert key(Bt) == k0
        close(Bt @ torch.from_numpy(x), np.asarray(Bj @ jnp.asarray(x)), what="lsr1")
    Bt.ensure_a()  # the lazy a-vector refresh swaps state: the key stays
    assert key(Bt) == k0
    Bt.reset()
    assert key(Bt) == k0


@pytest.mark.parametrize("name", ["DiagonalAndrei", "DiagonalPSB", "SpectralGradient",
                                  "DiagonalBFGS"])
def test_diagonal_qn_key_across_pushes(rng, name):
    """Mirror of the reference's diagonal no-recompile test: pushes and a
    reset keep the key; d follows the reference's."""
    n = 16
    if name == "SpectralGradient":
        sigma = rng.random() + 0.1
        opt, opj = lt.SpectralGradient(sigma, n, **CPU), lo.SpectralGradient(sigma, n)
    else:
        d0 = rng.random(n) + 0.5
        opt, opj = getattr(lt, name)(d0, **CPU), getattr(lo, name)(jnp.asarray(d0))
    k0 = key(opt)
    for _ in range(5):
        s, y = rng.random(n) + 0.1, rng.random(n)
        opt.push(s, y)
        opj.push(jnp.asarray(s), jnp.asarray(y))
        assert key(opt) == k0
        close(opt.d, np.asarray(opj.d), what=name)
    opt.reset()
    assert key(opt) == k0


def test_solves_with_pushes_between_add_no_signature(rng, fresh_cache):
    """A quasi-Newton loop's traffic: cg preconditioned by an inverse L-BFGS
    model that gets a push before every solve. After the first solve
    ``apply_cache_sizes()`` stays put, and each x is the reference's."""
    n, mem = 40, 5
    A = spd(rng, n)
    At, Aj = lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU), lo.LinearOperator(
        A, symmetric=True, hermitian=True)
    Ht, Hj = lt.InverseLBFGSOperator(n, mem=mem, **CPU), lo.InverseLBFGSOperator(n, mem=mem)
    b = rng.standard_normal(n)
    sizes = None
    for r, (s, y) in enumerate(_pairs(rng, n, 7, H=A)):
        _push_both(Ht, Hj, s, y, False)
        x_t, k_t, _ = lt.cg(At, torch.from_numpy(b), M=Ht, tol=1e-10, maxiter=200)
        x_j, k_j, _ = lo.cg(Aj, jnp.asarray(b), M=Hj, tol=1e-10, maxiter=200)
        assert abs(k_t - int(k_j)) <= 1
        close(x_t, np.asarray(x_j), rtol=1e-8, what=f"round {r}")
        if sizes is None:
            sizes = lt.apply_cache_sizes()
        assert lt.apply_cache_sizes() == sizes, r
    assert sizes["signatures"] == 1 and sizes["graphs"] == 0


def test_held_state_is_never_written(rng):
    """The reference's state is immutable, so ``saved = B.state; B.push(s,
    y); B.state = saved`` rolls a model back. Pushes and solves leave a held
    state as it was, and assigning it back restores the applies, bit for
    bit, and the reference's values."""
    n, mem = 30, 4
    Bt, Bj, _ = _lbfgs("forward", n, mem)
    pairs = _pairs(rng, n, 5)
    for s, y in pairs[:3]:
        _push_both(Bt, Bj, s, y, False)
    x = torch.from_numpy(rng.standard_normal(n))
    saved_t, saved_j = Bt.state, Bj.state
    copies = [t.clone() for t in saved_t]
    y0 = Bt @ x
    for s, y in pairs[3:]:
        _push_both(Bt, Bj, s, y, False)
    lt.cg(Bt, x, tol=1e-10, maxiter=100)
    assert all(torch.equal(a, b) for a, b in zip(saved_t, copies))
    assert not torch.equal(Bt @ x, y0)
    Bt.state, Bj.state = saved_t, saved_j
    assert torch.equal(Bt @ x, y0)
    close(Bt @ x, np.asarray(Bj @ jnp.asarray(x.numpy())), what="rolled back")


def test_lobpcg_no_recompile_across_calls(rng, fresh_cache):
    """LOBPCG called three times with a new start block adds no signature
    (the reference's jit cache: no entry); θ is the reference's for each."""
    n, k = 40, 2
    A = spd(rng, n)
    op_t = lt.LinearOperator(A, symmetric=True, hermitian=True, **CPU)
    op_j = lo.LinearOperator(A, symmetric=True, hermitian=True)
    X0 = rng.standard_normal((n, k))
    lt.lobpcg(op_t, k=k, X0=torch.from_numpy(X0), tol=1e-8, maxiter=100)
    sizes = lt.apply_cache_sizes()
    for _ in range(3):
        X0 = rng.standard_normal((n, k))
        th_t, _, _, _ = lt.lobpcg(op_t, k=k, X0=torch.from_numpy(X0), tol=1e-8, maxiter=100)
        th_j, _, _, _ = lo.lobpcg(op_j, k=k, X0=jnp.asarray(X0), tol=1e-8, maxiter=100)
        close(th_t, np.asarray(th_j), rtol=1e-8, what="θ")
        assert lt.apply_cache_sizes() == sizes
    assert sizes["signatures"] == 1


class Flip:
    def __call__(self, x):
        return -x


def test_callable_no_recompile(fresh_cache):
    """A ``FunctionOperator``'s repeated applies add nothing to the cache and
    give the reference's values."""
    op_t = lt.LinearOperator(torch.float64, 2, 2, True, True, Flip())
    op_j = lo.LinearOperator(jnp.float64, 2, 2, True, True, Flip())
    v = np.ones(2)
    op_t.matvec(torch.from_numpy(v))
    before = lt.apply_cache_sizes()
    for _ in range(5):
        close(op_t.matvec(torch.from_numpy(v)), np.asarray(op_j.matvec(jnp.asarray(v))))
    assert lt.apply_cache_sizes() == before == {"signatures": 0, "graphs": 0, "captures": 0}


@pytest.mark.parametrize("form", ["forward", "inverse"])
def test_static_state_follows_updates(rng, form):
    """A captured block's copy of an operator's state: made equal to it,
    refreshed by a push (new tensors) and by an in-place edit (a bumped
    version), nothing copied when nothing changed; during a capture the
    operator reads the copy, with its lazy a-vectors left fresh, and gets
    its own state back after."""
    n, mem = 20, 3
    B, _, _ = _lbfgs(form, n, mem)
    for s, y in _pairs(rng, n, 2):
        B.push(s, y)
    B.ensure_ab()
    sig = capture_signature(B)
    mirrors = loop._Mirrors(sig, torch.device("cpu"))

    def copies():  # the state as the captured block reads it
        with mirrors.swapped(capture_signature(B)):
            return B.state

    assert all(torch.equal(a, b) for a, b in zip(copies(), B.state))
    assert mirrors.refresh(capture_signature(B).tensors) == 0
    s, y = _pairs(rng, n, 1)[0]
    B.push(s, y)
    assert capture_signature(B).key == sig.key
    assert mirrors.refresh(capture_signature(B).tensors) > 0
    assert mirrors.refresh(capture_signature(B).tensors) == 0
    assert all(torch.equal(a, b) for a, b in zip(copies(), B.state))
    B.state.S.mul_(2.0)
    assert mirrors.refresh(capture_signature(B).tensors) == B.state.S.numel() * 8
    own, fresh = B.state, B._ab_fresh
    ones = torch.ones(n, dtype=torch.float64)
    y_own = B @ ones
    with mirrors.swapped(capture_signature(B)):
        assert B.state is not own and B._ab_fresh == fresh
        assert all(a is mirrors.static[i] for a, i in zip(B.state, sig.mirrored))
        assert torch.equal(B @ ones, y_own)
    assert B.state is own
    with pytest.raises(RuntimeError, match="replaced the state"):
        with mirrors.swapped(capture_signature(B)):
            B.push(s, y)
    assert B.state is own


def test_chain_timer_syncs_every_run(monkeypatch):
    """``marginal_chain_time`` waits for every run it times (two warm-ups,
    then a long and a short run per rep), and without ``device=`` its
    stopwatch takes the device of the run's output."""
    synced, devices = [], []
    real_sync = timing.sync

    def counting_sync(out):
        synced.append(out)
        real_sync(out)

    class Watch(timing.Stopwatch):
        def __init__(self, device):
            devices.append(torch.device(device))
            super().__init__("cpu")

    monkeypatch.setattr(timing, "sync", counting_sync)
    monkeypatch.setattr(timing, "Stopwatch", Watch)
    outs = []

    def run(iters, dev="cpu"):
        outs.append(torch.zeros(iters, device=dev))
        return outs[-1], iters

    per = timing.marginal_chain_time(run, iters_short=2, iters_long=6, reps=3)
    assert per > 0
    assert len(outs) == len(synced) == 2 + 2 * 3 and devices == [torch.device("cpu")]
    assert all(s_[0] is o for s_, o in zip(synced, outs))
    devices.clear()
    timing.marginal_chain_time(lambda it: run(it, "meta"), iters_short=1, iters_long=2, reps=1)
    assert devices == [torch.device("meta")]
    devices.clear()
    timing.marginal_chain_time(run, iters_short=1, iters_long=2, reps=1, device="cpu")
    assert devices == [torch.device("cpu")]
