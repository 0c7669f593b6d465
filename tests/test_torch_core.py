"""Parity of the PyTorch port's operator core with the JAX reference.

The same inputs, made with numpy from a seed, go through ``linops_tpu`` and
``linops_tpu_torch`` in f64 on the CPU. Agreement: max|Δ| ≤ 1e-10·max|ref|
(the baseline's f64 tolerance, BASELINE.md)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu_torch.core.base import compose_modes as t_compose_modes

RTOL = 1e-10
MODES = ("N", "T", "C", "H")


def assert_rel(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-300)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"max|Δ| {err:.3e} > {rtol:g}·{scale:.3e}"


def rand(rng, *shape, complex_=False):
    a = rng.standard_normal(shape)
    if complex_:
        a = a + 1j * rng.standard_normal(shape)
    return a


def both_apply(op_j, op_t, v, mode):
    return op_j.matvec(jnp.asarray(v), mode=mode), op_t.matvec(torch.from_numpy(v), mode=mode)


def test_compose_modes_table():
    from linops_tpu.core.base import compose_modes

    for a in MODES:
        for b in MODES:
            assert t_compose_modes(a, b) == compose_modes(a, b)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("shape", [(12, 12), (9, 14), (14, 9)])
@pytest.mark.parametrize("mode", MODES)
def test_matrix_operator_modes(rng, shape, complex_, mode):
    M = rand(rng, *shape, complex_=complex_)
    op_j, op_t = lo.LinearOperator(jnp.asarray(M)), lt.LinearOperator(torch.from_numpy(M))
    v = rand(rng, op_t.in_dim(mode), complex_=complex_)
    yj, yt = both_apply(op_j, op_t, v, mode)
    assert_rel(yt, yj)
    assert op_t.shape == op_j.shape


def _function_ops(M, which):
    """The same function-backed operator in both packages, with only the
    product slots named by ``which``."""
    Mj, Mt = jnp.asarray(M), torch.from_numpy(M)
    n, m = M.shape
    sym = which == "prod_sym"
    kw_j = dict(prod=lambda v: Mj @ v)
    kw_t = dict(prod=lambda v: Mt @ v)
    if which == "tprod":
        kw_j["tprod"], kw_t["tprod"] = (lambda u: Mj.T @ u), (lambda u: Mt.T @ u)
    if which == "ctprod":
        kw_j["ctprod"] = lambda w: jnp.conj(Mj).T @ w
        kw_t["ctprod"] = lambda w: Mt.conj().T @ w
    dt_j, dt_t = jnp.complex128, torch.complex128
    op_j = lo.LinearOperator(dt_j, n, m, sym, False, kw_j.pop("prod"), **kw_j)
    op_t = lt.LinearOperator(dt_t, n, m, sym, False, kw_t.pop("prod"), **kw_t)
    return op_j, op_t


@pytest.mark.parametrize("which", ["prod", "prod_sym", "tprod", "ctprod"])
@pytest.mark.parametrize("mode", MODES)
def test_function_operator_inference_lattice(rng, which, mode):
    n = 10
    M = rand(rng, n, n, complex_=True)
    if which == "prod_sym":
        M = M + M.T
    op_j, op_t = _function_ops(M, which)
    v = rand(rng, n, complex_=True)
    if which == "prod" and mode in ("T", "H"):
        with pytest.raises(lo.LinearOperatorException):
            op_j.matvec(jnp.asarray(v), mode=mode)
        with pytest.raises(lt.LinearOperatorException, match="unable to infer"):
            op_t.matvec(torch.from_numpy(v), mode=mode)
        return
    yj, yt = both_apply(op_j, op_t, v, mode)
    assert_rel(yt, yj)
    assert (op_t.nprod, op_t.ntprod, op_t.nctprod) == (op_j.nprod, op_j.ntprod, op_j.nctprod)


def _graph(pkg, arr, M1, M2, d, alpha):
    A = pkg.LinearOperator(arr(M1))
    B = pkg.LinearOperator(arr(M2), symmetric=True, hermitian=not np.iscomplexobj(M2))
    D = pkg.opDiagonal(arr(d))
    n = M1.shape[0]
    g = alpha * (A @ B) + A.T - D.H + (B @ D) / 3.0 + pkg.opEye(n, dtype=getattr(
        jnp if pkg is lo else torch, "float64"))
    return g, (A, B, D)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_algebra_graph_modes_flags_counters(rng, complex_, mode):
    n = 11
    M1 = rand(rng, n, n, complex_=complex_)
    M2 = rand(rng, n, n)
    M2 = M2 + M2.T
    d = rand(rng, n, complex_=complex_)
    alpha = 2.0 - 0.5j if complex_ else 2.5
    gj, leaves_j = _graph(lo, jnp.asarray, M1, M2, d, alpha)
    gt, leaves_t = _graph(lt, torch.from_numpy, M1, M2, d, alpha)
    v = rand(rng, n, complex_=complex_)
    for _ in range(2):
        yj, yt = both_apply(gj, gt, v, mode)
    assert_rel(yt, yj)
    assert (gt.symmetric, gt.hermitian) == (gj.symmetric, gj.hermitian)
    assert str(gt.dtype).replace("torch.", "") == jnp.dtype(gj.dtype).name
    for lj, ltt in zip(leaves_j, leaves_t):
        assert (ltt.nprod, ltt.ntprod, ltt.nctprod) == (lj.nprod, lj.ntprod, lj.nctprod)


@pytest.mark.parametrize("wrap", ["T", "H", "conj", "TH", "HH"])
@pytest.mark.parametrize("mode", MODES)
def test_adjoint_wrappers(rng, wrap, mode):
    M = rand(rng, 7, 5, complex_=True)
    ops = []
    for pkg, arr in ((lo, jnp.asarray), (lt, torch.from_numpy)):
        op = pkg.LinearOperator(arr(M))
        w = {"T": op.T, "H": op.H, "conj": op.conj(), "TH": op.T.H, "HH": op.H.H}[wrap]
        ops.append((op, w))
    (pj, wj), (pt, wt) = ops
    assert wt.shape == wj.shape and type(wt).__name__ == type(wj).__name__
    v = rand(rng, wt.in_dim(mode), complex_=True)
    yj, yt = both_apply(wj, wt, v, mode)
    assert_rel(yt, yj)
    assert (wt.nprod, wt.ntprod, wt.nctprod) == (wj.nprod, wj.ntprod, wj.nctprod)
    assert (pt.nprod, pt.ntprod, pt.nctprod) == (pj.nprod, pj.ntprod, pj.nctprod)


@pytest.mark.parametrize("case", ["beta_none", "beta_zero_nan", "beta_tensor_zero_nan",
                                  "alpha_beta", "matrix_rhs", "donate"])
@pytest.mark.parametrize("mode", ["N", "H"])
def test_five_arg_mul(rng, case, mode):
    M = rand(rng, 8, 6, complex_=True)
    op_j, op_t = lo.LinearOperator(jnp.asarray(M)), lt.LinearOperator(torch.from_numpy(M))
    k = 3 if case == "matrix_rhs" else None
    shape_in = (op_t.in_dim(mode),) if k is None else (op_t.in_dim(mode), k)
    shape_out = (op_t.out_dim(mode),) if k is None else (op_t.out_dim(mode), k)
    v = rand(rng, *shape_in, complex_=True)
    res = rand(rng, *shape_out, complex_=True)
    if "nan" in case:
        res[...] = np.nan
    alpha, beta = {"beta_none": (None, None), "beta_zero_nan": (1.5, 0),
                   "beta_tensor_zero_nan": (1.5, "tensor0"), "alpha_beta": (0.5 + 1j, -2.0),
                   "matrix_rhs": (2.0, 0.25), "donate": (2.0, 0.5)}[case]
    bj = jnp.asarray(0.0) if beta == "tensor0" else beta
    bt = torch.tensor(0.0, dtype=torch.float64) if beta == "tensor0" else beta
    donate = case == "donate"
    yj = lo.mul(op_j, jnp.asarray(v), alpha, bj, jnp.asarray(res), mode=mode)
    res_t = torch.from_numpy(res.copy())
    yt = lt.mul(op_t, torch.from_numpy(v), alpha, bt, res_t, mode=mode, donate=donate)
    assert np.isfinite(yt.numpy()).all()
    assert_rel(yt, yj)
    if donate:
        assert yt is res_t


def test_mul_nonzero_beta_needs_res(rng):
    op = lt.LinearOperator(torch.from_numpy(rand(rng, 4, 4)))
    with pytest.raises(lt.LinearOperatorException, match="requires res"):
        lt.mul(op, torch.ones(4, dtype=torch.float64), 1.0, 2.0)


@pytest.mark.parametrize("shape", [(6, 6), (4, 9), (9, 4)])
@pytest.mark.parametrize("mode", MODES)
def test_eye_and_diagonal(rng, shape, mode):
    d = rand(rng, min(shape), complex_=True)
    for mk in (lambda pkg, arr: pkg.opEye(*shape),
               lambda pkg, arr: pkg.opDiagonal(shape[0], shape[1], arr(d))):
        op_j, op_t = mk(lo, jnp.asarray), mk(lt, torch.from_numpy)
        assert (op_t.symmetric, op_t.hermitian) == (op_j.symmetric, op_j.hermitian)
        v = rand(rng, op_t.in_dim(mode), complex_=True)
        yj, yt = both_apply(op_j, op_t, v, mode)
        assert_rel(yt, yj)
        Mv = rand(rng, op_t.in_dim(mode), 3, complex_=True)
        assert_rel(op_t.matmat(torch.from_numpy(Mv), mode=mode),
                   op_j.matmat(jnp.asarray(Mv), mode=mode))


def test_universal_eye_passthrough(rng):
    op = lt.LinearOperator(torch.from_numpy(rand(rng, 3, 3)))
    v = torch.ones(3, dtype=torch.float64)
    I = lt.opEye()
    assert I * op is op and op * I is op and I * v is v
    with pytest.raises(lt.LinearOperatorException):
        2.0 * I


def test_to_dense_power_and_symmetrizers(rng):
    M = rand(rng, 9, 9, complex_=True)
    op_j, op_t = lo.LinearOperator(jnp.asarray(M)), lt.LinearOperator(torch.from_numpy(M))
    assert_rel(op_t.to_dense(), op_j.to_dense())
    assert_rel((op_t ** 3).to_dense(), (op_j ** 3).to_dense())
    assert_rel((op_t ** 0).to_dense(), np.eye(9))
    for name in ("hermitianized", "symmetrized"):
        hj, ht = getattr(op_j, name)(), getattr(op_t, name)()
        assert (ht.symmetric, ht.hermitian) == (hj.symmetric, hj.hermitian)
        assert_rel(ht.to_dense(), hj.to_dense())


def test_shape_and_eltype_errors(rng):
    A = lt.LinearOperator(torch.from_numpy(rand(rng, 4, 5)))
    with pytest.raises(lt.LinearOperatorException, match="shape mismatch"):
        A * torch.ones(4, dtype=torch.float64)
    with pytest.raises(lt.LinearOperatorException, match="shape mismatch"):
        A @ A
    with pytest.raises(lt.LinearOperatorException, match="shape mismatch"):
        A + A.T
    liar = lt.LinearOperator(torch.float64, 3, 3, False, False,
                             lambda v: v.to(torch.complex128) * 1j)
    with pytest.raises(lt.LinearOperatorException, match="incompatible with declared"):
        liar * torch.ones(3, dtype=torch.float64)


def test_numpy_operands_and_scalar_dtypes(rng):
    M = rand(rng, 5, 5).astype(np.float32)
    op = lt.LinearOperator(torch.from_numpy(M))
    assert (2.0 * op).dtype == torch.float32  # Python scalars are weakly typed
    assert (1j * op).dtype == torch.complex64
    assert (torch.tensor(2.0, dtype=torch.float64) * op).dtype == torch.float64
    v = np.arange(5, dtype=np.float32)
    assert_rel((op * v).numpy(), M @ v, rtol=1e-6)
    assert_rel((v @ op).numpy(), M.T @ v, rtol=1e-6)


def test_to_device_copies_tensors_and_resets_counters(rng):
    M = rand(rng, 6, 6)
    op = lt.opDiagonal(torch.from_numpy(rand(rng, 6))) @ lt.LinearOperator(torch.from_numpy(M))
    v = torch.from_numpy(rand(rng, 6))
    y = op * v
    moved = op.to("cpu")
    assert moved is not op and moved.op2 is not op.op2 and moved.device == torch.device("cpu")
    assert moved.nprod == 0 and op.nprod == 1
    assert torch.equal(moved * v, y)
    assert lt.opEye(3).device is None


def test_precision_policy_mapping():
    from linops_tpu.core.precision import matmul_precision as jax_policy
    import jax

    for dts in ((torch.float32,), (torch.float64, torch.float32), (torch.bfloat16, torch.float32)):
        jd = [jnp.dtype(str(d).replace("torch.", "")) for d in dts]
        expect = "default" if jax_policy(*jd) == jax.lax.Precision.DEFAULT else "highest"
        assert lt.matmul_precision(*dts) == expect
    # the policy changes no global flag, and CPU tensors never trip the check
    assert lt.f32_exact()
    lt.check_f32_exact(torch.ones(2), torch.ones(2))
    assert math.isclose(float(lt.core.precision.pvdot(torch.ones(3), torch.ones(3))), 3.0)
