"""The port's Clos-routed SpMV (``linops_tpu_torch/sparse/routed.py``) and
``RoutedCSROperator`` against the JAX reference, on the CPU.

Mirrors ``tests/test_routed.py`` and ``tests/test_routed_transpose.py``:

- ``pack_routed_csr`` with ``to_device=False`` gives arrays bit-identical to
  the reference's (dtype, shape and every element), for the 3-stage,
  5-stage, trivial, tiled, ReducePass-fallback and chunked layouts (the
  last two with ``TILED_MAX_K`` / ``CLOS_MAX_SLOTS`` patched in both
  packages), forward and derived transpose.
- the plain pipeline (``use_kernel=False``) against the reference's
  ``use_pallas=False`` in f64: max|Δ| ≤ 1e-10·max|ref| (the same sums in
  other orders).
- the kernel pipeline on CPU tensors (the kernels' plain versions) in f32
  against the reference's ``use_pallas="interpret"``: gathers and products
  agree exactly, and the segment-sum combine's prefix difference errs by
  at most eps·Σ|window|; a window holds at most 128 partials, each at most
  max(|A|·|x|), so max|Δ| ≤ 128·eps_f32·max(|A|·|x|).
- operators in every mode, complex, symmetric, ``backend="xla"``,
  ``defer_transpose``, matrix applies; ``opSparse(format="auto")`` picks
  routed and warns as the reference does.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.sparse import ops as JO
from linops_tpu.sparse import routed as JR
from linops_tpu_torch.convert import routed_from_reference, to_numpy
from linops_tpu_torch.sparse import ops as TO
from linops_tpu_torch.sparse import routed as TR

MODES = ("N", "T", "C", "H")
EPS32 = float(np.finfo(np.float32).eps)


def random_csr(n_r, n_c, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = sps.random(n_r, n_c, density=density, format="csr", random_state=seed, dtype=dtype)
    A.data[:] = rng.standard_normal(A.nnz)
    return A


def rows_csr(n_r, n_c, ks, rng):
    """CSR with ks[i] distinct sorted columns in row i."""
    cols = np.concatenate([np.sort(rng.choice(n_c, k, replace=False)) for k in ks])
    indptr = np.concatenate([[0], np.cumsum(ks)])
    return sps.csr_matrix((rng.standard_normal(indptr[-1]), cols, indptr), shape=(n_r, n_c))


def rel(got, ref) -> float:
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def assert_same_program(ours, ref, path="prog"):
    """Field by field: equal dtypes, shapes and elements; equal statics."""
    if ours is None or ref is None:
        assert ours is None and ref is None, path
        return
    if isinstance(ours, tuple):
        assert isinstance(ref, tuple) and len(ours) == len(ref), path
        if hasattr(ours, "_fields"):
            assert ours._fields == ref._fields, path
        for i, (a, b) in enumerate(zip(ours, ref)):
            name = ours._fields[i] if hasattr(ours, "_fields") else str(i)
            assert_same_program(a, b, f"{path}.{name}")
        return
    if isinstance(ours, np.ndarray):
        b = np.asarray(ref)
        assert ours.dtype == b.dtype and ours.shape == b.shape, (path, ours.dtype, b.dtype)
        assert np.array_equal(ours, b), path
        return
    assert ours == ref, path


def layout(name, monkeypatch):
    """(A, w) of one pack layout; patches both packages where it needs to."""
    rng = np.random.default_rng(hash(name) % 2**31)
    if name == "3stage":
        return random_csr(1000, 1000, 0.004, seed=1), 8
    if name == "5stage":
        return random_csr(5000, 4000, 0.005, seed=2), "auto"
    if name == "trivial":
        return rows_csr(600, 600, rng.integers(1, 4, size=600), rng), 4
    if name == "tiled":
        return random_csr(700, 900, 0.05, seed=3), 4
    if name == "reduce_passes":
        for mod in (JR, TR):
            monkeypatch.setattr(mod, "TILED_MAX_K", 0)
        return random_csr(900, 700, 0.02, seed=41), 8
    assert name == "chunked"
    for mod in (JR, TR):
        monkeypatch.setattr(mod, "CLOS_MAX_SLOTS", 16384)
    return rows_csr(6000, 6000, rng.integers(0, 12, size=6000), rng), "auto"


LAYOUTS = ["3stage", "5stage", "trivial", "tiled", "reduce_passes", "chunked"]


def both_packs(A, w):
    ref = JR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=w, with_transpose=True,
                             to_device=False)
    ours = TR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=w, with_transpose=True,
                              to_device=False)
    return ours, ref


@pytest.mark.parametrize("name", LAYOUTS)
def test_pack_is_bit_identical(name, monkeypatch):
    A, w = layout(name, monkeypatch)
    (fwd, der), (fwd_j, der_j) = both_packs(A, w)
    assert_same_program(fwd, fwd_j)
    assert_same_program(der, der_j)
    expect = {"trivial": lambda: fwd.rowid is None and not fwd.passes,
              "tiled": lambda: fwd.comb_lo is not None,
              "reduce_passes": lambda: fwd.rowid is None and len(fwd.passes) >= 1,
              "chunked": lambda: fwd.vals.shape[0] > 1,
              "5stage": lambda: fwd.vals.shape[1] > 128 and len(fwd.stages) == 4,
              "3stage": lambda: fwd.vals.shape[1] <= 128 and len(fwd.stages) == 2}[name]
    assert expect(), name


@pytest.mark.parametrize("name", LAYOUTS)
def test_plain_pipeline_matches_the_reference_f64(name, monkeypatch):
    A, w = layout(name, monkeypatch)
    (fwd, der), (fwd_j, der_j) = both_packs(A, w)
    fwd, der = TR.upload_program(fwd, "cpu"), TR.upload_program(der, "cpu")
    rng = np.random.default_rng(5)
    x, u = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    X, U = rng.standard_normal((A.shape[1], 3)), rng.standard_normal((A.shape[0], 3))
    assert rel(TR.routed_matvec(fwd, torch.from_numpy(x), use_kernel=False),
               JR.routed_matvec(fwd_j, x, use_pallas=False)) <= 1e-10
    assert rel(TR.routed_matvec(fwd, torch.from_numpy(x)), A @ x) <= 1e-10  # CPU default: plain
    if not fwd.passes:
        assert rel(TR.routed_matmat(fwd, torch.from_numpy(X), use_kernel=False),
                   JR.routed_matmat(fwd_j, X, use_pallas=False)) <= 1e-10
    if der is not None:
        assert rel(TR.routed_rmatvec(der, torch.from_numpy(u), use_kernel=False),
                   JR.routed_rmatvec(der_j, u, use_pallas=False)) <= 1e-10
        assert rel(TR.routed_rmatmat(der, torch.from_numpy(U), use_kernel=False),
                   JR.routed_rmatmat(der_j, U, use_pallas=False)) <= 1e-10
    else:
        assert name == "reduce_passes"


def f32_limit(A, x):
    return 128 * EPS32 * np.abs(abs(A) @ np.abs(x)).max()


@pytest.mark.parametrize("name", ["3stage", "5stage", "trivial", "chunked"])
def test_kernel_pipeline_matches_the_reference_interpret_f32(name, monkeypatch):
    A, w = layout(name, monkeypatch)
    A = A.astype(np.float32)
    (fwd, der), (fwd_j, der_j) = both_packs(A, w)
    fwd, der = TR.upload_program(fwd, "cpu"), TR.upload_program(der, "cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    u = rng.standard_normal(A.shape[0]).astype(np.float32)
    got = to_numpy(TR.routed_matvec(fwd, torch.from_numpy(x), use_kernel=True))
    ref = np.asarray(JR.routed_matvec(fwd_j, jnp.asarray(x), use_pallas="interpret"))
    assert np.abs(got - ref).max() <= f32_limit(A, x)
    got = to_numpy(TR.routed_rmatvec(der, torch.from_numpy(u), use_kernel=True))
    ref = np.asarray(JR.routed_rmatvec(der_j, jnp.asarray(u), use_pallas="interpret"))
    assert np.abs(got - ref).max() <= f32_limit(A.T, u)
    if name in ("3stage", "trivial"):  # the rep-grid kernels, k = 3
        X = rng.standard_normal((A.shape[1], 3)).astype(np.float32)
        U = rng.standard_normal((A.shape[0], 3)).astype(np.float32)
        got = to_numpy(TR.routed_matmat(fwd, torch.from_numpy(X), use_kernel=True))
        ref = np.asarray(JR.routed_matmat(fwd_j, jnp.asarray(X), use_pallas="interpret"))
        assert np.abs(got - ref).max() <= f32_limit(A, np.abs(X).max(1))
        got = to_numpy(TR.routed_rmatmat(der, torch.from_numpy(U), use_kernel=True))
        ref = np.asarray(JR.routed_rmatmat(der_j, jnp.asarray(U), use_pallas="interpret"))
        assert np.abs(got - ref).max() <= f32_limit(A.T, np.abs(U).max(1))


def test_panel_layout_matches_dense_layout():
    A = random_csr(700, 900, 0.03, seed=9)
    fwd, der = TR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=8,
                                  with_transpose=True, device="cpu")
    rng = np.random.default_rng(1)
    X, U = torch.from_numpy(rng.standard_normal((900, 4))), torch.from_numpy(
        rng.standard_normal((700, 4)))
    assert torch.equal(TR.routed_matmat(fwd, X.t().contiguous(), panel=True),
                       TR.routed_matmat(fwd, X).t())
    assert torch.equal(TR.routed_rmatmat(der, U.t().contiguous(), panel=True),
                       TR.routed_rmatmat(der, U).t())


def test_pack_defaults_to_the_card_and_checks_its_input(monkeypatch):
    A = random_csr(100, 100, 0.05, seed=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lt.LinearOperatorException, match='device="cpu"'):
        TR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape)
    with pytest.raises(ValueError):
        TR.pack_routed_csr(np.zeros(0), np.zeros(0, np.int64), np.zeros(101, np.int64),
                           (100, 100), device="cpu")
    with pytest.raises(ValueError):
        TR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=7, device="cpu")


def test_tiled_combine_without_bounds_names_k13(monkeypatch):
    """A tiled program whose segment bounds were dropped combines through K13
    (``tiled_combine``) on the kernel pipeline, as the reference's takes its
    one-hot kernel: against the reference's ``use_pallas="interpret"`` on the
    same program within 1e-6 relative in f32, and against the plain
    pipeline; the multi-column apply runs K13 with rep = k."""
    A = random_csr(700, 900, 0.05, seed=3).astype(np.float32)
    (fwd, _), (fwd_j, _) = both_packs(A, 4)
    assert fwd.comb_lo is not None and fwd.rowid is not None
    p = TR.upload_program(fwd, "cpu")._replace(comb_lo=None, comb_hi=None)
    p_j = fwd_j._replace(comb_lo=None, comb_hi=None)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(900).astype(np.float32)
    calls = []
    real = TR.LG.tiled_combine
    monkeypatch.setattr(TR.LG, "tiled_combine", lambda *a, **k: (calls.append(k), real(*a, **k))[1])
    y = TR.routed_matvec(p, torch.from_numpy(x), use_kernel=True)
    assert calls == [{"rep": 1}]
    ref = np.asarray(JR.routed_matvec(p_j, jnp.asarray(x), use_pallas="interpret"))
    assert rel(y, ref) <= 1e-6
    assert rel(y, TR.routed_matvec(p, torch.from_numpy(x), use_kernel=False)) <= 1e-6
    assert rel(y, A.astype(np.float64) @ x) <= 1e-5
    X = rng.standard_normal((900, 3)).astype(np.float32)
    Y = TR.routed_matmat(p, torch.from_numpy(X), use_kernel=True)
    assert calls[-1] == {"rep": 3}
    assert rel(Y, np.asarray(JR.routed_matmat(p_j, jnp.asarray(X), use_pallas="interpret"))) <= 1e-6


def test_plain_combine_builds_its_order_once_per_program(monkeypatch):
    """The plain pipeline's tiled combine builds its segment plan at the
    program's first apply and keeps it with the program's ``rowid``: later
    applies (vector and matrix, forward and conjugate) build none and give
    the same bits; a copy of the program on another tensor builds its own."""
    A = random_csr(700, 900, 0.05, seed=3)
    fwd, _ = both_packs(A, 4)[0]
    p = TR.upload_program(fwd, "cpu")
    assert p.rowid is not None
    built = []
    real = TR.LG.segment_plan
    monkeypatch.setattr(TR.LG, "segment_plan", lambda *a, **k: built.append(1) or real(*a, **k))
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(900))
    y = TR.routed_matvec(p, x)
    assert len(built) == 1 and rel(y, A @ x.numpy()) <= 1e-12
    assert torch.equal(TR.routed_matvec(p, x), y)
    TR.routed_matmat(p, torch.stack([x, 2 * x], dim=1))
    TR.routed_matvec(p._replace(vals=p.vals.conj()), x)
    assert len(built) == 1
    TR.routed_matvec(p._replace(rowid=p.rowid.clone()), x)
    assert len(built) == 2


# ----------------------------------------------------------------------------
# Operators
# ----------------------------------------------------------------------------


def check_modes(op_t, op_j, rng, complex_, tol=1e-10):
    for mode in MODES:
        n = op_t.in_dim(mode)
        v = rng.standard_normal(n) + (1j * rng.standard_normal(n) if complex_ else 0)
        assert rel(op_t.matvec(torch.from_numpy(v), mode=mode),
                   op_j.matvec(jnp.asarray(v), mode=mode)) <= tol, mode
        M = rng.standard_normal((n, 3)) + (1j * rng.standard_normal((n, 3)) if complex_ else 0)
        assert rel(op_t.matmat(torch.from_numpy(M), mode=mode),
                   op_j.matmat(jnp.asarray(M), mode=mode)) <= tol, mode


@pytest.mark.parametrize("complex_", [False, True])
def test_routed_operator_all_modes(complex_):
    A = random_csr(800, 600, 0.02, seed=11)
    if complex_:
        A = A.astype(np.complex128)
        A.data = A.data + 1j * np.random.default_rng(1).standard_normal(A.nnz)
    op_t = lt.opSparse(A, format="routed", device="cpu")
    op_j = lo.opSparse(A, format="routed")
    assert isinstance(op_t, lt.RoutedCSROperator)
    assert isinstance(op_t.routed_t, TR.RoutedTranspose)  # derived at construction
    check_modes(op_t, op_j, np.random.default_rng(2), complex_)
    assert rel(op_t.to_dense(), A.toarray()) <= 1e-12


@pytest.mark.parametrize("complex_", [False, True])
def test_routed_matrix_branch_all_modes(monkeypatch, complex_):
    """The routed matmat (taken on the card) in every mode, reached on the
    CPU through the ``_on_card`` seam, as the reference's test patches
    ``_on_tpu``."""
    A = random_csr(300, 260, 0.03, seed=61)
    if complex_:
        A = A.astype(np.complex128)
        A.data = A.data + 1j * np.random.default_rng(3).standard_normal(A.nnz)
    op_t = lt.opSparse(A, format="routed", device="cpu")
    op_j = lo.opSparse(A, format="routed")
    monkeypatch.setattr(TO, "_on_card", lambda t: True)
    monkeypatch.setattr(JO, "_on_tpu", lambda: True)
    assert op_t.matrix_path("N") == "routed" and op_t.matrix_path("T", panel=True) == "routed_panel"
    rng = np.random.default_rng(4)
    check_modes(op_t, op_j, rng, complex_)
    for mode in MODES:
        n = op_t.in_dim(mode)
        Mt = rng.standard_normal((2, n)) + (1j * rng.standard_normal((2, n)) if complex_ else 0)
        assert rel(op_t.apply_matrix_t(torch.from_numpy(Mt), mode),
                   op_j.apply_matrix_t(jnp.asarray(Mt), mode)) <= 1e-10, mode


def test_routed_symmetric_serves_transpose_with_the_forward_program(monkeypatch):
    B = random_csr(300, 300, 0.03, seed=71)
    S = (B + B.T).tocsr()
    op_t = lt.opSparse(S, format="routed", symmetric=True, hermitian=True, device="cpu")
    op_j = lo.opSparse(S, format="routed", symmetric=True, hermitian=True)
    assert op_t.routed_t is None
    monkeypatch.setattr(TO, "_on_card", lambda t: True)
    check_modes(op_t, op_j, np.random.default_rng(5), False)
    assert op_t.routed_t is None  # never packed


def test_routed_backend_xla_and_torch_alias():
    A = random_csr(500, 400, 0.02, seed=21)
    op = lt.opSparse(A, format="routed", device="cpu")
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(400))
    for backend in ("xla", "torch"):
        plain = lt.RoutedCSROperator(op.data, backend=backend)
        assert plain.routed is None and plain._backend == "xla"
        assert rel(plain * v, A @ v.numpy()) <= 1e-12 and rel(op * v, plain * v) <= 1e-12
    with pytest.raises(ValueError, match="unknown routed backend"):
        lt.RoutedCSROperator(op.data, backend="pallas")


def test_defer_transpose_packs_at_first_transpose():
    A = random_csr(300, 300, 0.03, seed=23)
    op = lt.opSparse(A, format="routed", device="cpu", w=32)
    assert op.routed.w == 32
    op_d = lt.RoutedCSROperator(op.data, defer_transpose=True, w=32)
    assert op_d.routed_t is None
    u = np.random.default_rng(2).standard_normal(300)
    got = op_d.T * torch.from_numpy(u)
    assert isinstance(op_d.routed_t, TR.RoutedSpMV) and op_d.routed_t.w == 32  # full re-pack
    assert rel(got, A.T @ u) <= 1e-11


def test_routed_operator_moves_with_to_and_from_reference():
    A = random_csr(1200, 1100, 0.01, seed=11)
    op = lt.opSparse(A, format="routed", device="cpu")
    moved = op.to("cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(1100))
    assert torch.equal(moved * x, op * x) and moved.routed.vals.device.type == "cpu"
    fwd_j, der_j = JR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape, with_transpose=True,
                                      to_device=False)
    fwd, der = routed_from_reference(fwd_j, der_j, device="cpu")
    op_r = lt.RoutedCSROperator(op.data, routed=fwd, routed_t=der)
    assert rel(op_r * x, A @ x.numpy()) <= 1e-12
    u = np.random.default_rng(5).standard_normal(1200)
    assert rel(op_r.T * torch.from_numpy(u), A.T @ u) <= 1e-12


def test_routed_from_reference_takes_reduce_pass_chains(monkeypatch):
    for mod in (JR, TR):
        monkeypatch.setattr(mod, "TILED_MAX_K", 0)
    A = random_csr(900, 700, 0.02, seed=41)
    fwd_j = JR.pack_routed_csr(A.data, A.indices, A.indptr, A.shape, w=8, to_device=False)
    assert fwd_j.passes  # stage arrays the reference keeps as device arrays
    fwd, der = routed_from_reference(fwd_j, device="cpu")
    assert der is None and isinstance(fwd.passes[0], TR.ReducePass)
    x = np.random.default_rng(6).standard_normal(700)
    assert rel(TR.routed_matvec(fwd, torch.from_numpy(x)), A @ x) <= 1e-12


def test_auto_picks_routed_and_warns_like_the_reference(monkeypatch):
    A = random_csr(4096, 4096, 16 / 4096, seed=17)
    for mod in (JO, TO):
        monkeypatch.setattr(mod, "ROUTED_AUTO_WARN_NNZ", 1000)
    for build in (lambda: lt.opSparse(A, format="auto", device="cpu"),
                  lambda: lo.opSparse(A, format="auto")):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            op = build()
        assert type(op).__name__ == "RoutedCSROperator"
        assert any("pack" in str(w.message) for w in rec)
    for mod in (JO, TO):
        monkeypatch.setattr(mod, "ROUTED_AUTO_MAX_NNZ", 1000)
    with pytest.warns(UserWarning, match="cap"):
        op = lt.opSparse(A, format="auto", device="cpu")
    assert type(op) is lt.CSROperator
    v = np.random.default_rng(1).standard_normal(4096)
    assert rel(op * torch.from_numpy(v), A @ v) <= 1e-12


def test_routed_dense_and_prebuilt_inputs():
    rng = np.random.default_rng(8)
    Ad = rng.standard_normal((150, 170)) * (rng.random((150, 170)) < 0.05)
    v = rng.standard_normal(170)
    op = lt.opSparse(Ad, format="routed", device="cpu")
    assert isinstance(op, lt.RoutedCSROperator) and rel(op * torch.from_numpy(v), Ad @ v) <= 1e-12
    op2 = lt.opSparse(lt.csr_from_dense(Ad, device="cpu"), format="routed")  # keeps its device
    assert isinstance(op2, lt.RoutedCSROperator) and rel(op2 * torch.from_numpy(v), Ad @ v) <= 1e-12
    op3 = lt.opSparse(Ad.astype(np.float32), format="routed", dtype=torch.bfloat16, device="cpu")
    assert op3.routed.vals.dtype == torch.bfloat16 and op3.routed_t.vals_pre.dtype == torch.bfloat16
