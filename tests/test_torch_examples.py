"""The port's examples (``examples/torch/``) against the JAX package's, on
the CPU. Each JAX example is loaded as a module (it runs at import, as a
script), and the port's ``main("cpu")`` runs on the same inputs (numpy's
seeds; the JAX examples that seed ``jax.random`` keys draw numbers the port
cannot share).

- Deterministic outputs that the same inputs reach in both agree at rtol
  1e-10 in f64 (01, 02, 04, 05, 07's heat kernel, 09's applies); the f32
  examples (03, 06) at the f32 level, 1e-5 (sums in other orders), and
  their bf16 tier within its own rounding.
- Iteration counts agree within ±1.
- Seeded-random outputs (07's LOBPCG start blocks, Hutch++, the diagonal
  probes and the Nyström sketch; 08's LOBPCG start block) are held against
  the exact value within the error bound the example itself prints: the
  LOBPCG tolerance, 6 standard errors, the opnorm's rtol.
- 03 and 08 run in gloo worlds (``parallel.launch``): 03 on 4 ranks, 08 on
  8, the reference's 4 x 2 mesh, whose collective counts are its contract.

``04_trust_region_on_device.py``: the same L-BFGS model and Levenberg
search; the port's σ-search runs on ``utils/loop.py::device_while`` with σ
a tensor (one host read per block). Its step, step norm, final σ and the
shifted system's residual are held against the JAX example's
``tr_subproblem`` at rtol 1e-10.
"""

import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import torch
from torch_refnative import ensure_reference_native

# the reference's native libraries whole before any example calls them
ensure_reference_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trust_region_on_device_matches_the_jax_example(capsys):
    ref = load("examples/04_trust_region_on_device.py", "jax_example_04")
    port = load("examples/torch/04_trust_region_on_device.py", "torch_example_04")
    from linops_tpu_torch.utils import loop

    p, sigma, resid = port.main(torch.device("cpu"))
    assert loop.stats["path"] == "blocks"
    # σ = 0.1, 0.3, 0.7, 1.5, 3.1, 6.3: six iterations, one read per block
    assert loop.stats["reads"] == loop.stats["blocks"] + 1 == math.ceil(6 / loop.BLOCK) + 1
    assert "on-device trust-region subproblem: OK" in capsys.readouterr().out
    p_ref, sigma_ref = ref.tr_subproblem(ref.B, jnp.asarray(ref.g), 0.5)
    p_ref = np.asarray(p_ref)
    assert p.dtype == torch.float64 and p.shape == p_ref.shape
    assert np.linalg.norm(p.numpy() - p_ref) <= 1e-10 * np.linalg.norm(p_ref)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(p)), np.linalg.norm(p_ref),
                               rtol=1e-10)
    np.testing.assert_allclose(float(sigma), float(sigma_ref), rtol=1e-10)
    resid_ref = (np.asarray(ref.B.to_dense()) + float(sigma_ref) * np.eye(ref.n)) @ p_ref \
        + np.asarray(ref.g)
    np.testing.assert_allclose(np.linalg.norm(resid), np.linalg.norm(resid_ref),
                               rtol=1e-10, atol=1e-13)
    # the same model: the port's dense B is the reference's
    np.testing.assert_allclose(port.build_model("cpu")[0].to_dense().numpy(),
                               np.asarray(ref.B.to_dense()), rtol=1e-10, atol=1e-12)


def close(got, want, rtol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def test_operator_algebra_matches_the_jax_example(capsys):
    ref = load("examples/01_operator_algebra.py", "jax_example_01")
    ref_counts = (ref.expr.nprod, ref.expr.ntprod, ref.expr.nctprod)  # before the applies below
    port = load("examples/torch/01_operator_algebra.py", "torch_example_01")
    r = port.main("cpu")
    assert "expr * v" in capsys.readouterr().out
    close(r["y"], ref.expr * ref.v)
    close(r["yH"], ref.expr.H * ref.v)
    close(r["dense"], ref.expr.to_dense())
    assert tuple(r["sub_shape"]) == tuple(ref.sub.shape)
    close(r["sub_dense"], ref.sub.to_dense())
    assert (tuple(r["blk_shape"]), tuple(r["cat_shape"]), tuple(r["kron_shape"])) == (
        tuple(ref.blk.shape), tuple(ref.cat.shape), tuple(ref.K.shape))
    close(r["kron_ones"], ref.K * jnp.ones(ref.n * ref.n))
    c = r["counters"]
    assert (c.nprod, c.ntprod, c.nctprod) == ref_counts == (1, 1, 0)


def test_lbfgs_preconditioned_cg_matches_the_jax_example():
    ref = load("examples/02_lbfgs_preconditioned_cg.py", "jax_example_02")
    port = load("examples/torch/02_lbfgs_preconditioned_cg.py", "torch_example_02")
    r = port.main("cpu")
    assert abs(r["it0"] - int(ref.it0)) <= 1 and abs(r["it1"] - int(ref.it1)) <= 1
    close(r["x0"], ref.x0)
    close(r["x1"], ref.x1)
    close(r["x_shifted"], ref.x)
    assert r["resid"] <= 1e-12 and float(ref.resid) <= 1e-12
    assert r["insert"] == (int(ref.B2.insert), int(ref.B.insert))
    close(r["restored_apply"], r["apply"], rtol=0.0)  # the checkpoint restores every bit
    close(r["apply"], ref.B * ref.b)


def run_world(rel, n_ranks):
    from linops_tpu_torch.parallel import launch

    return launch.run(os.path.join(ROOT, rel) + ":main", n_ranks, args=("cpu",),
                      backend="gloo", timeout=600)[0]


def test_sparse_and_sharded_matches_the_jax_example():
    """f32 data: the CSR-vs-BSR agreement and ‖A‖₂ at the f32 level; the
    sharded chain and the halo apply in a 4-rank gloo world."""
    ref = load("examples/03_sparse_and_sharded.py", "jax_example_03")
    r = run_world("examples/torch/03_sparse_and_sharded.py", 4)
    assert r["world"] == 4 and r["nnz"] == ref.S_csr.nnz
    assert r["rel"] <= 1e-6
    np.testing.assert_allclose(r["norm2"], float(np.sqrt(np.asarray(ref.lam).real)), rtol=1e-5)
    assert np.isfinite(r["chain"]).all()
    close(r["chain"], ref.out, rtol=1e-5)
    assert r["halo_err"] <= 1e-6
    assert any("halo matvec rel err" in line for line in r["lines"])


def test_trust_region_on_device_is_held_above():
    """(example 04: ``test_trust_region_on_device_matches_the_jax_example``)"""
    assert os.path.exists(os.path.join(ROOT, "examples/torch/04_trust_region_on_device.py"))


def test_least_squares_matches_the_jax_example():
    ref = load("examples/05_least_squares.py", "jax_example_05")
    port = load("examples/torch/05_least_squares.py", "torch_example_05")
    r = port.main("cpu")
    close(r["b"], ref.b)
    assert abs(r["iters"] - int(ref.iters)) <= 1
    close(r["x"], ref.x)
    np.testing.assert_allclose(r["res"], ref.res, rtol=1e-10)
    assert r["err"] < 1e-6 and ref.err < 1e-6


def test_mixed_precision_chains_match_the_jax_example():
    """f32 applies and power iterations at the f32 level; the bf16 tier
    within bf16 rounding of f32 in both packages (their bf16 paths round at
    other places)."""
    ref = load("examples/06_mixed_precision_chains.py", "jax_example_06")
    port = load("examples/torch/06_mixed_precision_chains.py", "torch_example_06")
    r = port.main("cpu")
    close(r["y32"], np.asarray(ref.y32), rtol=1e-5)
    assert r["rel"] <= 1e-2 and ref.rel <= 1e-2
    assert r["finite"] == (True, True)
    close(r["w32"], np.asarray(ref.w32, dtype=np.float64), rtol=1e-4)
    np.testing.assert_allclose(r["lam32"], float(jnp.abs(ref.lam32)), rtol=1e-5)
    assert abs(r["lam16"] - r["lam32"]) <= 0.05 * r["lam32"]


def test_spectral_analysis_matches_the_jax_example():
    """On the reference's potential: eigenvalues within the LOBPCG
    tolerance of the dense spectrum, the trace within 6 standard errors,
    the diagonal within 6 standard errors per entry, the opnorm within its
    rtol of the largest eigenvalue, the heat kernel at rtol 1e-10, and a
    Nyström-preconditioned CG that converges in fewer iterations."""
    ref = load("examples/07_spectral_analysis.py", "jax_example_07")
    port = load("examples/torch/07_spectral_analysis.py", "torch_example_07")
    r = port.main("cpu", potential=np.asarray(ref.potential))
    ev = np.linalg.eigvalsh(np.asarray(ref.A.to_dense()))
    th = r["theta"].numpy()
    assert r["iters_m"] < 500 and r["iters_m"] < r["iters"] + 1
    np.testing.assert_allclose(th, ev[:4], rtol=0, atol=1e-8 * ev[3])
    np.testing.assert_allclose(th, np.asarray(ref.theta), rtol=1e-8)
    est, se = r["trace"]
    assert r["tr_true"] == ref.tr_true and abs(est - r["tr_true"]) <= 6 * se
    d_est, d_se = r["diag"]
    d_true = 4.0 + np.asarray(ref.potential)
    assert (np.abs(d_est.numpy() - d_true) <= 6 * d_se.numpy() + 1e-12).all()
    nrm, ok = r["opnorm"]
    assert ok and abs(nrm - ev[-1]) <= 1e-7 * ev[-1] and abs(nrm - ref.nrm) <= 1e-7 * ev[-1]
    assert abs(r["th_top"] - ev[-1]) <= r["res_top"] + 1e-8 * ev[-1]
    close(r["u"], ref.u)
    assert r["it_nys"] < r["it_plain"] and r["cg_residual"] <= 1e-9
    assert abs(r["it_plain"] - int(ref.it_plain)) <= 30  # another (random) spike and rhs


def test_domain_decomposition_matches_the_jax_example():
    """The reference's 4 x 2 mesh in an 8-rank gloo world: 4 exchange rounds
    and no all-gather per apply, CG's count (±1) and solution at rtol 1e-10,
    and the two lowest modes within the LOBPCG tolerance of the analytic
    spectrum (another start block than the reference's)."""
    ref = load("examples/08_domain_decomposition.py", "jax_example_08")
    r = run_world("examples/torch/08_domain_decomposition.py", 8)
    assert r["mesh"] == (4, 2)
    assert r["counts"].get("collective-permute", 0) == ref.counts["collective-permute"] == 4
    assert r["counts"].get("all-gather", 0) == ref.counts["all-gather"] == 0
    assert abs(r["iters"] - int(ref.iters)) <= 1
    close(r["x"], ref.x)
    close(r["U"], ref.U)
    i, j = np.arange(1, ref.ny + 1), np.arange(1, ref.nx + 1)
    lam = np.sort((4 - 2 * np.cos(i[:, None] * np.pi / (ref.ny + 1))
                   - 2 * np.cos(j[None, :] * np.pi / (ref.nx + 1))).ravel())
    np.testing.assert_allclose(r["theta"][0], r["lam0"], rtol=0, atol=1e-8)
    assert np.all(np.abs(r["theta"] - lam[:2]) <= r["resnorms"] + 1e-12)
    np.testing.assert_allclose(r["theta"], np.asarray(ref.theta), rtol=1e-6)


def test_unstructured_spmv_matches_the_jax_example(capsys):
    ref = load("examples/09_unstructured_spmv.py", "jax_example_09")
    port = load("examples/torch/09_unstructured_spmv.py", "torch_example_09")
    r = port.main("cpu")
    assert "auto picked: RoutedCSROperator" in capsys.readouterr().out
    assert type(ref.op).__name__ == "RoutedCSROperator"
    for key in ("forward", "adjoint", "chain", "rcm", "reorder"):
        assert r[key] <= 1e-14, key
    assert r["perm_exact"] and r["perm_roundtrip"]
    assert r["inner"] == type(ref.op_re.inner).__name__
