"""The port's examples (``examples/torch/``) against the JAX package's, on
the CPU in f64.

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
