"""The port's Clos router (``linops_tpu_torch/sparse/routing.py`` and the
native router) against the JAX reference's, on the CPU.

Mirrors ``tests/test_routing.py``, and adds: for random permutations (1-,
3- and 5-stage) the port's stage arrays, from its numpy router and from
its native router, equal the reference's exactly; and the port's native
sources are byte-identical copies of the reference's.
"""

import os

import numpy as np
import pytest

from linops_tpu.native import clos_route_native as ref_clos_route_native
from linops_tpu.sparse.routing import clos_route as ref_clos_route
from linops_tpu_torch import native
from linops_tpu_torch.sparse.routing import RADIX, clos_apply, clos_route, clos_stage_shapes
from torch_refnative import ensure_reference_native

# the reference's native libraries whole before its router is called
ensure_reference_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = [
    RADIX,                # single crossbar
    4 * RADIX,            # 3-stage, m = 4
    RADIX * RADIX,        # 3-stage, m = 128 (largest 3-stage)
    2 * RADIX * RADIX,    # 5-stage, B = 2
    8 * RADIX * RADIX,    # 5-stage, B = 8
]


@pytest.mark.parametrize("n", SIZES)
def test_clos_random_permutation(n):
    rng = np.random.default_rng(n)
    dest = rng.permutation(n)
    out = clos_apply(np.arange(n, dtype=np.float64), clos_route(dest))
    # the element that started at position i must land at dest[i]
    np.testing.assert_array_equal(out[dest], np.arange(n))


def test_clos_identity_and_reverse():
    n = 2 * RADIX * RADIX
    for dest in (np.arange(n), np.arange(n)[::-1].copy()):
        out = clos_apply(np.arange(n, dtype=np.float64), clos_route(dest))
        np.testing.assert_array_equal(out[dest], np.arange(n))


def test_clos_stage_count_and_shapes():
    assert clos_stage_shapes(64 * RADIX) == (64, 0)
    assert len(clos_route(np.random.default_rng(0).permutation(64 * RADIX))) == 3
    assert clos_stage_shapes(4 * RADIX * RADIX) == (4 * RADIX, 4)
    assert len(clos_route(np.random.default_rng(1).permutation(4 * RADIX * RADIX))) == 5


def test_clos_rejects_bad_sizes():
    with pytest.raises(ValueError):
        clos_stage_shapes(RADIX + 1)
    with pytest.raises(ValueError):
        clos_stage_shapes((RADIX + 1) * RADIX)
    with pytest.raises(ValueError):
        clos_stage_shapes(RADIX ** 3 + RADIX ** 2)
    with pytest.raises(ValueError):
        clos_route(np.zeros(RADIX, np.int64))  # not a permutation
    with pytest.raises(ValueError):
        native.clos_route_native(np.arange(RADIX + 1))


@pytest.mark.parametrize("n", SIZES + [3 * RADIX * RADIX])
def test_stage_arrays_equal_the_reference(n):
    dest = np.random.default_rng(n + 7).permutation(n)
    want = ref_clos_route(dest)
    for got in (clos_route(dest), native.clos_route_native(dest)):
        assert got is not None and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == np.asarray(w).shape
            np.testing.assert_array_equal(g, np.asarray(w))
    ref_native = ref_clos_route_native(dest)
    for g, w in zip(native.clos_route_native(dest), ref_native):
        np.testing.assert_array_equal(g, w)


def test_native_sources_are_copies_of_the_reference():
    for name in ("bsr_pack.cpp", "clos_route.cpp"):
        with open(os.path.join(ROOT, "linops_tpu_torch", "native_src", name), "rb") as f:
            ours = f.read()
        with open(os.path.join(ROOT, "linops_tpu", "native", name), "rb") as f:
            assert ours == f.read(), name


def test_native_libraries_build_from_the_port():
    assert native._SRC_DIR.endswith(os.path.join("linops_tpu_torch", "native_src"))
    assert native._BUILD.endswith(os.path.join("linops_tpu_torch", "_native_build"))
    assert native.clos_route_native(np.arange(RADIX)) is not None and native.available()
    assert {"closroute", "bsrpack"} <= set(native._libs)
    for lib in native._libs.values():
        assert os.path.dirname(lib._name) == native._BUILD


def test_rcm_permutation_matches_the_reference():
    import scipy.sparse as sps

    from linops_tpu.native import rcm_permutation as ref_rcm

    A = sps.random(500, 500, density=0.01, random_state=3, format="csr")
    pat = ((A != 0) + (A != 0).T).tocsr()
    got = native.rcm_permutation(pat.indices, pat.indptr, 500)
    want = ref_rcm(pat.indices.astype(np.int32), pat.indptr.astype(np.int32), 500)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(500))
