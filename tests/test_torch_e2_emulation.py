"""E2's kernel (``linops_tpu_torch/kernels/csrc/small_lstsq.cu``,
``small_lstsq_kernel``) run on the CPU.

The kernel's source above its launch code is compiled with g++ behind the
shim of ``tests/test_torch_e1_emulation.py`` (``__syncthreads`` and
``__syncwarp`` as its futex barriers, ``__shfl_xor_sync`` through a shared
array, ``threadIdx``/``blockIdx`` thread-local), one OS thread per CUDA
thread of a block, so the kernel's own arithmetic, schedule and
synchronisation run here. Its thread count is any multiple of 32 (groups of lanes take
the pairs in turns), so the emulation runs one to three warps (16 at
m = 120), both Jacobi forms (f32 and c64 input without V, f64 and c128
with it) and both memory variants (shared memory, and the global workspace
the wrapper allocates past 227 KB).

Its solutions are held against numpy's SVD-based ``lstsq`` in f64 at
``jnp.linalg.lstsq``'s cutoff: the residual ‖a y − b‖ within 50·eps·‖b‖ of
numpy's (eps of the input's precision), the singular values within
50·eps·σ_max, y within 50·eps·κ of numpy's; the trailing columns of a lucky
breakdown (exact zeros) give exact zeros in y, and the zero matrix y = 0."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
from test_torch_e1_emulation import SHIM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "linops_tpu_torch", "kernels", "csrc", "small_lstsq.cu")
TOL = 50

MATH = r"""
using std::fabs;
using std::fma;
using std::fmax;
using std::hypot;
using std::ilogb;
using std::isfinite;
using std::ldexp;
using std::sqrt;
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
inline bool __any_sync(unsigned, bool v) {
  const unsigned w = warp_id(), l = threadIdx.x & 31;
  g_lanes[w][l] = v;
  __syncwarp();
  bool any = false;
  for (int i = 0; i < 32; ++i) any = any || g_lanes[w][i] != 0.0;
  __syncwarp();
  return any;
}
"""

RUNNER = r"""
template <typename F> void run_blocks(int batch, int nt, F kernel) {
  blockDim.x = nt;
  g_cluster_size = 1;
  g_cluster = std::make_unique<Barrier>(nt);
  g_blocks.clear();
  g_warps.clear();
  g_blocks.push_back(std::make_unique<Barrier>(nt));
  for (int i = 0; i < kEmuWarps; ++i) g_warps.push_back(std::make_unique<Barrier>(32));
  for (int b = 0; b < batch; ++b) {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        t_rank = 0;
        kernel();
      });
    for (auto& th : threads) th.join();
  }
}

template <typename T>
int run(int smem, const T* a, const T* b, T* y, real_t<T>* s, int* sweeps, int r, int c,
        int batch, int nt) {
  const size_t bytes = layout<wide_t<T>>(r, c, keeps_v<T>()).total;
  if (nt > 32 * kEmuWarps || nt % 32) return 1;
  if (smem) {
    if (bytes > sizeof(g_dyn[0])) return 1;
    run_blocks(batch, nt, [=] { small_lstsq_kernel<T, true>(a, b, y, s, nullptr, sweeps, r, c); });
  } else {
    std::vector<unsigned char> work(bytes * batch);
    unsigned char* w = work.data();
    run_blocks(batch, nt, [=] { small_lstsq_kernel<T, false>(a, b, y, s, w, sweeps, r, c); });
  }
  return 0;
}
}  // namespace

extern "C" int emulate(int smem, int dtype, const void* a, const void* b, void* y, void* s,
                       int* sweeps, int r, int c, int batch, int nt) {
  switch (dtype) {
    case 0: return run(smem, (const float*)a, (const float*)b, (float*)y, (float*)s, sweeps, r, c, batch, nt);
    case 1: return run(smem, (const double*)a, (const double*)b, (double*)y, (double*)s, sweeps, r, c, batch, nt);
    case 2: return run(smem, (const Cx<float>*)a, (const Cx<float>*)b, (Cx<float>*)y, (float*)s, sweeps, r, c, batch, nt);
    case 3: return run(smem, (const Cx<double>*)a, (const Cx<double>*)b, (Cx<double>*)y, (double*)s, sweeps, r, c, batch, nt);
  }
  return 2;
}
"""

CODES = {np.float32: 0, np.float64: 1, np.complex64: 2, np.complex128: 3}
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    """The kernel built for the host: ``emulate(a, b, threads, smem)`` ->
    (y, s, sweeps)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the host emulation")
    with open(SOURCE) as f:
        src = f.read()
    body = src[:src.index("// ---- launch ----")]
    for include in ("#include <cuda_runtime.h>",
                    '#include "bsr_common.cuh"  // linops_cuda_error_string, set_dynamic_smem'):
        body = body.replace(include, "")
    body = body.replace("extern __shared__ __align__(16) unsigned char dyn[];",
                        "unsigned char* dyn = g_dyn[t_rank];")
    body = body.replace("__shared__ double red[32];", "static double red[32];")
    body = body.replace("__shared__ int rotated;", "static int rotated;")
    out = tmp_path_factory.mktemp("e2_emulation")
    cpp, lib = out / "e2.cpp", out / "libe2.so"
    cpp.write_text(SHIM + MATH + body + RUNNER)
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-o", str(lib), str(cpp),
                    "-lpthread"], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.emulate.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4

    def run(a, b, threads=64, smem=True):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b, dtype=a.dtype)
        batch, r, c = a.shape
        real = np.float32 if a.dtype in (np.float32, np.complex64) else np.float64
        y, s = np.zeros((batch, c), a.dtype), np.zeros((batch, c), real)
        sweeps = np.zeros(batch, np.int32)
        rc = dll.emulate(int(smem), CODES[a.dtype.type], a.ctypes.data, b.ctypes.data,
                         y.ctypes.data, s.ctypes.data, sweeps.ctypes.data, r, c, batch, threads)
        assert rc == 0
        return y, s, sweeps

    return run


def hessenberg(rng, m, dtype, batch=2):
    """(m + 1) x m upper Hessenberg matrices (GMRES's H) and β e₁."""
    H = np.triu(rng.standard_normal((batch, m + 1, m)), -1)
    if np.issubdtype(dtype, np.complexfloating):
        H = H + 1j * np.triu(rng.standard_normal((batch, m + 1, m)), -1)
    b = np.zeros((batch, m + 1))
    b[:, 0] = rng.random(batch) + 0.5
    return H.astype(dtype), b.astype(dtype)


def reference(a, b):
    """numpy's f64 solution at jnp.linalg.lstsq's cutoff for a's precision:
    (y, σ, residual norm) per matrix."""
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    eps = np.finfo(a.real.dtype).eps
    out = []
    for ai, bi in zip(a.astype(wide), b.astype(wide)):
        y, _, _, s = np.linalg.lstsq(ai, bi, rcond=eps * max(ai.shape))
        out.append((y, s, np.linalg.norm(ai @ y - bi)))
    return out


def check(a, b, y, s):
    """The contract against numpy, per matrix: the residual, σ, y."""
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    eps = np.finfo(a.real.dtype).eps
    for ai, bi, yi, si, (y_ref, s_ref, res_ref) in zip(a, b, y, s, reference(a, b)):
        scale = max(np.linalg.norm(bi), 1e-300)
        res = np.linalg.norm(ai.astype(wide) @ yi.astype(wide) - bi.astype(wide))
        assert res <= res_ref + TOL * eps * scale, (res, res_ref)
        smax = max(s_ref[0], 1e-300)
        assert np.abs(si[:len(s_ref)] - s_ref).max() <= TOL * eps * smax  # min(r, c) of them
        kappa = s_ref[0] / s_ref[s_ref >= eps * max(ai.shape) * s_ref[0]][-1]
        assert np.linalg.norm(yi - y_ref) <= TOL * eps * kappa * max(np.linalg.norm(y_ref), 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 8, 15, 30])
def test_random_hessenberg_meets_the_contract(rng, emulate, dtype, m):
    """GMRES's problem on random Hessenbergs: the contract against numpy's
    lstsq, fewer than 30 sweeps."""
    a, b = hessenberg(rng, m, dtype)
    y, s, sweeps = emulate(a, b, threads=64 if m > 2 else 32)
    check(a, b, y, s)
    assert sweeps.max() < 30


@pytest.mark.parametrize("dtype", DTYPES)
def test_lucky_breakdown_gives_exact_zeros(rng, emulate, dtype):
    """The columns of H past a lucky breakdown at step j are exactly zero:
    those entries of y are exactly 0 (as the SVD cutoff gives them), the rest
    meet the contract; the zero matrix gives y = 0 and σ = 0."""
    m, j = 12, 5
    a, b = hessenberg(rng, m, dtype, batch=3)
    a[:2, :, j:] = 0.0
    a[1, j + 1:, :] = 0.0
    a[2] = 0.0
    y, s, _ = emulate(a, b)
    assert not y[:2, j:].any()
    check(a[:2], b[:2], y[:2], s[:2])
    assert not y[2].any() and not s[2].any()


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_global_workspace_variant(rng, emulate, dtype):
    """The variant whose buffers live in the global workspace (the same
    code) gives the shared-memory variant's bits."""
    a, b = hessenberg(rng, 20, dtype)
    y, s, sw = emulate(a, b, threads=96, smem=True)
    y2, s2, sw2 = emulate(a, b, threads=96, smem=False)
    np.testing.assert_array_equal(y, y2)
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(sw, sw2)
    check(a, b, y, s)


def test_general_shapes_and_special_inputs(rng, emulate):
    """A tall and a wide matrix (not Hessenberg), a rank-deficient one, a
    general right-hand side and a huge scale meet the contract; a NaN entry
    gives NaN out with no sweep."""
    for r, c in ((9, 4), (4, 9)):
        a = rng.standard_normal((2, r, c))
        a[1, :, 1] = a[1, :, 0] * 2.0  # rank deficient: a repeated direction
        b = rng.standard_normal((2, r))
        y, s, _ = emulate(a, b)
        check(a, b, y, s)
    a, b = hessenberg(rng, 6, np.float64)
    y, s, _ = emulate(a * 1e200, b * 1e-150)
    check(a * 1e200, b * 1e-150, y, s)
    a[1, 3, 2] = np.nan
    y, s, sweeps = emulate(a, b)
    assert np.isnan(y[1]).all() and np.isnan(s[1]).all() and sweeps[1] == 0
    check(a[:1], b[:1], y[:1], s[:1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bits_do_not_depend_on_the_warps(rng, emulate, dtype):
    """A pair's sums and rotation do not depend on which warp takes it: one
    warp (steps separated by a warp barrier: at m = 8 the four pairs of a
    step share it), two and three warps give the same bits."""
    a, b = hessenberg(rng, 8, dtype)
    runs = [emulate(a, b, threads=t) for t in (32, 64, 96)]
    for y, s, sw in runs[1:]:
        np.testing.assert_array_equal(y, runs[0][0])
        np.testing.assert_array_equal(s, runs[0][1])
        np.testing.assert_array_equal(sw, runs[0][2])
    check(a, b, runs[0][0], runs[0][1])


def test_past_the_old_shared_memory_edge(rng, emulate):
    """m = 120 in f32, past the first design's 118-column edge (where its a
    and V left shared memory), on a Hessenberg whose diagonal dominates so
    that the sweeps are few, with two warps taking the 60 pairs of a step in
    turns, meets the contract."""
    a, b = hessenberg(rng, 120, np.float32, batch=1)
    a = (a * 0.01 + np.eye(121, 120) * np.arange(1, 121)).astype(np.float32)
    y, s, sweeps = emulate(a, b, threads=64)
    check(a, b, y, s)
    assert sweeps.max() < 30
