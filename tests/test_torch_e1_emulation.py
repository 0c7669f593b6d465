"""E1's blocked kernels (``linops_tpu_torch/kernels/csrc/small_eigh.cu``,
``blocked_eigh_kernel`` on one CTA and ``cluster_eigh_kernel`` on a
thread-block cluster) run on the CPU.

The kernel's source above its launch code is compiled with g++ behind a
shim of the CUDA constructs it uses: ``__global__``/``__device__`` empty,
``threadIdx``/``blockIdx`` thread-local, ``__syncthreads``, ``__syncwarp``
and a cluster's ``sync`` as barriers whose waiters sleep in a futex at once
(spinning waiters would take the cores that the threads still to arrive
need), ``__shfl_xor_sync`` through a shared array, each CTA's shared memory a buffer of its own that
``map_shared_rank`` maps between CTAs, the special-function intrinsics as
their exact host versions. One OS thread runs each CUDA thread of a cluster
(a lone CTA for the blocked kernel), so the kernel's own arithmetic,
schedule and synchronisation run here, with the card's rounding except for
those intrinsics. Its eigenpairs are held to the accuracy contract of the
card tests (|Δλ|, ‖AV − VΛ‖₂ ≤ 50·eps·‖A‖₂, max|VᴴV − I| ≤ 50·eps, eps of
the input's precision) against numpy's eigh in f64."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "linops_tpu_torch", "kernels", "csrc", "small_eigh.cu")
TOL = 50

SHIM = r"""
#include <atomic>
#include <cfloat>
#include <cmath>
#include <climits>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>
// arrive_and_wait as std::barrier's; a waiter sleeps in the kernel at once
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void arrive_and_wait() {
    const int gen = gen_.load(std::memory_order_acquire);
    if (count_.fetch_add(1, std::memory_order_acq_rel) + 1 == n_) {
      count_.store(0, std::memory_order_relaxed);
      gen_.fetch_add(1, std::memory_order_release);
      syscall(SYS_futex, &gen_, FUTEX_WAKE_PRIVATE, INT_MAX, nullptr, nullptr, 0);
      return;
    }
    while (gen_.load(std::memory_order_acquire) == gen)
      syscall(SYS_futex, &gen_, FUTEX_WAIT_PRIVATE, gen, nullptr, nullptr, 0);
  }

 private:
  const int n_;
  std::atomic<int> count_{0}, gen_{0};
};
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __align__(x) alignas(x)
struct Dim { unsigned x = 0; };
inline thread_local Dim threadIdx, blockIdx;
inline thread_local unsigned t_rank;  // the thread's CTA in its cluster
inline Dim blockDim;
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
constexpr int kEmuBlocks = 8, kEmuWarps = 16;
inline std::vector<std::unique_ptr<Barrier>> g_blocks, g_warps;
inline std::unique_ptr<Barrier> g_cluster;
inline unsigned g_cluster_size = 1;
inline double g_lanes[kEmuBlocks * kEmuWarps][32];
alignas(64) inline unsigned char g_dyn[kEmuBlocks][1 << 20];
inline unsigned warp_id() { return t_rank * kEmuWarps + (threadIdx.x >> 5); }
inline void __syncthreads() { g_blocks[t_rank]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warps[warp_id()]->arrive_and_wait(); }
// shuffles take two buffers in turns, so one barrier each will do: a lane
// writes a buffer again only past the next shuffle's barrier, which every lane
// reaches after its read of this one
inline double g_shfl[2][kEmuBlocks * kEmuWarps][32];
inline thread_local unsigned t_shfl;  // the buffer of this lane's next shuffle
inline double __shfl_xor_sync(unsigned, double v, int o) {
  const unsigned w = warp_id(), l = threadIdx.x & 31, b = t_shfl;
  t_shfl ^= 1u;
  g_shfl[b][w][l] = v;
  __syncwarp();
  return g_shfl[b][w][l ^ o];
}
template <typename T> T __ldcg(const T* p) { return *p; }
namespace cooperative_groups {
struct cluster_group {
  unsigned num_blocks() const { return g_cluster_size; }
  unsigned block_rank() const { return t_rank; }
  void sync() const { g_cluster->arrive_and_wait(); }
  template <typename P> P* map_shared_rank(P* p, unsigned r) const {
    const auto off = reinterpret_cast<unsigned char*>(p) - g_dyn[t_rank];
    return reinterpret_cast<P*>(g_dyn[r] + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
inline float __fdividef(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
using std::copysign;
using std::max;
using std::min;
"""

RUNNER = r"""
// kernel(t_rank) runs one CTA's thread; clusters of `ranks` CTAs of nt threads
// run one after another, their threads all at once
template <typename F> void run_blocks(int batch, int ranks, int nt, F kernel) {
  blockDim.x = nt;
  g_cluster_size = ranks;
  g_cluster = std::make_unique<Barrier>(ranks * nt);
  g_blocks.clear();
  g_warps.clear();
  for (int r = 0; r < ranks; ++r) g_blocks.push_back(std::make_unique<Barrier>(nt));
  for (int i = 0; i < ranks * kEmuWarps; ++i) g_warps.push_back(std::make_unique<Barrier>(32));
  for (int b = 0; b < batch; ++b) {
    std::vector<std::thread> threads;
    for (int r = 0; r < ranks; ++r)
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([=] {
          threadIdx.x = t;
          blockIdx.x = b * ranks + r;
          t_rank = r;
          kernel();
        });
    for (auto& th : threads) th.join();
  }
}

template <typename T>
int run(int kernel, const T* a, real_t<T>* w, T* v, int* sweeps, int m, int batch, int nt) {
  if (kernel == 1) {
    if (blayout<T>(m).total > sizeof(g_dyn[0]) || nt > 32 * kEmuWarps) return 1;
    run_blocks(batch, 1, nt, [=] { blocked_eigh_kernel<T, 512, true>(a, w, v, nullptr, sweeps, m); });
    return 0;
  }
  const CLayout L = clayout<T>(m);
  if (L.total > sizeof(g_dyn[0]) || nt != 64) return 1;
  run_blocks(batch, L.C, 64, [=] { cluster_eigh_kernel<T, 64>(a, w, v, sweeps, m); });
  return 0;
}
}  // namespace

// kernel: 1 the blocked kernel (one CTA of nt threads), 2 the cluster kernel
// (CTAs of 64 threads)
extern "C" int emulate(int kernel, int dtype, const void* a, void* w, void* v, int* sweeps, int m,
                       int batch, int nt) {
  switch (dtype) {
    case 0: return run(kernel, (const float*)a, (float*)w, (float*)v, sweeps, m, batch, nt);
    case 1: return run(kernel, (const double*)a, (double*)w, (double*)v, sweeps, m, batch, nt);
    case 2: return run(kernel, (const Cx<float>*)a, (float*)w, (Cx<float>*)v, sweeps, m, batch, nt);
    case 3: return run(kernel, (const Cx<double>*)a, (double*)w, (Cx<double>*)v, sweeps, m, batch, nt);
  }
  return 2;
}
"""

CODES = {np.float32: 0, np.float64: 1, np.complex64: 2, np.complex128: 3}
KERNELS = {"blocked": 1, "cluster": 2}


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    """The kernel built for the host: ``emulate(A, threads)`` -> (w, V, sweeps)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the host emulation")
    with open(SOURCE) as f:
        src = f.read()
    body = src[:src.index("// ---- launch ----")]
    for include in ("#include <cuda_runtime.h>", "#include <cooperative_groups.h>",
                    '#include "bsr_common.cuh"  // linops_cuda_error_string, set_dynamic_smem'):
        body = body.replace(include, "")
    body = body.replace("extern __shared__ __align__(16) unsigned char dyn[];",
                        "unsigned char* dyn = g_dyn[t_rank];")
    body = body.replace("__shared__ double red[32];", "static double red[32];")
    out = tmp_path_factory.mktemp("e1_emulation")
    cpp, lib = out / "e1.cpp", out / "libe1.so"
    cpp.write_text(SHIM + body + RUNNER)
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-o", str(lib), str(cpp),
                    "-lpthread"], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.emulate.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3

    def run(A, threads, kernel="blocked"):
        A = np.ascontiguousarray(A)
        batch, m, _ = A.shape
        real = np.float32 if A.dtype in (np.float32, np.complex64) else np.float64
        w, V = np.zeros((batch, m), real), np.zeros((batch, m, m), A.dtype)
        sweeps = np.zeros(batch, np.int32)
        rc = dll.emulate(KERNELS[kernel], CODES[A.dtype.type], A.ctypes.data, w.ctypes.data, V.ctypes.data,
                         sweeps.ctypes.data, m, batch, threads)
        assert rc == 0
        return w, V, sweeps

    return run


def errors(A, w, V):
    """(|Δλ| over eps·‖A‖₂, ‖AV − VΛ‖₂ over eps·‖A‖₂, max|VᴴV − I| over eps),
    A's lower triangle read, the worst over the batch."""
    wide = np.complex128 if np.iscomplexobj(A) else np.float64
    eps = np.finfo(w.dtype).eps
    L = np.tril(A.astype(wide))
    H = L + np.conj(np.swapaxes(np.tril(L, -1), -1, -2))
    diag = np.arange(A.shape[-1])
    H[:, diag, diag] = H[:, diag, diag].real  # the real diagonal, as eigh reads it
    ref = np.linalg.eigvalsh(H)
    norm = np.abs(ref).max(-1)
    Vw = V.astype(wide)
    dl = (np.abs(w - ref).max(-1) / norm).max() / eps
    res = max(np.linalg.norm(H[i] @ Vw[i] - Vw[i] * w[i], 2) / norm[i]
              for i in range(A.shape[0])) / eps
    orth = max(np.abs(Vw[i].conj().T @ Vw[i] - np.eye(A.shape[-1])).max()
               for i in range(A.shape[0])) / eps
    return dl, res, orth


def random_batch(rng, m, dtype, batch):
    A = rng.standard_normal((batch, m, m))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((batch, m, m))
    return A.astype(dtype)


@pytest.mark.parametrize("m, dtype, threads", [(25, np.float32, 64), (33, np.float32, 64),
                                               (40, np.complex64, 64), (48, np.float64, 64),
                                               (40, np.complex128, 64), (64, np.float32, 128)])
def test_blocked_kernel_meets_the_contract(rng, emulate, m, dtype, threads):
    """Random matrices (each padded to blocks of 8, the padding zero): the
    contract, ascending eigenvalues, fewer than 30 sweeps."""
    A = random_batch(rng, m, dtype, 2)
    w, V, sweeps = emulate(A, threads)
    dl, res, orth = errors(A, w, V)
    assert dl <= TOL and res <= TOL and orth <= TOL, (dl, res, orth)
    assert (np.diff(w, axis=1) >= 0).all() and sweeps.max() < 30


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_kernel_repeated_eigenvalues(rng, emulate, dtype):
    """Eigenvalues 1, 1, 2, 2, ...: negligible couplings are zeroed, not
    rotated, so the sweeps stay few (rotating noise between equal diagonal
    entries shrank the off-diagonal mass by 1/sqrt(2) a sweep)."""
    m = 32
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    A = ((Q * (np.arange(m) // 2 + 1.0)) @ Q.T)[None].astype(dtype)
    w, V, sweeps = emulate(A, 64)
    dl, res, orth = errors(A, w, V)
    assert dl <= TOL and res <= TOL and orth <= TOL, (dl, res, orth)
    assert sweeps.max() <= 15, sweeps


def test_blocked_kernel_special_inputs(rng, emulate):
    """A non-finite entry gives NaN out with no sweep; a diagonal matrix and
    zero take no sweep and come out exactly."""
    m = 40
    A = random_batch(rng, m, np.float32, 3)
    A[0, 30, 2] = np.inf
    A[1] = np.diag(rng.standard_normal(m)).astype(np.float32)
    A[2] = 0.0
    w, V, sweeps = emulate(A, 64)
    assert np.isnan(w[0]).all() and np.isnan(V[0]).all() and sweeps[0] == 0
    assert sweeps[1] == sweeps[2] == 0
    np.testing.assert_array_equal(w[1], np.sort(np.diag(A[1])))
    np.testing.assert_array_equal(w[2], 0.0)
    np.testing.assert_array_equal(V[2], np.eye(m))


@pytest.mark.parametrize("m, dtype", [(25, np.float32), (40, np.float32), (64, np.complex64),
                                      (48, np.float64), (40, np.complex128), (72, np.float64),
                                      (136, np.float32)])
def test_cluster_kernel_meets_the_contract(rng, emulate, m, dtype):
    """The cluster kernel on random matrices, a CTA per block pair up to 8
    pairs (m = 25: 2 CTAs; 72: 5) and two pairs a CTA above (136: 9 pairs
    on 5 CTAs, one slot empty): the contract, ascending eigenvalues, fewer
    than 30 sweeps, as many sweeps as the blocked kernel within one."""
    A = random_batch(rng, m, dtype, 2)
    w, V, sweeps = emulate(A, 64, "cluster")
    dl, res, orth = errors(A, w, V)
    assert dl <= TOL and res <= TOL and orth <= TOL, (dl, res, orth)
    assert (np.diff(w, axis=1) >= 0).all() and sweeps.max() < 30
    if m <= 64:
        assert np.abs(sweeps - emulate(A, 64)[2]).max() <= 1


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_cluster_kernel_repeated_eigenvalues(rng, emulate, dtype):
    """Eigenvalues 1, 1, 2, 2, ... on the cluster kernel: few sweeps, the
    contract."""
    m = 48
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    A = ((Q * (np.arange(m) // 2 + 1.0)) @ Q.T)[None].astype(dtype)
    w, V, sweeps = emulate(A, 64, "cluster")
    dl, res, orth = errors(A, w, V)
    assert dl <= TOL and res <= TOL and orth <= TOL, (dl, res, orth)
    assert sweeps.max() <= 15, sweeps


def test_cluster_kernel_special_inputs(rng, emulate):
    """The cluster kernel: a non-finite entry gives NaN out with no sweep on
    every CTA; a diagonal matrix and zero take no sweep and come out exactly;
    each matrix of a batch as alone."""
    m = 40
    A = random_batch(rng, m, np.float32, 4)
    A[0, 30, 2] = np.inf
    A[1] = np.diag(rng.standard_normal(m)).astype(np.float32)
    A[2] = 0.0
    w, V, sweeps = emulate(A, 64, "cluster")
    assert np.isnan(w[0]).all() and np.isnan(V[0]).all() and sweeps[0] == 0
    assert sweeps[1] == sweeps[2] == 0
    np.testing.assert_array_equal(w[1], np.sort(np.diag(A[1])))
    np.testing.assert_array_equal(w[2], 0.0)
    np.testing.assert_array_equal(V[2], np.eye(m))
    w3, V3, _ = emulate(A[3:], 64, "cluster")
    np.testing.assert_array_equal(w3[0], w[3])
    np.testing.assert_array_equal(V3[0], V[3])
