// E1: a batched small Hermitian eigensolver for Hopper (sm_90a).
//
// linops_small_eigh computes what torch.linalg.eigh computes for a batch of
// Hermitian m x m matrices (the lower triangle read, as eigh's default):
// eigenvalues in ascending order and orthonormal eigenvector columns, in f32,
// f64, c64 or c128. It is not the counterpart of a Pallas site: it replaces
// the jnp.linalg.eigh that XLA lowers inside the reference's LOBPCG loop
// (linops_tpu/utils/eig.py, _svqb_transform_g at m = k and the Rayleigh-Ritz
// step at m = 3k). torch.linalg.eigh on a CUDA tensor reads cuSOLVER's info
// back to the host, which a CUDA-graph capture refuses; this kernel never
// reads the host, allocates nothing and calls no library, so a LOBPCG
// iteration can be captured whole (utils/loop.py).
//
// Method: cyclic Jacobi in parallel (round-robin) order. A sweep is M - 1
// steps (M = m rounded up to even); step r pairs the indices by the circle
// method (r with M - 1, and (r + k) mod (M - 1) with (r - k) mod (M - 1) for
// k = 1 .. M/2 - 1), so the M/2 rotations of a step touch disjoint index
// pairs and are applied at once: first every rotation's parameters from the
// current matrix, then A <- A G and V <- V G (columns), then A <- G^H A
// (rows), then each pair's own 2 x 2 block set to its exact rotated values
// (a_pq = 0). A complex a_pq = |a_pq| e is first turned real by the phase e:
// G = diag(1, conj(e)) J with J the real Jacobi rotation of
// [[a_pp, |a_pq|], [|a_pq|, a_qq]] (Golub & Van Loan, sym.schur2). A sweep
// runs while the off-diagonal mass exceeds eps * ||A||_F (both squared, summed
// in f64 on the device), at most kMaxSweeps times: a matrix whose entries are
// not all finite gets NaN eigenvalues and vectors without a sweep. Then the
// columns of V are scaled to unit norm (the rotations' c^2 + s^2 = 1 + O(eps)
// drifts the norms by about m eps over a solve's sweeps; the scaling leaves
// the inner products of distinct columns at a few eps), and an in-kernel sort
// (each eigenvalue's rank by counting, NaN last, ties by index) writes w and
// the columns of V in ascending order.
//
// Layout: one thread block per matrix. The matrix, V, the step's rotations
// and the sort's arrays sit in dynamic shared memory when they fit (up to
// 227 KB: f32 to m = 168, c128 to m = 84), else in a global workspace the
// wrapper allocates (work, layout_bytes per matrix); the code is the same on
// both.
//
// What bounds it: at LOBPCG's sizes (m = 2 .. 3k) neither bytes nor
// operations: a sweep is 2 (m - 1) dependent barrier-separated passes of a
// few instructions per thread, so its time is that chain's latency. The
// operations an eigendecomposition needs, about 9 m^3 whatever the method
// (a sweep here does about 10 m^3), over the card's peak give a bound far
// below it (chip_smoke.py phase 15a reports both).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "bsr_common.cuh"  // linops_cuda_error_string, set_dynamic_smem

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSweeps = 30;
constexpr int kMaxThreads = 512;
// dynamic shared memory a Hopper thread block can take, less this kernel's
// static shared memory
constexpr size_t kSmemLimit = 232448 - 1024;

template <typename R> struct alignas(2 * sizeof(R)) Cx { R re, im; };

template <typename T> struct RealOf { using type = T; };
template <typename R> struct RealOf<Cx<R>> { using type = R; };
template <typename T> using real_t = typename RealOf<T>::type;

template <typename R> struct Eps;
template <> struct Eps<float> { static constexpr double value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };

__device__ __forceinline__ float real_part(float x) { return x; }
__device__ __forceinline__ double real_part(double x) { return x; }
template <typename R> __device__ __forceinline__ R real_part(Cx<R> x) { return x.re; }

__device__ __forceinline__ double sq(float x) { return (double)x * x; }
__device__ __forceinline__ double sq(double x) { return x * x; }
template <typename R> __device__ __forceinline__ double sq(Cx<R> x) {
  return (double)x.re * x.re + (double)x.im * x.im;
}

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
template <typename R> __device__ __forceinline__ R absval(Cx<R> x) { return hypot(x.re, x.im); }

__device__ __forceinline__ float cj(float x) { return x; }
__device__ __forceinline__ double cj(double x) { return x; }
template <typename R> __device__ __forceinline__ Cx<R> cj(Cx<R> x) { return {x.re, -x.im}; }

template <typename T> __device__ __forceinline__ T from_real(real_t<T> x) { return x; }
template <> __device__ __forceinline__ Cx<float> from_real<Cx<float>>(float x) { return {x, 0.f}; }
template <> __device__ __forceinline__ Cx<double> from_real<Cx<double>>(double x) {
  return {x, 0.0};
}

// the unit phase e of a_pq (a_pq = |a_pq| e), |a_pq| > 0
__device__ __forceinline__ float phase(float x, float) { return x >= 0.f ? 1.f : -1.f; }
__device__ __forceinline__ double phase(double x, double) { return x >= 0.0 ? 1.0 : -1.0; }
template <typename R> __device__ __forceinline__ Cx<R> phase(Cx<R> x, R ab) {
  return {x.re / ab, x.im / ab};
}

// the unit phase of x given 1/|x|
__device__ __forceinline__ double phase_by(double x, double) { return x >= 0.0 ? 1.0 : -1.0; }
__device__ __forceinline__ Cx<double> phase_by(Cx<double> x, double inv) {
  return {x.re * inv, x.im * inv};
}

__device__ __forceinline__ float scale(float s, float x) { return s * x; }
__device__ __forceinline__ double scale(double s, double x) { return s * x; }
template <typename R> __device__ __forceinline__ Cx<R> scale(R s, Cx<R> x) {
  return {s * x.re, s * x.im};
}

// (x, y) <- (c x - s f y, s x + c f y)
__device__ __forceinline__ void rotate(float& x, float& y, float c, float s, float f) {
  const float fy = f * y, x0 = x;
  x = c * x0 - s * fy;
  y = s * x0 + c * fy;
}
__device__ __forceinline__ void rotate(double& x, double& y, double c, double s, double f) {
  const double fy = f * y, x0 = x;
  x = c * x0 - s * fy;
  y = s * x0 + c * fy;
}
template <typename R>
__device__ __forceinline__ void rotate(Cx<R>& x, Cx<R>& y, R c, R s, Cx<R> f) {
  const Cx<R> fy = {f.re * y.re - f.im * y.im, f.re * y.im + f.im * y.re};
  const Cx<R> x0 = x;
  x = {c * x0.re - s * fy.re, c * x0.im - s * fy.im};
  y = {s * x0.re + c * fy.re, s * x0.im + c * fy.im};
}

// one rotation of a step: G = diag(1, conj(e)) [[c, s], [-s, c]] on (p, q);
// q < 0 marks a step slot with nothing to rotate
template <typename T> struct Rot {
  T e;
  real_t<T> c, s, app, aqq, tab;  // tab = t |a_pq|: a_pp -= tab, a_qq += tab
  int p, q;
};

struct Layout {
  size_t a, v, rot, d, nrm, rank, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

// the per-matrix buffer: A and V (m x m each, row-major), the step's
// rotations, then the eigenvalues, column scales and ranks of the sort
template <typename T> __host__ __device__ inline Layout layout(int m) {
  const size_t mm = (size_t)m * m;
  const size_t np = (size_t)(m + 1) / 2;
  Layout L;
  size_t off = 0;
  L.a = take(off, sizeof(T) * mm);
  L.v = take(off, sizeof(T) * mm);
  L.rot = take(off, sizeof(Rot<T>) * np);
  L.d = take(off, sizeof(real_t<T>) * m);
  L.nrm = take(off, sizeof(real_t<T>) * m);
  L.rank = take(off, sizeof(int) * m);
  L.total = off;
  return L;
}

// the block-wide sum of every thread's v, the same value (and bits) in every
// thread; blockDim.x is a multiple of 32
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int nw = (int)((blockDim.x + 31) >> 5);
  __syncthreads();  // red is free: every thread read its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

template <typename R> __device__ __forceinline__ R sort_key(R x) {
  return x != x ? (R)INFINITY : x;  // NaN last
}

template <typename T>
__global__ void small_eigh_kernel(const T* __restrict__ a, real_t<T>* __restrict__ w,
                                  T* __restrict__ v, unsigned char* __restrict__ work,
                                  int* __restrict__ sweeps_out, int m, int in_smem) {
  using R = real_t<T>;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double red[32];
  const Layout L = layout<T>(m);
  unsigned char* base = in_smem ? dyn : work + (size_t)blockIdx.x * L.total;
  T* A = reinterpret_cast<T*>(base + L.a);
  T* V = reinterpret_cast<T*>(base + L.v);
  Rot<T>* rot = reinterpret_cast<Rot<T>*>(base + L.rot);
  R* d = reinterpret_cast<R*>(base + L.d);
  R* nrm = reinterpret_cast<R*>(base + L.nrm);
  int* rank = reinterpret_cast<int*>(base + L.rank);
  // 32-bit index arithmetic (m <= 46340, so m * m fits): a 64-bit division
  // per item costs more than the item's rotation
  const unsigned tid = threadIdx.x, nt = blockDim.x, um = (unsigned)m;
  const unsigned mm = um * um;
  const T* src = a + (size_t)blockIdx.x * mm;
  R* w_out = w + (size_t)blockIdx.x * m;
  T* v_out = v + (size_t)blockIdx.x * mm;

  // the Hermitian matrix of the lower triangle (real diagonal), and V = I
  double local = 0.0;
  for (unsigned it = tid; it < mm; it += nt) {
    const unsigned i = it / um, j = it - i * um;
    const T x = i > j ? src[it] : i == j ? from_real<T>(real_part(src[it])) : cj(src[j * um + i]);
    A[it] = x;
    V[it] = from_real<T>(i == j ? (R)1 : (R)0);
    local += sq(x);
  }
  const double fro2 = block_sum(local, red);
  if (!(fro2 <= DBL_MAX)) {  // an entry that is NaN or infinite: NaN out, no sweep
    for (unsigned it = tid; it < mm; it += nt) v_out[it] = from_real<T>((R)NAN);
    for (unsigned j = tid; j < um; j += nt) w_out[j] = (R)NAN;
    if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = 0;
    return;
  }
  const double tol2 = Eps<R>::value * Eps<R>::value * fro2;
  const unsigned M = um + (um & 1u), np = M / 2;
  const unsigned items = um * np;
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (unsigned it = tid; it < mm; it += nt)
      if (it % (um + 1) != 0) off += sq(A[it]);  // the diagonal is every (m + 1)-th entry
    if (!(block_sum(off, red) > tol2)) break;
    for (unsigned r = 0; r < M - 1; ++r) {
      for (unsigned k = tid; k < np; k += nt) {
        unsigned p = k == 0 ? r : (r + k) % (M - 1);
        unsigned q = k == 0 ? M - 1 : (r + (M - 1) - k) % (M - 1);
        if (p > q) { const unsigned t = p; p = q; q = t; }
        Rot<T> z;
        z.p = (int)p;
        z.q = -1;
        if (q < um) {
          const T apq = A[p * um + q];
          const R ab = absval(apq);
          if (ab > (R)0) {
            const R app = real_part(A[p * um + p]), aqq = real_part(A[q * um + q]);
            const R tau = (aqq - app) / ((R)2 * ab);
            const R t = (tau >= (R)0 ? (R)1 : (R)-1) / (fabs(tau) + sqrt((R)1 + tau * tau));
            const R c = (R)1 / sqrt((R)1 + t * t);
            z.e = phase(apq, ab);
            z.c = c;
            z.s = t * c;
            z.app = app;
            z.aqq = aqq;
            z.tab = t * ab;
            z.q = (int)q;
          }
        }
        rot[k] = z;
      }
      __syncthreads();
      for (unsigned it = tid; it < items; it += nt) {  // A <- A G, V <- V G
        const unsigned i = it / np;
        const Rot<T>& z = rot[it - i * np];
        if (z.q < 0) continue;
        const T f = cj(z.e);
        const unsigned row = i * um;
        rotate(A[row + z.p], A[row + z.q], z.c, z.s, f);
        rotate(V[row + z.p], V[row + z.q], z.c, z.s, f);
      }
      __syncthreads();
      for (unsigned it = tid; it < items; it += nt) {  // A <- G^H A
        const unsigned k = it / um, j = it - k * um;
        const Rot<T>& z = rot[k];
        if (z.q < 0) continue;
        rotate(A[(unsigned)z.p * um + j], A[(unsigned)z.q * um + j], z.c, z.s, z.e);
      }
      __syncthreads();
      for (unsigned k = tid; k < np; k += nt) {  // each pair's block, exactly
        const Rot<T>& z = rot[k];
        if (z.q < 0) continue;
        const unsigned p = (unsigned)z.p, q = (unsigned)z.q;
        A[p * um + p] = from_real<T>(z.app - z.tab);
        A[q * um + q] = from_real<T>(z.aqq + z.tab);
        A[p * um + q] = from_real<T>((R)0);
        A[q * um + p] = from_real<T>((R)0);
      }
      __syncthreads();
    }
  }

  // unit columns, then the ascending order
  for (unsigned j = tid; j < um; j += nt) {
    double s2 = 0.0;
    for (unsigned i = 0; i < um; ++i) s2 += sq(V[i * um + j]);
    nrm[j] = (R)(1.0 / sqrt(s2));
    d[j] = real_part(A[j * um + j]);
  }
  __syncthreads();
  for (unsigned j = tid; j < um; j += nt) {
    const R kj = sort_key(d[j]);
    int rk = 0;
    for (unsigned i = 0; i < um; ++i) {
      const R ki = sort_key(d[i]);
      rk += ki < kj || (ki == kj && i < j);
    }
    rank[j] = rk;
    w_out[rk] = d[j];
  }
  __syncthreads();
  for (unsigned it = tid; it < mm; it += nt) {
    const unsigned i = it / um, j = it - i * um;
    v_out[i * um + rank[j]] = scale(nrm[j], V[it]);
  }
  if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = sweep;
}

// ---------------------------------------------------------------------------
// The blocked kernel (m > m0 where the cluster kernel's buffers do not fit
// in shared memory: c128 above m = 128): block Jacobi, a warp per block pair.
//
// The Jacobi kernel above takes 2 (M - 1) barrier-separated passes a sweep,
// each a few instructions per thread on shared memory: at m = 96 a step is
// latency, not work (PERF.md section 6). Here the matrix is cut into nb block
// columns of kB = 8 (nb rounded up to even; the padding is zero, so a pad
// index never rotates with a real one: its a_pq is exactly 0, and the pads
// stay out of every product below). An outer step pairs the blocks by the
// circle method, the ordering the Jacobi kernel uses for indices, and takes
// three block-wide barriers:
//   1. each pair's 2kB x 2kB diagonal block S goes to a warp, which rotates
//      it (pair_solve: 8 steps of 8 rotations on the pairs across the two
//      blocks, 15 steps at a sweep's first outer step, two __syncwarp a
//      step) and writes the rotated S and their product Q;
//   2. A <- A Q and V <- V Q: each block-column pair times its Q, a half-warp
//      per row with Q's column in registers and the row's two 8-entry
//      segments in 16-byte loads;
//   3. A <- Q^H A: each block-row pair times Q^H, a lane per column, and the
//      pair's own diagonal block set to the rotated S of step 1 (the exact
//      zeros of its last rotations).
// A and V stay in the input's precision and steps 2-3 are plain
// multiply-adds in it (f32: FFMA, no TF32); step 1 works in f64 (c128) for
// f32 (c64) input and rounds Q and S once. Q and S come from the same
// rotations, so the two descriptions of a step agree to that rounding: in
// f32 throughout they drift apart by a few eps a step, and at m = 150 that
// drift broke the contract's 50 eps (a host emulation of this kernel,
// tests/test_torch_e1_emulation.py's harness), against a few eps this way. The rest is the Jacobi kernel's: the stopping test at each
// sweep's start (off-diagonal mass <= eps ||A||_F, both squared and summed in
// f64, at most kMaxSweeps sweeps), NaN out for a non-finite input, unit
// columns, the in-kernel ascending sort, one thread block per matrix, no
// host read, no allocation (a global workspace from the wrapper when the
// buffer passes the shared-memory limit); f64 and c128 add one
// Newton-Schulz step on V. A step's arithmetic is 3 m_p^2 2kB multiply-adds
// (m_p the padded size) in steps 2-3, many per barrier, and step 1's chain of
// 15 dependent rotations per warp; at m = 96 the two take about equal time,
// and step 1's chain bounds it: each step waits on its rotation's
// special-function estimates, two exchanges through shared memory and the
// warp's f64 multiply-adds (PERF.md section 6 has the measured split).
// ---------------------------------------------------------------------------

constexpr int kB = 8;             // block width; a pair's block is 2kB = 16 wide
constexpr int kB2 = 2 * kB;
constexpr unsigned kFull = 0xffffffffu;

// step 1 works in f64 (c128) for f32 (c64) input
template <typename T> struct WideOf { using type = T; };
template <> struct WideOf<float> { using type = double; };
template <> struct WideOf<Cx<float>> { using type = Cx<double>; };
template <typename T> using wide_t = typename WideOf<T>::type;

// (bsr_common.cuh's widen/narrow are its bf16 helpers)
__device__ __forceinline__ double to_wide(float x) { return x; }
__device__ __forceinline__ double to_wide(double x) { return x; }
template <typename R> __device__ __forceinline__ Cx<double> to_wide(Cx<R> x) {
  return {(double)x.re, (double)x.im};
}
template <typename T> __device__ __forceinline__ T from_wide(double x) { return (T)x; }
template <typename T> __device__ __forceinline__ T from_wide(Cx<double> x) {
  return {(real_t<T>)x.re, (real_t<T>)x.im};
}

struct BLayout {
  size_t a, v, sq, rot, d, nrm, rank, total;
  unsigned mp, np;  // padded size (a multiple of 2kB), block pairs
};

// the rotation of a pair, as step 1 shares it between lanes: c, s and the
// phase e of G = diag(1, conj(e)) [[c, s], [-s, c]], and tab = t |a_pq|
// (a_pp -= tab, a_qq += tab)
template <typename W> struct Rot2 {
  real_t<W> c, s, tab;
  W e;
};

// per matrix: A and V (m_p x m_p, in the input's type), each pair's S and Q
// side by side (16 x 16 each, the input's type; while the pair is solved the
// same bytes hold its 16 x 16 S in the working type), each pair's 8
// rotations, then the sort's arrays
template <typename T> __host__ __device__ inline BLayout blayout(int m) {
  using W = wide_t<T>;
  BLayout L;
  const unsigned nb = ((unsigned)m + kB - 1) / kB;
  L.np = (nb + 1) / 2;
  L.mp = 2 * L.np * kB;
  const size_t mm = (size_t)L.mp * L.mp, tile = (size_t)L.np * kB2 * kB2;
  size_t off = 0;
  L.a = take(off, sizeof(T) * mm);
  L.v = take(off, sizeof(T) * mm);
  static_assert(2 * sizeof(T) >= sizeof(W), "a pair's S and Q hold its S in the working type");
  L.sq = take(off, sizeof(T) * 2 * tile);
  L.rot = take(off, sizeof(Rot2<W>) * L.np * kB);
  L.d = take(off, sizeof(real_t<T>) * m);
  L.nrm = take(off, sizeof(real_t<T>) * m);
  L.rank = take(off, sizeof(int) * m);
  L.total = off;
  return L;
}

// x * y and a x + b y
__device__ __forceinline__ double mul(double x, double y) { return x * y; }
__device__ __forceinline__ Cx<double> mul(Cx<double> x, Cx<double> y) {
  return {x.re * y.re - x.im * y.im, x.re * y.im + x.im * y.re};
}
__device__ __forceinline__ double axpby(double a, double x, double b, double y) {
  return fma(a, x, b * y);
}
__device__ __forceinline__ Cx<double> axpby(Cx<double> a, Cx<double> x, Cx<double> b,
                                            Cx<double> y) {
  const Cx<double> u = mul(a, x), w = mul(b, y);
  return {u.re + w.re, u.im + w.im};
}

// 8 consecutive entries (16-byte aligned) in 16-byte loads
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const double* p, double* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 a = reinterpret_cast<const double2*>(p)[i];
    x[2 * i] = a.x;
    x[2 * i + 1] = a.y;
  }
}
__device__ __forceinline__ void load8(const Cx<float>* p, Cx<float>* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    x[2 * i] = {a.x, a.y};
    x[2 * i + 1] = {a.z, a.w};
  }
}
__device__ __forceinline__ void load8(const Cx<double>* p, Cx<double>* x) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const double2 a = reinterpret_cast<const double2*>(p)[i];
    x[i] = {a.x, a.y};
  }
}

// acc += x * y
__device__ __forceinline__ void mac(float& acc, float x, float y) { acc = fmaf(x, y, acc); }
__device__ __forceinline__ void mac(double& acc, double x, double y) { acc = fma(x, y, acc); }
template <typename R> __device__ __forceinline__ void mac(Cx<R>& acc, Cx<R> x, Cx<R> y) {
  acc.re = fma(x.re, y.re, acc.re);
  acc.re = fma(-x.im, y.im, acc.re);
  acc.im = fma(x.re, y.im, acc.im);
  acc.im = fma(x.im, y.re, acc.im);
}

// 1.5 v - 0.5 acc, the Newton-Schulz step's entry
__device__ __forceinline__ double ns_step(double v, double acc) { return fma(1.5, v, -0.5 * acc); }
__device__ __forceinline__ Cx<double> ns_step(Cx<double> v, Cx<double> acc) {
  return {fma(1.5, v.re, -0.5 * acc.re), fma(1.5, v.im, -0.5 * acc.im)};
}

// global index of a pair's local index l (0 .. 2kB - 1): block P's, then block Q's
__device__ __forceinline__ unsigned pair_index(unsigned l, unsigned P, unsigned Qb) {
  return l < kB ? P * kB + l : Qb * kB + (l - kB);
}

// the blocks of pair k at outer step r among nb blocks (the circle method)
__device__ __forceinline__ void block_pair(unsigned r, unsigned k, unsigned nb, unsigned& P,
                                           unsigned& Qb) {
  P = k == 0 ? r : (r + k) % (nb - 1);
  Qb = k == 0 ? nb - 1 : (r + (nb - 1) - k) % (nb - 1);
}

// the rotation of (p, q) that zeroes a_pq = o, with a_pp = app, a_qq = aqq:
// the Jacobi kernel's t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau =
// (a_qq - a_pp) / (2 |a_pq|), and c = 1 / sqrt(1 + t^2), to the working
// precision without a double division or square root in the step's chain:
// each from its f32 estimate on the special-function unit and two Newton
// steps in the working type (t as the small root of t^2 + 2 tau t - 1; a
// huge tau, or a |a_pq| outside f32's range, takes the divisions), or, with
// kNewtonT = 0 (f32 and c64 input, whose results are rounded to f32), t in
// f32 and c from one Newton step. a_pq = 0
// gives the identity. An a_pq below eps sqrt(|a_pp a_qq|) (eps of the working
// type) gives the identity too, and the caller sets it to 0, as Jacobi's
// relative-accuracy test allows: rotating two equal diagonal entries by the
// angle such noise gives (up to 45 degrees) moves the mass of their
// couplings to a third index back and forth every sweep, and the sweeps then
// shrink it by 1/sqrt(2) each (a matrix with repeated eigenvalues took 30
// sweeps on the card).
template <int kNewtonT, typename W>
__device__ __forceinline__ Rot2<W> make_rot2(W o, real_t<W> app, real_t<W> aqq) {
  using R = real_t<W>;
  Rot2<W> z;
  z.c = (R)1;
  z.s = (R)0;
  z.tab = (R)0;
  z.e = from_real<W>((R)1);
  if constexpr (kNewtonT == 0) {
    // f32 and c64 input: the angle in f32; c orthonormal in f64 by one Newton
    // step, the phase unit in f64 by two
    const R n2 = sq(o);  // |a_pq|^2
    if (!(n2 > (R)0) || n2 <= (R)(Eps<R>::value * Eps<R>::value) * fabs(app * aqq)) return z;
    R ab;
    float tau;
    if constexpr (sizeof(W) == sizeof(R)) {
      ab = fabs(o);
      z.e = phase_by(o, (R)1);
      tau = __fdividef(0.5f * (float)(aqq - app), (float)ab);
    } else {
      R inv = (R)rsqrtf((float)n2);
      inv = inv * fma((R)-0.5 * n2, inv * inv, (R)1.5);
      inv = inv * fma((R)-0.5 * n2, inv * inv, (R)1.5);
      ab = n2 * inv;
      z.e = phase_by(o, inv);
      tau = 0.5f * (float)(aqq - app) * (float)inv;
    }
    const float tf = __fdividef(copysignf(1.f, tau), fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f)));
    const R t = (R)tf, u = fma(t, t, (R)1);
    R c = (R)rsqrtf(fmaf(tf, tf, 1.f));
    c = c * fma((R)-0.5 * u, c * c, (R)1.5);
    z.c = c;
    z.s = t * c;
    z.tab = t * ab;
    return z;
  }
  const R ab = absval(o);
  if (!(ab > (R)0) || ab * ab <= (R)(Eps<R>::value * Eps<R>::value) * fabs(app * aqq)) return z;
  R inv;  // 1 / |a_pq|
  if (ab > (R)1e-30 && ab < (R)1e30) {
    inv = (R)__fdividef(1.f, (float)ab);
    inv = inv * fma(-ab, inv, (R)2);
    inv = inv * fma(-ab, inv, (R)2);
  } else {
    inv = (R)1 / ab;
  }
  z.e = phase_by(o, inv);
  const R tau = (R)0.5 * (aqq - app) * inv;
  R t;
  if (fabs(tau) < (R)1e15) {
    const float tf = (float)tau;
    t = (R)__fdividef(copysignf(1.f, tf), fabsf(tf) + sqrtf(fmaf(tf, tf, 1.f)));
#pragma unroll
    for (int i = 0; i < kNewtonT; ++i)
      t -= fma(t, t + (R)2 * tau, (R)-1) * (R)__fdividef(0.5f, (float)(t + tau));
  } else {
    t = (R)0.5 / tau;
  }
  const R u = fma(t, t, (R)1);
  R c = (R)rsqrtf((float)u);
  c = c * fma((R)-0.5 * u, c * c, (R)1.5);
  c = c * fma((R)-0.5 * u, c * c, (R)1.5);
  z.c = c;
  z.s = t * c;
  z.tab = t * ab;
  return z;
}

// the slot of entry (i, c) in row i of a pair's working S: a column of
// 8-byte entries spread over the banks two by two, of 16-byte ones one by one
template <typename W> __device__ __forceinline__ unsigned swz(unsigned i, unsigned c) {
  return (c + (sizeof(W) == 8 ? 2 * i : i)) & (kB2 - 1);
}

// The inner schedule of a pair's 2kB indices: 8 rotations a step on
// disjoint index pairs. A within step u (0 .. 6) pairs each half's 8 indices
// by the circle method (slots 0-3 block P's, 4-7 block Qb's); a cross step s
// (0 .. 7) pairs index i of block P with index kB + (i + s) mod kB of block
// Qb (slot i). 7 within steps and 8 cross steps rotate all 120 pairs once.
enum { kWithin = 0, kCross = 1 };

// the index that `row` meets at step t
__device__ __forceinline__ unsigned partner(int kind, int t, unsigned row) {
  if (kind == kCross) return row < kB ? kB + ((row + t) & (kB - 1)) : (row + kB - t) & (kB - 1);
  const unsigned h = row & kB, l = row & (kB - 1);
  return h | (l == kB - 1 ? (unsigned)t : l == (unsigned)t ? kB - 1 : (2 * t + (kB - 1) - l) % (kB - 1));
}

// the slot of the pair p < q at step t
__device__ __forceinline__ unsigned slot_of(int kind, int t, unsigned p, unsigned q) {
  if (kind == kCross) return p;
  const unsigned pl = p & (kB - 1), ql = q & (kB - 1);
  const unsigned kp = ql == kB - 1 ? 0u : (pl + (kB - 1) - t) % (kB - 1);
  return (p & kB ? kB / 2 : 0) + (kp < kB / 2 ? kp : (kB - 1) - kp);
}

// the pair a < b of slot k at step t
__device__ __forceinline__ void slot_pair(int kind, int t, int k, int& a, int& b) {
  if (kind == kCross) {
    a = k;
    b = kB + ((k + t) & (kB - 1));
    return;
  }
  const int h = k >= kB / 2 ? kB : 0, kk = k & (kB / 2 - 1);
  const int x = kk == 0 ? t : (t + kk) % (kB - 1), y = kk == 0 ? kB - 1 : (t + (kB - 1) - kk) % (kB - 1);
  a = h + (x < y ? x : y);
  b = h + (x < y ? y : x);
}

// one step of pair_solve (see there)
template <int kNewtonT, typename W>
__device__ __forceinline__ void pair_step(int kind, int t, W* xbuf, W* own_row, W (&v)[kB2],
                                          Rot2<W>* rot, unsigned row, bool is_s) {
  using R = real_t<W>;
  const unsigned j = partner(kind, t, row);
  const unsigned p = min(row, j), q = max(row, j);
  R own = (R)0;
  if (is_s) {
    const R app = real_part(xbuf[p * kB2 + swz<W>(p, p)]);
    const R aqq = real_part(xbuf[q * kB2 + swz<W>(q, q)]);
    const Rot2<W> z = make_rot2<kNewtonT>(xbuf[p * kB2 + swz<W>(p, q)], app, aqq);
    if (row == p) rot[slot_of(kind, t, p, q)] = z;
    own = row == p ? app - z.tab : aqq + z.tab;
    // S <- G^H S on rows p and q: v = alpha (own row) + beta (partner's row)
    const W alpha = row == p ? from_real<W>(z.c) : mul(from_real<W>(z.c), z.e);
    const W beta = row == p ? mul(from_real<W>(-z.s), z.e) : from_real<W>(z.s);
    const W* other = xbuf + j * kB2;
#pragma unroll
    for (int c = 0; c < kB2; ++c)
      v[c] = axpby(alpha, own_row[swz<W>(row, c)], beta, other[swz<W>(j, c)]);
  }
  __syncwarp();  // rot[] complete; every lane done reading the old S
#pragma unroll
  for (int k = 0; k < kB; ++k) {  // S <- S G, Q <- Q G
    int a, b;
    slot_pair(kind, t, k, a, b);
    const Rot2<W> zk = rot[k];
    rotate(v[a], v[b], zk.c, zk.s, cj(zk.e));
  }
  if (is_s) {  // the new row, with the pair's 2 x 2 block set exactly
#pragma unroll
    for (int c = 0; c < kB2; ++c) own_row[swz<W>(row, c)] = v[c];
    own_row[swz<W>(row, row)] = from_real<W>(own);
    own_row[swz<W>(row, j)] = from_real<W>((R)0);
  }
  __syncwarp();
}

// step 1 for one pair, by one warp: lane i < 16 handles row i of the pair's
// 2kB x 2kB diagonal block S (widened), kept in xbuf; lane 16 + i holds row
// i of the rotation Q (from I) in registers. At each step (pair_step) every
// index i meets its partner j: lanes p = min(i, j) and q = max(i, j) read
// the pair's 2 x 2 block and compute the same rotation (lane p also puts it
// in rot[k] for the others), rotate their two rows of the old S (S <- G^H S),
// then every lane rotates its row's column pairs (S <- S G, Q <- Q G), and
// the pair's 2 x 2 block is set exactly (a_pq = 0). Two __syncwarp a step,
// no shuffle. With `within` (the first outer step of a sweep, where every
// block is in a pair) the 7 within steps run before the 8 cross steps, so a
// sweep rotates every pair of indices once or more; the other outer steps
// take the cross steps alone: the couplings inside a block wait for the
// next sweep's first step, as in a scalar cyclic sweep, which rotates each
// pair once (every step rotating the 56 pairs inside the two blocks as
// well took 15 steps a pair solve, not 8). f32 (c64) input takes t to f32
// accuracy (its special-function estimate, no Newton step on it) and rounds
// the result to f32 anyway; f64 (c128) input takes two Newton steps. Writes
// S and Q, rounded to the storage type, over sq (row-major 16 x 16 each). A
// holds the pair's rows with stride ld (global row indices), block P's 8
// columns at c0 and block Qb's at c1.
template <typename T>
__device__ __forceinline__ void pair_solve(const T* A, unsigned ld, unsigned c0, unsigned c1,
                                           unsigned P, unsigned Qb, bool within, T* sq,
                                           Rot2<wide_t<T>>* rot, unsigned lane) {
  using W = wide_t<T>;
  using R = real_t<W>;
  constexpr int kNewtonT = sizeof(real_t<T>) == 8 ? 2 : 0;
  const unsigned row = lane & (kB2 - 1);
  const bool is_s = lane < (unsigned)kB2;
  // S in the working type, over the pair's S and Q; entry (i, c) at row i,
  // slot swz(i, c), so the 16 lanes that read one column of their own rows
  // hit 16 different banks (rows of 16 entries would put a column in one)
  W* xbuf = reinterpret_cast<W*>(sq);
  W v[kB2];  // lane < 16: a row of S for the step; lane >= 16: its row of Q
  W* own_row = xbuf + row * kB2;
  if (is_s) {
    T t[kB2];
    const T* src = A + (size_t)pair_index(row, P, Qb) * ld;
    load8(src + c0, t);
    load8(src + c1, t + kB);
#pragma unroll
    for (int c = 0; c < kB2; ++c) own_row[swz<W>(row, c)] = to_wide(t[c]);
  } else {
#pragma unroll
    for (int c = 0; c < kB2; ++c) v[c] = from_real<W>(c == (int)row ? (R)1 : (R)0);
  }
  __syncwarp();
  if (within) {
#pragma unroll
    for (int u = 0; u < kB - 1; ++u)
      pair_step<kNewtonT>(kWithin, u, xbuf, own_row, v, rot, row, is_s);
  }
#pragma unroll
  for (int s = 0; s < kB; ++s) pair_step<kNewtonT>(kCross, s, xbuf, own_row, v, rot, row, is_s);
  if (is_s) {
#pragma unroll
    for (int c = 0; c < kB2; ++c) v[c] = own_row[swz<W>(row, c)];
  }
  __syncwarp();  // S and Q now overwrite the working copy
  T* dst = sq + (is_s ? 0 : kB2 * kB2) + row * kB2;
#pragma unroll
  for (int c = 0; c < kB2; ++c) dst[c] = from_wide<T>(v[c]);
}

// step 2: the columns of every block pair of X0 (and X1, if given) times
// that pair's Q, for all rows: a half-warp per row, Q's column in registers,
// the row's two 8-entry segments in 16-byte loads
template <typename T>
__device__ __forceinline__ void right_multiply(T* X0, T* X1, unsigned mp, unsigned nb, unsigned r,
                                               const T* SQ, unsigned warp, unsigned nw,
                                               unsigned lane) {
  const unsigned np = nb / 2, chunks = mp / kB2, mats = X1 ? 2u : 1u;
  const unsigned c = lane & (kB2 - 1), h = lane >> 4;
  for (unsigned item = warp; item < np * chunks * mats; item += nw) {
    const unsigned k = item % np, rest = item / np;
    T* X = rest >= chunks ? X1 : X0;
    const unsigned row0 = (rest % chunks) * kB2;
    unsigned P, Qb;
    block_pair(r, k, nb, P, Qb);
    const T* Qk = SQ + (size_t)(2 * k + 1) * kB2 * kB2;
    T q[kB2];
#pragma unroll
    for (int i = 0; i < kB2; ++i) q[i] = Qk[i * kB2 + c];
    const unsigned col = pair_index(c, P, Qb);
    for (unsigned i = h; i < kB2; i += 2) {
      const unsigned row = row0 + i;
      T x[kB2];
      load8(X + (size_t)row * mp + P * kB, x);
      load8(X + (size_t)row * mp + Qb * kB, x + kB);
      T acc = from_real<T>((real_t<T>)0), acc2 = acc;  // two chains: half the latency
#pragma unroll
      for (int j = 0; j < kB2; j += 2) {
        mac(acc, x[j], q[j]);
        mac(acc2, x[j + 1], q[j + 1]);
      }
      mac(acc, acc2, from_real<T>((real_t<T>)1));
      __syncwarp();  // the whole row read before any lane writes it
      X[(size_t)row * mp + col] = acc;
    }
  }
}

// step 3: the rows of every block pair of X times that pair's Q^H, for all
// columns, a lane per column; the pair's own diagonal block from S
template <typename T>
__device__ __forceinline__ void left_multiply(T* X, unsigned mp, unsigned nb, unsigned r,
                                              const T* SQ, unsigned warp, unsigned nw,
                                              unsigned lane) {
  const unsigned np = nb / 2, chunks = (mp + 31) / 32;
  for (unsigned item = warp; item < np * chunks; item += nw) {
    const unsigned k = item % np, col = (item / np) * 32 + lane;
    if (col >= mp) continue;
    unsigned P, Qb;
    block_pair(r, k, nb, P, Qb);
    const T* Qk = SQ + (size_t)(2 * k + 1) * kB2 * kB2;
    T acc[kB2];
#pragma unroll
    for (int i = 0; i < kB2; ++i) acc[i] = from_real<T>((real_t<T>)0);
#pragma unroll
    for (int l = 0; l < kB2; ++l) {
      const T b = X[(size_t)pair_index(l, P, Qb) * mp + col];
      T qrow[kB2];
      load8(Qk + l * kB2, qrow);
      load8(Qk + l * kB2 + kB, qrow + kB);
#pragma unroll
      for (int i = 0; i < kB2; ++i) mac(acc[i], cj(qrow[i]), b);
    }
    const unsigned cb = col / kB;
    if (cb == P || cb == Qb) {
      const T* Sk = SQ + (size_t)2 * k * kB2 * kB2 + (cb == P ? col - P * kB : kB + col - Qb * kB);
#pragma unroll
      for (int i = 0; i < kB2; ++i) acc[i] = Sk[i * kB2];
    }
#pragma unroll
    for (int i = 0; i < kB2; ++i) X[(size_t)pair_index(i, P, Qb) * mp + col] = acc[i];
  }
}

// kSmem: the buffer is in shared memory (a template argument, so every
// access is a shared-memory instruction, not a generic one)
template <typename T, int NT, bool kSmem>
__global__ void __launch_bounds__(NT)
    blocked_eigh_kernel(const T* __restrict__ a, real_t<T>* __restrict__ w, T* __restrict__ v,
                        unsigned char* __restrict__ work, int* __restrict__ sweeps_out, int m) {
  using R = real_t<T>;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double red[32];
  const BLayout L = blayout<T>(m);
  unsigned char* base = kSmem ? dyn : work + (size_t)blockIdx.x * L.total;
  T* A = reinterpret_cast<T*>(base + L.a);
  T* V = reinterpret_cast<T*>(base + L.v);
  T* SQ = reinterpret_cast<T*>(base + L.sq);  // pair k: S at 2k * 256, Q after it
  Rot2<wide_t<T>>* Rall = reinterpret_cast<Rot2<wide_t<T>>*>(base + L.rot);
  R* d = reinterpret_cast<R*>(base + L.d);
  R* nrm = reinterpret_cast<R*>(base + L.nrm);
  int* rank = reinterpret_cast<int*>(base + L.rank);
  const unsigned tid = threadIdx.x, nt = blockDim.x, um = (unsigned)m, mp = L.mp;
  const unsigned lane = tid & 31u, warp = tid >> 5, nw = nt >> 5;
  const unsigned mm = mp * mp, nb = 2 * L.np;
  const T* src = a + (size_t)blockIdx.x * um * um;
  R* w_out = w + (size_t)blockIdx.x * um;
  T* v_out = v + (size_t)blockIdx.x * um * um;

  // the Hermitian matrix of the lower triangle (real diagonal), padded with
  // zeros, and V = I
  double local = 0.0;
  for (unsigned it = tid; it < mm; it += nt) {
    const unsigned i = it / mp, j = it - i * mp;
    T x = from_real<T>((R)0);
    if (i < um && j < um) {
      const unsigned ij = i * um + j;
      x = i > j ? src[ij] : i == j ? from_real<T>(real_part(src[ij])) : cj(src[j * um + i]);
    }
    A[it] = x;
    V[it] = from_real<T>(i == j ? (R)1 : (R)0);
    local += sq(x);
  }
  const double fro2 = block_sum(local, red);
  if (!(fro2 <= DBL_MAX)) {  // an entry that is NaN or infinite: NaN out, no sweep
    for (unsigned it = tid; it < um * um; it += nt) v_out[it] = from_real<T>((R)NAN);
    for (unsigned j = tid; j < um; j += nt) w_out[j] = (R)NAN;
    if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = 0;
    return;
  }
  const double tol2 = Eps<R>::value * Eps<R>::value * fro2;
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (unsigned it = tid; it < mm; it += nt)
      if (it % (mp + 1) != 0) off += sq(A[it]);
    if (!(block_sum(off, red) > tol2)) break;
    for (unsigned r = 0; r + 1 < nb; ++r) {
      for (unsigned k = warp; k < L.np; k += nw) {
        unsigned P, Qb;
        block_pair(r, k, nb, P, Qb);
        pair_solve(A, mp, P * kB, Qb * kB, P, Qb, r == 0, SQ + (size_t)k * 2 * kB2 * kB2,
                   Rall + (size_t)k * kB, lane);
      }
      __syncthreads();
      right_multiply<T>(A, V, mp, nb, r, SQ, warp, nw, lane);
      __syncthreads();
      left_multiply<T>(A, mp, nb, r, SQ, warp, nw, lane);
      __syncthreads();
    }
  }

  for (unsigned j = tid; j < um; j += nt) d[j] = real_part(A[j * mp + j]);
  __syncthreads();
  if constexpr (sizeof(R) == 8) {
    // f64 and c128: one Newton-Schulz step V <- V (3I - V^H V) / 2. The
    // dense products that apply each step's Q to V leave its columns some
    // tens of eps from orthogonal after a solve's ~100 steps (47.8 eps at
    // m = 150 in c128, against the contract's 50); the step squares that.
    // G = V^H V goes where A was (its diagonal is in d now), the new rows,
    // 16 at a time, where the pairs' S and Q were (np 512 >= 16 m_p).
    T* G = A;
    for (unsigned it = tid; it < um * um; it += nt) {
      const unsigned i = it / um, j = it - i * um;
      if (i > j) continue;
      T acc = from_real<T>((R)0);
      for (unsigned k = 0; k < um; ++k) mac(acc, cj(V[k * mp + i]), V[k * mp + j]);
      G[i * mp + j] = acc;
      G[j * mp + i] = cj(acc);
    }
    __syncthreads();
    for (unsigned r0 = 0; r0 < um; r0 += kB2) {
      const unsigned rows = um - r0 < (unsigned)kB2 ? um - r0 : (unsigned)kB2;
      for (unsigned it = tid; it < rows * um; it += nt) {
        const unsigned i = it / um, j = it - i * um;
        T acc = from_real<T>((R)0);
        for (unsigned k = 0; k < um; ++k) mac(acc, V[(r0 + i) * mp + k], G[k * mp + j]);
        SQ[i * mp + j] = ns_step(V[(r0 + i) * mp + j], acc);
      }
      __syncthreads();
      for (unsigned it = tid; it < rows * um; it += nt) {
        const unsigned i = it / um, j = it - i * um;
        V[(r0 + i) * mp + j] = SQ[i * mp + j];
      }
      __syncthreads();
    }
  }

  // unit columns, then the ascending order
  for (unsigned j = tid; j < um; j += nt) {
    double s2 = 0.0;
    for (unsigned i = 0; i < um; ++i) s2 += sq(V[i * mp + j]);
    nrm[j] = (R)(1.0 / sqrt(s2));
  }
  __syncthreads();
  for (unsigned j = tid; j < um; j += nt) {
    const R kj = sort_key(d[j]);
    int rk = 0;
    for (unsigned i = 0; i < um; ++i) {
      const R ki = sort_key(d[i]);
      rk += ki < kj || (ki == kj && i < j);
    }
    rank[j] = rk;
    w_out[rk] = d[j];
  }
  __syncthreads();
  for (unsigned it = tid; it < um * um; it += nt) {
    const unsigned i = it / um, j = it - i * um;
    v_out[i * um + rank[j]] = scale(nrm[j], V[i * mp + j]);
  }
  if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = sweep;
}

// ---------------------------------------------------------------------------
// The cluster kernel: the blocked kernel's method on a thread-block cluster of
// C <= 8 CTAs per matrix, on neighbouring SMs, where its buffers fit in
// shared memory.
//
// The blocked kernel runs a matrix on one SM, and its dense passes are bound
// by that SM's shared-memory wavefronts. Here CTA c of a matrix's cluster
// owns the block pairs k = c, c + C, ... (ppc = ceil(np / C) slots) and holds
// each pair's 16 columns of A and of V: all m_p rows, row-major, 16 entries a
// row (block P's 8, then block Qb's). An outer step takes two cluster
// barriers:
//   1. each slot's 16 x 16 diagonal block S goes to a warp, pair_solve as in
//      the blocked kernel, which writes the rotated S and Q; each CTA then
//      writes its Q's into every CTA's shared memory (distributed shared
//      memory), and the cluster syncs;
//   2. each slot's new columns, a warp per 16 x 16 tile: A'[I, J] =
//      Q_I^H A[I, J] Q_J for every row pair I (the pair's own block from S)
//      and V'[:, J] = V[:, J] Q_J; each result column goes straight to the
//      CTA and slot its block has at the next step (the circle method moves
//      blocks between pairs), into the other of two buffers, and the cluster
//      syncs.
// The stopping test's sums and the diagonal go to every CTA the same way;
// each CTA adds the sums in rank order, so all take the same branch with the
// same bits. f64 and c128 take the blocked kernel's Newton-Schulz step, with
// V shared through v_out (each CTA writes its columns there, then reads them
// all). The rest is the blocked kernel's.
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kClusterThreads = 256;

struct CLayout {
  size_t a, v, sq, qall, rot, red, csum, d, nrm, rank, total;
  unsigned mp, np, C, ppc;
};

// per CTA: A's and V's columns of its slots (two buffers each), each slot's
// S and Q (the working S while solved, as in the blocked kernel), every
// pair's Q, the slots' rotations, the block and cluster sums, the whole
// diagonal, the slots' column scales and ranks
template <typename T> __host__ __device__ inline CLayout clayout(int m) {
  using W = wide_t<T>;
  CLayout L;
  const unsigned nb = ((unsigned)m + kB - 1) / kB;
  L.np = (nb + 1) / 2;
  L.mp = 2 * L.np * kB;
  L.ppc = (L.np + kMaxCluster - 1) / kMaxCluster;
  L.C = (L.np + L.ppc - 1) / L.ppc;
  const size_t cols = (size_t)L.ppc * L.mp * kB2;
  size_t off = 0;
  L.a = take(off, sizeof(T) * 2 * cols);
  L.v = take(off, sizeof(T) * 2 * cols);
  L.sq = take(off, sizeof(T) * L.ppc * 2 * kB2 * kB2);
  L.qall = take(off, sizeof(T) * L.np * kB2 * kB2);
  L.rot = take(off, sizeof(Rot2<W>) * L.ppc * kB);
  L.red = take(off, sizeof(double) * 32);
  L.csum = take(off, sizeof(double) * 2 * kMaxCluster);
  L.d = take(off, sizeof(real_t<T>) * L.mp);
  L.nrm = take(off, sizeof(real_t<T>) * L.ppc * kB2);
  L.rank = take(off, sizeof(int) * L.ppc * kB2);
  L.total = off;
  return L;
}

// the pair k and half (0: P, 1: Qb) of block b at step r among nb blocks, the
// inverse of block_pair
__device__ __forceinline__ void block_slot(unsigned b, unsigned r, unsigned nb, unsigned& k,
                                           unsigned& half) {
  if (b == nb - 1 || b == r) {
    k = 0;
    half = b == nb - 1;
    return;
  }
  const unsigned dist = (b + (nb - 1) - r) % (nb - 1);
  k = dist < nb / 2 ? dist : nb - 1 - dist;
  half = dist >= nb / 2;
}

// lane ^ 16's x
__device__ __forceinline__ float xor16(float x) { return __shfl_xor_sync(kFull, x, 16); }
__device__ __forceinline__ double xor16(double x) { return __shfl_xor_sync(kFull, x, 16); }
template <typename R> __device__ __forceinline__ Cx<R> xor16(Cx<R> x) {
  return {xor16(x.re), xor16(x.im)};
}

__device__ __forceinline__ float plus(float x, float y) { return x + y; }
__device__ __forceinline__ double plus(double x, double y) { return x + y; }
template <typename R> __device__ __forceinline__ Cx<R> plus(Cx<R> x, Cx<R> y) {
  return {x.re + y.re, x.im + y.im};
}

// a load that another CTA's stores reach after a cluster barrier (through L2)
__device__ __forceinline__ double load_cg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ Cx<double> load_cg(const Cx<double>* p) {
  const double2 x = __ldcg(reinterpret_cast<const double2*>(p));
  return {x.x, x.y};
}

// the cluster-wide sum of every thread's v, the same bits in every thread of
// every CTA: each CTA's sum goes to slot c of every CTA's sums (two uses in a
// row need other sums), and each CTA adds them in rank order
__device__ double cluster_sum(cg::cluster_group& cl, double v, double* red, double* sums) {
  const double s = block_sum(v, red);
  const unsigned C = cl.num_blocks();
  if (threadIdx.x < C) cl.map_shared_rank(sums, threadIdx.x)[cl.block_rank()] = s;
  cl.sync();
  double t = 0.0;
  for (unsigned i = 0; i < C; ++i) t += sums[i];
  return t;
}

// step 2 for one 16 x 16 tile of slot s's new columns, by one warp: A'[I, J] =
// Q_I^H X Q_J with X = A[I, J], I the row pair kr (I = J: S), or V'[rows, J] =
// X Q_J with X = V's rows 16 kr .. 16 kr + 15. Lane (c, h) = (lane % 16,
// lane / 16) makes column c of Y = X Q_J on rows h, h + 2, ..., then its
// share of Q_I^H Y over those rows for all 16 rows, and adds lane ^ 16's share
// of its own. The results of column c go to dst (rows at stride 16).
template <typename T>
__device__ __forceinline__ void column_tile(const T* X, const T* Qj, const T* Qi, const T* S,
                                            unsigned Pi, unsigned Qbi, unsigned kr, T* dst,
                                            unsigned lane) {
  const unsigned c = lane & (kB2 - 1), h = lane >> 4;
  T z[kB];  // rows h + 2u, u = 0 .. 7, of column c
  if (S) {
#pragma unroll
    for (int u = 0; u < kB; ++u) z[u] = S[(h + 2 * u) * kB2 + c];
  } else {
    T q[kB2];
#pragma unroll
    for (int l = 0; l < kB2; ++l) q[l] = Qj[l * kB2 + c];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const unsigned i = h + 2 * u;
      T x[kB2];
      const T* row = X + (size_t)(Qi ? pair_index(i, Pi, Qbi) : kr * kB2 + i) * kB2;
      load8(row, x);
      load8(row + kB, x + kB);
      T acc = from_real<T>((real_t<T>)0), acc2 = acc;
#pragma unroll
      for (int l = 0; l < kB2; l += 2) {
        mac(acc, x[l], q[l]);
        mac(acc2, x[l + 1], q[l + 1]);
      }
      mac(acc, acc2, from_real<T>((real_t<T>)1));
      z[u] = acc;
    }
    if (Qi) {
      T part[kB2];
#pragma unroll
      for (int i = 0; i < kB2; ++i) part[i] = from_real<T>((real_t<T>)0);
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        T qrow[kB2];
        load8(Qi + (h + 2 * u) * kB2, qrow);
        load8(Qi + (h + 2 * u) * kB2 + kB, qrow + kB);
#pragma unroll
        for (int i = 0; i < kB2; ++i) mac(part[i], cj(qrow[i]), z[u]);
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {  // keep rows h + 2u, send rows (1 - h) + 2u
        const T keep = h ? part[2 * u + 1] : part[2 * u];
        const T send = h ? part[2 * u] : part[2 * u + 1];
        z[u] = plus(keep, xor16(send));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const unsigned i = h + 2 * u;
    dst[(size_t)(Qi || S ? pair_index(i, Pi, Qbi) : kr * kB2 + i) * kB2] = z[u];
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
    cluster_eigh_kernel(const T* __restrict__ a, real_t<T>* __restrict__ w, T* __restrict__ v,
                        int* __restrict__ sweeps_out, int m) {
  using R = real_t<T>;
  using W = wide_t<T>;
  extern __shared__ __align__(16) unsigned char dyn[];
  cg::cluster_group cl = cg::this_cluster();
  const CLayout L = clayout<T>(m);
  const unsigned C = L.C, ppc = L.ppc, np = L.np, mp = L.mp, nb = 2 * np, um = (unsigned)m;
  const unsigned me = cl.block_rank(), mat = blockIdx.x / C;
  const unsigned tid = threadIdx.x, lane = tid & 31u, warp = tid >> 5, nw = NT / 32;
  const unsigned slot = mp * kB2, cols = ppc * slot, tile = kB2 * kB2;
  T* Abuf = reinterpret_cast<T*>(dyn + L.a);  // [2][ppc][m_p][16]
  T* Vbuf = reinterpret_cast<T*>(dyn + L.v);
  T* SQ = reinterpret_cast<T*>(dyn + L.sq);  // slot s: S at 2s * 256, Q after it
  T* Qall = reinterpret_cast<T*>(dyn + L.qall);  // pair k's Q at 256 k
  Rot2<W>* Rall = reinterpret_cast<Rot2<W>*>(dyn + L.rot);
  double* red = reinterpret_cast<double*>(dyn + L.red);
  double* sums = reinterpret_cast<double*>(dyn + L.csum);
  R* d = reinterpret_cast<R*>(dyn + L.d);
  R* nrm = reinterpret_cast<R*>(dyn + L.nrm);
  int* rank = reinterpret_cast<int*>(dyn + L.rank);
  const T* src = a + (size_t)mat * um * um;
  R* w_out = w + (size_t)mat * um;
  T* v_out = v + (size_t)mat * um * um;

  // slot s's pair k = me + s C (none when k >= np) and the global column of
  // its local column l at step 0, where every sweep starts
  auto column = [&](unsigned s, unsigned l) -> unsigned {
    const unsigned k = me + s * C;
    if (k >= np) return ~0u;
    unsigned P, Qb;
    block_pair(0, k, nb, P, Qb);
    return pair_index(l, P, Qb);
  };

  // the Hermitian matrix of the lower triangle (real diagonal), padded with
  // zeros, and V = I, in buffer 0
  double local = 0.0;
  for (unsigned it = tid; it < cols; it += NT) {
    const unsigned s = it / slot, i = (it - s * slot) / kB2, j = column(s, it % kB2);
    T x = from_real<T>((R)0), e = x;
    if (i < um && j < um) {
      const unsigned ij = i * um + j;
      x = i > j ? src[ij] : i == j ? from_real<T>(real_part(src[ij])) : cj(src[j * um + i]);
    }
    if (i == j) e = from_real<T>((R)1);
    Abuf[it] = x;
    Vbuf[it] = e;
    local += sq(x);
  }
  const double fro2 = cluster_sum(cl, local, red, sums);
  if (!(fro2 <= DBL_MAX)) {  // an entry that is NaN or infinite: NaN out, no sweep
    if (me == 0) {
      for (unsigned it = tid; it < um * um; it += NT) v_out[it] = from_real<T>((R)NAN);
      for (unsigned j = tid; j < um; j += NT) w_out[j] = (R)NAN;
      if (tid == 0 && sweeps_out) sweeps_out[mat] = 0;
    }
    return;
  }
  const double tol2 = Eps<R>::value * Eps<R>::value * fro2;
  unsigned cb = 0;
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (unsigned it = tid; it < cols; it += NT) {
      const unsigned s = it / slot, i = (it - s * slot) / kB2, j = column(s, it % kB2);
      if (j != ~0u && i != j) off += sq(Abuf[cb * cols + it]);
    }
    if (!(cluster_sum(cl, off, red, sums + kMaxCluster) > tol2)) break;
    for (unsigned r = 0; r + 1 < nb; ++r) {
      const unsigned rn = r + 2 < nb ? r + 1 : 0;  // the next step: the next sweep's first
      const T* Acur = Abuf + cb * cols;
      const T* Vcur = Vbuf + cb * cols;
      for (unsigned s = warp; s < ppc; s += nw) {
        const unsigned k = me + s * C;
        if (k >= np) continue;
        unsigned P, Qb;
        block_pair(r, k, nb, P, Qb);
        pair_solve(Acur + s * slot, kB2, 0, kB, P, Qb, r == 0, SQ + 2 * s * tile, Rall + s * kB,
                   lane);
      }
      __syncthreads();
      for (unsigned it = tid; it < ppc * C * tile; it += NT) {  // every CTA gets the Q's
        const unsigned e = it % tile, to = (it / tile) % C, s = it / (tile * C);
        const unsigned k = me + s * C;
        if (k < np) cl.map_shared_rank(Qall, to)[k * tile + e] = SQ[(2 * s + 1) * tile + e];
      }
      cl.sync();
      for (unsigned item = warp; item < ppc * 2 * np; item += nw) {
        const unsigned s = item / (2 * np), kr = item % np, k = me + s * C;
        const bool is_v = item % (2 * np) >= np;
        if (k >= np) continue;
        unsigned P, Qb, Pi, Qbi, k2, half;
        block_pair(r, k, nb, P, Qb);
        block_pair(r, kr, nb, Pi, Qbi);
        const unsigned c = lane & (kB2 - 1);
        block_slot(c < kB ? P : Qb, rn, nb, k2, half);
        T* next = (is_v ? Vbuf : Abuf) + (cb ^ 1) * cols;
        T* dst = cl.map_shared_rank(next, k2 % C) + (k2 / C) * slot + half * kB + (c & (kB - 1));
        const T* S = !is_v && kr == k ? SQ + 2 * s * tile : nullptr;
        column_tile<T>((is_v ? Vcur : Acur) + s * slot, SQ + (2 * s + 1) * tile,
                       is_v ? nullptr : Qall + kr * tile, S, Pi, Qbi, kr, dst, lane);
      }
      cl.sync();
      cb ^= 1;
    }
  }

  // the diagonal, to every CTA
  T* Af = Abuf + cb * cols;
  T* Vf = Vbuf + cb * cols;
  for (unsigned it = tid; it < cols / mp * C; it += NT) {
    const unsigned to = it % C, sl = it / C, s = sl / kB2, j = column(s, sl % kB2);
    if (j != ~0u) cl.map_shared_rank(d, to)[j] = real_part(Af[s * slot + j * kB2 + sl % kB2]);
  }
  cl.sync();
  if constexpr (sizeof(R) == 8) {
    // f64 and c128: the blocked kernel's Newton-Schulz step V <- V (3I -
    // V^H V) / 2, with V through v_out: G's columns of the slots go to the
    // other buffer
    for (unsigned it = tid; it < cols; it += NT) {
      const unsigned s = it / slot, i = (it - s * slot) / kB2, j = column(s, it % kB2);
      if (i < um && j < um) v_out[i * um + j] = Vf[it];
    }
    cl.sync();
    T* G = Abuf + (cb ^ 1) * cols;
    for (unsigned it = tid; it < cols; it += NT) {
      const unsigned s = it / slot, i = (it - s * slot) / kB2, l = it % kB2, j = column(s, l);
      if (i >= um || j >= um) continue;
      T acc = from_real<T>((R)0);
      for (unsigned k = 0; k < um; ++k)
        mac(acc, cj(load_cg(v_out + k * um + i)), Vf[s * slot + k * kB2 + l]);
      G[it] = acc;
    }
    __syncthreads();
    for (unsigned it = tid; it < cols; it += NT) {
      const unsigned s = it / slot, i = (it - s * slot) / kB2, l = it % kB2, j = column(s, l);
      if (i >= um || j >= um) continue;
      T acc = from_real<T>((R)0);
      for (unsigned k = 0; k < um; ++k) mac(acc, load_cg(v_out + i * um + k), G[s * slot + k * kB2 + l]);
      Vf[it] = ns_step(Vf[it], acc);
    }
    cl.sync();  // every CTA done reading v_out
  }

  // unit columns, then the ascending order, each CTA its own columns
  for (unsigned t = tid; t < ppc * kB2; t += NT) {
    const unsigned s = t / kB2, l = t % kB2, j = column(s, l);
    if (j >= um) continue;
    double s2 = 0.0;
    for (unsigned i = 0; i < um; ++i) s2 += sq(Vf[s * slot + i * kB2 + l]);
    nrm[t] = (R)(1.0 / sqrt(s2));
    const R kj = sort_key(d[j]);
    int rk = 0;
    for (unsigned i = 0; i < um; ++i) {
      const R ki = sort_key(d[i]);
      rk += ki < kj || (ki == kj && i < j);
    }
    rank[t] = rk;
    w_out[rk] = d[j];
  }
  __syncthreads();
  for (unsigned it = tid; it < cols; it += NT) {
    const unsigned s = it / slot, i = (it - s * slot) / kB2, l = it % kB2, j = column(s, l);
    if (i < um && j < um) v_out[i * um + rank[s * kB2 + l]] = scale(nrm[s * kB2 + l], Vf[it]);
  }
  if (me == 0 && tid == 0 && sweeps_out) sweeps_out[mat] = sweep;
}

// ---- launch ----

// The kernels, by code: 0 the Jacobi kernel, 1 the blocked kernel on one CTA,
// 2 the blocked kernel on a cluster.
enum { kJacobi = 0, kBlocked = 1, kCluster = 2 };

// m0: at m = 24 the Jacobi kernel is the faster, at m = 32 (the blocked
// kernels' padded size for m = 17 .. 32) a blocked one. Above m0 the cluster
// kernel: in f32 it beats the one-CTA kernel at every m timed (171.3 /
// 275.6 / 436.0 / 853.6 us against 238.4 / 399.5 / 658.7 / 1636.6 at m =
// 32 / 48 / 64 / 96). chip_smoke.py phase 15a times the three kernels in
// f32 at m = 2 .. 150 and both blocked kernels in f64 (NVIDIA H100 80GB
// HBM3; PERF.md section 6).
constexpr int kJacobiMaxM = 24;

template <typename T> size_t layout_bytes(int m, int kernel) {
  return kernel == kJacobi ? layout<T>(m).total
         : kernel == kBlocked ? blayout<T>(m).total
                              : clayout<T>(m).total;
}

size_t bytes_for(int m, int dtype, int kernel) {
  switch (dtype) {
    case 0: return layout_bytes<float>(m, kernel);
    case 1: return layout_bytes<double>(m, kernel);
    case 2: return layout_bytes<Cx<float>>(m, kernel);
    case 3: return layout_bytes<Cx<double>>(m, kernel);
  }
  return 0;
}

// the kernel the dispatch takes: m <= m0 the Jacobi kernel; above it the
// cluster kernel where its buffers fit in shared memory (c128 to m = 128),
// else the blocked kernel on one CTA
int kernel_for(int m, int dtype) {
  if (m <= kJacobiMaxM) return kJacobi;
  return bytes_for(m, dtype, kCluster) <= kSmemLimit ? kCluster : kBlocked;
}

int threads_for(int m) {
  const int64_t items = (int64_t)m * ((m + 1) / 2);
  int64_t t = (items + 31) / 32 * 32;
  if (t < 32) t = 32;
  return (int)(t > kMaxThreads ? kMaxThreads : t);
}

template <typename T>
int launch(const void* a, void* w, void* v, void* work, int* sweeps, int m, int64_t batch,
           cudaStream_t stream, int kernel) {
  const size_t bytes = layout_bytes<T>(m, kernel);
  const bool in_smem = bytes <= kSmemLimit;
  if (!in_smem && (work == nullptr || kernel == kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_smem ? bytes : 0;
  const T* A = static_cast<const T*>(a);
  real_t<T>* W = static_cast<real_t<T>*>(w);
  T* Vo = static_cast<T*>(v);
  unsigned char* ws = static_cast<unsigned char*>(work);
  const unsigned grid = static_cast<unsigned>(batch);
  if (kernel == kJacobi) {
    if (int rc = set_dynamic_smem(small_eigh_kernel<T>, smem)) return rc;
    small_eigh_kernel<T><<<grid, threads_for(m), smem, stream>>>(A, W, Vo, ws, sweeps, m,
                                                                 in_smem ? 1 : 0);
  } else if (kernel == kBlocked) {
    // 16 warps; 8 for the complex types, whose passes hold twice the registers
    constexpr int nt = sizeof(wide_t<T>) > 8 ? 256 : 512;
    if (in_smem) {
      if (int rc = set_dynamic_smem(blocked_eigh_kernel<T, nt, true>, smem)) return rc;
      blocked_eigh_kernel<T, nt, true><<<grid, nt, smem, stream>>>(A, W, Vo, ws, sweeps, m);
    } else {
      blocked_eigh_kernel<T, nt, false><<<grid, nt, 0, stream>>>(A, W, Vo, ws, sweeps, m);
    }
  } else {
    const CLayout L = clayout<T>(m);
    if ((int64_t)L.C * batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    auto kern = cluster_eigh_kernel<T, kClusterThreads>;
    if (int rc = set_dynamic_smem(kern, smem)) return rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(L.C * batch), 1, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (int rc = static_cast<int>(cudaLaunchKernelEx(&cfg, kern, A, W, Vo, sweeps, m))) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The kernel linops_small_eigh runs for `kernel` (-1: the dispatch's choice
// by m and dtype; 0 Jacobi, 1 blocked, 2 cluster), or -1 when that kernel
// cannot take the size; *work gets the bytes of global workspace per matrix
// it needs (0 when its buffer fits in shared memory). dtype: 0 f32, 1 f64,
// 2 c64, 3 c128.
int linops_small_eigh_plan(int m, int dtype, int kernel, int64_t* work) {
  if (dtype < 0 || dtype > 3 || kernel < -1 || kernel > kCluster || m <= 0) return -1;
  if (kernel < 0) kernel = kernel_for(m, dtype);
  const size_t bytes = bytes_for(m, dtype, kernel);
  if (kernel == kCluster && bytes > kSmemLimit) return -1;
  *work = bytes <= kSmemLimit ? 0 : static_cast<int64_t>(bytes);
  return kernel;
}

// a (batch, m, m) -> w (batch, m) ascending, v (batch, m, m) with the
// eigenvectors as columns, by the kernel linops_small_eigh_plan names; work:
// batch times its bytes (or null when that is 0); sweeps: the sweeps each
// matrix ran (or null).
int linops_small_eigh(const void* a, void* w, void* v, void* work, void* sweeps, int m,
                      int64_t batch, int dtype, int device, void* stream, int kernel) {
  if (int err = static_cast<int>(cudaSetDevice(device))) return err;
  if (m <= 0 || batch <= 0) return 0;
  if (kernel < 0) kernel = kernel_for(m, dtype);
  if (batch > 0x7fffffffLL || m > 46340 || kernel > kCluster)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sw = static_cast<int*>(sweeps);
  switch (dtype) {
    case 0: return launch<float>(a, w, v, work, sw, m, batch, s, kernel);
    case 1: return launch<double>(a, w, v, work, sw, m, batch, s, kernel);
    case 2: return launch<Cx<float>>(a, w, v, work, sw, m, batch, s, kernel);
    case 3: return launch<Cx<double>>(a, w, v, work, sw, m, batch, s, kernel);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
