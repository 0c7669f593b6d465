// E2: a batched small least-squares solver for Hopper (sm_90a).
//
// linops_small_lstsq computes what jnp.linalg.lstsq(a, b)[0] computes at its
// default cutoff, for a batch of r x c matrices a and right-hand sides b in
// f32, f64, c64 or c128: the minimum-norm y = V S+ U^H b of the thin SVD
// a = U S V^H, with every singular value s < eps * max(r, c) * s_max (eps of
// the input's precision) or s = 0 dropped. It is not the counterpart of a
// Pallas site: it replaces the jnp.linalg.lstsq that XLA lowers inside the
// reference's GMRES restart (linops_tpu/utils/krylov.py:185, the (m + 1) x m
// Hessenberg problem min ||beta e1 - H y||). torch.linalg.svd and
// torch.linalg.pinv on a CUDA tensor read cuSOLVER's info back to the host,
// which a CUDA-graph capture refuses; this kernel never reads the host,
// allocates nothing and calls no library, so a GMRES restart can be captured
// whole (utils/loop.py), nested inside another solve's block as well.
//
// Method: one-sided (Hestenes) Jacobi on the columns of a. A sweep is M - 1
// steps (M = c rounded up to even); step k pairs the columns by the circle
// method (as E1, small_eigh.cu), so the M/2 rotations of a step touch
// disjoint column pairs and run at once, one warp per pair. A warp sums
// alpha = |a_p|^2, beta = |a_q|^2 and gamma = a_p^H a_q over the rows (a
// fixed butterfly, so every lane holds the same bits), and where
// |gamma| > sqrt(r) eps_f64 sqrt(alpha beta) rotates columns p, q of a and of
// V (V starts as I) by the Jacobi rotation that makes them orthogonal
// (f = conj(gamma) / |gamma| turns gamma real first).
// Sweeps run until one rotates nothing, at most kMaxSweeps. Then a V = U S:
// s_j = |a_j|, and y = sum_j v_j (a_j^H b) / s_j^2 over the kept j.
//
// Why this method. After a lucky breakdown at Arnoldi step j every column of
// H past j is exactly zero. One-sided Jacobi never rotates a zero column
// (gamma = 0), so its v stays a unit vector no other column mixes with, its
// s is 0 and it is dropped: those entries of y come out exactly 0, as the
// SVD cutoff gives them. A Givens QR of the Hessenberg matrix would divide by
// zero there, and a solve through H^H H squares the condition number, which
// makes the eps-relative cutoff meaningless in f32.
//
// Precision: every product and rotation runs in f64 (c128 for complex
// input), whatever the input type: E1 needed f64 rotations for f32 input to
// stay within its 50-eps limit. The results are rounded to the input's type
// once. The input is scaled by powers of two (exact) so that the squared
// column norms neither overflow nor underflow; a non-finite entry in a or b
// gives NaN in y and s.
//
// Layout: one thread block per matrix, min(32, ceil(c / 2)) warps. a, V, b
// and the coefficients sit in dynamic shared memory when they fit (up to
// 227 KB: c <= 118 in f64 units, c <= 83 in c128), else in a global
// workspace the wrapper allocates (linops_small_lstsq_work bytes per matrix);
// the code is the same on both (a template parameter names the memory, so
// the loads are not generic).
//
// What bounds it: at GMRES's sizes (c = restart, 2 .. a few tens) neither
// bytes nor operations. A sweep is M - 1 dependent steps separated by block
// barriers, each a few butterfly reductions and a rotation, so the time is
// that chain's latency times the sweeps (in f64: 7 at c = 30 on a GMRES
// Hessenberg, 9-19 on random ill-conditioned ones at c = 30-128). The
// operations a least-squares solve by SVD needs, 4 r c^2 + 8 c^3 (Golub &
// Van Loan, section 5.5), over the card's peak give a bound far below it
// (chip_smoke.py phase 15f reports both, and the sweeps).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "bsr_common.cuh"  // linops_cuda_error_string, set_dynamic_smem

namespace {

constexpr int kMaxSweeps = 30;
constexpr int kMaxWarps = 32;
// dynamic shared memory a Hopper thread block can take, less this kernel's
// static shared memory
constexpr size_t kSmemLimit = 232448 - 1024;

template <typename R> struct alignas(2 * sizeof(R)) Cx { R re, im; };

template <typename T> struct RealOf { using type = T; };
template <typename R> struct RealOf<Cx<R>> { using type = R; };
template <typename T> using real_t = typename RealOf<T>::type;

// the working type: f64 for real input, c128 for complex input
template <typename T> struct WideOf { using type = double; };
template <typename R> struct WideOf<Cx<R>> { using type = Cx<double>; };
template <typename T> using wide_t = typename WideOf<T>::type;

template <typename R> struct Eps;
template <> struct Eps<float> { static constexpr double value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };

using C2 = Cx<double>;

__device__ __forceinline__ double widen_to(float x) { return x; }
__device__ __forceinline__ double widen_to(double x) { return x; }
template <typename R> __device__ __forceinline__ C2 widen_to(Cx<R> x) {
  return {(double)x.re, (double)x.im};
}

template <typename T> __device__ __forceinline__ T narrow_to(double x) { return (T)x; }
template <typename T> __device__ __forceinline__ T narrow_to(C2 x) {
  return {(real_t<T>)x.re, (real_t<T>)x.im};
}

__device__ __forceinline__ double abs2(double x) { return x * x; }
__device__ __forceinline__ double abs2(C2 x) { return x.re * x.re + x.im * x.im; }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ double absval(C2 x) { return hypot(x.re, x.im); }
__device__ __forceinline__ double maxabs(double x) { return fabs(x); }
__device__ __forceinline__ double maxabs(C2 x) { return fmax(fabs(x.re), fabs(x.im)); }
__device__ __forceinline__ bool finite(double x) { return isfinite(x); }
__device__ __forceinline__ bool finite(C2 x) { return isfinite(x.re) && isfinite(x.im); }

template <typename W> __device__ __forceinline__ W zero();
template <> __device__ __forceinline__ double zero<double>() { return 0.0; }
template <> __device__ __forceinline__ C2 zero<C2>() { return {0.0, 0.0}; }
template <typename W> __device__ __forceinline__ W unit();
template <> __device__ __forceinline__ double unit<double>() { return 1.0; }
template <> __device__ __forceinline__ C2 unit<C2>() { return {1.0, 0.0}; }

__device__ __forceinline__ double scaled(double x, double s) { return x * s; }
__device__ __forceinline__ C2 scaled(C2 x, double s) { return {x.re * s, x.im * s}; }

// acc + conj(x) y
__device__ __forceinline__ double cdot_add(double acc, double x, double y) { return fma(x, y, acc); }
__device__ __forceinline__ C2 cdot_add(C2 acc, C2 x, C2 y) {
  return {fma(x.re, y.re, fma(x.im, y.im, acc.re)), fma(x.re, y.im, fma(-x.im, y.re, acc.im))};
}

// acc + x y
__device__ __forceinline__ double mul_add(double acc, double x, double y) { return fma(x, y, acc); }
__device__ __forceinline__ C2 mul_add(C2 acc, C2 x, C2 y) {
  return {fma(x.re, y.re, fma(-x.im, y.im, acc.re)), fma(x.re, y.im, fma(x.im, y.re, acc.im))};
}

// the sum over the warp, the same bits in every lane (a fixed butterfly)
__device__ __forceinline__ double warp_total(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ C2 warp_total(C2 v) { return {warp_total(v.re), warp_total(v.im)}; }

// f = conj(g) / |g| (|g| > 0): the phase that turns a_p^H (a_q f) real
__device__ __forceinline__ double unphase(double g, double) { return g >= 0.0 ? 1.0 : -1.0; }
__device__ __forceinline__ C2 unphase(C2 g, double ab) {
  const double inv = 1.0 / ab;
  return {g.re * inv, -g.im * inv};
}

// (x, y) <- (c x - s f y, s x + c f y)
__device__ __forceinline__ void rotate(double& x, double& y, double c, double s, double f) {
  const double fy = f * y, x0 = x;
  x = c * x0 - s * fy;
  y = s * x0 + c * fy;
}
__device__ __forceinline__ void rotate(C2& x, C2& y, double c, double s, C2 f) {
  const C2 fy = {f.re * y.re - f.im * y.im, f.re * y.im + f.im * y.re};
  const C2 x0 = x;
  x = {c * x0.re - s * fy.re, c * x0.im - s * fy.im};
  y = {s * x0.re + c * fy.re, s * x0.im + c * fy.im};
}

struct Layout {
  size_t a, v, b, coef, sig, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

// the per-matrix buffer in the working type W: a (r x c) and V (c x c), both
// column-major (a warp walks a column on consecutive addresses), b, the
// coefficients of y's sum, and the singular values
template <typename W> __host__ __device__ inline Layout layout(int r, int c) {
  Layout L;
  size_t off = 0;
  L.a = take(off, sizeof(W) * (size_t)r * c);
  L.v = take(off, sizeof(W) * (size_t)c * c);
  L.b = take(off, sizeof(W) * (size_t)r);
  L.coef = take(off, sizeof(W) * (size_t)c);
  L.sig = take(off, sizeof(double) * (size_t)c);
  L.total = off;
  return L;
}

// the block-wide maximum of every thread's v, the same in every thread
__device__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int nw = (int)((blockDim.x + 31) >> 5);
  __syncthreads();  // red is free: every thread read its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double m = 0.0;
  for (int i = 0; i < nw; ++i) m = fmax(m, red[i]);
  return m;
}

// 2^-e for the exponent e of x > 0 (exact), 1 for x = 0
__device__ __forceinline__ double pow2_scale(double x) {
  return x > 0.0 ? ldexp(1.0, -ilogb(x)) : 1.0;
}

// a (batch, r, c) row-major and b (batch, r) -> y (batch, c) and s (batch, c),
// the singular values in descending order; sweeps_out (or null): the sweeps
// each matrix ran
template <typename T, bool kSmem>
__global__ void small_lstsq_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                   T* __restrict__ y, real_t<T>* __restrict__ s,
                                   unsigned char* __restrict__ work, int* __restrict__ sweeps_out,
                                   int r, int c) {
  using W = wide_t<T>;
  using R = real_t<T>;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double red[32];
  __shared__ int rotated;
  const Layout L = layout<W>(r, c);
  unsigned char* base = kSmem ? dyn : work + (size_t)blockIdx.x * L.total;
  W* A = reinterpret_cast<W*>(base + L.a);
  W* V = reinterpret_cast<W*>(base + L.v);
  W* bw = reinterpret_cast<W*>(base + L.b);
  W* coef = reinterpret_cast<W*>(base + L.coef);
  double* sig = reinterpret_cast<double*>(base + L.sig);
  const unsigned tid = threadIdx.x, nt = blockDim.x, ur = (unsigned)r, uc = (unsigned)c;
  const unsigned rc = ur * uc;
  const T* src = a + (size_t)blockIdx.x * rc;
  const T* bsrc = b + (size_t)blockIdx.x * ur;
  T* y_out = y + (size_t)blockIdx.x * uc;
  R* s_out = s + (size_t)blockIdx.x * uc;

  // a (column-major), b and V = I, in the working type; the largest |entry|
  // of a and of b (infinite for a non-finite one)
  double amax = 0.0, bmax = 0.0;
  for (unsigned it = tid; it < rc; it += nt) {
    const unsigned i = it / uc, j = it - i * uc;
    const W x = widen_to(src[it]);
    A[j * ur + i] = x;
    amax = fmax(amax, finite(x) ? maxabs(x) : (double)INFINITY);
  }
  for (unsigned i = tid; i < ur; i += nt) {
    const W x = widen_to(bsrc[i]);
    bw[i] = x;
    bmax = fmax(bmax, finite(x) ? maxabs(x) : (double)INFINITY);
  }
  for (unsigned it = tid; it < uc * uc; it += nt) {
    const unsigned j = it / uc, i = it - j * uc;
    V[it] = i == j ? unit<W>() : zero<W>();
  }
  amax = block_max(amax, red);
  bmax = block_max(bmax, red);
  if (!(amax < INFINITY && bmax < INFINITY)) {  // NaN out, no sweep
    for (unsigned j = tid; j < uc; j += nt) {
      y_out[j] = narrow_to<T>(scaled(unit<W>(), (double)NAN));
      s_out[j] = (R)NAN;
    }
    if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = 0;
    return;
  }
  // powers of two, so the scaling is exact: |a|, |b| < 2 after it
  const double sa = pow2_scale(amax), sb = pow2_scale(bmax);
  for (unsigned it = tid; it < rc; it += nt) A[it] = scaled(A[it], sa);
  for (unsigned i = tid; i < ur; i += nt) bw[i] = scaled(bw[i], sb);
  __syncthreads();

  const unsigned warp = tid >> 5, lane = tid & 31u, nw = nt >> 5;
  const unsigned M = uc + (uc & 1u), np = M / 2;
  const double tol2 = (double)r * DBL_EPSILON * DBL_EPSILON;  // (sqrt(r) eps)^2
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (unsigned step = 0; step + 1 < M; ++step) {
      for (unsigned k = warp; k < np; k += nw) {
        unsigned p = k == 0 ? step : (step + k) % (M - 1);
        unsigned q = k == 0 ? M - 1 : (step + (M - 1) - k) % (M - 1);
        if (p > q) { const unsigned t = p; p = q; q = t; }
        if (q >= uc) continue;  // the padding column of an odd c: the warp idles
        W* ap = A + p * ur;
        W* aq = A + q * ur;
        double al = 0.0, be = 0.0;
        W ga = zero<W>();
        for (unsigned i = lane; i < ur; i += 32) {
          const W x = ap[i], z = aq[i];
          al += abs2(x);
          be += abs2(z);
          ga = cdot_add(ga, x, z);
        }
        al = warp_total(al);
        be = warp_total(be);
        ga = warp_total(ga);
        // |gamma| > tol sqrt(alpha beta), squared: a zero column has gamma = 0
        // exactly, so it is never rotated
        if (abs2(ga) > tol2 * al * be) {
          // t = sign(d) 2 |gamma| / (|d| + sqrt(d^2 + 4 |gamma|^2)), d = beta - alpha:
          // the smaller root of t^2 + 2 zeta t - 1 = 0, zeta = d / (2 |gamma|), with one
          // square root and one division on the step's dependent chain
          const double g = absval(ga), d = be - al;
          const double t = (d >= 0.0 ? 2.0 : -2.0) * g / (fabs(d) + hypot(d, 2.0 * g));
          const double cs = rsqrt(1.0 + t * t), sn = cs * t;
          const W f = unphase(ga, g);
          for (unsigned i = lane; i < ur; i += 32) rotate(ap[i], aq[i], cs, sn, f);
          W* vp = V + p * uc;
          W* vq = V + q * uc;
          for (unsigned i = lane; i < uc; i += 32) rotate(vp[i], vq[i], cs, sn, f);
          if (lane == 0) rotated = 1;
        }
      }
      __syncthreads();
    }
    const int more = rotated;
    __syncthreads();  // every thread read the flag before it is reset
    if (!more) break;
  }

  // a V = U S: s_j = |a_j|; the coefficient of v_j in y, (a_j^H b) / s_j^2,
  // for the kept s_j (the largest s by a block maximum: exact in any order)
  double smax = 0.0;
  for (unsigned j = tid; j < uc; j += nt) {
    double ss = 0.0;
    for (unsigned i = 0; i < ur; ++i) ss += abs2(A[j * ur + i]);
    sig[j] = sqrt(ss);
    smax = fmax(smax, sig[j]);
  }
  smax = block_max(smax, red);  // its barriers publish sig
  const double cut = Eps<R>::value * (double)(r > c ? r : c) * smax;
  for (unsigned j = tid; j < uc; j += nt) {
    W cj = zero<W>();
    const double sj = sig[j];
    if (sj > 0.0 && sj >= cut) {
      for (unsigned i = 0; i < ur; ++i) cj = cdot_add(cj, A[j * ur + i], bw[i]);
      cj = scaled(cj, 1.0 / (sj * sj));
    }
    coef[j] = cj;
  }
  __syncthreads();
  // y = V coef, undoing the scaling (a / sa -> y * sa; b / sb -> y / sb); the
  // singular values descending (rank by counting, ties by index)
  const double back = sa / sb;
  for (unsigned i = tid; i < uc; i += nt) {
    W acc = zero<W>();
    for (unsigned j = 0; j < uc; ++j) acc = mul_add(acc, V[j * uc + i], coef[j]);
    y_out[i] = narrow_to<T>(scaled(acc, back));
    const double si = sig[i];
    unsigned rank = 0;
    for (unsigned j = 0; j < uc; ++j) rank += sig[j] > si || (sig[j] == si && j < i);
    s_out[rank] = (R)(si / sa);
  }
  if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = sweep;
}

// ---- launch ----

int threads_for(int c) {
  const int pairs = (c + 1) / 2;
  return 32 * (pairs < 1 ? 1 : pairs > kMaxWarps ? kMaxWarps : pairs);
}

size_t bytes_for(int r, int c, int dtype) {
  return dtype == 0 || dtype == 1 ? layout<double>(r, c).total : layout<C2>(r, c).total;
}

template <typename T>
int launch(const void* a, const void* b, void* y, void* s, void* work, int* sweeps, int r, int c,
           int64_t batch, cudaStream_t stream) {
  const size_t bytes = layout<wide_t<T>>(r, c).total;
  const bool in_smem = bytes <= kSmemLimit;
  if (!in_smem && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* Y = static_cast<T*>(y);
  real_t<T>* S = static_cast<real_t<T>*>(s);
  unsigned char* ws = static_cast<unsigned char*>(work);
  const unsigned grid = static_cast<unsigned>(batch);
  const int nt = threads_for(c);
  if (in_smem) {
    if (int rc = set_dynamic_smem(small_lstsq_kernel<T, true>, bytes)) return rc;
    small_lstsq_kernel<T, true><<<grid, nt, bytes, stream>>>(A, B, Y, S, ws, sweeps, r, c);
  } else {
    small_lstsq_kernel<T, false><<<grid, nt, 0, stream>>>(A, B, Y, S, ws, sweeps, r, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The bytes of global workspace per matrix linops_small_lstsq needs for an
// r x c matrix of `dtype` (0 f32, 1 f64, 2 c64, 3 c128): 0 when its buffer
// fits in shared memory. Returns -1 for an argument it cannot take.
int linops_small_lstsq_work(int r, int c, int dtype, int64_t* work) {
  if (dtype < 0 || dtype > 3 || r <= 0 || c <= 0) return -1;
  const size_t bytes = bytes_for(r, c, dtype);
  *work = bytes <= kSmemLimit ? 0 : static_cast<int64_t>(bytes);
  return 0;
}

// a (batch, r, c) row-major, b (batch, r) -> y (batch, c), s (batch, c)
// descending (real, of a's precision); work: batch times
// linops_small_lstsq_work's bytes (or null when that is 0); sweeps: the
// sweeps each matrix ran (or null).
int linops_small_lstsq(const void* a, const void* b, void* y, void* s, void* work, void* sweeps,
                       int r, int c, int64_t batch, int dtype, int device, void* stream) {
  if (int err = static_cast<int>(cudaSetDevice(device))) return err;
  if (r <= 0 || c <= 0 || batch <= 0) return 0;
  if (batch > 0x7fffffffLL || (int64_t)r * c > 0x7fffffffLL || (int64_t)c * c > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sw = static_cast<int*>(sweeps);
  switch (dtype) {
    case 0: return launch<float>(a, b, y, s, work, sw, r, c, batch, st);
    case 1: return launch<double>(a, b, y, s, work, sw, r, c, batch, st);
    case 2: return launch<Cx<float>>(a, b, y, s, work, sw, r, c, batch, st);
    case 3: return launch<Cx<double>>(a, b, y, s, work, sw, r, c, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
