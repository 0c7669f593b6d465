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
// Method. The matrix is held with b as one more column, [a | b]
// (r x (c + 1)), in the working type.
//   1. A QR factorisation by Givens rotations of rows: column k's entries
//      below the diagonal are rotated into row k one by one (a rotation that
//      would meet a zero entry is skipped, so nothing divides by zero). Every
//      thread computes the same rotations from column k and applies them to
//      its own columns, b's among them: one block barrier per column. Only
//      the rows within the lower bandwidth are visited (one for GMRES's
//      Hessenberg, found once from the input), so this is c rotations there.
//      Then R y = Q^H b has the solution set of a y ~ b.
//   2. One-sided (Hestenes) Jacobi on the K = min(r, c) rows of R, as
//      vectors: a rotation of rows p and q that makes them orthogonal also
//      rotates their b entries, so the rows end as R^T W = X with orthogonal
//      columns x_j and the b column as W^T Q^H b. Then
//      y = sum_j conj(x_j) b_j / |x_j|^2 over the kept j: no V is stored or
//      rotated. Jacobi on the triangular factor takes fewer sweeps than on a
//      itself (Drmac and Veselic's preconditioning).
// A sweep is M - 1 steps (M = K rounded up to even); step k pairs the rows by
// the circle method, so the M/2 rotations of a step touch disjoint rows and
// run at once, one group of L lanes per pair (L = c rounded up to a power of
// two, at most 16, so a warp holds 32 / L pairs). A group sums
// gamma = x_p^H x_q (a fixed butterfly: every lane holds the same bits); the
// squared row norms alpha, beta are carried across rotations as LAPACK's
// xGESVJ carries them (alpha' = alpha - t |gamma|, beta' = beta + t |gamma|),
// recomputed exactly at each sweep's start and after a rotation that empties
// a row by more than 2^10, so a step's dependent chain holds one reduction.
// The angle comes from two f64 reciprocal square roots, with no division and
// no square root: 1 / sqrt(d^2 + 4 |gamma|^2) gives cos 2t and sin 2t
// (d = beta - alpha), 1 / sqrt(cos^2 t) gives cos t and sin t. Where
// |gamma| > sqrt(n) eps sqrt(alpha beta) (n entries summed) the pair is
// rotated (f = conj(gamma) / |gamma| turns gamma real first). Steps are
// separated by a block barrier, or by a warp barrier where one warp holds
// every pair (at most 8 vectors). Sweeps run until one rotates nothing, at
// most kMaxSweeps.
// f64 and c128 input keep V instead (Jacobi on R's columns, V rotated along,
// y = V (x_j^H Q^H b / s_j^2)): without V the right singular vectors are the
// rows' directions, accurate only to eps s_max / s_j, which put the
// residuals of random f64 Hessenbergs at m = 64 past the limit of 50 eps |b|
// in the host emulation; f32 and c64 input, run in f64, keep far inside
// their limits without it.
//
// Why this method. After a lucky breakdown at Arnoldi step j every column of
// H past j is exactly zero. Row rotations keep those columns exactly zero,
// in the QR and in the Jacobi sweeps, so the entries of y past j come out
// exactly 0, as the SVD cutoff gives them, and a zero row of R (s = 0) is
// never rotated (gamma = 0) and is dropped. A solve through H^H H would
// square the condition number, which makes the eps-relative cutoff
// meaningless in f32.
//
// Precision: every product and rotation runs in f64 (c128 for complex
// input), whatever the input type, and rotations run to f64's tolerance
// (sqrt(n) eps_f64): rotating c64 input only to f32's tolerance put a
// residual at m = 64 past the limit of 50 eps |b| in the host emulation.
// The results are rounded to the input's type once. The
// input is scaled by powers of two (exact) so that the squared norms neither
// overflow nor underflow; a non-finite entry in a or b gives NaN in y and s.
//
// Layout: one thread block per matrix, min(32, ceil(pairs / (32 / L))) warps.
// [a | b], V where kept, and the norms sit in dynamic shared memory when they
// fit (227 KB: GMRES's (m + 1) x m to m = 168 in f32, 119 in c64 and f64, 84
// in c128), else in a global workspace the wrapper allocates
// (linops_small_lstsq_work bytes per matrix); the code is the same on both (a
// template parameter names the memory, so the loads are not generic).
//
// What bounds it: at GMRES's sizes (c = restart, 2 .. a few tens) neither
// the bytes nor the operations a least-squares solve by SVD needs,
// 4 r c^2 + 8 c^3 (Golub & Van Loan, section 5.5), over the card's peak
// (chip_smoke.py phase 15f reports that bound, and the sweeps). A sweep is
// M - 1 dependent steps, and on the H100 a step's time follows the f64
// instructions its warps issue on the one SM, not its barrier or its chain:
// variants timed without the barrier, the butterfly or the square roots
// each saved little at m = 30, while at m = 128 the two square roots take
// about half of a step (PERF.md, section 6).

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
// a carried squared norm that falls below this share of its old value is
// summed again (cancellation in alpha - t |gamma|)
constexpr double kStale = 0x1p-10;

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
__device__ __forceinline__ double maxabs(double x) { return fabs(x); }
__device__ __forceinline__ double maxabs(C2 x) { return fmax(fabs(x.re), fabs(x.im)); }
__device__ __forceinline__ bool finite(double x) { return isfinite(x); }
__device__ __forceinline__ bool finite(C2 x) { return isfinite(x.re) && isfinite(x.im); }
__device__ __forceinline__ bool nonzero(double x) { return x != 0.0; }
__device__ __forceinline__ bool nonzero(C2 x) { return x.re != 0.0 || x.im != 0.0; }
__device__ __forceinline__ double conj_of(double x) { return x; }
__device__ __forceinline__ C2 conj_of(C2 x) { return {x.re, -x.im}; }

template <typename W> __device__ __forceinline__ W zero();
template <> __device__ __forceinline__ double zero<double>() { return 0.0; }
template <> __device__ __forceinline__ C2 zero<C2>() { return {0.0, 0.0}; }
template <typename W> __device__ __forceinline__ W real_as(double x);
template <> __device__ __forceinline__ double real_as<double>(double x) { return x; }
template <> __device__ __forceinline__ C2 real_as<C2>(double x) { return {x, 0.0}; }

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

// the sum over an aligned group of L lanes (a power of two), the same bits in
// each of its lanes (a fixed butterfly); every lane of the warp calls it
__device__ __forceinline__ double group_total(double v, unsigned L) {
  for (unsigned o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ C2 group_total(C2 v, unsigned L) {
  return {group_total(v.re, L), group_total(v.im, L)};
}

// |g| and f = conj(g) / |g| from g and g2 = |g|^2 > 0: the phase that turns
// x_p^H (f x_q) real
__device__ __forceinline__ double polar(double g, double, double& f) {
  f = g >= 0.0 ? 1.0 : -1.0;
  return fabs(g);
}
__device__ __forceinline__ double polar(C2 g, double g2, C2& f) {
  const double inv = rsqrt(g2);
  f = {g.re * inv, -g.im * inv};
  return g2 * inv;
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

// f64 and c128 input keep V (see the header); f32 and c64 input drop it
template <typename T> __host__ __device__ constexpr bool keeps_v() {
  return sizeof(real_t<T>) == sizeof(double);
}

struct Layout {
  size_t a, v, coef, nrm, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

// the per-matrix buffer in the working type W: [a | b] (r x (c + 1),
// row-major without V and column-major with V, so that a group walks a
// Jacobi vector on consecutive addresses: in the global workspace a strided
// walk would take a memory sector per lane; the QR's walks across columns
// are few); with V, V (c x c, column-major) and y's coefficients in the V
// basis; the Jacobi vectors' squared norms (then their norms)
template <typename W> __host__ __device__ inline Layout layout(int r, int c, bool with_v) {
  Layout L;
  size_t off = 0;
  L.a = take(off, sizeof(W) * (size_t)r * (c + 1));
  L.v = take(off, with_v ? sizeof(W) * (size_t)c * c : 0);
  L.coef = take(off, with_v ? sizeof(W) * (size_t)c : 0);
  L.nrm = take(off, sizeof(double) * (size_t)(r > c ? r : c));
  L.total = off;
  return L;
}

// lanes that sum one pair's products: n rounded up to a power of two, at
// most 16, so that a warp holds at least two pairs and their angles share
// its f64 instructions (the f64 pipe of the one SM bounds a step: a cap of
// 32 made m = 128 29 % slower on the H100, PERF.md)
__host__ __device__ inline unsigned lanes_for(int n) {
  unsigned L = 1;
  while (L < (unsigned)n && L < 16) L <<= 1;
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

// The Jacobi vectors: vector p's entry j at base[p * vs + j * es], j < n
// summed, j < nrot rotated. Groups of L lanes take vectors (norms) or pairs.
template <typename W> struct Vecs {
  W* base;
  unsigned vs, es, n, nrot, count;
  __device__ W& at(unsigned p, unsigned j) const { return base[p * vs + j * es]; }
};

// the squared norms of the vectors into nrm (root: the norms), a group a vector
template <typename W>
__device__ __forceinline__ void vec_norms(const Vecs<W>& X, double* nrm, unsigned grp,
                                          unsigned ngrp, unsigned sub, unsigned L, bool root) {
  for (unsigned p0 = 0; p0 < X.count; p0 += ngrp) {  // the same trip count in every group
    const unsigned p = p0 + grp;
    double s = 0.0;
    if (p < X.count)
      for (unsigned j = sub; j < X.n; j += L) s += abs2(X.at(p, j));
    s = group_total(s, L);
    if (p < X.count && sub == 0) nrm[p] = root ? sqrt(s) : s;
  }
}

// a (batch, r, c) row-major and b (batch, r) -> y (batch, c) and s (batch,
// c), the singular values in descending order (min(r, c) of them without V;
// with V, c, the rest near zero); sweeps_out (or null): the sweeps each
// matrix ran
// Registers capped so that 32 warps fit (64 a thread).
template <typename T, bool kSmem>
__launch_bounds__(kMaxWarps * 32) __global__ void
small_lstsq_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                   T* __restrict__ y, real_t<T>* __restrict__ s,
                                   unsigned char* __restrict__ work, int* __restrict__ sweeps_out,
                                   int r, int c) {
  using W = wide_t<T>;
  using R = real_t<T>;
  constexpr bool kV = keeps_v<T>();
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double red[32];
  __shared__ int rotated;
  const Layout Lay = layout<W>(r, c, kV);
  unsigned char* base = kSmem ? dyn : work + (size_t)blockIdx.x * Lay.total;
  W* A = reinterpret_cast<W*>(base + Lay.a);
  W* V = reinterpret_cast<W*>(base + Lay.v);
  W* coef = reinterpret_cast<W*>(base + Lay.coef);
  double* nrm = reinterpret_cast<double*>(base + Lay.nrm);
  const unsigned tid = threadIdx.x, nt = blockDim.x, ur = (unsigned)r, uc = (unsigned)c;
  const unsigned ld = uc + 1, rc = ur * uc;
  // entry (i, j) of [a | b] at A[i * ar + j * ac]: row-major without V,
  // column-major with V, so that a Jacobi vector is contiguous
  const unsigned ar = kV ? 1u : ld, ac = kV ? ur : 1u;
  const T* src = a + (size_t)blockIdx.x * rc;
  const T* bsrc = b + (size_t)blockIdx.x * ur;
  T* y_out = y + (size_t)blockIdx.x * uc;
  R* s_out = s + (size_t)blockIdx.x * uc;

  // [a | b] in the working type (and V = I); the largest |entry| of a and
  // of b (infinite for a non-finite one); a's lower bandwidth (the largest
  // i - j of a nonzero entry)
  double amax = 0.0, bmax = 0.0, band = 0.0;
  for (unsigned it = tid; it < rc; it += nt) {
    const unsigned i = it / uc, j = it - i * uc;
    const W x = widen_to(src[it]);
    A[i * ar + j * ac] = x;
    amax = fmax(amax, finite(x) ? maxabs(x) : (double)INFINITY);
    if (i > j && nonzero(x)) band = fmax(band, (double)(i - j));
  }
  for (unsigned i = tid; i < ur; i += nt) {
    const W x = widen_to(bsrc[i]);
    A[i * ar + uc * ac] = x;
    bmax = fmax(bmax, finite(x) ? maxabs(x) : (double)INFINITY);
  }
  if (kV)
    for (unsigned it = tid; it < uc * uc; it += nt)
      V[it] = real_as<W>(it / uc == it % uc ? 1.0 : 0.0);
  amax = block_max(amax, red);
  bmax = block_max(bmax, red);
  const unsigned bw = (unsigned)block_max(band, red);
  if (!(amax < INFINITY && bmax < INFINITY)) {  // NaN out, no sweep
    for (unsigned j = tid; j < uc; j += nt) {
      y_out[j] = narrow_to<T>(scaled(real_as<W>(1.0), (double)NAN));
      s_out[j] = (R)NAN;
    }
    if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = 0;
    return;
  }
  // powers of two, so the scaling is exact: |a|, |b| < 2 after it
  const double sa = pow2_scale(amax), sb = pow2_scale(bmax);
  for (unsigned it = tid; it < ur * ld; it += nt) {
    const unsigned j = kV ? it / ur : it % ld;
    A[it] = scaled(A[it], j < uc ? sa : sb);
  }
  __syncthreads();

  // 1. QR: column k's entries in rows k+1 .. k+bw rotated into row k (the
  // band does not widen: row i takes row k's entries right of column k).
  // Every thread forms the same rotations; thread t rotates columns
  // k+1+t, k+1+t+nt, ... (b's column, uc, among them). Column k itself is
  // read-only here; one thread writes it after the barrier (R[k,k] and
  // zeros), where the next column's reads do not look.
  for (unsigned k = 0; k + 1 < ur && k < uc; ++k) {
    const unsigned iend = min(ur, k + 1 + bw);
    W piv = A[k * ar + k * ac];
    for (unsigned i = k + 1; i < iend; ++i) {
      const W h = A[i * ar + k * ac];
      if (!nonzero(h)) continue;
      // G = [[conj(piv), conj(h)], [-h, piv]] / sqrt(|piv|^2 + |h|^2), on
      // inputs scaled by a power of two so the squares neither overflow nor
      // underflow
      const double sc = pow2_scale(fmax(maxabs(piv), maxabs(h)));
      const W ps = scaled(piv, sc), hs = scaled(h, sc);
      const double n2 = abs2(ps) + abs2(hs);
      const double inv = rsqrt(n2);
      const W g11 = scaled(conj_of(ps), inv), g12 = scaled(conj_of(hs), inv);
      const W g21 = scaled(hs, -inv), g22 = scaled(ps, inv);
      for (unsigned j = k + 1 + tid; j <= uc; j += nt) {
        const W xk = A[k * ar + j * ac], xi = A[i * ar + j * ac];
        A[k * ar + j * ac] = mul_add(mul_add(zero<W>(), g11, xk), g12, xi);
        A[i * ar + j * ac] = mul_add(mul_add(zero<W>(), g21, xk), g22, xi);
      }
      piv = real_as<W>(n2 * inv / sc);
    }
    __syncthreads();
    if (tid == 0) {
      A[k * ar + k * ac] = piv;
      for (unsigned i = k + 1; i < iend; ++i) A[i * ar + k * ac] = zero<W>();
    }
  }
  __syncthreads();

  // 2. one-sided Jacobi: without V on the K rows of R (b's entries rotated
  // with them), with V on the c columns of R's K rows; group grp of L lanes
  // takes pairs grp, grp + ngrp, ... of each step
  const unsigned K = ur < uc ? ur : uc;
  const Vecs<W> X = kV ? Vecs<W>{A, ac, 1, K, K, uc} : Vecs<W>{A, ar, 1, uc, uc + 1, K};
  const unsigned lane = tid & 31u, nw = nt >> 5, L = lanes_for(X.n);
  const unsigned sub = lane & (L - 1), grp = (tid >> 5) * (32 / L) + lane / L;
  const unsigned ngrp = nw * (32 / L);
  const unsigned M = X.count + (X.count & 1u), np = M / 2;
  const double tol2 = (double)X.n * DBL_EPSILON * DBL_EPSILON;  // (sqrt(n) eps)^2
  int sweep = 0;
  for (; sweep < kMaxSweeps && X.count > 1; ++sweep) {
    if (tid == 0) rotated = 0;
    vec_norms(X, nrm, grp, ngrp, sub, L, false);
    __syncthreads();
    for (unsigned step = 0; step + 1 < M; ++step) {
      for (unsigned k0 = 0; k0 < np; k0 += ngrp) {  // the same trip count in every group
        const unsigned k = k0 + grp;
        unsigned p = step, q = M - 1;
        if (k != 0) {
          p = step + k;
          q = step + (M - 1) - k;
          if (p >= M - 1) p -= M - 1;
          if (q >= M - 1) q -= M - 1;
        }
        if (p > q) { const unsigned t = p; p = q; q = t; }
        const bool valid = k < np && q < X.count;  // q = count: an odd count's padding
        double al = 0.0, be = 0.0;
        W ga = zero<W>();
        if (valid) {
          al = nrm[p];
          be = nrm[q];
          for (unsigned j = sub; j < X.n; j += L) ga = cdot_add(ga, X.at(p, j), X.at(q, j));
        }
        ga = group_total(ga, L);
        // |gamma| > tol sqrt(alpha beta), squared: a zero vector has gamma =
        // 0 exactly, so it is never rotated
        const double g2 = abs2(ga);
        const bool rot = valid && g2 > fmax(tol2 * al * be, DBL_MIN);
        bool stale = false;
        if (rot) {
          W f;
          const double g = polar(ga, g2, f), d = be - al;
          const double rinv = rsqrt(fma(d, d, 4.0 * g2));  // 1 / sqrt(d^2 + 4 g^2)
          const double h = fma(0.5, fabs(d) * rinv, 0.5);    // cos^2 t = (1 + cos 2t) / 2
          const double ic = rsqrt(h);
          const double s2 = (d >= 0.0 ? g : -g) * rinv;      // sin 2t / 2
          const double cs = h * ic, sn = s2 * ic, tg = s2 * g * ic * ic;  // t |gamma|
          for (unsigned j = sub; j < X.nrot; j += L) rotate(X.at(p, j), X.at(q, j), cs, sn, f);
          if (kV)
            for (unsigned j = sub; j < uc; j += L) rotate(V[p * uc + j], V[q * uc + j], cs, sn, f);
          const double al1 = al - tg, be1 = be + tg;
          stale = al1 < kStale * al || be1 < kStale * be;
          al = al1;
          be = be1;
        }
        if (__any_sync(0xffffffffu, stale)) {  // the whole warp sums, so it stays converged
          double sp = 0.0, sq = 0.0;
          if (stale)
            for (unsigned j = sub; j < X.n; j += L) {
              sp += abs2(X.at(p, j));
              sq += abs2(X.at(q, j));
            }
          sp = group_total(sp, L);
          sq = group_total(sq, L);
          if (stale) {
            al = sp;
            be = sq;
          }
        }
        if (rot && sub == 0) {
          nrm[p] = al;
          nrm[q] = be;
          rotated = 1;
        }
      }
      if (nw == 1) __syncwarp(); else __syncthreads();
    }
    const int more = rotated;
    __syncthreads();  // every thread read the flag before it is reset
    if (!more) break;
  }

  // 3. s_j = |x_j| (the largest s by a block maximum: exact in any order),
  // then y's coefficient b_j / s_j^2 of each kept s_j. Without V (R^T W =
  // X): b_j is the rotated b and y = sum_j conj(x_j) b_j / s_j^2. With V
  // (R V = X): b_j = x_j^H Q^H b and y = V (b_j / s_j^2).
  vec_norms(X, nrm, grp, ngrp, sub, L, true);
  double smax = 0.0;
  __syncthreads();
  for (unsigned j = tid; j < X.count; j += nt) smax = fmax(smax, nrm[j]);
  smax = block_max(smax, red);
  const double cut = Eps<R>::value * (double)(r > c ? r : c) * smax;
  for (unsigned j = tid; j < X.count; j += nt) {
    const double sj = nrm[j];
    const bool kept = sj > 0.0 && sj >= cut;
    if (kV) {
      W cj = zero<W>();
      if (kept) {
        for (unsigned i = 0; i < K; ++i)
          cj = cdot_add(cj, A[i * ar + j * ac], A[i * ar + uc * ac]);
        cj = scaled(cj, 1.0 / (sj * sj));
      }
      coef[j] = cj;
    } else {
      A[j * ar + uc * ac] = kept ? scaled(A[j * ar + uc * ac], 1.0 / (sj * sj)) : zero<W>();
    }
  }
  __syncthreads();
  // undo the scaling (a * sa -> y / sa; b * sb -> y * sb); the singular
  // values descending (rank by counting, ties by index)
  const double back = sa / sb;
  for (unsigned i = tid; i < uc; i += nt) {
    W acc = zero<W>();
    if (kV)
      for (unsigned j = 0; j < uc; ++j) acc = mul_add(acc, V[j * uc + i], coef[j]);
    else
      for (unsigned j = 0; j < K; ++j)
        acc = mul_add(acc, conj_of(A[j * ar + i * ac]), A[j * ar + uc * ac]);
    y_out[i] = narrow_to<T>(scaled(acc, back));
  }
  for (unsigned i = tid; i < X.count; i += nt) {
    const double si = nrm[i];
    unsigned rank = 0;
    for (unsigned j = 0; j < X.count; ++j) rank += nrm[j] > si || (nrm[j] == si && j < i);
    s_out[rank] = (R)(si / sa);
  }
  if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = sweep;
}

// ---- launch ----

// threads per matrix: enough groups of lanes_for(n) lanes for the pairs of
// Jacobi vectors
int threads_for(int r, int c, bool with_v) {
  const int K = r < c ? r : c;
  const int count = with_v ? c : K, n = with_v ? K : c;
  const int pairs = (count + 1) / 2, per_warp = 32 / (int)lanes_for(n);
  const int warps = (pairs + per_warp - 1) / per_warp;
  return 32 * (warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps);
}

size_t bytes_for(int r, int c, int dtype) {
  switch (dtype) {
    case 0: return layout<double>(r, c, false).total;
    case 1: return layout<double>(r, c, true).total;
    case 2: return layout<C2>(r, c, false).total;
    default: return layout<C2>(r, c, true).total;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* y, void* s, void* work, int* sweeps, int r, int c,
           int64_t batch, cudaStream_t stream) {
  const size_t bytes = layout<wide_t<T>>(r, c, keeps_v<T>()).total;
  const bool in_smem = bytes <= kSmemLimit;
  if (!in_smem && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* Y = static_cast<T*>(y);
  real_t<T>* S = static_cast<real_t<T>*>(s);
  unsigned char* ws = static_cast<unsigned char*>(work);
  const unsigned grid = static_cast<unsigned>(batch);
  const int nt = threads_for(r, c, keeps_v<T>());
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

// a (batch, r, c) row-major, b (batch, r) -> y (batch, c), s (batch, c):
// min(r, c) singular values descending (real, of a's precision), the rest
// not written; work: batch times linops_small_lstsq_work's bytes (or null
// when that is 0); sweeps: the sweeps each matrix ran (or null).
int linops_small_lstsq(const void* a, const void* b, void* y, void* s, void* work, void* sweeps,
                       int r, int c, int64_t batch, int dtype, int device, void* stream) {
  if (int err = static_cast<int>(cudaSetDevice(device))) return err;
  if (r <= 0 || c <= 0 || batch <= 0) return 0;
  if (batch > 0x7fffffffLL || (int64_t)r * (c + 1) > 0x7fffffffLL)
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
