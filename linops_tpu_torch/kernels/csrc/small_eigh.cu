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

#include "bsr_common.cuh"  // linops_cuda_error_string, set_dynamic_smem

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

template <typename T> size_t layout_bytes(int m) { return layout<T>(m).total; }

size_t bytes_for(int m, int dtype) {
  switch (dtype) {
    case 0: return layout_bytes<float>(m);
    case 1: return layout_bytes<double>(m);
    case 2: return layout_bytes<Cx<float>>(m);
    case 3: return layout_bytes<Cx<double>>(m);
  }
  return 0;
}

int threads_for(int m) {
  const int64_t items = (int64_t)m * ((m + 1) / 2);
  int64_t t = (items + 31) / 32 * 32;
  if (t < 32) t = 32;
  return (int)(t > kMaxThreads ? kMaxThreads : t);
}

template <typename T>
int launch(const void* a, void* w, void* v, void* work, int* sweeps, int m, int64_t batch,
           cudaStream_t stream) {
  const size_t bytes = layout_bytes<T>(m);
  const bool in_smem = bytes <= kSmemLimit;
  if (!in_smem && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_smem ? bytes : 0;
  if (int rc = set_dynamic_smem(small_eigh_kernel<T>, smem)) return rc;
  small_eigh_kernel<T><<<static_cast<unsigned>(batch), threads_for(m), smem, stream>>>(
      static_cast<const T*>(a), static_cast<real_t<T>*>(w), static_cast<T*>(v),
      static_cast<unsigned char*>(work), sweeps, m, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of global workspace per matrix the kernel needs at size m (0 when
// its buffer fits in shared memory). dtype: 0 f32, 1 f64, 2 c64, 3 c128.
int64_t linops_small_eigh_workspace(int m, int dtype) {
  const size_t bytes = bytes_for(m, dtype);
  return bytes <= kSmemLimit ? 0 : static_cast<int64_t>(bytes);
}

// a (batch, m, m) -> w (batch, m) ascending, v (batch, m, m) with the
// eigenvectors as columns; work: batch * linops_small_eigh_workspace(m) bytes
// (or null when that is 0); sweeps: the sweeps each matrix ran (or null).
int linops_small_eigh(const void* a, void* w, void* v, void* work, void* sweeps, int m,
                      int64_t batch, int dtype, int device, void* stream) {
  if (int err = static_cast<int>(cudaSetDevice(device))) return err;
  if (m <= 0 || batch <= 0) return 0;
  if (batch > 0x7fffffffLL || m > 46340) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sw = static_cast<int*>(sweeps);
  switch (dtype) {
    case 0: return launch<float>(a, w, v, work, sw, m, batch, s);
    case 1: return launch<double>(a, w, v, work, sw, m, batch, s);
    case 2: return launch<Cx<float>>(a, w, v, work, sw, m, batch, s);
    case 3: return launch<Cx<double>>(a, w, v, work, sw, m, batch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
