// Lane-gather kernels for Hopper (sm_90a): the crossbars, phase-1 products and
// row combines of the Clos-routed unstructured SpMV (sparse/routed.py).
//
// Every kernel works on rows of 128 lanes. Index, value and boundary arrays are
// shared by all repeats of the data ("rep-outer" layout): a repeated operand is
// (rep*R0, 128) and a shared one (R0, 128), so output row i reads shared row
// i mod R0. Index arrays are int8 in [0, 128) (gathers; read modulo 128, so a
// bad index cannot leave the row) and -1 means "no term" in the segment
// boundaries lo/hi.
//
// K7  linops_lane_gather replaces linops_tpu/kernels/lane_gather.py::lane_gather:
//       out[i, l] = a[i, idx[i mod R0, l]]
// K8  linops_lane_gather_mul replaces lane_gather.py::lane_gather_mul:
//       out[i, l] = vals[i mod R0, l] * a[i, idx[i mod R0, l]]
// K9  linops_lane_gather_mul_t replaces lane_gather.py::lane_gather_mul_t_batched:
//       K8 per chunk with a transposed output; repeat j, chunk c, window row i,
//       lane l lands at out[(j*C + c)*128 + l, i] of a (rep*C*128, m) array
// K10 linops_lane_gather_sum replaces lane_gather.py::lane_gather_sum:
//       K7, then the sum of each w consecutive lanes: (rows, 128) -> (rows, 128/w)
// K11 linops_lane_segsum replaces lane_gather.py::lane_segsum:
//       S[i, c] = cs[i, hi[c]] - cs[i, lo[c]], cs the inclusive lane prefix of q
//       (terms at -1 read as 0)
// K12 linops_lane_gather_mul_segsum replaces lane_gather.py::lane_gather_mul_segsum:
//       K8, then K11 on the products
// K13 linops_tiled_combine replaces lane_gather.py::tiled_combine:
//       y[j, t*128 + i] = sum over k of q[j, t*K + k] * [rowid[t, k] == i] for T
//       tiles of 128 rows, K slots each (rowid -1 = trash), repeat j of rep
// K14 lane_gather.py::lane_gather_mul_t (K9 for one chunk, one repeat) has no
//       entry point of its own: its wrapper launches linops_lane_gather_mul_t
//       with C = 1 and rep = 1, as the TPU kernel ran K9's kernel body
//
// What bounds them: all seven move each input byte once and do one or two flops
// per element, so each is bound by device-memory bytes: (bytes read once +
// bytes written) / 3.35 TB/s. A row of 128 f32 values is 512 bytes, of int8
// indices 128 bytes; the shared arrays are read once per repeat (they stay in
// L2 across repeats only when they fit).
//
// What the design does about it: one warp per row, each lane owning four
// consecutive lanes, so every row is read and written with 16-byte (f32) or
// 8-byte (bf16) vector accesses, fully coalesced, and the indices as one
// 4-byte char4 per lane. The gather within the row goes through a 512-byte
// staging row in shared memory (per warp; no block-wide barrier). K9 writes
// its transposed output through a padded 128x33 shared tile so that each warp
// stores 32 consecutive window rows of one lane. K10 sums lane groups with
// warp shuffles; K11/K12 form the prefix with a warp scan. Products are taken
// in f32 and rounded once to the output type (a bf16*bf16 product is exact in
// f32); sums accumulate in f32 and round once. K8, K9 and K12 read the shared
// values in their own type (f32 or bf16) beside data of either type, and write
// the promoted type (f32 unless both are bf16), so a bf16 program applied to f32
// data is never converted on the host.
//
// K13 takes any rowid per tile, not only the contiguous runs the pack makes
// (the TPU kernel was a one-hot contraction over each tile's slots). One
// thread block per (repeat, tile) walks the tile's K slots in order, 256 at a
// time, one slot per thread, with coalesced loads of q and rowid. Inside a
// warp, __match_any_sync groups the lanes of one row and every lane of a
// group sums the group's values in lane order (shuffles); the group's lowest
// lane adds the sum into its warp's 128-row partial in shared memory. At the
// end thread i sums the eight warps' partials of row i in warp order and
// writes row i once. So the result is the same bits on every run: no float
// atomics, and every sum is taken in a fixed order. Sums are in f32; the
// output is q's type.
//
// The TPU kernels required R0 to be a multiple of 128 rows (their VMEM tile,
// lane_gather.py::_tile_rows). These take any R0 and any row count: a thread
// block walks rows in a grid-stride loop and K9 masks the ragged window tile.
// So on CUDA every f32/bf16 call with 128 lanes takes a kernel.
//
// Each entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() of its launch (0 on success).

#include "bsr_common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;           // rows in flight per thread block (one per warp)
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 32;       // K9: window rows per transposed tile
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ char4 load_idx(const int8_t* p) {
  return __ldg(reinterpret_cast<const char4*>(p));
}

// Stage this lane's four values into the warp's row, then read the four
// gathered lanes (out[k] = row[idx[k]]). The caller's next write to `row`
// must come after a __syncwarp().
__device__ __forceinline__ void gather_row(float* row, const float v[4], char4 ix, float g[4],
                                           int lane) {
  *reinterpret_cast<float4*>(row + 4 * lane) = make_float4(v[0], v[1], v[2], v[3]);
  __syncwarp();
  g[0] = row[ix.x & 127];
  g[1] = row[ix.y & 127];
  g[2] = row[ix.z & 127];
  g[3] = row[ix.w & 127];
}

// In-place: z (this lane's four values of the row) -> S[c] = cs[hi[c]] - cs[lo[c]]
// for this lane's four output lanes, cs the inclusive prefix of the row.
__device__ __forceinline__ void segsum_row(float* row, float z[4], char4 lo, char4 hi,
                                           int lane) {
  float c[4];
  c[0] = z[0];
  c[1] = c[0] + z[1];
  c[2] = c[1] + z[2];
  c[3] = c[2] + z[3];
  float t = c[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, t, off);
    if (lane >= off) t += n;
  }
  const float excl = t - c[3];
  __syncwarp();  // earlier reads of `row` by this warp are done
  *reinterpret_cast<float4*>(row + 4 * lane) =
      make_float4(c[0] + excl, c[1] + excl, c[2] + excl, c[3] + excl);
  __syncwarp();
  const signed char h[4] = {hi.x, hi.y, hi.z, hi.w};
  const signed char l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    z[k] = (h[k] >= 0 ? row[h[k] & 127] : 0.f) - (l[k] >= 0 ? row[l[k] & 127] : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ a, const int8_t* __restrict__ idx, T* __restrict__ out,
              int64_t rows, int64_t r0) {
  __shared__ __align__(16) float stage[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = int64_t(blockIdx.x) * kWarps + warp; i < rows; i += int64_t(gridDim.x) * kWarps) {
    float v[4], g[4];
    load4(a + i * kLanes + 4 * lane, v);
    gather_row(stage[warp], v, load_idx(idx + (i % r0) * kLanes + 4 * lane), g, lane);
    store4(out + i * kLanes + 4 * lane, g);
    __syncwarp();
  }
}

template <typename TA, typename TV, typename TO>
__global__ void __launch_bounds__(kThreads)
gather_mul_kernel(const TA* __restrict__ a, const int8_t* __restrict__ idx,
                  const TV* __restrict__ vals, TO* __restrict__ out, int64_t rows, int64_t r0) {
  __shared__ __align__(16) float stage[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = int64_t(blockIdx.x) * kWarps + warp; i < rows; i += int64_t(gridDim.x) * kWarps) {
    const int64_t s = (i % r0) * kLanes + 4 * lane;
    float v[4], g[4], w[4];
    load4(a + i * kLanes + 4 * lane, v);
    load4(vals + s, w);
    gather_row(stage[warp], v, load_idx(idx + s), g, lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] *= w[k];
    store4(out + i * kLanes + 4 * lane, g);
    __syncwarp();
  }
}

// grid (ceil(m / kTileRows), rep*C): block (x, y) takes window rows
// [x*kTileRows, ...) of repeat/chunk y = j*C + c.
template <typename TA, typename TV, typename TO>
__global__ void __launch_bounds__(kThreads)
gather_mul_t_kernel(const TA* __restrict__ a, const int8_t* __restrict__ idx,
                    const TV* __restrict__ vals, TO* __restrict__ out, int64_t C, int64_t m) {
  __shared__ __align__(16) float stage[kWarps][kLanes];
  __shared__ float tile[kLanes][kTileRows + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t jc = blockIdx.y;
  const int64_t c = jc % C;
  const int64_t i0 = int64_t(blockIdx.x) * kTileRows;
  for (int r = warp; r < kTileRows; r += kWarps) {
    const int64_t i = i0 + r;
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < m) {  // uniform across the warp
      const int64_t s = (c * m + i) * kLanes + 4 * lane;
      float v[4], w[4];
      load4(a + (jc * m + i) * kLanes + 4 * lane, v);
      load4(vals + s, w);
      gather_row(stage[warp], v, load_idx(idx + s), g, lane);
#pragma unroll
      for (int k = 0; k < 4; ++k) g[k] *= w[k];
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) tile[4 * lane + k][r] = g[k];
  }
  __syncthreads();
  const int64_t i = i0 + lane;
  if (i < m) {
    TO* base = out + jc * kLanes * m + i;
    for (int l = warp; l < kLanes; l += kWarps) base[int64_t(l) * m] = narrow<TO>(tile[l][lane]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const T* __restrict__ a, const int8_t* __restrict__ idx, T* __restrict__ out,
                  int64_t rows, int64_t r0, int w) {
  __shared__ __align__(16) float stage[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = kLanes / w;  // output lanes per row
  for (int64_t i = int64_t(blockIdx.x) * kWarps + warp; i < rows; i += int64_t(gridDim.x) * kWarps) {
    float v[4], g[4];
    load4(a + i * kLanes + 4 * lane, v);
    gather_row(stage[warp], v, load_idx(idx + (i % r0) * kLanes + 4 * lane), g, lane);
    T* o = out + i * width;
    if (w == 1) {
      store4(o + 4 * lane, g);
    } else if (w == 2) {
      store2(o + 2 * lane, g[0] + g[1], g[2] + g[3]);
    } else {
      float s = ((g[0] + g[1]) + g[2]) + g[3];
      const int group = w >> 2;  // lanes (threads) per output value
      for (int off = 1; off < group; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane % group == 0) o[lane / group] = narrow<T>(s);
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const T* __restrict__ q, const int8_t* __restrict__ lo,
              const int8_t* __restrict__ hi, T* __restrict__ out, int64_t rows, int64_t r0) {
  __shared__ __align__(16) float stage[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = int64_t(blockIdx.x) * kWarps + warp; i < rows; i += int64_t(gridDim.x) * kWarps) {
    const int64_t s = (i % r0) * kLanes + 4 * lane;
    float z[4];
    load4(q + i * kLanes + 4 * lane, z);
    segsum_row(stage[warp], z, load_idx(lo + s), load_idx(hi + s), lane);
    store4(out + i * kLanes + 4 * lane, z);
    __syncwarp();
  }
}

template <typename TA, typename TV, typename TO>
__global__ void __launch_bounds__(kThreads)
gather_mul_segsum_kernel(const TA* __restrict__ a, const int8_t* __restrict__ idx,
                         const TV* __restrict__ vals, const int8_t* __restrict__ lo,
                         const int8_t* __restrict__ hi, TO* __restrict__ out, int64_t rows,
                         int64_t r0) {
  __shared__ __align__(16) float stage[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = int64_t(blockIdx.x) * kWarps + warp; i < rows; i += int64_t(gridDim.x) * kWarps) {
    const int64_t s = (i % r0) * kLanes + 4 * lane;
    float v[4], g[4], w[4];
    load4(a + i * kLanes + 4 * lane, v);
    load4(vals + s, w);
    gather_row(stage[warp], v, load_idx(idx + s), g, lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] *= w[k];  // kept in f32 into the prefix
    segsum_row(stage[warp], g, load_idx(lo + s), load_idx(hi + s), lane);
    store4(out + i * kLanes + 4 * lane, g);
    __syncwarp();
  }
}

// one block per (repeat j, tile t): blockIdx.x = j*T + t
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_combine_kernel(const T* __restrict__ q, const int8_t* __restrict__ rowid,
                     T* __restrict__ out, int64_t tiles, int64_t K) {
  __shared__ float part[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t jt = blockIdx.x;
  const int64_t t = jt % tiles;
  for (int i = threadIdx.x; i < kWarps * kLanes; i += kThreads) (&part[0][0])[i] = 0.f;
  __syncthreads();
  const T* qt = q + jt * K;
  const int8_t* rt = rowid + t * K;
  for (int64_t k0 = 0; k0 < K; k0 += kThreads) {
    const int64_t k = k0 + threadIdx.x;
    int r = -1;
    float v = 0.f;
    if (k < K) {
      r = rt[k];
      v = widen(qt[k]);
    }
    const unsigned group = __match_any_sync(0xffffffffu, r);
    float s = 0.f;
#pragma unroll
    for (int src = 0; src < 32; ++src) {  // lane order: the same sum on every lane of a group
      const float u = __shfl_sync(0xffffffffu, v, src);
      if (group >> src & 1u) s += u;
    }
    if (r >= 0 && lane == __ffs(group) - 1) part[warp][r & 127] += s;
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x < kLanes) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += part[w][threadIdx.x];
    out[jt * kLanes + threadIdx.x] = narrow<T>(acc);
  }
}

unsigned row_blocks(int64_t rows) {
  const int64_t b = (rows + kWarps - 1) / kWarps;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

// f(Tag<T>{}) for dtype code 0 (float32) or 1 (bfloat16); cudaErrorInvalidValue otherwise
template <typename F>
int dispatch_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(Tag<float>{});
  if (dtype == 1) return f(Tag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(Tag<TA>{}, Tag<TV>{}, Tag<TO>{}) for data code a and value code v (0 float32,
// 1 bfloat16), TO the promoted type; cudaErrorInvalidValue otherwise
template <typename F>
int dispatch_mixed(int a, int v, F&& f) {
  using bf16 = __nv_bfloat16;
  if (a == 0 && v == 0) return f(Tag<float>{}, Tag<float>{}, Tag<float>{});
  if (a == 0 && v == 1) return f(Tag<float>{}, Tag<bf16>{}, Tag<float>{});
  if (a == 1 && v == 0) return f(Tag<bf16>{}, Tag<float>{}, Tag<float>{});
  if (a == 1 && v == 1) return f(Tag<bf16>{}, Tag<bf16>{}, Tag<bf16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

int begin(int device) { return static_cast<int>(cudaSetDevice(device)); }

}  // namespace

extern "C" {

int linops_lane_gather(const void* a, const void* idx, void* out, int64_t rows, int64_t r0,
                       int dtype, int device, void* stream) {
  if (int err = begin(device)) return err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    gather_kernel<T><<<row_blocks(rows), kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const int8_t*>(idx), static_cast<T*>(out), rows, r0);
    return static_cast<int>(cudaGetLastError());
  });
}

// K8, K9 and K12 take the value type (vals_dtype) apart from the data type
// (dtype); out is in the promoted type.
int linops_lane_gather_mul(const void* a, const void* idx, const void* vals, void* out,
                           int64_t rows, int64_t r0, int vals_dtype, int dtype, int device,
                           void* stream) {
  if (int err = begin(device)) return err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_mixed(dtype, vals_dtype, [&](auto ta, auto tv, auto to) {
    using TA = typename decltype(ta)::type;
    using TV = typename decltype(tv)::type;
    using TO = typename decltype(to)::type;
    gather_mul_kernel<TA, TV, TO><<<row_blocks(rows), kThreads, 0, s>>>(
        static_cast<const TA*>(a), static_cast<const int8_t*>(idx), static_cast<const TV*>(vals),
        static_cast<TO*>(out), rows, r0);
    return static_cast<int>(cudaGetLastError());
  });
}

int linops_lane_gather_mul_t(const void* a, const void* idx, const void* vals, void* out,
                             int64_t C, int64_t m, int64_t rep, int vals_dtype, int dtype,
                             int device, void* stream) {
  if (int err = begin(device)) return err;
  if (C <= 0 || m <= 0 || rep <= 0) return 0;
  const int64_t tiles = (m + kTileRows - 1) / kTileRows;
  if (rep * C > 65535 || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rep * C));
  return dispatch_mixed(dtype, vals_dtype, [&](auto ta, auto tv, auto to) {
    using TA = typename decltype(ta)::type;
    using TV = typename decltype(tv)::type;
    using TO = typename decltype(to)::type;
    gather_mul_t_kernel<TA, TV, TO><<<grid, kThreads, 0, s>>>(
        static_cast<const TA*>(a), static_cast<const int8_t*>(idx), static_cast<const TV*>(vals),
        static_cast<TO*>(out), C, m);
    return static_cast<int>(cudaGetLastError());
  });
}

int linops_lane_gather_sum(const void* a, const void* idx, void* out, int64_t rows, int64_t r0,
                           int w, int dtype, int device, void* stream) {
  if (int err = begin(device)) return err;
  if (w <= 0 || w > kLanes || (w & (w - 1))) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    gather_sum_kernel<T><<<row_blocks(rows), kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const int8_t*>(idx), static_cast<T*>(out), rows, r0,
        w);
    return static_cast<int>(cudaGetLastError());
  });
}

int linops_lane_segsum(const void* q, const void* lo, const void* hi, void* out, int64_t rows,
                       int64_t r0, int dtype, int device, void* stream) {
  if (int err = begin(device)) return err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    segsum_kernel<T><<<row_blocks(rows), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(lo), static_cast<const int8_t*>(hi),
        static_cast<T*>(out), rows, r0);
    return static_cast<int>(cudaGetLastError());
  });
}

int linops_lane_gather_mul_segsum(const void* a, const void* idx, const void* vals,
                                  const void* lo, const void* hi, void* out, int64_t rows,
                                  int64_t r0, int vals_dtype, int dtype, int device,
                                  void* stream) {
  if (int err = begin(device)) return err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_mixed(dtype, vals_dtype, [&](auto ta, auto tv, auto to) {
    using TA = typename decltype(ta)::type;
    using TV = typename decltype(tv)::type;
    using TO = typename decltype(to)::type;
    gather_mul_segsum_kernel<TA, TV, TO><<<row_blocks(rows), kThreads, 0, s>>>(
        static_cast<const TA*>(a), static_cast<const int8_t*>(idx), static_cast<const TV*>(vals),
        static_cast<const int8_t*>(lo), static_cast<const int8_t*>(hi), static_cast<TO*>(out),
        rows, r0);
    return static_cast<int>(cudaGetLastError());
  });
}

// K13: q (rep*T*K) in dtype, rowid (T, K) int8, out (rep*T*128) in dtype.
int linops_tiled_combine(const void* q, const void* rowid, void* out, int64_t tiles, int64_t K,
                         int64_t rep, int dtype, int device, void* stream) {
  if (int err = begin(device)) return err;
  if (tiles <= 0 || rep <= 0) return 0;
  if (rep * tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    tiled_combine_kernel<T><<<static_cast<unsigned>(rep * tiles), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(rowid), static_cast<T*>(out), tiles,
        K);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
