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
// K13 takes any rowid per tile, not only the runs the pack makes (the TPU
// kernel was a one-hot contraction over each tile's slots), and sums each
// row's slots one after another in slot order, in f32, starting from zero:
// the same bits on every run, with no float atomics, and the same bits
// whichever of the two paths below a segment takes. One warp per (repeat,
// tile), kCombWarps tiles per thread block, with a 128-row running sum per
// warp in shared memory. The warp stages kCombSeg slots at a time in shared
// memory with cp.async 16-byte copies (no registers hold them, so many warps
// fit an SM; plain loads where K % 16 != 0); the main path's K = 640 is one
// segment. Then:
// - runs (what the pack builds: rowid nondecreasing as bytes over the
//   segment, trash -1 = 255 last; a byte-wise compare per lane and a warp
//   vote): each row's slots are one contiguous run. Lanes mark where each
//   row's run starts and ends, and lane l adds the runs of rows l, l + 32,
//   l + 64 and l + 96 (rows 32 apart, so the lanes' reads of the staged q
//   spread over the banks), four loads at a time. A few instructions per
//   slot.
// - any other order: for every 32 slots in order, __match_any_sync groups
//   the lanes holding the same row, and the group's lowest lane adds the
//   group's q, in lane order, to the row's running sum.
// At the end lane l writes rows 4l..4l+3 with one vector store, in q's type.
// Each segment's path is found again for every repeat rather than kept: the
// vote costs a few instructions per 128 slots. What bounds K13: the bytes
// of q (read once) and of the output; the first version (one thread block
// per tile and a 32-step shuffle sweep per 32 slots) was bound by
// instructions at 23 % of that bound.

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
constexpr int kCombSeg = 1024;      // K13: slots a warp stages at once
constexpr int kCombWarps = 4;       // K13: tiles (one per warp) per thread block
constexpr int64_t kMaxBlocks = 1 << 20;

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

// 16 bytes global -> shared without registers; cp_async_wait makes this
// thread's copies complete (a __syncwarp then shows them to the warp).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 4 packed rowid bytes (as unsigned: trash -1 = 255, last in order)
__device__ __forceinline__ unsigned bytes4(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// one warp per (repeat j, tile t) = j*T + t; kCombWarps of them per thread block
template <typename T>
__global__ void __launch_bounds__(kCombWarps * 32)
tiled_combine_kernel(const T* __restrict__ q, const int8_t* __restrict__ rowid,
                     T* __restrict__ out, int64_t tiles, int64_t K, int64_t units, bool vec) {
  __shared__ __align__(16) float acc_s[kCombWarps][kLanes];     // running row sums
  __shared__ __align__(16) T q_s[kCombWarps][kCombSeg];         // the segment's q
  __shared__ __align__(16) int8_t r_s[kCombWarps][kCombSeg];    // the segment's rowid
  __shared__ __align__(16) int16_t run_s[kCombWarps][2][kLanes];  // runs: [start, end) per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t jt = int64_t(blockIdx.x) * kCombWarps + warp;
  if (jt >= units) return;  // whole warps leave; nothing below syncs the block
  const T* qt = q + jt * K;
  const int8_t* rt = rowid + (jt % tiles) * K;
  float* acc = acc_s[warp];
  const T* qs = q_s[warp];
  int8_t* rs = r_s[warp];
  int16_t* start = run_s[warp][0];
  int16_t* end = run_s[warp][1];
  *reinterpret_cast<float4*>(acc + 4 * lane) = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t k0 = 0; k0 < K; k0 += kCombSeg) {
    const int n = K - k0 < kCombSeg ? static_cast<int>(K - k0) : kCombSeg;  // slots here
    const int n128 = (n + kLanes - 1) / kLanes * kLanes;
    __syncwarp();  // the previous segment's reads of the shared rows are done
    if (vec) {  // K % 16 == 0: whole 16-byte pieces of q and of rowid
      constexpr int kQ = 16 / sizeof(T);  // q values per 16 bytes
      for (int i = lane; i < n / kQ; i += 32) cp_async16(&q_s[warp][i * kQ], qt + k0 + i * kQ);
      for (int i = lane; i < n / 16; i += 32) cp_async16(rs + i * 16, rt + k0 + i * 16);
      cp_async_wait();
    } else {
      for (int i = lane; i < n; i += 32) {
        q_s[warp][i] = qt[k0 + i];
        rs[i] = rt[k0 + i];
      }
    }
    for (int i = n + lane; i < n128; i += 32) rs[i] = -1;  // the last piece's tail: trash
    __syncwarp();
    // runs iff every rowid byte is at least the one before it (trash = 255 last)
    bool runs = true;
    for (int p = 0; p < n128 / kLanes; ++p) {
      const int b = p * kLanes + 4 * lane;
      const unsigned w = bytes4(rs + b);
      const unsigned left = b > 0 ? static_cast<uint8_t>(rs[b - 1]) : 0u;
      runs = runs && __vcmpleu4(__byte_perm(w, left, 0x2104), w) == 0xffffffffu;
    }
    if (__all_sync(0xffffffffu, runs)) {
      *reinterpret_cast<uint2*>(start + 4 * lane) = make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(end + 4 * lane) = make_uint2(0u, 0u);
      __syncwarp();
      // the bytes that start or end a run mark it (the segment's ends always do)
      for (int p = 0; p < n128 / kLanes; ++p) {
        const int b = p * kLanes + 4 * lane;
        const unsigned w = bytes4(rs + b);
        const unsigned left = b > 0 ? static_cast<uint8_t>(rs[b - 1]) : 256u;
        const unsigned right = b + 4 < n128 ? static_cast<uint8_t>(rs[b + 4]) : 256u;
        const unsigned first = __vcmpne4(__byte_perm(w, left, 0x2104), w) | (left >> 8);
        const unsigned last = __vcmpne4(__byte_perm(w, right, 0x4321), w) | (right >> 8 << 24);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned row = (w >> (8 * j)) & 0xffu;
          if (row < kLanes && (first >> (8 * j) & 1u)) start[row] = static_cast<int16_t>(b + j);
          if (row < kLanes && (last >> (8 * j) & 1u)) end[row] = static_cast<int16_t>(b + j + 1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows 32 apart: their runs fall in other banks
        const int row = lane + 32 * i;
        float a = acc[row];
        int k = start[row];
        const int e = end[row];
        for (; k + 4 <= e; k += 4) {  // four loads at once, added in slot order
          const float b0 = widen(qs[k]), b1 = widen(qs[k + 1]);
          const float b2 = widen(qs[k + 2]), b3 = widen(qs[k + 3]);
          a = (((a + b0) + b1) + b2) + b3;
        }
        for (; k < e; ++k) a += widen(qs[k]);
        acc[row] = a;
      }
    } else {
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int rrow = rs[c0 + lane];  // -1 past K
        const unsigned group = __match_any_sync(0xffffffffu, rrow);
        if (rrow >= 0 && lane == __ffs(group) - 1) {
          float a = acc[rrow];
          for (unsigned g = group; g; g &= g - 1) a += widen(qs[c0 + __ffs(g) - 1]);
          acc[rrow] = a;
        }
        __syncwarp();  // the next 32 slots' groups may add to the same row
      }
    }
  }
  __syncwarp();
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = acc[4 * lane + i];
  store4(out + jt * kLanes + 4 * lane, o);
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
  const int64_t units = rep * tiles;
  const int64_t blocks = (units + kCombWarps - 1) / kCombWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rowid) % 16 == 0;
    tiled_combine_kernel<T><<<static_cast<unsigned>(blocks), kCombWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(rowid), static_cast<T*>(out), tiles,
        K, units, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
