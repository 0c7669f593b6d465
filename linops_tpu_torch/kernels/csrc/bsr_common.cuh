// Helpers shared by the kernel sources (bsr_spmv.cu, bsr_window.cu, lane_gather.cu,
// small_eigh.cu, small_lstsq.cu).
//
// - widen/narrow: f32 accumulation for f32 and bf16 values; bf16 is widened
//   per element and the result narrowed once at the store.
// - load4/store4: four consecutive values as one 16-byte (f32) or 8-byte
//   (bf16) access, widened to / narrowed from f32; the address must be
//   aligned to the access.
// - dispatch_dtypes: the (block, vector) dtype pairs every entry point takes,
//   as codes shared with the Python wrappers (0 = float32, 1 = bfloat16):
//   (0, 0), (1, 0), (1, 1). The vector type is also the output type.
// - set_dynamic_smem: lifts a kernel's dynamic shared-memory cap above the
//   48 KB default when a launch needs more.
// - column_chunk_pass / column_combine_pass / launch_column_plan: the two
//   passes of a transpose over a column plan, which K2 (bsr_spmv.cu) and K6
//   (bsr_window.cu) launch under kernels of their own names.
// - linops_cuda_error_string: the message of a CUDA error code, for the
//   wrappers' exceptions.
//
// The build (kernels/build.py) hashes this header together with every source
// that includes it, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T> struct Tag { using type = T; };

// f(Tag<TB>{}, Tag<TX>{}) for a supported pair; cudaErrorInvalidValue otherwise
template <typename F>
int dispatch_dtypes(int block_dtype, int vec_dtype, F&& f) {
  if (block_dtype == 0 && vec_dtype == 0) return f(Tag<float>{}, Tag<float>{});
  if (block_dtype == 1 && vec_dtype == 0) return f(Tag<__nv_bfloat16>{}, Tag<float>{});
  if (block_dtype == 1 && vec_dtype == 1) return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename K>
int set_dynamic_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}


// ---- a column plan's transpose (K2, K6) ----
//
// out[c, n] = sum over the slots a column plan lists for block column c
// (bsr_spmv.py::BSRColumnPlan: the slots sorted by column, cut into chunks
// of about 64 KB of blocks) of sum_m blocks[slot, m, n] * u[slot / kmax, m];
// design notes in bsr_spmv.cu (K2). K6 (bsr_window.cu) runs the same passes
// on a plan of the slots its windows cover.

constexpr int kT2Warps = 8;  // K2: warps per thread block, each a slice of m
constexpr int kT2Tile = 128; // K2: n values per thread block (4 per lane)
constexpr int kStage = 64;   // K2: chunk slots whose offsets are staged at a time
constexpr int kUnroll = 8;   // K2: block rows (or partial rows) a warp loads at once

// Four values n0..n0+3 of a row (zeros past bn): one vector load when
// `vec` (bn % 4 == 0 and an aligned base), else four scalar loads.
template <typename T>
__device__ __forceinline__ void load_n4(const T* __restrict__ row, int n0, int bn, bool vec,
                                        float v[4]) {
  if (vec) {
    if (n0 < bn) {
      load4(row + n0, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = n0 + q < bn ? widen(row[n0 + q]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_n4(T* __restrict__ row, int n0, int bn, bool vec,
                                         const float v[4]) {
  if (vec) {
    if (n0 < bn) store4(row + n0, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (n0 + q < bn) row[n0 + q] = narrow<T>(v[q]);
}

// The warps' four sums per lane, added in warp order by warp 0 (into v).
// Every thread of the block must call it.
__device__ __forceinline__ bool sum_warps(float (*red)[kT2Tile], float v[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  *reinterpret_cast<float4*>(&red[warp][4 * lane]) = make_float4(v[0], v[1], v[2], v[3]);
  __syncthreads();
  if (warp != 0) return false;
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = red[0][4 * lane + q];
  for (int w = 1; w < kT2Warps; ++w) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] += red[w][4 * lane + q];
  }
  return true;
}

// Pass 1 of a column plan's transpose: blockIdx.x = chunk, blockIdx.y = n
// tile. A warp's block rows are (staged slot i, m = warp + j * kT2Warps); it
// loads US slots x UM of its m values (kUnroll rows) at once: kUnroll slots
// when it has one m (bm <= kT2Warps), else kUnroll m values of one slot (a
// chunk of 128x128 f32 blocks is one slot). The kernel that calls it caps
// registers so that four thread blocks (32 warps) fit an SM.
template <typename TB, typename TX, int US, int UM>
__device__ __forceinline__ void
column_chunk_pass(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ chunk_ptr, const int32_t* __restrict__ chunk_col,
                  const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                  float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm, int bn,
                  bool vec) {
  static_assert(US * UM == kUnroll, "a warp loads kUnroll block rows at once");
  __shared__ int64_t slot_s[kStage];  // element offset of each staged slot's block
  __shared__ int64_t urow_s[kStage];  // offset of its block row in u
  __shared__ __align__(16) float red[kT2Warps][kT2Tile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ch = blockIdx.x;
  const int n0 = blockIdx.y * kT2Tile + 4 * lane;
  const int s0 = chunk_ptr[ch], s1 = chunk_ptr[ch + 1];
  const int64_t bsize = static_cast<int64_t>(bm) * bn;
  const int mw = warp < bm ? (bm - warp + kT2Warps - 1) / kT2Warps : 0;  // this warp's m values
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = s0; b0 < s1; b0 += kStage) {
    const int nb = min(kStage, s1 - b0);
    __syncthreads();  // the previous stage's reads are done
    if (threadIdx.x < nb) {
      const int64_t slot = perm[b0 + threadIdx.x];
      slot_s[threadIdx.x] = slot * bsize;
      urow_s[threadIdx.x] = (slot / kmax) * bm;
    }
    __syncthreads();
    for (int i0 = 0; i0 < nb; i0 += US) {
      for (int j0 = 0; j0 < mw; j0 += UM) {
        float v[US][UM][4], um[US][UM];
#pragma unroll
        for (int a = 0; a < US; ++a) {
#pragma unroll
          for (int b = 0; b < UM; ++b) {
            if (i0 + a < nb && j0 + b < mw) {
              const int m = warp + (j0 + b) * kT2Warps;
              load_n4(blocks + slot_s[i0 + a] + static_cast<int64_t>(m) * bn, n0, bn, vec,
                      v[a][b]);
              um[a][b] = widen(u[urow_s[i0 + a] + m]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < US; ++a) {
#pragma unroll
          for (int b = 0; b < UM; ++b) {
            if (i0 + a < nb && j0 + b < mw) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[q] = fmaf(v[a][b][q], um[a][b], acc[q]);
            }
          }
        }
      }
    }
  }
  if (!sum_warps(red, acc)) return;
  const int64_t c = chunk_col[ch];
  if (col_chunk[c + 1] - col_chunk[c] == 1)
    store_n4(out + c * bn, n0, bn, vec, acc);
  else
    store_n4(partial + ch * bn, n0, bn, vec, acc);
}

// Pass 2: blockIdx.x = a column with no chunk or several, blockIdx.y = n tile.
template <typename TX>
__device__ __forceinline__ void
column_combine_pass(const float* __restrict__ partial, const int32_t* __restrict__ cols,
                    const int32_t* __restrict__ col_chunk, TX* __restrict__ out, int bn,
                    bool vec) {
  __shared__ __align__(16) float red[kT2Warps][kT2Tile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = cols[blockIdx.x];
  const int n0 = blockIdx.y * kT2Tile + 4 * lane;
  const int k1 = col_chunk[c + 1];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = col_chunk[c] + warp; k < k1; k += kT2Warps * kUnroll) {
    float v[kUnroll][4];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      if (k + i * kT2Warps < k1)
        load_n4(partial + static_cast<int64_t>(k + i * kT2Warps) * bn, n0, bn, vec, v[i]);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (k + i * kT2Warps < k1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += v[i][q];
      }
    }
  }
  if (sum_warps(red, acc)) store_n4(out + c * bn, n0, bn, vec, acc);
}

// The two kernels of a column plan's transpose, each a thin __global__ around
// the passes above, so that K2 and K6 launch under their own names.
template <typename TB, typename TX>
using ChunkKernel = void (*)(const TB*, const int32_t*, const int32_t*, const int32_t*,
                             const int32_t*, const TX*, float*, TX*, int, int, int, bool);
template <typename TX>
using CombineKernel = void (*)(const float*, const int32_t*, const int32_t*, TX*, int, bool);

// Launches a column plan's two passes: `by_slot` (kUnroll slots at once) when
// bm <= kT2Warps, else `by_m` (kUnroll m values of one slot); `combine` for
// the columns with no chunk or several.
template <typename TB, typename TX>
int launch_column_plan(ChunkKernel<TB, TX> by_slot, ChunkKernel<TB, TX> by_m,
                       CombineKernel<TX> combine, const void* blocks, const void* perm,
                       const void* chunk_ptr, const void* chunk_col, const void* col_chunk,
                       const void* combine_cols, const void* u, float* partial, void* out,
                       int64_t nchunks, int64_t ncombine, int kmax, int bm, int bn,
                       cudaStream_t stream) {
  if (nchunks > 0x7fffffffLL || ncombine > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned tiles = static_cast<unsigned>((bn + kT2Tile - 1) / kT2Tile);
  const bool vec = bn % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % (4 * sizeof(TB)) == 0;
  if (nchunks > 0) {
    const dim3 grid(static_cast<unsigned>(nchunks), tiles);
    auto kernel = bm <= kT2Warps ? by_slot : by_m;
    kernel<<<grid, kT2Warps * 32, 0, stream>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(chunk_ptr), static_cast<const int32_t*>(chunk_col),
        static_cast<const int32_t*>(col_chunk), static_cast<const TX*>(u), partial,
        static_cast<TX*>(out), kmax, bm, bn, vec);
    if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  }
  if (ncombine > 0) {
    combine<<<dim3(static_cast<unsigned>(ncombine), tiles), kT2Warps * 32, 0, stream>>>(
        partial, static_cast<const int32_t*>(combine_cols),
        static_cast<const int32_t*>(col_chunk), static_cast<TX*>(out), bn, bn % 4 == 0);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}


// ---- a column plan's transpose over a panel of columns (K2p, K6p) ----
//
// out[c bn + n, j] = the sum above for every column j < k of u: the block
// apply of a transpose. u and out are addressed through (row, column)
// strides (PanelIO), so a column panel (n, k) and the transposed view of a
// row panel (k, n) both run without a copy. blockIdx.z picks a tile of
// kPanel columns, and each lane keeps kPanel x 4 accumulators (its four n
// values for every column of the tile): a stored block is read once per
// tile, so once for k <= kPanel, where k vector applies read it k times.
//
// What the panel adds to K2's loop is u: every lane needs the same kPanel
// values of each loaded block row. The warp loads them together with the
// block rows, kUnroll rows x kPanel columns spread over its lanes (two
// values a lane), and hands each to the lanes by a shuffle; so no u load
// waits in the multiply-adds, whatever u's strides. The warps' sums are
// added by all warps at once, warp j taking column j of the tile (K2's
// combine of four values would be kPanel times longer here), and the
// partial rows are f32 (nchunks, k, bn), so that a warp writes and reads a
// column's row in 16-byte pieces.
//
// Column j's multiply-adds are those of the vector pass for column j, in
// its order (the same slots, m values and unrolled groups), its warps are
// added in warp order and its partial rows in the combine's order: column
// j is bit for bit K2 (K6) applied to column j of u.
//
// kPanel = 8: the chunk pass holds 32 accumulators beside the 32 block
// values of its kUnroll loaded rows, about 98 registers; its kernels cap
// them at 85 (three 256-thread blocks an SM, where the vector pass fits
// four): a few spill, and the pass ran 10 % faster on the H100 than with two
// blocks an SM, the same bits. Its block loads wait in registers, so the
// blocks an SM set the bytes in flight.

constexpr int kPanel = 8;  // K2p, K4p, K6p: columns per tile
static_assert(kPanel <= kT2Warps, "warp j adds column j of a tile");
static_assert(kUnroll * kPanel == 64, "a lane holds two of a warp's u values");

struct PanelIO {  // u[row, j] = u[row * u_rs + j * u_cs]; out likewise; k columns
  int64_t u_rs, u_cs, o_rs, o_cs;
  int k;
};

// The warps' kPanel x 4 sums per lane written to shared memory; then warp j
// (j < kw) adds column j over the warps in warp order, into v. Every thread
// of the block must call it.
__device__ __forceinline__ bool sum_warps_panel(float (*red)[kPanel][kT2Tile],
                                                const float acc[kPanel][4], int kw,
                                                float v[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
    if (j < kw)
      *reinterpret_cast<float4*>(&red[warp][j][4 * lane]) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  if (warp >= kw) return false;
  float4 t = *reinterpret_cast<const float4*>(&red[0][warp][4 * lane]);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  for (int w = 1; w < kT2Warps; ++w) {
    t = *reinterpret_cast<const float4*>(&red[w][warp][4 * lane]);
    v[0] += t.x; v[1] += t.y; v[2] += t.z; v[3] += t.w;
  }
  return true;
}

// Column j of a tile, a lane's four rows (row0 + n0 + q) of out.
template <typename TX>
__device__ __forceinline__ void store_column(TX* __restrict__ out, int64_t row0, int n0, int bn,
                                             int64_t rs, const float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (n0 + q < bn) out[(row0 + n0 + q) * rs] = narrow<TX>(v[q]);
}

// Pass 1 of a column plan's panel transpose: blockIdx.x = chunk, blockIdx.y
// = n tile, blockIdx.z = column tile. column_chunk_pass's loads and order;
// each loaded block row is multiplied into every column of the tile.
template <typename TB, typename TX, int US, int UM>
__device__ __forceinline__ void
panel_chunk_pass(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ chunk_ptr, const int32_t* __restrict__ chunk_col,
                 const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                 float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm, int bn,
                 bool vec, PanelIO io) {
  static_assert(US * UM == kUnroll, "a warp loads kUnroll block rows at once");
  __shared__ int64_t slot_s[kStage];  // element offset of each staged slot's block
  __shared__ int64_t urow_s[kStage];  // its block row's first row of u
  __shared__ __align__(16) float red[kT2Warps][kPanel][kT2Tile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ch = blockIdx.x;
  const int n0 = blockIdx.y * kT2Tile + 4 * lane;
  const int j0 = blockIdx.z * kPanel;
  const int kw = min(kPanel, io.k - j0);
  // this lane's two u values of a loaded group: row r = lane / 4 of the
  // kUnroll rows (slot a = r / UM, m step b = r % UM), columns 2 (lane % 4) + {0, 1}
  const int ur = lane >> 2, ua = ur / UM, ub = ur % UM, uc = 2 * (lane & 3);
  const TX* uj = u + (j0 + uc) * io.u_cs;
  const int64_t bsize = static_cast<int64_t>(bm) * bn;
  const int s0 = chunk_ptr[ch], s1 = chunk_ptr[ch + 1];
  const int mw = warp < bm ? (bm - warp + kT2Warps - 1) / kT2Warps : 0;  // this warp's m values
  float acc[kPanel][4];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int b0 = s0; b0 < s1; b0 += kStage) {
    const int nb = min(kStage, s1 - b0);
    __syncthreads();  // the previous stage's reads are done
    if (threadIdx.x < nb) {
      const int64_t slot = perm[b0 + threadIdx.x];
      slot_s[threadIdx.x] = slot * bsize;
      urow_s[threadIdx.x] = (slot / kmax) * bm;
    }
    __syncthreads();
    for (int i0 = 0; i0 < nb; i0 += US) {
      for (int jm = 0; jm < mw; jm += UM) {
        float v[US][UM][4];
#pragma unroll
        for (int a = 0; a < US; ++a) {
#pragma unroll
          for (int b = 0; b < UM; ++b) {
            if (i0 + a < nb && jm + b < mw) {
              const int m = warp + (jm + b) * kT2Warps;
              load_n4(blocks + slot_s[i0 + a] + static_cast<int64_t>(m) * bn, n0, bn, vec,
                      v[a][b]);
            }
          }
        }
        float u0 = 0.f, u1 = 0.f;
        if (i0 + ua < nb && jm + ub < mw) {
          const TX* row = uj + (urow_s[i0 + ua] + warp + (jm + ub) * kT2Warps) * io.u_rs;
          if (uc < kw) u0 = widen(row[0]);
          if (uc + 1 < kw) u1 = widen(row[io.u_cs]);
        }
#pragma unroll
        for (int a = 0; a < US; ++a) {
#pragma unroll
          for (int b = 0; b < UM; ++b) {
            if (i0 + a < nb && jm + b < mw) {  // the same for the whole warp
#pragma unroll
              for (int j = 0; j < kPanel; ++j) {
                if (j < kw) {
                  const float um = __shfl_sync(0xffffffffu, (j & 1) ? u1 : u0,
                                               4 * (a * UM + b) + (j >> 1));
#pragma unroll
                  for (int q = 0; q < 4; ++q) acc[j][q] = fmaf(v[a][b][q], um, acc[j][q]);
                }
              }
            }
          }
        }
      }
    }
  }
  float v[4];
  if (!sum_warps_panel(red, acc, kw, v)) return;
  const int64_t c = chunk_col[ch];
  if (col_chunk[c + 1] - col_chunk[c] == 1)
    store_column(out + (j0 + warp) * io.o_cs, c * bn, n0, bn, io.o_rs, v);
  else  // partial row (ch, j0 + warp): a column's row, contiguous in n
    store_n4(partial + (ch * io.k + j0 + warp) * bn, n0, bn, bn % 4 == 0, v);
}

// Pass 2: blockIdx.x = a column with no chunk or several, blockIdx.y = n
// tile, blockIdx.z = column tile; column_combine_pass's order per column.
template <typename TX>
__device__ __forceinline__ void
panel_combine_pass(const float* __restrict__ partial, const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ col_chunk, TX* __restrict__ out, int bn,
                   PanelIO io) {
  __shared__ __align__(16) float red[kT2Warps][kPanel][kT2Tile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = cols[blockIdx.x];
  const int n0 = blockIdx.y * kT2Tile + 4 * lane;
  const int j0 = blockIdx.z * kPanel;
  const int kw = min(kPanel, io.k - j0);
  const bool vec = bn % 4 == 0;
  const int k1 = col_chunk[c + 1];
  float acc[kPanel][4];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int r = col_chunk[c] + warp; r < k1; r += kT2Warps * kUnroll) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t row = r + i * kT2Warps;
      if (row < k1) {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          if (j < kw) {
            float p[4];
            load_n4(partial + (row * io.k + j0 + j) * bn, n0, bn, vec, p);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[j][q] += p[q];
          }
        }
      }
    }
  }
  float v[4];
  if (sum_warps_panel(red, acc, kw, v))
    store_column(out + (j0 + warp) * io.o_cs, c * bn, n0, bn, io.o_rs, v);
}

template <typename TB, typename TX>
using PanelChunkKernel = void (*)(const TB*, const int32_t*, const int32_t*, const int32_t*,
                                  const int32_t*, const TX*, float*, TX*, int, int, int, bool,
                                  PanelIO);
template <typename TX>
using PanelCombineKernel = void (*)(const float*, const int32_t*, const int32_t*, TX*, int,
                                    PanelIO);

// Launches a column plan's two panel passes, as launch_column_plan does,
// over ceil(k / kPanel) column tiles. partial is (nchunks, k, bn) f32.
template <typename TB, typename TX>
int launch_panel_plan(PanelChunkKernel<TB, TX> by_slot, PanelChunkKernel<TB, TX> by_m,
                      PanelCombineKernel<TX> combine, const void* blocks, const void* perm,
                      const void* chunk_ptr, const void* chunk_col, const void* col_chunk,
                      const void* combine_cols, const void* u, float* partial, void* out,
                      int64_t nchunks, int64_t ncombine, int kmax, int bm, int bn,
                      PanelIO io, cudaStream_t stream) {
  if (nchunks > 0x7fffffffLL || ncombine > 0x7fffffffLL || io.k <= 0 ||
      (io.k + kPanel - 1) / kPanel > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned tiles = static_cast<unsigned>((bn + kT2Tile - 1) / kT2Tile);
  const unsigned ktiles = static_cast<unsigned>((io.k + kPanel - 1) / kPanel);
  const bool vec = bn % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % (4 * sizeof(TB)) == 0;
  if (nchunks > 0) {
    const dim3 grid(static_cast<unsigned>(nchunks), tiles, ktiles);
    auto kernel = bm <= kT2Warps ? by_slot : by_m;
    kernel<<<grid, kT2Warps * 32, 0, stream>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(chunk_ptr), static_cast<const int32_t*>(chunk_col),
        static_cast<const int32_t*>(col_chunk), static_cast<const TX*>(u), partial,
        static_cast<TX*>(out), kmax, bm, bn, vec, io);
    if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  }
  if (ncombine > 0) {
    combine<<<dim3(static_cast<unsigned>(ncombine), tiles, ktiles), kT2Warps * 32, 0, stream>>>(
        partial, static_cast<const int32_t*>(combine_cols),
        static_cast<const int32_t*>(col_chunk), static_cast<TX*>(out), bn, io);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}


// ---- the forward over a panel of columns (K1p, K3p, K5p) ----
//
// y[r bm + m, j] = sum over the slots of block row r of sum_n
// blocks[r, k, m, n] * x[row(slot) bn + n, j], for every column j < k of x:
// the block apply of a forward (the reference runs jax.vmap of the vector
// kernel there, one batched pallas_call). x and y are addressed through
// (row, column) strides (PanelIO: u is x, out is y), so a column panel
// (n, k) and the transposed view of a row panel (k, n) both run without a
// copy. `row` maps a slot to the block row of x it reads, or -1 when the
// slot adds nothing (K1: its block column; K3, K5: the window row the
// vector kernel stages, addressed in x itself).
//
// Work: a warp takes a chunk of kFwdRows m values of one block row (a
// thread block, kFwdWarps consecutive chunks: 8 block rows at bm = 8) and a
// tile of kPanel columns (blockIdx.y). Lanes walk n (n = lane, lane + 32,
// ...) over the slots in order, as the vector kernels' warps do; each lane
// keeps kFwdRows x kPanel f32 chains, one per (m, j). A step loads the
// chunk's kFwdRows block values and the kPanel x values of its n once and
// makes kFwdRows x kPanel multiply-adds: a stored block is read once per
// tile of kPanel columns, and an x value once per chunk (the first design,
// a warp per m row as K1, read each x value bm times from L1/L2 and ran at
// a sixth of the bytes bound on the H100).
//
// The end of a chunk adds each chain over the warp by warp_sum's butterfly
// (lane offsets 16, 8, 4, 2, 1), each lane sending half of the values it
// holds at each level and keeping the other half: 62 shuffles for the 64
// sums, where 64 warp_sums take 320, and lane l ends with sums 2l and
// 2l + 1 (m = l / 4, j = 2 (l % 4) + {0, 1}). Each level adds the same two
// partial sums as warp_sum's (a + b or b + a: the same bits), so each sum
// is warp_sum's.
//
// Order: the chain of (m, j) is the vector kernel's chain of row m for
// column j (the same slots, n values and order), and its warp sum is
// warp_sum's, so column j is bit for bit K1 (K3, K5) applied to column j. A
// window row past x, which K3 and K5 stage as zeros, is read as zeros here
// (a multiply-add by 0, as there).
//
// What the windows become here: K3 and K5 stage a row group's windows of
// one vector in shared memory (2 wb or W wb rows of bn values, up to 192
// KiB); a panel's windows are kPanel times larger and do not fit. So the
// panel kernels read the window rows of x from L2, as K1 reads x: the
// chunks of one thread block are consecutive block rows, which a banded
// plan points at the same windows, and the block rows of one group read the
// same windows, so L1 and L2 hold them. The plan is unchanged: the same
// slots count, in the same order.
//
// x is read as two 4-value loads a row when its columns are contiguous
// (u_cs == 1, u_rs a multiple of 4, x aligned, a full tile), else one
// value per column.

constexpr int kFwdWarps = 8;  // K1p, K3p, K5p: warps (chunks) per thread block
constexpr int kFwdRows = 8;   // m values per chunk
static_assert(kFwdRows * kPanel == 64, "a lane ends with two of a chunk's 64 sums");

template <typename TX>
__device__ __forceinline__ void load_panel_row(const TX* __restrict__ p, int64_t cs, int kw,
                                               bool vec, float v[kPanel]) {
  if (vec) {
    load4(p, v);
    load4(p + 4, v + 4);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) v[j] = j < kw ? widen(p[j * cs]) : 0.f;
}

// One level of the chunk's butterfly: N values a lane to N / 2, pairs at
// lane offset o.
template <int N>
__device__ __forceinline__ void sum_level(float* v, int o) {
  const bool up = (threadIdx.x & 31) & o;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The chunk's chunk-th kFwdRows m values of block row r over the column tile
// blockIdx.y; x_rows is x's block rows (a row at or past it reads as zeros).
template <typename TB, typename TX, typename Row>
__device__ __forceinline__ void forward_panel_chunk(const TB* __restrict__ blocks,
                                                    const TX* __restrict__ x,
                                                    TX* __restrict__ y, int64_t r, int m0,
                                                    int kmax, int bm, int bn, int64_t x_rows,
                                                    const Row& row, PanelIO io) {
  static_assert(kPanel == 8, "load_panel_row loads a tile as two 4-value pieces");
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.y * kPanel;
  const int kw = min(kPanel, io.k - j0);
  const int mw = min(kFwdRows, bm - m0);
  const TX* xj = x + j0 * io.u_cs;
  const bool vec = io.u_cs == 1 && io.u_rs % 4 == 0 && kw == kPanel &&
                   reinterpret_cast<uintptr_t>(xj) % (4 * sizeof(TX)) == 0;
  float acc[kFwdRows * kPanel];
#pragma unroll
  for (int i = 0; i < kFwdRows * kPanel; ++i) acc[i] = 0.f;
  for (int k = 0; k < kmax; ++k) {
    const int64_t slot = r * kmax + k;
    const int64_t xr = row(slot);
    if (xr < 0) continue;  // the same for the whole warp
    const bool inside = xr < x_rows;
    const TB* brow = blocks + (slot * bm + m0) * static_cast<int64_t>(bn);
    const TX* xrow = xj + xr * bn * io.u_rs;
#pragma unroll 2
    for (int n = lane; n < bn; n += 32) {
      float b[kFwdRows], xv[kPanel];
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i)
        b[i] = i < mw ? widen(brow[static_cast<int64_t>(i) * bn + n]) : 0.f;
      if (inside) {
        load_panel_row(xrow + n * io.u_rs, io.u_cs, kw, vec, xv);
      } else {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) xv[j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        if (i < mw) {  // the same for the whole warp
#pragma unroll
          for (int j = 0; j < kPanel; ++j)
            acc[i * kPanel + j] = fmaf(b[i], xv[j], acc[i * kPanel + j]);
        }
      }
    }
  }
  sum_level<64>(acc, 16);
  sum_level<32>(acc, 8);
  sum_level<16>(acc, 4);
  sum_level<8>(acc, 2);
  sum_level<4>(acc, 1);
  const int m = lane >> 2;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = 2 * (lane & 3) + t;
    if (m < mw && j < kw)
      y[(r * bm + m0 + m) * io.o_rs + (j0 + j) * io.o_cs] = narrow<TX>(acc[t]);
  }
}

// The chunk a warp takes: blockIdx.x kFwdWarps chunks, chunk c = block row
// c / mchunks, m values from (c % mchunks) kFwdRows; false past the last.
__device__ __forceinline__ bool forward_chunk(int64_t nbrow, int bm, int64_t* r, int* m0) {
  const int mchunks = (bm + kFwdRows - 1) / kFwdRows;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  *r = c / mchunks;
  *m0 = static_cast<int>(c % mchunks) * kFwdRows;
  return *r < nbrow;
}

// The grid of a forward panel: blockIdx.x = kFwdWarps chunks, blockIdx.y =
// column tile.
inline int forward_panel_grid(int64_t nbrow, int bm, int k, dim3* grid) {
  const int64_t chunks = nbrow * ((bm + kFwdRows - 1) / kFwdRows);
  const int64_t gx = (chunks + kFwdWarps - 1) / kFwdWarps;
  const int64_t gy = (k + kPanel - 1) / kPanel;
  if (k <= 0 || gx > 0x7fffffffLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return 0;
}

}  // namespace

extern "C" const char* linops_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
