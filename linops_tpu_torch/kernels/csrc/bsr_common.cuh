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
//   (bsr_window.cu) launch under kernels of their own names; their panel
//   forms (K2p, K6p), whose chunk pass stages block rows in a ring of
//   shared memory by bulk copies (mbarriers, cp.async.bulk: sm_90), which
//   K4p's per-warp rings (bsr_window.cu) use too.
// - linops_cuda_error_string: the message of a CUDA error code, for the
//   wrappers' exceptions.
//
// The build (kernels/build.py) hashes this header together with every source
// that includes it, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
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
// row panel (k, n) both run without a copy. The chunk pass's work items are
// (chunk, 128-wide n tile, tile of TJ columns: 8 for k <= 8, else 16, as
// the caller passes it, bsr_spmv.py::transpose_panel_tile), and each lane
// keeps TJ x 4 f32 accumulators (its four n values for every column of the
// tile): a stored block is read once per column tile, where k vector
// applies read it k times.
//
// The ring. An item's block rows (slot i of the chunk, m), taken slot by
// slot and m ascending, are cut into stages of Ring::rows (at most 32) rows
// of its n tile, about 16 KB; a thread block holds kRingStages stages in
// dynamic shared memory and is persistent: as many blocks as fit the card
// walk the items, and the ring runs on from one item's stages to the next,
// so a chunk's start is not paid before its rows stream. kRingProducers
// producer warps fill the stages in turn: with bulk copies (cp.async.bulk,
// completing on the stage's `full` mbarrier by bytes) when every staged
// row starts on 16 bytes (bn x the value size a multiple of 16, an aligned
// base: one copy per slot when the n tile is the whole row, 4 KB for an
// 8x128 f32 block, else one per row), and with the stage's u values, a row
// a lane, widened to f32. A producer loads the perm entries of its next
// stage and the u values of the current one before it waits for the
// current stage's `empty` mbarrier, so that when a stage frees only its
// copies remain to be issued (a producer that loaded them after the wait
// left a 16-column tile 1.2-1.4x slower on the H100). The eight consumer warps
// wait on `full`, multiply, and release the stage on `empty`. The copies
// cost the consumers no registers and no instructions, and u reaches every
// lane as a shared-memory broadcast (the first panel pass loaded 8 rows
// into registers and handed out u by 64 shuffles).
//
// The ragged path: a shape the bulk copy cannot take (bn x the value size
// not a multiple of 16, or an unaligned base) runs the same kernel with the
// producer's lanes copying the rows by plain loads, zeros past bn; the
// consumers do not change (Ring::bulk).
//
// The bits contract: column j's multiply-adds are the vector pass's for
// column j in its order (warp w takes m = w, w + 8, ...; slots in the
// chunk's perm order, m ascending within a slot; fmaf(block, u, acc)), its
// warps are added in warp order and its partial rows in the combine's
// order: column j is bit for bit K2 (K6) applied to column j of u, whatever
// the tile width, the stage size or the path. The number of consumer warps
// and which warp owns which m are therefore fixed at K2's.
//
// At an item's end the consumers write their sums to shared memory (red),
// kPanel columns a round, and consumer warp j adds column j over the warps
// in warp order; they synchronise among themselves (a named barrier), not
// with the producers, which run on into the next item.

constexpr int kPanel = 8;       // K1p, K3p, K5p, and the panel combines: columns per tile
constexpr int kRingStages = 4;     // K2p, K6p: stages in a thread block's ring
constexpr int kRingProducers = 2;  // K2p, K6p: producer warps, each a stage in turn
constexpr int kRingBytes = 16384;  // block bytes a stage holds, about
constexpr int kRingMaxRows = 32;   // block rows a stage holds, at most: one a producer lane
constexpr int kRingThreads = (kT2Warps + kRingProducers) * 32;
static_assert(kRingStages % kRingProducers == 0, "a ring stage belongs to one producer warp");
static_assert(kPanel <= kT2Warps, "warp j adds column j of a tile");

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

// ---- mbarriers and bulk copies (sm_90) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's earlier shared-memory reads before later bulk copies
// into the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// four consecutive staged values (16 or 8 bytes, aligned), widened
__device__ __forceinline__ void lds4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// The staging of a transpose panel's block rows, set by the host.
struct Ring {
  int rows;     // block rows a stage holds
  int pitch;    // values from one staged row to the next
  bool bulk;    // bulk copies; else the ragged path's plain loads
  bool whole;   // the n tile is the whole row (bn <= 128)
  int u_off;    // byte offset of the staged u values in dynamic shared memory
  int red_off;  // byte offset of the warps' sums (the chunk pass)
};

// The column tile and the staging of a transpose panel are the caller's
// (bsr_spmv.py::transpose_panel_tile, transpose_panel_path): tj 8 or 16,
// and bulk copies only where every staged row starts on 16 bytes, which a
// launch checks (a bulk copy from another address faults).
template <typename TB>
inline bool panel_staging_ok(const void* blocks, int bn, int tj, bool bulk) {
  const bool aligned = (static_cast<int64_t>(bn) * sizeof(TB)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  return (tj == 8 || tj == 16) && (aligned || !bulk);
}

// Multiplies one staged block row into a lane's TJ x 4 accumulators.
template <typename TB, int TJ>
__device__ __forceinline__ void ring_row(const TB* brow, const float* urow, int n0, int width,
                                         int kw, float acc[TJ][4]) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (n0 < width) lds4(brow + n0, v);  // rows are zero-filled to a multiple of 4
#pragma unroll
  for (int j4 = 0; j4 < TJ; j4 += 4) {
    if (j4 < kw) {  // the same for the whole block
      const float4 w = *reinterpret_cast<const float4*>(urow + j4);
      const float uw[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j4 + jj < kw) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j4 + jj][q] = fmaf(v[q], uw[jj], acc[j4 + jj][q]);
        }
      }
    }
  }
}

// Stages rows [0, nr) of block rows `row_of(r)` (element offsets of the n
// tile's first value) by plain loads, width values each, zeros to the pitch.
template <typename TB, typename RowOf>
__device__ __forceinline__ void stage_rows_plain(TB* dst, const TB* __restrict__ blocks, int nr,
                                                 int width, int pitch, const RowOf& row_of) {
  for (int r = 0; r < nr; ++r) {
    const TB* src = blocks + row_of(r);
    for (int n = threadIdx.x & 31; n < pitch; n += 32)
      dst[r * pitch + n] = n < width ? src[n] : narrow<TB>(0.f);
  }
}

// The work items of a panel plan: (chunk, n tile, column tile), item w =
// (w / (ntiles ktiles), (w / ktiles) % ntiles, w % ktiles).
struct PanelItems {
  int64_t n;   // items
  int ntiles;  // 128-wide n tiles
  int ktiles;  // column tiles
};

__device__ __forceinline__ void consumer_sync() {  // the kT2Warps consumer warps alone
  asm volatile("bar.sync 1, %0;" ::"n"(kT2Warps * 32) : "memory");
}

// Pass 1 of a column plan's panel transpose, persistent: a thread block
// walks items blockIdx.x, blockIdx.x + gridDim.x, ... with kT2Warps consumer
// warps and kRingProducers producer warps (the last), its ring running on
// from one item's stages to the next's, so that an item's first stages
// stream in while the one before it is summed and written.
template <typename TB, typename TX, int TJ>
__device__ __forceinline__ void
panel_chunk_pass(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ chunk_ptr, const int32_t* __restrict__ chunk_col,
                 const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                 float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm, int bn,
                 Ring ring, PanelIO io, PanelItems items) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kRingStages], empty[kRingStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stage_vals = ring.rows * ring.pitch;
  const int64_t bsize = static_cast<int64_t>(bm) * bn;
  TB* ring_b = reinterpret_cast<TB*>(smem);
  float* ring_u = reinterpret_cast<float*>(smem + ring.u_off);
  float(*red)[kPanel][kT2Tile] = reinterpret_cast<float(*)[kPanel][kT2Tile]>(smem + ring.red_off);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kT2Warps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int per_chunk = items.ntiles * items.ktiles;
  if (warp >= kT2Warps) {  // producer p fills the ring's stages g with g % kRingProducers == p
    const int p = warp - kT2Warps;
    // the item w, the stages of the block's items before it (g), and its geometry
    int64_t w = blockIdx.x, g = 0;
    int s0 = 0, rows = 0, nst = 0, t0 = 0, j0 = 0, width = 0, kw = 0;
    auto load_item = [&]() {
      const int64_t ch = w / per_chunk;
      const int rem = static_cast<int>(w % per_chunk);
      t0 = (rem / items.ktiles) * kT2Tile;
      j0 = (rem % items.ktiles) * TJ;
      width = min(kT2Tile, bn - t0);
      kw = min(TJ, io.k - j0);
      s0 = chunk_ptr[ch];
      rows = (chunk_ptr[ch + 1] - s0) * bm;
      nst = (rows + ring.rows - 1) / ring.rows;
    };
    int t = p;  // the stage of item w this producer fills next
    auto settle = [&]() {  // move on to the item that holds stage t
      while (w < items.n && t >= nst) {
        t -= nst;
        g += nst;
        w += gridDim.x;
        if (w < items.n) load_item();
      }
    };
    // which slots of the chunk a lane's copy (ic) and its u row (iu) read
    // at stage t, -1 for none; their perm entries are loaded a stage ahead
    auto slots = [&](int& ic, int& iu) {
      const int r0 = t * ring.rows, nr = min(ring.rows, rows - r0);
      if (ring.whole)
        ic = r0 / bm + lane <= (r0 + nr - 1) / bm ? r0 / bm + lane : -1;
      else
        ic = lane < nr ? (r0 + lane) / bm : -1;
      iu = lane < nr ? (r0 + lane) / bm : -1;
    };
    if (w < items.n) load_item();
    settle();
    int ic = -1, iu = -1, pc = 0, pu = 0;
    if (w < items.n) {
      slots(ic, iu);
      pc = ic >= 0 ? perm[s0 + ic] : 0;
      pu = iu >= 0 ? perm[s0 + iu] : 0;
    }
    while (w < items.n) {
      // stage t of item w: its u row and its copy, from the perm entries in hand
      const int64_t gs = g + t;
      const int st = static_cast<int>(gs % kRingStages);
      const int r0 = t * ring.rows, nr = min(ring.rows, rows - r0);
      float uw[TJ];
#pragma unroll
      for (int j = 0; j < TJ; ++j) uw[j] = 0.f;
      if (iu >= 0) {
        const TX* pu_row = u + (static_cast<int64_t>(pu) / kmax * bm + (r0 + lane - iu * bm)) *
                                   io.u_rs + j0 * io.u_cs;
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          if (j < kw) uw[j] = widen(pu_row[j * io.u_cs]);
      }
      const TB* src = nullptr;
      int drow = 0;
      unsigned nbytes = 0;
      if (ic >= 0) {
        if (ring.whole) {
          const int ma = max(r0 - ic * bm, 0), mb = min(r0 + nr - ic * bm, bm);
          src = blocks + pc * bsize + static_cast<int64_t>(ma) * bn;
          drow = ic * bm + ma - r0;
          nbytes = (mb - ma) * bn * static_cast<unsigned>(sizeof(TB));
        } else {
          src = blocks + pc * bsize + static_cast<int64_t>(r0 + lane - ic * bm) * bn + t0;
          drow = lane;
          nbytes = width * static_cast<unsigned>(sizeof(TB));
        }
      }
      const int cur_s0 = s0, cur_t0 = t0, cur_width = width;
      const unsigned stage_bytes = nr * width * static_cast<unsigned>(sizeof(TB));
      // the next stage's perm entries, in flight while this one waits for its slot
      t += kRingProducers;
      settle();
      if (w < items.n) {
        slots(ic, iu);
        pc = ic >= 0 ? perm[s0 + ic] : 0;
        pu = iu >= 0 ? perm[s0 + iu] : 0;
      }
      if (gs >= kRingStages)
        mbar_wait(&empty[st], static_cast<unsigned>((gs / kRingStages - 1) & 1));
      TB* dst = ring_b + st * stage_vals;
      if (ring.bulk) {
        if (lane == 0) mbar_expect_tx(&full[st], stage_bytes);
        __syncwarp();
        if (nbytes) bulk_load(dst + drow * ring.pitch, src, nbytes, &full[st]);
      } else {
        stage_rows_plain(dst, blocks, nr, cur_width, ring.pitch, [&](int r) -> int64_t {
          const int i = (r0 + r) / bm, m = r0 + r - i * bm;
          return perm[cur_s0 + i] * bsize + static_cast<int64_t>(m) * bn + cur_t0;
        });
      }
      if (lane < nr) {
        float* du = ring_u + (st * ring.rows + lane) * TJ;
#pragma unroll
        for (int j = 0; j < TJ; j += 4)
          *reinterpret_cast<float4*>(du + j) = make_float4(uw[j], uw[j + 1], uw[j + 2], uw[j + 3]);
      }
      mbar_arrive(&full[st]);  // each lane's stores, and the copies' bytes
    }
    return;
  }
  // a consumer: m = warp, warp + kT2Warps, ... of every slot
  int64_t g = 0;
  const int n0 = 4 * lane;
  for (int64_t w = blockIdx.x; w < items.n; w += gridDim.x) {
    const int64_t ch = w / per_chunk;
    const int rem = static_cast<int>(w % per_chunk);
    const int t0 = (rem / items.ktiles) * kT2Tile, j0 = (rem % items.ktiles) * TJ;
    const int width = min(kT2Tile, bn - t0), kw = min(TJ, io.k - j0);
    const int rows = (chunk_ptr[ch + 1] - chunk_ptr[ch]) * bm;
    const int nst = (rows + ring.rows - 1) / ring.rows;
    float acc[TJ][4];
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int t = 0; t < nst; ++t) {
      const int64_t gs = g + t;
      const int st = static_cast<int>(gs % kRingStages);
      mbar_wait(&full[st], static_cast<unsigned>((gs / kRingStages) & 1));
      const int r0 = t * ring.rows, r1 = min(r0 + ring.rows, rows);
      if (warp < bm) {
        int i = r0 / bm, m = r0 - i * bm;
        m += (warp - m) & (kT2Warps - 1);  // the first m of this warp at or after r0
        if (m >= bm) {
          ++i;
          m = warp;
        }
        const TB* sb = ring_b + st * stage_vals;
        const float* su = ring_u + st * ring.rows * TJ;
        for (int r = i * bm + m; r < r1; r = i * bm + m) {
          ring_row<TB, TJ>(sb + (r - r0) * ring.pitch, su + (r - r0) * TJ, n0, width, kw, acc);
          m += kT2Warps;
          if (m >= bm) {
            ++i;
            m = warp;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    g += nst;
    // the warps' sums, kPanel columns a round: warp j adds column j over the
    // warps in warp order
    const int64_t c = chunk_col[ch];
    const bool single = col_chunk[c + 1] - col_chunk[c] == 1;
#pragma unroll
    for (int jr = 0; jr < TJ; jr += kPanel) {
      if (jr < kw) {  // the same for the whole block
        consumer_sync();  // the last round's reads are done
#pragma unroll
        for (int j = 0; j < kPanel; ++j)
          if (jr + j < kw)
            *reinterpret_cast<float4*>(&red[warp][j][n0]) =
                make_float4(acc[jr + j][0], acc[jr + j][1], acc[jr + j][2], acc[jr + j][3]);
        consumer_sync();
        if (jr + warp < kw) {
          float4 sum = *reinterpret_cast<const float4*>(&red[0][warp][n0]);
          float v[4] = {sum.x, sum.y, sum.z, sum.w};
          for (int w2 = 1; w2 < kT2Warps; ++w2) {
            sum = *reinterpret_cast<const float4*>(&red[w2][warp][n0]);
            v[0] += sum.x; v[1] += sum.y; v[2] += sum.z; v[3] += sum.w;
          }
          const int j = j0 + jr + warp;
          if (single)
            store_column(out + j * io.o_cs, c * bn, t0 + n0, bn, io.o_rs, v);
          else  // partial row (ch, j): a column's row, contiguous in n
            store_n4(partial + (ch * io.k + j) * bn, t0 + n0, bn, bn % 4 == 0, v);
        }
      }
    }
  }
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
                                  const int32_t*, const TX*, float*, TX*, int, int, int, Ring,
                                  PanelIO, PanelItems);
template <typename TX>
using PanelCombineKernel = void (*)(const float*, const int32_t*, const int32_t*, TX*, int,
                                    PanelIO);

// The ring of a chunk pass over rows of bn values and a tile of tj columns;
// its dynamic shared memory (the ring, the staged u values, the warps'
// sums) in *bytes.
template <typename TB>
Ring chunk_ring(bool bulk, int bn, int tj, size_t* bytes) {
  Ring g;
  g.bulk = bulk;
  g.whole = bn <= kT2Tile;
  g.pitch = g.whole ? (bn + 3) / 4 * 4 : kT2Tile;
  g.rows = kRingBytes / (g.pitch * static_cast<int>(sizeof(TB)));
  g.rows = g.rows < 1 ? 1 : (g.rows > kRingMaxRows ? kRingMaxRows : g.rows);
  const size_t ring_bytes = static_cast<size_t>(kRingStages) * g.rows * g.pitch * sizeof(TB);
  const size_t u_off = (ring_bytes + 15) / 16 * 16;
  const size_t red_off = u_off + static_cast<size_t>(kRingStages) * g.rows * tj * sizeof(float);
  g.u_off = static_cast<int>(u_off);
  g.red_off = static_cast<int>(red_off);
  *bytes = red_off + static_cast<size_t>(kT2Warps) * kPanel * kT2Tile * sizeof(float);
  return g;
}

// Launches a column plan's two panel passes, as launch_column_plan does:
// the chunk pass (`chunk8` or `chunk16`, by the column tile tj; bulk
// copies or the ragged path, by `bulk`) persistent,
// as many thread blocks as fit the card at once over the items (chunk, n
// tile, column tile), then the combine over ceil(k / kPanel) column tiles.
// partial is (nchunks, k, bn) f32.
template <typename TB, typename TX>
int launch_panel_plan(PanelChunkKernel<TB, TX> chunk8, PanelChunkKernel<TB, TX> chunk16,
                      PanelCombineKernel<TX> combine, const void* blocks, const void* perm,
                      const void* chunk_ptr, const void* chunk_col, const void* col_chunk,
                      const void* combine_cols, const void* u, float* partial, void* out,
                      int64_t nchunks, int64_t ncombine, int kmax, int bm, int bn,
                      PanelIO io, int tj, bool bulk, cudaStream_t stream) {
  if (nchunks > 0x7fffffffLL || ncombine > 0x7fffffffLL || io.k <= 0 ||
      (io.k + kPanel - 1) / kPanel > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (!panel_staging_ok<TB>(blocks, bn, tj, bulk))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>((bn + kT2Tile - 1) / kT2Tile);
  if (nchunks > 0) {
    size_t smem;
    const Ring ring = chunk_ring<TB>(bulk, bn, tj, &smem);
    auto kernel = tj == 8 ? chunk8 : chunk16;
    if (int rc = set_dynamic_smem(kernel, smem)) return rc;
    const PanelItems items{nchunks * tiles * ((io.k + tj - 1) / tj), static_cast<int>(tiles),
                           (io.k + tj - 1) / tj};
    int device, sms, per_sm;
    if (int rc = static_cast<int>(cudaGetDevice(&device))) return rc;
    if (int rc = static_cast<int>(
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
      return rc;
    if (int rc = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRingThreads, smem)))
      return rc;
    const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = static_cast<unsigned>(items.n < resident ? items.n : resident);
    kernel<<<grid, kRingThreads, smem, stream>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(chunk_ptr), static_cast<const int32_t*>(chunk_col),
        static_cast<const int32_t*>(col_chunk), static_cast<const TX*>(u), partial,
        static_cast<TX*>(out), kmax, bm, bn, ring, io, items);
    if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  }
  if (ncombine > 0) {
    const unsigned ktiles = static_cast<unsigned>((io.k + kPanel - 1) / kPanel);
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
