// Windowed BSR products for Hopper (sm_90a): BSR operators whose x (or, for
// the transpose, whose output) is reached through a window plan.
//
// K3 `linops_bsr_matvec_windowed` replaces
//     linops_tpu/kernels/bsr_spmv.py::bsr_matvec_pallas_windowed:
//     y[r, m] = sum_k sum_n blocks[r, k, m, n] * x[q[g] * wb + cols_local[r, k], n]
//   for r in row group g (R = nbrow / ngroups rows each); 0 <= cols_local < 2 wb,
//   so a group reads x only through the two adjacent windows at q[g] * wb.
// K5 `linops_bsr_matvec_multiwin` replaces bsr_matvec_pallas_multiwin:
//     K1's sum with x read through W <= kMaxWindows independently addressed
//     windows [q[w, g] * wb, (q[w, g] + 1) * wb); a slot reads its (global)
//     block column c from the lane whose window holds it. Dump windows past x
//     hold no column. The host finds that lane once per operator
//     (bsr_multiwin_index: row w wb + c % wb of the staged windows, or -1),
//     so the kernel's inner loop is K3's: a per-slot division and lane search
//     made the first version bound by instructions (PERF.md).
// K4 `linops_bsr_rmatvec_windowed` replaces bsr_rmatvec_pallas_windowed and
// K6 `linops_bsr_rmatvec_multiwin` replaces bsr_rmatvec_pallas_multiwin: the
//   transpose scatter out[c, n] = sum blocks[r, k, m, n] * u[r, m] into the
//   windows of the same plans (K6: W monotone output lanes, valid mask per
//   lane and group; an invalid lane step adds nothing, a slot is added once
//   for every valid lane step whose window holds its column). Block columns
//   no window visits come out exactly zero.
//
// What bounds them: like K1/K2, the bytes of the stored blocks, each read
// once for one multiply-add. What the windows buy on this card: a row group's
// x windows are staged once into shared memory (2 wb or W wb rows of bn,
// 40 KB at the banded benchmark shape), so the per-slot gather reads shared
// memory instead of L2/HBM. The TPU needed windows because x did not fit its
// VMEM; an H100 thread block can gather x anywhere, so whether the windows
// pay here is a measurement (PERF.md), not a premise.
//
// Forward design (K3, K5): one thread block per (row group, slice of
// slice_rows block rows), kThreads threads, registers capped so two blocks
// fit an SM. It stages the group's windows
// into dynamic shared memory with coalesced loads (rows past x are staged as
// zeros, so no window reads past x and the caller pads nothing), syncs once,
// then runs K1's shape: one warp per output row (r, m), lanes over n, a
// shuffle-tree sum, no atomics. Slices keep the grid full when groups are few
// and large (R = 512 block rows at the banded benchmark shape).
//
// Transpose design (K4): deterministic, bit-identical from run to run, with
// no float atomics. Two phases:
//   1. window_partial_kernel: one warp per (partial row i, 128-wide n tile).
//      Partial row i = g * 2 wb + l is local output column l of group g's
//      windows. The host builds, once per operator, the slots of each
//      partial row in increasing slot order (`perm`, `ptr`: see
//      bsr_window_t_index); a lane sums its n over those slots and over m in
//      that fixed order, in f32, four slots' loads in flight at a time, and
//      writes the row (zeros for rows no slot reaches).
//   2. windowed_combine_kernel: one thread per output element (c, n).
//      Because q never decreases over groups, the groups whose windows hold
//      c form a contiguous run, found by binary search in the plan itself; a
//      run's partials are added in a fixed order (strided_sum).
// The partials are (ngroups * 2 wb, bn) f32 in a buffer the wrapper
// allocates: about 1 % of the stored block bytes at the benchmark shapes.
//
// Transpose design (K6): K2's column plan (bsr_spmv.cu, bsr_common.cuh) over
// the slots that K6's windows cover. The host builds, once per operator
// (bsr_spmv.py::bsr_multiwin_t_plan), the slots of every valid lane step
// whose window holds the slot's block column, sorted by block column, cut
// into chunks of about 64 KB of blocks; multiwin_chunk_kernel gives each
// (chunk, 128-wide n tile) a thread block with 16-byte loads and 8 block
// rows in flight per warp, and multiwin_combine_kernel adds the partial rows
// of a column with several chunks by warps, in a fixed order (zeros for a
// column no window visits). K6's first design ran K4's two phases with
// W wb partial rows per group: a warp per partial row made scalar loads, and
// on the band + cluster operator one combine thread walked the far column's
// 2048 groups (59 % of the bytes bound, against 88 % now; PERF.md).
//
// Panel forms (the block apply of a transpose; the reference runs jax.vmap
// of the vector kernel there, one batched pallas_call): K4p
// `linops_bsr_rmatmat_windowed` and K6p `linops_bsr_rmatmat_multiwin` give
// out[c, n, j] for every column j < k of u, u and out addressed through
// (row, column) strides. K4p's phase 1 (window_panel_partial_kernel) is
// window_partial_kernel with kPanel (8) accumulators per n value, so a
// stored block is read once per tile of kPanel columns; a lane holds four
// consecutive n values (one vector load a block row, where K4 loads them one
// by one), a warp loads kUnroll block rows at a time and their u values two
// a lane, handed out by shuffles. Its partials are
// (ngroups 2 wb, k, bn) f32, and its combine takes one thread per (c, n),
// as K4's, with K4's binary searches once and strided_sum for every column. K6p runs
// K2p's panel passes (bsr_common.cuh) over K6's column plan. Both keep the
// vector kernel's order per column: column j is bit for bit K4 (K6)
// applied to column j.
//
// f32 accumulation for f32 and bf16 blocks, also across groups (the TPU's
// bf16 transposes accumulated across groups in bf16; this does not). 64-bit
// element offsets. Each entry point launches on the caller's stream, does
// not synchronise, and returns the first nonzero cudaGetLastError() of its
// launches.

#include "bsr_common.cuh"

namespace {

constexpr int kThreads = 1024;     // forward: 32 warps per thread block
constexpr int kMaxWindows = 8;     // K5/K6 lanes
constexpr int kTile = 128;         // transpose phase 1: n values per warp
constexpr int kPartialWarps = 8;   // transpose phase 1: warps per thread block
constexpr int kCombineThreads = 256;

template <typename TX>
__device__ __forceinline__ void stage_rows(TX* dst, const TX* __restrict__ x,
                                           int64_t row0, int rows, int64_t x_rows,
                                           int bn) {
  const int64_t count = static_cast<int64_t>(rows) * bn;
  const int64_t base = row0 * bn;
  const int64_t limit = x_rows * bn;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    const int64_t gi = base + i;
    dst[i] = gi < limit ? x[gi] : narrow<TX>(0.f);
  }
}

// The forward body of K3 and K5, once the thread block's windows are staged
// in xs: warps walk the slice's output rows (r, m); slot (r, k) reads window
// row local[slot] (K3: cols_local; K5: w wb + c % wb for the lane w whose
// window holds its column c, built from the plan at construction); a row
// outside [0, span) is in no window and adds nothing.
template <typename TB, typename TX>
__device__ __forceinline__ void window_rows(const TB* __restrict__ blocks,
                                            const int32_t* __restrict__ local,
                                            const TX* xs, TX* __restrict__ y, int64_t r_first,
                                            int rows, int kmax, int bm, int bn, int span) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < rows * bm; t += kThreads / 32) {
    const int64_t r = r_first + t / bm;
    const int m = t % bm;
    float acc = 0.f;
    for (int k = 0; k < kmax; ++k) {
      const int64_t slot = r * kmax + k;
      const int l = local[slot];
      if (l < 0 || l >= span) continue;  // the same for the whole warp
      const TB* brow = blocks + (slot * bm + m) * static_cast<int64_t>(bn);
      const TX* xrow = xs + static_cast<int64_t>(l) * bn;
      for (int n = lane; n < bn; n += 32) acc = fmaf(widen(brow[n]), widen(xrow[n]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) y[r * bm + m] = narrow<TX>(acc);
  }
}

// Registers capped so that two 1024-thread blocks fit an SM (64 warps).
template <typename TB, typename TX>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
bsr_matvec_windowed_kernel(const TB* __restrict__ blocks,
                           const int32_t* __restrict__ cols_local,
                           const int32_t* __restrict__ win_q,
                           const TX* __restrict__ x, TX* __restrict__ y,
                           int64_t x_rows, int R, int slice_rows, int slices,
                           int kmax, int bm, int bn, int wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);  // (2 wb, bn)
  const int64_t g = blockIdx.x / slices;
  const int r0 = static_cast<int>(blockIdx.x % slices) * slice_rows;
  stage_rows(xs, x, static_cast<int64_t>(win_q[g]) * wb, 2 * wb, x_rows, bn);
  __syncthreads();
  window_rows(blocks, cols_local, xs, y, g * R + r0, min(slice_rows, R - r0), kmax, bm, bn,
              2 * wb);
}

template <typename TB, typename TX>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
bsr_matvec_multiwin_kernel(const TB* __restrict__ blocks,
                           const int32_t* __restrict__ lane_rows,
                           const int32_t* __restrict__ win_q,
                           const TX* __restrict__ x, TX* __restrict__ y,
                           int64_t x_rows, int ngroups, int nwin, int R,
                           int slice_rows, int slices, int kmax, int bm, int bn,
                           int wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);  // (nwin * wb, bn)
  const int64_t g = blockIdx.x / slices;
  const int r0 = static_cast<int>(blockIdx.x % slices) * slice_rows;
  for (int w = 0; w < nwin; ++w)  // the dump window lies past x: staged as zeros
    stage_rows(xs + static_cast<int64_t>(w) * wb * bn, x,
               static_cast<int64_t>(win_q[static_cast<int64_t>(w) * ngroups + g]) * wb, wb,
               x_rows, bn);
  __syncthreads();
  window_rows(blocks, lane_rows, xs, y, g * R + r0, min(slice_rows, R - r0), kmax, bm, bn,
              nwin * wb);
}

// Adds U listed slots (perm[e .. e+U)) to a lane's accumulators, slot by
// slot in list order; the U slots' addresses come first, so their loads are
// in flight together (a partial row can list hundreds of slots: the far
// cluster's row gets every row of its group at the band + cluster shape).
template <int U, typename TB, typename TX>
__device__ __forceinline__ void add_slots(const TB* __restrict__ blocks,
                                          const int32_t* __restrict__ perm, int e,
                                          const TX* __restrict__ u, float* acc, int kmax,
                                          int bm, int bn, int n0) {
  const TB* blk[U];
  const TX* urow[U];
#pragma unroll
  for (int s = 0; s < U; ++s) {
    const int64_t slot = perm[e + s];
    blk[s] = blocks + slot * bm * static_cast<int64_t>(bn);
    urow[s] = u + (slot / kmax) * bm;
  }
#pragma unroll
  for (int s = 0; s < U; ++s) {
    for (int m = 0; m < bm; ++m) {
      const float um = widen(urow[s][m]);
      const TB* brow = blk[s] + static_cast<int64_t>(m) * bn;
#pragma unroll
      for (int t = 0; t < kTile / 32; ++t) {
        const int n = n0 + 32 * t;
        if (n < bn) acc[t] = fmaf(widen(brow[n]), um, acc[t]);
      }
    }
  }
}

// Transpose phase 1 (K4 and K6): partial[i, n] = sum over the slots listed
// for partial row i (perm[ptr[i] .. ptr[i+1]]) and over m of
// blocks[slot, m, n] * u[slot / kmax, m]; fixed order, no atomics.
template <typename TB, typename TX>
__global__ void __launch_bounds__(kPartialWarps * 32)
window_partial_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ ptr, const TX* __restrict__ u,
                      float* __restrict__ partial, int64_t nrows, int ntiles,
                      int kmax, int bm, int bn) {
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * kPartialWarps + (threadIdx.x >> 5);
  if (wid >= nrows * ntiles) return;  // whole warps leave; nothing below syncs
  const int64_t i = wid / ntiles;
  const int n0 = static_cast<int>(wid % ntiles) * kTile + (threadIdx.x & 31);
  float acc[kTile / 32] = {0.f, 0.f, 0.f, 0.f};
  const int e1 = ptr[i + 1];
  int e = ptr[i];
  for (; e + 4 <= e1; e += 4) add_slots<4>(blocks, perm, e, u, acc, kmax, bm, bn, n0);
  for (; e < e1; ++e) add_slots<1>(blocks, perm, e, u, acc, kmax, bm, bn, n0);
  float* prow = partial + i * bn;
#pragma unroll
  for (int t = 0; t < kTile / 32; ++t) {
    const int n = n0 + 32 * t;
    if (n < bn) prow[n] = acc[t];
  }
}

// One listed slot added to a lane's panel accumulators, in add_slots' order
// (m ascending). A lane holds four consecutive n values (where K4's lane
// holds n0 + 32 t: which lane holds an output does not change its sum), so
// a block row is one 16-byte (f32) or 8-byte (bf16) load; the warp loads
// kUnroll rows at a time, with their u values two a lane (row m0 + lane / 4,
// columns 2 (lane % 4) + {0, 1} of the tile), handed out by shuffles.
template <typename TB, typename TX>
__device__ __forceinline__ void add_slot_panel(const TB* __restrict__ blk,
                                               const TX* __restrict__ urow,
                                               float acc[kPanel][4], int bm, int bn, int n0,
                                               bool vec, int64_t u_rs, int64_t u_cs, int kw) {
  const int lane = threadIdx.x & 31;
  const int uc = 2 * (lane & 3);
  for (int m0 = 0; m0 < bm; m0 += kUnroll) {
    const int mu = m0 + (lane >> 2);
    float u0 = 0.f, u1 = 0.f;
    if (mu < bm) {
      if (uc < kw) u0 = widen(urow[mu * u_rs + uc * u_cs]);
      if (uc + 1 < kw) u1 = widen(urow[mu * u_rs + (uc + 1) * u_cs]);
    }
    float b[kUnroll][4];
#pragma unroll
    for (int mm = 0; mm < kUnroll; ++mm)
      if (m0 + mm < bm) load_n4(blk + static_cast<int64_t>(m0 + mm) * bn, n0, bn, vec, b[mm]);
#pragma unroll
    for (int mm = 0; mm < kUnroll; ++mm) {
      if (m0 + mm < bm) {  // the same for the whole warp
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          if (j < kw) {
            const float um = __shfl_sync(0xffffffffu, (j & 1) ? u1 : u0, 4 * mm + (j >> 1));
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n0 + q < bn) acc[j][q] = fmaf(b[mm][q], um, acc[j][q]);
          }
        }
      }
    }
  }
}

// K4p phase 1: window_partial_kernel over a panel; blockIdx.y = column tile.
// partial[(i k + j) bn + n] for partial row i, f32. Registers capped at 128
// (a cap of 85 spilled and ran 1.4x slower on the H100).
template <typename TB, typename TX>
__global__ void __launch_bounds__(kPartialWarps * 32, 2)
window_panel_partial_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ ptr, const TX* __restrict__ u,
                            float* __restrict__ partial, int64_t nrows, int ntiles, int kmax,
                            int bm, int bn, bool vec, PanelIO io) {
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * kPartialWarps + (threadIdx.x >> 5);
  if (wid >= nrows * ntiles) return;  // whole warps leave; nothing below syncs
  const int64_t i = wid / ntiles;
  const int n0 = static_cast<int>(wid % ntiles) * kTile + 4 * (threadIdx.x & 31);
  const int j0 = blockIdx.y * kPanel;
  const int kw = min(kPanel, io.k - j0);
  const TX* uj = u + j0 * io.u_cs;
  float acc[kPanel][4];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int e = ptr[i]; e < ptr[i + 1]; ++e) {
    const int64_t slot = perm[e];
    add_slot_panel(blocks + slot * bm * static_cast<int64_t>(bn),
                   uj + (slot / kmax) * bm * io.u_rs, acc, bm, bn, n0, vec, io.u_rs, io.u_cs,
                   kw);
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
    if (j < kw) store_n4(partial + (i * io.k + j0 + j) * bn, n0, bn, bn % 4 == 0, acc[j]);
}

// first index in the nondecreasing a[0..len) with a[idx] >= v (upper: > v)
__device__ __forceinline__ int lower_bound(const int32_t* a, int len, int64_t v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int32_t* a, int len, int64_t v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Σ over i in [0, count) of p[i * stride], in eight interleaved partial
// sums added in a fixed order: deterministic, with eight independent loads
// in flight (a run of groups can be long: every group's cluster lane holds
// the far column of the band + cluster benchmark, 2048 groups).
__device__ __forceinline__ float strided_sum(const float* __restrict__ p, int64_t stride,
                                             int count) {
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (; i + 8 <= count; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] += p[static_cast<int64_t>(i + u) * stride];
  }
  for (; i < count; ++i) a[0] += p[static_cast<int64_t>(i) * stride];
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// K4 phase 2: group g's windows hold block column c iff q[g] is p - 1 (its
// high window, local column wb + j) or p (its low window, local column j),
// with p = c / wb, j = c % wb; q never decreases, so both are runs.
template <typename TX>
__global__ void __launch_bounds__(kCombineThreads)
windowed_combine_kernel(const float* __restrict__ partial, const int32_t* __restrict__ win_q,
                        TX* __restrict__ out, int64_t nbcol, int ngroups, int bn, int wb) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (idx >= nbcol * bn) return;
  const int64_t c = idx / bn;
  const int n = static_cast<int>(idx % bn);
  const int64_t p = c / wb;
  const int64_t j = c - p * wb;
  const int g0 = lower_bound(win_q, ngroups, p - 1);
  const int gm = lower_bound(win_q, ngroups, p);
  const int g1 = upper_bound(win_q, ngroups, p);
  const int64_t row = 2LL * wb * bn;  // one group's partial rows
  const float hi = strided_sum(partial + g0 * row + (wb + j) * bn + n, row, gm - g0);
  const float lo = strided_sum(partial + gm * row + j * bn + n, row, g1 - gm);
  out[idx] = narrow<TX>(hi + lo);
}

// K4p phase 2: windowed_combine_kernel for one (c, n) a thread, over every
// column j of the panel (the groups' search made once); the partials
// (ngroups 2 wb, k, bn).
template <typename TX>
__global__ void __launch_bounds__(kCombineThreads)
windowed_panel_combine_kernel(const float* __restrict__ partial,
                              const int32_t* __restrict__ win_q, TX* __restrict__ out,
                              int64_t nbcol, int ngroups, int bn, int wb, PanelIO io) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (idx >= nbcol * bn) return;
  const int64_t c = idx / bn;
  const int n = static_cast<int>(idx % bn);
  const int64_t p = c / wb;
  const int64_t jc = c - p * wb;
  const int g0 = lower_bound(win_q, ngroups, p - 1);
  const int gm = lower_bound(win_q, ngroups, p);
  const int g1 = upper_bound(win_q, ngroups, p);
  const int64_t row = 2LL * wb * io.k * bn;  // one group's partial rows
  const float* hi_p = partial + g0 * row + (wb + jc) * io.k * bn + n;
  const float* lo_p = partial + gm * row + jc * io.k * bn + n;
  TX* o = out + idx * io.o_rs;
  for (int j = 0; j < io.k; ++j) {
    const float hi = strided_sum(hi_p + static_cast<int64_t>(j) * bn, row, gm - g0);
    const float lo = strided_sum(lo_p + static_cast<int64_t>(j) * bn, row, g1 - gm);
    o[j * io.o_cs] = narrow<TX>(hi + lo);
  }
}

// K6 pass 1 and pass 2: K2's passes (bsr_common.cuh) over K6's own column
// plan (bsr_spmv.py::bsr_multiwin_t_plan), under K6's names. Registers capped
// as K2's.
template <typename TB, typename TX, int US, int UM>
__global__ void __launch_bounds__(kT2Warps * 32, 4)
multiwin_chunk_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ chunk_ptr,
                      const int32_t* __restrict__ chunk_col,
                      const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                      float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm,
                      int bn, bool vec) {
  column_chunk_pass<TB, TX, US, UM>(blocks, perm, chunk_ptr, chunk_col, col_chunk, u, partial,
                                    out, kmax, bm, bn, vec);
}

template <typename TX>
__global__ void __launch_bounds__(kT2Warps * 32)
multiwin_combine_kernel(const float* __restrict__ partial, const int32_t* __restrict__ cols,
                        const int32_t* __restrict__ col_chunk, TX* __restrict__ out, int bn,
                        bool vec) {
  column_combine_pass<TX>(partial, cols, col_chunk, out, bn, vec);
}

// K6p pass 1 and pass 2: K2p's panel passes over K6's column plan, under
// K6p's names. Registers capped as K2p's.
template <typename TB, typename TX, int US, int UM>
__global__ void __launch_bounds__(kT2Warps * 32, 3)
multiwin_panel_chunk_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ chunk_ptr,
                            const int32_t* __restrict__ chunk_col,
                            const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                            float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm,
                            int bn, bool vec, PanelIO io) {
  panel_chunk_pass<TB, TX, US, UM>(blocks, perm, chunk_ptr, chunk_col, col_chunk, u, partial,
                                   out, kmax, bm, bn, vec, io);
}

template <typename TX>
__global__ void __launch_bounds__(kT2Warps * 32, 2)
multiwin_panel_combine_kernel(const float* __restrict__ partial,
                              const int32_t* __restrict__ cols,
                              const int32_t* __restrict__ col_chunk, TX* __restrict__ out,
                              int bn, PanelIO io) {
  panel_combine_pass<TX>(partial, cols, col_chunk, out, bn, io);
}

int grid_or_error(int64_t blocks, unsigned* out) {
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out = static_cast<unsigned>(blocks);
  return 0;
}

template <typename TB, typename TX>
int launch_partial(const void* blocks, const void* perm, const void* ptr, const void* u,
                   float* partial, int64_t nrows, int kmax, int bm, int bn,
                   cudaStream_t stream) {
  const int ntiles = (bn + kTile - 1) / kTile;
  unsigned grid;
  if (int rc = grid_or_error((nrows * ntiles + kPartialWarps - 1) / kPartialWarps, &grid)) return rc;
  if (grid == 0) return 0;
  window_partial_kernel<TB, TX><<<grid, kPartialWarps * 32, 0, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(ptr), static_cast<const TX*>(u), partial, nrows, ntiles,
      kmax, bm, bn);
  return static_cast<int>(cudaGetLastError());
}

int combine_grid(int64_t nbcol, int bn, unsigned* grid) {
  return grid_or_error((nbcol * bn + kCombineThreads - 1) / kCombineThreads, grid);
}

}  // namespace

extern "C" {

// K3. x is (x_rows, bn); y is (nbrow, bm). nbrow = ngroups * R.
int linops_bsr_matvec_windowed(const void* blocks, const void* cols_local,
                               const void* win_q, const void* x, void* y, int64_t x_rows,
                               int64_t nbrow, int ngroups, int slice_rows, int kmax,
                               int bm, int bn, int wb, int block_dtype, int vec_dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ngroups <= 0 || nbrow % ngroups) return static_cast<int>(cudaErrorInvalidValue);
  const int R = static_cast<int>(nbrow / ngroups);
  const int slices = (R + slice_rows - 1) / slice_rows;
  unsigned grid;
  if (int rc = grid_or_error(static_cast<int64_t>(ngroups) * slices, &grid)) return rc;
  if (grid == 0) return 0;
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    const size_t smem = sizeof(TX) * 2 * static_cast<size_t>(wb) * bn;
    if (int rc = set_dynamic_smem(bsr_matvec_windowed_kernel<TB, TX>, smem)) return rc;
    bsr_matvec_windowed_kernel<TB, TX><<<grid, kThreads, smem, s>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(cols_local),
        static_cast<const int32_t*>(win_q), static_cast<const TX*>(x), static_cast<TX*>(y),
        x_rows, R, slice_rows, slices, kmax, bm, bn, wb);
    return static_cast<int>(cudaGetLastError());
  });
}

// K5. win_q is (nwin, ngroups); lane_rows is (nbrow, kmax), see bsr_multiwin_index.
int linops_bsr_matvec_multiwin(const void* blocks, const void* lane_rows, const void* win_q,
                               const void* x, void* y, int64_t x_rows, int64_t nbrow,
                               int ngroups, int nwin, int slice_rows, int kmax, int bm,
                               int bn, int wb, int block_dtype, int vec_dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ngroups <= 0 || nbrow % ngroups || nwin < 1 || nwin > kMaxWindows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = static_cast<int>(nbrow / ngroups);
  const int slices = (R + slice_rows - 1) / slice_rows;
  unsigned grid;
  if (int rc = grid_or_error(static_cast<int64_t>(ngroups) * slices, &grid)) return rc;
  if (grid == 0) return 0;
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    const size_t smem = sizeof(TX) * static_cast<size_t>(nwin) * wb * bn;
    if (int rc = set_dynamic_smem(bsr_matvec_multiwin_kernel<TB, TX>, smem)) return rc;
    bsr_matvec_multiwin_kernel<TB, TX><<<grid, kThreads, smem, s>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(lane_rows),
        static_cast<const int32_t*>(win_q), static_cast<const TX*>(x), static_cast<TX*>(y),
        x_rows, ngroups, nwin, R, slice_rows, slices, kmax, bm, bn, wb);
    return static_cast<int>(cudaGetLastError());
  });
}

// K4. partial is (ngroups * 2 wb, bn) f32 scratch; out is (nbcol, bn).
int linops_bsr_rmatvec_windowed(const void* blocks, const void* perm, const void* ptr,
                                const void* u, const void* win_q, float* partial, void* out,
                                int64_t nbcol, int ngroups, int kmax, int bm, int bn, int wb,
                                int block_dtype, int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    const int64_t nrows = static_cast<int64_t>(ngroups) * 2 * wb;
    if (int rc = launch_partial<TB, TX>(blocks, perm, ptr, u, partial, nrows, kmax, bm, bn, s))
      return rc;
    unsigned grid;
    if (int rc = combine_grid(nbcol, bn, &grid)) return rc;
    if (grid == 0) return 0;
    windowed_combine_kernel<TX><<<grid, kCombineThreads, 0, s>>>(
        partial, static_cast<const int32_t*>(win_q), static_cast<TX*>(out), nbcol, ngroups,
        bn, wb);
    return static_cast<int>(cudaGetLastError());
  });
}

// K6. perm, chunk_ptr, chunk_col, col_chunk, combine_cols: K6's column plan
// (bsr_spmv.py::bsr_multiwin_t_plan: the slots of valid lane steps whose
// window holds their block column, by column); partial is (nchunks, bn) f32
// scratch; out is (nbcol, bn).
int linops_bsr_rmatvec_multiwin(const void* blocks, const void* perm, const void* chunk_ptr,
                                const void* chunk_col, const void* col_chunk,
                                const void* combine_cols, const void* u, float* partial,
                                void* out, int64_t nchunks, int64_t ncombine, int kmax, int bm,
                                int bn, int block_dtype, int vec_dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_column_plan<TB, TX>(
        multiwin_chunk_kernel<TB, TX, kUnroll, 1>, multiwin_chunk_kernel<TB, TX, 1, kUnroll>,
        multiwin_combine_kernel<TX>, blocks, perm, chunk_ptr, chunk_col, col_chunk,
        combine_cols, u, partial, out, nchunks, ncombine, kmax, bm, bn, s);
  });
}

// K4p. K4's plan over k columns: u[row, j] at u[row * u_rs + j * u_cs]
// (row < nbrow bm), out[row, j] at out[row * o_rs + j * o_cs] (row < nbcol
// bn); partial is (ngroups 2 wb, k, bn) f32 scratch.
int linops_bsr_rmatmat_windowed(const void* blocks, const void* perm, const void* ptr,
                                const void* u, const void* win_q, float* partial, void* out,
                                int64_t nbcol, int ngroups, int kmax, int bm, int bn, int wb,
                                int k, int64_t u_rs, int64_t u_cs, int64_t o_rs, int64_t o_cs,
                                int block_dtype, int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || (k + kPanel - 1) / kPanel > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const PanelIO io{u_rs, u_cs, o_rs, o_cs, k};
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    const int64_t nrows = static_cast<int64_t>(ngroups) * 2 * wb;
    const int ntiles = (bn + kTile - 1) / kTile;
    unsigned grid;
    if (int rc = grid_or_error((nrows * ntiles + kPartialWarps - 1) / kPartialWarps, &grid))
      return rc;
    if (grid > 0) {
      const dim3 g2(grid, static_cast<unsigned>((k + kPanel - 1) / kPanel));
      const bool vec =
          bn % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % (4 * sizeof(TB)) == 0;
      window_panel_partial_kernel<TB, TX><<<g2, kPartialWarps * 32, 0, s>>>(
          static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
          static_cast<const int32_t*>(ptr), static_cast<const TX*>(u), partial, nrows, ntiles,
          kmax, bm, bn, vec, io);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    if (int rc = combine_grid(nbcol, bn, &grid)) return rc;
    if (grid == 0) return 0;
    windowed_panel_combine_kernel<TX><<<grid, kCombineThreads, 0, s>>>(
        partial, static_cast<const int32_t*>(win_q), static_cast<TX*>(out), nbcol, ngroups, bn,
        wb, io);
    return static_cast<int>(cudaGetLastError());
  });
}

// K6p. K6's column plan over k columns; u, out as K4p's; partial is
// (nchunks, k, bn) f32 scratch.
int linops_bsr_rmatmat_multiwin(const void* blocks, const void* perm, const void* chunk_ptr,
                                const void* chunk_col, const void* col_chunk,
                                const void* combine_cols, const void* u, float* partial,
                                void* out, int64_t nchunks, int64_t ncombine, int kmax, int bm,
                                int bn, int k, int64_t u_rs, int64_t u_cs, int64_t o_rs,
                                int64_t o_cs, int block_dtype, int vec_dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PanelIO io{u_rs, u_cs, o_rs, o_cs, k};
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_panel_plan<TB, TX>(
        multiwin_panel_chunk_kernel<TB, TX, kUnroll, 1>,
        multiwin_panel_chunk_kernel<TB, TX, 1, kUnroll>, multiwin_panel_combine_kernel<TX>,
        blocks, perm, chunk_ptr, chunk_col, col_chunk, combine_cols, u, partial, out, nchunks,
        ncombine, kmax, bm, bn, io, s);
  });
}

}  // extern "C"
