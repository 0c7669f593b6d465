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
// (row, column) strides, a stored block read once per column tile (8
// columns for k <= 8, else 16, as the caller passes it). K4p's phase 1
// (window_panel_partial_kernel) is window_partial_kernel over a tile: a
// warp per (partial row, 128-wide n tile) walks its slot list's block rows
// (slot by slot, m ascending) through a ring of its own in shared memory,
// kWinStages stages of 8 rows: lane 0 issues the bulk copies
// (cp.async.bulk on the stage's mbarrier) of the stage kWinStages - 1
// ahead while the warp multiplies the current one, and the lanes load that
// stage's u values into registers then and store them after, so each lane
// reads u as a shared-memory broadcast and holds only its accumulators (the
// first panel walk held 8 loaded rows and handed out u by shuffles: two
// thread blocks an SM, no loads in flight while it multiplied). A row the bulk copy
// cannot take (bn x the value size not a multiple of 16, an unaligned base)
// is staged by the lanes' plain loads just before it is multiplied: the
// ragged path of the same kernel. Its partials are (ngroups 2 wb, k, bn)
// f32, and its combine takes one thread per (c, n), as K4's, with K4's
// binary searches once and strided_sum for every column. K6p runs K2p's
// panel passes (bsr_common.cuh: the chunk pass's ring, a producer per
// stage) over K6's column plan. Both keep the vector kernel's order per
// column (K4p: slots in list order, m ascending, per n value; K6p: K2p's
// contract): column j is bit for bit K4 (K6) applied to column j, whatever
// the tile or the path.
//
// Forward panel forms (the block apply of a forward, jax.vmap of the vector
// kernel in the reference): K3p `linops_bsr_matmat_windowed` and K5p
// `linops_bsr_matmat_multiwin` give y[r, m, j] for every column j < k of x,
// x and y addressed through (row, column) strides. They run K1p's body
// (forward_panel_chunk, bsr_common.cuh) with a slot's x row found through the
// plan as K3 and K5 find it (K3: q[g] wb + cols_local, none outside both
// windows; K5: the lane row's window, none for -1), read from L2 where the
// vector kernels stage one vector's windows in shared memory: a panel's
// windows are kPanel times larger than shared memory holds at the plans'
// widths (design notes in bsr_common.cuh). A warp per 8 output rows, as
// K1p, so a thread block's working set does not grow with the group. Both
// keep the vector kernel's order per column: column j is bit for bit K3
// (K5) applied to column j.
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

// K3p: forward_panel_chunk with slot (r, k) of group g = r / R reading x's
// block row q[g] wb + cols_local[slot], and nothing outside both windows.
template <typename TB, typename TX>
__global__ void __launch_bounds__(kFwdWarps * 32)
bsr_matmat_windowed_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ cols_local,
                           const int32_t* __restrict__ win_q, const TX* __restrict__ x,
                           TX* __restrict__ y, int64_t x_rows, int64_t nbrow, int R, int kmax,
                           int bm, int bn, int wb, PanelIO io) {
  int64_t r;
  int m0;
  if (!forward_chunk(nbrow, bm, &r, &m0)) return;  // whole warps; nothing below synchronises
  const int64_t base = static_cast<int64_t>(win_q[r / R]) * wb;
  const int span = 2 * wb;
  forward_panel_chunk(blocks, x, y, r, m0, kmax, bm, bn, x_rows,
                      [cols_local, base, span](int64_t slot) -> int64_t {
                        const int l = cols_local[slot];
                        return l < 0 || l >= span ? -1 : base + l;
                      },
                      io);
}

// K5p: forward_panel_chunk with a slot's lane row l = w wb + c % wb
// (bsr_multiwin_index) reading x's block row q[w, g] wb + l % wb, and
// nothing for l = -1.
template <typename TB, typename TX>
__global__ void __launch_bounds__(kFwdWarps * 32)
bsr_matmat_multiwin_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ lane_rows,
                           const int32_t* __restrict__ win_q, const TX* __restrict__ x,
                           TX* __restrict__ y, int64_t x_rows, int64_t nbrow, int ngroups,
                           int nwin, int R, int kmax, int bm, int bn, int wb, PanelIO io) {
  int64_t r;
  int m0;
  if (!forward_chunk(nbrow, bm, &r, &m0)) return;  // whole warps; nothing below synchronises
  const int64_t g = r / R;
  const int span = nwin * wb;
  forward_panel_chunk(blocks, x, y, r, m0, kmax, bm, bn, x_rows,
                      [lane_rows, win_q, g, ngroups, span, wb](int64_t slot) -> int64_t {
                        const int l = lane_rows[slot];
                        if (l < 0 || l >= span) return -1;
                        const int w = l / wb;
                        return static_cast<int64_t>(win_q[static_cast<int64_t>(w) * ngroups + g]) *
                                   wb + (l - w * wb);
                      },
                      io);
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

// K4p's per-warp ring: kWinStages stages of kWinRows block rows of one n
// tile, then their u values (kWinRows x TJ, f32), in the warp's own slice of
// dynamic shared memory (warp_bytes each).
constexpr int kWinStages = 3;  // K4p: stages in a warp's ring
constexpr int kWinRows = 8;    // K4p: block rows a stage holds (one 8x128 block)

template <typename TB>
Ring window_ring(bool bulk, int bn, int tj, size_t* warp_bytes) {
  Ring g;
  g.bulk = bulk;
  g.whole = bn <= kTile;
  g.pitch = g.whole ? (bn + 3) / 4 * 4 : kTile;
  g.rows = kWinRows;
  g.red_off = 0;  // K4p keeps its sums in registers
  const size_t ring_bytes = static_cast<size_t>(kWinStages) * kWinRows * g.pitch * sizeof(TB);
  const size_t u_off = (ring_bytes + 15) / 16 * 16;
  g.u_off = static_cast<int>(u_off);
  *warp_bytes = u_off + static_cast<size_t>(kWinStages) * kWinRows * tj * sizeof(float);
  return g;
}

// K4p phase 1: window_partial_kernel over a panel; blockIdx.y = column tile
// of TJ columns. A warp takes partial row i and a 128-wide n tile, as K4's,
// and walks the rows (slot, m) of its list perm[ptr[i] .. ptr[i+1]], slot by
// slot and m ascending, through its own ring: lane 0 issues the bulk copies
// of stage t + kWinStages - 1 and the lanes load its u values into
// registers while the warp multiplies stage t, then store them. The ragged
// path (Ring::bulk false) copies each stage by plain loads just before it is
// multiplied. A lane holds four consecutive n values (where K4's lane holds
// n0 + 32 t: which lane holds an output does not change its sum), and
// partial[(i k + j) bn + n] is written in f32.
template <typename TB, typename TX, int TJ>
__global__ void __launch_bounds__(kPartialWarps * 32, 2)
window_panel_partial_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ ptr, const TX* __restrict__ u,
                            float* __restrict__ partial, int64_t nrows, int ntiles, int kmax,
                            int bm, int bn, Ring ring, int warp_bytes, PanelIO io) {
  static_assert(kWinRows * TJ == 32 * (TJ / 4), "a lane stages TJ / 4 u values of a stage");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kPartialWarps][kWinStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * kPartialWarps + warp;
  if (wid >= nrows * ntiles) return;  // whole warps leave; nothing below syncs the block
  const int64_t i = wid / ntiles;
  const int t0 = static_cast<int>(wid % ntiles) * kTile;
  const int width = min(kTile, bn - t0);
  const int n0 = 4 * lane;
  const int j0 = blockIdx.y * TJ;
  const int kw = min(TJ, io.k - j0);
  const int e0 = ptr[i];
  const int rows = (ptr[i + 1] - e0) * bm;
  const int nst = (rows + kWinRows - 1) / kWinRows;
  const int stage_vals = kWinRows * ring.pitch;
  const int64_t bsize = static_cast<int64_t>(bm) * bn;
  unsigned char* mine = smem + static_cast<int64_t>(warp) * warp_bytes;
  TB* ring_b = reinterpret_cast<TB*>(mine);
  float* ring_u = reinterpret_cast<float*>(mine + ring.u_off);
  uint64_t* bar = full[warp];
  if (lane == 0) {
    for (int s = 0; s < kWinStages; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
  }
  __syncwarp();
  // element offset of the n tile of list row r
  auto row_of = [&](int r) -> int64_t {
    const int e = r / bm, m = r - e * bm;
    return perm[e0 + e] * bsize + static_cast<int64_t>(m) * bn + t0;
  };
  auto issue = [&](int t) {  // stage t's bulk copies, by lane 0
    if (lane != 0) return;
    const int st = t % kWinStages, r0 = t * kWinRows, nr = min(kWinRows, rows - r0);
    TB* dst = ring_b + st * stage_vals;
    fence_proxy_async();  // the warp's reads of this stage (before the __syncwarp) come first
    mbar_arrive_tx(&bar[st], nr * width * static_cast<unsigned>(sizeof(TB)));
    if (ring.whole) {  // one copy per slot's run of rows
      for (int r = 0; r < nr;) {
        const int e = (r0 + r) / bm, m = r0 + r - e * bm, n = min(bm - m, nr - r);
        bulk_load(dst + r * ring.pitch, blocks + perm[e0 + e] * bsize + static_cast<int64_t>(m) * bn,
                  n * bn * static_cast<unsigned>(sizeof(TB)), &bar[st]);
        r += n;
      }
    } else {
      for (int r = 0; r < nr; ++r)
        bulk_load(dst + r * ring.pitch, blocks + row_of(r0 + r),
                  width * static_cast<unsigned>(sizeof(TB)), &bar[st]);
    }
  };
  // a lane's TJ / 4 u values of stage t: row lane / 4, columns (lane % 4) TJ / 4 + c
  const int ur = lane >> 2, uc = (lane & 3) * (TJ / 4);
  auto load_u = [&](int t, float up[TJ / 4]) {
    const int r = t * kWinRows + ur;
#pragma unroll
    for (int c = 0; c < TJ / 4; ++c) up[c] = 0.f;
    if (r < rows) {
      const int e = r / bm, m = r - e * bm;
      const TX* p = u + (static_cast<int64_t>(perm[e0 + e]) / kmax * bm + m) * io.u_rs +
                    (j0 + uc) * io.u_cs;
#pragma unroll
      for (int c = 0; c < TJ / 4; ++c)
        if (uc + c < kw) up[c] = widen(p[c * io.u_cs]);
    }
  };
  auto store_u = [&](int t, const float up[TJ / 4]) {
    float* d = ring_u + (t % kWinStages) * kWinRows * TJ + ur * TJ + uc;
#pragma unroll
    for (int c = 0; c < TJ / 4; ++c) d[c] = up[c];
  };
  float acc[TJ][4];
#pragma unroll
  for (int j = 0; j < TJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int t = 0; t < kWinStages - 1 && t < nst; ++t) {
    if (ring.bulk) issue(t);
    float up[TJ / 4];
    load_u(t, up);
    store_u(t, up);
  }
  __syncwarp();
  for (int t = 0; t < nst; ++t) {
    const int st = t % kWinStages, tp = t + kWinStages - 1;
    float up[TJ / 4];
    if (tp < nst) {
      if (ring.bulk) issue(tp);  // into the stage the warp finished at t - 1
      load_u(tp, up);
    }
    const int r0 = t * kWinRows, nr = min(kWinRows, rows - r0);
    TB* sb = ring_b + st * stage_vals;
    if (ring.bulk) {
      mbar_wait(&bar[st], (t / kWinStages) & 1);
    } else {
      stage_rows_plain(sb, blocks, nr, width, ring.pitch, [&](int r) { return row_of(r0 + r); });
      __syncwarp();
    }
    const float* su = ring_u + st * kWinRows * TJ;
    for (int r = 0; r < nr; ++r)
      ring_row<TB, TJ>(sb + r * ring.pitch, su + r * TJ, n0, width, kw, acc);
    if (tp < nst) store_u(tp, up);
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < TJ; ++j)
    if (j < kw) store_n4(partial + (i * io.k + j0 + j) * bn, t0 + n0, bn, bn % 4 == 0, acc[j]);
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
template <typename TB, typename TX, int TJ>
__global__ void __launch_bounds__(kRingThreads, 2)
multiwin_panel_chunk_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ chunk_ptr,
                            const int32_t* __restrict__ chunk_col,
                            const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                            float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm,
                            int bn, Ring ring, PanelIO io, PanelItems items) {
  panel_chunk_pass<TB, TX, TJ>(blocks, perm, chunk_ptr, chunk_col, col_chunk, u, partial, out,
                               kmax, bm, bn, ring, io, items);
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
                                int k, int tile, int bulk, int64_t u_rs, int64_t u_cs,
                                int64_t o_rs, int64_t o_cs, int block_dtype, int vec_dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || (k + kPanel - 1) / kPanel > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const PanelIO io{u_rs, u_cs, o_rs, o_cs, k};
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    if (!panel_staging_ok<TB>(blocks, bn, tile, bulk))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t nrows = static_cast<int64_t>(ngroups) * 2 * wb;
    const int ntiles = (bn + kTile - 1) / kTile;
    unsigned grid;
    if (int rc = grid_or_error((nrows * ntiles + kPartialWarps - 1) / kPartialWarps, &grid))
      return rc;
    if (grid > 0) {
      size_t warp_bytes;
      const Ring ring = window_ring<TB>(bulk != 0, bn, tile, &warp_bytes);
      const size_t smem = warp_bytes * kPartialWarps;
      auto kernel = tile == 8 ? window_panel_partial_kernel<TB, TX, 8>
                              : window_panel_partial_kernel<TB, TX, 16>;
      if (int rc = set_dynamic_smem(kernel, smem)) return rc;
      const dim3 g2(grid, static_cast<unsigned>((k + tile - 1) / tile));
      kernel<<<g2, kPartialWarps * 32, smem, s>>>(
          static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
          static_cast<const int32_t*>(ptr), static_cast<const TX*>(u), partial, nrows, ntiles,
          kmax, bm, bn, ring, static_cast<int>(warp_bytes), io);
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
                                int bn, int k, int tile, int bulk, int64_t u_rs, int64_t u_cs,
                                int64_t o_rs, int64_t o_cs, int block_dtype, int vec_dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PanelIO io{u_rs, u_cs, o_rs, o_cs, k};
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_panel_plan<TB, TX>(
        multiwin_panel_chunk_kernel<TB, TX, 8>, multiwin_panel_chunk_kernel<TB, TX, 16>,
        multiwin_panel_combine_kernel<TX>, blocks, perm, chunk_ptr, chunk_col, col_chunk,
        combine_cols, u, partial, out, nchunks, ncombine, kmax, bm, bn, io, tile, bulk != 0, s);
  });
}

// K3p. K3's plan over k columns: x[row, j] at x[row * x_rs + j * x_cs]
// (row < x_rows bn; window rows past it read as zeros), y[row, j] at
// y[row * y_rs + j * y_cs] (row < nbrow bm). nbrow = ngroups * R.
int linops_bsr_matmat_windowed(const void* blocks, const void* cols_local, const void* win_q,
                               const void* x, void* y, int64_t x_rows, int64_t nbrow,
                               int ngroups, int kmax, int bm, int bn, int wb, int k,
                               int64_t x_rs, int64_t x_cs, int64_t y_rs, int64_t y_cs,
                               int block_dtype, int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ngroups <= 0 || nbrow % ngroups || wb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (int rc = forward_panel_grid(nbrow, bm, k, &grid)) return rc;
  if (grid.x == 0) return 0;
  const PanelIO io{x_rs, x_cs, y_rs, y_cs, k};
  const int R = static_cast<int>(nbrow / ngroups);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    bsr_matmat_windowed_kernel<TB, TX><<<grid, kFwdWarps * 32, 0, s>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(cols_local),
        static_cast<const int32_t*>(win_q), static_cast<const TX*>(x), static_cast<TX*>(y),
        x_rows, nbrow, R, kmax, bm, bn, wb, io);
    return static_cast<int>(cudaGetLastError());
  });
}

// K5p. K5's plan over k columns; win_q is (nwin, ngroups), lane_rows (nbrow,
// kmax) (bsr_multiwin_index); x, y as K3p's.
int linops_bsr_matmat_multiwin(const void* blocks, const void* lane_rows, const void* win_q,
                               const void* x, void* y, int64_t x_rows, int64_t nbrow,
                               int ngroups, int nwin, int kmax, int bm, int bn, int wb, int k,
                               int64_t x_rs, int64_t x_cs, int64_t y_rs, int64_t y_cs,
                               int block_dtype, int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ngroups <= 0 || nbrow % ngroups || wb <= 0 || nwin < 1 || nwin > kMaxWindows)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (int rc = forward_panel_grid(nbrow, bm, k, &grid)) return rc;
  if (grid.x == 0) return 0;
  const PanelIO io{x_rs, x_cs, y_rs, y_cs, k};
  const int R = static_cast<int>(nbrow / ngroups);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    bsr_matmat_multiwin_kernel<TB, TX><<<grid, kFwdWarps * 32, 0, s>>>(
        static_cast<const TB*>(blocks), static_cast<const int32_t*>(lane_rows),
        static_cast<const int32_t*>(win_q), static_cast<const TX*>(x), static_cast<TX*>(y),
        x_rows, nbrow, ngroups, nwin, R, kmax, bm, bn, wb, io);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
