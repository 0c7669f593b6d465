// BSR sparse matrix-vector products for Hopper (sm_90a), forward and transpose.
//
// K1 `linops_bsr_matvec` replaces linops_tpu/kernels/bsr_spmv.py::bsr_matvec_pallas:
//     y[r, m] = sum_k sum_n blocks[r, k, m, n] * x[block_cols[r, k], n]
// K2 `linops_bsr_rmatvec` replaces linops_tpu/kernels/bsr_spmv.py::bsr_rmatvec_pallas:
//     out[c, n] = sum_{(r,k): block_cols[r,k] = c} sum_m blocks[r, k, m, n] * u[r, m]
//
// Both are bound by the bytes of the stored blocks: every block value is read
// once and used in one multiply-add, far below the card's compute/byte ratio.
// So the design aims only at coalesced, once-only block reads:
//
// - K1: one warp per output row (r, m); a thread block holds kWarps warps, the
//   rows m0..m0+kWarps-1 of one block row (all of it when bm <= kWarps). Lanes
//   walk n, so each warp reads a contiguous row of bn block values per k. x is
//   read directly through block_cols: a Hopper gather is exact, so the TPU's
//   one-hot selector matmuls and the bf16 split of x have no counterpart here.
//   The warp sum is a shuffle tree: no atomics, no shared memory.
// - K2: deterministic, balanced over the stored blocks, no float atomics.
//   The host builds a column plan once per operator (bsr_spmv.py::
//   bsr_column_plan): the flattened (nbrow*kmax) slots sorted stably by block
//   column (`perm`), cut into chunks of at most S consecutive slots of one
//   column (`chunk_ptr`, `chunk_col`; S slots hold about 64 KB of blocks,
//   16 at 8x128 f32, more when the operator has more than 8192*S slots, so
//   no column has more than 8192 chunks), and each column's chunk range
//   (`col_chunk`). Two launches:
//   1. rmatvec_chunk_kernel, one thread block per (chunk, 128-wide n tile):
//      the block stages up to kStage of the chunk's slot offsets and block
//      rows in shared memory, then warp w takes m = w, w + kT2Warps, ... and
//      lane l the four n values 4l..4l+3 of each block row: kUnroll block
//      rows (of several slots, and for bm > kT2Warps several m) are loaded
//      at once (16-byte f32 or 8-byte bf16 loads, so 2-4 KB in flight per
//      warp) and multiplied by u[row(slot), m]. The warps'
//      partial sums are added in warp order through shared memory. A column
//      with one chunk gets its output row written here; every other chunk
//      writes an f32 partial row.
//   2. rmatvec_combine_kernel, one thread block per column with no chunk or
//      several: warp w sums the column's partial rows w, w + kT2Warps, ... in
//      order, the warps are added in warp order, and the row is written
//      (zeros for a column no slot reaches).
//   So a column of 2^19 slots is spread over thousands of thread blocks
//   (the old design walked it in one), and every sum has a fixed order: the
//   result is bit-identical from run to run. The partial rows (f32, one per
//   chunk) are the design's own bytes, about 1 % of the blocks' at 8x128.
//
// K2p `linops_bsr_rmatmat` is K2 over a panel of k columns, the block apply
// of a transpose (the reference runs jax.vmap of bsr_rmatvec_pallas there,
// one batched pallas_call): out[c, n, j] = sum blocks[r, k, m, n] * u[r, m, j].
// Its passes (bsr_common.cuh) keep K2's plan and order per column and read
// every stored block once per tile of kPanel columns, where k vector applies
// read it k times; column j is bit for bit K2 applied to column j.
//
// Accumulation is f32 for f32 and bf16 blocks; bf16 is widened per element.
// Element offsets are 64-bit (nbrow*kmax*bm*bn passes 2^31 soon after the
// 67M-value benchmark shape). Each entry point launches on the caller's stream,
// does not synchronise, and returns the first nonzero cudaGetLastError() of its
// launches.

#include "bsr_common.cuh"

namespace {

constexpr int kWarps = 8;    // K1: warps (output rows) per thread block
// K2's kT2Warps, kT2Tile, kStage, kUnroll and its passes: bsr_common.cuh

template <typename TB, typename TX>
__global__ void bsr_matvec_kernel(const TB* __restrict__ blocks,
                                  const int32_t* __restrict__ cols,
                                  const TX* __restrict__ x, TX* __restrict__ y,
                                  int kmax, int bm, int bn, int mgroups) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = blockIdx.x / mgroups;
  const int m = static_cast<int>(blockIdx.x % mgroups) * kWarps + warp;
  if (m >= bm) return;  // the whole warp leaves; nothing below synchronises
  float acc = 0.f;
  for (int k = 0; k < kmax; ++k) {
    const int64_t slot = r * kmax + k;
    const TB* brow = blocks + (slot * bm + m) * static_cast<int64_t>(bn);
    const TX* xrow = x + static_cast<int64_t>(cols[slot]) * bn;
    for (int n = lane; n < bn; n += 32) acc = fmaf(widen(brow[n]), widen(xrow[n]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) y[r * bm + m] = narrow<TX>(acc);
}

// K2 pass 1 (column_chunk_pass, bsr_common.cuh). Registers capped so that
// four thread blocks (32 warps) fit an SM.
template <typename TB, typename TX, int US, int UM>
__global__ void __launch_bounds__(kT2Warps * 32, 4)
rmatvec_chunk_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ chunk_ptr,
                     const int32_t* __restrict__ chunk_col,
                     const int32_t* __restrict__ col_chunk, const TX* __restrict__ u,
                     float* __restrict__ partial, TX* __restrict__ out, int kmax, int bm,
                     int bn, bool vec) {
  column_chunk_pass<TB, TX, US, UM>(blocks, perm, chunk_ptr, chunk_col, col_chunk, u, partial,
                                    out, kmax, bm, bn, vec);
}

// K2 pass 2 (column_combine_pass).
template <typename TX>
__global__ void __launch_bounds__(kT2Warps * 32)
rmatvec_combine_kernel(const float* __restrict__ partial, const int32_t* __restrict__ cols,
                       const int32_t* __restrict__ col_chunk, TX* __restrict__ out, int bn,
                       bool vec) {
  column_combine_pass<TX>(partial, cols, col_chunk, out, bn, vec);
}

// K2p pass 1 and pass 2 (panel_chunk_pass, panel_combine_pass; bsr_common.cuh):
// K2 over a panel of columns, under names of their own. The chunk pass's
// registers are capped at 85 (three thread blocks an SM; see bsr_common.cuh).
template <typename TB, typename TX, int US, int UM>
__global__ void __launch_bounds__(kT2Warps * 32, 3)
rmatmat_chunk_kernel(const TB* __restrict__ blocks, const int32_t* __restrict__ perm,
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
rmatmat_combine_kernel(const float* __restrict__ partial, const int32_t* __restrict__ cols,
                       const int32_t* __restrict__ col_chunk, TX* __restrict__ out, int bn,
                       PanelIO io) {
  panel_combine_pass<TX>(partial, cols, col_chunk, out, bn, io);
}

template <typename TB, typename TX>
int launch_matvec(const void* blocks, const void* cols, const void* x, void* y,
                  int64_t nbrow, int kmax, int bm, int bn, cudaStream_t stream) {
  const int mgroups = (bm + kWarps - 1) / kWarps;
  const int64_t grid = nbrow * mgroups;
  if (grid <= 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  bsr_matvec_kernel<TB, TX><<<static_cast<unsigned>(grid), kWarps * 32, 0, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const int32_t*>(cols),
      static_cast<const TX*>(x), static_cast<TX*>(y), kmax, bm, bn, mgroups);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB, typename TX>
int launch_rmatvec(const void* blocks, const void* perm, const void* chunk_ptr,
                   const void* chunk_col, const void* col_chunk, const void* combine_cols,
                   const void* u, float* partial, void* out, int64_t nchunks,
                   int64_t ncombine, int kmax, int bm, int bn, cudaStream_t stream) {
  return launch_column_plan<TB, TX>(
      rmatvec_chunk_kernel<TB, TX, kUnroll, 1>, rmatvec_chunk_kernel<TB, TX, 1, kUnroll>,
      rmatvec_combine_kernel<TX>, blocks, perm, chunk_ptr, chunk_col, col_chunk, combine_cols,
      u, partial, out, nchunks, ncombine, kmax, bm, bn, stream);
}

template <typename TB, typename TX>
int launch_rmatmat(const void* blocks, const void* perm, const void* chunk_ptr,
                   const void* chunk_col, const void* col_chunk, const void* combine_cols,
                   const void* u, float* partial, void* out, int64_t nchunks,
                   int64_t ncombine, int kmax, int bm, int bn, PanelIO io, cudaStream_t stream) {
  return launch_panel_plan<TB, TX>(
      rmatmat_chunk_kernel<TB, TX, kUnroll, 1>, rmatmat_chunk_kernel<TB, TX, 1, kUnroll>,
      rmatmat_combine_kernel<TX>, blocks, perm, chunk_ptr, chunk_col, col_chunk, combine_cols,
      u, partial, out, nchunks, ncombine, kmax, bm, bn, io, stream);
}

}  // namespace

// dtype codes: see bsr_common.cuh (dispatch_dtypes).
extern "C" {

int linops_bsr_matvec(const void* blocks, const void* cols, const void* x, void* y,
                      int64_t nbrow, int kmax, int bm, int bn, int block_dtype,
                      int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_matvec<TB, TX>(blocks, cols, x, y, nbrow, kmax, bm, bn, s);
  });
}

// K2. perm, chunk_ptr, chunk_col, col_chunk, combine_cols: the column plan
// (bsr_spmv.py::bsr_column_plan); partial is (nchunks, bn) f32 scratch; out
// is (nbcol, bn).
int linops_bsr_rmatvec(const void* blocks, const void* perm, const void* chunk_ptr,
                       const void* chunk_col, const void* col_chunk, const void* combine_cols,
                       const void* u, float* partial, void* out, int64_t nchunks,
                       int64_t ncombine, int kmax, int bm, int bn, int block_dtype,
                       int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_rmatvec<TB, TX>(blocks, perm, chunk_ptr, chunk_col, col_chunk, combine_cols,
                                  u, partial, out, nchunks, ncombine, kmax, bm, bn, s);
  });
}

// K2p. K2's column plan over k columns: u[row, j] at u[row * u_rs + j * u_cs]
// (row < nbrow bm), out[row, j] at out[row * o_rs + j * o_cs] (row < nbcol
// bn); partial is (nchunks, k, bn) f32 scratch.
int linops_bsr_rmatmat(const void* blocks, const void* perm, const void* chunk_ptr,
                       const void* chunk_col, const void* col_chunk, const void* combine_cols,
                       const void* u, float* partial, void* out, int64_t nchunks,
                       int64_t ncombine, int kmax, int bm, int bn, int k, int64_t u_rs,
                       int64_t u_cs, int64_t o_rs, int64_t o_cs, int block_dtype,
                       int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PanelIO io{u_rs, u_cs, o_rs, o_cs, k};
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_rmatmat<TB, TX>(blocks, perm, chunk_ptr, chunk_col, col_chunk, combine_cols,
                                  u, partial, out, nchunks, ncombine, kmax, bm, bn, io, s);
  });
}

}  // extern "C"
