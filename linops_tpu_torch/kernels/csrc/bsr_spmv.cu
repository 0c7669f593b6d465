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
// - K2: deterministic. The host builds, once per operator, the slots of the
//   flattened (nbrow*kmax) block list sorted stably by block column (`perm`)
//   and the offsets of each column in that order (`colptr`, nbcol+1 entries).
//   One thread block owns one (block column, tile of bn) output: thread
//   (x = n, y = j) sums blocks[slot, m, n] * u[row(slot), m] over the
//   column's slots in order and over m = j, j+blockDim.y, ...; the blockDim.y
//   partial sums are added in a fixed order through shared memory. No float
//   atomics, so the result is bit-identical from run to run.
//
// Accumulation is f32 for f32 and bf16 blocks; bf16 is widened per element.
// Element offsets are 64-bit (nbrow*kmax*bm*bn passes 2^31 soon after the
// 67M-value benchmark shape). Each entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError() of its launch.

#include "bsr_common.cuh"

namespace {

constexpr int kWarps = 8;  // K1: warps (output rows) per thread block

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

template <typename TB, typename TX>
__global__ void bsr_rmatvec_kernel(const TB* __restrict__ blocks,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ colptr,
                                   const TX* __restrict__ u, TX* __restrict__ out,
                                   int kmax, int bm, int bn) {
  extern __shared__ float partial[];  // blockDim.y * blockDim.x
  const int64_t c = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const int j = threadIdx.y;
  float acc = 0.f;
  if (n < bn) {
    const int s1 = colptr[c + 1];
    for (int s = colptr[c]; s < s1; ++s) {
      const int64_t slot = perm[s];
      const TB* blk = blocks + slot * bm * static_cast<int64_t>(bn) + n;
      const TX* urow = u + (slot / kmax) * bm;
      for (int m = j; m < bm; m += blockDim.y)
        acc = fmaf(widen(blk[static_cast<int64_t>(m) * bn]), widen(urow[m]), acc);
    }
  }
  partial[j * blockDim.x + threadIdx.x] = acc;
  __syncthreads();
  if (j == 0 && n < bn) {
    float total = 0.f;
    for (int q = 0; q < static_cast<int>(blockDim.y); ++q) total += partial[q * blockDim.x + threadIdx.x];
    out[c * bn + n] = narrow<TX>(total);
  }
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
int launch_rmatvec(const void* blocks, const void* perm, const void* colptr,
                   const void* u, void* out, int64_t nbcol, int kmax, int bm,
                   int bn, int tile_n, int split, cudaStream_t stream) {
  if (nbcol <= 0) return 0;
  if (nbcol > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(nbcol), static_cast<unsigned>((bn + tile_n - 1) / tile_n));
  const dim3 block(tile_n, split);
  const size_t shared = sizeof(float) * tile_n * split;
  bsr_rmatvec_kernel<TB, TX><<<grid, block, shared, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(colptr), static_cast<const TX*>(u),
      static_cast<TX*>(out), kmax, bm, bn);
  return static_cast<int>(cudaGetLastError());
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

int linops_bsr_rmatvec(const void* blocks, const void* perm, const void* colptr,
                       const void* u, void* out, int64_t nbcol, int kmax, int bm,
                       int bn, int tile_n, int split, int block_dtype,
                       int vec_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtypes(block_dtype, vec_dtype, [&](auto tb, auto tx) {
    using TB = typename decltype(tb)::type;
    using TX = typename decltype(tx)::type;
    return launch_rmatvec<TB, TX>(blocks, perm, colptr, u, out, nbcol, kmax, bm, bn,
                                  tile_n, split, s);
  });
}

}  // extern "C"
