// Helpers shared by the kernel sources (bsr_spmv.cu, bsr_window.cu, lane_gather.cu).
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

}  // namespace

extern "C" const char* linops_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
