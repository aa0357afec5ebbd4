// Shared helpers of the package's kernels: fp32 <-> storage-type conversion
// at the reference's cast points, and the error-string export each library
// carries for its Python wrapper (ops/_build.py::check).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hipllama {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as jnp's astype(bfloat16) and torch's .to(bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through the storage type T and widened back: a cast point
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// four consecutive elements of a T array (16-byte aligned for float,
// 8-byte for bf16), widened to fp32
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo); out[1] = __high2float(lo);
  out[2] = __low2float(hi); out[3] = __high2float(hi);
}

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace hipllama

#define HIPLLAMA_EXPORT_ERROR_STRING                                   \
  extern "C" const char* hipllama_error_string(int e) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(e));          \
  }
