// mma.sync building blocks shared by the tensor-core kernels written for
// mma.sync.m16n8k16 (attention.cu's prefill, ffn.cu's FFN products, q8.cuh's
// decode GEMV): bf16 tiles in shared memory, XOR-swizzled by 16-byte chunk
// so that ldmatrix reads 8 rows at one chunk without bank conflicts, filled
// by cp.async.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace hipllama {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte chunk c of row r of a bf16 tile with CPR chunks a row, XOR-swizzled
// so that 8 consecutive rows at one chunk (an ldmatrix phase) hit 8
// different 16-byte bank groups
template <int CPR>
__device__ __forceinline__ int tile_chunk(int r, int c) {
  if (CPR >= 8) return r * CPR + (c ^ (r & 7));
  if (CPR == 4) return r * CPR + (c ^ ((r >> 1) & 3));
  return r * CPR + (c ^ ((r >> 2) & 1));
}

// cp.async of `bytes` (16, 8 or 4); zeros where !live (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool live) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(live ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(live ? BYTES : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t a, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), fp32
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16 x 8 bf16, row) * b (8 x 8 bf16, col) in fp32, summed from zero
__device__ __forceinline__ void mma_bf16_k8(float d[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.f));
}

// bf16(a) low, bf16(b) high
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace mma
}  // namespace hipllama
