// KV cache writers for the dense cache (B, L, KVH, S, HS), in place: fp32,
// bf16, or int8 with one fp32 scale per row in (B, L, KVH, S) planes.
//
// kv_commit_rows replaces hip_llama_tpu/ops/cache.py::kv_commit_rows (dense
// branch): one decode step's K and V rows, (L, B, KVH, HS) each, land at
// (b, l, :, pos[b], :) for every layer, in ONE launch for both planes.
// kv_commit_rows_int8 is its int8 branch (_kv_commit_kernel, quantized):
// the fp32 or bf16 rows are quantized in the kernel, one warp per (layer,
// slot, head) row: scale = absmax * fp32(1/127), q = round-half-even(x /
// scale) (IEEE division); the int8 row and its scale land together. The
// JAX package writes absmax / 127.0 (cache.py:264-273, :553), which XLA
// compiles into that product with the reciprocal; ops/cache.py::
// quantize_kv_rows, the plain version, computes the same.
// kv_write_rows replaces hip_llama_tpu/ops/cache.py::kv_write_rows (K8):
// one plane's step rows (L, B, KVH, HS), in the plane's dtype (int8 rows
// arrive quantized by quantize_kv_rows), land at (b, l, :, pos[b], :) for
// every layer, skipping a slot whose valid[b] is 0; scale_write_rows
// replaces cache.py::scale_write_rows (K9): one scale plane's (L, B, KVH)
// fp32 row scales at (b, l, :, pos[b]). Together with quantize_kv_rows they
// are the four-write commit the JAX step takes where K2 does not run
// (HIPLLAMA_KV_COMMIT=0): one launch per plane, as there.
// kv_write_chunk replaces hip_llama_tpu/ops/cache.py::kv_write_chunk: one
// layer's prefill chunk rows, (B, T, KVH, HS) in the cache's dtype, land at
// start[b] + j for j < valid[b] and start[b] + j < S, K and V in one launch
// per layer. scale_write_chunk replaces cache.py::scale_write_chunk: the
// chunk's (B, T, KVH) fp32 scales under the same rule, both planes in one
// launch.
//
// Bound: bytes. Each moves its rows once in and once out (read the rows,
// write as many cache bytes); the int8 commit adds an absmax and a divide
// per element, far below the card's arithmetic rate. The TPU kernels
// read-modify-write aligned windows because a TPU DMA cannot address one
// row; on the card every thread stores its piece straight to the row (16
// bytes where the row's size allows), so the cache is never read.
// Positions outside [0, S) write nothing.
//
// The paged pool (L, KVH, P, PS, HS), fp32 scale planes (L, KVH, P, PS) on
// int8 pages, takes the same writers through a page table (B, max_pages):
// kv_write_rows_paged replaces hip_llama_tpu/ops/cache.py::
// kv_write_rows_paged: one decode step's rows (L, B, KVH, HS) land at page
// table[b, pos[b] / PS], offset pos[b] % PS, for every slot (an idle slot's
// table names the trash page), K and V in one launch; int8 rows arrive
// quantized (quantize_kv_rows), as the JAX step quantizes before its
// writer. scale_write_rows_paged (cache.py::scale_write_rows_paged) writes
// their (L, B, KVH) scales, both planes in one launch. kv_write_chunk_paged
// (cache.py::kv_write_chunk_paged) writes one layer's chunk rows (B, T,
// KVH, HS), T <= PS, row j < valid[b] of slot b at page table[b, start[b] /
// PS], offset j (the chunk starts on a page boundary); valid 0 leaves a
// slot's pages alone. scale_write_chunk_paged (cache.py::
// scale_write_chunk_paged) writes the chunk's (B, T, KVH) scales by the
// same rule, both planes in one launch. The TPU kernels read-modify-write
// a window or the whole page; these store the rows alone. A position past
// the table writes nothing.

#include <stdint.h>

#include "common.cuh"

namespace {

using hipllama::to_f;
using hipllama::warp_max;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // grid-stride: a few waves of the SMs

// The row copies move opaque units V (16, 8, 4, 2 or 1 bytes: the widest
// that divides a row's bytes), whatever the element type. One plane's step
// rows (L, B, KVH, row_units) to (b, l, :, pos[b]), grid-stride along x.
template <typename V>
__device__ __forceinline__ void write_step_rows(V* __restrict__ cache,
                                                const V* __restrict__ rows,
                                                const int* __restrict__ pos,
                                                const int* __restrict__ valid, int B, int L,
                                                int KVH, int S, int row_units) {
  const long long n = (long long)L * B * KVH * row_units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int dv = (int)(e % row_units);
    long long r = e / row_units;
    const int g = (int)(r % KVH);
    r /= KVH;
    const int b = (int)(r % B);
    const int l = (int)(r / B);
    if (valid != nullptr && valid[b] == 0) continue;
    const int p = pos[b];
    if (p < 0 || p >= S) continue;
    cache[((((long long)b * L + l) * KVH + g) * S + p) * row_units + dv] = rows[e];
  }
}

// K2, dense planes: grid row 0 writes K, row 1 V
template <typename V>
__global__ void __launch_bounds__(kThreads) kv_commit_rows_kernel(
    void* __restrict__ k_cache, void* __restrict__ v_cache,
    const void* __restrict__ k_rows, const void* __restrict__ v_rows,
    const int* __restrict__ pos, const int* __restrict__ valid,
    int B, int L, int KVH, int S, int row_units) {
  write_step_rows<V>(static_cast<V*>(blockIdx.y == 0 ? k_cache : v_cache),
                     static_cast<const V*>(blockIdx.y == 0 ? k_rows : v_rows), pos, valid, B,
                     L, KVH, S, row_units);
}

// K8: one plane of any dtype
template <typename V>
__global__ void __launch_bounds__(kThreads) kv_write_rows_kernel(
    void* __restrict__ cache, const void* __restrict__ rows, const int* __restrict__ pos,
    const int* __restrict__ valid, int B, int L, int KVH, int S, int row_units) {
  write_step_rows<V>(static_cast<V*>(cache), static_cast<const V*>(rows), pos, valid, B, L, KVH,
                     S, row_units);
}

// K9: one scale plane (B, L, KVH, S), rows (L, B, KVH)
__global__ void __launch_bounds__(kThreads) scale_write_rows_kernel(
    float* __restrict__ scale, const float* __restrict__ srows, const int* __restrict__ pos,
    int B, int L, int KVH, int S) {
  const long long n = (long long)L * B * KVH;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int g = (int)(e % KVH);
    const int b = (int)((e / KVH) % B);
    const int l = (int)(e / ((long long)KVH * B));
    const int p = pos[b];
    if (p < 0 || p >= S) continue;
    scale[(((long long)b * L + l) * KVH + g) * S + p] = srows[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) kv_commit_rows_int8_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const T* __restrict__ k_rows, const T* __restrict__ v_rows,
    const int* __restrict__ pos, const int* __restrict__ valid,
    int B, int L, int KVH, int S, int HS) {
  const T* rows = blockIdx.y == 0 ? k_rows : v_rows;
  int8_t* cache = blockIdx.y == 0 ? k_cache : v_cache;
  float* scales = blockIdx.y == 0 ? k_scale : v_scale;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)L * B * KVH;  // rows, one warp each
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32; r < n; r += warps) {
    const int g = (int)(r % KVH);
    const int b = (int)((r / KVH) % B);
    const int l = (int)(r / ((long long)KVH * B));
    // warp-uniform: every lane holds the same row r
    if (valid != nullptr && valid[b] == 0) continue;
    const int p = pos[b];
    if (p < 0 || p >= S) continue;
    const T* row = rows + r * HS;
    float am = 0.f;
    for (int i = lane; i < HS; i += 32) am = fmaxf(am, fabsf(to_f(row[i])));
    am = warp_max(am);
    const float sc = am == 0.f ? 1.f : am * (1.0f / 127.0f);
    const long long dst = (((long long)b * L + l) * KVH + g) * S + p;
    for (int i = lane; i < HS; i += 32)
      cache[dst * HS + i] = (int8_t)__float2int_rn(to_f(row[i]) / sc);
    if (lane == 0) scales[dst] = sc;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) kv_write_chunk_kernel(
    void* __restrict__ k_cache, void* __restrict__ v_cache,
    const void* __restrict__ k_rows, const void* __restrict__ v_rows,
    const int* __restrict__ start, const int* __restrict__ valid,
    int B, int L, int KVH, int S, int row_units, int T_len, int layer) {
  const V* rows = static_cast<const V*>(blockIdx.y == 0 ? k_rows : v_rows);
  V* cache = static_cast<V*>(blockIdx.y == 0 ? k_cache : v_cache);
  const long long n = (long long)B * T_len * KVH * row_units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int dv = (int)(e % row_units);
    long long r = e / row_units;
    const int g = (int)(r % KVH);
    r /= KVH;
    const int t = (int)(r % T_len);
    const int b = (int)(r / T_len);
    if (t >= valid[b]) continue;
    const int p = start[b] + t;
    if (p < 0 || p >= S) continue;
    cache[((((long long)b * L + layer) * KVH + g) * S + p) * row_units + dv] = rows[e];
  }
}

__global__ void __launch_bounds__(kThreads) scale_write_chunk_kernel(
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const float* __restrict__ k_srows, const float* __restrict__ v_srows,
    const int* __restrict__ start, const int* __restrict__ valid,
    int B, int L, int KVH, int S, int T_len, int layer) {
  const float* src = blockIdx.y == 0 ? k_srows : v_srows;
  float* dst = blockIdx.y == 0 ? k_scale : v_scale;
  const long long n = (long long)B * T_len * KVH;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int g = (int)(e % KVH);
    const int t = (int)((e / KVH) % T_len);
    const int b = (int)(e / ((long long)KVH * T_len));
    if (t >= valid[b]) continue;
    const int p = start[b] + t;
    if (p < 0 || p >= S) continue;
    dst[(((long long)b * L + layer) * KVH + g) * S + p] = src[e];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) kv_write_rows_paged_kernel(
    void* __restrict__ k_pages, void* __restrict__ v_pages,
    const void* __restrict__ k_rows, const void* __restrict__ v_rows,
    const int* __restrict__ table, const int* __restrict__ pos,
    int B, int L, int KVH, int P, int PS, int max_pages, int row_units) {
  const V* rows = static_cast<const V*>(blockIdx.y == 0 ? k_rows : v_rows);
  V* pages = static_cast<V*>(blockIdx.y == 0 ? k_pages : v_pages);
  const long long n = (long long)L * B * KVH * row_units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int dv = (int)(e % row_units);
    long long r = e / row_units;
    const int g = (int)(r % KVH);
    r /= KVH;
    const int b = (int)(r % B);
    const int l = (int)(r / B);
    const int p = pos[b];
    if (p < 0 || p >= max_pages * PS) continue;
    const int page = table[(long long)b * max_pages + p / PS];
    pages[((((long long)l * KVH + g) * P + page) * PS + p % PS) * row_units + dv] = rows[e];
  }
}

__global__ void __launch_bounds__(kThreads) scale_write_rows_paged_kernel(
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const float* __restrict__ k_srows, const float* __restrict__ v_srows,
    const int* __restrict__ table, const int* __restrict__ pos,
    int B, int L, int KVH, int P, int PS, int max_pages) {
  const float* src = blockIdx.y == 0 ? k_srows : v_srows;
  float* dst = blockIdx.y == 0 ? k_scale : v_scale;
  const long long n = (long long)L * B * KVH;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int g = (int)(e % KVH);
    const int b = (int)((e / KVH) % B);
    const int l = (int)(e / ((long long)KVH * B));
    const int p = pos[b];
    if (p < 0 || p >= max_pages * PS) continue;
    const int page = table[(long long)b * max_pages + p / PS];
    dst[(((long long)l * KVH + g) * P + page) * PS + p % PS] = src[e];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) kv_write_chunk_paged_kernel(
    void* __restrict__ k_pages, void* __restrict__ v_pages,
    const void* __restrict__ k_rows, const void* __restrict__ v_rows,
    const int* __restrict__ table, const int* __restrict__ start, const int* __restrict__ valid,
    int B, int KVH, int P, int PS, int max_pages, int row_units, int T_len, int layer) {
  const V* rows = static_cast<const V*>(blockIdx.y == 0 ? k_rows : v_rows);
  V* pages = static_cast<V*>(blockIdx.y == 0 ? k_pages : v_pages);
  const long long n = (long long)B * T_len * KVH * row_units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int dv = (int)(e % row_units);
    long long r = e / row_units;
    const int g = (int)(r % KVH);
    r /= KVH;
    const int t = (int)(r % T_len);
    const int b = (int)(r / T_len);
    if (t >= valid[b]) continue;
    const int s = start[b];
    if (s < 0 || s >= max_pages * PS) continue;
    const int page = table[(long long)b * max_pages + s / PS];
    pages[((((long long)layer * KVH + g) * P + page) * PS + t) * row_units + dv] = rows[e];
  }
}

__global__ void __launch_bounds__(kThreads) scale_write_chunk_paged_kernel(
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const float* __restrict__ k_srows, const float* __restrict__ v_srows,
    const int* __restrict__ table, const int* __restrict__ start, const int* __restrict__ valid,
    int B, int KVH, int P, int PS, int max_pages, int T_len, int layer) {
  const float* src = blockIdx.y == 0 ? k_srows : v_srows;
  float* dst = blockIdx.y == 0 ? k_scale : v_scale;
  const long long n = (long long)B * T_len * KVH;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int g = (int)(e % KVH);
    const int t = (int)((e / KVH) % T_len);
    const int b = (int)(e / ((long long)KVH * T_len));
    if (t >= valid[b]) continue;
    const int s = start[b];
    if (s < 0 || s >= max_pages * PS) continue;
    const int page = table[(long long)b * max_pages + s / PS];
    dst[(((long long)layer * KVH + g) * P + page) * PS + t] = src[e];
  }
}

int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

// CALL(V, units) with the widest copy unit V that divides row_bytes
#define HIPLLAMA_UNIT_SWITCH(row_bytes, CALL)                  \
  if ((row_bytes) % 16 == 0) CALL(uint4, (row_bytes) / 16);    \
  else if ((row_bytes) % 8 == 0) CALL(uint2, (row_bytes) / 8); \
  else if ((row_bytes) % 4 == 0) CALL(uint32_t, (row_bytes) / 4); \
  else if ((row_bytes) % 2 == 0) CALL(uint16_t, (row_bytes) / 2); \
  else CALL(uint8_t, (row_bytes))

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// row_bytes: one cache row (HS elements) in bytes. valid may be null
// (every slot writes).
extern "C" int kv_commit_rows(void* k_cache, void* v_cache, const void* k_rows,
                              const void* v_rows, const void* pos, const void* valid,
                              int B, int L, int KVH, int S, int row_bytes, void* stream) {
  if (row_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(V, units)                                                                   \
  kv_commit_rows_kernel<V><<<dim3(blocks_for((long long)L * B * KVH * (units)), 2),      \
                             kThreads, 0, st>>>(k_cache, v_cache, k_rows, v_rows,         \
                                                (const int*)pos, (const int*)valid, B, L, \
                                                KVH, S, units)
  HIPLLAMA_UNIT_SWITCH(row_bytes, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

// rows dtype: 0 = float, 1 = bfloat16; the cache planes are int8 and the
// scale planes fp32 (B, L, KVH, S). valid may be null.
extern "C" int kv_commit_rows_int8(void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                                   const void* k_rows, const void* v_rows, const void* pos,
                                   const void* valid, int B, int L, int KVH, int S, int HS,
                                   int dtype, void* stream) {
  if (HS < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)L * B * KVH * 32), 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kv_commit_rows_int8_kernel<float><<<grid, kThreads, 0, st>>>(
        (int8_t*)k_cache, (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
        (const float*)k_rows, (const float*)v_rows, (const int*)pos, (const int*)valid,
        B, L, KVH, S, HS);
  } else {
    kv_commit_rows_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (int8_t*)k_cache, (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
        (const __nv_bfloat16*)k_rows, (const __nv_bfloat16*)v_rows, (const int*)pos,
        (const int*)valid, B, L, KVH, S, HS);
  }
  return (int)cudaGetLastError();
}

// K8 on one plane (B, L, KVH, S, HS) of any dtype; rows (L, B, KVH, HS) in
// the plane's dtype; row_bytes: one row in bytes. valid may be null.
extern "C" int kv_write_rows(void* cache, const void* rows, const void* pos, const void* valid,
                             int B, int L, int KVH, int S, int row_bytes, void* stream) {
  if (row_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(V, units)                                                                   \
  kv_write_rows_kernel<V><<<blocks_for((long long)L * B * KVH * (units)), kThreads, 0, st>>>( \
      cache, rows, (const int*)pos, (const int*)valid, B, L, KVH, S, units)
  HIPLLAMA_UNIT_SWITCH(row_bytes, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

// K9 on one fp32 scale plane (B, L, KVH, S); srows (L, B, KVH) fp32
extern "C" int scale_write_rows(void* scale, const void* srows, const void* pos, int B, int L,
                                int KVH, int S, void* stream) {
  scale_write_rows_kernel<<<blocks_for((long long)L * B * KVH), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      (float*)scale, (const float*)srows, (const int*)pos, B, L, KVH, S);
  return (int)cudaGetLastError();
}

// rows in the cache's dtype; row_bytes: one cache row in bytes
extern "C" int kv_write_chunk(void* k_cache, void* v_cache, const void* k_rows,
                              const void* v_rows, const void* start, const void* valid,
                              int B, int L, int KVH, int S, int row_bytes, int T_len, int layer,
                              void* stream) {
  if (row_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(V, units)                                                                     \
  kv_write_chunk_kernel<V><<<dim3(blocks_for((long long)B * T_len * KVH * (units)), 2),    \
                             kThreads, 0, st>>>(k_cache, v_cache, k_rows, v_rows,           \
                                                (const int*)start, (const int*)valid, B, L, \
                                                KVH, S, units, T_len, layer)
  HIPLLAMA_UNIT_SWITCH(row_bytes, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int scale_write_chunk(void* k_scale, void* v_scale, const void* k_srows,
                                 const void* v_srows, const void* start, const void* valid,
                                 int B, int L, int KVH, int S, int T_len, int layer,
                                 void* stream) {
  const dim3 grid(blocks_for((long long)B * T_len * KVH), 2);
  scale_write_chunk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (float*)k_scale, (float*)v_scale, (const float*)k_srows, (const float*)v_srows,
      (const int*)start, (const int*)valid, B, L, KVH, S, T_len, layer);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the paged pool; rows in the pages' dtype, row_bytes: one row in bytes

extern "C" int kv_write_rows_paged(void* k_pages, void* v_pages, const void* k_rows,
                                   const void* v_rows, const void* table, const void* pos, int B,
                                   int L, int KVH, int P, int PS, int max_pages, int row_bytes,
                                   void* stream) {
  if (row_bytes < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(V, units)                                                                         \
  kv_write_rows_paged_kernel<V><<<dim3(blocks_for((long long)L * B * KVH * (units)), 2),       \
                                  kThreads, 0, st>>>(k_pages, v_pages, k_rows, v_rows,          \
                                                     (const int*)table, (const int*)pos, B, L,  \
                                                     KVH, P, PS, max_pages, units)
  HIPLLAMA_UNIT_SWITCH(row_bytes, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int scale_write_rows_paged(void* k_scale, void* v_scale, const void* k_srows,
                                      const void* v_srows, const void* table, const void* pos,
                                      int B, int L, int KVH, int P, int PS, int max_pages,
                                      void* stream) {
  if (PS < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)L * B * KVH), 2);
  scale_write_rows_paged_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (float*)k_scale, (float*)v_scale, (const float*)k_srows, (const float*)v_srows,
      (const int*)table, (const int*)pos, B, L, KVH, P, PS, max_pages);
  return (int)cudaGetLastError();
}

extern "C" int kv_write_chunk_paged(void* k_pages, void* v_pages, const void* k_rows,
                                    const void* v_rows, const void* table, const void* start,
                                    const void* valid, int B, int KVH, int P, int PS,
                                    int max_pages, int row_bytes, int T_len, int layer,
                                    void* stream) {
  if (row_bytes < 1 || PS < 1 || T_len > PS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(V, units)                                                                          \
  kv_write_chunk_paged_kernel<V><<<dim3(blocks_for((long long)B * T_len * KVH * (units)), 2),   \
                                   kThreads, 0, st>>>(k_pages, v_pages, k_rows, v_rows,          \
                                                      (const int*)table, (const int*)start,      \
                                                      (const int*)valid, B, KVH, P, PS,          \
                                                      max_pages, units, T_len, layer)
  HIPLLAMA_UNIT_SWITCH(row_bytes, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int scale_write_chunk_paged(void* k_scale, void* v_scale, const void* k_srows,
                                       const void* v_srows, const void* table, const void* start,
                                       const void* valid, int B, int KVH, int P, int PS,
                                       int max_pages, int T_len, int layer, void* stream) {
  if (PS < 1 || T_len > PS) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)B * T_len * KVH), 2);
  scale_write_chunk_paged_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (float*)k_scale, (float*)v_scale, (const float*)k_srows, (const float*)v_srows,
      (const int*)table, (const int*)start, (const int*)valid, B, KVH, P, PS, max_pages, T_len,
      layer);
  return (int)cudaGetLastError();
}
