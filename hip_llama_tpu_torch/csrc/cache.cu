// KV cache writers for the dense cache (B, L, KVH, S, HS), in place.
//
// kv_commit_rows replaces hip_llama_tpu/ops/cache.py::kv_commit_rows (dense
// branch): one decode step's K and V rows, (L, B, KVH, HS) each, land at
// (b, l, :, pos[b], :) for every layer, in ONE launch for both planes.
// kv_write_chunk replaces hip_llama_tpu/ops/cache.py::kv_write_chunk: one
// layer's prefill chunk rows, (B, T, KVH, HS), land at start[b] + j for
// j < valid[b] and start[b] + j < S, K and V in one launch per layer.
//
// Bound: bytes. Each moves its rows once in and once out (read the rows,
// write as many cache bytes); no arithmetic. The TPU kernels read-modify-
// write aligned windows because a TPU DMA cannot address one row; on the
// card every thread stores 16 bytes straight to its row, so the cache is
// never read. Positions outside [0, S) write nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // grid-stride: a few waves of the SMs

template <typename T>
__global__ void __launch_bounds__(kThreads) kv_commit_rows_kernel(
    T* __restrict__ k_cache, T* __restrict__ v_cache,
    const T* __restrict__ k_rows, const T* __restrict__ v_rows,
    const int* __restrict__ pos, const int* __restrict__ valid,
    int B, int L, int KVH, int S, int HS) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte store
  const uint4* rows = reinterpret_cast<const uint4*>(blockIdx.y == 0 ? k_rows : v_rows);
  uint4* cache = reinterpret_cast<uint4*>(blockIdx.y == 0 ? k_cache : v_cache);
  const int hsv = HS / VEC;
  const long long n = (long long)L * B * KVH * hsv;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int dv = (int)(e % hsv);
    long long r = e / hsv;
    const int g = (int)(r % KVH);
    r /= KVH;
    const int b = (int)(r % B);
    const int l = (int)(r / B);
    if (valid != nullptr && valid[b] == 0) continue;
    const int p = pos[b];
    if (p < 0 || p >= S) continue;
    cache[((((long long)b * L + l) * KVH + g) * S + p) * hsv + dv] = rows[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) kv_write_chunk_kernel(
    T* __restrict__ k_cache, T* __restrict__ v_cache,
    const T* __restrict__ k_rows, const T* __restrict__ v_rows,
    const int* __restrict__ start, const int* __restrict__ valid,
    int B, int L, int KVH, int S, int HS, int T_len, int layer) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* rows = reinterpret_cast<const uint4*>(blockIdx.y == 0 ? k_rows : v_rows);
  uint4* cache = reinterpret_cast<uint4*>(blockIdx.y == 0 ? k_cache : v_cache);
  const int hsv = HS / VEC;
  const long long n = (long long)B * T_len * KVH * hsv;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int dv = (int)(e % hsv);
    long long r = e / hsv;
    const int g = (int)(r % KVH);
    r /= KVH;
    const int t = (int)(r % T_len);
    const int b = (int)(r / T_len);
    if (t >= valid[b]) continue;
    const int p = start[b] + t;
    if (p < 0 || p >= S) continue;
    cache[((((long long)b * L + layer) * KVH + g) * S + p) * hsv + dv] = rows[e];
  }
}

int blocks_for(long long n_vec) {
  const long long want = (n_vec + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// dtype: 0 = float, 1 = bfloat16. valid may be null (every slot writes).
extern "C" int kv_commit_rows(void* k_cache, void* v_cache, const void* k_rows,
                              const void* v_rows, const void* pos, const void* valid,
                              int B, int L, int KVH, int S, int HS, int dtype,
                              void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (HS % vec) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)L * B * KVH * (HS / vec)), 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kv_commit_rows_kernel<float><<<grid, kThreads, 0, st>>>(
        (float*)k_cache, (float*)v_cache, (const float*)k_rows, (const float*)v_rows,
        (const int*)pos, (const int*)valid, B, L, KVH, S, HS);
  } else {
    kv_commit_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (__nv_bfloat16*)k_cache, (__nv_bfloat16*)v_cache, (const __nv_bfloat16*)k_rows,
        (const __nv_bfloat16*)v_rows, (const int*)pos, (const int*)valid, B, L, KVH, S, HS);
  }
  return (int)cudaGetLastError();
}

extern "C" int kv_write_chunk(void* k_cache, void* v_cache, const void* k_rows,
                              const void* v_rows, const void* start, const void* valid,
                              int B, int L, int KVH, int S, int HS, int T_len, int layer,
                              int dtype, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (HS % vec) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)B * T_len * KVH * (HS / vec)), 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kv_write_chunk_kernel<float><<<grid, kThreads, 0, st>>>(
        (float*)k_cache, (float*)v_cache, (const float*)k_rows, (const float*)v_rows,
        (const int*)start, (const int*)valid, B, L, KVH, S, HS, T_len, layer);
  } else {
    kv_write_chunk_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (__nv_bfloat16*)k_cache, (__nv_bfloat16*)v_cache, (const __nv_bfloat16*)k_rows,
        (const __nv_bfloat16*)v_rows, (const int*)start, (const int*)valid, B, L, KVH, S,
        HS, T_len, layer);
  }
  return (int)cudaGetLastError();
}
