// GQA attention over the dense KV cache (B, L, KVH, S, HS), fp32 or bf16.
//
// attention_decode replaces hip_llama_tpu/ops/attention.py::
// attention_decode_pallas (_decode_kernel and its bfold/bvec/dyn schedules,
// which compute one function): query heads q (B, H, HS) of one decode token
// attend over cache rows 0..pos[b]-1 of layer `layer`, then the current
// row k_cur/v_cur (B, KVH, HS) is folded in last, as _final does.
// attention_prefill replaces attention_prefill_pallas (_prefill_kernel_tmaj
// and _prefill_kernel): chunk queries q (B, T, H, HS) over a cache that
// already holds the chunk; query t of slot b sees rows 0..start[b]+t and
// rows t >= valid[b] are written as zeros.
//
// Cast points follow the JAX kernels (attention.py:164-241, :912-940): q in
// the cache dtype for QK, fp32 scores and softmax state (m, l, acc),
// probabilities exp(s - running max) rounded to the V dtype before PV,
// output in q's dtype. q, the cache and the current rows share one dtype
// here (the wrapper checks). The running max advances once per block of bk
// cache rows; with a bf16 cache the rounded probabilities depend on it, so
// the wrappers pass the JAX kernels' block where it is at most 64 rows. A
// block of 64 (every cache of 64 rows or more) is a compile-time constant,
// so the kernels' tile loops are those of a fixed 64-row tile; smaller
// blocks (short caches only) take it as an argument.
//
// Bounds on an H100: decode is bound by bytes — every live K and V row of
// the layer is read once (2 * pos * HS * bytes per slot and KV head) for
// 4 * pos * HS flops per query head, far below the card's ~295 flop/byte
// ridge. One CTA per (KV head, slot) runs decode_attention.cuh's task: it
// streams its rows with coalesced warp loads and keeps the kv_mul query
// heads of the group in shared memory, so each K/V byte is read once for
// all heads that share it. Prefill at
// T = 256 does up to T flops per K/V byte and would be bound by operations
// on the tensor cores; this first version does the products on the fp32
// CUDA cores out of shared memory (one CTA per slot, KV head and 64-row
// tile of (t, head) queries, walking cache tiles up to the tile's causal
// frontier with an online softmax), which is simple and exact to the cast
// points; wgmma/TMA is later work.

#include <math.h>

#include "common.cuh"
#include "decode_attention.cuh"

namespace {

using hipllama::DecodeSmem;
using hipllama::decode_attention_task;
using hipllama::kDecThreads;
using hipllama::kMaxM;
using hipllama::kDecTile;
using hipllama::load4;
using hipllama::round_to;
using hipllama::to_f;
using hipllama::from_f;
using hipllama::warp_max;
using hipllama::warp_sum;

// ---------------------------------------------------------------------------
// decode: one (KV head, slot) task per CTA (decode_attention.cuh)

template <typename T, int HS, int BK>
__global__ void __launch_bounds__(kDecThreads) attention_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* __restrict__ pos_arr, const T* __restrict__ k_cur,
    const T* __restrict__ v_cur, T* __restrict__ out,
    int H, int KVH, int S, int L, int layer, float scale, int q_bs, int cur_bs, int bk) {
  __shared__ DecodeSmem<HS, kDecThreads> sm;
  decode_attention_task<T, HS, kDecThreads, BK>(sm, blockIdx.x, blockIdx.y, q, k_cache, v_cache,
                                                pos_arr, k_cur, v_cur, out, H, KVH, S, L, layer,
                                                scale, q_bs, cur_bs, bk);
}

// ---------------------------------------------------------------------------
// prefill

constexpr int kPfThreads = 256;  // 8 warps
constexpr int kPfRows = 64;      // (t, head) query rows per CTA
constexpr int kPfTile = 64;      // cache rows per tile

template <int HS>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * ((size_t)kPfRows * HS          // q
                          + (size_t)kPfTile * (HS + 1)  // k (padded rows)
                          + (size_t)kPfTile * HS        // v
                          + (size_t)kPfRows * (kPfTile + 1)  // scores / p
                          + 3 * (size_t)kPfRows);       // m, l, alpha
}

template <typename T, int HS, int BK>
__global__ void __launch_bounds__(kPfThreads) attention_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* __restrict__ start_arr, const int* __restrict__ valid_arr,
    T* __restrict__ out, int T_len, int H, int KVH, int S, int L, int layer, float scale,
    int bk_arg) {
  const int bk = BK > 0 ? BK : bk_arg;
  constexpr int ACC = kPfRows * HS / kPfThreads;       // output entries per thread
  constexpr int SC = kPfRows * kPfTile / kPfThreads;   // score entries per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // [kPfRows][HS]
  float* k_s = q_s + kPfRows * HS;           // [kPfTile][HS + 1]
  float* v_s = k_s + kPfTile * (HS + 1);     // [kPfTile][HS]
  float* p_s = v_s + kPfTile * HS;           // [kPfRows][kPfTile + 1]
  float* m_s = p_s + kPfRows * (kPfTile + 1);
  float* l_s = m_s + kPfRows;
  float* a_s = l_s + kPfRows;

  const int g = blockIdx.y, b = blockIdx.z;
  const int M = H / KVH;
  const int BT = kPfRows / M;  // chunk positions per CTA; row r = (t0 + r / M, head g*M + r % M)
  const int t0 = blockIdx.x * BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = start_arr[b];
  const int t_end = min(min(t0 + BT, valid_arr[b]), T_len);  // live rows: t0 .. t_end-1
  // causal frontier of the tile: the last live query's cache position
  const int q_pos_max = t_end > t0 ? start + t_end - 1 : -1;

  for (int i = tid; i < kPfRows * HS; i += kPfThreads) {
    const int r = i / HS, t = t0 + r / M;
    q_s[i] = t < T_len ? to_f(q[(((size_t)b * T_len + t) * H + (size_t)g * M + r % M) * HS + i % HS])
                       : 0.f;
  }
  if (tid < kPfRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const size_t plane = (((size_t)b * L + layer) * KVH + g) * (size_t)S * HS;
  const T* kb = k_cache + plane;
  const T* vb = v_cache + plane;

  for (int k0 = 0; k0 <= q_pos_max && k0 < S; k0 += bk) {
    __syncthreads();  // the previous tile's k/v/p are consumed
    for (int i = tid; i < kPfTile * HS; i += kPfThreads) {
      const int c = i / HS, dd = i % HS;
      const bool in = c < bk && k0 + c < S;
      k_s[c * (HS + 1) + dd] = in ? to_f(kb[(size_t)(k0 + c) * HS + dd]) : 0.f;
      v_s[i] = in ? to_f(vb[(size_t)(k0 + c) * HS + dd]) : 0.f;
    }
    __syncthreads();
    // scores: thread owns column c = tid % kPfTile of rows tid / kPfTile + 4i
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      const int e = tid + i * kPfThreads;
      const int r = e / kPfTile, c = e % kPfTile;
      const int t = t0 + r / M, col = k0 + c;
      const float* qr = q_s + r * HS;
      const float* kr = k_s + c * (HS + 1);
      float s = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < HS; ++dd) s += qr[dd] * kr[dd];
      const bool live = c < bk && t < t_end && col < S && col <= start + t;
      p_s[r * (kPfTile + 1) + c] = live ? s * scale : -INFINITY;
    }
    __syncthreads();
    // online softmax: each warp takes kPfRows / 8 rows
    for (int r = warp; r < kPfRows; r += kPfThreads / 32) {
      float* pr = p_s + r * (kPfTile + 1);
      float mx = -INFINITY;
      for (int c = lane; c < kPfTile; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kPfTile; c += 32) {
        // a row with no live column yet keeps p = 0 (and m = -inf)
        const float p = pr[c] == -INFINITY ? 0.f : expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_to<T>(p);
      }
      sum = warp_sum(sum, 32);
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // PV: thread owns output entries tid + 256 i -> (row, dim)
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * kPfThreads;
      const int r = e / HS, dd = e % HS;
      const float* pr = p_s + r * (kPfTile + 1);
      float a = acc[i] * a_s[r];
#pragma unroll 16
      for (int c = 0; c < kPfTile; ++c) a += pr[c] * v_s[c * HS + dd];
      acc[i] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * kPfThreads;
    const int r = e / HS, dd = e % HS;
    const int t = t0 + r / M;
    if (t < T_len) {
      const float l = l_s[r];
      out[(((size_t)b * T_len + t) * H + (size_t)g * M + r % M) * HS + dd] =
          from_f<T>(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers

template <typename T, int HS>
int launch_decode(const void* q, const void* k, const void* v, const void* pos,
                  const void* kc, const void* vc, void* out, int B, int H, int KVH,
                  int S, int L, int layer, float scale, int q_bs, int cur_bs, int bk,
                  cudaStream_t st) {
  auto kernel = bk == kDecTile ? attention_decode_kernel<T, HS, kDecTile>
                               : attention_decode_kernel<T, HS, 0>;
  kernel<<<dim3(KVH, B), kDecThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const T*)kc,
      (const T*)vc, (T*)out, H, KVH, S, L, layer, scale, q_bs, cur_bs, bk);
  return (int)cudaGetLastError();
}

template <typename T, int HS>
int launch_prefill(const void* q, const void* k, const void* v, const void* start,
                   const void* valid, void* out, int B, int T_len, int H, int KVH,
                   int S, int L, int layer, float scale, int bk, cudaStream_t st) {
  constexpr size_t smem = prefill_smem_bytes<HS>();
  auto kernel = bk == kPfTile ? attention_prefill_kernel<T, HS, kPfTile>
                              : attention_prefill_kernel<T, HS, 0>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bt = kPfRows / (H / KVH);
  const dim3 grid((T_len + bt - 1) / bt, KVH, B);
  kernel<<<grid, kPfThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)start, (const int*)valid,
      (T*)out, T_len, H, KVH, S, L, layer, scale, bk);
  return (int)cudaGetLastError();
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// dtype: 0 = float, 1 = bfloat16; HS in {8, 16, 32, 64, 128}; H / KVH <= 8;
// bk (1..64) cache rows per online-softmax block.
extern "C" int attention_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* pos, const void* k_cur, const void* v_cur,
                                void* out, int B, int H, int KVH, int S, int HS, int L,
                                int layer, int dtype, int bk, void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1 || bk > kDecTile) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, N)                                                                 \
  launch_decode<T, N>(q, k_cache, v_cache, pos, k_cur, v_cur, out, B, H, KVH, S, L, layer, \
                      scale, H * HS, KVH * HS, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// attention_decode_fused replaces hip_llama_tpu/ops/attention.py::
// attention_decode_fused: the same function as attention_decode, reading
// q, k_cur and v_cur in place from the head-split QKV projection
// qkv (B, H + 2 KVH, HS): q = rows 0..H-1, k_cur = rows H..H+KVH-1, v_cur
// the rest. The decode kernel above takes the slot strides of its operands,
// so no slice is copied. dtype: 0 = float, 1 = bfloat16.
extern "C" int attention_decode_fused(const void* qkv, const void* k_cache, const void* v_cache,
                                      const void* pos, void* out, int B, int H, int KVH, int S,
                                      int HS, int L, int layer, int dtype, int bk,
                                      void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1 || bk > kDecTile) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = H + 2 * KVH;
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  const void* kc = base + (size_t)H * HS * esize;
  const void* vc = base + (size_t)(H + KVH) * HS * esize;
#define CALL(T, N)                                                                  \
  launch_decode<T, N>(qkv, k_cache, v_cache, pos, kc, vc, out, B, H, KVH, S, L, layer, \
                      scale, nt * HS, nt * HS, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// dtype: 0 = float, 1 = bfloat16; HS in {8, 16, 32, 64, 128}; 64 % (H / KVH) == 0;
// bk (1..64) cache rows per online-softmax block.
extern "C" int attention_prefill(const void* q, const void* k_cache, const void* v_cache,
                                 const void* start, const void* valid, void* out, int B,
                                 int T_len, int H, int KVH, int S, int HS, int L, int layer,
                                 int dtype, int bk, void* stream) {
  if (H % KVH || kPfRows % (H / KVH) || bk < 1 || bk > kPfTile)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, N) \
  launch_prefill<T, N>(q, k_cache, v_cache, start, valid, out, B, T_len, H, KVH, S, L, layer, \
                       scale, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}
