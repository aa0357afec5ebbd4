// GQA attention over the dense KV cache (B, L, KVH, S, HS) or the paged
// pool (L, KVH, P, PS, HS), fp32 or bf16 (or int8 with row scales).
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
// here (the wrapper checks).
//
// int8 caches (one fp32 scale per row, (B, L, KVH, S) planes): the decode
// kernels run decode_attention.cuh's int8 task (int8 dots of q quantized by
// row against K, and of p * vs quantized by row over each JAX block against
// V; attention.py:300-383), with the whole block's scores in dynamic shared
// memory. Prefill follows _prefill_kernel_tmaj's int8 branch (attention.py:
// 891-940): q rounded to bf16 whatever its dtype, K and V widened exactly,
// scores * scale * ks[row], and (p * vs[row]) rounded to bf16 before PV; no
// int8 dots. q, the current rows and the output are fp32 or bf16. The
// running max advances once per block of bk cache rows, the JAX kernel's KV
// block, which the wrappers pass: the rounded probabilities (bf16 V, or
// p * vs on an int8 cache) depend on it. So every kernel takes a whole
// block's scores before it rounds any: the decode task holds its M x bk
// scores in dynamic shared memory, and the prefill kernel its 64 query rows
// x bk (up to 576 columns: 128 KiB at the JAX prefill block of 512), each
// computed a 64-row tile of K at a time; PV then walks the block's V tiles.
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
// tile of (t, head) queries, walking cache blocks up to the tile's causal
// frontier with an online softmax), which is simple and exact to the cast
// points; wgmma/TMA is later work.
//
// attention_decode_paged and attention_prefill_paged replace hip_llama_tpu/
// ops/attention.py::attention_decode_paged (_decode_kernel through
// _decode_kernel_paged) and attention_prefill_paged (_prefill_kernel
// through _prefill_kernel_paged): the same kernels with the paged row policy
// of decode_attention.cuh, row r of slot b at page table[b, r / PS], offset
// r % PS, looked up once per block that lies in one page. The TPU kernels gather one page per grid step
// through their BlockSpec index maps, so their block is the page; here the
// online softmax also advances once per page, whose scores the kernels hold
// whole in shared memory.
// Bound and design as the dense kernels: bytes for decode, the live rows
// read once; the page lookup costs an index load per block from the slot's
// table row (per row only where a block spans pages).

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "decode_attention.cuh"

namespace {

using hipllama::ContiguousCache;
using hipllama::DecodeSmem;
using hipllama::DecodeSmemInt8;
using hipllama::decode_attention_task;
using hipllama::decode_attention_task_int8;
using hipllama::decode_int8_smem;
using hipllama::decode_smem;
using hipllama::kDecThreads;
using hipllama::kMaxM;
using hipllama::PagedCache;
using hipllama::load4;
using hipllama::round_to;
using hipllama::to_f;
using hipllama::from_f;
using hipllama::warp_max;
using hipllama::warp_sum;

// ---------------------------------------------------------------------------
// decode: one (KV head, slot) task per CTA (decode_attention.cuh)

// the block's scores in dynamic shared memory after sm
template <typename T, int HS, typename Cache>
__global__ void __launch_bounds__(kDecThreads) attention_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const Cache cache, const int* __restrict__ pos_arr, const T* __restrict__ k_cur,
    const T* __restrict__ v_cur, T* __restrict__ out, int H, int KVH, float scale, int q_bs,
    int cur_bs, int bk) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  auto& sm = *reinterpret_cast<DecodeSmem<HS, kDecThreads>*>(dec_smem);
  float* p_s = reinterpret_cast<float*>(dec_smem + sizeof(DecodeSmem<HS, kDecThreads>));
  const int g = blockIdx.x, b = blockIdx.y;
  decode_attention_task<T, HS, kDecThreads>(sm, p_s, g, b, q, k_cache, v_cache, cache.rows(b, g),
                                            pos_arr, k_cur, v_cur, out, H, KVH, scale, q_bs,
                                            cur_bs, bk);
}

// the int8 cache: the block's scores in dynamic shared memory after sm
template <typename T, int HS, typename Cache>
__global__ void __launch_bounds__(kDecThreads) attention_decode_int8_kernel(
    const T* __restrict__ q, const signed char* __restrict__ k_cache,
    const signed char* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Cache cache, const int* __restrict__ pos_arr,
    const T* __restrict__ k_cur, const T* __restrict__ v_cur, T* __restrict__ out,
    int H, int KVH, float scale, int q_bs, int cur_bs, int bk) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  auto& sm = *reinterpret_cast<DecodeSmemInt8<HS, kDecThreads>*>(dec_smem);
  float* p_s = reinterpret_cast<float*>(dec_smem + sizeof(DecodeSmemInt8<HS, kDecThreads>));
  const int g = blockIdx.x, b = blockIdx.y;
  decode_attention_task_int8<T, HS, kDecThreads>(sm, p_s, g, b, q, k_cache, v_cache, k_scale,
                                                 v_scale, cache.rows(b, g), pos_arr, k_cur,
                                                 v_cur, out, H, KVH, scale, q_bs, cur_bs, bk);
}

// ---------------------------------------------------------------------------
// prefill

constexpr int kPfThreads = 256;  // 8 warps
constexpr int kPfRows = 64;      // (t, head) query rows per CTA
constexpr int kPfTile = 64;      // cache rows per tile

// the block's columns rounded up to whole tiles
__host__ __device__ constexpr int prefill_cols(int bk) {
  return (bk + kPfTile - 1) / kPfTile * kPfTile;
}

// dynamic shared memory at block bk (ops/attention.py::check_prefill_block
// computes the same)
template <int HS>
constexpr size_t prefill_smem_bytes(int bk) {
  return sizeof(float) * ((size_t)kPfRows * HS                  // q
                          + (size_t)kPfTile * (HS + 1)          // a K tile (padded rows), then V
                          + (size_t)kPfRows * (prefill_cols(bk) + 1)  // the block's scores / p
                          + 3 * (size_t)kPfRows                 // m, l, alpha
                          + (size_t)kPfTile                     // the K tile's row scales (int8)
                          + (size_t)prefill_cols(bk));          // the block's V row scales (int8)
}

// T: q and output; C: the cache (T, or int8 with k_scale / v_scale); Cache:
// the row policy (decode_attention.cuh); S: the rows a slot can hold; bk:
// the online softmax's block of cache rows
template <typename T, typename C, int HS, typename Cache>
__global__ void __launch_bounds__(kPfThreads) attention_prefill_kernel(
    const T* __restrict__ q, const C* __restrict__ k_cache, const C* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const Cache cache,
    const int* __restrict__ start_arr, const int* __restrict__ valid_arr,
    T* __restrict__ out, int T_len, int H, int KVH, int S, float scale, int bk) {
  constexpr bool kInt8 = std::is_same<C, signed char>::value;
  // the type probabilities round to before PV: V's, bf16 for an int8 cache
  using P = typename std::conditional<kInt8, __nv_bfloat16, C>::type;
  constexpr int ACC = kPfRows * HS / kPfThreads;       // output entries per thread
  constexpr int SC = kPfRows * kPfTile / kPfThreads;   // score entries per thread and tile
  const int pst = prefill_cols(bk) + 1;                // row stride of the scores
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // [kPfRows][HS]
  float* kv_s = q_s + kPfRows * HS;          // [kPfTile][HS + 1] K, then [kPfTile][HS] V
  float* p_s = kv_s + kPfTile * (HS + 1);    // [kPfRows][pst]
  float* m_s = p_s + kPfRows * pst;
  float* l_s = m_s + kPfRows;
  float* a_s = l_s + kPfRows;
  float* ks_s = a_s + kPfRows;  // [kPfTile]
  float* vs_s = ks_s + kPfTile; // [prefill_cols(bk)]

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
    // q in the cache dtype; bf16 for an int8 cache (attention.py:912)
    const float qv = t < T_len ? to_f(q[(((size_t)b * T_len + t) * H + (size_t)g * M + r % M) * HS
                                        + i % HS])
                               : 0.f;
    q_s[i] = kInt8 ? round_to<__nv_bfloat16>(qv) : qv;
  }
  if (tid < kPfRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const auto rows = cache.rows(b, g);

  for (int k0 = 0; k0 <= q_pos_max && k0 < S; k0 += bk) {
    const int n = min(bk, S - k0);
    // the block's columns up to the tile's causal frontier, and whole tiles
    // of them: columns ncols .. ntile - 1 are masked
    const int ncols = min(n, q_pos_max - k0 + 1);
    const int ntile = prefill_cols(ncols);
    const hipllama::BlockRows<decltype(rows)> block_row(rows, k0, n);
    // scores of the block, a K tile at a time
    for (int c0 = 0; c0 < ncols; c0 += kPfTile) {
      __syncthreads();  // the previous tile's (or block's) k/v/p are consumed
      for (int i = tid; i < kPfTile * HS; i += kPfThreads) {
        const int c = i / HS, dd = i % HS;
        const bool in = c0 + c < ncols;
        kv_s[c * (HS + 1) + dd] = in ? to_f(k_cache[block_row(c0 + c) * HS + dd]) : 0.f;
      }
      if (kInt8 && tid < kPfTile)
        ks_s[tid] = c0 + tid < ncols ? k_scale[block_row(c0 + tid)] : 0.f;
      __syncthreads();
      // thread owns column c = tid % kPfTile of rows tid / kPfTile + 4i
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const int e = tid + i * kPfThreads;
        const int r = e / kPfTile, c = e % kPfTile;
        const int t = t0 + r / M, col = k0 + c0 + c;
        const float* qr = q_s + r * HS;
        const float* kr = kv_s + c * (HS + 1);
        float s = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < HS; ++dd) s += qr[dd] * kr[dd];
        const bool live = c0 + c < ncols && t < t_end && col <= start + t;
        s *= scale;
        if (kInt8) s *= ks_s[c];
        p_s[r * pst + c0 + c] = live ? s : -INFINITY;
      }
    }
    if (kInt8)
      for (int c = tid; c < ntile; c += kPfThreads)
        vs_s[c] = c < ncols ? v_scale[block_row(c)] : 0.f;
    __syncthreads();
    // online softmax over the block: each warp takes kPfRows / 8 rows
    for (int r = warp; r < kPfRows; r += kPfThreads / 32) {
      float* pr = p_s + r * pst;
      float mx = -INFINITY;
      for (int c = lane; c < ntile; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < ntile; c += 32) {
        // a row with no live column yet keeps p = 0 (and m = -inf)
        const float p = pr[c] == -INFINITY ? 0.f : expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_to<P>(kInt8 ? p * vs_s[c] : p);
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
    // PV, a V tile at a time: thread owns output entries tid + 256 i -> (row, dim)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] *= a_s[(tid + i * kPfThreads) / HS];
    for (int c0 = 0; c0 < ncols; c0 += kPfTile) {
      if (c0) __syncthreads();  // the previous V tile is consumed
      for (int i = tid; i < kPfTile * HS; i += kPfThreads) {
        const int c = i / HS, dd = i % HS;
        kv_s[i] = c0 + c < ncols ? to_f(v_cache[block_row(c0 + c) * HS + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int e = tid + i * kPfThreads;
        const int r = e / HS, dd = e % HS;
        const float* pr = p_s + r * pst + c0;
        float a = acc[i];
#pragma unroll 16
        for (int c = 0; c < kPfTile; ++c) a += pr[c] * kv_s[c * HS + dd];
        acc[i] = a;
      }
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

// the kernel's dynamic shared memory may exceed the default 48 KB
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// the decode kernel with M x bk scores in dynamic shared memory
template <typename T, int HS, typename Cache>
int launch_decode(const void* q, const void* k, const void* v, const Cache& cache,
                  const void* pos, const void* kc, const void* vc, void* out, int B, int H,
                  int KVH, float scale, int q_bs, int cur_bs, int bk, cudaStream_t st) {
  const size_t smem = decode_smem<HS, kDecThreads>(H / KVH, bk);
  auto kernel = attention_decode_kernel<T, HS, Cache>;
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<dim3(KVH, B), kDecThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, cache, (const int*)pos, (const T*)kc,
      (const T*)vc, (T*)out, H, KVH, scale, q_bs, cur_bs, bk);
  return (int)cudaGetLastError();
}

// the int8 decode kernel with M x bk scores in dynamic shared memory
template <typename T, int HS, typename Cache>
int launch_decode_int8(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const Cache& cache, const void* pos, const void* kc,
                       const void* vc, void* out, int B, int H, int KVH, float scale, int q_bs,
                       int cur_bs, int bk, cudaStream_t st) {
  const size_t smem = decode_int8_smem<HS, kDecThreads>(H / KVH, bk);
  auto kernel = attention_decode_int8_kernel<T, HS, Cache>;
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<dim3(KVH, B), kDecThreads, smem, st>>>(
      (const T*)q, (const signed char*)k, (const signed char*)v, (const float*)ks,
      (const float*)vs, cache, (const int*)pos, (const T*)kc, (const T*)vc, (T*)out, H, KVH,
      scale, q_bs, cur_bs, bk);
  return (int)cudaGetLastError();
}

template <typename T, typename C, int HS, typename Cache>
int launch_prefill(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const Cache& cache, const void* start, const void* valid,
                   void* out, int B, int T_len, int H, int KVH, int S, float scale, int bk,
                   cudaStream_t st) {
  const size_t smem = prefill_smem_bytes<HS>(bk);
  auto kernel = attention_prefill_kernel<T, C, HS, Cache>;
  if (const int e = allow_smem(kernel, smem)) return e;
  const int bt = kPfRows / (H / KVH);
  const dim3 grid((T_len + bt - 1) / bt, KVH, B);
  kernel<<<grid, kPfThreads, smem, st>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)ks, (const float*)vs, cache,
      (const int*)start, (const int*)valid, (T*)out, T_len, H, KVH, S, scale, bk);
  return (int)cudaGetLastError();
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// dtype: 0 = float, 1 = bfloat16; HS in {8, 16, 32, 64, 128}; H / KVH <= 8;
// bk >= 1 cache rows per online-softmax block, each block's M x bk scores
// held in shared memory (the wrapper keeps that within the card's limit).
// q_bs, cur_bs: the slot strides, in elements, of q (B, H, HS) and of k_cur
// and v_cur (B, KVH, HS), whose heads are contiguous: H * HS and KVH * HS
// for packed operands, the QKV row's width where q, k_cur and v_cur are
// column slices of the flat QKV projection (B, (H + 2 KVH) HS), read in
// place (the stacked layer).
extern "C" int attention_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* pos, const void* k_cur, const void* v_cur,
                                void* out, int B, int H, int KVH, int S, int HS, int L,
                                int layer, int q_bs, int cur_bs, int dtype, int bk,
                                void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1 || q_bs < H * HS || cur_bs < KVH * HS)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                       \
  launch_decode<T, N>(q, k_cache, v_cache, cache, pos, k_cur, v_cur, out, B, H, KVH, scale, \
                      q_bs, cur_bs, bk, st)
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
  if (H % KVH || H / KVH > kMaxM || bk < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = H + 2 * KVH;
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  const void* kc = base + (size_t)H * HS * esize;
  const void* vc = base + (size_t)(H + KVH) * HS * esize;
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                     \
  launch_decode<T, N>(qkv, k_cache, v_cache, cache, pos, kc, vc, out, B, H, KVH, scale, \
                      nt * HS, nt * HS, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// The int8 branches of the two above: int8 cache planes with fp32 scale
// planes (B, L, KVH, S); q, the current rows and out in dtype (0 = float,
// 1 = bfloat16); bk >= 1 cache rows per block, each block's M x bk scores
// held in shared memory (the wrapper keeps that within the card's limit);
// q_bs and cur_bs as attention_decode's.
extern "C" int attention_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                                     const void* k_scale, const void* v_scale, const void* pos,
                                     const void* k_cur, const void* v_cur, void* out, int B,
                                     int H, int KVH, int S, int HS, int L, int layer, int q_bs,
                                     int cur_bs, int dtype, int bk, void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1 || q_bs < H * HS || cur_bs < KVH * HS)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                        \
  launch_decode_int8<T, N>(q, k_cache, v_cache, k_scale, v_scale, cache, pos, k_cur, v_cur, \
                           out, B, H, KVH, scale, q_bs, cur_bs, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_decode_fused_int8(const void* qkv, const void* k_cache,
                                           const void* v_cache, const void* k_scale,
                                           const void* v_scale, const void* pos, void* out,
                                           int B, int H, int KVH, int S, int HS, int L,
                                           int layer, int dtype, int bk, void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = H + 2 * KVH;
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  const void* kc = base + (size_t)H * HS * esize;
  const void* vc = base + (size_t)(H + KVH) * HS * esize;
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                            \
  launch_decode_int8<T, N>(qkv, k_cache, v_cache, k_scale, v_scale, cache, pos, kc, vc, out, B, \
                           H, KVH, scale, nt * HS, nt * HS, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// dtype: 0 = float, 1 = bfloat16; HS in {8, 16, 32, 64, 128}; 64 % (H / KVH) == 0;
// bk >= 1 cache rows per online-softmax block (prefill_smem_bytes(bk) within
// the card's shared memory, which the wrapper checks).
extern "C" int attention_prefill(const void* q, const void* k_cache, const void* v_cache,
                                 const void* start, const void* valid, void* out, int B,
                                 int T_len, int H, int KVH, int S, int HS, int L, int layer,
                                 int dtype, int bk, void* stream) {
  if (H % KVH || kPfRows % (H / KVH) || bk < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                           \
  launch_prefill<T, T, N>(q, k_cache, v_cache, nullptr, nullptr, cache, start, valid, out, B, \
                          T_len, H, KVH, S, scale, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// int8 cache planes with fp32 scale planes (B, L, KVH, S); q and out in
// dtype (0 = float, 1 = bfloat16); otherwise as attention_prefill.
extern "C" int attention_prefill_int8(const void* q, const void* k_cache, const void* v_cache,
                                      const void* k_scale, const void* v_scale,
                                      const void* start, const void* valid, void* out, int B,
                                      int T_len, int H, int KVH, int S, int HS, int L,
                                      int layer, int dtype, int bk, void* stream) {
  if (H % KVH || kPfRows % (H / KVH) || bk < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                            \
  launch_prefill<T, signed char, N>(q, k_cache, v_cache, k_scale, v_scale, cache, start, valid, \
                                    out, B, T_len, H, KVH, S, scale, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// ---------------------------------------------------------------------------
// the paged pool: planes (L, KVH, P, PS, HS), int8 with fp32 scale planes
// (L, KVH, P, PS); table (B, max_pages) int32 physical page ids; rows
// 0..pos[b]-1 (decode) or 0..start[b]+t (prefill) of slot b must sit in
// pages the table names. dtype and bk as the dense entry points above.

extern "C" int attention_decode_paged(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* pos, const void* k_cur,
                                      const void* v_cur, void* out, int B, int H, int KVH, int P,
                                      int PS, int max_pages, int HS, int layer, int dtype, int bk,
                                      void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
#define CALL(T, N)                                                                          \
  launch_decode<T, N>(q, k_pages, v_pages, cache, pos, k_cur, v_cur, out, B, H, KVH, scale, \
                      H * HS, KVH * HS, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_decode_paged_int8(const void* q, const void* k_pages,
                                           const void* v_pages, const void* k_scale,
                                           const void* v_scale, const void* table,
                                           const void* pos, const void* k_cur, const void* v_cur,
                                           void* out, int B, int H, int KVH, int P, int PS,
                                           int max_pages, int HS, int layer, int dtype, int bk,
                                           void* stream) {
  if (H % KVH || H / KVH > kMaxM || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
#define CALL(T, N)                                                                            \
  launch_decode_int8<T, N>(q, k_pages, v_pages, k_scale, v_scale, cache, pos, k_cur, v_cur, out, \
                           B, H, KVH, scale, H * HS, KVH * HS, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_prefill_paged(const void* q, const void* k_pages, const void* v_pages,
                                       const void* table, const void* start, const void* valid,
                                       void* out, int B, int T_len, int H, int KVH, int P, int PS,
                                       int max_pages, int HS, int layer, int dtype, int bk,
                                       void* stream) {
  if (H % KVH || kPfRows % (H / KVH) || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
  const int S = max_pages * PS;
#define CALL(T, N)                                                                           \
  launch_prefill<T, T, N>(q, k_pages, v_pages, nullptr, nullptr, cache, start, valid, out, B, \
                          T_len, H, KVH, S, scale, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_prefill_paged_int8(const void* q, const void* k_pages,
                                            const void* v_pages, const void* k_scale,
                                            const void* v_scale, const void* table,
                                            const void* start, const void* valid, void* out,
                                            int B, int T_len, int H, int KVH, int P, int PS,
                                            int max_pages, int HS, int layer, int dtype, int bk,
                                            void* stream) {
  if (H % KVH || kPfRows % (H / KVH) || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
  const int S = max_pages * PS;
#define CALL(T, N)                                                                               \
  launch_prefill<T, signed char, N>(q, k_pages, v_pages, k_scale, v_scale, cache, start, valid, \
                                    out, B, T_len, H, KVH, S, scale, bk, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}
