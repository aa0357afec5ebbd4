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
// probabilities rounded to the V dtype before PV, output in q's dtype. q,
// the cache and the current rows share one dtype here (the wrapper checks).
//
// Bounds on an H100: decode is bound by bytes — every live K and V row of
// the layer is read once (2 * pos * HS * bytes per slot and KV head) for
// 4 * pos * HS flops per query head, far below the card's ~295 flop/byte
// ridge. One CTA per (KV head, slot) streams its rows with coalesced warp
// loads and keeps the kv_mul query heads of the group in shared memory, so
// each K/V byte is read once for all heads that share it. Prefill at
// T = 256 does up to T flops per K/V byte and would be bound by operations
// on the tensor cores; this first version does the products on the fp32
// CUDA cores out of shared memory (one CTA per slot, KV head and 64-row
// tile of (t, head) queries, walking cache tiles up to the tile's causal
// frontier with an online softmax), which is simple and exact to the cast
// points; wgmma/TMA is later work.

#include <math.h>

#include "common.cuh"

namespace {

using hipllama::load4;
using hipllama::round_to;
using hipllama::to_f;
using hipllama::from_f;
using hipllama::warp_max;
using hipllama::warp_sum;

// ---------------------------------------------------------------------------
// decode

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTile = 64;      // cache rows per tile
constexpr int kMaxM = 8;          // query heads per KV head (kv_mul)

template <typename T, int HS>
__global__ void __launch_bounds__(kDecThreads) attention_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* __restrict__ pos_arr, const T* __restrict__ k_cur,
    const T* __restrict__ v_cur, T* __restrict__ out,
    int H, int KVH, int S, int L, int layer, float scale) {
  constexpr int LPR = HS / 4;          // lanes per K row in QK (4 elements each)
  constexpr int RPW = 32 / LPR;        // K rows per warp per pass
  constexpr int RG = kDecThreads / HS; // row groups in PV (each thread owns one dim)
  static_assert(kDecTile % (kDecWarps * RPW) == 0, "tile must split over the warps");

  __shared__ __align__(16) float q_s[kMaxM][HS];  // q, as the cache dtype, widened
  __shared__ float p_s[kMaxM][kDecTile];          // scores, then rounded probabilities
  __shared__ float red_s[kMaxM][kDecThreads];     // PV partial sums over row groups
  __shared__ float m_s[kMaxM], l_s[kMaxM], a_s[kMaxM], pc_s[kMaxM];

  const int g = blockIdx.x, b = blockIdx.y;
  const int M = H / KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];

  const T* qb = q + ((size_t)b * H + (size_t)g * M) * HS;
  for (int i = tid; i < M * HS; i += kDecThreads) q_s[i / HS][i % HS] = to_f(qb[i]);
  if (tid < kMaxM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const size_t plane = (((size_t)b * L + layer) * KVH + g) * (size_t)S * HS;
  const T* kb = k_cache + plane;
  const T* vb = v_cache + plane;
  const int d = tid % HS, rg = tid / HS;
  const int c0 = (lane % LPR) * 4;
  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  for (int t0 = 0; t0 < pos; t0 += kDecTile) {
    const int n = min(kDecTile, pos - t0);
    // scores: LPR lanes per row, reduced with shuffles (all lanes take the
    // same trip count, so the shuffles stay convergent)
    for (int r = warp * RPW + lane / LPR; r < kDecTile; r += kDecWarps * RPW) {
      float kf[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < n) load4(kb + (size_t)(t0 + r) * HS + c0, kf);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          float qf[4];
          load4(&q_s[m][c0], qf);
          float s = qf[0] * kf[0] + qf[1] * kf[1] + qf[2] * kf[2] + qf[3] * kf[3];
          s = warp_sum(s, LPR);
          if (lane % LPR == 0) p_s[m][r] = r < n ? s * scale : -INFINITY;
        }
      }
    }
    __syncthreads();
    // online softmax, one warp per query head
    for (int m = warp; m < M; m += kDecWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < kDecTile; r += 32) mx = fmaxf(mx, p_s[m][r]);
      mx = warp_max(mx);  // finite: the tile holds at least one live row
      const float m_old = m_s[m];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kDecTile; r += 32) {
        const float p = r < n ? expf(p_s[m][r] - m_new) : 0.f;
        sum += p;
        p_s[m][r] = round_to<T>(p);
      }
      sum = warp_sum(sum, 32);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[m] = alpha;
        l_s[m] = alpha * l_s[m] + sum;
        m_s[m] = m_new;
      }
    }
    __syncthreads();
    // PV: thread (rg, d) sums rows rg, rg + RG, ... of the tile
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) acc[m] *= a_s[m];
    for (int r = rg; r < n; r += RG) {
      const float v = to_f(vb[(size_t)(t0 + r) * HS + d]);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) acc[m] += p_s[m][r] * v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < M) red_s[m][tid] = acc[m];
  // the current row: s_cur = q . k_cur in q's dtype, p_cur stays fp32
  const T* kc = k_cur + ((size_t)b * KVH + g) * HS;
  for (int m = warp; m < M; m += kDecWarps) {
    float s = 0.f;
    for (int i = lane; i < HS; i += 32) s += q_s[m][i] * to_f(kc[i]);
    s = warp_sum(s, 32) * scale;
    if (lane == 0) {
      const float m_new = fmaxf(m_s[m], s);
      const float alpha = expf(m_s[m] - m_new);
      const float p_cur = expf(s - m_new);
      a_s[m] = alpha;
      pc_s[m] = p_cur;
      l_s[m] = alpha * l_s[m] + p_cur;
    }
  }
  __syncthreads();
  if (tid < HS) {
    const float vcur = to_f(v_cur[((size_t)b * KVH + g) * HS + tid]);
    for (int m = 0; m < M; ++m) {
      float o = 0.f;
      for (int i = 0; i < RG; ++i) o += red_s[m][i * HS + tid];
      o = o * a_s[m] + pc_s[m] * vcur;
      const float l = l_s[m];
      out[((size_t)b * H + (size_t)g * M + m) * HS + tid] = from_f<T>(o / (l == 0.f ? 1.f : l));
    }
  }
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

template <typename T, int HS>
__global__ void __launch_bounds__(kPfThreads) attention_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* __restrict__ start_arr, const int* __restrict__ valid_arr,
    T* __restrict__ out, int T_len, int H, int KVH, int S, int L, int layer, float scale) {
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

  for (int k0 = 0; k0 <= q_pos_max && k0 < S; k0 += kPfTile) {
    __syncthreads();  // the previous tile's k/v/p are consumed
    for (int i = tid; i < kPfTile * HS; i += kPfThreads) {
      const int c = i / HS, dd = i % HS;
      const bool in = k0 + c < S;
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
      const bool live = t < t_end && col < S && col <= start + t;
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
                  int S, int L, int layer, float scale, cudaStream_t st) {
  attention_decode_kernel<T, HS><<<dim3(KVH, B), kDecThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const T*)kc,
      (const T*)vc, (T*)out, H, KVH, S, L, layer, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HS>
int launch_prefill(const void* q, const void* k, const void* v, const void* start,
                   const void* valid, void* out, int B, int T_len, int H, int KVH,
                   int S, int L, int layer, float scale, cudaStream_t st) {
  constexpr size_t smem = prefill_smem_bytes<HS>();
  cudaError_t e = cudaFuncSetAttribute(attention_prefill_kernel<T, HS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bt = kPfRows / (H / KVH);
  const dim3 grid((T_len + bt - 1) / bt, KVH, B);
  attention_prefill_kernel<T, HS><<<grid, kPfThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)start, (const int*)valid,
      (T*)out, T_len, H, KVH, S, L, layer, scale);
  return (int)cudaGetLastError();
}

#define HIPLLAMA_HS_SWITCH(HS, T, CALL)                     \
  switch (HS) {                                             \
    case 8: return CALL(T, 8);                              \
    case 16: return CALL(T, 16);                            \
    case 32: return CALL(T, 32);                            \
    case 64: return CALL(T, 64);                            \
    case 128: return CALL(T, 128);                          \
    default: return (int)cudaErrorInvalidValue;             \
  }

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// dtype: 0 = float, 1 = bfloat16; HS in {8, 16, 32, 64, 128}; H / KVH <= 8.
extern "C" int attention_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* pos, const void* k_cur, const void* v_cur,
                                void* out, int B, int H, int KVH, int S, int HS, int L,
                                int layer, int dtype, void* stream) {
  if (H % KVH || H / KVH > kMaxM) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, N) \
  launch_decode<T, N>(q, k_cache, v_cache, pos, k_cur, v_cur, out, B, H, KVH, S, L, layer, scale, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// dtype: 0 = float, 1 = bfloat16; HS in {8, 16, 32, 64, 128}; 64 % (H / KVH) == 0.
extern "C" int attention_prefill(const void* q, const void* k_cache, const void* v_cache,
                                 const void* start, const void* valid, void* out, int B,
                                 int T_len, int H, int KVH, int S, int HS, int L, int layer,
                                 int dtype, void* stream) {
  if (H % KVH || kPfRows % (H / KVH)) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, N) \
  launch_prefill<T, N>(q, k_cache, v_cache, start, valid, out, B, T_len, H, KVH, S, L, layer, scale, st)
  if (dtype == 0) {
    HIPLLAMA_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}
