// One-token GQA attention over the dense KV cache (B, L, KVH, S, HS), as a
// device function of one (KV head, slot) task, shared by attention.cu
// (attention_decode, attention_decode_fused) and layer_fused.cu
// (q8_layer_fused).
//
// The kv_mul query heads of KV head g in slot b attend over cache rows
// 0..pos[b]-1 of layer `layer`, then the current row k_cur/v_cur is folded
// in last, as the JAX kernels' _final does. Cast points (attention.py:
// 164-241): q in the cache dtype for QK, fp32 scores and softmax state (m,
// l, acc), probabilities exp(s - running max) rounded to the V dtype before
// PV, output in q's dtype. The running max advances once per block of bk
// cache rows (bk <= kDecTile); BK > 0 fixes the block at compile time, BK
// == 0 takes it from the argument.
//
// The task streams its rows with coalesced warp loads and keeps the query
// heads of the group in shared memory, so each K/V byte is read once for all
// heads that share it. Operands are addressed through slot strides (q_bs,
// cur_bs), so q, k_cur and v_cur may be read in place from a head-split QKV
// projection. The kernels run it on CTAs of kDecThreads threads, so that
// the decode kernels and the fused layer sum (and round) alike.
#pragma once

#include <math.h>

#include "common.cuh"

namespace hipllama {

constexpr int kDecTile = 64;     // cache rows per tile
constexpr int kMaxM = 8;         // query heads per KV head (kv_mul)
constexpr int kDecThreads = 256; // threads per task (NT) in the kernels

template <int HS, int NT>
struct DecodeSmem {
  __align__(16) float q_s[kMaxM][HS];  // q, as the cache dtype, widened
  float p_s[kMaxM][kDecTile];          // scores, then rounded probabilities
  float red_s[kMaxM][NT];              // PV partial sums over row groups
  float m_s[kMaxM], l_s[kMaxM], a_s[kMaxM], pc_s[kMaxM];
};

template <typename T, int HS, int NT, int BK>
__device__ __forceinline__ void decode_attention_task(
    DecodeSmem<HS, NT>& sm, int g, int b, const T* q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* pos_arr, const T* k_cur, const T* v_cur,
    T* __restrict__ out, int H, int KVH, int S, int L, int layer, float scale, int q_bs,
    int cur_bs, int bk_arg) {
  constexpr int kWarps = NT / 32;
  constexpr int LPR = HS / 4;   // lanes per K row in QK (4 elements each)
  constexpr int RPW = 32 / LPR; // K rows per warp per pass
  constexpr int RG = NT / HS;   // row groups in PV (each thread owns one dim)
  // a warp's RPW rows are all inside the tile or all past it, so the
  // shuffles of the score loop stay convergent
  static_assert(kDecTile % RPW == 0, "a warp's rows must not straddle the tile");
  const int bk = BK > 0 ? BK : bk_arg;
  const int M = H / KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];

  __syncthreads();  // the previous task's readers of sm are done
  const T* qb = q + (size_t)b * q_bs + (size_t)g * M * HS;
  for (int i = tid; i < M * HS; i += NT) sm.q_s[i / HS][i % HS] = to_f(qb[i]);
  if (tid < kMaxM) {
    sm.m_s[tid] = -INFINITY;
    sm.l_s[tid] = 0.f;
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

  for (int t0 = 0; t0 < pos; t0 += bk) {
    const int n = min(bk, pos - t0);
    // scores: LPR lanes per row, reduced with shuffles. The unroll counts
    // here and in PV are spelled out: left to itself the compiler unrolled
    // these loops less once the task was a function of its own, and the
    // kernel ran 14% slower than with its loops written inline.
#pragma unroll 4
    for (int r = warp * RPW + lane / LPR; r < kDecTile; r += kWarps * RPW) {
      float kf[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < n) load4(kb + (size_t)(t0 + r) * HS + c0, kf);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          float qf[4];
          load4(&sm.q_s[m][c0], qf);
          float s = qf[0] * kf[0] + qf[1] * kf[1] + qf[2] * kf[2] + qf[3] * kf[3];
          s = warp_sum(s, LPR);
          if (lane % LPR == 0) sm.p_s[m][r] = r < n ? s * scale : -INFINITY;
        }
      }
    }
    __syncthreads();
    // online softmax, one warp per query head
    for (int m = warp; m < M; m += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < kDecTile; r += 32) mx = fmaxf(mx, sm.p_s[m][r]);
      mx = warp_max(mx);  // finite: the tile holds at least one live row
      const float m_old = sm.m_s[m];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kDecTile; r += 32) {
        const float p = r < n ? expf(sm.p_s[m][r] - m_new) : 0.f;
        sum += p;
        sm.p_s[m][r] = round_to<T>(p);
      }
      sum = warp_sum(sum, 32);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm.a_s[m] = alpha;
        sm.l_s[m] = alpha * sm.l_s[m] + sum;
        sm.m_s[m] = m_new;
      }
    }
    __syncthreads();
    // PV: thread (rg, d) sums rows rg, rg + RG, ... of the tile
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) acc[m] *= sm.a_s[m];
#pragma unroll 8
    for (int r = rg; r < n; r += RG) {
      const float v = to_f(vb[(size_t)(t0 + r) * HS + d]);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) acc[m] += sm.p_s[m][r] * v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < M) sm.red_s[m][tid] = acc[m];
  // the current row: s_cur = q . k_cur in q's dtype, p_cur stays fp32
  const T* kc = k_cur + (size_t)b * cur_bs + (size_t)g * HS;
  for (int m = warp; m < M; m += kWarps) {
    float s = 0.f;
    for (int i = lane; i < HS; i += 32) s += sm.q_s[m][i] * to_f(kc[i]);
    s = warp_sum(s, 32) * scale;
    if (lane == 0) {
      const float m_new = fmaxf(sm.m_s[m], s);
      const float alpha = expf(sm.m_s[m] - m_new);
      const float p_cur = expf(s - m_new);
      sm.a_s[m] = alpha;
      sm.pc_s[m] = p_cur;
      sm.l_s[m] = alpha * sm.l_s[m] + p_cur;
    }
  }
  __syncthreads();
  if (tid < HS) {
    const float vcur = to_f(v_cur[(size_t)b * cur_bs + (size_t)g * HS + tid]);
    for (int m = 0; m < M; ++m) {
      float o = 0.f;
      for (int i = 0; i < RG; ++i) o += sm.red_s[m][i * HS + tid];
      o = o * sm.a_s[m] + sm.pc_s[m] * vcur;
      const float l = sm.l_s[m];
      out[((size_t)b * H + (size_t)g * M + m) * HS + tid] = from_f<T>(o / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace hipllama

// dispatch on the head size: CALL(T, HS) for HS in {8, 16, 32, 64, 128}
#define HIPLLAMA_HS_SWITCH(HS, T, CALL)                     \
  switch (HS) {                                             \
    case 8: return CALL(T, 8);                              \
    case 16: return CALL(T, 16);                            \
    case 32: return CALL(T, 32);                            \
    case 64: return CALL(T, 64);                            \
    case 128: return CALL(T, 128);                          \
    default: return (int)cudaErrorInvalidValue;             \
  }
