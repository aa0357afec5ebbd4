// One-token GQA attention over the KV cache, as a device function of one
// (KV head, slot) task, shared by attention.cu (attention_decode,
// attention_decode_fused, attention_decode_paged) and layer_fused.cu
// (q8_layer_fused).
//
// The kv_mul query heads of KV head g in slot b attend over cache rows
// 0..pos[b]-1 of layer `layer`, then the current row k_cur/v_cur is folded
// in last, as the JAX kernels' _final does. Cast points (attention.py:
// 164-241): q in the cache dtype for QK, fp32 scores and softmax state (m,
// l, acc), probabilities exp(s - running max) rounded to the V dtype before
// PV, output in q's dtype. The running max advances once per block of bk
// cache rows, the JAX kernel's KV block: the block decides the max at which
// the probabilities round, so the task holds a whole block's M x bk fp32
// scores in the dynamic shared memory that follows its struct (p_s), takes
// the block's max, and then rounds the probabilities and does PV.
//
// The task streams its rows with coalesced warp loads and keeps the query
// heads of the group in shared memory, so each K/V byte is read once for all
// heads that share it. Operands are addressed through slot strides (q_bs,
// cur_bs), so q, k_cur and v_cur may be read in place from a head-split QKV
// projection. The kernels run it on CTAs of kDecThreads threads, so that
// the decode kernels and the fused layer sum (and round) alike.
//
// Head sizes: the task is compiled for HS in {8, 16, 32, 64, 128, 256} and
// takes any head size hs <= HS that is a multiple of 8 (decode_hs_pad picks
// HS): the q rows are zero past hs and the lanes past hs load nothing, so a
// padded score sums the same terms and the padded output dims are not
// written. PAD false compiles the task for hs == HS, whose masks and
// strides then fold away. Decode is bound by the bytes of the live K/V rows, which padding
// does not grow (rows are addressed at their own stride hs); it costs idle
// lanes. Query heads per KV head: a task takes at most kMaxM of the M heads
// that share KV head g, heads m0 .. m0 + min(kMaxM, M - m0) - 1 (the
// kernels launch ceil(M / kMaxM) tasks per KV head; each head's arithmetic
// is its own, so the split changes no value).
//
// Where a row lives is the task's row policy, a functor from the row's
// position r to its index in the cache planes (in rows of HS elements; the
// scale planes hold one fp32 per row at the same index): ContiguousRows for
// the dense cache (B, L, KVH, S, HS), PagedRows for the paged pool (L, KVH,
// P, PS, HS), where row r of slot b lives in page table[b, r / PS] at offset
// r % PS. A block of rows that lies in one page (every block, where the
// block divides the page) is addressed from its first row with one table
// load (BlockRows); a block that spans pages looks each row's page up. The
// policy changes addresses only: the arithmetic, and so the rounding, is
// the same for both.
#pragma once

#include <math.h>

#include "common.cuh"

namespace hipllama {

constexpr int kDecTile = 64;     // cache rows per tile
constexpr int kMaxM = 8;         // query heads of one task (of one KV head)
constexpr int kDecThreads = 256; // threads per task (NT) in the kernels

// the compiled head size that serves head size hs (a multiple of 8 up to
// 256): the next power of two; 0 where none does
__host__ __device__ constexpr int decode_hs_pad(int hs) {
  return hs < 8 || hs % 8 || hs > 256 ? 0 : hs <= 8 ? 8 : hs <= 16 ? 16 : hs <= 32 ? 32
         : hs <= 64 ? 64 : hs <= 128 ? 128 : 256;
}
// the tasks of a KV head: groups of at most kMaxM of its M query heads
__host__ __device__ constexpr int head_groups(int M) { return (M + kMaxM - 1) / kMaxM; }

// row r of one (slot, KV head) of the dense cache: rows in order
struct ContiguousRows {
  size_t row0;  // ((b * L + layer) * KVH + g) * S
  __device__ __forceinline__ size_t operator()(int r) const { return row0 + (size_t)r; }
  // rows t0 .. t0 + n - 1 are base + (r - t0): always
  __device__ __forceinline__ bool span(int t0, int n, size_t& base) const {
    base = row0 + (size_t)t0;
    return true;
  }
};

// row r of one (slot, KV head) of the paged pool, through the slot's page
// table row
struct PagedRows {
  const int* table;  // the slot's page-table row
  size_t page0;      // (layer * KVH + g) * P: page 0 of the (layer, head) plane
  int ps;
  __device__ __forceinline__ size_t operator()(int r) const {
    return (page0 + (size_t)table[r / ps]) * ps + (size_t)(r % ps);
  }
  // rows t0 .. t0 + n - 1 are base + (r - t0) where they lie in one page
  __device__ __forceinline__ bool span(int t0, int n, size_t& base) const {
    base = (*this)(t0);
    return t0 % ps + n <= ps;
  }
};

// row t0 + r of a block of n rows that starts at row t0: one add from the
// block's first row where the policy says the block is consecutive, else
// the policy's own lookup
template <typename Rows>
struct BlockRows {
  Rows rows;
  int t0;
  size_t base;
  bool consecutive;
  __device__ __forceinline__ BlockRows(const Rows& rw, int t0_, int n) : rows(rw), t0(t0_) {
    consecutive = rw.span(t0_, n, base);
  }
  __device__ __forceinline__ size_t operator()(int r) const {
    return consecutive ? base + (size_t)r : rows(t0 + r);
  }
};

// The two caches as kernel arguments: rows(b, g) is the row policy of slot
// b's KV head g in layer `layer`.
struct ContiguousCache {
  int L, KVH, S, layer;
  __device__ __forceinline__ ContiguousRows rows(int b, int g) const {
    return {(((size_t)b * L + layer) * KVH + g) * (size_t)S};
  }
};
struct PagedCache {
  const int* table;  // (B, max_pages) int32
  int max_pages, KVH, P, PS, layer;
  __device__ __forceinline__ PagedRows rows(int b, int g) const {
    return {table + (size_t)b * max_pages, ((size_t)layer * KVH + g) * P, PS};
  }
};

template <int HS, int NT>
struct DecodeSmem {
  __align__(16) float q_s[kMaxM][HS];  // q, as the cache dtype, widened
  float red_s[kMaxM][NT];              // PV partial sums over row groups
  float m_s[kMaxM], l_s[kMaxM], a_s[kMaxM], pc_s[kMaxM];
};

template <typename T, int HS, int NT, typename Rows, bool PAD = true>
__device__ __forceinline__ void decode_attention_task(
    DecodeSmem<HS, NT>& sm, float* p_s, int g, int b, const T* q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const Rows rows, const int* pos_arr, const T* k_cur,
    const T* v_cur, T* __restrict__ out, int H, int KVH, float scale, int q_bs, int cur_bs,
    int bk, int hs_arg, int m0) {
  const int hs = PAD ? hs_arg : HS;
  constexpr int kWarps = NT / 32;
  constexpr int LPR = HS / 4 < 32 ? HS / 4 : 32;  // lanes per K row in QK
  constexpr int EPL = HS / LPR;                    // elements a lane takes (4, or 8 at 256)
  constexpr int RPW = 32 / LPR;                    // K rows per warp per pass
  constexpr int RG = NT / HS;                      // row groups in PV (each thread owns one dim)
  // a warp's RPW rows are all inside the tile or all past it, so the
  // shuffles of the score loop stay convergent
  static_assert(kDecTile % RPW == 0, "a warp's rows must not straddle the tile");
  const int M = H / KVH;
  const int MC = min(kMaxM, M - m0);  // the task's query heads
  const int head0 = g * M + m0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];

  __syncthreads();  // the previous task's readers of sm and p_s are done
  const T* qb = q + (size_t)b * q_bs + (size_t)head0 * hs;
  for (int i = tid; i < MC * HS; i += NT) {
    const int m = i / HS, dd = i % HS;
    sm.q_s[m][dd] = dd < hs ? to_f(qb[m * hs + dd]) : 0.f;
  }
  if (tid < kMaxM) {
    sm.m_s[tid] = -INFINITY;
    sm.l_s[tid] = 0.f;
  }
  __syncthreads();

  const int d = tid % HS, rg = tid / HS;
  const int c0 = (lane % LPR) * 4;
  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  for (int t0 = 0; t0 < pos; t0 += bk) {
    const int n = min(bk, pos - t0);
    const BlockRows<Rows> row(rows, t0, n);
    // scores of the block's rows, a tile of kDecTile rows at a time: LPR
    // lanes per row, reduced with shuffles. The unroll counts here and in
    // PV are spelled out: left to itself the compiler unrolled these loops
    // less once the task was a function of its own, and the kernel ran 14%
    // slower than with its loops written inline.
    for (int r0 = 0; r0 < n; r0 += kDecTile) {
#pragma unroll 4
      for (int r = r0 + warp * RPW + lane / LPR; r < r0 + kDecTile; r += kWarps * RPW) {
        float kf[EPL];
#pragma unroll
        for (int j = 0; j < EPL; ++j) kf[j] = 0.f;
#pragma unroll
        for (int j = 0; j < EPL / 4; ++j) {
          const int c = c0 + 4 * LPR * j;
          if (r < n && c < hs) load4(k_cache + row(r) * hs + c, kf + 4 * j);
        }
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < MC) {
            float qf[4];
            load4(&sm.q_s[m][c0], qf);
            float s = qf[0] * kf[0] + qf[1] * kf[1] + qf[2] * kf[2] + qf[3] * kf[3];
#pragma unroll
            for (int j = 1; j < EPL / 4; ++j) {
              load4(&sm.q_s[m][c0 + 4 * LPR * j], qf);
              s += qf[0] * kf[4 * j] + qf[1] * kf[4 * j + 1] + qf[2] * kf[4 * j + 2] +
                   qf[3] * kf[4 * j + 3];
            }
            s = warp_sum(s, LPR);
            if (lane % LPR == 0 && r < n) p_s[m * bk + r] = s * scale;
          }
        }
      }
    }
    __syncthreads();
    // online softmax over the block, one warp per query head
    for (int m = warp; m < MC; m += kWarps) {
      float* pm = p_s + m * bk;
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, pm[r]);
      mx = warp_max(mx);  // finite: the block holds at least one live row
      const float m_old = sm.m_s[m];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(pm[r] - m_new);
        sum += p;
        pm[r] = round_to<T>(p);
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
    // PV: thread (rg, d) sums rows rg, rg + RG, ... of the block
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < MC) acc[m] *= sm.a_s[m];
    if (d < hs) {
#pragma unroll 8
      for (int r = rg; r < n; r += RG) {
        const float v = to_f(v_cache[row(r) * hs + d]);
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (m < MC) acc[m] += p_s[m * bk + r] * v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < MC) sm.red_s[m][tid] = acc[m];
  // the current row: s_cur = q . k_cur in q's dtype, p_cur stays fp32
  const T* kc = k_cur + (size_t)b * cur_bs + (size_t)g * hs;
  for (int m = warp; m < MC; m += kWarps) {
    float s = 0.f;
    for (int i = lane; i < hs; i += 32) s += sm.q_s[m][i] * to_f(kc[i]);
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
  if (tid < hs) {
    const float vcur = to_f(v_cur[(size_t)b * cur_bs + (size_t)g * hs + tid]);
    for (int m = 0; m < MC; ++m) {
      float o = 0.f;
      for (int i = 0; i < RG; ++i) o += sm.red_s[m][i * HS + tid];
      o = o * sm.a_s[m] + sm.pc_s[m] * vcur;
      const float l = sm.l_s[m];
      out[((size_t)b * H + head0 + m) * hs + tid] = from_f<T>(o / (l == 0.f ? 1.f : l));
    }
  }
}

// ---------------------------------------------------------------------------
// The same task over an int8 cache with one fp32 scale per row (k_scale,
// v_scale: (B, L, KVH, S), or (L, KVH, P, PS) for the paged pool), with the
// int8 dots of the JAX kernels'
// HIPLLAMA_ATTN_I8MXU path (attention.py:88-93, :300-383):
//   - q (its own dtype T, fp32 or bf16) widened to fp32 and quantized by
//     row: sq = max|q| * (1/127) (1 where zero), qi = round-half-even(q/sq);
//   - scores = fp32(int32(qi . k)) * (sq * scale) * ks[row];
//   - the online softmax advances once per block of bk rows; (p * vs[row])
//     is quantized by row over the block's rows, sp = max|p vs| * (1/127),
//     and dotted as int32 with the int8 V rows: acc = acc * alpha +
//     fp32(int32) * sp;
//   - the current row stays unquantized: q . k_cur in q's dtype with fp32
//     sums, v_cur in fp32, as _final.
// The block is part of the numerics (it decides which probabilities share
// an int8 scale), so the task holds a whole block's scores, M x bk fp32, in
// the shared memory at p_s that follows sm, as the task above does. QK uses dp4a on
// packed int8 words (HS / 4 lanes per row), PV one int8 per thread and
// row, both exact in int32.
template <int HS, int NT>
struct DecodeSmemInt8 {
  __align__(16) float q_s[kMaxM][HS];  // q in its dtype, widened
  int qw_s[kMaxM][HS / 4];             // q quantized, four int8 per word
  float red_s[kMaxM][NT];              // PV partial sums over row groups
  float m_s[kMaxM], l_s[kMaxM], a_s[kMaxM], pc_s[kMaxM], sq_s[kMaxM], sp_s[kMaxM];
};

template <typename T, int HS, int NT, typename Rows, bool PAD = true>
__device__ __forceinline__ void decode_attention_task_int8(
    DecodeSmemInt8<HS, NT>& sm, float* p_s, int g, int b, const T* q,
    const signed char* __restrict__ k_cache, const signed char* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const Rows rows,
    const int* pos_arr, const T* k_cur, const T* v_cur, T* __restrict__ out, int H, int KVH,
    float scale, int q_bs, int cur_bs, int bk, int hs_arg, int m0) {
  const int hs = PAD ? hs_arg : HS;
  constexpr int kWarps = NT / 32;
  constexpr int LPR = HS / 4 < 32 ? HS / 4 : 32;  // lanes per K row in QK
  constexpr int WPL = HS / 4 / LPR;                // int8x4 words a lane takes (1, or 2 at 256)
  constexpr int RPW = 32 / LPR;                    // K rows per warp per pass
  constexpr int RG = NT / HS;                      // row groups in PV (each thread owns one dim)
  const int M = H / KVH;
  const int MC = min(kMaxM, M - m0);  // the task's query heads
  const int head0 = g * M + m0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];

  __syncthreads();  // the previous task's readers of sm and p_s are done
  const T* qb = q + (size_t)b * q_bs + (size_t)head0 * hs;
  for (int i = tid; i < MC * HS; i += NT) {
    const int m = i / HS, dd = i % HS;
    sm.q_s[m][dd] = dd < hs ? to_f(qb[m * hs + dd]) : 0.f;
  }
  __syncthreads();
  for (int m = warp; m < MC; m += kWarps) {
    float am = 0.f;
    for (int i = lane; i < HS; i += 32) am = fmaxf(am, fabsf(sm.q_s[m][i]));
    am = warp_max(am);
    float sq = am * (1.0f / 127.0f);
    if (sq == 0.f) sq = 1.f;
    for (int w = lane; w < HS / 4; w += 32) {
      unsigned int word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= ((unsigned int)__float2int_rn(sm.q_s[m][4 * w + j] / sq) & 0xffu) << (8 * j);
      sm.qw_s[m][w] = (int)word;
    }
    if (lane == 0) {
      sm.sq_s[m] = sq * scale;
      sm.m_s[m] = -INFINITY;
      sm.l_s[m] = 0.f;
    }
  }
  __syncthreads();

  const int d = tid % HS, rg = tid / HS;
  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  for (int t0 = 0; t0 < pos; t0 += bk) {
    const int n = min(bk, pos - t0);
    const BlockRows<Rows> block_row(rows, t0, n);
    // scores of the block's live rows; the loop bound is warp-uniform, so
    // the shuffles stay convergent
    for (int r0 = warp * RPW; r0 < n; r0 += kWarps * RPW) {
      const int r = r0 + lane / LPR, w = lane % LPR;
      const bool live = r < n;
      const size_t row = live ? block_row(r) : 0;
      int kw[WPL];
#pragma unroll
      for (int j = 0; j < WPL; ++j)
        kw[j] = live && 4 * (w + LPR * j) < hs
                    ? *reinterpret_cast<const int*>(k_cache + row * hs + 4 * (w + LPR * j))
                    : 0;
      const float ks = live ? k_scale[row] : 0.f;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < MC) {
          int dot = 0;
#pragma unroll
          for (int j = 0; j < WPL; ++j) dot = __dp4a(sm.qw_s[m][w + LPR * j], kw[j], dot);
          const int si = warp_sum_int(dot, LPR);
          if (w == 0 && live) p_s[m * bk + r] = (float)si * sm.sq_s[m] * ks;
        }
      }
    }
    __syncthreads();
    // online softmax and the quantization of p * vs, one warp per query head
    for (int m = warp; m < MC; m += kWarps) {
      float* pm = p_s + m * bk;
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, pm[r]);
      mx = warp_max(mx);  // finite: the block holds at least one live row
      const float m_old = sm.m_s[m];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f, am = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(pm[r] - m_new);
        sum += p;
        const float pv = p * v_scale[block_row(r)];
        pm[r] = pv;
        am = fmaxf(am, fabsf(pv));
      }
      sum = warp_sum(sum, 32);
      am = warp_max(am);
      float sp = am * (1.0f / 127.0f);
      if (sp == 0.f) sp = 1.f;
      int* pim = reinterpret_cast<int*>(pm);  // each lane rewrites its own entries
      for (int r = lane; r < n; r += 32) pim[r] = __float2int_rn(pm[r] / sp);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm.a_s[m] = alpha;
        sm.l_s[m] = alpha * sm.l_s[m] + sum;
        sm.m_s[m] = m_new;
        sm.sp_s[m] = sp;
      }
    }
    __syncthreads();
    // PV in int32: thread (rg, d) sums rows rg, rg + RG, ... of the block
    const int* pi = reinterpret_cast<const int*>(p_s);
    int ai[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) ai[m] = 0;
    if (d < hs) {
#pragma unroll 4
      for (int r = rg; r < n; r += RG) {
        const int v = v_cache[block_row(r) * hs + d];
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (m < MC) ai[m] += pi[m * bk + r] * v;
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < MC) acc[m] = acc[m] * sm.a_s[m] + (float)ai[m] * sm.sp_s[m];
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < MC) sm.red_s[m][tid] = acc[m];
  // the current row: s_cur = q . k_cur in q's dtype, p_cur stays fp32
  const T* kc = k_cur + (size_t)b * cur_bs + (size_t)g * hs;
  for (int m = warp; m < MC; m += kWarps) {
    float s = 0.f;
    for (int i = lane; i < hs; i += 32) s += sm.q_s[m][i] * to_f(kc[i]);
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
  if (tid < hs) {
    const float vcur = to_f(v_cur[(size_t)b * cur_bs + (size_t)g * hs + tid]);
    for (int m = 0; m < MC; ++m) {
      float o = 0.f;
      for (int i = 0; i < RG; ++i) o += sm.red_s[m][i * HS + tid];
      o = o * sm.a_s[m] + sm.pc_s[m] * vcur;
      const float l = sm.l_s[m];
      out[((size_t)b * H + head0 + m) * hs + tid] = from_f<T>(o / (l == 0.f ? 1.f : l));
    }
  }
}

// dynamic shared memory of one task: its struct, then M x bk fp32 scores
// (M: the task's query heads, at most kMaxM)
template <int HS, int NT>
constexpr size_t decode_smem(int M, int bk) {
  return sizeof(DecodeSmem<HS, NT>) + sizeof(float) * (size_t)M * bk;
}
template <int HS, int NT>
constexpr size_t decode_int8_smem(int M, int bk) {
  return sizeof(DecodeSmemInt8<HS, NT>) + sizeof(float) * (size_t)M * bk;
}

}  // namespace hipllama

// dispatch on the head size hs (a multiple of 8 up to 256): CALL(T, N) with
// N = decode_hs_pad(hs), the task compiled for it
#define HIPLLAMA_DECODE_HS_SWITCH(hs, T, CALL)              \
  switch (hipllama::decode_hs_pad(hs)) {                    \
    case 8: return CALL(T, 8);                              \
    case 16: return CALL(T, 16);                            \
    case 32: return CALL(T, 32);                            \
    case 64: return CALL(T, 64);                            \
    case 128: return CALL(T, 128);                          \
    case 256: return CALL(T, 256);                          \
    default: return (int)cudaErrorInvalidValue;             \
  }
