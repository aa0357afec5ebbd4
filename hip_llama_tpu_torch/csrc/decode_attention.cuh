// One-token GQA attention over the KV cache, as a device function of one
// (KV head, slot) task, shared by attention.cu (attention_decode,
// attention_decode_fused, attention_decode_paged) and layer_fused.cu
// (q8_layer_fused).
//
// The kv_mul query heads of KV head g in slot b attend over cache rows
// 0..pos[b]-1 of layer `layer`, then the current row k_cur/v_cur is folded
// in last, as the JAX kernels' _final does. The running max advances once
// per block of bk cache rows, the JAX kernel's KV block: the block decides
// the max at which the probabilities round (to the V dtype, or to int8 with
// one scale a block on an int8 cache), so a task takes a whole block's max
// before it rounds any. Both tasks hold a chunk of the block's scores in the
// dynamic shared memory that follows their struct (the whole block where it
// fits; a longer block is walked in chunks, its K tiles once more for the
// block's max), so no block is refused.
//
// A task's operands (q of its query heads, the current k and v rows of its
// KV head) reach shared memory through an operand policy: DirectOperands
// reads them from memory through slot strides (q_bs, cur_bs), so q, k_cur
// and v_cur may be read in place from a head-split QKV projection;
// layer_fused.cu's policy makes them from the QKV product's split-K
// partials. The kernels run the tasks on CTAs of kDecThreads threads, so
// that the decode kernels and the fused layer sum (and round) alike.
//
// Two tasks: decode_attention_task for fp32 and bf16 caches, and
// decode_attention_task_int8 for the int8 cache. Both stream the block's K
// and V tiles through an asynchronous shared-memory ring (see their notes).
//
// Head sizes: the tasks are compiled for HS in {8, 16, 32, 64, 128, 256} and
// take any head size hs <= HS that is a multiple of 8 (decode_hs_pad picks
// HS): the q rows are zero past hs and the lanes past hs load nothing, so a
// padded score sums the same terms and the padded output dims are not
// written. PAD false compiles the task for hs == HS, whose masks and
// strides then fold away. Decode is bound by the bytes of the live K/V rows,
// which padding does not grow (rows are addressed at their own stride hs).
// Query heads per KV head: a task takes at most kMaxM of the M heads that
// share KV head g, heads m0 .. m0 + min(kMaxM, M - m0) - 1 (the kernels
// launch ceil(M / kMaxM) tasks per KV head; each head's arithmetic is its
// own, so the split changes no value).
//
// Where a row lives is the task's row policy, a functor from the row's
// position r to its index in the cache planes (in rows of HS elements; the
// scale planes hold one fp32 per row at the same index): ContiguousRows for
// the dense cache (B, L, KVH, S, HS), PagedRows for the paged pool (L, KVH,
// P, PS, HS), where row r of slot b lives in page table[b, r / PS] at offset
// r % PS. A run of rows that lies in one page (every block, where the block
// divides the page) is addressed from its first row with one table load
// (BlockRows); a run that spans pages looks each row's page up. The policy
// changes addresses only: the arithmetic, and so the rounding, is the same
// for both.
#pragma once

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace hipllama {

constexpr int kMaxM = 8;         // query heads of one task (of one KV head)
constexpr int kDecThreads = 256; // threads per task (NT) in the kernels
constexpr size_t kSmemPerCta = 232448;  // the dynamic shared memory a CTA may take on an H100

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

// A task's operands read from memory: q (B, H, hs) and the current rows
// k_cur, v_cur (B, KVH, hs), a slot's heads contiguous, at slot strides q_bs
// and cur_bs (elements). load() brings the task's MC query heads (from
// head0), zero past hs up to HS, and KV head g's current rows into shared
// memory as fp32; every thread of the CTA takes part.
template <typename T>
struct DirectOperands {
  const T* q;
  const T* k_cur;
  const T* v_cur;
  int q_bs, cur_bs;
  template <int HS>
  __device__ __forceinline__ void load(int b, int g, int head0, int MC, int hs, float (*q_s)[HS],
                                       float* kc_s, float* vc_s) const {
    const T* qb = q + (size_t)b * q_bs + (size_t)head0 * hs;
    for (int i = threadIdx.x; i < MC * HS; i += blockDim.x) {
      const int m = i / HS, dd = i % HS;
      q_s[m][dd] = dd < hs ? to_f(qb[m * hs + dd]) : 0.f;
    }
    const size_t c0 = (size_t)b * cur_bs + (size_t)g * hs;
    for (int i = threadIdx.x; i < hs; i += blockDim.x) {
      kc_s[i] = to_f(k_cur[c0 + i]);
      vc_s[i] = to_f(v_cur[c0 + i]);
    }
  }
};

// The current row, folded in last by both tasks as the JAX kernels' _final:
// s_cur = q . k_cur in q's dtype with fp32 sums (a warp per query head),
// m_next = max(m, s_cur), alpha = exp(m - m_next), p_cur = exp(s_cur -
// m_next) in fp32, l = alpha l + p_cur. Ends with the CTA's barrier.
template <int HS, int NT>
__device__ __forceinline__ void fold_current_row(float (*q_s)[HS], const float* kc_s,
                                                 const float* m_s, float* l_s, float* a_s,
                                                 float* pc_s, int MC, int hs, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < MC; m += NT / 32) {
    float s = 0.f;
    for (int i = lane; i < hs; i += 32) s += q_s[m][i] * kc_s[i];
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
}

// ---------------------------------------------------------------------------
// The task over an fp32 or bf16 cache (T: the cache dtype, which q, the
// current rows and the output share), with the JAX kernel's cast points
// (attention.py:164-241):
//   - s = fp32(q . k) * scale, q in the cache dtype, fp32 products and sums;
//   - the online softmax advances once per block of bk rows: m_next = max(m,
//     the block's max), p = exp(s - m_next) in fp32, l = alpha l + sum(p)
//     over the unrounded p, and p rounded to T before PV;
//   - acc = acc * alpha + PV in fp32;
//   - the current row folded in last, unrounded (fold_current_row), and the
//     output o / l cast to T.
// Only the order of the fp32 sums is the task's own, and fixed: q . k over a
// lane's elements in order, then the LPR lanes' sums by shuffles; the sum of
// p over each thread's rows of a chunk (r = tid, tid + 256, ...) in order,
// then its warp by shuffles, the warps in order, the chunks in order; PV
// over each row group's rows in order, each group's acc scaled by the
// block's alpha, and the row groups added in order at the end (never by
// float atomics, so that two calls give the same bits).
//
// Bound on an H100: the bytes of the live K and V rows (2 hs sizeof(T) a
// row), far below the ridge; at one query head per KV head about 30 MFLOP a
// call. What holds a task is the bytes one CTA keeps in flight: its rows are
// one slot's, and at chip_smoke's positions the longest slot's 32 tasks read
// 256 KB each. The task walks a stream of tiles (KvTile: kKvTileBytes of
// rows, at most kKvTileRows rows) through a ring of kKvStages slots in
// shared memory filled by cp.async 16-byte copies (a row of a head size that
// is a multiple of 8 is whole 16-byte chunks, in either dtype) kKvStages - 1
// tiles ahead of the tile in use (48 KB in flight a CTA): V's copies go out
// with K's, and the next block's K tiles while this block's V tiles are in
// use. A slot's rows are swizzled by 16-byte chunk (KvTile::off) so that
// the 16-byte loads of a load phase hit 8 bank groups. Two CTAs an SM fit
// beside each other (kDecSmemBudget), so at Llama-2-7B's 256 tasks of a
// step every task is resident at once.
//
// A block's scores (then its rounded p) sit in the dynamic shared memory
// after sm, bc of its rows at a time (a chunk; the launchers take bc = bk
// where the block fits kDecSmemBudget, decode_chunk). A block of at most bc
// rows takes its K tiles, then its V tiles:
//   1. QK, a K tile at a time: LPR lanes a row, each one or two 16-byte
//      chunks of k (8 bf16 or 4 fp32 a chunk) widened to fp32 against the
//      same chunks of q (kept in T in shared memory), the LPR lanes' sums
//      added by shuffles; each row's score goes to the chunk's scores, and
//      each thread keeps its rows' max a head;
//   2. the softmax on every thread, a head at a time: the block's max from
//      the warps' maxima and the running max; each thread takes its own rows
//      (p = exp(s - m_next), the sum of p, p rounded to T in place); each
//      warp's sum to shared memory;
//   3. PV, a V tile at a time: thread (head, dims, row group) owns one
//      16-byte chunk of dims of one query head (acc: CH fp32 sums) and walks
//      the rows rg, rg + RG, ... of each tile, one 16-byte load a row;
//   4. the head's state (l, the running max) by one thread a head, after the
//      barrier of the block's first V tile; each PV thread scales its acc by
//      alpha (computed in step 2 from the same operands) before the block's
//      first PV.
// A longer block is walked in chunks of bc rows (a multiple of 256): its K
// tiles once for the block's max (1 without the stores), then each chunk's
// K tiles for its scores and p (1, 2) and its V tiles for PV (3), the
// chunks' sums of p added in chunk order. Every value is computed as in a
// block that fits, so only the order of the sum of p differs.

constexpr int kKvStages = 4;          // slots of the ring
constexpr int kKvTileBytes = 16384;   // bytes of one tile's rows, at most
constexpr int kKvTileRows = 256;      // rows of one tile, at most
// the dynamic shared memory each of two CTAs an SM may take on an H100
// (228 KB an SM, 1 KB of it reserved a CTA)
constexpr size_t kDecSmemBudget = (233472 - 2 * 1024) / 2;

template <typename T, int HS>
struct KvTile {
  static constexpr int CH = 16 / (int)sizeof(T);       // elements of a 16-byte chunk
  static constexpr int CPR = HS / CH;                  // chunks of a row (1 .. 64)
  static constexpr int ROW = HS * (int)sizeof(T);      // bytes of a row
  static constexpr int ROWS = kKvTileBytes / ROW < kKvTileRows ? kKvTileBytes / ROW : kKvTileRows;
  static constexpr int BYTES = ROWS * ROW;             // 16 KB from HS 32 (bf16), less below
  static constexpr int LPR = CPR < 2 ? 1 : CPR / 2;    // lanes a K row in QK
  static constexpr int NCH = CPR / LPR;                // chunks a lane takes in QK: 1 or 2
  static constexpr int PASSES = ROWS * LPR / 256;      // QK passes over a tile of 256 threads
  // the XOR of row r's 16-byte chunks: the 8 lanes of a QK load phase (8 /
  // LPR rows, each lane at one of its chunks; or 8 lanes of one row) land
  // in 8 different bank groups
  __device__ __forceinline__ static int swz(int r) {
    if (CPR >= 8) return LPR >= 8 ? 0 : (r % (8 / LPR)) * LPR;
    if (CPR == 4) return ((r >> 1) & 1) * 2;
    if (CPR == 2) return (r >> 2) & 1;
    return 0;
  }
  // the byte of a slot where 16-byte chunk c of row r starts
  __device__ __forceinline__ static int off(int r, int c) {
    return r * ROW + ((c ^ swz(r)) << 4);
  }
};

template <typename T, int HS, int NT>
struct DecodeSmem {
  __align__(16) unsigned char ring[kKvStages][KvTile<T, HS>::BYTES];
  __align__(16) T q_t[kMaxM][HS];      // q in the cache dtype, for QK
  __align__(16) float q_s[kMaxM][HS];  // q widened, for the current row
  float kc_s[HS], vc_s[HS];            // the current k and v rows, widened
  float red_max[NT / 32][kMaxM], red_sum[NT / 32][kMaxM];
  float m_s[kMaxM], l_s[kMaxM], a_s[kMaxM], pc_s[kMaxM];
  float tot_s[kMaxM];  // a chunked block's sum of p so far
};

// a 16-byte chunk of T (8 bf16 or 4 fp32), widened to fp32
__device__ __forceinline__ void widen16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int HS, int NT, typename Rows, typename Ops, bool PAD = true>
__device__ __forceinline__ void decode_attention_task(
    DecodeSmem<T, HS, NT>& sm, float* dyn, int g, int b, const Ops& ops,
    const T* __restrict__ k_cache, const T* __restrict__ v_cache, const Rows rows,
    const int* pos_arr, T* __restrict__ out, int H, int KVH, float scale, int bk, int bc,
    int hs_arg, int m0) {
  using Tile = KvTile<T, HS>;
  constexpr int kWarps = NT / 32;
  constexpr int CH = Tile::CH, ROWS = Tile::ROWS, LPR = Tile::LPR, NCH = Tile::NCH;
  constexpr int NA = (kMaxM * Tile::CPR + NT - 1) / NT;  // PV chunks a thread owns, at most
  constexpr int D = kKvStages;
  static_assert(NT == 256 && Tile::PASSES >= 1, "the QK passes assume 256 threads");
  const int hs = PAD ? hs_arg : HS;
  const int hc = PAD ? hs / CH : Tile::CPR;  // live chunks of a row
  const int M = H / KVH;
  const int MC = min(kMaxM, M - m0);  // the task's query heads
  const int head0 = g * M + m0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];
  float* p_s = dyn;  // MC x bc: the chunk's scores, then its rounded p
  auto chunks = [&](int n) { return (n + bc - 1) / bc; };

  // the producer's place in the stream: block t0, segment sg, tile pj. A
  // block of one chunk is the segments K, V; a longer one the K tiles of
  // each chunk (pre segments), then K, V of each chunk. issue() copies the
  // next tile into slot i % D and commits a group (empty past the stream,
  // so that each thread's groups count the tiles)
  int pt0 = 0, sg = 0, pj = 0;
  auto issue = [&](int i) {
    if (pt0 < pos) {
      const int n = min(bk, pos - pt0), nch = chunks(n), pre = nch > 1 ? nch : 0;
      const bool is_v = sg >= pre && ((sg - pre) & 1);
      const int c0 = (sg < pre ? sg : (sg - pre) >> 1) * bc, nc = min(bc, n - c0);
      const int j0 = pj * ROWS, nr = min(ROWS, nc - j0);
      const BlockRows<Rows> row(rows, pt0 + c0 + j0, nr);
      const uint32_t s0 = mma::smem_u32(sm.ring[i % D]);
      const T* plane = is_v ? v_cache : k_cache;
      for (int u = tid; u < nr * hc; u += NT) {
        const int r = u / hc, c = u - r * hc;
        mma::cp_async<16>(s0 + Tile::off(r, c), plane + row(r) * hs + c * CH, true);
      }
      if (j0 + ROWS < nc) {
        ++pj;
      } else {
        pj = 0;
        if (++sg == pre + 2 * nch) {
          sg = 0;
          pt0 += bk;
        }
      }
    }
    mma::cp_async_commit();
  };

  __syncthreads();  // the previous task's readers of sm and dyn are done
  for (int i = 0; i < D - 1; ++i) issue(i);
  ops.template load<HS>(b, g, head0, MC, hs, sm.q_s, sm.kc_s, sm.vc_s);
  if (tid < kMaxM) {
    sm.m_s[tid] = -INFINITY;
    sm.l_s[tid] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < MC * HS; i += NT) (&sm.q_t[0][0])[i] = from_f<T>((&sm.q_s[0][0])[i]);
  // (the barrier in the first next() publishes q_t)

  int it = 0;  // the next tile of the stream to use
  // tile `it` has landed for every thread, and the slot used before it is
  // free for tile it + D - 1
  auto next = [&]() -> const unsigned char* {
    mma::cp_async_wait<D - 2>();
    __syncthreads();
    issue(it + D - 1);
    return sm.ring[it++ % D];
  };

  // the thread's PV chunks: (head, 16-byte chunk of dims) pairs, the chunk
  // fastest; RG row groups of MC * hc threads where they fit the CTA, else
  // one group with NA pairs a thread
  const int npair = MC * hc;
  const bool wide = npair > NT;
  const int RG = wide ? 1 : NT / npair;
  const int rg = wide ? 0 : tid / npair;
  int pm[NA], pdg[NA];
  bool pok[NA];
  float acc[NA][CH], alpha[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const int c = (wide ? tid : tid % npair) + k * NT;
    pok[k] = rg < RG && c < npair;
    pm[k] = pok[k] ? c / hc : 0;
    pdg[k] = pok[k] ? c % hc : 0;
    alpha[k] = 0.f;
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[k][e] = 0.f;
  }
  const int sub = tid % LPR;
  float mx[kMaxM];  // this thread's rows' max score a head

  // 1. QK over the K tile in slot st: rows j0 .. j0 + nr - 1 of the chunk
  auto qk = [&](const unsigned char* st, int j0, int nr, bool store) {
#pragma unroll
    for (int ps = 0; ps < Tile::PASSES; ++ps) {
      const int r = ps * (NT / LPR) + tid / LPR;
      const bool live = r < nr;
      float kf[NCH][CH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = sub + LPR * c;
        if (live && ch < hc) {
          widen16(reinterpret_cast<const T*>(st + Tile::off(r, ch)), kf[c]);
        } else {
#pragma unroll
          for (int e = 0; e < CH; ++e) kf[c][e] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < MC) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float qf[CH];
            widen16(&sm.q_t[m][(sub + LPR * c) * CH], qf);
#pragma unroll
            for (int e = 0; e < CH; ++e) dot += qf[e] * kf[c][e];
          }
          const float s = warp_sum(dot, LPR) * scale;
          if (live && sub == 0) {
            if (store) p_s[m * bc + j0 + r] = s;
            mx[m] = fmaxf(mx[m], s);
          }
        }
      }
    }
  };
  // each warp's max of the block's scores a head
  auto publish_max = [&]() {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < MC) {
        const float v = warp_max(mx[m]);
        if (lane == 0) sm.red_max[warp][m] = v;
      }
  };
  // the block's max of head m: the running max and the warps' maxima
  auto block_max = [&](int m) {
    float v = sm.m_s[m];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = fmaxf(v, sm.red_max[w][m]);
    return v;  // finite: the block holds at least one live row
  };
  // 2. p over the chunk's nc rows, a head at a time: each warp's sum of p;
  // on the block's first chunk also each PV chunk's alpha (the running max
  // is still the block before's)
  auto softmax = [&](int nc, bool first) {
    for (int m = 0; m < MC; ++m) {
      const float mn = block_max(m);
      float s = 0.f;
      for (int r = tid; r < nc; r += NT) {
        const float p = expf(p_s[m * bc + r] - mn);
        s += p;
        p_s[m * bc + r] = round_to<T>(p);
      }
      s = warp_sum(s, 32);
      if (lane == 0) sm.red_sum[warp][m] = s;
    }
    if (first) {
#pragma unroll
      for (int k = 0; k < NA; ++k)
        if (pok[k]) alpha[k] = expf(sm.m_s[pm[k]] - block_max(pm[k]));
    }
  };
  // 3. PV over the V tile in slot st: rows j0 .. j0 + nr - 1 of the chunk
  auto pv = [&](const unsigned char* st, int j0, int nr) {
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      if (pok[k]) {
        const float* pr = p_s + pm[k] * bc + j0;
#pragma unroll 4
        for (int r = rg; r < nr; r += RG) {
          float vf[CH];
          widen16(reinterpret_cast<const T*>(st + Tile::off(r, pdg[k])), vf);
          const float p = pr[r];
#pragma unroll
          for (int e = 0; e < CH; ++e) acc[k][e] += p * vf[e];
        }
      }
    }
  };

  for (int t0 = 0; t0 < pos; t0 += bk) {
    const int n = min(bk, pos - t0), nch = chunks(n);
    const bool chunked = nch > 1;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) mx[m] = -INFINITY;
    if (chunked) {  // the block's max (published by the barrier of the next tile)
      for (int c0 = 0; c0 < n; c0 += bc)
        for (int j0 = 0; j0 < min(bc, n - c0); j0 += ROWS)
          qk(next(), j0, min(ROWS, n - c0 - j0), false);
      publish_max();
    }
    for (int c0 = 0; c0 < n; c0 += bc) {
      const int nc = min(bc, n - c0), ntc = (nc + ROWS - 1) / ROWS;
      for (int j = 0; j < ntc; ++j) qk(next(), j * ROWS, min(ROWS, nc - j * ROWS), true);
      if (!chunked) publish_max();
      __syncthreads();  // the chunk's scores (and the block's max)
      softmax(nc, c0 == 0);
      for (int j = 0; j < ntc; ++j) {
        const unsigned char* st = next();  // its barrier publishes p and the warps' sums
        if (j == 0) {
          // 4. the head's state, now that the chunk's sums are in; no
          // thread reads m_s or the warps' sums again before the next
          // chunk's barriers
          if (tid < MC) {
            float tot = c0 == 0 ? 0.f : sm.tot_s[tid];
#pragma unroll
            for (int w = 0; w < kWarps; ++w) tot += sm.red_sum[w][tid];
            if (c0 + bc >= n) {
              const float mn = block_max(tid);
              const float a = expf(sm.m_s[tid] - mn);
              sm.l_s[tid] = a * sm.l_s[tid] + tot;
              sm.m_s[tid] = mn;
            } else {
              sm.tot_s[tid] = tot;
            }
          }
          if (c0 == 0) {
#pragma unroll
            for (int k = 0; k < NA; ++k)
#pragma unroll
              for (int e = 0; e < CH; ++e) acc[k][e] *= alpha[k];
          }
        }
        pv(st, j * ROWS, min(ROWS, nc - j * ROWS));
      }
    }
  }

  // the row groups' sums, in the ring (no copy is in flight: the stream's
  // trailing groups are empty), added in order by the owner of each (head,
  // dim) after the current row's barrier
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring's last readers are done; m_s and l_s are final
  float* red = reinterpret_cast<float*>(&sm.ring[0][0]);  // RG x MC x hs
#pragma unroll
  for (int k = 0; k < NA; ++k)
    if (pok[k])
#pragma unroll
      for (int e = 0; e < CH; ++e) red[(rg * MC + pm[k]) * hs + pdg[k] * CH + e] = acc[k][e];
  // the current row: s_cur = q . k_cur in q's dtype, p_cur stays fp32
  fold_current_row<HS, NT>(sm.q_s, sm.kc_s, sm.m_s, sm.l_s, sm.a_s, sm.pc_s, MC, hs, scale);
  for (int i = tid; i < MC * hs; i += NT) {
    const int m = i / hs, d = i - m * hs;
    float o = 0.f;
    for (int r = 0; r < RG; ++r) o += red[(r * MC + m) * hs + d];
    o = o * sm.a_s[m] + sm.pc_s[m] * sm.vc_s[d];
    const float l = sm.l_s[m];
    out[((size_t)b * H + head0 + m) * hs + d] = from_f<T>(o / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// The same task over an int8 cache with one fp32 scale per row (k_scale,
// v_scale: (B, L, KVH, S), or (L, KVH, P, PS) for the paged pool), with the
// int8 dots of the JAX kernels' HIPLLAMA_ATTN_I8MXU path (attention.py:
// 88-93, :300-383) and the plain version's cast points (ops/attention.py::
// _quant_rows, _online_softmax_pv):
//   - q (its own dtype T, fp32 or bf16) widened to fp32 and quantized by
//     row: sq = max|q| * (1/127) (1 where zero), qi = round-half-even(q/sq);
//   - s = fp32(int32(qi . k)) * (sq * scale) * ks[row];
//   - the online softmax advances once per block of bk rows: m_next = max(m,
//     the block's max), p = exp(s - m_next); (p * vs[row]) is quantized by
//     row over the block's rows, sp = max|p vs| * (1/127) (1 where zero),
//     pi = round-half-even(p vs / sp), a true division; PV is one int32 per
//     (head, dim) over the whole block, then one fp32 update, acc = acc *
//     alpha + fp32(int32) * sp, and l = alpha l + sum(p);
//   - the current row stays unquantized: q . k_cur in q's dtype with fp32
//     sums, v_cur in fp32, as _final.
// Both dots are exact in int32, so every integer is the plain version's;
// the fp32 sum of p is the task's own order (each thread's rows of a chunk,
// r = tid, tid + 256, ..., in order, then its warp, then the warps in
// order, then the chunks in order), which K5 and K23 share.
//
// Bound on an H100: the bytes of the live K and V rows and their scales
// (2 (hs + 4) bytes a row), far below the ridge. What holds a task is
// latency: its rows are one slot's, so one CTA must keep many bytes in
// flight. The task walks a stream of tiles (I8Tile<HS>::ROWS rows each:
// kI8TileBytes of int8 rows, at most kI8TileRows rows; a K tile also
// carries its rows' k and v scales) through a ring of kI8Stages slots in
// shared memory filled by cp.async 16-byte copies (8-byte where hs % 16 !=
// 0) kI8Stages - 1 tiles ahead of the tile in use: V's copies go out with
// K's, and the next block's K tiles while this block's V tiles are in use
// (32 KB in flight a CTA). A slot's rows are swizzled by 16-byte chunk
// (I8Tile::off) so that the QK loads of a load phase hit 8 bank groups.
//
// A block's scores, v scales and packed probabilities sit in the dynamic
// shared memory after sm, for bc of its rows at a time (a chunk; the
// launchers take bc = bk where the block fits the CTA's shared memory,
// decode_int8_chunk). A block of at most bc rows takes its K tiles, then
// its V tiles:
//   1. QK, a K tile at a time: LPR lanes a row, each a dp4a over 8 words
//      (two 16-byte loads) of q and k, the LPR lanes' sums added by
//      shuffles; each row's score goes to the chunk's scores, its v scale
//      beside them, and each thread keeps its rows' max a head;
//   2. the softmax on every thread, a head at a time: the block's max from
//      the warps' maxima; each thread takes a row at a time (exp, the sum of
//      p, the absmax of p vs); the warps' sums and absmax give l and sp;
//      each thread then rounds its rows' pi (p vs recomputed, the same
//      operations), and four lanes' bytes (four rows) are packed into a
//      word by shuffles;
//   3. PV, a V tile at a time: thread (dw, rg) takes word dw (4 dims) of
//      the rows of quads rg, rg + RG, ...: 4 rows' words transposed by byte
//      permutes into 4 dims' words of 4 rows, each a dp4a with the quad's pi
//      word of a head, summed in int32;
//   4. the row groups' int32 sums added by shared-memory atomics (exact in
//      any order); after the next barrier the thread that owns a (head,
//      dim) does its fp32 update (in the next block's first tile step, so
//      that the block needs no barrier of its own for it).
// A longer block is walked in chunks of bc rows (a multiple of 256), its K
// tiles three times: once for the block's max (1 without the stores), once
// for the sums of p and the absmax of p vs (2 without the pi), and then a
// chunk's K tiles for its scores and pi and its V tiles for PV (1 to 4,
// each chunk's int32 sums added to the block's). Every value is computed as
// in a block that fits, so only the order of the sum of p differs.
// MAXM bounds the task's query heads for its register arrays: kMaxM, or 1
// where the caller knows M is 1.

constexpr int kI8Stages = 5;        // slots of the ring
constexpr int kI8TileBytes = 8192;  // int8 rows of one tile, at most
constexpr int kI8TileRows = 256;    // rows of one tile, at most

template <int HS>
struct I8Tile {
  static constexpr int ROWS = kI8TileBytes / HS < kI8TileRows ? kI8TileBytes / HS : kI8TileRows;
  static constexpr int DATA = ROWS * HS;               // 8192 bytes from HS 32, less below
  static constexpr int WPL = HS / 4 < 8 ? HS / 4 : 8;  // words of a K row a lane takes in QK
  static constexpr int LPR = HS / 4 / WPL;             // lanes a K row: 1 up to HS 32, .. 8
  static constexpr int PASSES = ROWS * LPR / 256;      // QK passes over a tile of 256 threads
  static constexpr int STAGE = DATA + 8 * ROWS;        // the rows, then a K tile's ks and vs
  // the XOR of row r's 16-byte chunks: the 8 lanes of a QK load phase (8 /
  // LPR rows, each lane at one of its chunks) land in 8 different bank
  // groups
  __device__ __forceinline__ static int swz(int r) {
    if (HS >= 128) return (r % (8 / LPR)) * LPR;
    if (HS == 64) return ((r >> 1) & 1) * 2;
    if (HS == 32) return (r >> 2) & 1;
    return 0;
  }
  // the byte of a slot that holds byte `at` of row r
  __device__ __forceinline__ static int off(int r, int at) {
    return r * HS + (((at >> 4) ^ swz(r)) << 4) + (at & 15);
  }
};

template <int HS, int NT>
struct DecodeSmemInt8 {
  __align__(16) unsigned char ring[kI8Stages][I8Tile<HS>::STAGE];
  __align__(16) float q_s[kMaxM][HS];     // q in its dtype, widened
  __align__(16) int qw_s[kMaxM][HS / 4];  // q quantized, four int8 a word
  float kc_s[HS], vc_s[HS];               // the current k and v rows, widened
  int red_i[kMaxM][HS];                   // the block's PV sums over the row groups
  float red_max[NT / 32][kMaxM], red_sum[NT / 32][kMaxM], red_am[NT / 32][kMaxM];
  float m_s[kMaxM], l_s[kMaxM], a_s[kMaxM], pc_s[kMaxM], sq_s[kMaxM], sp_s[kMaxM];
  float tot_s[kMaxM], am_s[kMaxM];  // a chunked block's sum of p and absmax of p vs
};

// four words of four rows (w[i]: dims 4 dw .. 4 dw + 3 of row i) as four
// words of four dims (t[j]: dim 4 dw + j of rows 0..3, row i in byte i)
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t t[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <typename T, int HS, int NT, typename Rows, typename Ops, bool PAD = true,
          int MAXM = kMaxM>
__device__ __forceinline__ void decode_attention_task_int8(
    DecodeSmemInt8<HS, NT>& sm, float* dyn, int g, int b, const Ops& ops,
    const signed char* __restrict__ k_cache, const signed char* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const Rows rows,
    const int* pos_arr, T* __restrict__ out, int H, int KVH, float scale, int bk, int bc,
    int hs_arg, int m0) {
  using Tile = I8Tile<HS>;
  constexpr int kWarps = NT / 32;
  constexpr int ROWS = Tile::ROWS, WPL = Tile::WPL, LPR = Tile::LPR;
  constexpr int NCH = WPL / 4;  // 16-byte chunks of a lane's K words (0 at HS 8: 8 bytes)
  constexpr int DW = HS / 4;                          // words of a V row
  constexpr int RG = NT / DW;                         // row groups in PV
  constexpr int NACC = (MAXM * HS + NT - 1) / NT;     // (head, dim) sums a thread owns
  constexpr int D = kI8Stages;
  static_assert(NT == 256 && Tile::PASSES >= 1, "the QK passes assume 256 threads");
  const int hs = PAD ? hs_arg : HS;
  const int M = H / KVH;
  const int MC = min(MAXM, M - m0);  // the task's query heads
  const int head0 = g * M + m0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];
  const int bcq = (bc + 3) / 4;
  float* vs_s = dyn;      // the chunk's v scales
  float* p_s = dyn + bc;  // MC x bc: the chunk's scores
  int* pw_s = reinterpret_cast<int*>(p_s + (size_t)MC * bc);  // MC x bcq: pi, 4 rows a word
  // the segments of a block of n rows, each the tiles of one plane over one
  // chunk: a block of one chunk is K, V; a longer one K of each chunk twice
  // (pre segments), then K, V of each chunk
  auto chunks = [&](int n) { return (n + bc - 1) / bc; };

  // the producer's place in the stream: block t0, segment sg, tile pj.
  // issue() copies the next tile into slot i % D and commits a group (empty
  // past the stream, so that each thread's groups count the tiles)
  int pt0 = 0, sg = 0, pj = 0;
  auto issue = [&](int i) {
    if (pt0 < pos) {
      const int n = min(bk, pos - pt0), nch = chunks(n), pre = nch > 1 ? 2 * nch : 0;
      const bool is_v = sg >= pre && ((sg - pre) & 1);
      const int c0 = (sg < pre ? sg % nch : (sg - pre) >> 1) * bc, nc = min(bc, n - c0);
      const int j0 = pj * ROWS, nr = min(ROWS, nc - j0);
      const BlockRows<Rows> row(rows, pt0 + c0 + j0, nr);
      const uint32_t s0 = mma::smem_u32(sm.ring[i % D]);
      const signed char* plane = is_v ? v_cache : k_cache;
      if (hs % 16 == 0) {
        const int upr = hs >> 4;
        for (int u = tid; u < nr * upr; u += NT) {
          const int r = u / upr, c = u - r * upr;
          mma::cp_async<16>(s0 + Tile::off(r, c << 4), plane + row(r) * hs + (c << 4), true);
        }
      } else {
        const int upr = hs >> 3;
        for (int u = tid; u < nr * upr; u += NT) {
          const int r = u / upr, c = u - r * upr;
          mma::cp_async<8>(s0 + Tile::off(r, c << 3), plane + row(r) * hs + (c << 3), true);
        }
      }
      if (!is_v)
        for (int u = tid; u < 2 * nr; u += NT) {
          const bool v = u >= nr;
          const int r = v ? u - nr : u;
          mma::cp_async<4>(s0 + Tile::DATA + 4 * (v ? ROWS + r : r),
                           (v ? v_scale : k_scale) + row(r), true);
        }
      if (j0 + ROWS < nc) {
        ++pj;
      } else {
        pj = 0;
        if (++sg == pre + 2 * nch) {
          sg = 0;
          pt0 += bk;
        }
      }
    }
    mma::cp_async_commit();
  };

  __syncthreads();  // the previous task's readers of sm and dyn are done
  for (int i = 0; i < D - 1; ++i) issue(i);
  ops.template load<HS>(b, g, head0, MC, hs, sm.q_s, sm.kc_s, sm.vc_s);
  for (int i = tid; i < kMaxM * HS; i += NT) (&sm.red_i[0][0])[i] = 0;
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
  // (the barrier in the first next() publishes qw_s, sq_s, m_s and l_s)

  int it = 0;  // the next tile of the stream to use
  // tile `it` has landed for every thread, and the slot used before it is
  // free for tile it + D - 1
  auto next = [&]() -> const unsigned char* {
    mma::cp_async_wait<D - 2>();
    __syncthreads();
    issue(it + D - 1);
    return sm.ring[it++ % D];
  };

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  // 4. (of the block before) the owner of each (head, dim) takes the row
  // groups' int32 sum, does its fp32 update and clears the sum; run after a
  // barrier that follows the block's atomics and before the barrier after
  // which the next block's a_s and sp_s are written
  auto update = [&]() {
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int i = tid + k * NT, m = i / HS, d = i % HS;
      if (i < MC * HS) {
        if (d < hs) acc[k] = acc[k] * sm.a_s[m] + (float)sm.red_i[m][d] * sm.sp_s[m];
        sm.red_i[m][d] = 0;
      }
    }
  };
  const int sub = tid % LPR;
  const int dw = tid % DW, rg = tid / DW;
  float mx[MAXM];  // this thread's rows' max score a head

  // 1. QK over the K tile in slot st: rows j0 .. j0 + nr - 1 of the chunk
  auto qk = [&](const unsigned char* st, int j0, int nr, bool store) {
    const float* ks = reinterpret_cast<const float*>(st + Tile::DATA);
#pragma unroll
    for (int ps = 0; ps < Tile::PASSES; ++ps) {
      const int r = ps * (NT / LPR) + tid / LPR;
      const bool live = r < nr;
      int kw[WPL];
      if constexpr (NCH > 0) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int4 v = live ? *reinterpret_cast<const int4*>(
                                    st + Tile::off(r, 16 * (sub + LPR * c)))
                              : make_int4(0, 0, 0, 0);
          kw[4 * c] = v.x;
          kw[4 * c + 1] = v.y;
          kw[4 * c + 2] = v.z;
          kw[4 * c + 3] = v.w;
        }
      } else {  // HS 8: a row is two words
        const int2 v = live ? *reinterpret_cast<const int2*>(st + r * HS) : make_int2(0, 0);
        kw[0] = v.x;
        kw[WPL - 1] = v.y;
      }
      const float kscale = live ? ks[r] : 0.f;
      if (store && live && sub == 0) vs_s[j0 + r] = ks[ROWS + r];
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < MC) {
          int dot = 0;
          if constexpr (NCH > 0) {
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              const int4 qv = *reinterpret_cast<const int4*>(&sm.qw_s[m][4 * (sub + LPR * c)]);
              dot = __dp4a(qv.x, kw[4 * c], dot);
              dot = __dp4a(qv.y, kw[4 * c + 1], dot);
              dot = __dp4a(qv.z, kw[4 * c + 2], dot);
              dot = __dp4a(qv.w, kw[4 * c + 3], dot);
            }
          } else {
            const int2 qv = *reinterpret_cast<const int2*>(&sm.qw_s[m][0]);
            dot = __dp4a(qv.x, kw[0], dot);
            dot = __dp4a(qv.y, kw[WPL - 1], dot);
          }
          const int si = warp_sum_int(dot, LPR);
          if (live && sub == 0) {
            const float s = (float)si * sm.sq_s[m] * kscale;
            if (store) p_s[m * bc + j0 + r] = s;
            mx[m] = fmaxf(mx[m], s);
          }
        }
      }
    }
  };
  // each warp's max of the block's scores a head
  auto publish_max = [&]() {
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      if (m < MC) {
        const float v = warp_max(mx[m]);
        if (lane == 0) sm.red_max[warp][m] = v;
      }
  };
  // the block's max of head m: the running max and the warps' maxima
  auto block_max = [&](int m) {
    float v = sm.m_s[m];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = fmaxf(v, sm.red_max[w][m]);
    return v;  // finite: the block holds at least one live row
  };
  // 2. each warp's sum of p and absmax of p vs over the chunk's nc rows, a
  // head at a time
  auto sums = [&](int nc) {
    for (int m = 0; m < MC; ++m) {
      const float mn = block_max(m);
      float s = 0.f, a = 0.f;
      for (int r = tid; r < nc; r += NT) {
        const float p = expf(p_s[m * bc + r] - mn);
        s += p;
        a = fmaxf(a, fabsf(p * vs_s[r]));
      }
      s = warp_sum(s, 32);
      a = warp_max(a);
      if (lane == 0) {
        sm.red_sum[warp][m] = s;
        sm.red_am[warp][m] = a;
      }
    }
  };
  // ... and each chunk's pi, four rows (lanes 4k .. 4k + 3) packed into
  // lane 4k's word by shuffles; the loop bound is uniform, so the shuffles
  // converge. sp of head m from its absmax a.
  auto pack = [&](int nc, bool chunked) {
    for (int m = 0; m < MC; ++m) {
      const float mn = block_max(m);
      float a = 0.f;
      if (chunked) {
        a = sm.am_s[m];
      } else {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a = fmaxf(a, sm.red_am[w][m]);
      }
      float sp = a * (1.0f / 127.0f);
      if (sp == 0.f) sp = 1.f;
      for (int r0 = 0; r0 < nc; r0 += NT) {
        const int r = r0 + tid;
        const int pi =
            r < nc ? __float2int_rn((expf(p_s[m * bc + r] - mn) * vs_s[r]) / sp) : 0;
        const unsigned int byte = (unsigned int)pi & 0xffu;
        const unsigned int word = byte | __shfl_down_sync(0xffffffffu, byte, 1) << 8 |
                                  __shfl_down_sync(0xffffffffu, byte, 2) << 16 |
                                  __shfl_down_sync(0xffffffffu, byte, 3) << 24;
        if (r < nc && (lane & 3) == 0) pw_s[m * bcq + r / 4] = (int)word;
      }
    }
  };

  for (int t0 = 0; t0 < pos; t0 += bk) {
    const int n = min(bk, pos - t0), nch = chunks(n);
    const bool chunked = nch > 1;
    bool first = true;
    // the next tile; the block's first runs the update of the block before
    // after next()'s barrier
    auto tile = [&]() {
      const unsigned char* st = next();
      if (first && t0 > 0) update();
      first = false;
      return st;
    };
#pragma unroll
    for (int m = 0; m < MAXM; ++m) mx[m] = -INFINITY;
    if (chunked) {  // the block's max, then its sum of p and absmax of p vs
      for (int c0 = 0; c0 < n; c0 += bc)
        for (int j0 = 0; j0 < min(bc, n - c0); j0 += ROWS)
          qk(tile(), j0, min(ROWS, n - c0 - j0), false);
      publish_max();  // (published by the barrier after the first chunk's scores)
    }
    for (int pass = chunked ? 0 : 1; pass < 2; ++pass) {
      for (int c0 = 0; c0 < n; c0 += bc) {
        const int nc = min(bc, n - c0), ntc = (nc + ROWS - 1) / ROWS;
        for (int j = 0; j < ntc; ++j) qk(tile(), j * ROWS, min(ROWS, nc - j * ROWS), true);
        if (!chunked) publish_max();
        __syncthreads();  // the chunk's scores (and the block's max)
        if (pass == 0 || !chunked) {
          sums(nc);
          __syncthreads();
          if (chunked && tid < MC) {  // the block's sums, chunk by chunk
            float s = 0.f, a = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              s += sm.red_sum[w][tid];
              a = fmaxf(a, sm.red_am[w][tid]);
            }
            sm.tot_s[tid] = c0 == 0 ? s : sm.tot_s[tid] + s;
            sm.am_s[tid] = c0 == 0 ? a : fmaxf(sm.am_s[tid], a);
          }
          if (pass == 0) continue;
        }
        pack(nc, chunked);
        // 3. PV in int32 over the chunk's V tiles (the barrier in next()
        // publishes pw_s)
        const unsigned char* st0 = tile();
        if (c0 + bc >= n && tid < MC) {
          // the head's state, now that no thread reads m_s for the block;
          // read by the owners after PV
          const int m = tid;
          float tot = 0.f, a = 0.f;
          if (chunked) {
            tot = sm.tot_s[m];
            a = sm.am_s[m];
          } else {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              tot += sm.red_sum[w][m];
              a = fmaxf(a, sm.red_am[w][m]);
            }
          }
          float sp = a * (1.0f / 127.0f);
          if (sp == 0.f) sp = 1.f;
          const float mn = block_max(m);
          const float alpha = expf(sm.m_s[m] - mn);
          sm.a_s[m] = alpha;
          sm.l_s[m] = alpha * sm.l_s[m] + tot;
          sm.m_s[m] = mn;
          sm.sp_s[m] = sp;
        }
        int ai[MAXM][4];
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) ai[m][jj] = 0;
        for (int j = 0; j < ntc; ++j) {
          const unsigned char* st = j == 0 ? st0 : tile();
          const int nq_t = (min(ROWS, nc - j * ROWS) + 3) / 4;
          const int* pwj = pw_s + j * (ROWS / 4);
          if (4 * dw < hs) {
#pragma unroll 2
            for (int qd = rg; qd < nq_t; qd += RG) {
              uint32_t w[4], t[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                w[i] = *reinterpret_cast<const uint32_t*>(st + Tile::off(4 * qd + i, 4 * dw));
              transpose4(w, t);
#pragma unroll
              for (int m = 0; m < MAXM; ++m)
                if (m < MC) {
                  const int pw = pwj[m * bcq + qd];
#pragma unroll
                  for (int jj = 0; jj < 4; ++jj) ai[m][jj] = __dp4a(pw, (int)t[jj], ai[m][jj]);
                }
            }
          }
        }
        // 4. the row groups' (and chunks') int32 sums, exact in any order
        if (4 * dw < hs) {
#pragma unroll
          for (int m = 0; m < MAXM; ++m)
            if (m < MC)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) atomicAdd(&sm.red_i[m][4 * dw + jj], ai[m][jj]);
        }
      }
    }
  }
  if (pos > 0) {
    __syncthreads();
    update();  // the last block's,
    __syncthreads();  // read before the current row rewrites a_s
  }

  // the current row: s_cur = q . k_cur in q's dtype, p_cur stays fp32
  fold_current_row<HS, NT>(sm.q_s, sm.kc_s, sm.m_s, sm.l_s, sm.a_s, sm.pc_s, MC, hs, scale);
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int i = tid + k * NT, m = i / HS, d = i % HS;
    if (i < MC * HS && d < hs) {
      const float o = acc[k] * sm.a_s[m] + sm.pc_s[m] * sm.vc_s[d];
      const float l = sm.l_s[m];
      out[((size_t)b * H + head0 + m) * hs + d] = from_f<T>(o / (l == 0.f ? 1.f : l));
    }
  }
  mma::cp_async_wait<0>();  // the stream's trailing groups are empty
}

// dynamic shared memory of one fp32/bf16 task: its struct, then M x bc
// fp32 scores (M: the task's query heads, at most kMaxM)
template <typename T, int HS, int NT>
constexpr size_t decode_smem(int M, int bc) {
  return sizeof(DecodeSmem<T, HS, NT>) + sizeof(float) * (size_t)M * bc;
}
// the fp32/bf16 task's chunk for a block of bk rows and M query heads (at
// most kMaxM), within kDecSmemBudget: the whole block where it fits, else
// the most rows that fit, a multiple of NT (and so of a tile's rows)
template <typename T, int HS, int NT>
constexpr int decode_chunk(int M, int bk) {
  if (decode_smem<T, HS, NT>(M, bk) <= kDecSmemBudget) return bk;
  int rows = bk / NT * NT;
  while (rows > NT && decode_smem<T, HS, NT>(M, rows) > kDecSmemBudget) rows -= NT;
  return rows;
}
// the int8 task's: its struct, then a chunk of bc rows' v scales (bc fp32),
// M x bc scores and M x ceil(bc / 4) words of pi
template <int HS, int NT>
constexpr size_t decode_int8_smem(int M, int bc) {
  return sizeof(DecodeSmemInt8<HS, NT>) +
         4 * ((size_t)bc + (size_t)M * bc + (size_t)M * ((bc + 3) / 4));
}
// the int8 task's chunk for a block of bk rows and M query heads (at most
// kMaxM), within kSmemPerCta: the whole block where it fits, else the most
// rows that fit, a multiple of NT (and so of a tile's rows)
template <int HS, int NT>
constexpr int decode_int8_chunk(int M, int bk) {
  if (decode_int8_smem<HS, NT>(M, bk) <= kSmemPerCta) return bk;
  int rows = bk / NT * NT;
  while (rows > NT && decode_int8_smem<HS, NT>(M, rows) > kSmemPerCta) rows -= NT;
  return rows;
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
