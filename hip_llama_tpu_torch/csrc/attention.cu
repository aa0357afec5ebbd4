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
// V, one int32 a block; attention.py:300-383), with its tile ring in
// dynamic shared memory. Prefill follows _prefill_kernel_tmaj's int8 branch
// (attention.py:891-940): q rounded to bf16 whatever its dtype, K and V
// widened exactly, scores * scale * ks[row], and (p * vs[row]) rounded to
// bf16 before PV; no int8 dots. q, the current rows and the output are fp32
// or bf16. The running max advances once per block of bk cache rows, the
// JAX kernel's KV block, which the wrappers pass: the rounded probabilities
// (bf16 V, or p * vs on an int8 cache) depend on it. So every kernel takes
// a whole block's max before it rounds any: the decode tasks hold the
// block's M x bk scores in dynamic shared memory, a chunk of them at a time
// where the block is past the task's shared memory (decode_chunk,
// decode_int8_chunk; their K tiles then once or twice more), the fp32
// prefill kernel its 64 query
// rows x bk (up to 640 columns at HS 128: 128 KiB at the JAX block of 512),
// each computed a 64-row tile of K at a time, PV then walking the block's V
// tiles; the tensor-core prefill kernel takes two passes over the block.
//
// Bounds on an H100: decode is bound by bytes — every live K and V row of
// the layer is read once (2 * pos * HS * bytes per slot and KV head) for
// 4 * pos * HS flops per query head, far below the card's ~295 flop/byte
// ridge. One CTA per (KV head, head group, slot) runs decode_attention.
// cuh's task, which keeps the group's query heads in shared memory, so each
// K/V byte is read once for all heads that share it, streaming the rows
// through a cp.async ring of K and V tiles in shared memory (16 KB tiles of
// fp32 or bf16 rows, two CTAs an SM; 8 KB tiles of int8 rows).
//
// Prefill (K4, K7) on bf16 and int8 caches runs on the tensor cores
// (attention_prefill_mma_kernel). At the 7B shapes (T 256 over 512 rows)
// the byte bound is about 4x the bf16 operation bound, but the kernel
// before this one did both products on the fp32 CUDA cores with two
// shared-memory loads per FMA, held a JAX block's 64 x 512 fp32 scores in
// 128 KB of shared memory (one CTA per SM) and widened K and V to fp32 on
// the way in, single-stage: 12.9x SDPA. What bounds it now is the work
// between the products (the masks, exp and the bf16 rounding of p, done
// once per score in pass 2) and the second read of K per block. The
// design, FlashAttention-2's layout on mma.sync.m16n8k16 (bf16 in, fp32
// out):
//  - each of 4 warps owns 16 of the CTA's 64 (t, head) query rows; q is
//    held in registers as the A operand, rounded to bf16 (the cache dtype,
//    bf16 for an int8 cache: attention.py:912);
//  - K and V tiles of 64 rows arrive by cp.async (16-byte copies, 8 for
//    int8 rows of 8) in the cache's own dtype into a 2-stage ring, so the
//    next tile's copy overlaps this tile's products; bf16 tiles are
//    XOR-swizzled by 16-byte chunk so that ldmatrix reads them without bank
//    conflicts (K as the B operand of QK^T, V through ldmatrix.trans as the
//    B operand of PV);
//  - the running max must advance once per JAX block (ref_block(S, 512),
//    the page for K7): the probabilities round to bf16 at the block's max.
//    Instead of holding the block's scores, each block takes two passes
//    over its tiles. Pass 0 computes S a tile at a time and keeps each
//    row's max in registers (quad shuffles); pass 1 recomputes S (the same
//    instructions on the same operands: the same values), takes
//    p = exp(s - m_new), adds the unrounded p to l, rounds p (x vs[row] on
//    int8) to bf16 in registers, where the score fragment is already the A
//    fragment of PV, and runs PV into the fp32 accumulator. Shared memory
//    no longer grows with the block: any bk runs, at 64 KB a CTA at HS 128
//    (three CTAs an SM);
//  - an int8 cache is copied as int8 and widened to bf16 in shared memory
//    (exact: byte-permute into a float, top half), once per tile for the
//    CTA, into one swizzled bf16 K and V tile; the scales ride in the ring.
//    Widening in registers instead would convert every tile once per warp
//    (4x the conversions), and V's transposed fragment has no byte-level
//    ldmatrix, so one shared-memory round trip per tile is the cheaper way;
//  - the kernel is compiled for head sizes 8, 16, 32, 48, 64, 96, 128 and
//    256 (prefill_hs_pad), a head size between two of them runs zero-padded
//    to the next in shared memory, and 8 runs padded to 16 for k16: the pad
//    columns of q, K and V are zeros, so the scores and the live outputs are
//    unchanged. The query heads of a KV head share its K/V tiles side by side
//    in the CTA's 64 rows, however many there are (PfRows);
//  - the causal frontier: blocks stop at the CTA's last live query, tiles
//    at the block's last live column, and a warp skips the products of a
//    tile that lies past its own rows' frontier. Rows t >= valid[b] are
//    written as zeros.
// fp32 caches keep attention_prefill_kernel below (fp32 CUDA cores, the
// block's scores in shared memory): TF32 or a bf16 product would move the
// fp32 goldens, which are byte-identical to the CPU's.
//
// attention_decode_paged and attention_prefill_paged replace hip_llama_tpu/
// ops/attention.py::attention_decode_paged (_decode_kernel through
// _decode_kernel_paged) and attention_prefill_paged (_prefill_kernel
// through _prefill_kernel_paged): the same kernels with the paged row policy
// of decode_attention.cuh, row r of slot b at page table[b, r / PS], offset
// r % PS, looked up once per block that lies in one page. The TPU kernels
// gather one page per grid step through their BlockSpec index maps, so their
// block is the page; here the online softmax also advances once per page
// (attention_prefill_mma_kernel's two passes go over each page).
// Bound and design as the dense kernels: bytes for decode, the live rows
// read once; the page lookup costs an index load per block from the slot's
// table row (per row only where a block spans pages).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "decode_attention.cuh"
#include "mma.cuh"

namespace {

using namespace hipllama::mma;
using hipllama::ContiguousCache;
using hipllama::DecodeSmem;
using hipllama::DecodeSmemInt8;
using hipllama::decode_attention_task;
using hipllama::decode_attention_task_int8;
using hipllama::decode_int8_smem;
using hipllama::decode_smem;
using hipllama::DirectOperands;
using hipllama::kDecThreads;
using hipllama::kMaxM;
using hipllama::PagedCache;
using hipllama::warp_max;
using hipllama::warp_sum;

// ---------------------------------------------------------------------------
// decode: one (KV head, group of at most kMaxM query heads, slot) task per
// CTA (decode_attention.cuh); HS is the compiled head size, hs the
// operands' own. Every kernel here is compiled twice: for hs == HS (PAD
// false: the head size a constant, so that its masks, strides and copy
// counts fold away) and for any hs <= HS (PAD true); the launchers pick one.
// A runtime head size at HS 128 had cost the prefill kernels up to 38%.

// fp32 and bf16 caches: the ring, then a chunk of bc rows' scores in
// dynamic shared memory; two CTAs an SM (kDecSmemBudget)
template <typename T, int HS, typename Cache, bool PAD>
__global__ void __launch_bounds__(kDecThreads, 2) attention_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const Cache cache, const int* __restrict__ pos_arr, const T* __restrict__ k_cur,
    const T* __restrict__ v_cur, T* __restrict__ out, int H, int KVH, float scale, int q_bs,
    int cur_bs, int bk, int bc, int hs) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  using Smem = DecodeSmem<T, HS, kDecThreads>;
  auto& sm = *reinterpret_cast<Smem*>(dec_smem);
  float* dyn = reinterpret_cast<float*>(dec_smem + sizeof(Smem));
  const int ng = hipllama::head_groups(H / KVH);
  const int g = blockIdx.x / ng, m0 = blockIdx.x % ng * kMaxM, b = blockIdx.y;
  const DirectOperands<T> ops{q, k_cur, v_cur, q_bs, cur_bs};
  decode_attention_task<T, HS, kDecThreads, decltype(cache.rows(b, g)), DirectOperands<T>, PAD>(
      sm, dyn, g, b, ops, k_cache, v_cache, cache.rows(b, g), pos_arr, out, H, KVH, scale, bk,
      bc, hs, m0);
}

// the int8 cache: the ring, then a chunk of bc rows' scales, scores and pi
// in dynamic shared memory
template <typename T, int HS, typename Cache, bool PAD>
__global__ void __launch_bounds__(kDecThreads) attention_decode_int8_kernel(
    const T* __restrict__ q, const signed char* __restrict__ k_cache,
    const signed char* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Cache cache, const int* __restrict__ pos_arr,
    const T* __restrict__ k_cur, const T* __restrict__ v_cur, T* __restrict__ out,
    int H, int KVH, float scale, int q_bs, int cur_bs, int bk, int bc, int hs) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  auto& sm = *reinterpret_cast<DecodeSmemInt8<HS, kDecThreads>*>(dec_smem);
  float* dyn = reinterpret_cast<float*>(dec_smem + sizeof(DecodeSmemInt8<HS, kDecThreads>));
  const int ng = hipllama::head_groups(H / KVH);
  const int g = blockIdx.x / ng, m0 = blockIdx.x % ng * kMaxM, b = blockIdx.y;
  const DirectOperands<T> ops{q, k_cur, v_cur, q_bs, cur_bs};
  decode_attention_task_int8<T, HS, kDecThreads, decltype(cache.rows(b, g)), DirectOperands<T>,
                             PAD>(sm, dyn, g, b, ops, k_cache, v_cache, k_scale, v_scale,
                                  cache.rows(b, g), pos_arr, out, H, KVH, scale, bk, bc, hs,
                                  m0);
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

// dynamic shared memory at block bk (ops/attention.py::prefill_smem_bytes
// computes the same)
template <int HS>
constexpr size_t prefill_smem_bytes(int bk) {
  return sizeof(float) * ((size_t)kPfRows * HS                  // q
                          + (size_t)kPfTile * (HS + 1)          // a K tile (padded rows), then V
                          + (size_t)kPfRows * (prefill_cols(bk) + 1)  // the block's scores / p
                          + 3 * (size_t)kPfRows);               // m, l, alpha
}

// The (t, head) query rows of one prefill CTA: at most `rows` (64) of them,
// MC = min(M, rows) query heads of KV head g side by side for BT = rows / MC
// chunk positions: row r is position t0 + r / MC of head h0 + r % MC. A KV
// head with more than `rows` query heads takes ceil(M / MC) CTAs along y,
// each a group of MC heads; rows past BT * MC, and in the last group heads
// past M, are dead (zero q, never written).
struct PfRows {
  int t0, MC, BT, h0, hn;  // hn: the group's live heads
  __device__ __forceinline__ PfRows(int rows, int M, int g, int gy_in_g, int tile) {
    MC = min(M, rows);
    BT = rows / MC;
    t0 = tile * BT;
    h0 = g * M + gy_in_g * MC;
    hn = min(MC, M - gy_in_g * MC);
  }
  __device__ __forceinline__ int t(int r) const { return t0 + r / MC; }
  __device__ __forceinline__ int head(int r) const { return h0 + r % MC; }
  __device__ __forceinline__ bool live(int r) const { return r < BT * MC && r % MC < hn; }
};

// the CTAs of one KV head along y: groups of at most `rows` query heads
__host__ __device__ constexpr int pf_head_groups(int M, int rows) {
  return (M + rows - 1) / rows;
}

// The fp32 cache (q, the cache and the output fp32): the probabilities stay
// unrounded. Cache: the row policy (decode_attention.cuh); S: the rows a
// slot can hold; bk: the online softmax's block of cache rows; HS: the
// compiled head size, hs <= HS the operands' (zero-padded in shared memory).
template <int HS, typename Cache, bool PAD>
__global__ void __launch_bounds__(kPfThreads) attention_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k_cache,
    const float* __restrict__ v_cache, const Cache cache, const int* __restrict__ start_arr,
    const int* __restrict__ valid_arr, float* __restrict__ out, int T_len, int H, int KVH, int S,
    float scale, int bk, int hs_arg) {
  const int hs = PAD ? hs_arg : HS;
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

  const int M = H / KVH, ng = pf_head_groups(M, kPfRows);
  const int g = blockIdx.y / ng, b = blockIdx.z;
  const PfRows rw(kPfRows, M, g, blockIdx.y % ng, blockIdx.x);
  const int t0 = rw.t0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = start_arr[b];
  const int t_end = min(min(t0 + rw.BT, valid_arr[b]), T_len);  // live rows: t0 .. t_end-1
  // causal frontier of the tile: the last live query's cache position
  const int q_pos_max = t_end > t0 ? start + t_end - 1 : -1;

  for (int i = tid; i < kPfRows * HS; i += kPfThreads) {
    const int r = i / HS, dd = i % HS, t = rw.t(r);
    q_s[i] = rw.live(r) && t < T_len && dd < hs
                 ? q[(((size_t)b * T_len + t) * H + rw.head(r)) * hs + dd]
                 : 0.f;
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
        const bool in = c0 + c < ncols && dd < hs;
        kv_s[c * (HS + 1) + dd] = in ? k_cache[block_row(c0 + c) * hs + dd] : 0.f;
      }
      __syncthreads();
      // thread owns column c = tid % kPfTile of rows tid / kPfTile + 4i
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const int e = tid + i * kPfThreads;
        const int r = e / kPfTile, c = e % kPfTile;
        const int t = rw.t(r), col = k0 + c0 + c;
        const float* qr = q_s + r * HS;
        const float* kr = kv_s + c * (HS + 1);
        float s = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < HS; ++dd) s += qr[dd] * kr[dd];
        const bool live = c0 + c < ncols && t < t_end && col <= start + t;
        p_s[r * pst + c0 + c] = live ? s * scale : -INFINITY;
      }
    }
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
        pr[c] = p;
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
        kv_s[i] = c0 + c < ncols && dd < hs ? v_cache[block_row(c0 + c) * hs + dd] : 0.f;
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
    const int t = rw.t(r);
    if (t < T_len && rw.live(r) && dd < hs) {
      const float l = l_s[r];
      out[(((size_t)b * T_len + t) * H + rw.head(r)) * hs + dd] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
}

// ---------------------------------------------------------------------------
// prefill on the tensor cores (bf16 and int8 caches)

constexpr int kTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kTcRows = 64;      // (t, head) query rows per CTA, as kPfRows
constexpr int kTcTile = 64;      // cache rows per tile
constexpr int kTcStages = 2;     // the ring of K/V tiles

// shared memory of the tensor-core prefill (ops/attention.py::
// prefill_smem_bytes mirrors it): a ring of kTcStages stages, each a K and
// a V tile as copied (bf16 rows of CPR chunks, or int8 rows of HS bytes,
// then the two tiles' row scales), and on int8 the widened bf16 K and V
// tiles. HS is the compiled head size; HSP, HS rounded up to 16, is the
// width the products run at (k16 steps of QK, n8 pairs of PV); a bf16 row
// holds CPR, a power of two, 16-byte chunks for the swizzle (48: 6 used of
// 8, 96: 12 of 16)
template <typename C, int HS>
struct TcLayout {
  static constexpr bool kInt8 = std::is_same<C, signed char>::value;
  static constexpr int HSP = (HS + 15) / 16 * 16;  // head size padded for k16
  static constexpr int CPR = HSP <= 16 ? 2 : HSP <= 32 ? 4 : HSP <= 64 ? 8 : HSP <= 128 ? 16 : 32;
  static constexpr int WIDE = kTcTile * CPR * 16;  // a bf16 tile
  static constexpr int RAW = kInt8 ? kTcTile * HS : WIDE;
  static constexpr int SCALES = kInt8 ? 2 * kTcTile * 4 : 0;
  static constexpr int STAGE = 2 * RAW + SCALES;
  static constexpr int BYTES = kTcStages * STAGE + (kInt8 ? 2 * WIDE : 0);
};

// two consecutive q elements as a bf16 pair (q rounded to bf16)
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t q_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// four int8 values (one word) as two bf16 pairs, exactly: each byte, biased
// by 128, becomes the mantissa of 2^23 (a byte permute), less 2^23 + 128 is
// the value as a float, whose top half is its bf16 (|v| <= 128 has at most
// 8 significant bits)
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t bw = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(bw, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// the tile schedule of one CTA: for each JAX block of bk cache rows up to
// the CTA's causal frontier, pass 0 over its K tiles (the block's max),
// then pass 1 over its K and V tiles (p, l, PV)
struct TcSched {
  int k0, tile, pass;
  __device__ __forceinline__ bool live(int q_pos_max, int S) const {
    return k0 <= q_pos_max && k0 < S;
  }
  // columns of the block at k0 that can be live: its rows, up to the frontier
  __device__ __forceinline__ int ncols(int q_pos_max, int S, int bk) const {
    return min(min(bk, S - k0), q_pos_max - k0 + 1);
  }
  __device__ __forceinline__ void next(int q_pos_max, int S, int bk) {
    if (++tile * kTcTile < ncols(q_pos_max, S, bk)) return;
    tile = 0;
    if (pass == 0) {
      pass = 1;
    } else {
      pass = 0;
      k0 += bk;
    }
  }
};

// T: q and output (bf16 for a bf16 cache; fp32 or bf16 for int8); C: the
// cache (bf16, or int8 with k_scale / v_scale); Cache: the row policy
// (decode_attention.cuh); S: the rows a slot can hold; bk: the JAX block
template <typename T, typename C, int HS, typename Cache, bool PAD>
__global__ void __launch_bounds__(kTcThreads) attention_prefill_mma_kernel(
    const T* __restrict__ q, const C* __restrict__ k_cache, const C* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const Cache cache,
    const int* __restrict__ start_arr, const int* __restrict__ valid_arr,
    T* __restrict__ out, int T_len, int H, int KVH, int S, float scale, int bk, int hs_arg) {
  const int hs = PAD ? hs_arg : HS;
  using Lay = TcLayout<C, HS>;
  constexpr bool kInt8 = Lay::kInt8;
  constexpr int HSP = Lay::HSP, CPR = Lay::CPR;
  constexpr int NK = HSP / 16;  // k16 steps of QK^T; pairs of n8 tiles of PV
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t smem0 = smem_u32(tc_smem);

  const int M = H / KVH, ng = pf_head_groups(M, kTcRows);
  const int g = blockIdx.y / ng, b = blockIdx.z;
  const PfRows rw(kTcRows, M, g, blockIdx.y % ng, blockIdx.x);
  const int t0 = rw.t0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qd = lane & 3;  // the thread's column pair in a fragment
  const int start = start_arr[b];
  const int t_end = min(min(t0 + rw.BT, valid_arr[b]), T_len);  // live rows: t0 .. t_end-1
  const int q_pos_max = t_end > t0 ? start + t_end - 1 : -1;

  if (hs < HSP) {  // the pad columns stay zero: the copies write data chunks only
    for (int i = tid * 16; i < Lay::BYTES; i += kTcThreads * 16)
      *reinterpret_cast<uint4*>(tc_smem + i) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // the thread's two rows rg and rg + 8: their causal positions (-1: dead)
  const int rg = warp * 16 + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rg + 8 * h, t = rw.t(r);
    qpos[h] = t < t_end && rw.live(r) ? start + t : -1;
  }
  // the warp's frontier: its last live row's position
  const int tw_last = min(rw.t(warp * 16 + 15), t_end - 1);
  const int wpos = rw.t(warp * 16) < t_end ? start + tw_last : -1;

  // q as the A operand, bf16: slab kk, register e = (row rg + 8 (e & 1),
  // columns 16 kk + 8 (e >> 1) + 2 qd, +1)
  uint32_t qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rg + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + 2 * qd;
      const int t = rw.t(r);
      qa[kk][e] = t < T_len && col < hs && rw.live(r)
                      ? q_pair(q + (((size_t)b * T_len + t) * H + rw.head(r)) * hs + col)
                      : 0u;
    }

  float o[2 * NK][4];  // PV: n8 tiles of HSP columns
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, mb[2] = {-INFINITY, -INFINITY}, m_use[2] = {0.f, 0.f};
  float l[2] = {0.f, 0.f};

  const auto rows = cache.rows(b, g);

  // the copies of one schedule item into ring stage st
  auto issue = [&](const TcSched& it, int st) {
    const int ncols = it.ncols(q_pos_max, S, bk);
    const int c0 = it.tile * kTcTile;
    const hipllama::BlockRows<decltype(rows)> block_row(rows, it.k0, min(bk, S - it.k0));
    const uint32_t base = smem0 + st * Lay::STAGE;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      if (plane == 1 && it.pass == 0) break;  // pass 0 reads K only
      const C* src = plane == 0 ? k_cache : v_cache;
      const uint32_t dst = base + plane * Lay::RAW;
      if (kInt8) {
        // rows of hs bytes at a stride of HS: 16-byte copies where hs % 16
        // == 0, else 8-byte ones
        const int ch = hs % 16 ? hs / 8 : hs / 16;  // copies a row
        for (int i = tid; i < kTcTile * ch; i += kTcThreads) {
          const int r = i / ch, c = i % ch;
          const bool live = c0 + r < ncols;
          if (hs % 16) {
            const C* p = live ? src + block_row(c0 + r) * hs + c * 8 : src;
            cp_async<8>(dst + r * HS + c * 8, p, live);
          } else {
            const C* p = live ? src + block_row(c0 + r) * hs + c * 16 : src;
            cp_async<16>(dst + r * HS + c * 16, p, live);
          }
        }
      } else {
        const int ch = hs / 8;  // data chunks a row (beside the pad chunks)
        for (int i = tid; i < kTcTile * ch; i += kTcThreads) {
          const int r = i / ch, c = i % ch;
          const bool live = c0 + r < ncols;
          const C* p = live ? src + block_row(c0 + r) * hs + c * 8 : src;
          cp_async<16>(dst + tile_chunk<CPR>(r, c) * 16, p, live);
        }
      }
    }
    if (kInt8 && tid < kTcTile) {
      const bool live = c0 + tid < ncols;
      const size_t row = live ? block_row(c0 + tid) : 0;
      cp_async<4>(base + 2 * Lay::RAW + tid * 4, k_scale + row, live);
      if (it.pass == 1)
        cp_async<4>(base + 2 * Lay::RAW + (kTcTile + tid) * 4, v_scale + row, live);
    }
  };

  // int8: widen the stage's K (and V) tile into the swizzled bf16 tiles
  auto widen = [&](int st, bool with_v) {
    const unsigned char* raw = tc_smem + st * Lay::STAGE;
    unsigned char* wide = tc_smem + kTcStages * Lay::STAGE;
    const int ch = hs / 8;  // 8 int8 values -> one 16-byte bf16 chunk
    for (int plane = 0; plane < (with_v ? 2 : 1); ++plane)
      for (int i = tid; i < kTcTile * ch; i += kTcThreads) {
        const int r = i / ch, c = i % ch;
        const uint2 w = *reinterpret_cast<const uint2*>(raw + plane * Lay::RAW + r * HS + c * 8);
        const uint2 lo = widen4(w.x), hi = widen4(w.y);
        *reinterpret_cast<uint4*>(wide + plane * Lay::WIDE + tile_chunk<CPR>(r, c) * 16) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
  };

  TcSched ld{0, 0, 0}, cp{0, 0, 0};
  if (ld.live(q_pos_max, S)) {
    issue(ld, 0);
    ld.next(q_pos_max, S, bk);
  }
  cp_async_commit();
  for (int it = 0; cp.live(q_pos_max, S); ++it) {
    const int st = it % kTcStages;
    if (ld.live(q_pos_max, S)) {
      issue(ld, (it + 1) % kTcStages);
      ld.next(q_pos_max, S, bk);
    }
    cp_async_commit();
    cp_async_wait1();  // this item's copies have landed
    __syncthreads();
    if (kInt8) {
      widen(st, cp.pass == 1);
      __syncthreads();
    }
    const uint32_t kt = kInt8 ? smem0 + kTcStages * Lay::STAGE : smem0 + st * Lay::STAGE;
    const uint32_t vt = kt + (kInt8 ? Lay::WIDE : Lay::RAW);
    const float* ks = reinterpret_cast<const float*>(tc_smem + st * Lay::STAGE + 2 * Lay::RAW);
    const float* vs = ks + kTcTile;

    const int ncols = cp.ncols(q_pos_max, S, bk);
    const int c0 = cp.tile * kTcTile;
    if (cp.pass == 1 && cp.tile == 0) {
      // the block's max is known: rescale the running state once
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = mb[h];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = m_new == -INFINITY ? 1.f : expf(m[h] - m_new);
        l[h] *= alpha;
#pragma unroll
        for (int j = 0; j < 2 * NK; ++j) {
          o[j][2 * h] *= alpha;
          o[j][2 * h + 1] *= alpha;
        }
        m[h] = m_new;
        // a row with no live column yet keeps p = 0 (and m = -inf)
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;
        mb[h] = -INFINITY;
      }
    }
    if (cp.k0 + c0 <= wpos) {  // some row of this warp sees the tile
      // the last live tile column of each row
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) lim[h] = min(ncols - 1, qpos[h] - cp.k0) - c0;
      // S = q K^T for the warp's 16 rows x 64 columns
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          // n8 tiles 2jp, 2jp+1 (lanes 16-31) at chunks 2kk, 2kk+1 (lane bit 3)
          const int r = 8 * (2 * jp + (lane >> 4)) + (lane & 7);
          const int c = 2 * kk + ((lane >> 3) & 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(kt + tile_chunk<CPR>(r, c) * 16, b0, b1, b2, b3);
          mma_bf16(s[2 * jp], qa[kk], b0, b1);
          mma_bf16(s[2 * jp + 1], qa[kk], b2, b3);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * qd + (e & 1), h = e >> 1;
          float v = s[j][e] * scale;
          if (kInt8) v *= ks[c];
          const bool live = c <= lim[h];
          if (cp.pass == 0) {
            if (live) mb[h] = fmaxf(mb[h], v);
          } else {
            const float p = live ? expf(v - m_use[h]) : 0.f;
            l[h] += p;
            s[j][e] = kInt8 ? p * vs[c] : p;  // rounded to bf16 below
          }
        }
      if (cp.pass == 1) {
        // PV: the score fragments of n8 tiles 2kk, 2kk+1 are the A fragment
        // of k16 step kk
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < NK; ++dp) {
            // rows 16kk + 0..15 (lane bit 3), chunks 2dp, 2dp+1 (lanes 16-31)
            const int r = 16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7);
            const int c = 2 * dp + (lane >> 4);
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(vt + tile_chunk<CPR>(r, c) * 16, b0, b1, b2, b3);
            mma_bf16(o[2 * dp], pa, b0, b1);
            mma_bf16(o[2 * dp + 1], pa, b2, b3);
          }
        }
      }
    }
    __syncthreads();  // the stage (and the wide tiles) may be overwritten
    cp.next(q_pos_max, S, bk);
  }

  // out = o / l, zeros for rows without a live column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (lt == 0.f) lt = 1.f;
    const int r = rg + 8 * h, t = rw.t(r);
    if (t < T_len && rw.live(r)) {
      T* orow = out + (((size_t)b * T_len + t) * H + rw.head(r)) * hs;
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        const int d = 8 * j + 2 * qd;
        if (d < hs) store_pair(orow + d, o[j][2 * h] / lt, o[j][2 * h + 1] / lt);
      }
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

// the fp32/bf16 decode kernel; one task per (KV head, head group) along x
template <typename T, int HS, typename Cache>
int launch_decode(const void* q, const void* k, const void* v, const Cache& cache,
                  const void* pos, const void* kc, const void* vc, void* out, int B, int H,
                  int KVH, float scale, int q_bs, int cur_bs, int bk, int hs, cudaStream_t st) {
  const int M = H / KVH;
  // the ring copies rows in 16-byte pieces from 16-byte aligned planes
  if ((uintptr_t)k % 16 || (uintptr_t)v % 16) return (int)cudaErrorMisalignedAddress;
  const int mc = M < kMaxM ? M : kMaxM;
  // the block whole where it fits two CTAs an SM, else in chunks
  const int bc = hipllama::decode_chunk<T, HS, kDecThreads>(mc, bk);
  const size_t smem = decode_smem<T, HS, kDecThreads>(mc, bc);
  auto kernel = hs == HS ? attention_decode_kernel<T, HS, Cache, false>
                         : attention_decode_kernel<T, HS, Cache, true>;
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<dim3(KVH * hipllama::head_groups(M), B), kDecThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, cache, (const int*)pos, (const T*)kc,
      (const T*)vc, (T*)out, H, KVH, scale, q_bs, cur_bs, bk, bc, hs);
  return (int)cudaGetLastError();
}

// the int8 decode kernel, as launch_decode
template <typename T, int HS, typename Cache>
int launch_decode_int8(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const Cache& cache, const void* pos, const void* kc,
                       const void* vc, void* out, int B, int H, int KVH, float scale, int q_bs,
                       int cur_bs, int bk, int hs, cudaStream_t st) {
  const int M = H / KVH;
  // the ring copies rows in 16-byte pieces from 16-byte aligned planes
  if ((uintptr_t)k % 16 || (uintptr_t)v % 16 || (uintptr_t)ks % 4 || (uintptr_t)vs % 4)
    return (int)cudaErrorMisalignedAddress;
  const int mc = M < kMaxM ? M : kMaxM;
  // the block whole where it fits a CTA's shared memory, else in chunks
  const int bc = hipllama::decode_int8_chunk<HS, kDecThreads>(mc, bk);
  const size_t smem = decode_int8_smem<HS, kDecThreads>(mc, bc);
  auto kernel = hs == HS ? attention_decode_int8_kernel<T, HS, Cache, false>
                         : attention_decode_int8_kernel<T, HS, Cache, true>;
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<dim3(KVH * hipllama::head_groups(M), B), kDecThreads, smem, st>>>(
      (const T*)q, (const signed char*)k, (const signed char*)v, (const float*)ks,
      (const float*)vs, cache, (const int*)pos, (const T*)kc, (const T*)vc, (T*)out, H, KVH,
      scale, q_bs, cur_bs, bk, bc, hs);
  return (int)cudaGetLastError();
}

// the prefill grid: chunk-position tiles along x, (KV head, head group) along
// y, slots along z (PfRows)
dim3 prefill_grid(int rows, int B, int T_len, int H, int KVH) {
  const int M = H / KVH, mc = M < rows ? M : rows, bt = rows / mc;
  return dim3((T_len + bt - 1) / bt, KVH * pf_head_groups(M, rows), B);
}

// the fp32 cache: the CUDA-core kernel, the block's scores in shared memory
// (T: float, for HIPLLAMA_PREFILL_HS_SWITCH)
template <typename T, int HS, typename Cache>
int launch_prefill_f32(const void* q, const void* k, const void* v, const Cache& cache,
                       const void* start, const void* valid, void* out, int B, int T_len, int H,
                       int KVH, int S, float scale, int bk, int hs, cudaStream_t st) {
  static_assert(std::is_same<T, float>::value, "the CUDA-core prefill takes fp32");
  const size_t smem = prefill_smem_bytes<HS>(bk);
  auto kernel = hs == HS ? attention_prefill_kernel<HS, Cache, false>
                         : attention_prefill_kernel<HS, Cache, true>;
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<prefill_grid(kPfRows, B, T_len, H, KVH), kPfThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, cache, (const int*)start,
      (const int*)valid, (float*)out, T_len, H, KVH, S, scale, bk, hs);
  return (int)cudaGetLastError();
}

// bf16 and int8 caches: the tensor-core kernel, any block
template <typename T, typename C, int HS, typename Cache>
int launch_prefill_mma(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const Cache& cache, const void* start, const void* valid,
                       void* out, int B, int T_len, int H, int KVH, int S, float scale, int bk,
                       int hs, cudaStream_t st) {
  const size_t smem = TcLayout<C, HS>::BYTES;
  auto kernel = hs == HS ? attention_prefill_mma_kernel<T, C, HS, Cache, false>
                         : attention_prefill_mma_kernel<T, C, HS, Cache, true>;
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<prefill_grid(kTcRows, B, T_len, H, KVH), kTcThreads, smem, st>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)ks, (const float*)vs, cache,
      (const int*)start, (const int*)valid, (T*)out, T_len, H, KVH, S, scale, bk, hs);
  return (int)cudaGetLastError();
}

// the compiled head size of the prefill kernels that serves head size hs (a
// multiple of 8 up to 256): the next of 8, 16, 32, 48, 64, 96, 128, 256.
// 48 and 96 are compiled because padding them to 64 and 128 would add a
// third to the tensor cores' work; the others pad by at most 3/8 of a size
// no real model uses
constexpr int prefill_hs_pad(int hs) {
  return hs < 8 || hs % 8 || hs > 256 ? 0 : hs <= 8 ? 8 : hs <= 16 ? 16 : hs <= 32 ? 32
         : hs <= 48 ? 48 : hs <= 64 ? 64 : hs <= 96 ? 96 : hs <= 128 ? 128 : 256;
}

}  // namespace

// dispatch on the head size hs: CALL(T, N) with N = prefill_hs_pad(hs)
#define HIPLLAMA_PREFILL_HS_SWITCH(hs, T, CALL)             \
  switch (prefill_hs_pad(hs)) {                             \
    case 8: return CALL(T, 8);                              \
    case 16: return CALL(T, 16);                            \
    case 32: return CALL(T, 32);                            \
    case 48: return CALL(T, 48);                            \
    case 64: return CALL(T, 64);                            \
    case 96: return CALL(T, 96);                            \
    case 128: return CALL(T, 128);                          \
    case 256: return CALL(T, 256);                          \
    default: return (int)cudaErrorInvalidValue;             \
  }

HIPLLAMA_EXPORT_ERROR_STRING

// dtype: 0 = float, 1 = bfloat16; HS any multiple of 8 up to 256 (the task
// compiled for decode_hs_pad(HS) runs it); any H / KVH (tasks of at most
// kMaxM query heads); bk >= 1 cache rows per online-softmax block, any
// block (a block past the task's shared memory runs in chunks); the cache
// planes 16-byte aligned.
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
  if (H % KVH || bk < 1 || q_bs < H * HS || cur_bs < KVH * HS)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                       \
  launch_decode<T, N>(q, k_cache, v_cache, cache, pos, k_cur, v_cur, out, B, H, KVH, scale, \
                      q_bs, cur_bs, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_DECODE_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_DECODE_HS_SWITCH(HS, __nv_bfloat16, CALL)
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
  if (H % KVH || bk < 1) return (int)cudaErrorInvalidValue;
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
                      nt * HS, nt * HS, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_DECODE_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_DECODE_HS_SWITCH(HS, __nv_bfloat16, CALL)
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
  if (H % KVH || bk < 1 || q_bs < H * HS || cur_bs < KVH * HS)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                        \
  launch_decode_int8<T, N>(q, k_cache, v_cache, k_scale, v_scale, cache, pos, k_cur, v_cur, \
                           out, B, H, KVH, scale, q_bs, cur_bs, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_DECODE_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_DECODE_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_decode_fused_int8(const void* qkv, const void* k_cache,
                                           const void* v_cache, const void* k_scale,
                                           const void* v_scale, const void* pos, void* out,
                                           int B, int H, int KVH, int S, int HS, int L,
                                           int layer, int dtype, int bk, void* stream) {
  if (H % KVH || bk < 1) return (int)cudaErrorInvalidValue;
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
                           H, KVH, scale, nt * HS, nt * HS, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_DECODE_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_DECODE_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// The three prefill routes, chosen by the wrapper from the cache dtype.
// HS any multiple of 8 up to 256 (the kernel compiled for prefill_hs_pad(HS)
// runs it); any H / KVH (PfRows); bk >= 1 cache rows per online-softmax
// block.
//
// attention_prefill: a bf16 cache (dtype must be 1 = bfloat16, q and out
// bf16), on the tensor cores; any bk.
extern "C" int attention_prefill(const void* q, const void* k_cache, const void* v_cache,
                                 const void* start, const void* valid, void* out, int B,
                                 int T_len, int H, int KVH, int S, int HS, int L, int layer,
                                 int dtype, int bk, void* stream) {
  if (H % KVH || bk < 1 || dtype != 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                        \
  launch_prefill_mma<T, T, N>(q, k_cache, v_cache, nullptr, nullptr, cache, start, valid, out, \
                              B, T_len, H, KVH, S, scale, bk, HS, st)
  HIPLLAMA_PREFILL_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// attention_prefill_f32: an fp32 cache (dtype must be 0 = float), on the
// fp32 CUDA cores; prefill_smem_bytes(bk) within the card's shared memory,
// which the wrapper checks.
extern "C" int attention_prefill_f32(const void* q, const void* k_cache, const void* v_cache,
                                     const void* start, const void* valid, void* out, int B,
                                     int T_len, int H, int KVH, int S, int HS, int L, int layer,
                                     int dtype, int bk, void* stream) {
  if (H % KVH || bk < 1 || dtype != 0) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                       \
  launch_prefill_f32<T, N>(q, k_cache, v_cache, cache, start, valid, out, B, T_len, H, KVH, \
                           S, scale, bk, HS, st)
  HIPLLAMA_PREFILL_HS_SWITCH(HS, float, CALL)
#undef CALL
}

// attention_prefill_int8: int8 cache planes with fp32 scale planes (B, L,
// KVH, S); q and out in dtype (0 = float, 1 = bfloat16); on the tensor
// cores, any bk.
extern "C" int attention_prefill_int8(const void* q, const void* k_cache, const void* v_cache,
                                      const void* k_scale, const void* v_scale,
                                      const void* start, const void* valid, void* out, int B,
                                      int T_len, int H, int KVH, int S, int HS, int L,
                                      int layer, int dtype, int bk, void* stream) {
  if (H % KVH || bk < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContiguousCache cache{L, KVH, S, layer};
#define CALL(T, N)                                                                           \
  launch_prefill_mma<T, signed char, N>(q, k_cache, v_cache, k_scale, v_scale, cache, start,  \
                                        valid, out, B, T_len, H, KVH, S, scale, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_PREFILL_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_PREFILL_HS_SWITCH(HS, __nv_bfloat16, CALL)
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
  if (H % KVH || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
#define CALL(T, N)                                                                          \
  launch_decode<T, N>(q, k_pages, v_pages, cache, pos, k_cur, v_cur, out, B, H, KVH, scale, \
                      H * HS, KVH * HS, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_DECODE_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_DECODE_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_decode_paged_int8(const void* q, const void* k_pages,
                                           const void* v_pages, const void* k_scale,
                                           const void* v_scale, const void* table,
                                           const void* pos, const void* k_cur, const void* v_cur,
                                           void* out, int B, int H, int KVH, int P, int PS,
                                           int max_pages, int HS, int layer, int dtype, int bk,
                                           void* stream) {
  if (H % KVH || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
#define CALL(T, N)                                                                            \
  launch_decode_int8<T, N>(q, k_pages, v_pages, k_scale, v_scale, cache, pos, k_cur, v_cur, out, \
                           B, H, KVH, scale, H * HS, KVH * HS, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_DECODE_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_DECODE_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

// attention_prefill_paged (bf16 pages, tensor cores; dtype must be 1) and
// attention_prefill_paged_f32 (fp32 pages, CUDA cores; dtype must be 0)
extern "C" int attention_prefill_paged(const void* q, const void* k_pages, const void* v_pages,
                                       const void* table, const void* start, const void* valid,
                                       void* out, int B, int T_len, int H, int KVH, int P, int PS,
                                       int max_pages, int HS, int layer, int dtype, int bk,
                                       void* stream) {
  if (H % KVH || bk < 1 || PS < 1 || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
  const int S = max_pages * PS;
#define CALL(T, N)                                                                          \
  launch_prefill_mma<T, T, N>(q, k_pages, v_pages, nullptr, nullptr, cache, start, valid, out, \
                              B, T_len, H, KVH, S, scale, bk, HS, st)
  HIPLLAMA_PREFILL_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}

extern "C" int attention_prefill_paged_f32(const void* q, const void* k_pages,
                                           const void* v_pages, const void* table,
                                           const void* start, const void* valid, void* out,
                                           int B, int T_len, int H, int KVH, int P, int PS,
                                           int max_pages, int HS, int layer, int dtype, int bk,
                                           void* stream) {
  if (H % KVH || bk < 1 || PS < 1 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
  const int S = max_pages * PS;
#define CALL(T, N)                                                                          \
  launch_prefill_f32<T, N>(q, k_pages, v_pages, cache, start, valid, out, B, T_len, H, KVH, S, \
                           scale, bk, HS, st)
  HIPLLAMA_PREFILL_HS_SWITCH(HS, float, CALL)
#undef CALL
}

extern "C" int attention_prefill_paged_int8(const void* q, const void* k_pages,
                                            const void* v_pages, const void* k_scale,
                                            const void* v_scale, const void* table,
                                            const void* start, const void* valid, void* out,
                                            int B, int T_len, int H, int KVH, int P, int PS,
                                            int max_pages, int HS, int layer, int dtype, int bk,
                                            void* stream) {
  if (H % KVH || bk < 1 || PS < 1) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedCache cache{(const int*)table, max_pages, KVH, P, PS, layer};
  const int S = max_pages * PS;
#define CALL(T, N)                                                                             \
  launch_prefill_mma<T, signed char, N>(q, k_pages, v_pages, k_scale, v_scale, cache, start,    \
                                        valid, out, B, T_len, H, KVH, S, scale, bk, HS, st)
  if (dtype == 0) {
    HIPLLAMA_PREFILL_HS_SWITCH(HS, float, CALL)
  }
  HIPLLAMA_PREFILL_HS_SWITCH(HS, __nv_bfloat16, CALL)
#undef CALL
}
