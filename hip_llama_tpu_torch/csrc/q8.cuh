// Q8_0 device code shared by quant.cu (q8_matmul, q8_matmul_silu,
// q8_matmul_ffn) and layer_fused.cu (q8_layer_fused): weights q (K, N) int8
// row-major with s (K/gs, N) fp32, bf16 activations.
//
// Cast points, as in the JAX kernels (quant.py:237-241, :381-395, :148-180,
// :603-606, :851-886): xn = bf16(x_f32 * rsqrt(mean(x_f32^2) + eps) * g);
// w = bf16(f32(q) * s[k / gs][n]); products bf16 x bf16 summed in fp32; the
// residual is added to the fp32 sum; RoPE rotates (even, odd) column pairs
// below rope_limit on the fp32 sum with the frequency
// exp(((n % HS) / 2) * (-2 ln theta / HS)); the gate is
// bf16(h1 * sigmoid(h1) * h3) on fp32 sums; one cast at the end.
//
// Each piece is a device function of one phase (gemv_tasks: the tasks of a
// decode-shaped product, dealt out to the CTAs of the grid) or one output
// element, so that a kernel of its own and the fused layer (a persistent
// grid) run the same code and round alike. All take kThreads threads per
// CTA. The pieces are inlined into their kernels, so their shared-memory
// structs are addressed as shared memory and not through generic pointers.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace hipllama {
namespace q8 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// the epilogue of one (even, odd) column pair of a q8_matmul output row

struct Epilogue {
  const bf16* res;  // (M, N) residual or nullptr
  const int* pos;   // (M,) RoPE positions or nullptr
  int rope_limit;   // columns below it rotate
  int rope_hs;      // head size of the rotated segments
  float rope_coef;  // -2 ln(theta) / HS, rounded to fp32
  // (M, rope_hs) fp32: row m's cos and sin of pair p at 2 p, 2 p + 1, as
  // rope_cs_at computes them (rope_table_kernel), or nullptr: computed here
  const float* rope_cs;
};

// the RoPE angle's cos and sin for row m's pair p: freq = exp(p * coef),
// ang = pos[m] * freq, in fp32
__device__ __forceinline__ float2 rope_cs_at(const int* pos, int m, int p, float coef) {
  const float freq = expf((float)p * coef);
  const float ang = (float)pos[m] * freq;
  return make_float2(cosf(ang), sinf(ang));
}

// the pair (a0, a1) at columns n, n + 1 of row m through the epilogue, as
// the two bf16 values it writes
__device__ __forceinline__ __nv_bfloat162 epilogue_pair(const Epilogue& e, int m, int n, int N,
                                                        float a0, float a1) {
  const size_t at = (size_t)m * N + n;
  if (e.res != nullptr) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(e.res + at);
    a0 += __low2float(r);
    a1 += __high2float(r);
  }
  if (e.pos != nullptr && n < e.rope_limit) {
    const float2 cs =
        e.rope_cs != nullptr
            ? *reinterpret_cast<const float2*>(e.rope_cs + (size_t)m * e.rope_hs + n % e.rope_hs)
            : rope_cs_at(e.pos, m, (n % e.rope_hs) >> 1, e.rope_coef);
    const float c = cs.x, s = cs.y;
    const float r0 = a0 * c - a1 * s;  // partner[2i] = -acc[2i+1]
    const float r1 = a1 * c + a0 * s;  // partner[2i+1] = acc[2i]
    a0 = r0;
    a1 = r1;
  }
  return __floats2bfloat162_rn(a0, a1);
}

__device__ __forceinline__ void store_pair(const Epilogue& e, int m, int n, int N, float a0,
                                           float a1, bf16* out) {
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = epilogue_pair(e, m, n, N, a0, a1);
}

__device__ __forceinline__ float silu_gate(float h1, float h3) {
  return h1 * (1.f / (1.f + expf(-h1))) * h3;
}

// ---------------------------------------------------------------------------
// dequantization at the `reshape` cast point, w = bf16(f32(q) * s), kept off
// the conversion unit (16 results per clock per SM on sm_90, against 128 for
// the FMA pipe): byte j of a word of int8 values biased by 0x80, placed in
// the mantissa of 2^23 by one byte permute, less 2^23 + 128 is f32(q)
// exactly; the bf16 rounding (nearest even) takes two products per
// instruction.

constexpr uint32_t kBias4 = 0x80808080u;  // XOR of four int8 values: q + 128

__device__ __forceinline__ float q_to_f(uint32_t biased4, int j) {
  return __uint_as_float(__byte_perm(biased4, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// The int4 form (quant4.cu's packing, code + 8 in each nibble): a word's
// low nibbles are v & kLowNibbles, its high ones (v >> 4) & kLowNibbles;
// byte j of such a word of nibbles, placed in the mantissa of 2^23 by one
// byte permute, less 2^23 + 8, is f32(code) exactly.
constexpr uint32_t kLowNibbles = 0x0F0F0F0Fu;

__device__ __forceinline__ float nib_to_f(uint32_t nib4, int j) {
  return __uint_as_float(__byte_perm(nib4, 0x4B000000u, 0x7540 + j)) - 8388616.f;
}

// bf16(a) in the low half, bf16(b) in the high half
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four int8 weights (biased) times their scales, as two bf16x2 words
__device__ __forceinline__ uint2 dequant4(uint32_t biased4, float4 s) {
  return make_uint2(bf16x2_bits(q_to_f(biased4, 0) * s.x, q_to_f(biased4, 1) * s.y),
                    bf16x2_bits(q_to_f(biased4, 2) * s.z, q_to_f(biased4, 3) * s.w));
}

// ---------------------------------------------------------------------------
// rmsnorm of one row of K values into outr; red: kWarps floats of shared
// memory. Every thread sums the warps' partial sums in the same order.

// 1 / rms of one row of K values: rsqrt(mean(x^2) + eps)
__device__ __forceinline__ float rms_rsqrt(const bf16* xr, int K, float eps, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ss = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    const float v = to_f(xr[k]);
    ss += v * v;
  }
  ss = warp_sum(ss, 32);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  return rsqrtf(tot / (float)K + eps);
}

// xn[k] = bf16(x[k] * r * g[k]), r = rms_rsqrt of the row
__device__ __forceinline__ float normed(const bf16* xr, const float* g, float r, int k) {
  return to_f(__float2bfloat16_rn(to_f(xr[k]) * r * g[k]));
}

__device__ __forceinline__ void rmsnorm_row(const bf16* xr, const float* g, bf16* outr, int K,
                                            float eps, float* red) {
  const float r = rms_rsqrt(xr, K, eps, red);
  for (int k = threadIdx.x; k < K; k += kThreads) outr[k] = __float2bfloat16_rn(normed(xr, g, r, k));
}

// ---------------------------------------------------------------------------
// the split-K GEMV for decode-shaped M (at most 16 rows a task) on the bf16
// tensor cores. y = x @ w is computed as its transpose on mma.sync
// (m16n8k8, two to a step): 16 output columns of the dequantized weight are
// the A operand (16 columns x 8 k) and 8 activation rows the B operand (8 k
// x 8 rows), so 8 rows fill the n side with no padding row (16 rows: two n8
// tiles). Bound on an H100: the weight bytes (1 byte per weight plus 4/gs
// for the scales, each read once; int4: half a byte); the products cost two
// m16n8k8 per 256 weights, and what is left on the CUDA cores is the
// dequantization (about 4 operations a weight: a byte permute and a
// subtraction to f32(q), the product with the scale, half a bf16x2
// conversion).
//
// A task is one strip of kGemvBN = 128 output columns, one slice of the
// contraction in whole steps and one chunk of at most MAXM rows;
// gemv_tasks deals a product's tasks out to the CTAs of the grid (several a
// CTA where there are more tasks than CTAs). The 8 warps of a CTA split the
// slice into contiguous runs of steps; each warp streams its run through a
// ring of stages of its own in shared memory, filled by cp.async in 16-byte
// copies a ring's depth less one steps ahead, on across the CTA's tasks. A
// stage is the step's weight rows of the strip (XOR-swizzled by 16-byte
// chunk), the scale row of their group where it is new to the run, and the
// step's 16 columns of x. The weight's format is a template parameter:
//
//   - Q8_0 (kBits 8): a step is 16 rows of q (2 KB), k rows k0..k0 + 15; 4
//     stages (about 8 KB a warp in flight, 130 KB an SM at two CTAs an SM).
//     A lane holds 16 adjacent columns (16 (lane / 4) ..) of rows 2 t, 2 t +
//     1, 2 t + 8, 2 t + 9 (t = lane % 4): the two 8-deep halves of the step.
//   - int4 packed half-split (kBits 4, quant4.cu's format): a step is 8
//     packed rows k'..k' + 7 (1 KB); their low nibbles are the k rows k'..
//     and meet x[:, k'..], their high nibbles the rows K/2 + k'.. and meet
//     x[:, K/2 + k'..]: the step's two 8-deep halves are the two planes,
//     and its x the 8 columns of each. A lane holds 16 adjacent columns of
//     packed rows 2 t, 2 t + 1, whose low and high nibbles are its rows of
//     the two halves; a new group brings the scale rows of both halves.
//     The packed rows of a step are half Q8's bytes for the same work, so
//     the ring is one stage deeper.
//
// Once dequantized, a lane's values are its A fragments of 8 m16 tiles
// (tile j's row lane / 4 is the lane's column 2 j, its row lane / 4 + 8
// column 2 j + 1), so its accumulators hold 16 adjacent outputs of two
// activation rows in each n8 tile. The tensor cores sum each 8-deep half of
// a step from zero (m16n8k8), and the halves are added to the fp32 sums in
// order by the CUDA cores: the 16-deep product accumulated into the running
// sums inside the tensor core (its own alignment and truncation, not fp32
// adds) rounded the golden fixture's greedy Q8 decode away from the JAX
// outputs on one corpus more than its bar allows (PERF.md); this form costs
// 6-9% at 8 rows. The weight tensors are the ones the prefill tiles read:
// no second or permuted copy. At the end of a task the 8 warps' fp32 sums
// are added in warp order through shared memory and the task's partial goes
// to part[(split * M + m) * N + n]; split_epilogue_at adds the splits in a
// fixed order (no float atomics: greedy decoding gives the same tokens
// every run).

constexpr int kGemvBN = 128;    // output columns per task: 16 for each of 8 lane groups
constexpr int kGemvStep = 16;   // contraction rows per step: two 8-deep mmas
constexpr int kGemvStages = 4;  // ring stages per warp (Q8_0)
constexpr int kGemvWBytes = kGemvStep * kGemvBN;  // a step's int8 weight rows
constexpr int kGemvSBytes = kGemvBN * 4;          // the scale row of their group
constexpr int kGemvRedLd = kGemvBN + 4;           // a padded row of the warps' sums

// a weight format's step: kRows rows of q (K / 16 steps either way), their
// bytes, the scale rows of their groups, the ring's depth
template <int kBits>
struct GemvFormat {
  static constexpr int kRows = kBits == 4 ? 8 : kGemvStep;
  static constexpr int kWBytes = kRows * kGemvBN;
  static constexpr int kSBytes = (kBits == 4 ? 2 : 1) * kGemvSBytes;
  static constexpr int kStages = kBits == 4 ? 5 : kGemvStages;
};

template <int MAXM, int kBits = 8>
struct GemvSmem {
  using F = GemvFormat<kBits>;
  static constexpr int kX = MAXM * kGemvStep * 2;  // the step's x: MAXM rows of 16 bf16
  static constexpr int kStage = F::kWBytes + F::kSBytes + kX;
  __align__(16) unsigned char ring[kWarps][F::kStages][kStage];
  __align__(16) float red[kWarps / 2][8][kGemvRedLd];  // half the warps' sums of 8 rows
};

// The CTAs of a persistent `kernel` (kThreads threads, `bytes` of dynamic
// shared memory) that fit on the card at once, into ctas, after raising the
// kernel's dynamic shared-memory limit to `bytes`; an error where none fits.
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int bytes, int& ctas) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
  ctas = per_sm * sms;
  return e;
}

// the 16-byte chunk (of 8) that holds chunk c of weight row r of a stage:
// rows 2 t, 2 t + 1, 2 t + 8 and 2 t + 9 of the 4 lanes t of two lane groups
// land in 8 different bank groups
__device__ __forceinline__ int gemv_wchunk(int r, int c) { return c ^ (((r >> 1) & 3) << 1); }
// the 16-byte half (of 2) that holds half h of x row m of a stage: rows m
// and m + 4 of a B fragment load land in different banks
__device__ __forceinline__ int gemv_xhalf(int m, int h) { return h ^ ((m >> 2) & 1); }

// the first step of split sp of `split` over nsteps
__device__ __forceinline__ int gemv_split_step(int sp, int split, int nsteps) {
  return (int)((long long)sp * nsteps / split);
}

// bf16(f32(q) * s) of byte j of two words (the low half from `lo`, the
// high half from `hi`, which are rows k and k + 1 of one column): biased
// int8 values (kBits 8) or nibbles (kBits 4)
template <int J, int kBits = 8>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t lo, uint32_t hi, float s_lo,
                                                 float s_hi) {
  if constexpr (kBits == 4) return bf16x2_bits(nib_to_f(lo, J) * s_lo, nib_to_f(hi, J) * s_hi);
  return bf16x2_bits(q_to_f(lo, J) * s_lo, q_to_f(hi, J) * s_hi);
}

// The tasks of one product into its split-K partials: x (M, K) bf16, q (K,
// N) int8 (kBits 4: (K/2, N) packed half-split), s (K / gs, N) fp32, part
// (split, M, N) fp32; `split` slices of the K / 16 steps (1 <= split <= K /
// 16), K and N multiples of 16, any gs that divides K (kBits 4: K/2). FAST:
// gs a multiple of the rows of q a step (16; kBits 4: 8), so that a step
// lies in one group (of each plane), whose scale row the ring brings once a
// run meets it; otherwise each lane reads its scales from global memory a
// row at a time.
template <int MAXM, bool FAST, int kBits = 8>
__device__ __forceinline__ void gemv_tasks(GemvSmem<MAXM, kBits>& sm, const bf16* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ s, float* __restrict__ part,
                                           int M, int K, int N, int gs, int split) {
  using Sm = GemvSmem<MAXM, kBits>;
  using F = GemvFormat<kBits>;
  constexpr bool kInt4 = kBits == 4;
  constexpr int NT = MAXM / 8;       // n8 tiles
  constexpr int P = kInt4 ? 2 : 1;   // scale rows a group: one for each int4 plane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = lane >> 2, lt = lane & 3;  // the lane's 16 columns and its rows 2 lt, ...
  const int nsteps = K / kGemvStep;
  const int strips = (N + kGemvBN - 1) / kGemvBN;
  const int ntasks = strips * split * ((M + MAXM - 1) / MAXM);
  const uint32_t ring0 = mma::smem_u32(&sm.ring[warp][0][0]);

  // the warp's run of task t: steps [b, e)
  auto run = [&](int t, int& b, int& e) {
    const int sp = (t / strips) % split;
    const int s0 = gemv_split_step(sp, split, nsteps);
    const int n = gemv_split_step(sp + 1, split, nsteps) - s0;
    b = s0 + n * warp / kWarps;
    e = s0 + n * (warp + 1) / kWarps;
  };

  // the copies: step ps of the run [pb, pe) of task pt, the next to issue
  int pt = blockIdx.x, ps = 0, pb = 0, pe = 0;
  auto seek = [&]() {  // the first task from pt on where the warp has a run
    for (; pt < ntasks; pt += gridDim.x) {
      run(pt, pb, pe);
      if (pb < pe) break;
    }
    ps = pb;
  };
  auto issue = [&](int slot) {  // one commit group a step, empty past the last
    if (pt < ntasks) {
      const int n0 = pt % strips * kGemvBN, m0 = pt / strips / split * MAXM;
      const int k0 = ps * F::kRows;  // the step's first row of q
      const uint32_t st = ring0 + slot * Sm::kStage;
#pragma unroll
      for (int i = 0; i < F::kWBytes / 16 / 32; ++i) {  // kRows rows of 8 chunks
        const int e = lane + 32 * i, r = e >> 3, c = e & 7;
        const bool live = n0 + 16 * c < N;
        mma::cp_async<16>(st + r * kGemvBN + 16 * gemv_wchunk(r, c),
                          live ? q + (size_t)(k0 + r) * N + n0 + 16 * c : q, live);
      }
      if (FAST && (ps == pb || k0 % gs == 0)) {  // the group's scale rows, new to the run
        const bool live = n0 + 4 * lane < N;
        mma::cp_async<16>(st + F::kWBytes + 16 * lane,
                          live ? s + (size_t)(k0 / gs) * N + n0 + 4 * lane : s, live);
        if constexpr (kInt4)  // the high plane's group, K/2 / gs further
          mma::cp_async<16>(st + F::kWBytes + kGemvSBytes + 16 * lane,
                            live ? s + (size_t)(K / 2 / gs + k0 / gs) * N + n0 + 4 * lane : s,
                            live);
      }
      if (lane < 2 * MAXM) {  // x: MAXM rows of two halves, zero past M
        const int m = lane >> 1, h = lane & 1;
        const bool live = m0 + m < M;
        const uint32_t dst = st + F::kWBytes + F::kSBytes + m * 32 + 16 * gemv_xhalf(m, h);
        if constexpr (kInt4)  // the second half: the high plane's 8 columns
          mma::cp_async<16>(dst, live ? x + (size_t)(m0 + m) * K + h * (K / 2) + k0 : x, live);
        else  // the next 8 columns
          mma::cp_async<16>(dst, live ? x + (size_t)(m0 + m) * K + k0 + 8 * h : x, live);
      }
      if (++ps == pe) {
        pt += gridDim.x;
        seek();
      }
    }
    mma::cp_async_commit();
  };

  seek();
#pragma unroll
  for (int p = 0; p < F::kStages - 1; ++p) issue(p);

  // the lane's rows of the step's two halves (int4: packed rows 2 lt, 2 lt +
  // 1, their low nibbles, then their high ones)
  const int rows[4] = {2 * lt, 2 * lt + 1, kInt4 ? 2 * lt : 2 * lt + 8,
                       kInt4 ? 2 * lt + 1 : 2 * lt + 9};
  // FAST: the scales of the lane's 16 columns in the current group (int4:
  // then the high plane's)
  float sc[16 * P];
#pragma unroll
  for (int j = 0; j < 16 * P; ++j) sc[j] = 0.f;
  int item = 0;  // steps this warp has consumed: the ring slot is item % kStages
  for (int t = blockIdx.x; t < ntasks; t += gridDim.x) {
    const int strip = t % strips, sp = (t / strips) % split, m0 = t / strips / split * MAXM;
    const int n0 = strip * kGemvBN, mt = min(MAXM, M - m0);
    int b, e;
    run(t, b, e);
    float acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][j][i] = 0.f;

    for (int st = b; st < e; ++st, ++item) {
      issue((item + F::kStages - 1) % F::kStages);  // into the slot consumed last
      mma::cp_async_wait<F::kStages - 1>();          // this step's copies have landed
      __syncwarp();                                  // ... for every lane
      const unsigned char* stage = sm.ring[warp][item % F::kStages];
      const int k0 = st * F::kRows;
      // B: x rows 8 nt + lg at k 2 lt, 2 lt + 1 of each half
      uint32_t bx[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = 8 * nt + lg;
        const unsigned char* xr = stage + F::kWBytes + F::kSBytes + m * 32 + 4 * lt;
        bx[nt][0] = *reinterpret_cast<const uint32_t*>(xr + 16 * gemv_xhalf(m, 0));
        bx[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16 * gemv_xhalf(m, 1));
      }
      // A: the lane's 16 columns of its 4 rows, biased int8 values or
      // nibbles (byte j of word i is column 4 i + j)
      uint32_t w[4][4];
#pragma unroll
      for (int r = 0; r < (kInt4 ? 2 : 4); ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + rows[r] * kGemvBN + 16 * gemv_wchunk(rows[r], lg));
        if constexpr (kInt4) {
          const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[r][i] = vw[i] & kLowNibbles;
            w[r + 2][i] = (vw[i] >> 4) & kLowNibbles;
          }
        } else {
          w[r][0] = v.x ^ kBias4;
          w[r][1] = v.y ^ kBias4;
          w[r][2] = v.z ^ kBias4;
          w[r][3] = v.w ^ kBias4;
        }
      }
      if (FAST && (st == b || k0 % gs == 0)) {
        const float4* sr = reinterpret_cast<const float4*>(stage + F::kWBytes) + 4 * lg;
#pragma unroll
        for (int i = 0; i < 4 * P; ++i) {  // int4: the high plane's row 32 float4 on
          const float4 v = sr[i < 4 ? i : i - 4 + kGemvSBytes / 16];
          sc[4 * i] = v.x;
          sc[4 * i + 1] = v.y;
          sc[4 * i + 2] = v.z;
          sc[4 * i + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // m16 tile j: the lane's columns 2 j, 2 j + 1
        float s0[4], s1[4];  // the scales of columns 2 j and 2 j + 1 in each of the 4 rows
        if (FAST) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s0[r] = sc[(kInt4 ? 16 * (r >> 1) : 0) + 2 * j];
            s1[r] = sc[(kInt4 ? 16 * (r >> 1) : 0) + 2 * j + 1];
          }
        } else {
          const int c = n0 + 16 * lg + 2 * j;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (kInt4) {  // rows 2, 3: the high plane's, K/2 further
              const int kr = (r >= 2 ? K / 2 : 0) + k0 + rows[r];
              const float2 v = c < N ? __ldg(reinterpret_cast<const float2*>(
                                           s + (size_t)(kr / gs) * N + c))
                                     : make_float2(0.f, 0.f);
              s0[r] = v.x;
              s1[r] = v.y;
            } else {
              const float2 v = c < N ? __ldg(reinterpret_cast<const float2*>(
                                           s + (size_t)((k0 + rows[r]) / gs) * N + c))
                                     : make_float2(0.f, 0.f);
              s0[r] = v.x;
              s1[r] = v.y;
            }
          }
        }
        uint32_t a[4];
        if (j & 1) {
          a[0] = dequant_pair<2, kBits>(w[0][j >> 1], w[1][j >> 1], s0[0], s0[1]);
          a[1] = dequant_pair<3, kBits>(w[0][j >> 1], w[1][j >> 1], s1[0], s1[1]);
          a[2] = dequant_pair<2, kBits>(w[2][j >> 1], w[3][j >> 1], s0[2], s0[3]);
          a[3] = dequant_pair<3, kBits>(w[2][j >> 1], w[3][j >> 1], s1[2], s1[3]);
        } else {
          a[0] = dequant_pair<0, kBits>(w[0][j >> 1], w[1][j >> 1], s0[0], s0[1]);
          a[1] = dequant_pair<1, kBits>(w[0][j >> 1], w[1][j >> 1], s1[0], s1[1]);
          a[2] = dequant_pair<0, kBits>(w[2][j >> 1], w[3][j >> 1], s0[2], s0[3]);
          a[3] = dequant_pair<1, kBits>(w[2][j >> 1], w[3][j >> 1], s1[2], s1[3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt >= mt) continue;
          float lo[4], hi[4];  // the step's two 8-deep halves, each summed from zero
          mma::mma_bf16_k8(lo, a[0], a[1], bx[nt][0]);
          mma::mma_bf16_k8(hi, a[2], a[3], bx[nt][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][j][i] = (acc[nt][j][i] + lo[i]) + hi[i];
        }
      }
      __syncwarp();  // every lane is done with the slot before it is filled again
    }

    // the 8 warps' sums in warp order, 8 rows (an n8 tile) at a time, 4 warps
    // at a time through red; a thread adds 4 columns of one row
    const int rm = threadIdx.x >> 5, rc = threadIdx.x & 31;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= mt) break;  // uniform across the block
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __syncthreads();  // red is free
        if (warp >> 2 == half) {
#pragma unroll
          for (int ee = 0; ee < 2; ++ee) {  // rows 2 lt + ee: columns 16 lg + 2 j + h at acc[j][ee + 2 h]
            float* row = sm.red[warp & 3][2 * lt + ee] + 16 * lg;
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4)
              *reinterpret_cast<float4*>(row + 4 * c4) =
                  make_float4(acc[nt][2 * c4][ee], acc[nt][2 * c4][ee + 2],
                              acc[nt][2 * c4 + 1][ee], acc[nt][2 * c4 + 1][ee + 2]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          const float4 r = *reinterpret_cast<const float4*>(sm.red[w4][rm] + 4 * rc);
          v.x += r.x;
          v.y += r.y;
          v.z += r.z;
          v.w += r.w;
        }
      }
      const int m = 8 * nt + rm;
      if (m < mt && n0 + 4 * rc < N)
        *reinterpret_cast<float4*>(part + ((size_t)sp * M + m0 + m) * N + n0 + 4 * rc) = v;
    }
  }
  mma::cp_async_wait<0>();
}

// the split-K partials of columns n, n + 1 of row m (planes x split, M, N):
// each plane's splits added in order, then the planes (two for an int4
// weight's nibble planes in the `a8` mode, a8.cuh; one elsewhere)
__device__ __forceinline__ float2 split_pair_sum(const float* part, int split, int M, int N,
                                                 int m, int n, int planes = 1) {
  float a0 = 0.f, a1 = 0.f;
  for (int p = 0; p < planes; ++p) {
    float t0 = 0.f, t1 = 0.f;
    for (int j = 0; j < split; ++j) {
      const float2 v =
          *reinterpret_cast<const float2*>(part + ((size_t)(p * split + j) * M + m) * N + n);
      t0 += v.x;
      t1 += v.y;
    }
    a0 += t0;
    a1 += t1;
  }
  return make_float2(a0, a1);
}

// output column pair idx < M * N / 2 of the split-K partials through the
// epilogue (split_pair_sum, then store_pair)
__device__ __forceinline__ void split_epilogue_at(const float* part, int split, int M, int N,
                                                  const Epilogue& e, bf16* out, int idx,
                                                  int planes = 1) {
  const int pairs = N / 2;
  const int m = idx / pairs, n = (idx % pairs) * 2;
  const float2 a = split_pair_sum(part, split, M, N, m, n, planes);
  store_pair(e, m, n, N, a.x, a.y, out);
}

// gate element idx < M * H from the split-K partials of the W1|W3 product
// (planes x split, M, 2H), the splits and planes added as above
__device__ __forceinline__ void split_gate_at(const float* part, int split, int M, int H,
                                              bf16* out, int idx, int planes = 1) {
  const int m = idx / H, n = idx % H;
  float h1 = 0.f, h3 = 0.f;
  for (int p = 0; p < planes; ++p) {
    float t1 = 0.f, t3 = 0.f;
    for (int j = 0; j < split; ++j) {
      const float* pr = part + ((size_t)(p * split + j) * M + m) * (2 * (size_t)H);
      t1 += pr[n];
      t3 += pr[H + n];
    }
    h1 += t1;
    h3 += t3;
  }
  out[idx] = __float2bfloat16_rn(silu_gate(h1, h3));
}

// ---------------------------------------------------------------------------
// output column pair idx < M * N / 2 of the FFN above 16 rows (ffn.cu): the
// residual, then the down product's slices of the hidden width (nstrips, M,
// N) added in order, one cast
__device__ __forceinline__ void ffn_reduce_at(const float* part, int nstrips, int M, int N,
                                              const bf16* res, bf16* out, int idx) {
  const int pairs = N / 2;
  const int m = idx / pairs, n = (idx % pairs) * 2;
  const size_t at = (size_t)m * N + n;
  const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + at);
  float a0 = __low2float(r), a1 = __high2float(r);
  for (int j = 0; j < nstrips; ++j) {
    const float2 p = *reinterpret_cast<const float2*>(part + (size_t)j * M * N + at);
    a0 += p.x;
    a1 += p.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(a0, a1);
}

}  // namespace q8
}  // namespace hipllama
