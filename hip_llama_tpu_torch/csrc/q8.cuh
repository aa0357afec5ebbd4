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
// Each piece is a device function of one task (a CTA's share of the work)
// or one output element, so that a kernel of its own (a task per CTA) and
// the fused layer (tasks dealt out to a persistent grid) run the same code
// and round alike. All take kThreads threads per CTA. The tasks are inlined
// into their kernels, so their shared-memory structs are addressed as
// shared memory and not through generic pointers.
#pragma once

#include <stdint.h>

#include "common.cuh"

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

__device__ __forceinline__ void store_pair(const Epilogue& e, int m, int n, int N, float a0,
                                           float a1, bf16* out) {
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
  *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(a0, a1);
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

// eight bf16 weights of one row (raw int8 in `raw`, scales s0|s1), widened
__device__ __forceinline__ void dequant8(uint2 raw, float4 s0, float4 s1, float w[8]) {
  const uint2 lo = dequant4(raw.x ^ kBias4, s0), hi = dequant4(raw.y ^ kBias4, s1);
  const uint32_t wp[4] = {lo.x, lo.y, hi.x, hi.y};  // bf16x2 pairs of columns
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = __uint_as_float(wp[j] << 16);
    w[2 * j + 1] = __uint_as_float(wp[j] & 0xFFFF0000u);
  }
}

// acc[m][j] += x[k][m] * w[j] for the MAXM activation rows of one k, held
// transposed in shared memory (xr = the row of k: MAXM bf16, 16-byte aligned)
template <int MAXM>
__device__ __forceinline__ void fma_rows(const bf16* xr, const float w[8], float acc[MAXM][8]) {
#pragma unroll
  for (int m8 = 0; m8 < MAXM; m8 += 8) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + m8);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
    for (int mm = 0; mm < 8; ++mm) {
      const float xf = to_f(xe[mm]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m8 + mm][j] = fmaf(xf, w[j], acc[m8 + mm][j]);
    }
  }
}

// rows kbeg..kend-1 of x (rows m0..m0+M-1, K wide) into xs[k - kbeg][m],
// zero past M
template <int MAXM>
__device__ __forceinline__ void load_xs(bf16 (*xs)[MAXM], const bf16* x, int M, int m0, int K,
                                        int kbeg, int kend) {
  for (int i = threadIdx.x; i < (kend - kbeg) * MAXM; i += kThreads) {
    const int kk = i / MAXM, m = i % MAXM;
    xs[kk][m] = m < M ? x[(size_t)(m0 + m) * K + kbeg + kk] : __float2bfloat16_rn(0.f);
  }
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
// the split-K GEMV (decode-shaped M): a task is one strip of 256 columns and
// one K slice of at most 1024 rows, for up to MAXM activation rows. A warp
// reads 256 contiguous int8 bytes of a weight row per load; the activation
// rows sit transposed in shared memory so one 16-byte load gives 8 rows of
// one k. The task's fp32 partial sums go to part[(split * ldm + m0 + m) * N
// + n]; split_epilogue_at adds the splits in a fixed order (no float
// atomics: greedy decoding gives the same tokens every run).

constexpr int kGvBN = 32 * 8;   // columns per strip: 8 per lane
constexpr int kGvKMax = 1024;   // contraction rows per task at most

template <int MAXM>
struct GemvSmem {
  __align__(16) bf16 xs[kGvKMax][MAXM];  // x transposed: [k][m]
  float red[kWarps][kGvBN];
};

template <int MAXM>
__device__ __forceinline__ void gemv_task(GemvSmem<MAXM>& sm, const bf16* x,
                                          const int8_t* __restrict__ q,
                                          const float* __restrict__ s, float* part, int M, int ldm,
                                          int m0, int K, int N, int gs, int kslice, int strip,
                                          int split) {
  constexpr int R = MAXM <= 8 ? 8 : 4;  // rows a warp has in flight
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = strip * kGvBN;
  const int kbeg = split * kslice;
  const int kend = min(K, kbeg + kslice);
  __syncthreads();  // the previous task's readers of sm are done
  load_xs<MAXM>(sm.xs, x, M, m0, K, kbeg, kend);
  __syncthreads();

  const int n = n0 + lane * 8;
  const bool live = n < N;  // N % 8 == 0: a lane's 8 columns are all in or all out
  float acc[MAXM][8];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
  int cur_g = -1;

  for (int k0 = kbeg + warp * R; k0 < kend; k0 += kWarps * R) {
    uint2 raw[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + r;
      raw[r] = (live && k < kend) ? __ldg(reinterpret_cast<const uint2*>(q + (size_t)k * N + n))
                                  : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + r;
      if (k < kend) {  // uniform across the warp
        const int grp = k / gs;
        if (grp != cur_g) {
          cur_g = grp;
          if (live) {
            s0 = __ldg(reinterpret_cast<const float4*>(s + (size_t)grp * N + n));
            s1 = __ldg(reinterpret_cast<const float4*>(s + (size_t)grp * N + n + 4));
          }
        }
        float w[8];
        dequant8(raw[r], s0, s1, w);
        fma_rows<MAXM>(sm.xs[k - kbeg], w, acc);
      }
    }
  }

  // the 8 warps' sums of each row, added in warp order
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {  // uniform across the block
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.red[warp][lane * 8 + j] = acc[m][j];
      __syncthreads();
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sm.red[w][tid];
      if (n0 + tid < N) part[((size_t)split * ldm + m0 + m) * N + n0 + tid] = v;
      __syncthreads();
    }
  }
}

// output column pair idx < M * N / 2 of the split-K partials (planes x
// split, M, N) through the epilogue: each plane's splits added in order,
// then the planes (two for an int4 weight's nibble planes in the `a8` mode,
// a8.cuh; one elsewhere)
__device__ __forceinline__ void split_epilogue_at(const float* part, int split, int M, int N,
                                                  const Epilogue& e, bf16* out, int idx,
                                                  int planes = 1) {
  const int pairs = N / 2;
  const int m = idx / pairs, n = (idx % pairs) * 2;
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
  store_pair(e, m, n, N, a0, a1, out);
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
// the whole FFN for decode-shaped rows, one hidden strip per task (the TPU
// kernel's grid step over hidden strips, quant.py:832-886): the task
// computes h1 and h3 of its kFfBH hidden columns over the whole contraction
// (W1 and W3 strips, K x kFfBH int8 each), gates them to hb = bf16(silu(h1)
// * h3) in shared memory, and multiplies hb by its kFfBH rows of W2 into the
// strip's fp32 partial part[(strip * ldm + m0 + m) * N + n]. ffn_reduce_at
// seeds each output with the residual and adds the strips in order, as the
// TPU kernel's accumulator does. h never leaves the CTA.

constexpr int kFfBH = 64;                       // hidden columns per strip
constexpr int kFfLanes = 2 * kFfBH / 8;         // threads per W1|W3 row: 8 columns each
constexpr int kFfGroups = kThreads / kFfLanes;  // rows in flight side by side

template <int MAXM>
struct FfnSmem {
  __align__(16) bf16 xs[kGvKMax][MAXM];  // a K slice of xn, transposed
  float red[kFfGroups][2 * kFfBH];
  float hsum[2 * kFfBH];
  __align__(16) bf16 hb[kFfBH][MAXM];    // the gated strip, transposed
};

template <int MAXM>
__device__ __forceinline__ void ffn_strip_task(
    FfnSmem<MAXM>& sm, const bf16* xn, const int8_t* __restrict__ q13,
    const float* __restrict__ s13, const int8_t* __restrict__ q2, const float* __restrict__ s2,
    float* part, int M, int ldm, int m0, int K, int H, int N, int gs13, int gs2, int strip) {
  constexpr int R = MAXM <= 8 ? 8 : 4;  // rows a thread has in flight
  const int tid = threadIdx.x;
  const int grp = tid / kFfLanes, fl = tid % kFfLanes;
  const int h0 = strip * kFfBH;
  const int c = (fl % (kFfLanes / 2)) * 8;  // the thread's 8 columns of the strip
  const bool w3 = fl >= kFfLanes / 2;
  const int ld13 = 2 * H;
  const int qcol = (w3 ? H : 0) + h0 + c;
  const bool live = h0 + c < H;  // H % 8 == 0

  float acc[MAXM][8];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
  int cur_g = -1;
  for (int kb = 0; kb < K; kb += kGvKMax) {
    const int kend = min(K, kb + kGvKMax);
    __syncthreads();  // the previous slice's (or task's) readers of xs are done
    load_xs<MAXM>(sm.xs, xn, M, m0, K, kb, kend);
    __syncthreads();
    for (int k0 = kb + grp * R; k0 < kend; k0 += kFfGroups * R) {
      uint2 raw[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + r;
        raw[r] = (live && k < kend)
                     ? __ldg(reinterpret_cast<const uint2*>(q13 + (size_t)k * ld13 + qcol))
                     : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + r;
        if (k < kend) {
          const int g = k / gs13;
          if (g != cur_g) {
            cur_g = g;
            if (live) {
              s0 = __ldg(reinterpret_cast<const float4*>(s13 + (size_t)g * ld13 + qcol));
              s1 = __ldg(reinterpret_cast<const float4*>(s13 + (size_t)g * ld13 + qcol + 4));
            }
          }
          float w[8];
          dequant8(raw[r], s0, s1, w);
          fma_rows<MAXM>(sm.xs[k - kb], w, acc);
        }
      }
    }
  }

  // h1|h3 of each row: the row groups' sums added in order, then the gate
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {  // uniform across the block
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.red[grp][fl * 8 + j] = acc[m][j];
      __syncthreads();
      if (tid < 2 * kFfBH) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < kFfGroups; ++g) v += sm.red[g][tid];
        sm.hsum[tid] = v;
      }
      __syncthreads();
      if (tid < kFfBH)
        sm.hb[tid][m] = h0 + tid < H ? __float2bfloat16_rn(silu_gate(sm.hsum[tid],
                                                                     sm.hsum[kFfBH + tid]))
                                     : __float2bfloat16_rn(0.f);
    }
  }
  for (int i = tid; i < kFfBH * MAXM; i += kThreads)
    if (i % MAXM >= M) sm.hb[i / MAXM][i % MAXM] = __float2bfloat16_rn(0.f);
  __syncthreads();

  // hb (M, kFfBH) @ W2[h0 .. h0 + rows, :]: 8 columns per thread, a warp
  // reads 256 contiguous bytes of a W2 row per load
  const int rows = min(kFfBH, H - h0);
  for (int n = tid * 8; n < N; n += kThreads * 8) {
    float a[MAXM][8];
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) a[m][j] = 0.f;
    int g2 = -1;
    for (int r0 = 0; r0 < rows; r0 += 8) {
      uint2 raw[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        raw[r] = r0 + r < rows
                     ? __ldg(reinterpret_cast<const uint2*>(q2 + (size_t)(h0 + r0 + r) * N + n))
                     : make_uint2(0u, 0u);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r0 + r < rows) {
          const int g = (h0 + r0 + r) / gs2;
          if (g != g2) {
            g2 = g;
            s0 = __ldg(reinterpret_cast<const float4*>(s2 + (size_t)g * N + n));
            s1 = __ldg(reinterpret_cast<const float4*>(s2 + (size_t)g * N + n + 4));
          }
          float w[8];
          dequant8(raw[r], s0, s1, w);
          fma_rows<MAXM>(sm.hb[r0 + r], w, a);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        float4* dst = reinterpret_cast<float4*>(part + ((size_t)strip * ldm + m0 + m) * N + n);
        dst[0] = make_float4(a[m][0], a[m][1], a[m][2], a[m][3]);
        dst[1] = make_float4(a[m][4], a[m][5], a[m][6], a[m][7]);
      }
    }
  }
}

// output column pair idx < M * N / 2 of the FFN: the residual, then the
// strips' partials (nstrips, M, N) added in order, one cast
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
