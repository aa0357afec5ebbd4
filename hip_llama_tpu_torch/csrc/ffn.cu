// The whole Q8_0 FFN for 17-256 rows on the bf16 tensor cores: replaces
// hip_llama_tpu/ops/quant.py::q8_matmul_ffn (_q8_kernel_ffn) where the JAX
// package takes it with more than 16 rows (M <= 16 takes quant.cu's GEMV
// route, q8.cuh::gemv_tasks):
//
//   out = res + W2 bf16(silu(xn W1) * (xn W3)),  xn = rmsnorm(x, g)
//
// at the TPU kernel's cast points (quant.py:832-883): xn is bf16 from an
// fp32 rmsnorm; w = bf16(f32(q) * s); h1 and h3 are fp32 sums, gated in fp32
// and rounded once to bf16 as hb; the W2 product is an fp32 sum seeded with
// the residual and cast once.
//
// Bound on an H100: at M 128 and 7B widths the FFN does 2 M flops per int8
// weight byte, 256, just below the card's ~295 flop/byte ridge: the 144 MB of
// weights and scales (0.043 ms at 3.35 TB/s) and the 34.6 GFLOP (0.035 ms at
// 989 TFLOP/s) bound it alike. The strip kernel it replaced ran on the fp32
// CUDA cores (a floor of about 0.5 ms for the FMAs alone), read the weights
// once per 16 rows and wrote 361 MB of fp32 strip partials. The design:
//  - two tensor-core launches and two small passes: the rmsnorm (one pass,
//    xn M x K bf16), the gate product (hb = bf16(silu(xn W1) * xn W3), M x H
//    bf16: 2.8 MB at M 128, which stays in L2), the down product hb W2 as a
//    split-K product over `splits` slices of the hidden width into fp32
//    partials (splits x M x N: 16.8 MB at M 128), and the reduce that seeds
//    each output with the residual and adds the slices in order;
//  - both products run one mainloop: a CTA computes a BM x 128 tile (BM 64
//    for up to 64 rows, else 128) with 8 warps of 32 rows each (FtWarps) on
//    mma.sync.m16n8k16 bf16 -> fp32 from ldmatrix, as attention.cu's prefill
//    does. A cp.async ring (4 stages at BM 64, 3 at BM 128) brings each
//    64-deep step's x tile (bf16, XOR-swizzled), its 64 x 128 int8 weight
//    rows and their scale rows; the CTA then dequantizes the step's weights
//    into one bf16 B tile ([k][n], swizzled, read by ldmatrix.trans) and
//    multiplies. Each weight element is dequantized once per CTA, ceil(M /
//    BM) times a call (once at M <= 128), against M / 16 times in the strip
//    kernel. What bounds a step is its shared-memory traffic (the x and B
//    fragments every warp loads, the dequantization's reads and writes) and
//    the dequantization's ALU work, in two phases a CTA runs between
//    barriers, not the copies' latency: on an H100 weights copied five
//    steps ahead instead of two changed nothing, while loading each step's
//    scales once a thread and the 2 x 4 warp split at BM 64 (FtWarps) took
//    about a quarter off the gate product;
//  - the gate CTA's 128 B columns interleave blocks of W1 columns with the
//    same columns of W3 (at BM 128: W1 0..31, W3 0..31, W1 32..63, W3
//    32..63), so that a thread holds h1 and h3 of the same hidden column and
//    gates them in registers;
//  - shared memory is 112 KB a CTA, two CTAs an SM.
// Group sizes that are multiples of 8 have each step's scale rows (at most 8)
// in the ring; any other group size reads its scales a row at a time from
// global memory while dequantizing.

#include <stdint.h>

#include "common.cuh"
#include "matmul_passes.cuh"
#include "mma.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::mma;

constexpr int kFtThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kFtBN = 128;       // B columns per CTA (the gate: 64 of W1, the same 64 of W3)
constexpr int kFtBK = 64;        // k per step: a 128-byte bf16 row of x
constexpr int kFtGroups = 8;     // scale rows a step holds (gs % 8 == 0)

// A ring of STAGES steps (x tile, weight rows, scale rows), as deep as two
// CTAs an SM allow, then the dequantized B tile
template <int BM>
struct FtLayout {
  static constexpr int STAGES = BM == 64 ? 4 : 3;
  static constexpr int X = BM * kFtBK * 2;          // x tile, bf16 [m][k], 8 chunks a row
  static constexpr int RAW = kFtBK * kFtBN;         // int8 weight rows as they lie
  static constexpr int SC = kFtGroups * kFtBN * 4;  // the step's scale rows
  static constexpr int STAGE = X + RAW + SC;
  static constexpr int B = kFtBK * kFtBN * 2;       // the dequantized bf16 [k][n] tile
  static constexpr int BYTES = STAGES * STAGE + B;
};

// The warps of a CTA: WMG along M x 8 / WMG along N, each 32 rows (two
// m16 tiles) by 128 / (8 / WMG) columns. Each warp along M reads the B
// fragments of its columns again and each warp along N the x fragments of
// its rows, so the split that moves fewer bytes through ldmatrix wins: 2 x 4
// at BM 64 (16 KB a k16 step, against 20 KB for 4 x 2), 4 x 2 at BM 128.
template <int BM>
struct FtWarps {
  static constexpr int WMG = BM / 32;         // warps along M
  static constexpr int WNC = kFtBN * WMG / 8; // columns a warp
  static constexpr int NT8 = WNC / 8;         // its n8 tiles
  static constexpr int IB = WNC / 2;          // the gate's W1 (W3) block a warp
};

// B column n of a CTA at hidden column h0 (GATE) or output column n0: its
// column in q and s (row stride ldq), and whether it is in (< ncols). The
// gate's columns interleave blocks of IB columns of W1 and the same IB of
// W3, so that each warp holds IB hidden columns of both.
template <bool GATE, int IB>
__device__ __forceinline__ int ft_col(int n, int c0, int off3, int ncols, bool& live) {
  if (GATE) {  // IB-column blocks: W1, W3, W1, W3, ...
    const int blk = n / IB, h = c0 + (blk >> 1) * IB + n % IB;
    live = h < ncols;
    return (blk & 1) * off3 + h;
  }
  live = c0 + n < ncols;
  return c0 + n;
}

// One BM x 128 tile of x (M x K bf16, row stride K) times the dequantized
// weight q (K x ldq int8, s (K / gs) x ldq fp32), over the k steps
// [step0, step1) of 64 rows. GATE: the B columns are W1|W3 pairs at hidden
// columns h0 = blockIdx.y * 64 (W3 off3 columns further in q), the epilogue
// writes hb = bf16(silu(h1) * h3) (M x ncols); else the columns are n0 =
// blockIdx.y * 128 and the epilogue writes the fp32 partial sums of split
// blockIdx.z to part (splits x M x ncols).
template <int BM, bool GATE>
__global__ void __launch_bounds__(kFtThreads, 2) ffn_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    int M, int K, int ldq, int ncols, int off3, int gs, int steps_per_split,
    bf16* __restrict__ hb, float* __restrict__ part) {
  using Lay = FtLayout<BM>;
  using Wp = FtWarps<BM>;
  constexpr int FM = 2;            // m16 tiles per warp: 32 rows
  constexpr int NT8 = Wp::NT8;
  constexpr int AHEAD = Lay::STAGES - 1;  // steps copied ahead
  extern __shared__ __align__(128) unsigned char ft_smem[];
  const uint32_t smem0 = smem_u32(ft_smem);
  const uint32_t bt = smem0 + Lay::STAGES * Lay::STAGE;  // the B tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Wp::WMG, wn = warp / Wp::WMG;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * (GATE ? kFtBN / 2 : kFtBN);
  const int n_steps = (K + kFtBK - 1) / kFtBK;
  const int step0 = GATE ? 0 : blockIdx.z * steps_per_split;
  const int step1 = GATE ? n_steps : min(n_steps, step0 + steps_per_split);

  // the copies of step it into stage it % STAGES: its x tile, its weight
  // rows and their scales
  auto issue = [&](int it) {
    const uint32_t base = smem0 + (it % Lay::STAGES) * Lay::STAGE;
    const int k0 = it * kFtBK;
#pragma unroll
    for (int i = 0; i < BM * 8 / kFtThreads; ++i) {  // x: BM rows of 8 chunks
      const int e = tid + kFtThreads * i, r = e >> 3, c = e & 7;
      const bool live = m0 + r < M && k0 + 8 * c < K;
      cp_async<16>(base + tile_chunk<8>(r, c) * 16,
                   live ? x + (size_t)(m0 + r) * K + k0 + 8 * c : x, live);
    }
#pragma unroll
    for (int i = 0; i < kFtBK * 8 / kFtThreads; ++i) {  // q: 64 rows of 8 chunks of 16 columns
      const int e = tid + kFtThreads * i, r = e >> 3, c = e & 7;
      bool in;
      const int col = ft_col<GATE, Wp::IB>(16 * c, c0, off3, ncols, in);
      const bool live = in && k0 + r < K;
      cp_async<16>(base + Lay::X + r * kFtBN + 16 * c,
                   live ? q + (size_t)(k0 + r) * ldq + col : q, live);
    }
    if (gs % 8 == 0) {  // s: the step's groups (at most 8), 32 chunks of 4 columns
      const int g0 = k0 / gs, ng = (min(K, k0 + kFtBK) - 1) / gs - g0 + 1;
      const int gi = tid >> 5, c = tid & 31;
      bool in;
      const int col = ft_col<GATE, Wp::IB>(4 * c, c0, off3, ncols, in);
      if (gi < ng)
        cp_async<16>(base + Lay::X + Lay::RAW + (gi * kFtBN + 4 * c) * 4,
                     in ? s + (size_t)(g0 + gi) * ldq + col : s, in);
    }
  };

  float acc[FM][NT8][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one copy group a step, AHEAD steps ahead
#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    if (step0 + p < step1) issue(step0 + p);
    cp_async_commit();
  }
  for (int it = step0; it < step1; ++it) {
    cp_async_wait<AHEAD - 1>();  // step it's copies have landed
    __syncthreads();             // ... for every thread; step it - 1's products are done
    if (it + AHEAD < step1) issue(it + AHEAD);
    cp_async_commit();

    // dequantize the step's weights into the B tile: thread chunk e = row
    // e / 16, columns 8 (e % 16) .. + 7; a thread's chunks share their
    // columns (rows tid / 16 + 16 i), and where gs % 64 == 0 their group
    const unsigned char* stage = ft_smem + (it % Lay::STAGES) * Lay::STAGE + Lay::X;
    const int k0 = it * kFtBK;
    const bool one_group = gs % kFtBK == 0;
    float4 g0s = make_float4(0.f, 0.f, 0.f, 0.f), g1s = g0s;
    if (one_group) {
      const float* sr = reinterpret_cast<const float*>(stage + Lay::RAW) + 8 * (tid & 15);
      g0s = *reinterpret_cast<const float4*>(sr);
      g1s = *reinterpret_cast<const float4*>(sr + 4);
    }
#pragma unroll
    for (int i = 0; i < kFtBK * 16 / kFtThreads; ++i) {
      const int e = tid + kFtThreads * i, r = e >> 4, c = e & 15;
      const uint2 raw = *reinterpret_cast<const uint2*>(stage + r * kFtBN + 8 * c);
      float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;  // rows past K: their raw is zero
      const bool row_in = k0 + r < K;
      if (one_group) {
        s0 = g0s;
        s1 = g1s;
      } else if (row_in && gs % 8 == 0) {
        const float* sr = reinterpret_cast<const float*>(stage + Lay::RAW) +
                          ((k0 + r) / gs - k0 / gs) * kFtBN + 8 * c;
        s0 = *reinterpret_cast<const float4*>(sr);
        s1 = *reinterpret_cast<const float4*>(sr + 4);
      } else if (row_in) {
        bool in;
        const int col = ft_col<GATE, Wp::IB>(8 * c, c0, off3, ncols, in);
        if (in) {
          const float4* sp = reinterpret_cast<const float4*>(s + (size_t)((k0 + r) / gs) * ldq + col);
          s0 = __ldg(sp);
          s1 = __ldg(sp + 1);
        }
      }
      const uint2 lo = hipllama::q8::dequant4(raw.x ^ hipllama::q8::kBias4, s0);
      const uint2 hi = hipllama::q8::dequant4(raw.y ^ hipllama::q8::kBias4, s1);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(bt + tile_chunk<16>(r, c) * 16),
                   "r"(lo.x), "r"(lo.y), "r"(hi.x), "r"(hi.y)
                   : "memory");
    }
    __syncthreads();  // the B tile is whole

    const uint32_t xt = smem0 + (it % Lay::STAGES) * Lay::STAGE;
#pragma unroll
    for (int kk = 0; kk < kFtBK / 16; ++kk) {
      uint32_t a[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)  // rows 16 i .. + 15 of the warp's, chunks 2 kk, 2 kk + 1
        ldsm_x4(xt + tile_chunk<8>(wm * 32 + 16 * i + (lane & 15), 2 * kk + (lane >> 4)) * 16,
                a[i][0], a[i][1], a[i][2], a[i][3]);
#pragma unroll
      for (int dp = 0; dp < NT8 / 2; ++dp) {
        // k rows 16 kk + 0..15 (lane bit 3), n8 tiles 2 dp, 2 dp + 1 (lanes 16-31)
        const int r = 16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7);
        const int c = wn * NT8 + 2 * dp + (lane >> 4);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(bt + tile_chunk<16>(r, c) * 16, b0, b1, b2, b3);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_bf16(acc[i][2 * dp], a[i], b0, b1);
          mma_bf16(acc[i][2 * dp + 1], a[i], b2, b3);
        }
      }
    }
  }

  // epilogue: element e of n8 tile j is row 16 i + lane / 4 + 8 (e >> 1),
  // column 8 j + 2 (lane % 4) + (e & 1) of the warp's WNC
  const int qd = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + 16 * i + (lane >> 2) + 8 * h;
      if (row >= M) continue;
      if (GATE) {  // the first NT8 / 2 n8 tiles W1, the rest W3, of hidden columns IB wn + ...
#pragma unroll
        for (int j = 0; j < NT8 / 2; ++j) {
          const int col = c0 + Wp::IB * wn + 8 * j + 2 * qd;
          if (col < ncols)
            *reinterpret_cast<__nv_bfloat162*>(hb + (size_t)row * ncols + col) =
                __floats2bfloat162_rn(
                    hipllama::q8::silu_gate(acc[i][j][2 * h], acc[i][j + NT8 / 2][2 * h]),
                    hipllama::q8::silu_gate(acc[i][j][2 * h + 1],
                                            acc[i][j + NT8 / 2][2 * h + 1]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT8; ++j) {
          const int col = c0 + Wp::WNC * wn + 8 * j + 2 * qd;
          if (col < ncols)
            *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + row) * ncols + col) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
}

__global__ void ffn_reduce_kernel(const float* __restrict__ part, int splits, int M, int N,
                                  const bf16* __restrict__ res, bf16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * (N / 2)) hipllama::q8::ffn_reduce_at(part, splits, M, N, res, out, idx);
}

template <int BM, bool GATE>
int launch_ffn_mma(const void* x, const void* q, const void* s, int M, int K, int ldq,
                   int ncols, int off3, int gs, int splits, int steps_per_split, bf16* hb,
                   float* part, cudaStream_t st) {
  auto kernel = ffn_mma_kernel<BM, GATE>;
  const int smem = FtLayout<BM>::BYTES;
  HIPLLAMA_TRY((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem));
  // the row tiles of one column strip side by side, so that they meet its
  // weights in L2
  const dim3 grid((M + BM - 1) / BM, (ncols + (GATE ? 64 : 128) - 1) / (GATE ? 64 : 128),
                  GATE ? 1 : splits);
  kernel<<<grid, kFtThreads, smem, st>>>((const bf16*)x, (const int8_t*)q, (const float*)s, M,
                                         K, ldq, ncols, off3, gs, steps_per_split, hb, part);
  return check_launch();
}

template <int BM>
int run_ffn(const void* xn, const void* q13, const void* s13, const void* q2, const void* s2,
            const void* res, void* out, void* hb_ws, void* part_ws, int M, int K, int H, int N,
            int gs13, int gs2, int splits, cudaStream_t st) {
  bf16* hb = (bf16*)hb_ws;
  float* part = (float*)part_ws;
  HIPLLAMA_TRY((launch_ffn_mma<BM, true>(xn, q13, s13, M, K, 2 * H, H, H, gs13, 1, 0, hb,
                                         nullptr, st)));
  const int steps = (H + kFtBK - 1) / kFtBK;
  const int per = (steps + splits - 1) / splits;
  HIPLLAMA_TRY((launch_ffn_mma<BM, false>(hb, q2, s2, M, H, N, N, 0, gs2, splits, per, nullptr,
                                          part, st)));
  ffn_reduce_kernel<<<blocks((long long)M * (N / 2)), kEltThreads, 0, st>>>(part, splits, M, N,
                                                                          (const bf16*)res,
                                                                          (bf16*)out);
  return check_launch();
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// res + W2 bf16(silu(xn W1) * xn W3), xn = rmsnorm(x, g): x (M, K), res and
// out (M, N) bf16; q13 (K, 2H) int8 with s13 (K / gs13, 2H) fp32, q2 (H, N)
// int8 with s2 (H / gs2, N) fp32; g (K,) fp32. Workspaces: xn_ws (M, K) bf16, hb_ws (M, H) bf16,
// part_ws (splits, M, N) fp32, where splits (>= 1, at most ceil(H / 64))
// cuts the down product's hidden rows into slices of whole 64-row steps
// (the last slice may hold fewer, but none is empty). 1 <= M, K, H, N
// multiples of 16.
extern "C" int q8_matmul_ffn_tc(const void* x, const void* q13, const void* s13,
                                const void* q2, const void* s2, const void* g, const void* res,
                                void* out, void* xn_ws, void* hb_ws, void* part_ws, int M, int K,
                                int H, int N, int gs13, int gs2, int splits, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = (H + kFtBK - 1) / kFtBK;
  if (M < 1 || K % 16 || H % 16 || N % 16 || gs13 < 1 || K % gs13 || gs2 < 1 || H % gs2 ||
      splits < 1 || splits > steps || (splits - 1) * ((steps + splits - 1) / splits) >= steps)
    return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
  if (M <= 64)
    return run_ffn<64>(xn_ws, q13, s13, q2, s2, res, out, hb_ws, part_ws, M, K, H, N, gs13, gs2,
                       splits, st);
  return run_ffn<128>(xn_ws, q13, s13, q2, s2, res, out, hb_ws, part_ws, M, K, H, N, gs13, gs2,
                      splits, st);
}
