// Q8_0 weight-only matmuls: y = [rmsnorm(x, g)] @ dequant(q, s), with
// q (K, N) int8 row-major and s (K/gs, N) fp32 (one scale per gs rows of a
// column), x bf16 activations and bf16 outputs. The cast points are listed
// in q8.cuh, which holds the device code this file shares with
// layer_fused.cu.
//
// q8_matmul replaces hip_llama_tpu/ops/quant.py::q8_matmul (_q8_kernel and
// its norm / residual / rope variants; the head-split output is a view of
// the row-major (M, N) result and needs no kernel work). q8_matmul_silu
// replaces q8_matmul_silu (_q8_kernel_silu): silu(xn W1) * (xn W3) from the
// concatenated W1|W3 (K, 2H). q8_matmul_ffn replaces q8_matmul_ffn
// (_q8_kernel_ffn): x + W2 bf16(silu(xn W1) * xn W3).
//
// Bounds on an H100: with decode-shaped M (a few rows) every int8 weight
// byte is used for 2M flops, far below the card's ~295 flop/byte ridge, so
// the product is bound by the weight bytes (1 byte per weight plus 4/gs for
// the scales). The GEMV path (M <= 16) streams the weight once: each CTA
// owns 256 columns and a slice of K (split K, so that even N = 4096 fills
// the 132 SMs), and a second pass adds the slices in a fixed order and
// applies the epilogue. At prefill M (B*T up to 2048) the product does 2M
// flops per weight byte and is bound by operations: the tiled path
// dequantizes each 32 x 128 weight tile into shared memory as bf16 and runs
// bf16 tensor-core products (nvcuda::wmma, fp32 accumulators) on 128 x 128
// output tiles. The rmsnorm prologue is a pass of its own that writes xn
// once (M x K bf16, which stays in L2; matmul_passes.cuh, with the GEMV
// path's second pass).
//
// q8_matmul_ffn is one CTA per 64-column hidden strip and 16 rows
// (q8.cuh::ffn_strip_task): the strip's h never leaves the CTA, and W1, W3
// and W2 are each read once per 16 rows. Its cost beside the weights is the
// strips' fp32 partials (H / 64 x M x N x 4 bytes: 22 MB at 7B and M 8),
// written once and read once by the reduce pass that adds them in order.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::q8;
using hipllama::to_f;
using hipllama::warp_sum;
namespace wmma = nvcuda::wmma;

// ---------------------------------------------------------------------------
// GEMV path (M <= 16): one (strip, split) task per CTA

template <int MAXM>
__global__ void __launch_bounds__(kThreads) q8_gemv_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int gs, int kslice) {
  __shared__ GemvSmem<MAXM> sm;
  gemv_task<MAXM>(sm, x, q, s, part, M, M, 0, K, N, gs, kslice, blockIdx.x, blockIdx.y);
}

// ---------------------------------------------------------------------------
// the FFN: one (16-row chunk, hidden strip) task per CTA, then the reduce.
// The chunks of a strip are adjacent in launch order, so they run together
// and all but the first find the strip's weights in L2.

template <int MAXM>
__global__ void __launch_bounds__(kThreads) q8_ffn_strip_kernel(
    const bf16* __restrict__ xn, const int8_t* __restrict__ q13, const float* __restrict__ s13,
    const int8_t* __restrict__ q2, const float* __restrict__ s2, float* __restrict__ part, int M,
    int K, int H, int N, int gs13, int gs2) {
  __shared__ FfnSmem<MAXM> sm;
  const int m0 = blockIdx.x * MAXM;
  ffn_strip_task<MAXM>(sm, xn, q13, s13, q2, s2, part, min(MAXM, M - m0), M, m0, K, H, N, gs13,
                       gs2, blockIdx.y);
}

__global__ void q8_ffn_reduce_kernel(const float* __restrict__ part, int nstrips, int M, int N,
                                     const bf16* __restrict__ res, bf16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * (N / 2)) ffn_reduce_at(part, nstrips, M, N, res, out, idx);
}

// ---------------------------------------------------------------------------
// tiled tensor-core path (M > 16)

constexpr int kMmThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kMmBN = 128;
constexpr int kMmBK = 32;
constexpr int kMmLda = kMmBK + 8;   // padded rows (multiples of 8 bf16, 32-byte aligned tiles)
constexpr int kMmLdb = kMmBN + 8;

// GATE: two weight tiles per step, W1 columns n and W3 columns off3 + n, and
// the gate epilogue; else one tile and the q8_matmul epilogue. ldq is the
// row stride of q and s; ncols the output width. Each thread owns one
// 16-column chunk of x (the first BM * 2 threads) and one of each weight
// tile per step. Loading the next step's chunks into registers before this
// step's products (one stage of software pipelining) made the gate variant
// slower at prefill rows (more registers, fewer CTAs per SM); it is left out.
template <bool GATE>
__global__ void __launch_bounds__(kMmThreads) q8_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    int M, int K, int ldq, int ncols, int off3, int gs, Epilogue e, bf16* __restrict__ out) {
  constexpr int BM = GATE ? 64 : 128;
  constexpr int WM = BM / 4;      // rows per warp
  constexpr int FM = WM / 16;     // 16-row fragments per warp
  constexpr int FN = 4;           // 16-column fragments per warp (64 columns)
  constexpr int NB = GATE ? 2 : 1;
  static_assert(kMmBK * (kMmBN / 16) == kMmThreads, "one weight chunk per thread and tile");
  static_assert(BM * 2 <= kMmThreads, "at most one x chunk per thread");
  __shared__ __align__(32) bf16 a_s[BM][kMmLda];
  __shared__ __align__(32) bf16 b_s[NB][kMmBK][kMmLdb];
  __shared__ __align__(32) float c_s[kMmThreads / 32][NB][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kMmBN;
  // this thread's chunks: x row xr, columns xc..xc+15 of the step; weight
  // row wr, columns wc..wc+15 of each tile
  const bool has_x = tid < BM * 2;
  const int xr = tid >> 1, xc = (tid & 1) * 16;
  const int wr = tid >> 3, wc = (tid & 7) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][FM][FN];
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[t][i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kMmBK) {
    if (has_x) {
      uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
      const int gm = m0 + xr, gk = k0 + xc;
      if (gm < M && gk < K) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
        v0 = src[0];
        v1 = src[1];
      }
      uint4* dst = reinterpret_cast<uint4*>(&a_s[xr][xc]);
      dst[0] = v0;
      dst[1] = v1;
    }
    const int wk = k0 + wr, gn = n0 + wc;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      uint4 o0 = make_uint4(0u, 0u, 0u, 0u), o1 = o0;
      if (wk < K && gn < ncols) {
        const int qc = gn + t * off3;
        const uint4 qv = __ldg(reinterpret_cast<const uint4*>(q + (size_t)wk * ldq + qc));
        const float4* sp = reinterpret_cast<const float4*>(s + (size_t)(wk / gs) * ldq + qc);
        const uint2 w0 = dequant4(qv.x ^ kBias4, __ldg(sp));
        const uint2 w1 = dequant4(qv.y ^ kBias4, __ldg(sp + 1));
        const uint2 w2 = dequant4(qv.z ^ kBias4, __ldg(sp + 2));
        const uint2 w3 = dequant4(qv.w ^ kBias4, __ldg(sp + 3));
        o0 = make_uint4(w0.x, w0.y, w1.x, w1.y);
        o1 = make_uint4(w2.x, w2.y, w3.x, w3.y);
      }
      uint4* dst = reinterpret_cast<uint4*>(&b_s[t][wr][wc]);
      dst[0] = o0;
      dst[1] = o1;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], &a_s[wm * WM + i * 16][kk], kMmLda);
#pragma unroll
      for (int t = 0; t < NB; ++t) {
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, &b_s[t][kk][wn * 64 + j * 16], kMmLdb);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[t][i][j], af[i], bfr, acc[t][i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue, one 16 x 16 fragment at a time through the warp's scratch:
  // lane -> row lane / 2, columns (lane % 2) * 8 .. + 7
  float* cs1 = c_s[warp][0];
  float* cs3 = c_s[warp][NB - 1];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs1, acc[0][i][j], 16, wmma::mem_row_major);
      if (GATE) wmma::store_matrix_sync(cs3, acc[NB - 1][i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * WM + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + c0;
      if (gm < M) {
#pragma unroll
        for (int p = 0; p < 8; p += 2) {
          const int n = gn + p;
          if (n < ncols) {
            const float a0 = cs1[r * 16 + c0 + p], a1 = cs1[r * 16 + c0 + p + 1];
            if (GATE) {
              const float b0 = cs3[r * 16 + c0 + p], b1 = cs3[r * 16 + c0 + p + 1];
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gm * ncols + n) =
                  __floats2bfloat162_rn(silu_gate(a0, b0), silu_gate(a1, b1));
            } else {
              store_pair(e, gm, n, ncols, a0, a1, out);
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// launchers

int launch_gemv(const void* x, const void* q, const void* s, float* part, int M, int K, int N,
                int gs, int split, int kslice, cudaStream_t st) {
  if (M > 16 || kslice > kGvKMax || (long long)split * kslice < K ||
      (long long)(split - 1) * kslice >= K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kGvBN - 1) / kGvBN, split);
  if (M <= 8)
    q8_gemv_kernel<8><<<grid, kThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                 (const float*)s, part, M, K, N, gs, kslice);
  else
    q8_gemv_kernel<16><<<grid, kThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                  (const float*)s, part, M, K, N, gs, kslice);
  return check_launch();
}

template <bool GATE>
int launch_mma(const void* x, const void* q, const void* s, int M, int K, int ldq, int ncols,
               int off3, int gs, const Epilogue& e, void* out, cudaStream_t st) {
  constexpr int BM = GATE ? 64 : 128;
  const dim3 grid((ncols + kMmBN - 1) / kMmBN, (M + BM - 1) / BM);
  q8_mma_kernel<GATE><<<grid, kMmThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                   (const float*)s, M, K, ldq, ncols, off3, gs, e,
                                                   (bf16*)out);
  return check_launch();
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// All activations bf16, q int8, s and g fp32, pos int32. g, res and pos may be
// null (no norm, no residual, no RoPE). xn_ws: (M, K) bf16 workspace, used
// when g is given. split > 0 takes the GEMV path (M <= 16) with part_ws
// (split, M, N) fp32 and kslice rows per split; split == 0 the tiled path.
// K % 16 == 0, N % 16 == 0.
extern "C" int q8_matmul(const void* x, const void* q, const void* s, const void* g,
                         const void* res, const void* pos, void* out, void* xn_ws, void* part_ws,
                         int M, int K, int N, int gs, int split, int kslice, int rope_limit,
                         int rope_hs, float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  if (split > 0) {
    HIPLLAMA_TRY(launch_gemv(xin, q, s, (float*)part_ws, M, K, N, gs, split, kslice, st));
    return launch_split_epilogue((const float*)part_ws, split, M, N, e, out, st);
  }
  return launch_mma<false>(xin, q, s, M, K, N, N, 0, gs, e, out, st);
}

// silu(xn W1) * (xn W3) with q13 (K, 2H); out (M, H). Workspaces as above,
// part_ws (split, M, 2H).
extern "C" int q8_matmul_silu(const void* x, const void* q13, const void* s13, const void* g,
                              void* out, void* xn_ws, void* part_ws, int M, int K, int H, int gs,
                              int split, int kslice, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  if (split > 0) {
    HIPLLAMA_TRY(launch_gemv(xin, q13, s13, (float*)part_ws, M, K, 2 * H, gs, split, kslice, st));
    return launch_split_gate((const float*)part_ws, split, M, H, out, st);
  }
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  return launch_mma<true>(xin, q13, s13, M, K, 2 * H, H, H, gs, none, out, st);
}

// res + W2 bf16(silu(xn W1) * xn W3): q13 (K, 2H), q2 (H, N), res and out
// (M, N). xn_ws (M, K) bf16; part_ws (ceil(H / 64), M, N) fp32 holds the
// strips' partial sums. H % 8 == 0, N % 8 == 0.
extern "C" int q8_matmul_ffn(const void* x, const void* q13, const void* s13, const void* q2,
                             const void* s2, const void* g, const void* res, void* out,
                             void* xn_ws, void* part_ws, int M, int K, int H, int N, int gs13,
                             int gs2, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 8 || N % 8) return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
  const int nstrips = (H + kFfBH - 1) / kFfBH;
  float* part = (float*)part_ws;
  if (M <= 8) {
    q8_ffn_strip_kernel<8><<<dim3(1, nstrips), kThreads, 0, st>>>(
        (const bf16*)xn_ws, (const int8_t*)q13, (const float*)s13, (const int8_t*)q2,
        (const float*)s2, part, M, K, H, N, gs13, gs2);
  } else {
    q8_ffn_strip_kernel<16><<<dim3((M + 15) / 16, nstrips), kThreads, 0, st>>>(
        (const bf16*)xn_ws, (const int8_t*)q13, (const float*)s13, (const int8_t*)q2,
        (const float*)s2, part, M, K, H, N, gs13, gs2);
  }
  HIPLLAMA_TRY(check_launch());
  q8_ffn_reduce_kernel<<<blocks((long long)M * (N / 2)), kEltThreads, 0, st>>>(
      part, nstrips, M, N, (const bf16*)res, (bf16*)out);
  return check_launch();
}
