// The two prefill variants of the Q8_0 products that the JAX package runs
// behind knobs, in K15's reshape arithmetic (q8.cuh): w = bf16(f32(q) * s),
// bf16 x bf16 products summed in fp32, the epilogue on the fp32 sum, one
// cast.
//
// q8_matmul_minner replaces hip_llama_tpu/ops/quant.py::_q8_matmul_minner
// (K19, _q8_kernel_minner, HIPLLAMA_PREFILL_MINNER=1) and
// q8_matmul_silu_minner its gate twin inside q8_matmul_silu
// (_q8_kernel_silu_minner). The TPU kernel puts M innermost: each (n, k)
// weight tile is dequantized once into scratch and every row block sweeps
// through it, with a full-height fp32 accumulator in 4-12 MiB of VMEM. An SM
// has 227 KB of shared memory, so here each CTA owns a strip of 128 columns
// (a gate strip: 64 of W1 and the same 64 of W3) and a run of whole K tiles
// of 256 rows. For each tile it dequantizes the tile once into shared
// memory (bf16, 68 KB), then sweeps every 128-row block of x through it on
// the tensor cores (nvcuda::wmma, fp32 fragments), loading the block's
// running sums from an fp32 workspace that only this CTA touches and
// storing them back (the first tile of the run starts from zero). A pass
// after it adds the runs of each strip in order and applies the residual
// or RoPE epilogue (or the gate) and the one cast. No atomics: the sums
// are taken in a fixed order. The runs exist to fill the card: wo's 32
// strips alone would keep 32 of 132 SMs busy; each tile still belongs to
// one CTA, so each weight element is dequantized once per call, whatever
// M is. The norm prologue, where given, is a pass of its own first, as
// where the JAX call takes K19 (the norm has moved outside its kernel).
//
// Bounds on an H100: at prefill M (2048) the product does 2M flops per
// weight byte, far above the ~295 flop/byte ridge, so it is bound by
// operations (bf16 tensor cores). Beside the product this design moves
// the running sums: (K / 256) x M x N x 8 bytes, mostly through L2. A fast
// version would keep the sums in registers (wgmma over a resident tile
// ring, or a cluster sharing one dequantized tile through distributed
// shared memory).
//
// q8_matmul_xheads replaces hip_llama_tpu/ops/quant.py::q8_matmul_xheads
// (K16, the x_heads_hs branch of _q8_kernel, HIPLLAMA_PREFILL_XHEADS=1): wo
// over the attention output read in place as (M, GH, HS) through its row
// and head strides. Bound by operations at prefill M (2 x 2048 x 4096 x
// 4096 flops for the 7B wo), which only wgmma reaches: it runs
// q8_wgmma.cuh's pipelined mainloop on 128 x 128 tiles (a producer
// warpgroup copies x and the int8 weight by cp.async into a 6-stage ring;
// two consumer warpgroups each run wgmma m64n128k16 on 64 rows and
// dequantize the next step's weight tile, once per CTA, while the products
// run). Each consumer keeps two fp32 accumulators: the head's, overwritten
// by the head's first k16 product (scale-d 0) and fed the head's HS / 16
// k16 products, then added to the running sum in head order, as the TPU
// kernel adds each head's dot (quant.py:371-380); then q8.cuh's residual
// epilogue and one cast. The head's accumulator is read at its last step,
// so the products drain there only.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"
#include "q8_wgmma.cuh"

namespace {

using namespace hipllama::q8;
namespace wmma = nvcuda::wmma;

constexpr int kMiThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kMiBM = 128;       // rows per sweep block
constexpr int kMiBN = 128;       // tile columns per strip
constexpr int kMiBK = 256;       // weight rows per tile
constexpr int kMiXK = 64;        // x columns staged per step
constexpr int kMiLdb = kMiBN + 8;  // padded rows (multiples of 8 bf16, 32-byte aligned tiles)
constexpr int kMiLda = kMiXK + 8;

struct MinnerSmem {
  bf16 w[kMiBK][kMiLdb];           // the dequantized tile
  bf16 x[kMiBM][kMiLda];           // a 64-column step of a row block
};

// tile column of fragment j (0..3) of warp column wn: four 16-column
// fragments side by side, or for the gate two of W1 (tile columns 0..63)
// and the same two of W3 (64..127)
template <bool GATE>
__device__ __forceinline__ int frag_col(int wn, int j) {
  return GATE ? (j >> 1) * (kMiBN / 2) + wn * 32 + (j & 1) * 16 : wn * 64 + j * 16;
}

// GATE: q is W1|W3 (K, ldq = 2H), ncols = H, strip columns c0..c0+63 of W1
// and H + c0.. of W3; else q (K, ldq = ncols), strip columns c0..c0+127.
// ws: (parts, strips, Mp, kMiBN) fp32, Mp = M rounded up to kMiBM.
template <bool GATE>
__global__ void __launch_bounds__(kMiThreads) q8_minner_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    int M, int Mp, int K, int ldq, int ncols, int gs, int tiles_per_part,
    float* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MinnerSmem& sm = *reinterpret_cast<MinnerSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int strip = blockIdx.x, part = blockIdx.y;
  const int c0 = strip * (GATE ? kMiBN / 2 : kMiBN);
  const int n_tiles = (K + kMiBK - 1) / kMiBK;
  const int t_beg = part * tiles_per_part;
  const int t_end = min(n_tiles, t_beg + tiles_per_part);
  float* wsc = ws + ((size_t)part * gridDim.x + strip) * (size_t)Mp * kMiBN;

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kMiBK;
    const int kn = min(kMiBK, K - k0);  // rows of this tile (K % 16 == 0)
    __syncthreads();  // the previous tile's readers of sm.w are done
    // the tile, dequantized once: kn rows of 8 chunks of 16 columns
    for (int i = tid; i < kMiBK * 8; i += kMiThreads) {
      const int r = i >> 3, ch = i & 7;
      int col;
      bool live;
      if (GATE) {
        const int c = c0 + (ch & 3) * 16;
        live = c < ncols;
        col = c + (ch >> 2) * ncols;
      } else {
        col = c0 + ch * 16;
        live = col < ncols;
      }
      uint4 o0 = make_uint4(0u, 0u, 0u, 0u), o1 = o0;
      if (live && r < kn) {
        const int k = k0 + r;
        const uint4 qv = __ldg(reinterpret_cast<const uint4*>(q + (size_t)k * ldq + col));
        const float4* sp = reinterpret_cast<const float4*>(s + (size_t)(k / gs) * ldq + col);
        const uint2 w0 = dequant4(qv.x ^ kBias4, __ldg(sp));
        const uint2 w1 = dequant4(qv.y ^ kBias4, __ldg(sp + 1));
        const uint2 w2 = dequant4(qv.z ^ kBias4, __ldg(sp + 2));
        const uint2 w3 = dequant4(qv.w ^ kBias4, __ldg(sp + 3));
        o0 = make_uint4(w0.x, w0.y, w1.x, w1.y);
        o1 = make_uint4(w2.x, w2.y, w3.x, w3.y);
      }
      uint4* dst = reinterpret_cast<uint4*>(&sm.w[r][ch * 16]);
      dst[0] = o0;
      dst[1] = o1;
    }
    __syncthreads();

    // every row block sweeps through the tile
    for (int mb = 0; mb < Mp; mb += kMiBM) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
      float* wsw = wsc + (size_t)(mb + wm * 32) * kMiBN;  // this warp's 32 rows
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (t == t_beg)
            wmma::fill_fragment(acc[i][j], 0.f);
          else
            wmma::load_matrix_sync(acc[i][j], wsw + i * 16 * kMiBN + frag_col<GATE>(wn, j),
                                   kMiBN, wmma::mem_row_major);
        }
      for (int kx = 0; kx < kn; kx += kMiXK) {
        // rows mb..mb+127 of x, columns k0+kx..+63: two 16-column chunks
        // per thread, zero past M and K
        for (int i = tid; i < kMiBM * (kMiXK / 16); i += kMiThreads) {
          const int r = i >> 2, ch = i & 3;
          const int gm = mb + r, gk = k0 + kx + ch * 16;
          uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
          if (gm < M && gk < K) {
            const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
            v0 = src[0];
            v1 = src[1];
          }
          uint4* dst = reinterpret_cast<uint4*>(&sm.x[r][ch * 16]);
          dst[0] = v0;
          dst[1] = v1;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kMiXK; kk += 16) {
          if (kx + kk < kn) {  // uniform across the CTA
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::load_matrix_sync(af[i], &sm.x[wm * 32 + i * 16][kk], kMiLda);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(bfr, &sm.w[kx + kk][frag_col<GATE>(wn, j)], kMiLdb);
#pragma unroll
              for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(wsw + i * 16 * kMiBN + frag_col<GATE>(wn, j), acc[i][j], kMiBN,
                                  wmma::mem_row_major);
    }
  }
}

// output column pair idx < M * N / 2: the runs of its strip added in
// order, then q8.cuh's epilogue
__global__ void minner_epilogue_kernel(const float* __restrict__ ws, int parts, int strips,
                                       int M, int Mp, int N, Epilogue e, bf16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * (N / 2)) return;
  const int m = idx / (N / 2), n = (idx % (N / 2)) * 2;
  const int strip = n / kMiBN, c = n % kMiBN;
  float a0 = 0.f, a1 = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float2 v = *reinterpret_cast<const float2*>(
        ws + (((size_t)p * strips + strip) * Mp + m) * kMiBN + c);
    a0 += v.x;
    a1 += v.y;
  }
  store_pair(e, m, n, N, a0, a1, out);
}

// gate output idx < M * H: h1 and h3 of its strip's runs added in order
__global__ void minner_gate_kernel(const float* __restrict__ ws, int parts, int strips, int M,
                                   int Mp, int H, bf16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * H) return;
  const int m = idx / H, n = idx % H;
  const int strip = n / (kMiBN / 2), c = n % (kMiBN / 2);
  float h1 = 0.f, h3 = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float* r = ws + (((size_t)p * strips + strip) * Mp + m) * kMiBN;
    h1 += r[c];
    h3 += r[kMiBN / 2 + c];
  }
  out[idx] = __float2bfloat16_rn(silu_gate(h1, h3));
}

template <bool GATE>
int launch_minner(const void* x, const void* q, const void* s, int M, int K, int ldq, int ncols,
                  int gs, int parts, int tiles_per_part, float* ws, cudaStream_t st) {
  const int strip_cols = GATE ? kMiBN / 2 : kMiBN;
  const int strips = (ncols + strip_cols - 1) / strip_cols;
  const int n_tiles = (K + kMiBK - 1) / kMiBK;
  // every run holds at least one tile, and the runs cover K
  if (parts < 1 || tiles_per_part < 1 || (long long)parts * tiles_per_part < n_tiles ||
      (long long)(parts - 1) * tiles_per_part >= n_tiles)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(MinnerSmem);
  HIPLLAMA_TRY((int)cudaFuncSetAttribute(q8_minner_kernel<GATE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const int Mp = (M + kMiBM - 1) / kMiBM * kMiBM;
  q8_minner_kernel<GATE><<<dim3(strips, parts), kMiThreads, smem, st>>>(
      (const bf16*)x, (const int8_t*)q, (const float*)s, M, Mp, K, ldq, ncols, gs,
      tiles_per_part, ws);
  return check_launch();
}

// ---------------------------------------------------------------------------
// K16: q8_wgmma.cuh's mainloop, a head accumulator beside the running sum

__global__ void __launch_bounds__(hipllama::q8wg::kThreads, 1) q8_xheads_kernel(
    const bf16* __restrict__ x3, int sxm, int sxh, const int8_t* __restrict__ q,
    const float* __restrict__ s, int M, int GH, int HS, int N, int gs, Epilogue e,
    bf16* __restrict__ out) {
  namespace wg = hipllama::q8wg;
  extern __shared__ __align__(1024) unsigned char xh_smem[];
  const wg::Ring<1> ring = wg::ring_init<1>(xh_smem);
  const int m0 = blockIdx.y * wg::Tile<1>::kBM, n0 = blockIdx.x * wg::kBN;
  const int role = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int K = GH * HS, n_steps = K / wg::kBK;
  const wg::Weight<wg::kBN> w{q, s, N, n0, N, 0, gs};
  if (role == wg::kConsumers) {
    wg::producer_regs();
    // x (m, k): head k / HS, element k % HS (a step lies in one head)
    auto x_at = [=](int m, int k) {
      return x3 + (size_t)m * sxm + (size_t)(k / HS) * sxh + k % HS;
    };
    wg::produce(ring, x_at, m0, M, K, w, n_steps, t);
  } else {
    wg::consumer_regs();
    float acc[1][64], head[1][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = head[0][i] = 0.f;
    const int per_head = HS / wg::kBK;
    // the head accumulator is read (and so drained) at each head's last step
    wg::consume(
        ring, n_steps, K, w, m0, M, role, t, head, [=](int it) { return it % per_head == 0; },
        [=](int it) { return it % per_head == per_head - 1; },
        [&](int, const float(&h)[1][64]) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[0][i] += h[0][i];
        });
    wg::store_tile(acc, e, m0, n0, M, N, role, t, out);
  }
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// K19: x (M, K) bf16, q (K, N) int8, s (K/gs, N) fp32; g, res and pos may be
// null (no norm, no residual, no RoPE); xn_ws (M, K) bf16 when g is given;
// ws (parts, ceil(N/128), M rounded up to 128, 128) fp32; the K tiles of 256
// rows in `parts` runs of tiles_per_part. K % 16 == 0, N % 16 == 0.
extern "C" int q8_matmul_minner(const void* x, const void* q, const void* s, const void* g,
                                const void* res, const void* pos, void* out, void* xn_ws,
                                void* ws, int M, int K, int N, int gs, int parts,
                                int tiles_per_part, int rope_limit, int rope_hs, float rope_coef,
                                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % 16 || N % 16 || gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  HIPLLAMA_TRY(launch_minner<false>(xin, q, s, M, K, N, N, gs, parts, tiles_per_part,
                                    (float*)ws, st));
  const int Mp = (M + kMiBM - 1) / kMiBM * kMiBM;
  minner_epilogue_kernel<<<blocks((long long)M * (N / 2)), kEltThreads, 0, st>>>(
      (const float*)ws, parts, (N + kMiBN - 1) / kMiBN, M, Mp, N, e, (bf16*)out);
  return check_launch();
}

// K19 silu: q13 (K, 2H); out (M, H); ws (parts, ceil(H/64), M rounded up to
// 128, 128) fp32; otherwise as q8_matmul_minner. H % 16 == 0.
extern "C" int q8_matmul_silu_minner(const void* x, const void* q13, const void* s13,
                                     const void* g, void* out, void* xn_ws, void* ws, int M,
                                     int K, int H, int gs, int parts, int tiles_per_part,
                                     float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % 16 || H % 16 || gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  HIPLLAMA_TRY(launch_minner<true>(xin, q13, s13, M, K, 2 * H, H, gs, parts, tiles_per_part,
                                   (float*)ws, st));
  const int Mp = (M + kMiBM - 1) / kMiBM * kMiBM;
  minner_gate_kernel<<<blocks((long long)M * H), kEltThreads, 0, st>>>(
      (const float*)ws, parts, (H + kMiBN / 2 - 1) / (kMiBN / 2), M, Mp, H, (bf16*)out);
  return check_launch();
}

// K16: x3 bf16 with element (m, h, d) at m * sxm + h * sxh + d (sxm, sxh
// multiples of 8, 16-byte aligned base), q (GH * HS, N) int8, s (GH*HS/gs,
// N) fp32, res (M, N) bf16 or null; out (M, N) bf16. HS % 64 == 0, N % 16
// == 0, any gs that divides GH * HS.
extern "C" int q8_matmul_xheads(const void* x3, const void* q, const void* s, const void* res,
                                void* out, int M, int GH, int HS, int sxm, int sxh, int N,
                                int gs, void* stream) {
  namespace wg = hipllama::q8wg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || GH < 1 || HS % wg::kBK || N % 16 || sxm % 8 || sxh % 8 || gs < 1 ||
      (GH * HS) % gs)
    return (int)cudaErrorInvalidValue;
  const Epilogue e{(const bf16*)res, nullptr, 0, 1, 0.f};
  static const int ready = wg::prepare(q8_xheads_kernel, wg::Tile<1>::kSmemBytes);
  HIPLLAMA_TRY(ready);
  const dim3 grid((N + wg::kBN - 1) / wg::kBN, (M + wg::Tile<1>::kBM - 1) / wg::Tile<1>::kBM);
  q8_xheads_kernel<<<grid, wg::kThreads, wg::Tile<1>::kSmemBytes, st>>>(
      (const bf16*)x3, sxm, sxh, (const int8_t*)q, (const float*)s, M, GH, HS, N, gs, e,
      (bf16*)out);
  return check_launch();
}
