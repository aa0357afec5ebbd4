// int4 weight-only matmuls: y = [rmsnorm(x, g)] @ dequant(q, s), with q
// (K/2, N) int8 row-major packed half-split (byte k' holds row k' in its low
// nibble and row K/2 + k' in its high nibble, each as code + 8), s (K/gs, N)
// fp32 (each half holds whole groups: row K/2 + k' takes scale row
// K/(2 gs) + k'/gs), x bf16 activations and bf16 outputs.
//
// q4_matmul replaces hip_llama_tpu/ops/quant4.py::q4_matmul (_q4_kernel and
// its norm / residual / rope variants, `dequant` mode; the head-split
// output is a view of the row-major (M, N) result). q4_matmul_silu replaces
// q4_matmul_silu (_q4_kernel_silu, _q4_kernel_silu_norm): silu(xn W1) *
// (xn W3) from the concatenated W1|W3 (K/2, 2H). Cast points, as in the
// JAX kernels: code = nibble - 8; w = bf16(f32(code) * s); xn =
// bf16(x_f32 * rsqrt(mean(x_f32^2) + eps) * g); products bf16 x bf16 summed
// in fp32; residual, RoPE and the gate on the fp32 sums (q8.cuh's
// epilogues); one cast at the end.
//
// Bounds on an H100: at decode-shaped M (a few rows) every packed weight
// byte (two weights) is used for 4M flops, far below the card's ~295
// flop/byte ridge, so the product is bound by the weight bytes: 0.5 byte a
// weight plus 4/gs for the scales (0.625 at gs 32), the scales a fifth of
// the traffic. The GEMV path (M <= 16) streams the packed weight once: each
// CTA owns 256 columns and a slice of at most 512 packed rows (split K, so
// that even N = 4096 fills the 132 SMs); a lane reads 8 bytes of a packed
// row (8 columns of rows k' and K/2 + k'), turns each nibble plane into 8
// bf16 weights with its group's scales and multiplies them by x[k'] and
// x[K/2 + k'] of every activation row, held transposed in shared memory.
// A second pass adds the slices in a fixed order and applies the epilogue
// (q8.cuh::split_epilogue_at, split_gate_at). At prefill M (B*T up to 2048)
// the product does 4M flops per packed byte and is bound by operations: the
// tiled path dequantizes each packed 32 x 128 tile into two bf16 tiles in
// shared memory (rows k0.. and K/2 + k0..) and runs bf16 tensor-core
// products (nvcuda::wmma, fp32 accumulators) of both halves into one
// accumulator on 128 x 128 output tiles (64 x 128 for the gate, which
// keeps W1 and W3 tiles side by side). The rmsnorm prologue is a pass of
// its own that writes xn once (M x K bf16, which stays in L2;
// matmul_passes.cuh, with the GEMV path's second pass). The nibbles
// become floats by one byte permute into the mantissa of 2^23, off the
// conversion unit; a lop3/prmt conversion straight to bf16 pairs, cp.async
// or TMA staging and wgmma are for later.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::q8;
namespace wmma = nvcuda::wmma;

constexpr int kQ4KMax = 512;              // packed rows per GEMV task at most
constexpr uint32_t kLowNibbles = 0x0F0F0F0Fu;

// ---------------------------------------------------------------------------
// dequantization: byte j of a word of nibbles (each 0..15, code + 8) placed
// in the mantissa of 2^23 by one byte permute, less 2^23 + 8, is f32(code)
// exactly

__device__ __forceinline__ float nib_to_f(uint32_t nib4, int j) {
  return __uint_as_float(__byte_perm(nib4, 0x4B000000u, 0x7540 + j)) - 8388616.f;
}

// four weights (nibbles of one word) times their scales, as two bf16x2 words
__device__ __forceinline__ uint2 dequant4_nib(uint32_t nib4, float4 s) {
  return make_uint2(bf16x2_bits(nib_to_f(nib4, 0) * s.x, nib_to_f(nib4, 1) * s.y),
                    bf16x2_bits(nib_to_f(nib4, 2) * s.z, nib_to_f(nib4, 3) * s.w));
}

// eight bf16 weights of one row (the nibbles of `nib`, scales s0|s1), widened
__device__ __forceinline__ void dequant8_nib(uint2 nib, float4 s0, float4 s1, float w[8]) {
  const uint2 lo = dequant4_nib(nib.x, s0), hi = dequant4_nib(nib.y, s1);
  const uint32_t wp[4] = {lo.x, lo.y, hi.x, hi.y};  // bf16x2 pairs of columns
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = __uint_as_float(wp[j] << 16);
    w[2 * j + 1] = __uint_as_float(wp[j] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint2 low_nibbles(uint2 raw) {
  return make_uint2(raw.x & kLowNibbles, raw.y & kLowNibbles);
}
__device__ __forceinline__ uint2 high_nibbles(uint2 raw) {
  return make_uint2((raw.x >> 4) & kLowNibbles, (raw.y >> 4) & kLowNibbles);
}

// ---------------------------------------------------------------------------
// GEMV path (M <= 16): one (strip, split) task per CTA. A task is one strip
// of kGvBN columns and one slice of at most kQ4KMax packed rows; its fp32
// partial sums go to part[(split * M + m) * N + n].

template <int MAXM>
struct Q4GemvSmem {
  __align__(16) bf16 xlo[kQ4KMax][MAXM];  // x[:, k'] of the slice, transposed
  __align__(16) bf16 xhi[kQ4KMax][MAXM];  // x[:, K/2 + k']
  float red[kWarps][kGvBN];
};

template <int MAXM>
__global__ void __launch_bounds__(kThreads) q4_gemv_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int gs, int kslice) {
  __shared__ Q4GemvSmem<MAXM> sm;
  constexpr int R = MAXM <= 8 ? 8 : 4;  // packed rows a warp has in flight
  const int KH = K / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGvBN;
  const int split = blockIdx.y;
  const int kbeg = split * kslice;
  const int kend = min(KH, kbeg + kslice);
  load_xs<MAXM>(sm.xlo, x, M, 0, K, kbeg, kend);
  load_xs<MAXM>(sm.xhi, x + KH, M, 0, K, kbeg, kend);
  __syncthreads();

  const int n = n0 + lane * 8;
  const bool live = n < N;  // N % 8 == 0: a lane's 8 columns are all in or all out
  const int ghi = KH / gs;  // the high half's first group
  float acc[MAXM][8];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  float4 sl0 = make_float4(0.f, 0.f, 0.f, 0.f), sl1 = sl0, sh0 = sl0, sh1 = sl0;
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
            const float* sl = s + (size_t)grp * N + n;
            const float* sh = s + (size_t)(ghi + grp) * N + n;
            sl0 = __ldg(reinterpret_cast<const float4*>(sl));
            sl1 = __ldg(reinterpret_cast<const float4*>(sl + 4));
            sh0 = __ldg(reinterpret_cast<const float4*>(sh));
            sh1 = __ldg(reinterpret_cast<const float4*>(sh + 4));
          }
        }
        float w[8];
        dequant8_nib(low_nibbles(raw[r]), sl0, sl1, w);
        fma_rows<MAXM>(sm.xlo[k - kbeg], w, acc);
        dequant8_nib(high_nibbles(raw[r]), sh0, sh1, w);
        fma_rows<MAXM>(sm.xhi[k - kbeg], w, acc);
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
      if (n0 + tid < N) part[((size_t)split * M + m) * N + n0 + tid] = v;
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// tiled tensor-core path (M > 16)

constexpr int kMmThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kMmBN = 128;
constexpr int kMmBK = 32;           // packed rows per step: 2 x 32 contraction rows
constexpr int kMmLda = kMmBK + 8;   // padded rows (multiples of 8 bf16, 32-byte aligned tiles)
constexpr int kMmLdb = kMmBN + 8;

// GATE: two packed weight tiles per step, W1 columns n and W3 columns off3 +
// n, and the gate epilogue; else one tile and the q4_matmul epilogue. ldq
// is the row stride of q and s; ncols the output width. Each thread owns
// one 16-column chunk of each x half (the first BM * 2 threads) and one
// 16-byte chunk of each packed tile per step, which it writes to shared
// memory as 16 bf16 weights of row k0 + wr and 16 of row K/2 + k0 + wr. The
// fp32 epilogue scratch reuses the weight tiles' shared memory.
template <bool GATE>
__global__ void __launch_bounds__(kMmThreads) q4_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    int M, int K, int ldq, int ncols, int off3, int gs, Epilogue e, bf16* __restrict__ out) {
  constexpr int BM = GATE ? 64 : 128;
  constexpr int WM = BM / 4;      // rows per warp
  constexpr int FM = WM / 16;     // 16-row fragments per warp
  constexpr int FN = 4;           // 16-column fragments per warp (64 columns)
  constexpr int NB = GATE ? 2 : 1;
  constexpr int kA = BM * kMmLda;    // bf16 of one x half tile
  constexpr int kB = kMmBK * kMmLdb; // bf16 of one weight half tile
  constexpr int kABytes = 2 * kA * 2;
  constexpr int kBBytes = NB * 2 * kB * 2;
  constexpr int kCBytes = (kMmThreads / 32) * NB * 256 * 4;
  static_assert(kMmBK * (kMmBN / 16) == kMmThreads, "one packed chunk per thread and tile");
  static_assert(BM * 2 <= kMmThreads, "at most one chunk of each x half per thread");
  static_assert(kABytes + (kBBytes > kCBytes ? kBBytes : kCBytes) <= 48 * 1024, "static smem");
  __shared__ __align__(32) unsigned char smem[kABytes + (kBBytes > kCBytes ? kBBytes : kCBytes)];
  bf16* a_s = reinterpret_cast<bf16*>(smem);              // [half][BM][kMmLda]
  bf16* b_s = reinterpret_cast<bf16*>(smem + kABytes);    // [t][half][kMmBK][kMmLdb]
  float* c_s = reinterpret_cast<float*>(smem + kABytes);  // [warp][t][16 x 16], after the loop

  const int KH = K / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kMmBN;
  // this thread's chunks: x row xr, packed columns xc..xc+15 of each half;
  // packed weight row wr, columns wc..wc+15 of each tile
  const bool has_x = tid < BM * 2;
  const int xr = tid >> 1, xc = (tid & 1) * 16;
  const int wr = tid >> 3, wc = (tid & 7) * 16;
  const int ghi = KH / gs;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][FM][FN];
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[t][i][j], 0.f);

  for (int k0 = 0; k0 < KH; k0 += kMmBK) {
    if (has_x) {
      const int gm = m0 + xr, gk = k0 + xc;  // KH % 16 == 0: a chunk is all in or all out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
        if (gm < M && gk < KH) {
          const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)gm * K + h * KH + gk);
          v0 = src[0];
          v1 = src[1];
        }
        uint4* dst = reinterpret_cast<uint4*>(a_s + h * kA + xr * kMmLda + xc);
        dst[0] = v0;
        dst[1] = v1;
      }
    }
    const int wk = k0 + wr, gn = n0 + wc;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      uint4 lo0 = make_uint4(0u, 0u, 0u, 0u), lo1 = lo0, hi0 = lo0, hi1 = lo0;
      if (wk < KH && gn < ncols) {
        const int qc = gn + t * off3;
        const uint4 qv = __ldg(reinterpret_cast<const uint4*>(q + (size_t)wk * ldq + qc));
        const float4* sl = reinterpret_cast<const float4*>(s + (size_t)(wk / gs) * ldq + qc);
        const float4* sh =
            reinterpret_cast<const float4*>(s + (size_t)(ghi + wk / gs) * ldq + qc);
        const uint32_t words[4] = {qv.x, qv.y, qv.z, qv.w};
        uint2 wl[4], wh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wl[j] = dequant4_nib(words[j] & kLowNibbles, __ldg(sl + j));
          wh[j] = dequant4_nib((words[j] >> 4) & kLowNibbles, __ldg(sh + j));
        }
        lo0 = make_uint4(wl[0].x, wl[0].y, wl[1].x, wl[1].y);
        lo1 = make_uint4(wl[2].x, wl[2].y, wl[3].x, wl[3].y);
        hi0 = make_uint4(wh[0].x, wh[0].y, wh[1].x, wh[1].y);
        hi1 = make_uint4(wh[2].x, wh[2].y, wh[3].x, wh[3].y);
      }
      uint4* dlo = reinterpret_cast<uint4*>(b_s + (t * 2 + 0) * kB + wr * kMmLdb + wc);
      uint4* dhi = reinterpret_cast<uint4*>(b_s + (t * 2 + 1) * kB + wr * kMmLdb + wc);
      dlo[0] = lo0;
      dlo[1] = lo1;
      dhi[0] = hi0;
      dhi[1] = hi1;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < kMmBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(af[i], a_s + h * kA + (wm * WM + i * 16) * kMmLda + kk, kMmLda);
#pragma unroll
        for (int t = 0; t < NB; ++t) {
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, b_s + (t * 2 + h) * kB + kk * kMmLdb + wn * 64 + j * 16,
                                   kMmLdb);
#pragma unroll
            for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[t][i][j], af[i], bfr, acc[t][i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue, one 16 x 16 fragment at a time through the warp's scratch:
  // lane -> row lane / 2, columns (lane % 2) * 8 .. + 7
  float* cs1 = c_s + (warp * NB + 0) * 256;
  float* cs3 = c_s + (warp * NB + NB - 1) * 256;
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
  const int KH = K / 2;
  if (M > 16 || kslice > kQ4KMax || (long long)split * kslice < KH ||
      (long long)(split - 1) * kslice >= KH)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kGvBN - 1) / kGvBN, split);
  if (M <= 8)
    q4_gemv_kernel<8><<<grid, kThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                 (const float*)s, part, M, K, N, gs, kslice);
  else
    q4_gemv_kernel<16><<<grid, kThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                  (const float*)s, part, M, K, N, gs, kslice);
  return check_launch();
}

template <bool GATE>
int launch_mma(const void* x, const void* q, const void* s, int M, int K, int ldq, int ncols,
               int off3, int gs, const Epilogue& e, void* out, cudaStream_t st) {
  constexpr int BM = GATE ? 64 : 128;
  const dim3 grid((ncols + kMmBN - 1) / kMmBN, (M + BM - 1) / BM);
  q4_mma_kernel<GATE><<<grid, kMmThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                   (const float*)s, M, K, ldq, ncols, off3, gs, e,
                                                   (bf16*)out);
  return check_launch();
}

// the shapes both entry points take
bool bad_shape(int K, int gs) { return K % 32 || gs <= 0 || (K / 2) % gs; }

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// All activations bf16, q int8 (K/2, N) packed, s and g fp32, pos int32.
// g, res and pos may be null (no norm, no residual, no RoPE). xn_ws: (M, K)
// bf16 workspace, used when g is given. split > 0 takes the GEMV path
// (M <= 16) with part_ws (split, M, N) fp32 and kslice packed rows per
// split; split == 0 the tiled path. K % 32 == 0, (K/2) % gs == 0,
// N % 16 == 0.
extern "C" int q4_matmul(const void* x, const void* q, const void* s, const void* g,
                         const void* res, const void* pos, void* out, void* xn_ws, void* part_ws,
                         int M, int K, int N, int gs, int split, int kslice, int rope_limit,
                         int rope_hs, float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(K, gs) || N % 16) return (int)cudaErrorInvalidValue;
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

// silu(xn W1) * (xn W3) with q13 (K/2, 2H) packed; out (M, H). Workspaces
// as above, part_ws (split, M, 2H). H % 16 == 0.
extern "C" int q4_matmul_silu(const void* x, const void* q13, const void* s13, const void* g,
                              void* out, void* xn_ws, void* part_ws, int M, int K, int H, int gs,
                              int split, int kslice, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(K, gs) || H % 16) return (int)cudaErrorInvalidValue;
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
