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
// (q8.cuh::split_epilogue_at, split_gate_at). At prefill M (B*T up to 4088)
// the product does 4M flops per packed byte and is bound by operations on
// the bf16 tensor cores: the tiled path is the Q8 products' pipelined wgmma
// mainloop (q8_wgmma.cuh's q8_tile_kernel<GATE, 4>, launch_tiles): a
// producer warpgroup copies x and 32 packed rows of the weight a step into
// a 4-stage ring, and two consumer warpgroups turn the step's low and high
// nibbles into the 64 k rows of one bf16 B tile (rows k0.. and K/2 + k0..,
// with x's columns to match) while the last step's wgmmas m64n128k16 run,
// on 256 x 128 output tiles (the gate: 64 W1 columns beside the same 64 of
// W3, gated in registers). The rmsnorm prologue is a pass of its own that
// writes xn once (M x K bf16, which stays in L2), and RoPE reads each row's
// cos and sin from a table one pass computes (matmul_passes.cuh, with the
// GEMV path's second pass). The nibbles become floats by one byte permute
// into the mantissa of 2^23, off the conversion unit (q8.cuh::nib_to_f).
//
// q4_matmul_a8 and q4_matmul_silu_a8 are the `a8` (w4a8) branches of the
// two (a8.cuh; quant4.py:139-171, :218-232): the activations quantized per
// (row, group of gs) by one pass with the rmsnorm fused, each nibble plane's
// codes (nibble - 8, exact in int8) in int8 x int8 dots with its half of x,
// int32 sums per group, the fp32 rescale per group, the same epilogues.
// Above 16 rows at group sizes that are multiples of 32 they run
// a8_wgmma.cuh's int8 wgmma tiles (a8_plane_kernel: one nibble plane a CTA,
// its fp32 sum into a workspace, then the split pass that adds the two
// planes and runs the epilogue or gate), elsewhere a8.cuh's mma.sync tiles;
// q4_a8_tiles_probe runs either on the same input.

#include <stdint.h>

#include "a8.cuh"
#include "a8_wgmma.cuh"
#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"
#include "q8_wgmma.cuh"

namespace {

using namespace hipllama::q8;

constexpr int kQ4KMax = 512;              // packed rows per GEMV task at most
constexpr int kQ4BN = 32 * 8;             // columns per GEMV task: 8 per lane

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
      const float xf = hipllama::to_f(xe[mm]);
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
// dequantization (q8.cuh's nib_to_f: exact, off the conversion unit)

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
// of kQ4BN columns and one slice of at most kQ4KMax packed rows; its fp32
// partial sums go to part[(split * M + m) * N + n].

template <int MAXM>
struct Q4GemvSmem {
  __align__(16) bf16 xlo[kQ4KMax][MAXM];  // x[:, k'] of the slice, transposed
  __align__(16) bf16 xhi[kQ4KMax][MAXM];  // x[:, K/2 + k']
  float red[kWarps][kQ4BN];
};

template <int MAXM>
__global__ void __launch_bounds__(kThreads) q4_gemv_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int gs, int kslice) {
  __shared__ Q4GemvSmem<MAXM> sm;
  constexpr int R = MAXM <= 8 ? 8 : 4;  // packed rows a warp has in flight
  const int KH = K / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kQ4BN;
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
// launchers

int launch_gemv(const void* x, const void* q, const void* s, float* part, int M, int K, int N,
                int gs, int split, int kslice, cudaStream_t st) {
  const int KH = K / 2;
  if (M > 16 || kslice > kQ4KMax || (long long)split * kslice < KH ||
      (long long)(split - 1) * kslice >= KH)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kQ4BN - 1) / kQ4BN, split);
  if (M <= 8)
    q4_gemv_kernel<8><<<grid, kThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                 (const float*)s, part, M, K, N, gs, kslice);
  else
    q4_gemv_kernel<16><<<grid, kThreads, 0, st>>>((const bf16*)x, (const int8_t*)q,
                                                  (const float*)s, part, M, K, N, gs, kslice);
  return check_launch();
}

// the shapes both entry points take
bool bad_shape(int K, int gs) { return K % 32 || gs <= 0 || (K / 2) % gs; }

// The `a8` tiles on the quantized rows xi_ws, sx_ws of x (M, K) and the
// packed weight (q (K/2, N), s): wgmma, a8_wgmma.cuh's int8 wgmma tiles, one
// nibble plane a CTA into part_ws (2, M, N) fp32, then the split pass that
// adds the low plane's sum and the high plane's through the epilogue e (the
// gate: its pass, out (M, N/2)); else a8.cuh's mma.sync tiles, both planes
// a CTA, the epilogue in their store. The two round alike: the same int32
// group sums and fp32 rescales in group order, each plane's sum from zero,
// lo + hi, one epilogue (q8.cuh::split_pair_sum at split 1).
int launch_a8_tiles_int4(bool wgmma, bool gate, const void* xi_ws, const void* sx_ws,
                         const void* q, const void* s, int M, int K, int N, int gs,
                         const Epilogue& e, void* out, void* part_ws, cudaStream_t st) {
  const int ncols = gate ? N / 2 : N, off2 = gate ? N / 2 : 0;
  if (!wgmma)
    return gate ? hipllama::a8::launch_mma<true, true>(xi_ws, sx_ws, q, s, M, K, N, ncols, off2,
                                                       gs, e, out, st)
                : hipllama::a8::launch_mma<false, true>(xi_ws, sx_ws, q, s, M, K, N, ncols,
                                                        off2, gs, e, out, st);
  if (part_ws == nullptr) return (int)cudaErrorInvalidValue;
  const float* part = (const float*)part_ws;
  const int rc = gate ? launch_a8_tiles<true, 4>(xi_ws, sx_ws, q, s, M, K, N, ncols, off2, gs,
                                                 e, part_ws, st)
                      : launch_a8_tiles<false, 4>(xi_ws, sx_ws, q, s, M, K, N, ncols, off2, gs,
                                                  e, part_ws, st);
  if (rc != 0) return rc;
  return gate ? launch_split_gate(part, 1, M, ncols, out, st, 2)
              : launch_split_epilogue(part, 1, M, N, e, out, st, 2);
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// All activations bf16, q int8 (K/2, N) packed, s and g fp32, pos int32.
// g, res and pos may be null (no norm, no residual, no RoPE). xn_ws: (M, K)
// bf16 workspace, used when g is given. split > 0 takes the GEMV path
// (M <= 16) with part_ws (split, M, N) fp32 and kslice packed rows per
// split; split == 0 the tiled path, with part_ws (M, rope_hs) fp32 for the
// RoPE table where pos is given. K % 32 == 0, (K/2) % gs == 0, N % 16 == 0.
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
  Epilogue et = e;
  if (pos != nullptr) {  // the tiles read each row's cos and sin from part_ws
    if (part_ws == nullptr || rope_hs < 2 || rope_hs % 2) return (int)cudaErrorInvalidValue;
    HIPLLAMA_TRY(launch_rope_table(pos, M, rope_hs, rope_coef, (float*)part_ws, st));
    et.rope_cs = (const float*)part_ws;
  }
  return launch_tiles<false, 4>(xin, q, s, M, K, N, N, 0, gs, et, out, st);
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
  return launch_tiles<true, 4>(xin, q13, s13, M, K, 2 * H, H, H, gs, none, out, st);
}

// The `a8` mode of q4_matmul (a8.cuh): xi_ws (M, K) int8 and sx_ws (M, K/gs)
// fp32 workspaces take the quantized activations (normed by g where g is
// given); split > 0 takes the GEMV path (M <= 16) with part_ws (2 x split,
// M, N) fp32 (the low then the high nibble plane's splits) and kslice
// packed rows per split (a multiple of gs, at most 512); split == 0 the
// tiles: the int8 wgmma tiles where gs % 32 == 0, with part_ws (2, M, N)
// fp32 for the nibble planes' sums, else the mma.sync tiles. gs is any
// multiple of 8 (that divides K/2); otherwise as q4_matmul.
extern "C" int q4_matmul_a8(const void* x, const void* q, const void* s, const void* g,
                            const void* res, const void* pos, void* out, void* xi_ws,
                            void* sx_ws, void* part_ws, int M, int K, int N, int gs, int split,
                            int kslice, int rope_limit, int rope_hs, float rope_coef, float eps,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  if ((K / 2) % gs || K % 2) return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  if (split > 0) {
    HIPLLAMA_TRY(hipllama::a8::launch_gemv<true>(xi_ws, sx_ws, q, s, (float*)part_ws, M, K, N,
                                                 gs, split, kslice, st));
    return launch_split_epilogue((const float*)part_ws, split, M, N, e, out, st, 2);
  }
  return launch_a8_tiles_int4(gs % 32 == 0, false, xi_ws, sx_ws, q, s, M, K, N, gs, e, out,
                              part_ws, st);
}

// The `a8` mode of q4_matmul_silu: W1 and W3 share one quantized x.
// Workspaces as q4_matmul_a8, part_ws (2 x split, M, 2H) (the wgmma tiles:
// (2, M, 2H)).
extern "C" int q4_matmul_silu_a8(const void* x, const void* q13, const void* s13,
                                 const void* g, void* out, void* xi_ws, void* sx_ws,
                                 void* part_ws, int M, int K, int H, int gs, int split,
                                 int kslice, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((K / 2) % gs || K % 2) return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  if (split > 0) {
    HIPLLAMA_TRY(hipllama::a8::launch_gemv<true>(xi_ws, sx_ws, q13, s13, (float*)part_ws, M, K,
                                                 2 * H, gs, split, kslice, st));
    return launch_split_gate((const float*)part_ws, split, M, H, out, st, 2);
  }
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  return launch_a8_tiles_int4(gs % 32 == 0, true, xi_ws, sx_ws, q13, s13, M, K, 2 * H, gs, none,
                              out, part_ws, st);
}

// The `a8` product of q4_matmul_a8 (gate: q4_matmul_silu_a8, q (K/2, N =
// 2H), out (M, H)) above 16 rows with its tile kernel chosen: variant 0 the
// int8 wgmma tiles (part_ws (2, M, N)), 1 a8.cuh's mma.sync tiles, after
// the same quantizer pass; arguments otherwise as q4_matmul_a8's. For
// comparing the two tile kernels' outputs bit for bit.
extern "C" int q4_a8_tiles_probe(const void* x, const void* q, const void* s, const void* g,
                                 const void* res, const void* pos, void* out, void* xi_ws,
                                 void* sx_ws, void* part_ws, int M, int K, int N, int gs,
                                 int gate, int variant, int rope_limit, int rope_hs,
                                 float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  if (variant < 0 || variant > 1 || (K / 2) % gs || K % 2 || (gate && (res || pos)))
    return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  return launch_a8_tiles_int4(variant == 0, gate != 0, xi_ws, sx_ws, q, s, M, K, N, gs, e, out,
                              part_ws, st);
}
