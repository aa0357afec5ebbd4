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
// the traffic. The GEMV path (M <= 16) is the Q8 products' tensor-core GEMV
// with the int4 format (q8.cuh::gemv_tasks<MAXM, FAST, 4>): a step is 8
// packed rows of a 128-column strip, streamed through a cp.async ring a
// warp; its low nibbles are the A operand of one m16n8k8 against x[:, k'..]
// and its high nibbles of another against x[:, K/2 + k'..], each summed
// from zero and added to the fp32 sums in order; gemv_plan's tasks (a strip,
// a slice of the K / 16 steps, a chunk of rows) are dealt out to a grid of
// as many CTAs as fit on the card at once, and a second pass adds the
// slices in a fixed order and applies the epilogue (q8.cuh::
// split_epilogue_at, split_gate_at). At prefill M (B*T up to 4088)
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
// Up to 16 rows they run a8.cuh's GEMV, on the int8 tensor cores at group
// sizes that are multiples of 32 (a8_gemv_tc_kernel<true>: one set of byte
// permutes for both nibble planes) and by dp4a elsewhere, bit for bit
// alike (q4_a8_gemv_probe runs either). Above 16 rows at group sizes that
// are multiples of 32 they run a8_wgmma.cuh's int8 wgmma tiles
// (a8_plane_kernel: one nibble plane a CTA, its fp32 sum into a workspace,
// then the split pass that adds the two planes and runs the epilogue or
// gate), elsewhere a8.cuh's mma.sync tiles; q4_a8_tiles_probe runs either
// on the same input.

#include <stdint.h>

#include "a8.cuh"
#include "a8_wgmma.cuh"
#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"
#include "q8_wgmma.cuh"

namespace {

using namespace hipllama::q8;

// ---------------------------------------------------------------------------
// GEMV path (M <= 16): q8.cuh's tasks with the int4 format, dealt out to a
// grid of at most as many CTAs as fit on the card at once

template <int MAXM, bool FAST>
__global__ void __launch_bounds__(kThreads, MAXM <= 8 ? 2 : 1) q4_gemv_tc_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int gs, int split) {
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  gemv_tasks<MAXM, FAST, 4>(*reinterpret_cast<GemvSmem<MAXM, 4>*>(gemv_smem), x, q, s, part, M,
                            K, N, gs, split);
}

template <int MAXM, bool FAST>
int launch_gemv_kernel(const void* x, const void* q, const void* s, float* part, int M, int K,
                       int N, int gs, int split, cudaStream_t st) {
  auto kernel = q4_gemv_tc_kernel<MAXM, FAST>;
  constexpr int bytes = sizeof(GemvSmem<MAXM, 4>);
  static int ctas = 0;  // CTAs that fit on the card at once
  if (ctas == 0) HIPLLAMA_TRY((int)resident_ctas(kernel, bytes, ctas));
  const int tasks = (N + kGemvBN - 1) / kGemvBN * split;
  kernel<<<tasks < ctas ? tasks : ctas, kThreads, bytes, st>>>(
      (const bf16*)x, (const int8_t*)q, (const float*)s, part, M, K, N, gs, split);
  return check_launch();
}

// the split-K partials part (split, M, N) of x @ dequant(q, s) for at most
// 16 rows: split slices of the K / 16 steps of 8 packed rows (gemv_plan)
int launch_gemv(const void* x, const void* q, const void* s, float* part, int M, int K, int N,
                int gs, int split, cudaStream_t st) {
  if (M < 1 || M > 16 || K < kGemvStep || K % kGemvStep || N < 16 || N % 16 || gs < 1 ||
      (K / 2) % gs || split < 1 || split > K / kGemvStep)
    return (int)cudaErrorInvalidValue;
  const bool fast = gs % GemvFormat<4>::kRows == 0;
  if (M <= 8)
    return fast ? launch_gemv_kernel<8, true>(x, q, s, part, M, K, N, gs, split, st)
                : launch_gemv_kernel<8, false>(x, q, s, part, M, K, N, gs, split, st);
  return fast ? launch_gemv_kernel<16, true>(x, q, s, part, M, K, N, gs, split, st)
              : launch_gemv_kernel<16, false>(x, q, s, part, M, K, N, gs, split, st);
}

// the shapes both entry points take
bool bad_shape(int K, int gs) { return K % 32 || gs <= 0 || (K / 2) % gs; }

// The `a8` GEMV path on the quantized rows xi, sx and the packed weight (q
// (K/2, N), s): each nibble plane's split-K partials into part (2 x split,
// M, N) on the int8 tensor cores (tc: a8.cuh's a8_gemv_tc_kernel, gs % 32
// == 0) or by dp4a (a8_gemv_kernel), then the split pass that adds each
// plane's splits, then the planes, through the epilogue e, or (gate) the
// gate into out (M, N / 2).
int a8_gemv_path(bool tc, bool gate, const void* xi, const void* sx, const void* q, const void* s,
                 float* part, int M, int K, int N, int gs, int split, int kslice,
                 const Epilogue& e, void* out, cudaStream_t st) {
  HIPLLAMA_TRY(hipllama::a8::launch_gemv_any<true>(tc, xi, sx, q, s, part, M, K, N, gs, split,
                                                   kslice, st));
  return gate ? launch_split_gate(part, split, M, N / 2, out, st, 2)
              : launch_split_epilogue(part, split, M, N, e, out, st, 2);
}

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
// (M <= 16) with part_ws (split, M, N) fp32, split slices of the K / 16
// steps (gemv_plan); split == 0 the tiled path, with part_ws (M, rope_hs)
// fp32 for the RoPE table where pos is given. K % 32 == 0, (K/2) % gs == 0,
// N % 16 == 0.
extern "C" int q4_matmul(const void* x, const void* q, const void* s, const void* g,
                         const void* res, const void* pos, void* out, void* xn_ws, void* part_ws,
                         int M, int K, int N, int gs, int split, int rope_limit, int rope_hs,
                         float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(K, gs) || N % 16) return (int)cudaErrorInvalidValue;
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  if (split > 0) {
    HIPLLAMA_TRY(launch_gemv(xin, q, s, (float*)part_ws, M, K, N, gs, split, st));
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
                              int split, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(K, gs) || H % 16) return (int)cudaErrorInvalidValue;
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  if (split > 0) {
    HIPLLAMA_TRY(launch_gemv(xin, q13, s13, (float*)part_ws, M, K, 2 * H, gs, split, st));
    return launch_split_gate((const float*)part_ws, split, M, H, out, st);
  }
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  return launch_tiles<true, 4>(xin, q13, s13, M, K, 2 * H, H, H, gs, none, out, st);
}

// The `a8` mode of q4_matmul (a8.cuh): xi_ws (M, K) int8 and sx_ws (M, K/gs)
// fp32 workspaces take the quantized activations (normed by g where g is
// given); split > 0 takes the GEMV path (M <= 16: the int8 tensor cores
// where gs % 32 == 0, else dp4a) with part_ws (2 x split, M, N) fp32 (the
// low then the high nibble plane's splits) and kslice
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
  if (split > 0)
    return a8_gemv_path(gs % 32 == 0, false, xi_ws, sx_ws, q, s, (float*)part_ws, M, K, N, gs,
                        split, kslice, e, out, st);
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
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  if (split > 0)
    return a8_gemv_path(gs % 32 == 0, true, xi_ws, sx_ws, q13, s13, (float*)part_ws, M, K, 2 * H,
                        gs, split, kslice, none, out, st);
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

// The `a8` GEMV path of q4_matmul_a8 (gate: q4_matmul_silu_a8's, q (K/2, N
// = 2H), out (M, H)) with its kernel chosen: variant 0 the int8 tensor
// cores, 1 dp4a, after the same quantizer pass and before the same split
// pass; arguments otherwise as q4_matmul_a8's (split > 0). For comparing
// the two GEMVs' outputs bit for bit.
extern "C" int q4_a8_gemv_probe(const void* x, const void* q, const void* s, const void* g,
                                const void* res, const void* pos, void* out, void* xi_ws,
                                void* sx_ws, void* part_ws, int M, int K, int N, int gs, int split,
                                int kslice, int gate, int variant, int rope_limit, int rope_hs,
                                float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  if (variant < 0 || variant > 1 || gs < 1 || (K / 2) % gs || K % 2 || split < 1 ||
      (gate && (res || pos)))
    return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  return a8_gemv_path(variant == 0, gate != 0, xi_ws, sx_ws, q, s, (float*)part_ws, M, K, N, gs,
                      split, kslice, e, out, st);
}
