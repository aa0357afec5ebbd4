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
// the scales). The GEMV path (M <= 16) streams the weight once on the bf16
// tensor cores (q8.cuh::gemv_tasks: mma.sync.m16n8k16 with the dequantized
// weight as the 16-column A operand and the rows as the n side, each warp
// fed by a cp.async ring of its own): gemv_plan's tasks of 128 columns and
// a slice of K (split K, so that even N = 4096 fills the 132 SMs) dealt
// out to a grid of as many CTAs as fit on the card at once, then a second
// pass adds the slices in a fixed order and applies the epilogue. At
// prefill M (B*T up to 4088) the product does 2M flops per weight byte and
// is bound by operations on the bf16 tensor cores: the tiled path
// (q8_wgmma.cuh's q8_tile_kernel) runs its pipelined mainloop, a producer
// warpgroup copying x and the int8 weight into a 4-stage ring and two
// consumer warpgroups issuing wgmma m64n128k16 on 256 x 128 tiles (128
// rows each; the gate: 64 W1 columns beside the same 64 of W3, gated in
// registers) while they dequantize the next step's weight once per CTA;
// the wgmmas of a step stay in flight across the consumers' barrier. The
// rmsnorm prologue is a pass of its own that writes xn once (M x K bf16,
// which stays in L2), and RoPE reads each row's cos and sin from a table
// one pass computes (matmul_passes.cuh, with the GEMV path's second pass).
//
// q8_matmul_ffn up to 16 rows is the GEMV path twice: the W1|W3 product
// into split-K partials, the gate pass that adds them in order and writes
// hb = bf16(silu(h1) * h3) (M x H bf16, which stays in L2), the W2 product
// of hb, and the epilogue pass that adds its slices in order to the
// residual. h1 and h3 are fp32 sums and hb rounds once, as in the TPU
// kernel; the slices' partials are 2.1 MB and 1.0 MB at 7B and M 8.
//
// q8_matmul_layered replaces hip_llama_tpu/ops/quant.py::q8_matmul_layered
// (K20, _q8_kernel_layered and its norm / res / rope wrappers): q8_matmul
// on layer `layer` of a stacked weight q (L, K, N), s (L, K/gs, N) with a
// stacked norm weight g (L, K). The TPU kernel takes the layer as a
// scalar-prefetched index that its BlockSpecs map to the layer's tiles; the
// decode loop here runs on the host, which knows the layer, so the entry
// point takes it as an int and addresses layer l at l*K*N, l*(K/gs)*N and
// l*K of the stacked base pointers before it runs q8_matmul's kernels. No
// layer is copied, and the bound and design are q8_matmul's.
// q8_matmul_layered_a8 is its `a8` branch, through q8_matmul_a8's kernels;
// the wrapper decides which runs by K20's rule, not K15's.
//
// q8_matmul_a8 and q8_matmul_silu_a8 are the `a8` branches of the first two
// (a8.cuh): the activations quantized per (row, group) by one pass with the
// rmsnorm fused, int8 x int8 dots with int32 sums per group, the fp32
// rescale per group, then the same epilogues. Up to 16 rows a group size
// that is a multiple of 32 takes a8.cuh's GEMV on the int8 tensor cores
// (a8_gemv_tc_kernel), others its dp4a GEMV, bit for bit alike
// (q8_a8_gemv_probe runs either). Above 16 rows a group size that is a
// multiple of 32 takes a8_wgmma.cuh's int8 wgmma tiles (a pipelined ring,
// the weight transposed on chip, two int32 sum sets a consumer so that a
// group's rescale runs beside the next group's products); other group
// sizes take a8.cuh's mma.sync tiles, which round alike. q8_matmul_ffn
// has none: the JAX kernel keeps its reshape math in every mode
// (quant.py:967-971).

#include <stdint.h>

#include "a8.cuh"
#include "a8_wgmma.cuh"
#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"
#include "q8_wgmma.cuh"

namespace {

using namespace hipllama::q8;
using hipllama::to_f;
using hipllama::warp_sum;
namespace wg = hipllama::q8wg;

// ---------------------------------------------------------------------------
// GEMV path (M <= 16): q8.cuh's tasks dealt out to a grid of at most as
// many CTAs as fit on the card at once

template <int MAXM, bool FAST>
__global__ void __launch_bounds__(kThreads, MAXM <= 8 ? 2 : 1) q8_gemv_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int gs, int split) {
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  gemv_tasks<MAXM, FAST>(*reinterpret_cast<GemvSmem<MAXM>*>(gemv_smem), x, q, s, part, M, K, N,
                         gs, split);
}

// ---------------------------------------------------------------------------
// tiled path (M > 16): q8_wgmma.cuh's q8_tile_kernel and launch_tiles on
// its pipelined mainloop

// The mainloop's products alone, for timing its schedule: every CTA runs
// n_steps steps of the consumers' wgmmas (128 x 128 tiles) on ring tiles
// filled once (no copy, no dequantization, the producer idle), waiting
// after each step's issue for all but kInFlight of its groups before the
// consumers' barrier: 0 is the schedule before the pipelining, 1 the
// mainloop's. out: one sum per consumer thread, so that nothing is dead.
template <int kInFlight>
__global__ void __launch_bounds__(wg::kThreads, 1) wgmma_probe_kernel(float* __restrict__ out,
                                                                     int n_steps) {
  using T = wg::Tile<1>;
  extern __shared__ __align__(1024) unsigned char probe_smem[];
  const wg::Ring<1> ring = wg::ring_init<1>(probe_smem);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(ring.smem);  // the x tiles, then the B tiles
  for (int i = threadIdx.x; i < (T::kStages * T::kXBytes + wg::kBTiles * wg::kBTileBytes) / 4;
       i += blockDim.x) {
    const float v = (float)((i * 2654435761u) >> 24) * (1.f / 256.f) - 0.5f;
    tiles[i] = bf16x2_bits(v, -v);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int role = threadIdx.x >> 7;
  if (role == wg::kConsumers) return;
  float d[1][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[0][i] = 0.f;
  for (int it = 0; it < n_steps; ++it) {
    wg::wgmma_step(d, ring.x(it % T::kStages) + role * 64 * 128, ring.b(it % wg::kBTiles),
                   false, true);
    wg::wg_wait<kInFlight>();
    wg::consumers_sync();
  }
  wg::wg_wait<0>();
  wg::wg_fence_regs(d[0]);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += d[0][i];
  out[(size_t)blockIdx.x * 256 + threadIdx.x] = sum;
}

// ---------------------------------------------------------------------------
// launchers

template <int MAXM, bool FAST>
int launch_gemv_kernel(const void* x, const void* q, const void* s, float* part, int M, int K,
                       int N, int gs, int split, cudaStream_t st) {
  auto kernel = q8_gemv_kernel<MAXM, FAST>;
  constexpr int bytes = sizeof(GemvSmem<MAXM>);
  static int ctas = 0;  // CTAs that fit on the card at once
  if (ctas == 0) HIPLLAMA_TRY((int)resident_ctas(kernel, bytes, ctas));
  const int tasks = (N + kGemvBN - 1) / kGemvBN * split;
  kernel<<<tasks < ctas ? tasks : ctas, kThreads, bytes, st>>>(
      (const bf16*)x, (const int8_t*)q, (const float*)s, part, M, K, N, gs, split);
  return check_launch();
}

// the split-K partials part (split, M, N) of x @ dequant(q, s) for at most
// 16 rows: split slices of the K / 16 steps (gemv_plan)
int launch_gemv(const void* x, const void* q, const void* s, float* part, int M, int K, int N,
                int gs, int split, cudaStream_t st) {
  if (M < 1 || M > 16 || K < kGemvStep || K % kGemvStep || N < 16 || N % 16 || gs < 1 ||
      K % gs || split < 1 || split > K / kGemvStep)
    return (int)cudaErrorInvalidValue;
  const bool fast = gs % kGemvStep == 0;
  if (M <= 8)
    return fast ? launch_gemv_kernel<8, true>(x, q, s, part, M, K, N, gs, split, st)
                : launch_gemv_kernel<8, false>(x, q, s, part, M, K, N, gs, split, st);
  return fast ? launch_gemv_kernel<16, true>(x, q, s, part, M, K, N, gs, split, st)
              : launch_gemv_kernel<16, false>(x, q, s, part, M, K, N, gs, split, st);
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING


// All activations bf16, q int8, s and g fp32, pos int32. g, res and pos may be
// null (no norm, no residual, no RoPE). xn_ws: (M, K) bf16 workspace, used
// when g is given. split > 0 takes the GEMV path (M <= 16) with part_ws
// (split, M, N) fp32, split slices of the contraction (gemv_plan); split
// == 0 the tiled path, with part_ws (M, rope_hs) fp32 for the RoPE table
// where pos is given. K % 16 == 0, N % 16 == 0.
extern "C" int q8_matmul(const void* x, const void* q, const void* s, const void* g,
                         const void* res, const void* pos, void* out, void* xn_ws, void* part_ws,
                         int M, int K, int N, int gs, int split, int rope_limit, int rope_hs,
                         float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  return launch_tiles<false>(xin, q, s, M, K, N, N, 0, gs, et, out, st);
}

// silu(xn W1) * (xn W3) with q13 (K, 2H); out (M, H). Workspaces as above,
// part_ws (split, M, 2H).
extern "C" int q8_matmul_silu(const void* x, const void* q13, const void* s13, const void* g,
                              void* out, void* xn_ws, void* part_ws, int M, int K, int H, int gs,
                              int split, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  return launch_tiles<true>(xin, q13, s13, M, K, 2 * H, H, H, gs, none, out, st);
}

// The mainloop's products alone (wgmma_probe_kernel): ctas CTAs of n_steps
// 64-deep steps of a 128 x 128 tile, in_flight 0 (each step drained before
// the consumers' barrier) or 1 (the mainloop's schedule); out (ctas, 256)
// fp32.
extern "C" int wgmma_mainloop_probe(void* out, int ctas, int n_steps, int in_flight,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctas < 1 || n_steps < 1 || (in_flight != 0 && in_flight != 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = in_flight ? wgmma_probe_kernel<1> : wgmma_probe_kernel<0>;
  HIPLLAMA_TRY((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::Tile<1>::kSmemBytes));
  kernel<<<ctas, wg::kThreads, wg::Tile<1>::kSmemBytes, st>>>((float*)out, n_steps);
  return check_launch();
}

// res + W2 bf16(silu(xn W1) * xn W3) for at most 16 rows: q13 (K, 2H), q2
// (H, N), res and out (M, N). xn_ws (M, K) and hb_ws (M, H) bf16; part_ws
// fp32 of max(split13 * M * 2H, split2 * M * N) values holds the split-K
// partials of the W1|W3 product (split13 slices of K) and then of the W2
// product (split2 slices of H). H % 16 == 0, N % 16 == 0.
extern "C" int q8_matmul_ffn(const void* x, const void* q13, const void* s13, const void* q2,
                             const void* s2, const void* g, const void* res, void* out,
                             void* xn_ws, void* hb_ws, void* part_ws, int M, int K, int H, int N,
                             int gs13, int gs2, int split13, int split2, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 16 || N % 16) return (int)cudaErrorInvalidValue;
  float* part = (float*)part_ws;
  HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
  HIPLLAMA_TRY(launch_gemv(xn_ws, q13, s13, part, M, K, 2 * H, gs13, split13, st));
  HIPLLAMA_TRY(launch_split_gate(part, split13, M, H, hb_ws, st));
  HIPLLAMA_TRY(launch_gemv(hb_ws, q2, s2, part, M, H, N, gs2, split2, st));
  const Epilogue resid{(const bf16*)res, nullptr, 0, 1, 0.f};
  return launch_split_epilogue(part, split2, M, N, resid, out, st);
}

namespace {
// The `a8` GEMV path on the quantized rows xi, sx: the split-K partials
// part (split, M, N) on the int8 tensor cores (tc: a8.cuh's
// a8_gemv_tc_kernel, gs % 32 == 0) or by dp4a (a8_gemv_kernel), then the
// split pass through the epilogue e, or (gate) the gate into out (M, N / 2).
int a8_gemv_path(bool tc, bool gate, const void* xi, const void* sx, const void* q, const void* s,
                 float* part, int M, int K, int N, int gs, int split, int kslice,
                 const Epilogue& e, void* out, cudaStream_t st) {
  HIPLLAMA_TRY(hipllama::a8::launch_gemv_any<false>(tc, xi, sx, q, s, part, M, K, N, gs, split,
                                                    kslice, st));
  return gate ? launch_split_gate(part, split, M, N / 2, out, st)
              : launch_split_epilogue(part, split, M, N, e, out, st);
}
}  // namespace

// The `a8` mode of q8_matmul (a8.cuh): xi_ws (M, K) int8 and sx_ws (M, K/gs)
// fp32 workspaces take the quantized activations (normed by g where g is
// given); split > 0 takes the GEMV path (M <= 16: the int8 tensor cores
// where gs % 32 == 0, else dp4a) with part_ws (split, M, N) fp32 and kslice
// rows per split (a multiple of gs); split == 0 the
// tiles: the wgmma tiles where gs % 32 == 0, with part_ws (M, rope_hs)
// fp32 for the RoPE table where pos is given, else the mma.sync tiles. gs
// is any multiple of 8 (that divides K); otherwise as q8_matmul.
extern "C" int q8_matmul_a8(const void* x, const void* q, const void* s, const void* g,
                            const void* res, const void* pos, void* out, void* xi_ws,
                            void* sx_ws, void* part_ws, int M, int K, int N, int gs, int split,
                            int kslice, int rope_limit, int rope_hs, float rope_coef, float eps,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  if (gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  if (split > 0)
    return a8_gemv_path(gs % 32 == 0, false, xi_ws, sx_ws, q, s, (float*)part_ws, M, K, N, gs,
                        split, kslice, e, out, st);
  if (gs % 32)
    return hipllama::a8::launch_mma<false, false>(xi_ws, sx_ws, q, s, M, K, N, N, 0, gs, e, out,
                                                  st);
  Epilogue et = e;
  if (pos != nullptr) {  // the tiles read each row's cos and sin from part_ws
    if (part_ws == nullptr || rope_hs < 2 || rope_hs % 2) return (int)cudaErrorInvalidValue;
    HIPLLAMA_TRY(launch_rope_table(pos, M, rope_hs, rope_coef, (float*)part_ws, st));
    et.rope_cs = (const float*)part_ws;
  }
  return launch_a8_tiles<false>(xi_ws, sx_ws, q, s, M, K, N, N, 0, gs, et, out, st);
}

// The `a8` mode of q8_matmul_silu: W1 and W3 share one quantized x.
// Workspaces as q8_matmul_a8, part_ws (split, M, 2H).
extern "C" int q8_matmul_silu_a8(const void* x, const void* q13, const void* s13,
                                 const void* g, void* out, void* xi_ws, void* sx_ws,
                                 void* part_ws, int M, int K, int H, int gs, int split,
                                 int kslice, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % gs) return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  if (split > 0)
    return a8_gemv_path(gs % 32 == 0, true, xi_ws, sx_ws, q13, s13, (float*)part_ws, M, K, 2 * H,
                        gs, split, kslice, none, out, st);
  if (gs % 32)
    return hipllama::a8::launch_mma<true, false>(xi_ws, sx_ws, q13, s13, M, K, 2 * H, H, H, gs,
                                                 none, out, st);
  return launch_a8_tiles<true>(xi_ws, sx_ws, q13, s13, M, K, 2 * H, H, H, gs, none, out, st);
}

// The `a8` tiles alone on quantized rows xi (M, K) int8 and sx (M, K/gs)
// fp32, no epilogue (gate: the W1|W3 gate, q (K, 2 ncols); else q (K,
// ncols)), for comparing the tile kernels on the same inputs: variant 0 the
// wgmma tiles, 1 a8.cuh's mma.sync tiles.
extern "C" int q8_a8_tiles_probe(const void* xi, const void* sx, const void* q, const void* s,
                                 void* out, int M, int K, int ncols, int gs, int gate,
                                 int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  const int ldq = gate ? 2 * ncols : ncols, off2 = gate ? ncols : 0;
  if (variant == 0)
    return gate ? launch_a8_tiles<true>(xi, sx, q, s, M, K, ldq, ncols, off2, gs, none, out, st)
                : launch_a8_tiles<false>(xi, sx, q, s, M, K, ldq, ncols, off2, gs, none, out, st);
  if (variant == 1)
    return gate ? hipllama::a8::launch_mma<true, false>(xi, sx, q, s, M, K, ldq, ncols, off2, gs,
                                                        none, out, st)
                : hipllama::a8::launch_mma<false, false>(xi, sx, q, s, M, K, ldq, ncols, off2,
                                                         gs, none, out, st);
  return (int)cudaErrorInvalidValue;
}

// The `a8` GEMV path of q8_matmul_a8 (gate: q8_matmul_silu_a8's, q (K, N
// = 2H), out (M, H)) with its kernel chosen: variant 0 the int8 tensor
// cores, 1 dp4a, after the same quantizer pass and before the same split
// pass; arguments otherwise as q8_matmul_a8's (split > 0). For comparing
// the two GEMVs' outputs bit for bit.
extern "C" int q8_a8_gemv_probe(const void* x, const void* q, const void* s, const void* g,
                                const void* res, const void* pos, void* out, void* xi_ws,
                                void* sx_ws, void* part_ws, int M, int K, int N, int gs, int split,
                                int kslice, int gate, int variant, int rope_limit, int rope_hs,
                                float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  if (variant < 0 || variant > 1 || gs < 1 || K % gs || split < 1 || (gate && (res || pos)))
    return (int)cudaErrorInvalidValue;
  HIPLLAMA_TRY(launch_a8_quant(x, g, xi_ws, sx_ws, M, K, gs, eps, st));
  return a8_gemv_path(variant == 0, gate != 0, xi_ws, sx_ws, q, s, (float*)part_ws, M, K, N, gs,
                      split, kslice, e, out, st);
}

namespace {
// layer l of a stacked weight and norm weight: q (L, K, N) int8, s (L,
// K/gs, N) fp32, g (L, K) fp32 or null
struct LayerPtrs {
  const void* q;
  const void* s;
  const void* g;
};

LayerPtrs layer_ptrs(const void* q, const void* s, const void* g, int K, int N, int gs,
                     int layer) {
  const size_t kn = (size_t)K * N;
  return {static_cast<const int8_t*>(q) + (size_t)layer * kn,
          static_cast<const float*>(s) + (size_t)layer * (K / gs) * N,
          g == nullptr ? nullptr : static_cast<const float*>(g) + (size_t)layer * K};
}
}  // namespace

// q8_matmul on layer `layer` of the stacked q, s and g; arguments as
// q8_matmul's, the layer after the ints.
extern "C" int q8_matmul_layered(const void* x, const void* q, const void* s, const void* g,
                                 const void* res, const void* pos, void* out, void* xn_ws,
                                 void* part_ws, int M, int K, int N, int gs, int split,
                                 int rope_limit, int rope_hs, int layer, float rope_coef,
                                 float eps, void* stream) {
  if (layer < 0 || gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  const LayerPtrs w = layer_ptrs(q, s, g, K, N, gs, layer);
  return q8_matmul(x, w.q, w.s, w.g, res, pos, out, xn_ws, part_ws, M, K, N, gs, split,
                   rope_limit, rope_hs, rope_coef, eps, stream);
}

// q8_matmul_a8 on layer `layer` of the stacked q, s and g; arguments as
// q8_matmul_a8's, the layer after the ints.
extern "C" int q8_matmul_layered_a8(const void* x, const void* q, const void* s, const void* g,
                                    const void* res, const void* pos, void* out, void* xi_ws,
                                    void* sx_ws, void* part_ws, int M, int K, int N, int gs,
                                    int split, int kslice, int rope_limit, int rope_hs,
                                    int layer, float rope_coef, float eps, void* stream) {
  if (layer < 0 || gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  const LayerPtrs w = layer_ptrs(q, s, g, K, N, gs, layer);
  return q8_matmul_a8(x, w.q, w.s, w.g, res, pos, out, xi_ws, sx_ws, part_ws, M, K, N, gs,
                      split, kslice, rope_limit, rope_hs, rope_coef, eps, stream);
}
