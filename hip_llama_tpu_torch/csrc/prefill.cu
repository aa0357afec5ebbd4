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
// has 227 KB of shared memory and the sums belong in registers, so here
// both run the K15/K17 tiles (q8_wgmma.cuh's q8_tile_kernel and
// launch_tiles), through entry points and launch counters of their own: a
// CTA computes a 256 x 128 output tile over the whole K on the pipelined
// mainloop (a producer warpgroup copies x and the int8 weight by cp.async
// into a ring; two consumer warpgroups dequantize step it + 1's weight
// tile, once per CTA of 256 rows, while step it - 1's wgmma m64n128k16 run,
// and wait with wgmma.wait_group 1; setmaxnreg moves registers to the
// consumers). The epilogue (the residual, or RoPE from a cos/sin table one
// pass computes per call) or the gate bf16(h1 * sigmoid(h1) * h3) (a B
// tile of 64 W1 columns beside the same 64 of W3) runs on the fp32 sums in
// the tile's store: no workspace, no second pass, no atomics. Measured and
// not kept (PERF.md): a thread-block cluster along M whose CTAs share each
// step's dequantized weight tile through distributed shared memory (the
// TPU kernel's dequant-once), slower; the row tiles of a column tile run
// together, no faster. The norm prologue, where given, is a pass of its own
// first, as where the JAX call takes K19 (the norm has moved outside its
// kernel).
//
// Bound on an H100: at prefill M (2048) the product does 2M flops per
// weight byte, far above the ~295 flop/byte ridge, so it is bound by
// operations on the bf16 tensor cores, which only wgmma drives at their
// full rate.
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

#include <stdint.h>

#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"
#include "q8_wgmma.cuh"

namespace {

using namespace hipllama::q8;
namespace wg = hipllama::q8wg;

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
// rope_ws (M, rope_hs) fp32 for the RoPE table when pos is given. K % 16
// == 0, N % 16 == 0, any gs that divides K.
extern "C" int q8_matmul_minner(const void* x, const void* q, const void* s, const void* g,
                                const void* res, const void* pos, void* out, void* xn_ws,
                                void* rope_ws, int M, int K, int N, int gs, int rope_limit,
                                int rope_hs, float rope_coef, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % 16 || N % 16 || gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  Epilogue e{(const bf16*)res, (const int*)pos, rope_limit, rope_hs, rope_coef};
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  if (pos != nullptr) {  // the tiles read each row's cos and sin from rope_ws
    if (rope_ws == nullptr || rope_hs < 2 || rope_hs % 2) return (int)cudaErrorInvalidValue;
    HIPLLAMA_TRY(launch_rope_table(pos, M, rope_hs, rope_coef, (float*)rope_ws, st));
    e.rope_cs = (const float*)rope_ws;
  }
  return launch_tiles<false>(xin, q, s, M, K, N, N, 0, gs, e, out, st);
}

// K19 silu: q13 (K, 2H); out (M, H); otherwise as q8_matmul_minner. H % 16
// == 0.
extern "C" int q8_matmul_silu_minner(const void* x, const void* q13, const void* s13,
                                     const void* g, void* out, void* xn_ws, int M, int K, int H,
                                     int gs, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % 16 || H % 16 || gs < 1 || K % gs) return (int)cudaErrorInvalidValue;
  const void* xin = x;
  if (g != nullptr) {
    HIPLLAMA_TRY(launch_norm(x, g, xn_ws, M, K, eps, st));
    xin = xn_ws;
  }
  const Epilogue none{nullptr, nullptr, 0, 1, 0.f};
  return launch_tiles<true>(xin, q13, s13, M, K, 2 * H, H, H, gs, none, out, st);
}

// K19's launch plan for an (M, N) product (the gate: N = H), as its
// launches build it: plan[0..3] = the grid's x and y, the rows and the
// output columns of a CTA's tile. The launch sets no cluster dimension.
extern "C" int q8_minner_plan(int M, int N, int gate, int* plan) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = gate ? tile_grid<true>(M, N) : tile_grid<false>(M, N);
  plan[0] = (int)grid.x;
  plan[1] = (int)grid.y;
  plan[2] = TileT::kBM;
  plan[3] = gate ? wg::kBN / 2 : wg::kBN;
  return 0;
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
