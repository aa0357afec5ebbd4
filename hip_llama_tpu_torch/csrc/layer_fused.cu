// One whole Q8_0 decoder layer of a decode step in one kernel: replaces
// hip_llama_tpu/ops/layer_fused.py::q8_layer_fused (_layer_kernel).
//
//   qkv  = rope(rmsnorm(x, g1) @ Wqkv)         (B, H + 2 KVH, HS) head rows
//   att  = attention over the cache + the current k|v rows of qkv
//   x2   = x + att @ Wo
//   out  = x2 + W2 bf16(silu(xn2 @ W1) * (xn2 @ W3)),  xn2 = rmsnorm(x2, g2)
//
// The TPU kernel streams the layer's weights through one pipeline over a
// sequential grid whose phases hand their results on in VMEM. Here the grid
// is persistent (a cooperative launch of as many CTAs as fit on the card at
// once): each phase deals its tasks out to the CTAs, a grid-wide barrier
// separates the phases, and the intermediates (xn, qkv, att, x2 and the fp32
// partial sums) stay in a workspace that fits in L2. The tasks are those of
// the standalone kernels (q8.cuh, decode_attention.cuh) with the same plans,
// so the layer rounds exactly as q8_matmul (norm + RoPE), attention_decode_
// fused, q8_matmul (residual) and q8_matmul_ffn in a row, as the TPU kernel
// does against its 4-kernel path (layer_fused.py:25-27). What it removes is
// the launch of ~8 kernels and the gap between them per layer.
//
// Bounds on an H100: as the products it fuses, by the weight bytes (1 byte
// per weight plus 4/gs for the scales) and the live cache rows; the 8
// barriers cost a few microseconds each. The QKV rows of this step leave
// the kernel in the workspace for the cache commit after the layer loop.

#include <stdint.h>

#include "decode_attention.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::q8;
using hipllama::DecodeSmem;
using hipllama::decode_attention_task;
using hipllama::kDecThreads;
using hipllama::kDecTile;
using hipllama::kMaxM;

struct LayerArgs {
  const bf16* x;  // (B, D)
  const int8_t* qkv_q;
  const float* qkv_s;  // (D, NQKV)
  const float* g1;
  const int* pos;  // (B,)
  const bf16* k_cache;
  const bf16* v_cache;  // (B, L, KVH, S, HS)
  const int8_t* wo_q;
  const float* wo_s;  // (D, D)
  const int8_t* w13_q;
  const float* w13_s;  // (D, 2 HID)
  const int8_t* w2_q;
  const float* w2_s;  // (HID, D)
  const float* g2;
  bf16* out;   // (B, D)
  bf16* xn;    // (B, D) workspace
  bf16* qkv;   // (B, NQKV) workspace, and the step's k|v rows
  bf16* att;   // (B, D) workspace
  bf16* x2;    // (B, D) workspace
  float* part; // fp32 partial sums
  unsigned int* bar;  // two zeroed words: arrivals, generation
  int B, D, H, KVH, S, HS, L, layer, hidden;
  int gs_qkv, gs_o, gs13, gs2;
  int split_q, kslice_q, split_o, kslice_o, bk;
  float scale, rope_coef, eps;
};

// every CTA of the (co-resident) grid arrives before any leaves; the writes
// before it are visible to the reads after it
__device__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The phases that carry the products and attention are not inlined: each
// is compiled within its own register budget (the kernel's 128 at two CTAs
// per SM, which the standalone kernels' tasks fit), where the layer inlined
// whole kept the argument pointers live across it and spilled in the inner
// loops. Each names the kernel's dynamic shared memory itself, so that its
// tasks address it as shared memory.
extern __shared__ __align__(16) unsigned char smem[];

template <int MAXM>
__device__ __noinline__ void gemv_phase(const bf16* x, const int8_t* q, const float* s,
                                        float* part, int B, int K, int N, int gs, int split,
                                        int kslice) {
  auto& sm = *reinterpret_cast<GemvSmem<MAXM>*>(smem);
  const int strips = (N + kGvBN - 1) / kGvBN;
  const int chunks = (B + MAXM - 1) / MAXM;
  for (int t = blockIdx.x; t < strips * split * chunks; t += gridDim.x) {
    const int strip = t % strips, rest = t / strips;
    const int sp = rest % split, m0 = (rest / split) * MAXM;
    gemv_task<MAXM>(sm, x, q, s, part, min(MAXM, B - m0), B, m0, K, N, gs, kslice, strip, sp);
  }
}

template <int MAXM>
__device__ __noinline__ void ffn_phase(const LayerArgs& a) {
  auto& ff = *reinterpret_cast<FfnSmem<MAXM>*>(smem);
  const int nstrips = (a.hidden + kFfBH - 1) / kFfBH;
  const int chunks = (a.B + MAXM - 1) / MAXM;
  for (int t = blockIdx.x; t < nstrips * chunks; t += gridDim.x) {
    const int m0 = (t % chunks) * MAXM;
    ffn_strip_task<MAXM>(ff, a.xn, a.w13_q, a.w13_s, a.w2_q, a.w2_s, a.part,
                         min(MAXM, a.B - m0), a.B, m0, a.D, a.hidden, a.D, a.gs13, a.gs2,
                         t / chunks);
  }
}

// the attention phase at head size HS: one (KV head, slot) task each, on
// the CTA's threads as attention_decode_fused runs it, so that the two
// round alike
static_assert(kDecThreads == kThreads, "the attention tasks take the whole CTA");
template <int HS>
__device__ __noinline__ void attention_phase(const LayerArgs& a) {
  auto& at = *reinterpret_cast<DecodeSmem<HS, kDecThreads>*>(smem);
  const int nqkv = (a.H + 2 * a.KVH) * HS;
  for (int t = blockIdx.x; t < a.KVH * a.B; t += gridDim.x) {
    const int g = t % a.KVH, b = t / a.KVH;
    const bf16* kc = a.qkv + a.H * HS;
    const bf16* vc = a.qkv + (a.H + a.KVH) * HS;
    if (a.bk == kDecTile)
      decode_attention_task<bf16, HS, kDecThreads, kDecTile>(
          at, g, b, a.qkv, a.k_cache, a.v_cache, a.pos, kc, vc, a.att, a.H, a.KVH, a.S, a.L,
          a.layer, a.scale, nqkv, nqkv, a.bk);
    else
      decode_attention_task<bf16, HS, kDecThreads, 0>(
          at, g, b, a.qkv, a.k_cache, a.v_cache, a.pos, kc, vc, a.att, a.H, a.KVH, a.S, a.L,
          a.layer, a.scale, nqkv, nqkv, a.bk);
  }
}

constexpr size_t kMaxDecodeSmem = sizeof(DecodeSmem<128, kDecThreads>);

// two CTAs per SM at up to 8 rows (the standalone GEMV's occupancy); at
// 16 rows the accumulators need the registers of one
template <int MAXM>
__global__ void __launch_bounds__(kThreads, MAXM <= 8 ? 2 : 1) q8_layer_kernel(const LayerArgs a) {
  float* red = reinterpret_cast<float*>(smem);
  const unsigned int nblk = gridDim.x;
  const int gtid = blockIdx.x * kThreads + threadIdx.x, gthreads = gridDim.x * kThreads;
  const int B = a.B, D = a.D, HS = a.HS;
  const int nqkv = (a.H + 2 * a.KVH) * HS;

  // xn = rmsnorm(x, g1)
  for (int r = blockIdx.x; r < B; r += gridDim.x)
    rmsnorm_row(a.x + (size_t)r * D, a.g1, a.xn + (size_t)r * D, D, a.eps, red);
  grid_barrier(a.bar, nblk);
  // qkv = rope(xn @ Wqkv) on q|k
  gemv_phase<MAXM>(a.xn, a.qkv_q, a.qkv_s, a.part, B, D, nqkv, a.gs_qkv, a.split_q,
                   a.kslice_q);
  grid_barrier(a.bar, nblk);
  const Epilogue rope{nullptr, a.pos, (a.H + a.KVH) * HS, HS, a.rope_coef};
  for (int i = gtid; i < B * (nqkv / 2); i += gthreads)
    split_epilogue_at(a.part, a.split_q, B, nqkv, rope, a.qkv, i);
  grid_barrier(a.bar, nblk);
  switch (HS) {
    case 8: attention_phase<8>(a); break;
    case 16: attention_phase<16>(a); break;
    case 32: attention_phase<32>(a); break;
    case 64: attention_phase<64>(a); break;
    default: attention_phase<128>(a); break;
  }
  grid_barrier(a.bar, nblk);
  // x2 = x + att @ Wo
  gemv_phase<MAXM>(a.att, a.wo_q, a.wo_s, a.part, B, D, D, a.gs_o, a.split_o, a.kslice_o);
  grid_barrier(a.bar, nblk);
  const Epilogue resid{a.x, nullptr, 0, 1, 0.f};
  for (int i = gtid; i < B * (D / 2); i += gthreads)
    split_epilogue_at(a.part, a.split_o, B, D, resid, a.x2, i);
  grid_barrier(a.bar, nblk);
  // xn = rmsnorm(x2, g2)
  for (int r = blockIdx.x; r < B; r += gridDim.x)
    rmsnorm_row(a.x2 + (size_t)r * D, a.g2, a.xn + (size_t)r * D, D, a.eps, red);
  grid_barrier(a.bar, nblk);
  // the FFN's hidden strips, then out = x2 + their sum in order
  ffn_phase<MAXM>(a);
  grid_barrier(a.bar, nblk);
  const int nstrips = (a.hidden + kFfBH - 1) / kFfBH;
  for (int i = gtid; i < B * (D / 2); i += gthreads)
    ffn_reduce_at(a.part, nstrips, B, D, a.x2, a.out, i);
}

template <int MAXM>
int launch_layer(const LayerArgs& a, cudaStream_t st) {
  constexpr size_t smem_ab = sizeof(GemvSmem<MAXM>) > sizeof(FfnSmem<MAXM>)
                                 ? sizeof(GemvSmem<MAXM>) : sizeof(FfnSmem<MAXM>);
  constexpr size_t smem = smem_ab > kMaxDecodeSmem ? smem_ab : kMaxDecodeSmem;
  auto kernel = q8_layer_kernel<MAXM>;
  static int grid = 0;  // CTAs that fit on the card at once
  if (grid == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    grid = per_sm * sms;
  }
  void* args[] = {const_cast<LayerArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args,
                                          smem, st);
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// bf16 activations and cache, int8 weights with fp32 scales, fp32 norm
// weights, int32 positions. D == H * HS, HS in {8, 16, 32, 64, 128},
// H / KVH <= 8, D and hidden multiples of 16, bk (1..64) cache rows per
// online-softmax block. Workspaces: xn, att and x2 (B, D) bf16; qkv (B, (H +
// 2 KVH) HS) bf16 (its k|v rows are the step's rows for the cache commit);
// part fp32 of max(split_q * B * NQKV, split_o * B * D, ceil(hidden / 64) *
// B * D) values; bar two zeroed uint32.
extern "C" int q8_layer_fused(const void* x, const void* qkv_q, const void* qkv_s,
                              const void* g1, const void* pos, const void* k_cache,
                              const void* v_cache, const void* wo_q, const void* wo_s,
                              const void* w13_q, const void* w13_s, const void* w2_q,
                              const void* w2_s, const void* g2, void* out, void* xn_ws,
                              void* qkv_ws, void* att_ws, void* x2_ws, void* part_ws, void* bar_ws,
                              int B, int D, int H, int KVH, int S, int HS, int L, int layer,
                              int hidden, int gs_qkv, int gs_o, int gs13, int gs2, int split_q,
                              int kslice_q, int split_o, int kslice_o, int bk, float rope_coef,
                              float eps, void* stream) {
  if (H % KVH || H / KVH > kMaxM || D != H * HS || D % 16 || hidden % 16 || bk < 1 ||
      bk > kDecTile || kslice_q > kGvKMax || kslice_o > kGvKMax ||
      (HS != 8 && HS != 16 && HS != 32 && HS != 64 && HS != 128))
    return (int)cudaErrorInvalidValue;
  const LayerArgs a{
      (const bf16*)x, (const int8_t*)qkv_q, (const float*)qkv_s, (const float*)g1,
      (const int*)pos, (const bf16*)k_cache, (const bf16*)v_cache, (const int8_t*)wo_q,
      (const float*)wo_s, (const int8_t*)w13_q, (const float*)w13_s, (const int8_t*)w2_q,
      (const float*)w2_s, (const float*)g2, (bf16*)out, (bf16*)xn_ws, (bf16*)qkv_ws,
      (bf16*)att_ws, (bf16*)x2_ws, (float*)part_ws, (unsigned int*)bar_ws,
      B, D, H, KVH, S, HS, L, layer, hidden, gs_qkv, gs_o, gs13, gs2,
      split_q, kslice_q, split_o, kslice_o, bk,
      (float)(1.0 / sqrt((double)HS)), rope_coef, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return B <= 8 ? launch_layer<8>(a, st) : launch_layer<16>(a, st);
}
