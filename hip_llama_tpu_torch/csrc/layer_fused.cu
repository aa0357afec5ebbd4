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
// separates the phases, and the intermediates (xn, qkv, att, x2, hb and the
// fp32 partial sums) stay in a workspace that fits in L2. The tasks are
// those of the standalone kernels with the same plans: the four products
// are q8.cuh's tensor-core GEMV tasks (mma.sync, a cp.async ring per warp)
// at gemv_plan's splits, each followed by its pass over the partials
// (RoPE, the residual, the gate, the residual), and attention is
// decode_attention.cuh's task. So the layer rounds exactly as q8_matmul
// (norm + RoPE), attention_decode_fused, q8_matmul (residual) and
// q8_matmul_ffn in a row, as the TPU kernel does against its 4-kernel path
// (layer_fused.py:25-27). What it removes is the launch of 11 kernels and
// the gap between them per layer.
//
// Bounds on an H100: as the products it fuses, by the weight bytes (1 byte
// per weight plus 4/gs for the scales) and the live cache rows; the 10
// barriers cost a few microseconds each. The QKV rows of this step leave
// the kernel in the workspace for the cache commit after the layer loop.
//
// The attention phase runs decode_attention.cuh's task at the block the
// wrapper passes, on an int8 cache (kv_int8: int8 planes with fp32
// row-scale planes (B, L, KVH, S)) its int8 task: the ones attention_
// decode_fused runs. The task's M x bk scores sit in the dynamic shared
// memory after its own, which the launch sizes for the larger of the
// phases.

#include <stdint.h>

#include "decode_attention.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::q8;
using hipllama::ContiguousCache;
using hipllama::DecodeSmem;
using hipllama::DecodeSmemInt8;
using hipllama::decode_attention_task;
using hipllama::decode_attention_task_int8;
using hipllama::kDecThreads;
using hipllama::kMaxM;

struct LayerArgs {
  const bf16* x;  // (B, D)
  const int8_t* qkv_q;
  const float* qkv_s;  // (D, NQKV)
  const float* g1;
  const int* pos;  // (B,)
  const void* k_cache;
  const void* v_cache;  // (B, L, KVH, S, HS), bf16 or int8
  const float* k_scale;
  const float* v_scale;  // (B, L, KVH, S) for an int8 cache, else null
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
  bf16* hb;    // (B, hidden) workspace: the gated hidden rows
  float* part; // fp32 partial sums
  unsigned int* bar;  // two zeroed words: arrivals, generation
  int B, D, H, KVH, S, HS, L, layer, hidden;
  int gs_qkv, gs_o, gs13, gs2;
  int split_q, split_o, split13, split2, bk, kv_int8;
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

// one product's split-K partials (B, K) @ (K, N) into part (split, B, N)
template <int MAXM>
__device__ __noinline__ void gemv_phase(const bf16* x, const int8_t* q, const float* s,
                                        float* part, int B, int K, int N, int gs, int split) {
  auto& sm = *reinterpret_cast<GemvSmem<MAXM>*>(smem);
  if (gs % kGemvStep == 0)
    gemv_tasks<MAXM, true>(sm, x, q, s, part, B, K, N, gs, split);
  else
    gemv_tasks<MAXM, false>(sm, x, q, s, part, B, K, N, gs, split);
}

// the attention phase at compiled head size HS (decode_hs_pad of the head
// size): one (KV head, group of at most kMaxM query heads, slot) task each,
// on the CTA's threads as attention_decode_fused runs it, so that the two
// round alike
static_assert(kDecThreads == kThreads, "the attention tasks take the whole CTA");
template <int HS>
__device__ __noinline__ void attention_phase(const LayerArgs& a) {
  auto& at = *reinterpret_cast<DecodeSmem<HS, kDecThreads>*>(smem);
  auto& at8 = *reinterpret_cast<DecodeSmemInt8<HS, kDecThreads>*>(smem);
  float* p_s = reinterpret_cast<float*>(
      smem + (a.kv_int8 ? sizeof(DecodeSmemInt8<HS, kDecThreads>)
                        : sizeof(DecodeSmem<HS, kDecThreads>)));
  const int hs = a.HS;
  const int nqkv = (a.H + 2 * a.KVH) * hs;
  const bf16* kc = a.qkv + a.H * hs;
  const bf16* vc = a.qkv + (a.H + a.KVH) * hs;
  const ContiguousCache cache{a.L, a.KVH, a.S, a.layer};
  const int ng = hipllama::head_groups(a.H / a.KVH);
  for (int t = blockIdx.x; t < a.KVH * ng * a.B; t += gridDim.x) {
    const int gm = t % (a.KVH * ng), b = t / (a.KVH * ng);
    const int g = gm / ng, m0 = gm % ng * kMaxM;
    if (a.kv_int8)
      decode_attention_task_int8<bf16, HS, kDecThreads>(
          at8, p_s, g, b, a.qkv, (const signed char*)a.k_cache, (const signed char*)a.v_cache,
          a.k_scale, a.v_scale, cache.rows(b, g), a.pos, kc, vc, a.att, a.H, a.KVH, a.scale,
          nqkv, nqkv, a.bk, hs, m0);
    else
      decode_attention_task<bf16, HS, kDecThreads>(
          at, p_s, g, b, a.qkv, (const bf16*)a.k_cache, (const bf16*)a.v_cache,
          cache.rows(b, g), a.pos, kc, vc, a.att, a.H, a.KVH, a.scale, nqkv, nqkv, a.bk, hs,
          m0);
  }
}

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
  gemv_phase<MAXM>(a.xn, a.qkv_q, a.qkv_s, a.part, B, D, nqkv, a.gs_qkv, a.split_q);
  grid_barrier(a.bar, nblk);
  const Epilogue rope{nullptr, a.pos, (a.H + a.KVH) * HS, HS, a.rope_coef};
  for (int i = gtid; i < B * (nqkv / 2); i += gthreads)
    split_epilogue_at(a.part, a.split_q, B, nqkv, rope, a.qkv, i);
  grid_barrier(a.bar, nblk);
  switch (hipllama::decode_hs_pad(HS)) {
    case 8: attention_phase<8>(a); break;
    case 16: attention_phase<16>(a); break;
    case 32: attention_phase<32>(a); break;
    case 64: attention_phase<64>(a); break;
    case 128: attention_phase<128>(a); break;
    default: attention_phase<256>(a); break;
  }
  grid_barrier(a.bar, nblk);
  // x2 = x + att @ Wo
  gemv_phase<MAXM>(a.att, a.wo_q, a.wo_s, a.part, B, D, D, a.gs_o, a.split_o);
  grid_barrier(a.bar, nblk);
  const Epilogue resid{a.x, nullptr, 0, 1, 0.f};
  for (int i = gtid; i < B * (D / 2); i += gthreads)
    split_epilogue_at(a.part, a.split_o, B, D, resid, a.x2, i);
  grid_barrier(a.bar, nblk);
  // xn = rmsnorm(x2, g2)
  for (int r = blockIdx.x; r < B; r += gridDim.x)
    rmsnorm_row(a.x2 + (size_t)r * D, a.g2, a.xn + (size_t)r * D, D, a.eps, red);
  grid_barrier(a.bar, nblk);
  // the FFN: hb = bf16(silu(xn W1) * xn W3), then out = x2 + hb W2
  gemv_phase<MAXM>(a.xn, a.w13_q, a.w13_s, a.part, B, D, 2 * a.hidden, a.gs13, a.split13);
  grid_barrier(a.bar, nblk);
  for (int i = gtid; i < B * a.hidden; i += gthreads)
    split_gate_at(a.part, a.split13, B, a.hidden, a.hb, i);
  grid_barrier(a.bar, nblk);
  gemv_phase<MAXM>(a.hb, a.w2_q, a.w2_s, a.part, B, a.hidden, D, a.gs2, a.split2);
  grid_barrier(a.bar, nblk);
  const Epilogue resid2{a.x2, nullptr, 0, 1, 0.f};
  for (int i = gtid; i < B * (D / 2); i += gthreads)
    split_epilogue_at(a.part, a.split2, B, D, resid2, a.out, i);
}

// the attention phase's task and its block of min(M, kMaxM) x bk scores, at
// the task's compiled head size
size_t attention_smem(const LayerArgs& a) {
  const int M = a.H / a.KVH < kMaxM ? a.H / a.KVH : kMaxM;
#define HIPLLAMA_SMEM(N)                                                              \
  return a.kv_int8 ? hipllama::decode_int8_smem<N, kDecThreads>(M, a.bk)              \
                   : hipllama::decode_smem<N, kDecThreads>(M, a.bk)
  switch (hipllama::decode_hs_pad(a.HS)) {
    case 8: HIPLLAMA_SMEM(8);
    case 16: HIPLLAMA_SMEM(16);
    case 32: HIPLLAMA_SMEM(32);
    case 64: HIPLLAMA_SMEM(64);
    case 128: HIPLLAMA_SMEM(128);
    default: HIPLLAMA_SMEM(256);
  }
#undef HIPLLAMA_SMEM
}

template <int MAXM>
int launch_layer(const LayerArgs& a, cudaStream_t st) {
  constexpr size_t smem_gemv = sizeof(GemvSmem<MAXM>);
  // the attention phase's task and its block of scores
  const size_t smem_att = attention_smem(a);
  const size_t smem = smem_att > smem_gemv ? smem_att : smem_gemv;
  auto kernel = q8_layer_kernel<MAXM>;
  static int grid = 0;  // CTAs that fit on the card at once at smem_grid bytes
  static size_t smem_grid = 0;
  if (grid == 0 || smem != smem_grid) {
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
    smem_grid = smem;
  }
  void* args[] = {const_cast<LayerArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args,
                                          smem, st);
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// bf16 activations, int8 weights with fp32 scales, fp32 norm weights, int32
// positions. The cache: bf16 (kv_int8 0; k_scale and v_scale null) or int8
// with its fp32 scale planes (kv_int8 1); bk >= 1 cache rows per
// online-softmax block. D == H * HS, HS a multiple of 8 up to 256 (the
// attention task compiled for decode_hs_pad(HS)), any H / KVH, D and hidden
// multiples of 16. split_q, split_o, split13, split2: the products' slices
// of their contraction (gemv_plan; 1 to K / 16). Workspaces: xn, att and
// x2 (B, D) bf16; qkv (B, (H + 2 KVH) HS) bf16 (its k|v rows are the step's
// rows for the cache commit); hb (B, hidden) bf16; part fp32 of
// max(split_q * B * NQKV, split_o * B * D, split13 * B * 2 hidden, split2 *
// B * D) values; bar two zeroed uint32.
extern "C" int q8_layer_fused(const void* x, const void* qkv_q, const void* qkv_s,
                              const void* g1, const void* pos, const void* k_cache,
                              const void* v_cache, const void* k_scale, const void* v_scale,
                              const void* wo_q, const void* wo_s, const void* w13_q,
                              const void* w13_s, const void* w2_q, const void* w2_s,
                              const void* g2, void* out, void* xn_ws, void* qkv_ws, void* att_ws,
                              void* x2_ws, void* hb_ws, void* part_ws, void* bar_ws, int B, int D,
                              int H, int KVH, int S, int HS, int L, int layer, int hidden,
                              int gs_qkv, int gs_o, int gs13, int gs2, int split_q, int split_o,
                              int split13, int split2, int bk, int kv_int8, float rope_coef,
                              float eps, void* stream) {
  const int nqkv = (H + 2 * KVH) * HS;
  auto bad_split = [](int split, int K) { return split < 1 || split > K / kGemvStep; };
  if (B < 1 || H % KVH || D != H * HS || D % 16 || hidden % 16 || bk < 1 ||
      hipllama::decode_hs_pad(HS) == 0 || gs_qkv < 1 || gs_o < 1 || gs13 < 1 || gs2 < 1 ||
      D % gs_qkv || D % gs_o || D % gs13 || hidden % gs2 || bad_split(split_q, D) ||
      bad_split(split_o, D) || bad_split(split13, D) || bad_split(split2, hidden) || nqkv % 16)
    return (int)cudaErrorInvalidValue;
  const LayerArgs a{
      (const bf16*)x, (const int8_t*)qkv_q, (const float*)qkv_s, (const float*)g1,
      (const int*)pos, k_cache, v_cache, (const float*)k_scale, (const float*)v_scale,
      (const int8_t*)wo_q, (const float*)wo_s, (const int8_t*)w13_q, (const float*)w13_s,
      (const int8_t*)w2_q, (const float*)w2_s, (const float*)g2, (bf16*)out, (bf16*)xn_ws,
      (bf16*)qkv_ws, (bf16*)att_ws, (bf16*)x2_ws, (bf16*)hb_ws, (float*)part_ws,
      (unsigned int*)bar_ws, B, D, H, KVH, S, HS, L, layer, hidden, gs_qkv, gs_o, gs13, gs2,
      split_q, split_o, split13, split2, bk, kv_int8,
      (float)(1.0 / sqrt((double)HS)), rope_coef, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return B <= 8 ? launch_layer<8>(a, st) : launch_layer<16>(a, st);
}
