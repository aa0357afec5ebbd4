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
// at gemv_plan's splits, and attention is decode_attention.cuh's task (on
// an int8 cache, kv_int8: int8 planes with fp32 row-scale planes (B, L,
// KVH, S), its int8 task, which streams K and V tiles through a
// shared-memory ring). The passes over the partials that follow the
// products (the residual, the gate, the residual) run as phases of their
// own; the QKV product's pass (its splits added, RoPE on q|k) runs inside
// the attention tasks, each adding the columns of its own q heads and of
// its KV head's k and v rows with the pass's own code (SplitOperands), so
// that no phase and barrier sit between the QKV product and attention. So
// the layer rounds exactly as q8_matmul (norm + RoPE), attention_decode_
// fused, q8_matmul (residual) and q8_matmul_ffn in a row, as the TPU kernel
// does against its 4-kernel path (layer_fused.py:25-27). What it removes is
// the launch of 11 kernels and the gap between them per layer.
//
// Bounds on an H100: as the products it fuses, by the weight bytes (1 byte
// per weight plus 4/gs for the scales) and the live cache rows; each of the
// 9 barriers costs about 1.8 us (q8_layer_barrier_probe). The k|v rows of
// this step leave the kernel in the qkv workspace for the cache commit
// after the layer loop (the q columns stay in the attention tasks' shared
// memory).
//
// The dynamic shared memory is sized for the larger of the phases: the
// GEMV's rings, or the attention task's struct (its tile ring) with a chunk
// of the block's min(M, kMaxM) x bk scores (on an int8 cache also their v
// scales and packed probabilities): the whole block where it fits
// (decode_chunk: beside a second CTA an SM; decode_int8_chunk: a CTA),
// as attention_decode_fused takes it.

#include <stdint.h>

#include <type_traits>

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
  int split_q, split_o, split13, split2, bk, bc, kv_int8;  // bc: the attention task's chunk
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

// The attention task's operands from the QKV product's split-K partials
// (split, B, NQKV): the column pairs of the task's q heads and of its KV
// head's k and v columns, each added over the splits and rotated (q and k)
// by the code of the standalone pass (q8.cuh::split_pair_sum, epilogue_pair),
// so they round as q8_matmul writes them; the task of the KV head's first
// group of query heads also writes the k|v rows to qkv for the cache commit.
struct SplitOperands {
  const float* part;
  int split, B, nqkv, H, KVH;
  Epilogue rope;
  bf16* qkv;
  bool write_kv;
  template <int HS>
  __device__ __forceinline__ void load(int b, int g, int head0, int MC, int hs, float (*q_s)[HS],
                                       float* kc_s, float* vc_s) const {
    const int pairs = hs / 2;
    for (int i = threadIdx.x; i < (MC + 2) * pairs; i += blockDim.x) {
      const int m = i / pairs, p = (i - m * pairs) * 2;
      const int n = (m < MC ? (head0 + m) * hs : m == MC ? (H + g) * hs : (H + KVH + g) * hs) + p;
      const float2 a = split_pair_sum(part, split, B, nqkv, b, n);
      const __nv_bfloat162 r = epilogue_pair(rope, b, n, nqkv, a.x, a.y);
      float* dst = m < MC ? &q_s[m][p] : (m == MC ? kc_s : vc_s) + p;
      dst[0] = __low2float(r);
      dst[1] = __high2float(r);
      if (m >= MC && write_kv)
        *reinterpret_cast<__nv_bfloat162*>(qkv + (size_t)b * nqkv + n) = r;
    }
    for (int i = threadIdx.x; i < MC * (HS - hs); i += blockDim.x)
      q_s[i / (HS - hs)][hs + i % (HS - hs)] = 0.f;
  }
};

// the attention phase at compiled head size HS (decode_hs_pad of the head
// size), on the int8 cache or the bf16 one, the int8 task's register arrays
// sized for MAXM query heads (1 where the layer has one a KV head; a
// function each, so that each is compiled within the phase's register
// budget alone): one (KV head, group of at most kMaxM query heads, slot)
// task each, on the CTA's threads as attention_decode_fused runs it, so
// that the two round alike; each task makes its operands from the QKV
// partials
static_assert(kDecThreads == kThreads, "the attention tasks take the whole CTA");
template <int HS, bool INT8, int MAXM>
__device__ __noinline__ void attention_phase(const LayerArgs& a) {
  using Smem = typename std::conditional<INT8, DecodeSmemInt8<HS, kDecThreads>,
                                         DecodeSmem<bf16, HS, kDecThreads>>::type;
  auto& sm = *reinterpret_cast<Smem*>(smem);
  float* dyn = reinterpret_cast<float*>(smem + sizeof(Smem));
  const int hs = a.HS;
  const int nqkv = (a.H + 2 * a.KVH) * hs;
  const ContiguousCache cache{a.L, a.KVH, a.S, a.layer};
  const Epilogue rope{nullptr, a.pos, (a.H + a.KVH) * hs, hs, a.rope_coef};
  const int ng = hipllama::head_groups(a.H / a.KVH);
  for (int t = blockIdx.x; t < a.KVH * ng * a.B; t += gridDim.x) {
    const int gm = t % (a.KVH * ng), b = t / (a.KVH * ng);
    const int g = gm / ng, m0 = gm % ng * kMaxM;
    const SplitOperands ops{a.part, a.split_q, a.B, nqkv, a.H, a.KVH, rope, a.qkv, m0 == 0};
    using Rows = decltype(cache.rows(b, g));
    if constexpr (INT8)
      decode_attention_task_int8<bf16, HS, kDecThreads, Rows, SplitOperands, true, MAXM>(
          sm, dyn, g, b, ops, (const signed char*)a.k_cache, (const signed char*)a.v_cache,
          a.k_scale, a.v_scale, cache.rows(b, g), a.pos, a.att, a.H, a.KVH, a.scale, a.bk, a.bc,
          hs, m0);
    else
      decode_attention_task<bf16, HS, kDecThreads, Rows, SplitOperands>(
          sm, dyn, g, b, ops, (const bf16*)a.k_cache, (const bf16*)a.v_cache, cache.rows(b, g),
          a.pos, a.att, a.H, a.KVH, a.scale, a.bk, a.bc, hs, m0);
  }
}

template <int HS>
__device__ __forceinline__ void attention(const LayerArgs& a) {
  if (!a.kv_int8)
    attention_phase<HS, false, kMaxM>(a);
  else if (a.H == a.KVH)
    attention_phase<HS, true, 1>(a);
  else
    attention_phase<HS, true, kMaxM>(a);
}

// two CTAs per SM at up to 8 rows (the standalone GEMV's occupancy); at
// 16 rows the accumulators need the registers of one
template <int MAXM>
__global__ void __launch_bounds__(kThreads, MAXM <= 8 ? 2 : 1) q8_layer_kernel(const LayerArgs a) {
  float* red = reinterpret_cast<float*>(smem);
  const unsigned int nblk = gridDim.x;
  const int gtid = blockIdx.x * kThreads + threadIdx.x, gthreads = gridDim.x * kThreads;
  const int B = a.B, D = a.D;
  const int nqkv = (a.H + 2 * a.KVH) * a.HS;

  // xn = rmsnorm(x, g1)
  for (int r = blockIdx.x; r < B; r += gridDim.x)
    rmsnorm_row(a.x + (size_t)r * D, a.g1, a.xn + (size_t)r * D, D, a.eps, red);
  grid_barrier(a.bar, nblk);
  // the QKV partials of xn @ Wqkv; each attention task adds and rotates its
  // own q, k and v columns
  gemv_phase<MAXM>(a.xn, a.qkv_q, a.qkv_s, a.part, B, D, nqkv, a.gs_qkv, a.split_q);
  grid_barrier(a.bar, nblk);
  switch (hipllama::decode_hs_pad(a.HS)) {
    case 8: attention<8>(a); break;
    case 16: attention<16>(a); break;
    case 32: attention<32>(a); break;
    case 64: attention<64>(a); break;
    case 128: attention<128>(a); break;
    default: attention<256>(a); break;
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

// the attention phase's task and its chunk of bc rows of min(M, kMaxM)
// heads' scores, at the task's compiled head size
size_t attention_smem(const LayerArgs& a) {
  const int M = a.H / a.KVH < kMaxM ? a.H / a.KVH : kMaxM;
#define HIPLLAMA_SMEM(N)                                                              \
  return a.kv_int8 ? hipllama::decode_int8_smem<N, kDecThreads>(M, a.bc)              \
                   : hipllama::decode_smem<bf16, N, kDecThreads>(M, a.bc)
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

// the dynamic shared memory of the kernel at up to MAXM rows: the larger of
// its phases' (the GEMV's rings, the attention task's)
template <int MAXM>
size_t layer_smem(const LayerArgs& a) {
  const size_t att = attention_smem(a), gemv = sizeof(GemvSmem<MAXM>);
  return att > gemv ? att : gemv;
}

// the kernel's CTAs an SM at smem bytes of dynamic shared memory (its
// launch bounds ask for two up to 8 rows), in per_sm; the kernel may take
// up to a CTA's whole shared memory
template <int MAXM>
cudaError_t layer_ctas_per_sm(size_t smem, int& per_sm) {
  auto kernel = q8_layer_kernel<MAXM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)hipllama::kSmemPerCta);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
}

template <int MAXM>
int launch_layer(const LayerArgs& a, cudaStream_t st) {
  const size_t smem = layer_smem<MAXM>(a);
  static int grid = 0;  // CTAs that fit on the card at once at smem_grid bytes
  static size_t smem_grid = 0;
  if (grid == 0 || smem != smem_grid) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = layer_ctas_per_sm<MAXM>(smem, per_sm);
    if (e != cudaSuccess) return (int)e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    grid = per_sm * sms;
    smem_grid = smem;
  }
  void* args[] = {const_cast<LayerArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel((const void*)q8_layer_kernel<MAXM>, dim3(grid),
                                          dim3(kThreads), args, smem, st);
}

// the attention task's chunk of a block of bk rows at head size hs and M
// query heads per KV head, on an int8 cache or the bf16 one
// (decode_int8_chunk, decode_chunk: as attention_decode_fused takes it)
int attention_chunk(int hs, int M, int bk, int kv_int8) {
  const int mc = M < kMaxM ? M : kMaxM;
#define HIPLLAMA_CHUNK(N)                                                  \
  return kv_int8 ? hipllama::decode_int8_chunk<N, kDecThreads>(mc, bk)     \
                 : hipllama::decode_chunk<bf16, N, kDecThreads>(mc, bk)
  switch (hipllama::decode_hs_pad(hs)) {
    case 8: HIPLLAMA_CHUNK(8);
    case 16: HIPLLAMA_CHUNK(16);
    case 32: HIPLLAMA_CHUNK(32);
    case 64: HIPLLAMA_CHUNK(64);
    case 128: HIPLLAMA_CHUNK(128);
    default: HIPLLAMA_CHUNK(256);
  }
#undef HIPLLAMA_CHUNK
}

// a cooperative grid that passes n of the layer's grid barriers and does
// nothing else: timed at two n, what one barrier costs the layer
__global__ void __launch_bounds__(kThreads, 2) barrier_probe_kernel(unsigned int* bar, int n) {
  for (int i = 0; i < n; ++i) grid_barrier(bar, gridDim.x);
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// barrier_probe_kernel on ctas CTAs (at most two an SM: K23's grid up to 8
// rows); bar_ws two zeroed uint32
extern "C" int q8_layer_barrier_probe(void* bar_ws, int n, int ctas, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (n < 0 || ctas < 1 || ctas > 2 * sms) return (int)cudaErrorInvalidValue;
  unsigned int* bar = static_cast<unsigned int*>(bar_ws);
  void* args[] = {&bar, &n};
  return (int)cudaLaunchCooperativeKernel((const void*)barrier_probe_kernel, dim3(ctas),
                                          dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}

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
  // the attention tasks copy rows in 16-byte pieces from 16-byte aligned planes
  if ((uintptr_t)k_cache % 16 || (uintptr_t)v_cache % 16 ||
      (kv_int8 && ((uintptr_t)k_scale % 4 || (uintptr_t)v_scale % 4)))
    return (int)cudaErrorMisalignedAddress;
  const LayerArgs a{
      (const bf16*)x, (const int8_t*)qkv_q, (const float*)qkv_s, (const float*)g1,
      (const int*)pos, k_cache, v_cache, (const float*)k_scale, (const float*)v_scale,
      (const int8_t*)wo_q, (const float*)wo_s, (const int8_t*)w13_q, (const float*)w13_s,
      (const int8_t*)w2_q, (const float*)w2_s, (const float*)g2, (bf16*)out, (bf16*)xn_ws,
      (bf16*)qkv_ws, (bf16*)att_ws, (bf16*)x2_ws, (bf16*)hb_ws, (float*)part_ws,
      (unsigned int*)bar_ws, B, D, H, KVH, S, HS, L, layer, hidden, gs_qkv, gs_o, gs13, gs2,
      split_q, split_o, split13, split2, bk, attention_chunk(HS, H / KVH, bk, kv_int8), kv_int8,
      (float)(1.0 / sqrt((double)HS)), rope_coef, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return B <= 8 ? launch_layer<8>(a, st) : launch_layer<16>(a, st);
}

// The CTAs an SM that q8_layer_fused's grid is sized from at B rows, H
// query and KVH KV heads of head size HS and a block of bk rows on an int8
// (kv_int8 1) or bf16 cache: the card's occupancy at the kernel's shared
// memory (layer_smem); a negative CUDA error code where it fails
extern "C" int q8_layer_ctas_per_sm(int B, int H, int KVH, int HS, int bk, int kv_int8) {
  if (B < 1 || B > 16 || KVH < 1 || H % KVH || bk < 1 || hipllama::decode_hs_pad(HS) == 0)
    return -(int)cudaErrorInvalidValue;
  LayerArgs a{};
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.HS = HS;
  a.bk = bk;
  a.bc = attention_chunk(HS, H / KVH, bk, kv_int8);
  a.kv_int8 = kv_int8;
  int per_sm = 0;
  const cudaError_t e = B <= 8 ? layer_ctas_per_sm<8>(layer_smem<8>(a), per_sm)
                               : layer_ctas_per_sm<16>(layer_smem<16>(a), per_sm);
  return e == cudaSuccess ? per_sm : -(int)e;
}
