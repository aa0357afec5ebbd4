// The `a8` (w8a8, w4a8) tiles of K15, K17, K21 and K22 above 16 rows, on
// int8 wgmma: the arithmetic of a8.cuh's tiled path (hip_llama_tpu/ops/
// quant.py::_q8_kernel :250-296, _q8_kernel_silu :541-585; quant4.py::
// _q4_kernel :218-234, _q4_kernel_silu :494-517) at group sizes that are
// multiples of 32, so that no 32-deep int8 product straddles a group.
// quant.cu's q8_matmul_a8 and q8_matmul_silu_a8 launch a8_tile_kernel for a
// Q8_0 weight (and K20's `a8` branch through them); quant4.cu's
// q4_matmul_a8 and q4_matmul_silu_a8 launch a8_plane_kernel for an int4
// weight. Other group sizes stay on a8.cuh's a8_mma_kernel.
//
// An int4 weight is a policy of the same loop (kBits 4), not a copy of it:
// a CTA walks one nibble plane (blockIdx.x's low bit), the plane's half of
// the contraction, as a Q8_0 CTA walks K: xi's and sx's columns and s's
// rows from the plane's start, at the full rows' strides; the raw weight
// rows are q's packed bytes, which the transposition turns into the
// plane's int8 codes (plane_codes) before its byte permutes. The plane's
// fp32 sum goes to a workspace part (2, M, N) (store_plane), and the split
// pass that the GEMV path uses (matmul_passes.cuh, planes 2, split 1) adds
// the low plane's sum and the high plane's, (0 + lo) + hi, then runs the
// epilogue or gate: a8_mma_kernel's lo + hi and its store_pair, so the
// outputs are its outputs bit for bit. Two planes double the CTAs where
// the grid is thin (M 256: QKV 384 CTAs, the gate 688). The pass costs
// 8-10% of the tiles' time (QKV M 256: 0.016 of 0.160 ms, the gate 0.025
// of 0.317; PERF.md), so no cluster along the planes trades it for
// distributed shared memory.
//
// Bound on an H100: at M 2048 a product does 2M operations per weight byte,
// far above the ridge, so the int8 tensor-core rate would bound it (1979
// TOP/s, which only wgmma reaches: 0.104 ms for QKV); the group rescale
// comes first: each group's int32 sums become fp32 as acc = fma(f32(sum) *
// sx[m], s[n], acc), three fp32-pipe instructions an output element a
// group, M N K / gs of them (at gs 64, 2.4x the element operations of the
// reshape tiles' dequantization at M 2048, and 1.5x the tensor time of the
// group's products), then the copies from L2 (16 KB of xi and 16 KB of
// weight a 128-deep step of a 128 x 128 tile). The design:
//  - a CTA computes 128 rows (xi, the quantized activations, K-major int8)
//    of 128 B tile columns (for the gate, 64 columns of W1 beside the same
//    64 of W3, q8_wgmma.cuh's `Weight`) with three warpgroups: two
//    consumers, each issuing wgmma.mma_async m64n128k32.s32.s8.s8 on its
//    m64 block, and one producer; setmaxnreg moves registers to the
//    consumers, which hold two int32 sum sets and the fp32 accumulator;
//  - the producer walks K in steps of 128 (one 128-byte int8 row, the 128B
//    swizzle atom) through a ring of kStages stages by cp.async, each stage
//    the xi tile (swizzled K-major), the raw weight rows (128 k x 128
//    columns, N-contiguous as in memory), the scale rows s and the sx
//    columns of the groups the step touches (at most 4); copies past K and
//    M are zero-filled; `full` counts each producer thread's copies as they
//    land (cp.async.mbarrier.arrive.noinc), `empty` frees a stage as soon
//    as its step's products have completed and its groups are rescaled;
//  - s8 wgmma reads both operands K-major, so the consumers transpose the
//    next step's raw weight into a K-major, 128B-swizzled int8 B tile by
//    byte permutes (a8::transpose4) while the current step's first
//    products run: each thread takes 16 k of 4 columns, 16 conflict-free
//    32-bit loads and four conflict-free 16-byte stores;
//  - a step's products are runs of k32 wgmmas, each run the part of one
//    group within the step, committed as one wgmma group, the first of a
//    group with scale-d 0 so that its int32 sums start from zero; the
//    groups alternate between the two sum sets, so that a group's rescale
//    runs (after wgmma.wait_group 1) while the next group's products are in
//    flight; which set a group takes is fixed by the code path, not by a
//    register index, so ptxas sees every set's pending products;
//  - the int32 sums are exact in any order and the rescale rounds as
//    a8.cuh's close_group after nvcc's contraction, groups in order, so the
//    outputs equal a8_mma_kernel's bit for bit; the epilogues are the
//    bf16 tiles' (q8_wgmma.cuh::store_tile with the RoPE table, store_gate);
//  - the grid takes the row tiles of a column tile together (blockIdx.x
//    over M), so that a wave reads a few column tiles of the weight with
//    the whole of xi, which stay in L2.
// Where the time goes (QKV M 2048, PERF.md): the copies alone take about
// 0.32 ms of the tiles' 0.75, the loop without copies about 0.67: its
// rescale and its products run mostly in series rather than beside each
// other, and about 0.08 ms goes to each CTA's set-up, fill and drain. The
// int4 planes at gs 32 (every k32 product closes a group) take about the
// Q8_0 tiles' time a group, not a step: 3.3 us a 128-deep step at QKV M
// 256, of which the rescale's arithmetic is about a tenth (PERF.md).
// Tried and slower: separate rings for xi and the weight
// (deeper), an mbarrier hand-over of the B tiles in place of the
// consumers' barrier, sum sets of 64 columns (n64 wgmmas), four consumer
// warpgroups of one m64 x n64 block each, a persistent grid (its registers
// spill), the transposition's stores in 8-byte halves.
// f32(sum) is I2F (I2FP on sm_90): it timed faster than the integer add
// into the mantissa of 1.5 x 2^23, for Q8_0 at gs 64 and for the int4
// planes at gs 32 (PERF.md).
#pragma once

#include <stdint.h>

#include "a8.cuh"
#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"
#include "q8_wgmma.cuh"

namespace hipllama {
namespace a8wg {

namespace wg = hipllama::q8wg;
using q8::bf16;

constexpr int kBM = 128;                 // rows per CTA: one m64 block per consumer
constexpr int kBN = 128;                 // B tile columns per CTA: the wgmma's n
constexpr int kBK = 128;                 // k per step: a 128-byte int8 row
constexpr int kUnit = 32;                // k per wgmma
constexpr int kStepUnits = kBK / kUnit;  // wgmmas a step; also the most groups it touches
constexpr int kStages = 4;
constexpr int kBTiles = 3;  // int8 B tiles: the step's, the last step's last run, the next
constexpr int kXBytes = kBM * kBK;
constexpr int kRawBytes = kBK * kBN;
constexpr int kBTileBytes = kBN * kBK;
constexpr int kScaleBytes = kStepUnits * kBN * 4;  // s rows of the step's groups
constexpr int kSxBytes = kStepUnits * kBM * 4;     // sx columns of the step's groups
constexpr int kSmemBytes = 1024 + kStages * (kXBytes + kRawBytes + kScaleBytes + kSxBytes) +
                           kBTiles * kBTileBytes + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "the ring fits an SM's shared memory");

// the registers of a CTA's 384 threads: 168 each at launch (wg::prepare
// checks), then 40 for the producer and 232 for the consumers, whose two
// int32 sum sets and fp32 accumulator take 192. ptxas -v (CUDA 12.8,
// tools/ab_trees.py sass): a8_tile_kernel's two instantiations 168
// registers, 4 bytes of spill stores and 12 of spill loads, stack frame 40
// bytes (GATE false) and 8 (GATE true); a8_plane_kernel's 168 registers,
// 24 and 28 bytes of spill stores and loads (stack 24 and 32 bytes)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= wg::kLaunchRegs * wg::kThreads,
              "the consumers take what the producer gives back");

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

struct Ring {
  uint32_t x0, b0, raw0, sc0, sx0, full0, empty0;  // shared addresses
  __device__ __forceinline__ uint32_t x(int st) const { return x0 + st * kXBytes; }
  __device__ __forceinline__ uint32_t b(int bt) const { return b0 + bt * kBTileBytes; }
  __device__ __forceinline__ uint32_t raw(int st) const { return raw0 + st * kRawBytes; }
  __device__ __forceinline__ uint32_t scales(int st) const { return sc0 + st * kScaleBytes; }
  __device__ __forceinline__ uint32_t sxs(int st) const { return sx0 + st * kSxBytes; }
  __device__ __forceinline__ uint32_t full(int st) const { return full0 + st * 8; }
  __device__ __forceinline__ uint32_t empty(int st) const { return empty0 + st * 8; }
};

// the ring in dynamic shared memory: the xi tiles and the B tiles first
// (1024-byte aligned, the swizzle atom), then the raw weight rows, the
// scales and the barriers; every thread calls it (it ends in __syncthreads)
__device__ __forceinline__ Ring ring_init(unsigned char* smem) {
  const uint32_t base = (wg::smem_u32(smem) + 1023u) & ~1023u;
  Ring r;
  r.x0 = base;
  r.b0 = base + kStages * kXBytes;
  r.raw0 = r.b0 + kBTiles * kBTileBytes;
  r.sc0 = r.raw0 + kStages * kRawBytes;
  r.sx0 = r.sc0 + kStages * kScaleBytes;
  r.full0 = r.sx0 + kStages * kSxBytes;
  r.empty0 = r.full0 + kStages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(r.full(s), 128);                   // the producer's threads
      wg::mbar_init(r.empty(s), 128 * wg::kConsumers);  // the consumers' threads
    }
  }
  __syncthreads();
  return r;
}

// byte offset of 16-column chunk cc of raw weight row k: the chunk index
// XOR the row's 16-row block, so that the transposing warp's loads (8 row
// blocks x 4 words of one chunk) hit 32 banks
__device__ __forceinline__ uint32_t raw_at(int k, int cc) {
  return (uint32_t)(k * 128 + ((cc ^ ((k >> 4) & 7)) << 4));
}

// 4 bytes from global to shared, zeros where !live
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

// The producer warpgroup's loop over the n_steps steps of K: once `empty`
// frees step it's stage, the copies of xi's tile (rows m0 .., k0 = 128 it
// ..), the weight's raw rows k0 .. (raw_at's layout), the s rows of the
// groups g0 = k0 / gs .. that the step touches (ring row g - g0, the B
// tile's columns) and the sx columns of those groups (ring row g - g0, the
// CTA's rows); `full` counts each thread's copies as they land. pt: the
// thread's index in its warpgroup. kBits 4 (an int4 weight, one nibble
// plane a CTA): K is the plane's half of the contraction, xi, sx and w.s
// point at the plane's first column, group and scale row, and xi's and
// sx's rows are twice K and K / gs long; w.q's K packed rows are copied
// whole, both nibbles, as a Q8_0 weight's rows are.
template <int kHalf, int kBits = 8>
__device__ __forceinline__ void produce(const Ring& ring, const int8_t* __restrict__ xi,
                                        const float* __restrict__ sx,
                                        const wg::Weight<kHalf>& w, int m0, int M, int K,
                                        int n_steps, int pt) {
  constexpr int kPlanes = kBits == 8 ? 1 : 2;
  const int G = K / w.gs;
  const int ldx = kPlanes * K, ldsx = kPlanes * G;  // the row strides of xi and sx
  const bool row_live = m0 + pt < M;
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kStages, k0 = it * kBK;
    if (it >= kStages) wg::mbar_wait(ring.empty(st), ((it / kStages) & 1) ^ 1);
#pragma unroll
    for (int i = 0; i < kBM * 8 / 128; ++i) {  // xi: 128 rows of 8 chunks
      const int e = pt + 128 * i, r = e >> 3, c = e & 7;
      const bool live = m0 + r < M && k0 + 16 * c < K;
      wg::cp_async16(ring.x(st) + wg::swz128(r, c),
                     xi + (live ? (size_t)(m0 + r) * ldx + k0 + 16 * c : 0), live);
    }
#pragma unroll
    for (int i = 0; i < kBK * 8 / 128; ++i) {  // q: 128 rows of 8 chunks of 16 columns
      const int e = pt + 128 * i, r = e >> 3, c = e & 7;
      const bool live = w.live(16 * c) && k0 + r < K;
      wg::cp_async16(ring.raw(st) + raw_at(r, c),
                     w.q + (live ? (size_t)(k0 + r) * w.ldq + w.col(16 * c) : 0), live);
    }
    const int g0 = k0 / w.gs, ng = (min(K, k0 + kBK) - 1) / w.gs - g0 + 1;
    {  // s: ng rows of 32 chunks of 4 columns
      const int g = pt >> 5, c = pt & 31;
      const bool live = w.live(4 * c);
      if (g < ng)
        wg::cp_async16(ring.scales(st) + g * (kBN * 4) + c * 16,
                       w.s + (size_t)(g0 + g) * w.ldq + (live ? w.col(4 * c) : 0), live);
    }
#pragma unroll
    for (int g = 0; g < kStepUnits; ++g)  // sx: row pt's ng groups
      if (g < ng)
        cp_async4(ring.sxs(st) + g * (kBM * 4) + pt * 4,
                  sx + (row_live ? (size_t)(m0 + pt) * ldsx + g0 + g : 0), row_live);
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(ring.full(st))
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the int8 codes of nibble plane `plane` (0: the low nibbles, 1: the high)
// of four packed int4 bytes, each nibble code + 8: nibble + 0x78 in each
// byte (no carry leaves it), the top bit flipped, which is nibble - 8 in
// two's complement (a8.cuh's nib_codes, in four instructions)
__device__ __forceinline__ uint32_t plane_codes(uint32_t w, int plane) {
  return (((w >> (4 * plane)) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// Consumer thread ct (0 .. 255) transposes its share of stage st's raw
// weight rows into B tile bt (K-major: B row n holds column n's 128 k,
// 16-byte chunk c its k 16 c .. 16 c + 15, swizzled): k rows 16 c .. 16 c +
// 15 (c = lane % 8) of the 4 columns n = 16 w + 4 a .. + 3 (w: the warp of
// the two consumer warpgroups, a = lane / 8). A warp's loads of a row hit
// 32 banks (raw_at); the 8 threads of a store phase write the 8 chunks of
// one B row. kBits 4: each loaded word of packed int4 bytes becomes the
// int8 codes of the CTA's nibble plane first (plane_codes).
template <int kBits = 8>
__device__ __forceinline__ void transpose_step(const Ring& ring, int st, int bt, int ct,
                                               int plane) {
  const int lane = ct & 31, w = ct >> 5, c = lane & 7, a = lane >> 3;
  const int n = 16 * w + 4 * a;
  const uint32_t src = ring.raw(st) + ((w ^ c) << 4) + 4 * a + 16 * c * 128;
  uint32_t col[4][4];  // col[j][h]: column n + j's k 16 c + 4 h .. + 3, k-major in its bytes
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    uint32_t r[4], t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(r[i])
                   : "r"(src + (4 * h + i) * 128)
                   : "memory");
    if constexpr (kBits == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = plane_codes(r[i], plane);
    }
    hipllama::a8::transpose4(r, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j][h] = t[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     ring.b(bt) + (n + j) * 128 + ((c ^ ((n + j) & 7)) << 4)),
                 "r"(col[j][0]), "r"(col[j][1]), "r"(col[j][2]), "r"(col[j][3])
                 : "memory");
  // the generic-proxy stores become visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A (64 x 32 int8, desc a) * B (32 x 128 int8, desc b) in int32; d
// is overwritten where scale_d is 0. d's layout is the bf16 wgmma's
// (q8_wgmma.cuh::wgmma_m64n128).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n\t}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// one run: len (1-4) k32 products of A at desc a, B at desc b (32 bytes, +2
// in a descriptor, a product) into d, the first overwriting d where fresh;
// committed as one wgmma group, its products in one straight line
__device__ __forceinline__ void issue_run(int (&d)[64], uint64_t a, uint64_t b, int len,
                                          bool fresh) {
  const int sd = fresh ? 0 : 1;
  wg::wg_fence();
  switch (len) {
    case 4:
      wgmma_s8(d, a, b, sd);
      wgmma_s8(d, a + 2, b + 2, 1);
      wgmma_s8(d, a + 4, b + 4, 1);
      wgmma_s8(d, a + 6, b + 6, 1);
      break;
    case 3:
      wgmma_s8(d, a, b, sd);
      wgmma_s8(d, a + 2, b + 2, 1);
      wgmma_s8(d, a + 4, b + 4, 1);
      break;
    case 2:
      wgmma_s8(d, a, b, sd);
      wgmma_s8(d, a + 2, b + 2, 1);
      break;
    default:
      wgmma_s8(d, a, b, sd);
  }
  wg::wg_commit();
}

// no read of the sums may move above the wait that completed them
__device__ __forceinline__ void fence_sums(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// acc += (f32(d) * sx[row]) * s[col] for a completed group: s at the ring's
// shared address sc (the group's row of B tile columns), sx at sxa (its
// column of the CTA's rows); thread t of consumer c holds rows 64 c + 16 (t
// / 32) + (t % 32) / 4 (+ 8) and columns 8 i + 2 (t % 4) (+ 1) of n8 tile i
__device__ __forceinline__ void rescale(float (&acc)[64], const int (&d)[64], uint32_t sc,
                                        uint32_t sxa, int c, int t) {
  const int row = 64 * c + 16 * (t >> 5) + ((t & 31) >> 2);
  float sx0, sx1;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(sx0) : "r"(sxa + 4 * row) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(sx1) : "r"(sxa + 4 * (row + 8)) : "memory");
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    float s0, s1;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(s0), "=f"(s1)
                 : "r"(sc + 4 * (8 * i + 2 * (t & 3)))
                 : "memory");
    acc[4 * i] = __fmaf_rn(__fmul_rn(__int2float_rn(d[4 * i]), sx0), s0, acc[4 * i]);
    acc[4 * i + 1] = __fmaf_rn(__fmul_rn(__int2float_rn(d[4 * i + 1]), sx0), s1, acc[4 * i + 1]);
    acc[4 * i + 2] = __fmaf_rn(__fmul_rn(__int2float_rn(d[4 * i + 2]), sx1), s0, acc[4 * i + 2]);
    acc[4 * i + 3] = __fmaf_rn(__fmul_rn(__int2float_rn(d[4 * i + 3]), sx1), s1, acc[4 * i + 3]);
  }
}

// where a consumer is in K: step it, unit u (k = 128 it + 32 u), g0 the
// first group step it touches (its ring row 0); the stage and first group
// of the step of the last run of the group whose rescale is pending
struct Cursor {
  int it, u, g0, pend_st, pend_g0;
};

// Group g's runs into the sum set `cur`: each run up to the group's end or
// the step's end, committed, then wgmma.wait_group 1, so that everything
// but this run has completed: after the group's first run the previous
// group's sums (`prev`, where has_prev) are rescaled from the ring row of
// the step of its last run; after a step's first run (and that rescale)
// step it - 1's products have completed and its groups are rescaled, so
// the consumer frees its stage, then transposes the next step's raw weight
// into B tile (it + 1) % 3. At a step's end it meets the other consumer at
// the barrier, which joins the halves of the next B tile; tile (it + 2) %
// 3, the next to be written, was last read by step it - 1, whose products
// have completed in both warpgroups.
template <int kBits = 8>
__device__ __forceinline__ void group(const Ring& ring, Cursor& cu, int g, int (&cur)[64],
                                      int (&prev)[64], bool has_prev, int K, int gs, int n_steps,
                                      int c, int t, float (&acc)[64], int plane) {
  const int ct = 128 * c + t;
  const int kend = (g + 1) * gs;
  int k = kBK * cu.it + kUnit * cu.u;
  bool first = true;
  do {
    const int st = cu.it % kStages;
    const int len = min(kStepUnits - cu.u, (kend - k) / kUnit);
    issue_run(cur, wg::wg_desc(ring.x(st) + c * 64 * kBK) + 2 * cu.u,
              wg::wg_desc(ring.b(cu.it % kBTiles)) + 2 * cu.u, len, first);
    wg::wg_wait<1>();
    if (first && has_prev) {
      fence_sums(prev);
      const int gi = g - 1 - cu.pend_g0;
      rescale(acc, prev, ring.scales(cu.pend_st) + gi * (kBN * 4),
                      ring.sxs(cu.pend_st) + gi * (kBM * 4), c, t);
    }
    if (cu.u == 0) {
      if (cu.it > 0) wg::mbar_arrive(ring.empty((cu.it - 1) % kStages));
      if (cu.it + 1 < n_steps) {
        wg::mbar_wait(ring.full((cu.it + 1) % kStages), ((cu.it + 1) / kStages) & 1);
        transpose_step<kBits>(ring, (cu.it + 1) % kStages, (cu.it + 1) % kBTiles, ct, plane);
      }
    }
    first = false;
    cu.pend_st = st;
    cu.pend_g0 = cu.g0;
    cu.u += len;
    k += kUnit * len;
    if (cu.u == kStepUnits || k == K) {
      wg::consumers_sync();
      ++cu.it;
      cu.u = 0;
      cu.g0 = k / gs;
    }
  } while (k < kend);
}

// The consumer warpgroups' loop over K's groups (G = K / gs), even groups
// into sum set d0 and odd ones into d1, then the last group's rescale; acc
// holds the fp32 product on return (kBits 4: nibble plane `plane`'s, K its
// half of the contraction).
template <int kBits = 8>
__device__ __forceinline__ void consume(const Ring& ring, int K, int gs, int n_steps, int c,
                                        int t, float (&acc)[64], int plane) {
  int d0[64], d1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d0[i] = 0;
    d1[i] = 0;
    acc[i] = 0.f;
  }
  wg::mbar_wait(ring.full(0), 0);
  transpose_step<kBits>(ring, 0, 0, 128 * c + t, plane);
  wg::consumers_sync();
  const int G = K / gs;
  Cursor cu{0, 0, 0, 0, 0};
  for (int g = 0; g < G; g += 2) {
    group<kBits>(ring, cu, g, d0, d1, g > 0, K, gs, n_steps, c, t, acc, plane);
    if (g + 1 < G) group<kBits>(ring, cu, g + 1, d1, d0, true, K, gs, n_steps, c, t, acc, plane);
  }
  wg::wg_wait<0>();
  const int gi = G - 1 - cu.pend_g0;
  const uint32_t sc = ring.scales(cu.pend_st) + gi * (kBN * 4);
  const uint32_t sxa = ring.sxs(cu.pend_st) + gi * (kBM * 4);
  if ((G - 1) & 1) {
    fence_sums(d1);
    rescale(acc, d1, sc, sxa, c, t);
  } else {
    fence_sums(d0);
    rescale(acc, d0, sc, sxa, c, t);
  }
}

// An int4 CTA's epilogue: consumer c's fp32 sums of its 64 rows (m0 + 64 c
// ..) of the B tile's 128 columns into nibble plane `plane` of part (2, M,
// w.ldq), tile column n at weight column w.col(n) (the gate's W3 half at
// off2 = H, so that part's rows are the W1|W3 product's); thread t holds
// rows 16 (t / 32) + (t % 32) / 4 (+ 8) and column pairs 8 i + 2 (t % 4) of
// n8 tile i, a float2 each
template <int kHalf>
__device__ __forceinline__ void store_plane(const float (&acc)[64], const wg::Weight<kHalf>& w,
                                            int m0, int M, int plane, int c, int t,
                                            float* __restrict__ part) {
  const int row = m0 + 64 * c + 16 * (t >> 5) + ((t & 31) >> 2);
  float* base = part + ((size_t)plane * M + row) * w.ldq;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = 8 * i + 2 * (t & 3);
    if (w.live(n)) {
      const int col = w.col(n);
      if (row < M)
        *reinterpret_cast<float2*>(base + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(base + 8 * (size_t)w.ldq + col) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

}  // namespace a8wg
}  // namespace hipllama

namespace {

namespace a8wg = hipllama::a8wg;

// y = xi-rows' `a8` product with the weight (q, s), through the epilogue
// (GATE: the gate; B tile columns 0-63 are W1 columns n0 .., 64-127 the
// same of W3 at off2 = H, ncols = H). xi (M, K) int8, sx (M, K / gs) fp32.
// kBits 8, a Q8_0 weight (a8_tile_kernel): q (K, ldq) int8, s (K / gs,
// ldq) fp32; blockIdx.x is the row tile, blockIdx.y the column tile, out
// (M, ncols) bf16. kBits 4, an int4 weight packed half-split as quant4.cu's
// (a8_plane_kernel): q (K / 2, ldq), s (K / gs, ldq); blockIdx.x is twice
// the row tile plus the nibble plane p, whose CTA walks the plane's half of
// the contraction (xi's columns p K / 2 .., sx's groups p K / (2 gs) ..,
// s's rows the same, q's nibbles p) as a Q8_0 CTA walks K, and writes its
// fp32 sum to plane p of out = part (2, M, ldq), e unused: a second pass
// adds the low plane's sum and the high plane's, as a8_mma_kernel does,
// and applies the epilogue or gate.
template <bool GATE, int kBits, typename Out>
__device__ __forceinline__ void a8_tiles(const int8_t* __restrict__ xi,
                                         const float* __restrict__ sx,
                                         const int8_t* __restrict__ q,
                                         const float* __restrict__ s, int M, int K, int ldq,
                                         int ncols, int off2, int gs,
                                         const hipllama::q8::Epilogue& e, Out* __restrict__ out) {
  namespace wg = hipllama::q8wg;
  constexpr int kHalf = GATE ? a8wg::kBN / 2 : a8wg::kBN;
  constexpr int kPlanes = kBits == 8 ? 1 : 2;
  extern __shared__ __align__(1024) unsigned char a8_tile_smem[];
  const a8wg::Ring ring = a8wg::ring_init(a8_tile_smem);
  const int plane = blockIdx.x % kPlanes, kw = K / kPlanes;  // the plane's K
  const int m0 = blockIdx.x / kPlanes * a8wg::kBM, n0 = blockIdx.y * kHalf;
  const int role = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int n_steps = (kw + a8wg::kBK - 1) / a8wg::kBK;
  const int gp = plane * (kw / gs);  // the plane's first group
  const wg::Weight<kHalf> w{q, s + (size_t)gp * ldq, ldq, n0, ncols, off2, gs};
  if (role == wg::kConsumers) {
    a8wg::producer_regs();
    a8wg::produce<kHalf, kBits>(ring, xi + plane * kw, sx + gp, w, m0, M, kw, n_steps, t);
  } else {
    a8wg::consumer_regs();
    float acc[1][64];
    a8wg::consume<kBits>(ring, kw, gs, n_steps, role, t, acc[0], plane);
    if constexpr (kBits == 4)
      a8wg::store_plane(acc[0], w, m0, M, plane, role, t, out);
    else if (GATE)
      wg::store_gate(acc, m0, n0, M, ncols, role, t, out);
    else
      wg::store_tile(acc, e, m0, n0, M, ncols, role, t, out);
  }
}

template <bool GATE>
__global__ void __launch_bounds__(hipllama::q8wg::kThreads, 1) a8_tile_kernel(
    const int8_t* __restrict__ xi, const float* __restrict__ sx, const int8_t* __restrict__ q,
    const float* __restrict__ s, int M, int K, int ldq, int ncols, int off2, int gs,
    hipllama::q8::Epilogue e, a8wg::bf16* __restrict__ out) {
  a8_tiles<GATE, 8>(xi, sx, q, s, M, K, ldq, ncols, off2, gs, e, out);
}

template <bool GATE>
__global__ void __launch_bounds__(hipllama::q8wg::kThreads, 1) a8_plane_kernel(
    const int8_t* __restrict__ xi, const float* __restrict__ sx, const int8_t* __restrict__ q,
    const float* __restrict__ s, int M, int K, int ldq, int ncols, int off2, int gs,
    float* __restrict__ part) {
  a8_tiles<GATE, 4>(xi, sx, q, s, M, K, ldq, ncols, off2, gs, hipllama::q8::Epilogue{}, part);
}

// the `a8` tiles: gs a multiple of 32 dividing K (int4: K / 2), ncols and
// ldq multiples of 16; out (M, ncols) bf16 through the epilogue e, or for
// an int4 weight (kBits 4) part (2, M, ldq) fp32, the nibble planes' sums
template <bool GATE, int kBits = 8>
int launch_a8_tiles(const void* xi, const void* sx, const void* q, const void* s, int M, int K,
                    int ldq, int ncols, int off2, int gs, const hipllama::q8::Epilogue& e,
                    void* out, cudaStream_t st) {
  constexpr int kPlanes = kBits == 8 ? 1 : 2;
  if (M < 1 || gs < 32 || gs % 32 || K % (kPlanes * gs) || ncols % 16 || ldq % 16)
    return (int)cudaErrorInvalidValue;
  constexpr int kHalf = GATE ? a8wg::kBN / 2 : a8wg::kBN;
  const dim3 grid(kPlanes * ((M + a8wg::kBM - 1) / a8wg::kBM), (ncols + kHalf - 1) / kHalf);
  if constexpr (kBits == 8) {
    static const int ready = hipllama::q8wg::prepare(a8_tile_kernel<GATE>, a8wg::kSmemBytes);
    HIPLLAMA_TRY(ready);
    a8_tile_kernel<GATE><<<grid, hipllama::q8wg::kThreads, a8wg::kSmemBytes, st>>>(
        (const int8_t*)xi, (const float*)sx, (const int8_t*)q, (const float*)s, M, K, ldq,
        ncols, off2, gs, e, (a8wg::bf16*)out);
  } else {
    static const int ready = hipllama::q8wg::prepare(a8_plane_kernel<GATE>, a8wg::kSmemBytes);
    HIPLLAMA_TRY(ready);
    a8_plane_kernel<GATE><<<grid, hipllama::q8wg::kThreads, a8wg::kSmemBytes, st>>>(
        (const int8_t*)xi, (const float*)sx, (const int8_t*)q, (const float*)s, M, K, ldq,
        ncols, off2, gs, (float*)out);
  }
  return check_launch();
}

}  // namespace
