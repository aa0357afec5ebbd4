// A pipelined, dequantizing wgmma mainloop for Q8_0 and int4 products at
// prefill M, in K15's reshape arithmetic (q8.cuh) and K21's `dequant` one,
// which are the same: w = bf16(f32(code) * s), bf16 x bf16 products summed in
// fp32. The weight's format is a template policy (`Weight<kHalf, kBits>`:
// the producer's weight and scale copies and the dequantization follow it;
// the ring, the B tiles, the wgmmas and the epilogues do not). The tiles at
// the end of this file (q8_tile_kernel, 256 rows a CTA: K15's q8_matmul and
// K17's q8_matmul_silu above 16 rows in quant.cu, K19's q8_matmul_minner and
// q8_matmul_silu_minner in prefill.cu, K21's q4_matmul and K22's
// q4_matmul_silu above 16 rows in quant4.cu) and prefill.cu's
// q8_matmul_xheads (K16, 128 rows a CTA) run it.
//
// Bound on an H100: at M 2048 a product does 2M flops per weight byte, far
// above the ~295 flop/byte ridge, so it is bound by operations on the bf16
// tensor cores, which only wgmma drives at their full rate. The weight is
// int8 in memory and wgmma reads B from shared memory in bf16, so each
// weight tile is dequantized into shared memory before its products, once
// per CTA:
//  - a CTA computes kBM = 128 kMB rows of the B tile's 128 columns (for the
//    gate, 64 columns of W1 beside the same 64 of W3) with three
//    warpgroups: two consumers, each issuing wgmma.mma_async m64n128k16 on
//    its kMB m64 blocks of x, and one producer; setmaxnreg moves registers
//    from the producer to the consumers' accumulators;
//  - the producer walks K in steps of kBK = 64 (one 128-byte row of bf16,
//    the 128B swizzle atom) through a ring of kStages stages: the x tile
//    (kBM x 64 bf16, read in place through the caller's address functor) by
//    cp.async into the swizzled K-major layout, the weight tile (64 int8 x
//    128, or int4 32 packed rows of both halves' nibbles x 128; its columns
//    from one or two bases: `Weight`) and, where gs % 8 == 0, its scale
//    rows. cp.async.mbarrier.arrive.noinc has the `full` barrier count each
//    thread's copies as they land, so the producer waits only for free
//    stages. A last step past K % 64 is zero-filled (int4: past K/2 % 32 in
//    each half);
//  - the consumers' 256 threads dequantize step it + 1's tile into the
//    third of three bf16 B tiles while step it - 1's wgmmas run, then issue
//    step it's and wait with wgmma.wait_group 1, so the tensor pipe does not
//    drain within a product: a step waits for all of its products only
//    where the consumer reads its accumulator (K16 at each head's last
//    step; every product at its end);
//  - mbarriers hand the stages over (`full`, `empty`); a named barrier
//    joins the consumers' halves of each B tile.
// What bounds it now (K17 at M 2048 on an H100, timed with parts of the
// loop switched off; PERF.md): the copies alone take about half the
// kernel's time and more than the products would (a 256-row step copies
// 32 KB of x and 8 KB of weight from L2 for 4.2 Mflop), and the products add
// to them rather than hide behind them: beside the three B tiles the ring
// holds four 44 KB stages, two of them held by the consumers, which leaves
// too few copies in flight for L2's latency under this load. Tried and
// slower: 32-deep steps on the 64B swizzle with a 9-stage ring (the steps'
// fixed costs doubled), a deeper copy lag (before the copies were tracked
// by the barrier), 128-row tiles for the tiles (more bytes per flop); on K16
// before this mainloop, x multicast by TMA to a cluster of two CTAs along N,
// x by TMA without the cluster, an N-major B tile.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "matmul_passes.cuh"
#include "q8.cuh"

namespace hipllama {
namespace q8wg {

using q8::bf16;

constexpr int kBN = 128;                // B tile columns per CTA: the wgmma's n
constexpr int kBK = 64;                 // k per stage: a 128-byte bf16 row
constexpr int kBTiles = 3;              // bf16 B tiles: two read by wgmmas in flight, one written
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroups 0, 1 consume; 2 produces
constexpr int kBTileBytes = kBN * kBK * 2;        // a B tile (16 KB)
constexpr int kRawBytes = kBK * kBN;              // a step's int8 weight rows
constexpr int kScaleBytes = 8 * kBN * 4;          // its scale rows (at most 8 groups)

// The tile of x rows: kMB m64 blocks per consumer warpgroup, so kBM = 128
// kMB rows per CTA, and the ring's depth that fits beside them. Dynamic
// shared memory: the ring's x tiles and the B tiles (1024-byte aligned,
// the swizzle atom), the ring's raw weight and scale rows, then the
// barriers; the kernel aligns its base itself (217 KB for kMB 1, 225 KB for
// kMB 2, of the 227 KB a block may take).
template <int kMB>
struct Tile {
  static constexpr int kBM = 128 * kMB;
  static constexpr int kXBytes = kBM * kBK * 2;
  static constexpr int kStages = kMB == 1 ? 6 : 4;
  static constexpr int kSmemBytes = 1024 + kStages * (kXBytes + kRawBytes + kScaleBytes) +
                                    kBTiles * kBTileBytes + 2 * kStages * 8;
  static_assert(kMB == 1 || kMB == 2, "64 or 128 rows per consumer");
  static_assert(kSmemBytes <= 232448, "the ring fits an SM's shared memory");
};

// The registers of a CTA's threads: each starts with kLaunchRegs (65536 /
// 384, to a multiple of 8; __launch_bounds__(kThreads, 1)), then setmaxnreg
// moves them from the producer, which needs few, to the consumers, whose
// kMB x 64 fp32 accumulators (128 for the 256-row tiles and for K16's two)
// and dequantization do not fit 168 without spilling. An inc blocks until
// the pool has the registers, so the launchers refuse a kernel whose count
// at launch is not kLaunchRegs (prepare).
constexpr int kLaunchRegs = 168;
// 72 for the producer: at 56 its address arithmetic spilled (K17 5% slower)
constexpr int kProducerRegs = 72, kConsumerRegs = 216;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= kLaunchRegs * kThreads,
              "the consumers take what the producer gives back");

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// Once per kernel and process (the launchers keep the result in a static):
// refuse a kernel that does not start its threads with kLaunchRegs
// registers, and let it take smem_bytes of dynamic shared memory. Returns
// cudaSuccess or the error, which every later launch returns too, so that
// a launch makes no driver query on the host.
template <typename Kernel>
inline int prepare(Kernel kernel, int smem_bytes) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  if (fa.numRegs != kLaunchRegs) return (int)cudaErrorInvalidDeviceFunction;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (k / 8) of row r in a 128B-swizzled K-major
// tile of 64 bf16 a row: the chunk index XOR the row's index within its
// 8-row atom, as TMA's SWIZZLE_128B writes it and wgmma reads it
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// byte offset of 16-byte chunk c (columns 16 c ..) of raw weight row r: the
// chunk index XOR the row's 8-row group, so that the dequantizing warp's
// 32-bit loads (8 row groups x 4 words of one chunk) hit 32 banks
__device__ __forceinline__ uint32_t raw_at(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ ((r >> 3) & 7)) << 4));
}

// ---------------------------------------------------------------------------
// barriers and copies

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes from global to shared, zeros where !live
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// a shared-memory matrix descriptor: a K-major tile of 128-byte rows in the
// 128B swizzle, 8-row atoms 1024 bytes apart (SBO); LBO is unused there
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's wgmmas are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulator's registers are written by the asynchronous product: no
// read of them may move above the wait that follows it
__device__ __forceinline__ void wg_fence_regs(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, desc a) * B (16 x 128, desc b): bf16 in, fp32 out; d
// is overwritten where scale_d is 0. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 i + 2 (t % 4) (+ 1) of
// n8 tile i in d[4 i .. 4 i + 3] (row, row; row + 8, row + 8).
__device__ __forceinline__ void wgmma_m64n128(float d[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// One step of a consumer's products, committed as one group: its kMB m64
// blocks of x (block mb at x tile address a + mb * 8 KB) times B tile b,
// four k16 wgmmas each, the blocks' chains interleaved; d[mb] is overwritten
// by its first where `fresh`. Where the consumer has no live row nothing is
// issued; else every block is, those past M multiplying the producer's
// zeros, so that no branch sits between the wgmmas: around one, ptxas
// serializes them (its C7520 note), which cost the 256-row tiles 7-10%
// (PERF.md).
template <int kMB>
__device__ __forceinline__ void wgmma_step(float (&d)[kMB][64], uint32_t a, uint32_t b,
                                           bool fresh, bool live) {
  if (!live) return;
  const uint64_t da = wg_desc(a), db = wg_desc(b);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes a k16 step: +2 in the descriptor
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
      wgmma_m64n128(d[mb], da + mb * (64 * 128 >> 4) + 2 * kk, db + 2 * kk,
                    fresh && kk == 0 ? 0 : 1);
  wg_commit();
}

// ---------------------------------------------------------------------------
// the ring

template <int kMB>
struct Ring {
  using T = Tile<kMB>;
  unsigned char* smem;                      // the generic address of x0
  uint32_t x0, b0, raw0, sc0, full0, empty0;  // shared addresses
  __device__ __forceinline__ uint32_t x(int st) const { return x0 + st * T::kXBytes; }
  __device__ __forceinline__ uint32_t b(int bt) const { return b0 + bt * kBTileBytes; }
  __device__ __forceinline__ uint32_t raw(int st) const { return raw0 + st * kRawBytes; }
  __device__ __forceinline__ uint32_t scales(int st) const { return sc0 + st * kScaleBytes; }
  __device__ __forceinline__ uint32_t full(int st) const { return full0 + st * 8; }
  __device__ __forceinline__ uint32_t empty(int st) const { return empty0 + st * 8; }
};

// lay the ring out in dynamic shared memory and initialize its barriers
// (every thread of the CTA calls it; it ends in __syncthreads)
template <int kMB>
__device__ __forceinline__ Ring<kMB> ring_init(unsigned char* smem) {
  using T = Tile<kMB>;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  Ring<kMB> r;
  r.smem = smem + (base - smem_u32(smem));
  r.x0 = base;
  r.b0 = base + T::kStages * T::kXBytes;
  r.raw0 = r.b0 + kBTiles * kBTileBytes;
  r.sc0 = r.raw0 + T::kStages * kRawBytes;
  r.full0 = r.sc0 + T::kStages * kScaleBytes;
  r.empty0 = r.full0 + T::kStages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(r.full(s), 128);                 // the producer's threads
      mbar_init(r.empty(s), 128 * kConsumers);  // the consumers' threads
    }
  }
  __syncthreads();
  return r;
}

// The weight a CTA's B tile reads, in one of two formats (kBits), each step
// 64 contraction rows of B:
//  - 8, Q8_0: q (K, ldq) int8 and s (K / gs, ldq) fp32, row-major. Step it
//    takes rows k0 = 64 it ..: B row kb is contraction row k0 + kb, and the
//    x tile's 16-byte chunk c holds x's columns k0 + 8 c ..;
//  - 4, int4 packed half-split as quant4.cu's: q (K/2, ldq) int8, byte p
//    holding contraction row p in its low nibble and K/2 + p in its high
//    one, each as code + 8; s (K / gs, ldq) fp32 with (K/2) % gs == 0, so
//    that the high half's groups start at scale row K / (2 gs). Step it
//    takes the packed rows p0 = 32 it .. (kRows: 4 KB of q at 128 columns):
//    B rows 0-31 are their low nibbles (contraction rows p0 ..) and 32-63
//    their high nibbles (K/2 + p0 ..); x chunks 0-3 hold x's columns p0 ..
//    and 4-7 K/2 + p0 ... Each step's products sum the low half and then
//    the high half into one accumulator.
// Both take ceil(K / 64) steps. B tile column n (0 .. 127) is weight column
// n0 + n % kHalf + (n / kHalf) * off2, live where n0 + n % kHalf < ncols:
// with kHalf 128, 128 adjacent columns; with 64, the gate's 64 columns of W1
// from n0 beside the same 64 of W3 at off2 = H.
template <int kHalf, int kBits = 8>
struct Weight {
  static_assert(kBits == 8 || kBits == 4, "Q8_0 bytes or int4 nibbles");
  static constexpr int kRows = kBits == 8 ? kBK : kBK / 2;  // q rows a step
  const int8_t* q;
  const float* s;
  int ldq, n0, ncols, off2, gs;
  __device__ __forceinline__ int col(int n) const { return n0 + n % kHalf + (n / kHalf) * off2; }
  __device__ __forceinline__ bool live(int n) const { return n0 + n % kHalf < ncols; }
};

// B rows 8 c .. 8 c + 7 of step it, which the x tile's 16-byte chunk c
// meets: their first contraction row (x's column), their first row among
// the step's kRows q rows in the ring, and whether they lie in K (all or
// none: K % 16 == 0; for int4 K % 32 == 0, so K/2 % 16 == 0). An int4
// step past K/2 % 32 has dead rows in the middle of both its halves (B rows
// 16-31 and 48-63 where K/2 % 32 == 16).
struct Chunk {
  int k, raw;
  bool in;
};
template <int kBits>
__device__ __forceinline__ Chunk chunk_at(int it, int c, int K) {
  if constexpr (kBits == 8) {
    const int k = it * kBK + 8 * c;
    return {k, 8 * c, k < K};
  } else {
    const int kh = K >> 1, p = it * (kBK / 2) + 8 * (c & 3);
    return {(c >> 2) * kh + p, 8 * (c & 3), p < kh};
  }
}

// The producer warpgroup's loop over the n_steps = ceil(K / 64) steps of K:
// once `empty` says that step it's stage (it % kStages) is free, its copies
// by cp.async: x's tile through x_at(m, k) (the address of x's elements k ..
// k + 7 of row m, 16-byte aligned; zeros past M and K, and for int4 past
// K/2 in each half) into the swizzled x tile, and the weight's kRows q rows
// (raw_at's layout) and their scale rows (int4: the low half's groups in
// ring rows 0-3, the high half's in 4-7); rows past K are left to the
// dequantization. Each thread's cp.async.mbarrier.arrive.noinc has `full`
// count it when its copies of the step have landed, so the producer never
// waits for a copy: it runs as far ahead as the ring's free stages let it.
// pt: the thread's index in its warpgroup.
template <int kMB, int kHalf, int kBits, typename XAt>
__device__ __forceinline__ void produce(const Ring<kMB>& ring, XAt x_at, int m0, int M, int K,
                                        const Weight<kHalf, kBits>& w, int n_steps, int pt) {
  using T = Tile<kMB>;
  using W = Weight<kHalf, kBits>;
  const int qrows = kBits == 8 ? K : K / 2;  // the rows of q
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % T::kStages, k0 = it * W::kRows;
    if (it >= T::kStages) mbar_wait(ring.empty(st), ((it / T::kStages) & 1) ^ 1);
#pragma unroll
    for (int i = 0; i < T::kBM * 8 / 128; ++i) {  // x: kBM rows of 8 chunks
      const int e = pt + 128 * i, r = e >> 3, c = e & 7;
      const Chunk ch = chunk_at<kBits>(it, c, K);
      const bool live = m0 + r < M && ch.in;
      cp_async16(ring.x(st) + swz128(r, c), x_at(live ? m0 + r : m0, live ? ch.k : 0), live);
    }
#pragma unroll
    for (int i = 0; i < W::kRows * 8 / 128; ++i) {  // q: kRows rows of 8 chunks of 16 columns
      const int e = pt + 128 * i, r = e >> 3, c = e & 7;
      const bool live = w.live(16 * c) && k0 + r < qrows;
      cp_async16(ring.raw(st) + raw_at(r, c),
                 w.q + (live ? (size_t)(k0 + r) * w.ldq + w.col(16 * c) : 0), live);
    }
    // s: the groups of q rows k0 .. min(k0 + kRows, qrows) - 1 (at most 8,
    // int4 4 a half, where gs % 8 == 0), 32 chunks of 4 columns each
    const int g0 = k0 / w.gs;
    const int ng = w.gs % 8 ? 0 : (min(k0 + W::kRows, qrows) - 1) / w.gs - g0 + 1;
#pragma unroll
    for (int i = 0; i < 8 * 32 / 128; ++i) {
      const int e = pt + 128 * i, g = e >> 5, c = e & 31;
      const bool live = w.live(4 * c);
      if constexpr (kBits == 8) {
        if (g < ng)
          cp_async16(ring.scales(st) + g * 512 + c * 16,
                     w.s + (size_t)(g0 + g) * w.ldq + (live ? w.col(4 * c) : 0), live);
      } else {  // ring row g: group g0 + g % 4 of half g / 4
        if ((g & 3) < ng)
          cp_async16(ring.scales(st) + g * 512 + c * 16,
                     w.s + (size_t)((g >> 2) * (qrows / w.gs) + g0 + (g & 3)) * w.ldq +
                         (live ? w.col(4 * c) : 0),
                     live);
      }
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(ring.full(st))
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Consumer thread ct (0 .. 255) dequantizes its share of step `it`'s weight
// into B tile bt: w = bf16(f32(q) * s) for the 8 k rows 8 b .. 8 b + 7 (b =
// ct % 8; chunk_at) of the 4 tile columns 16 cw + 4 a .. + 3 (cw = ct / 32,
// a = ct % 32 / 8). It loads the 8 rows' words of its 4 columns (raw_at: a
// warp's loads hit 32 banks; the int4 step's 32 q rows hit 16, each word
// read by the two threads b and b + 4, which take its low and its high
// nibbles: a broadcast) and their 4 scales as one 16-byte word (the 8 rows
// share a group where gs % 8 == 0; else each row's scales are read from
// s), and stores each column's 8 k values as one 16-byte chunk of B row n
// (K-major, swizzled): the 8 threads of a store phase hold the 8 chunks of
// one row. Rows at or past K (the zero-filled tail of the last step) are
// stored as zeros, whatever the ring's scale rows hold there. f32(q): the
// biased byte or the nibble placed in the mantissa of 2^23 (q8::q_to_f,
// q8::nib_to_f).
template <int kMB, int kHalf, int kBits>
__device__ __forceinline__ void dequant_step(const Ring<kMB>& ring, int it, int bt, int K,
                                             const Weight<kHalf, kBits>& w, int ct) {
  const int st = it % Tile<kMB>::kStages, k0 = it * Weight<kHalf, kBits>::kRows;
  const int b = ct & 7, a = (ct >> 3) & 3, cw = ct >> 5;
  const int n = 16 * cw + 4 * a;  // the thread's first tile column
  const uint32_t dst = ring.b(bt);
  const Chunk ch = chunk_at<kBits>(it, b, K);
  if (!ch.in) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst + swz128(n + j, b)),
                   "r"(0u)
                   : "memory");
  } else {
    const unsigned char* raw = ring.smem + (ring.raw(st) - ring.x0);
    uint32_t v[8];  // rows 8 b + r, columns n .. n + 3: biased to q + 128, or nibbles
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(raw + raw_at(ch.raw + r, cw) + 4 * a);
      if constexpr (kBits == 8)
        v[r] = word ^ q8::kBias4;
      else
        v[r] = (word >> (b & 4)) & q8::kLowNibbles;  // b 0-3: low nibbles, 4-7: high
    }
    // the scales of columns n .. n + 3, from the ring's row of the chunk's
    // group (int4: the high half's rows from 4)
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w.gs % 8 == 0)
      sv = *reinterpret_cast<const float4*>(
          ring.smem + (ring.scales(st) - ring.x0) +
          (((k0 + ch.raw) / w.gs - k0 / w.gs + (kBits == 8 ? 0 : 4 * (b >> 2))) * kBN + n) * 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[8];
      if (w.gs % 8 == 0) {
        const float sn = j == 0 ? sv.x : j == 1 ? sv.y : j == 2 ? sv.z : sv.w;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          f[r] = (kBits == 8 ? q8::q_to_f(v[r], j) : q8::nib_to_f(v[r], j)) * sn;
      } else {
        const bool live = w.live(n + j);
        const float* sc = w.s + (live ? w.col(n + j) : 0);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          f[r] = (kBits == 8 ? q8::q_to_f(v[r], j) : q8::nib_to_f(v[r], j)) *
                 (live ? __ldg(sc + (size_t)((ch.k + r) / w.gs) * w.ldq) : 0.f);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + swz128(n + j, b)),
                   "r"(q8::bf16x2_bits(f[0], f[1])), "r"(q8::bf16x2_bits(f[2], f[3])),
                   "r"(q8::bf16x2_bits(f[4], f[5])), "r"(q8::bf16x2_bits(f[6], f[7]))
                   : "memory");
    }
  }
  // the generic-proxy stores (and, seen through `full`, the step's copies)
  // become visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumers' barrier (named barrier 1, both consumer warpgroups)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// The consumer warpgroups' loop over the n_steps steps of K (K and the
// weight as the producer's, for dequant_step); c: the warpgroup (0, 1), t:
// the thread in it; its x rows are m0 + 64 kMB c .., in kMB m64 blocks
// (those at or past M multiply zeros). Step it: dequantize step it + 1's
// weight into B tile (it + 1) % 3 while step it - 1's products run (that
// tile's last reader, step it - 2, completed before the last barrier);
// issue step it's wgmmas (x blocks of the stage times B tile it % 3, into
// d, overwritten by the first where fresh(it)); wait for step it - 1
// (wgmma.wait_group 1), or for step it too where reads(it), which then
// calls step_done(it, d); release step it - 1's stage (its x tile is read;
// its raw rows were two steps ago) and meet at the barrier, which puts B
// tile (it + 1) % 3's halves together and, since both warpgroups have
// waited, frees tile (it + 2) % 3 for the next dequantization. d holds the
// last step's sum on return.
template <int kMB, int kHalf, int kBits, typename Fresh, typename Reads, typename StepDone>
__device__ __forceinline__ void consume(const Ring<kMB>& ring, int n_steps, int K,
                                        const Weight<kHalf, kBits>& w, int m0, int M, int c, int t,
                                        float (&d)[kMB][64], Fresh fresh, Reads reads,
                                        StepDone step_done) {
  using T = Tile<kMB>;
  const int ct = 128 * c + t;
  const int row0 = m0 + 64 * kMB * c;
  const bool live = M > row0;
  mbar_wait(ring.full(0), 0);
  dequant_step(ring, 0, 0, K, w, ct);
  consumers_sync();
  for (int it = 0; it < n_steps; ++it) {
    if (it + 1 < n_steps) {
      mbar_wait(ring.full((it + 1) % T::kStages), ((it + 1) / T::kStages) & 1);
      dequant_step(ring, it + 1, (it + 1) % kBTiles, K, w, ct);
    }
    wgmma_step(d, ring.x(it % T::kStages) + c * kMB * 64 * 128, ring.b(it % kBTiles), fresh(it),
               live);
    if (reads(it)) {
      wg_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) wg_fence_regs(d[mb]);
      step_done(it, d);
    } else {
      wg_wait<1>();
    }
    if (it > 0) mbar_arrive(ring.empty((it - 1) % T::kStages));
    consumers_sync();
  }
  wg_wait<0>();
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) wg_fence_regs(d[mb]);
}

// the epilogue of a consumer's kMB x 64 rows (m0 + 64 kMB c ..) of 128
// columns (n0 ..), through q8.cuh's store_pair (residual, RoPE, one cast);
// a thread's column pair (2 (t % 4), + 1 of each n8 tile) is a RoPE pair
template <int kMB>
__device__ __forceinline__ void store_tile(const float (&d)[kMB][64], const q8::Epilogue& e,
                                           int m0, int n0, int M, int N, int c, int t,
                                           bf16* __restrict__ out) {
  const int col = n0 + 2 * (t & 3);
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    const int row = m0 + 64 * (kMB * c + mb) + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int n = col + 8 * i;
      if (n < N) {
        if (row < M) q8::store_pair(e, row, n, N, d[mb][4 * i], d[mb][4 * i + 1], out);
        if (row + 8 < M)
          q8::store_pair(e, row + 8, n, N, d[mb][4 * i + 2], d[mb][4 * i + 3], out);
      }
    }
  }
}

// the gate epilogue of a consumer's rows over Weight<64> (B columns 0-63:
// W1 columns n0 .., 64-127: the same of W3): n8 tiles i and i + 8 hold h1
// and h3 of one output column in one thread, so out (M, H) = bf16(h1 *
// sigmoid(h1) * h3) from registers, a bf16 pair at a time
template <int kMB>
__device__ __forceinline__ void store_gate(const float (&d)[kMB][64], int m0, int n0, int M,
                                           int H, int c, int t, bf16* __restrict__ out) {
  const int col = n0 + 2 * (t & 3);
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    const int row = m0 + 64 * (kMB * c + mb) + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
    for (int i = 0; i < kBN / 16; ++i) {
      const int n = col + 8 * i;
      const float* h1 = d[mb] + 4 * i;
      const float* h3 = d[mb] + 4 * (i + kBN / 16);
      if (n < H) {
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * H + n) = __floats2bfloat162_rn(
              q8::silu_gate(h1[0], h3[0]), q8::silu_gate(h1[1], h3[1]));
        if (row + 8 < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * H + n) =
              __floats2bfloat162_rn(q8::silu_gate(h1[2], h3[2]), q8::silu_gate(h1[3], h3[3]));
      }
    }
  }
}

}  // namespace q8wg
}  // namespace hipllama

// ---------------------------------------------------------------------------
// the tiles: y = [x's rows] @ dequant(q, s) with the epilogue or the gate in
// the tile's store, K15's and K17's function above 16 rows and K19's. Each
// source keeps its own copy (an anonymous namespace), as matmul_passes.cuh's.

namespace {

namespace wg = hipllama::q8wg;

// A CTA takes kTileMB = 2 m64 blocks per consumer: 256 rows, so that each
// dequantized weight element feeds 256 rows and a step's copies (x 32 KB,
// the weight 8 KB) carry twice the products of a 128-row tile's (16 + 8 KB).
constexpr int kTileMB = 2;
using TileT = wg::Tile<kTileMB>;

// GATE: B tile columns 0-63 are W1 columns n0 .., 64-127 the same of W3 at
// off2 = H (ncols = H), and the gate epilogue; else 128 adjacent columns and
// q8_matmul's epilogue. ldq is the row stride of q and s. kBits: the
// weight's format (Weight): 8, Q8_0 (K15, K17, K19); 4, int4 packed
// half-split (quant4.cu's K21 and K22 above 16 rows).
template <bool GATE, int kBits = 8>
__global__ void __launch_bounds__(wg::kThreads, 1) q8_tile_kernel(
    const wg::bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    int M, int K, int ldq, int ncols, int off2, int gs, hipllama::q8::Epilogue e,
    wg::bf16* __restrict__ out) {
  constexpr int kHalf = GATE ? wg::kBN / 2 : wg::kBN;
  extern __shared__ __align__(1024) unsigned char tile_smem[];
  const wg::Ring<kTileMB> ring = wg::ring_init<kTileMB>(tile_smem);
  const int m0 = blockIdx.y * TileT::kBM, n0 = blockIdx.x * kHalf;
  const int role = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int n_steps = (K + wg::kBK - 1) / wg::kBK;
  const wg::Weight<kHalf, kBits> w{q, s, ldq, n0, ncols, off2, gs};
  if (role == wg::kConsumers) {
    wg::producer_regs();
    wg::produce(ring, [=](int m, int k) { return x + (size_t)m * K + k; }, m0, M, K, w, n_steps,
                t);
  } else {
    wg::consumer_regs();
    float d[kTileMB][64];
#pragma unroll
    for (int mb = 0; mb < kTileMB; ++mb)
#pragma unroll
      for (int i = 0; i < 64; ++i) d[mb][i] = 0.f;
    wg::consume(
        ring, n_steps, K, w, m0, M, role, t, d, [](int it) { return it == 0; },
        [](int) { return false; }, [](int, const float(&)[kTileMB][64]) {});
    if (GATE)
      wg::store_gate(d, m0, n0, M, ncols, role, t, out);
    else
      wg::store_tile(d, e, m0, n0, M, ncols, role, t, out);
  }
}

// The grid of an (M, ncols) product: the column tiles of a row tile
// together (blockIdx.x over N), which timed faster than the row tiles of a
// column tile at the QKV product and tied at K19's shapes (PERF.md).
template <bool GATE>
dim3 tile_grid(int M, int ncols) {
  constexpr int kHalf = GATE ? wg::kBN / 2 : wg::kBN;
  return dim3((ncols + kHalf - 1) / kHalf, (M + TileT::kBM - 1) / TileT::kBM);
}

// K: the contraction's rows (int4: twice q's); K % 16 == 0, gs dividing K
// (int4: K % 32 == 0, gs dividing K/2, so that each half holds whole groups)
template <bool GATE, int kBits = 8>
int launch_tiles(const void* x, const void* q, const void* s, int M, int K, int ldq, int ncols,
                 int off2, int gs, const hipllama::q8::Epilogue& e, void* out, cudaStream_t st) {
  if (M < 1 || K % 16 || ncols % 16 || ldq % 16 || gs < 1 || K % gs ||
      (kBits == 4 && (K % 32 || (K / 2) % gs)))
    return (int)cudaErrorInvalidValue;
  static const int ready = wg::prepare(q8_tile_kernel<GATE, kBits>, TileT::kSmemBytes);
  HIPLLAMA_TRY(ready);
  q8_tile_kernel<GATE, kBits><<<tile_grid<GATE>(M, ncols), wg::kThreads, TileT::kSmemBytes,
                                st>>>(
      (const wg::bf16*)x, (const int8_t*)q, (const float*)s, M, K, ldq, ncols, off2, gs, e,
      (wg::bf16*)out);
  return check_launch();
}

}  // namespace
