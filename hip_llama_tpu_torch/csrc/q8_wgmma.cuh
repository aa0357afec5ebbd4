// A dequantizing wgmma mainloop for Q8_0 products at prefill M, in K15's
// reshape arithmetic (q8.cuh): w = bf16(f32(q) * s), bf16 x bf16 products
// summed in fp32. prefill.cu's q8_matmul_xheads (K16) runs it; it is the
// mainloop the other prefill products (K15's tiles, K17, K19) can take up.
//
// Bound on an H100: at M 2048 a product does 2M flops per weight byte, far
// above the ~295 flop/byte ridge, so it is bound by operations on the bf16
// tensor cores, which only wgmma drives at their full rate. The weight is
// int8 in memory, and wgmma reads B from shared memory in bf16, so a tile
// must be dequantized into shared memory before the product; the design
// does that once per CTA and hides it behind the products:
//  - a CTA computes one kBM x kBN = 128 x 128 output tile with three
//    warpgroups: two consumers, each issuing wgmma.mma_async m64n128k16 on
//    its 64 rows, and one producer;
//  - the producer walks K in steps of kBK = 64 (one 128-byte row of bf16,
//    the 128B swizzle atom) through a ring of kStages stages, with kLag
//    steps of copies in flight: it copies the x tile (128 x 64 bf16, read in
//    place through the caller's address functor) by cp.async into the
//    128B-swizzled K-major layout, with the int8 weight tile (64 x 128) and,
//    where gs % 8 == 0, its scale rows (one per group of gs rows) as they
//    lie; a group size that is no multiple of 8 (groups shorter than a
//    consumer thread's 8 rows, or not aligned to them) has its scales read
//    from global memory by the dequantizing threads, one per row;
//  - the consumers dequantize: while step it's wgmmas run asynchronously,
//    their 256 threads turn step it + 1's int8 tile into the other of two
//    bf16 B tiles, written K-major ([n][k]) in the same swizzle. A single
//    producer warpgroup that also dequantized (one warp per scheduler, its
//    dependent instructions unhidden) took longer than the products;
//  - mbarriers hand the stages over: `full` (each producer thread arrives
//    once its copies of the step have landed, behind a proxy fence, since
//    wgmma reads through the async proxy) and `empty` (the consumers' 256
//    threads arrive once the step's products have completed); a named
//    barrier joins the two halves of each B tile;
//  - each weight element is dequantized once per CTA, ceil(M / 128) times a
//    call (16 at M 2048, against 32 for K15's 64-row tiles).
// What still bounds it (variants timed on an H100 at the 7B wo): not the
// bytes from L2 (x multicast by TMA to a cluster of two CTAs along N, which
// halves them, ran slower, the pair in lock step; x by TMA without the
// cluster ran slower than cp.async too), not the copies' latency
// (a deeper lag gains nothing), not the bank conflicts of the transposing
// dequantization (an N-major B tile, which needs none, ran slower). The
// products alone, with no copy and no dequantization, reach about half the
// tensor cores' rate: each step waits for its wgmmas to drain before the
// two consumers meet at a barrier, and the dequantization of the next tile
// sits between issue and wait. Keeping a step's wgmmas in flight across
// the barrier (wait_group 1 within a head, two B tiles ahead) is the next
// step.
// The consumer decides what a step's product adds to (q8_matmul_xheads: a
// head accumulator from zero at the head's first step, added to the running
// sum in head order at its last).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "q8.cuh"

namespace hipllama {
namespace q8wg {

using q8::bf16;

constexpr int kBM = 128;                // x rows per CTA: 64 per consumer warpgroup
constexpr int kBN = 128;                // output columns per CTA: the wgmma's n
constexpr int kBK = 64;                 // k per stage: a 128-byte bf16 row
constexpr int kStages = 6;              // the ring of copies
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroups 0, 1 consume; 2 produces
constexpr int kTileBytes = kBM * kBK * 2;         // an x or a B tile (16 KB)
static_assert(kBM == kBN, "x and B tiles share one size");

constexpr int kRawBytes = kBK * kBN;         // a step's int8 weight rows
constexpr int kScaleBytes = 8 * kBN * 4;     // its scale rows (at most 8 groups)
// dynamic shared memory: the ring's x tiles and the two B tiles (1024-byte
// aligned, the swizzle atom), the ring's raw weight and scale rows, then
// the barriers; the kernel aligns its base itself
constexpr int kSmemBytes =
    1024 + kStages * (kTileBytes + kRawBytes + kScaleBytes) + 2 * kTileBytes + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (k / 8) of row r in a 128B-swizzled K-major
// tile of 64 bf16 a row: the chunk index XOR the row's index within its
// 8-row atom, as TMA's SWIZZLE_128B writes it and wgmma reads it
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
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
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// ---------------------------------------------------------------------------
// the ring

struct Ring {
  unsigned char* smem;                      // the generic address of x0
  uint32_t x0, b0, raw0, sc0, full0, empty0;  // shared addresses
  __device__ __forceinline__ uint32_t x(int st) const { return x0 + st * kTileBytes; }
  __device__ __forceinline__ uint32_t b(int bt) const { return b0 + bt * kTileBytes; }
  __device__ __forceinline__ uint32_t raw(int st) const { return raw0 + st * kRawBytes; }
  __device__ __forceinline__ uint32_t scales(int st) const { return sc0 + st * kScaleBytes; }
  __device__ __forceinline__ uint32_t full(int st) const { return full0 + st * 8; }
  __device__ __forceinline__ uint32_t empty(int st) const { return empty0 + st * 8; }
};

// lay the ring out in dynamic shared memory and initialize its barriers
// (every thread of the CTA calls it; it ends in __syncthreads)
__device__ __forceinline__ Ring ring_init(unsigned char* smem) {
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  Ring r;
  r.smem = smem + (base - smem_u32(smem));
  r.x0 = base;
  r.b0 = base + kStages * kTileBytes;
  r.raw0 = r.b0 + 2 * kTileBytes;
  r.sc0 = r.raw0 + kStages * kRawBytes;
  r.full0 = r.sc0 + kStages * kScaleBytes;
  r.empty0 = r.full0 + kStages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full(s), 128);                 // the producer's threads
      mbar_init(r.empty(s), 128 * kConsumers);  // the consumers' threads
    }
  }
  __syncthreads();
  return r;
}

// The producer warpgroup's loop over the n_steps steps of K: step it's
// copies (cp.async, into stage it % kStages, once `empty` says the stage is
// free): x's tile through x_at(m, k) (the address of x's elements k .. k + 7
// of row m, 16-byte aligned) into the swizzled x tile, and the weight's 64
// int8 rows and their scale rows as they lie in memory. kLag steps later,
// when its own copies of the step have landed, each thread fences them for
// wgmma's async proxy and arrives on `full`. pt: the thread's index in its
// warpgroup.
constexpr int kLag = 2;  // steps of copies in flight beyond the one landing
static_assert(kLag < kStages, "the copies in flight fit the ring");

template <typename XAt>
__device__ __forceinline__ void produce(const Ring& ring, XAt x_at, int m0, int M,
                                        const int8_t* __restrict__ q,
                                        const float* __restrict__ s, int n0, int N, int gs,
                                        int n_steps, int pt) {
  for (int it = 0; it < n_steps + kLag; ++it) {
    if (it < n_steps) {
      const int st = it % kStages, k0 = it * kBK;
      if (it >= kStages) mbar_wait(ring.empty(st), ((it / kStages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < kBM * 8 / 128; ++i) {  // x: kBM rows of 8 chunks
        const int e = pt + 128 * i, r = e >> 3, c = e & 7;
        const bool live = m0 + r < M;
        cp_async16(ring.x(st) + swz128(r, c), x_at(live ? m0 + r : m0, k0 + 8 * c), live);
      }
#pragma unroll
      for (int i = 0; i < kBK * 8 / 128; ++i) {  // q: kBK rows of 8 chunks of 16 columns
        const int e = pt + 128 * i, r = e >> 3, c = e & 7;
        const bool live = n0 + 16 * c < N;
        cp_async16(ring.raw(st) + r * 128 + c * 16,
                   q + (size_t)(k0 + r) * N + (live ? n0 + 16 * c : 0), live);
      }
      // s: the groups of rows k0 .. k0 + 63 (at most 8 where gs % 8 == 0),
      // 32 chunks of 4 columns each
      const int g0 = k0 / gs, ng = gs % 8 ? 0 : (k0 + kBK - 1) / gs - g0 + 1;
#pragma unroll
      for (int i = 0; i < 8 * 32 / 128; ++i) {
        const int e = pt + 128 * i, g = e >> 5, c = e & 31;
        const bool live = n0 + 4 * c < N;
        if (g < ng)
          cp_async16(ring.scales(st) + g * 512 + c * 16,
                     s + (size_t)(g0 + g) * N + (live ? n0 + 4 * c : 0), live);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int j = it - kLag;
    if (j < 0) continue;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag) : "memory");  // step j's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(ring.full(j % kStages));
  }
}

// Consumer thread ct (0 .. 255) dequantizes its share of step `it`'s weight
// into B tile bt: w = bf16(f32(q) * s) for k rows 8 (ct / 32) .. + 7 and
// tile columns ct % 32 + 32 j, j < 4. Tile column n is B row n, whose chunk
// ct / 32 takes the 8 k values; 8 consecutive threads write 8 consecutive
// rows, so the swizzled stores do not conflict, and the byte loads of a
// warp read whole rows. The 8 rows share one scale where gs % 8 == 0 (from
// the ring); else each row's scale is read from s (N columns from n0).
__device__ __forceinline__ void dequant_step(const Ring& ring, int it, int bt, int gs,
                                             const float* __restrict__ s, int n0, int N,
                                             int ct) {
  const int st = it % kStages, k0 = it * kBK;
  const int kc = ct >> 5, lane = ct & 31;
  const unsigned char* raw = ring.smem + (ring.raw(st) - ring.x0) + 8 * kc * 128;
  const float* sc = reinterpret_cast<const float*>(ring.smem + (ring.scales(st) - ring.x0)) +
                    (gs % 8 ? 0 : ((k0 + 8 * kc) / gs - k0 / gs) * kBN);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = lane + 32 * j;
    float f[8];
    if (gs % 8 == 0) {
      const float sn = sc[n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        f[r] = q8::q_to_f((uint32_t)raw[r * 128 + n] ^ 0x80u, 0) * sn;
    } else {
      const bool live = n0 + n < N;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float sn = live ? __ldg(s + (size_t)((k0 + 8 * kc + r) / gs) * N + n0 + n) : 0.f;
        f[r] = q8::q_to_f((uint32_t)raw[r * 128 + n] ^ 0x80u, 0) * sn;
      }
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(ring.b(bt) + swz128(n, kc)),
                 "r"(q8::bf16x2_bits(f[0], f[1])), "r"(q8::bf16x2_bits(f[2], f[3])),
                 "r"(q8::bf16x2_bits(f[4], f[5])), "r"(q8::bf16x2_bits(f[6], f[7]))
                 : "memory");
  }
  // the generic-proxy stores become visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumers' barrier (named barrier 1, both consumer warpgroups)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// The consumer warpgroups' loop over the n_steps steps of K (weight s and
// columns n0, N as the producer's, for dequant_step); c: the warpgroup (0,
// 1), t: the thread in it. While step it's wgmmas run (x rows
// 64 c .. 64 c + 63 of the stage times B tile it % 2, into d, overwritten
// by the first where fresh(it)), the consumers dequantize step it + 1's
// weight into the other B tile; then they wait for the products, release
// the stage and call step_done(it, d). The two B tiles alternate: the
// barrier that ends each step puts the next tile's halves together and
// frees the current one.
template <typename Fresh, typename StepDone>
__device__ __forceinline__ void consume(const Ring& ring, int n_steps, int gs,
                                        const float* __restrict__ s, int n0, int N, int c, int t,
                                        float d[64], Fresh fresh, StepDone step_done) {
  const int ct = 128 * c + t;
  mbar_wait(ring.full(0), 0);
  dequant_step(ring, 0, 0, gs, s, n0, N, ct);
  consumers_sync();
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kStages, bt = it & 1;
    const uint64_t a = wg_desc(ring.x(st) + c * 64 * 128), b = wg_desc(ring.b(bt));
    const bool f0 = fresh(it);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes a k16 step: +2 in the descriptor
      wgmma_m64n128(d, a + 2 * kk, b + 2 * kk, f0 && kk == 0 ? 0 : 1);
    wg_commit();
    if (it + 1 < n_steps) {
      mbar_wait(ring.full((it + 1) % kStages), ((it + 1) / kStages) & 1);
      dequant_step(ring, it + 1, bt ^ 1, gs, s, n0, N, ct);
    }
    wg_wait0();
    wg_fence_regs(d);
    mbar_arrive(ring.empty(st));  // its x tile is read, its raw rows were a step ago
    step_done(it, d);
    consumers_sync();
  }
}

// the epilogue of a consumer's 64 x 128 tile: rows m0 + 64 c + ..., through
// q8.cuh's store_pair (residual, RoPE, one cast)
__device__ __forceinline__ void store_tile(const float d[64], const q8::Epilogue& e, int m0,
                                           int n0, int M, int N, int c, int t,
                                           bf16* __restrict__ out) {
  const int row = m0 + 64 * c + 16 * (t >> 5) + ((t & 31) >> 2);
  const int col = n0 + 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = col + 8 * i;
    if (n < N) {
      if (row < M) q8::store_pair(e, row, n, N, d[4 * i], d[4 * i + 1], out);
      if (row + 8 < M) q8::store_pair(e, row + 8, n, N, d[4 * i + 2], d[4 * i + 3], out);
    }
  }
}

}  // namespace q8wg
}  // namespace hipllama
