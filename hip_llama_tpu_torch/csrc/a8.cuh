// The `a8` (w8a8, w4a8) mode of the weight products, shared by quant.cu
// (q8_matmul, q8_matmul_silu) and quant4.cu (q4_matmul, q4_matmul_silu): the
// arithmetic of the JAX kernels' `a8` branches (hip_llama_tpu/ops/quant.py::
// _q8_kernel :250-296, _q8_kernel_silu :541-585; quant4.py::_a8_quant_half
// :139, _a8_plane_dot :150), which is the reference int8 engine's
// (runq.c:332-337, :367):
//
//   - the activations, normed and rounded to bf16, are quantized per (row,
//     group of gs along K) by a pass of their own (matmul_passes.cuh::
//     a8_quant_rows_kernel): sx = max|x| * fp32(1/127) (1 where zero), xi =
//     round-half-even(x / sx), a true division;
//   - the int8 weights (Q8_0 codes, or int4 nibbles less 8, exact in int8)
//     meet xi in int8 x int8 dots with int32 sums, one per group, exact;
//   - each group's sum is rescaled in fp32, (f32(int32) * sx) * s, and the
//     groups are summed in fp32; the epilogue (residual, RoPE, gate) runs on
//     that sum, then one cast to bf16.
// int4 weights are packed half-split (byte k' holds row k' and row K/2 + k'):
// the low nibbles meet x[:, :K/2] and the high nibbles x[:, K/2:], each
// with its own groups, which is the same as quantizing the whole row in
// groups of gs because K/2 is a multiple of gs. The scales s (K/gs, N) and
// sx (M, K/gs) are indexed by the unpacked group either way.
//
// Bounds on an H100: at decode-shaped M the product is bound by the weight
// bytes, as in the reshape mode (1 byte a weight for Q8, 0.5 for int4, plus
// 4/gs for the scales); at prefill M by the int8 tensor-core rate (1979
// TOP/s, twice bf16's). The GEMV path (M <= 16) keeps the reshape mode's
// split-K layout but with strips of 128 columns and up to 8 activation rows
// per task, a warp taking whole groups of its slice. At group sizes that
// are multiples of 32 it runs on the int8 tensor cores (a8_gemv_tc_kernel:
// a cp.async ring a warp, mma.sync.m16n8k32.s8 on the weight made k-major
// by byte permutes, a persistent grid); at the others by dp4a
// (a8_gemv_kernel: a warp reads 4 rows of its lane's 4 columns, turns them
// into 4 words of 4 consecutive k of one column by byte permutes, and
// multiplies each by the packed xi word of a row with __dp4a). The two
// give the same bits: exact int32 group sums, rescaled by each warp in its
// group order, the warps added in order. Above 16 rows, at group sizes
// that are multiples of 32, Q8_0 and int4 weights take a8_wgmma.cuh's
// pipelined int8 wgmma tiles (an int4 weight one nibble plane a CTA). The
// tiled path here (a8_mma_kernel) takes the other group sizes, and is what
// the wgmma tiles are held to bit for bit on the card: it stages 64 x 128
// int8 x tiles and 128 x 128 weight tiles (transposed by byte permutes so
// that each column's k are consecutive) in shared memory, one synchronous
// stage a 128-deep step, and runs mma.sync.m16n8k32.s8 (k16 where gs % 32 !=
// 0) into int32 fragments, rescaling them into fp32 at the end of every
// group; an int4 weight's CTA walks both nibble planes, each packed byte
// read once a plane. The dp4a GEMV and the tiles take any group size that is
// a multiple of 8. No TPU mechanism is carried over (the transposed (G, gs,
// M) stash, the 4 MiB group chunks, the 256-row blocks).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "q8.cuh"

namespace hipllama {
namespace a8 {

using q8::bf16;
using q8::Epilogue;
using q8::kThreads;
using q8::kWarps;
using q8::silu_gate;
using q8::store_pair;

constexpr int kGvBN = 128;     // GEMV columns per strip: 4 per lane
constexpr int kGvRows = 8;     // activation rows per GEMV CTA
constexpr int kGvWords = 2048; // int32 words of xi a GEMV CTA stages
constexpr int kTileM = 64;     // tiled path: rows per CTA
constexpr int kTileN = 128;    // tiled path: weight columns per CTA (both weights of a gate)
constexpr int kTileK = 128;    // tiled path: k per shared-memory tile
constexpr int kTileLd = kTileK / 4 + 4;  // words per staged row: conflict-free fragment loads
constexpr uint32_t kNibbles = 0x0F0F0F0Fu;
constexpr uint32_t kEights = 0x08080808u;

// rows r[0..3] hold bytes (columns) 0..3 of four consecutive k; c[j] gets
// column j's four k, k-major in its bytes
__device__ __forceinline__ void transpose4(const uint32_t r[4], uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// the int8 codes of a word of packed int4 bytes: the low (hi == false) or
// high nibbles, each less 8
__device__ __forceinline__ uint32_t nib_codes(uint32_t w, bool hi) {
  return __vsub4((hi ? w >> 4 : w) & kNibbles, kEights);
}

// d += a (16 x 32, row-major) b (32 x 8, k-major columns) in int32
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// GEMV path: one (strip, split, 8-row chunk) task per CTA. Q8: q (K, N),
// slices of kslice rows; INT4: q (K/2, N) packed, slices of kslice packed
// rows. kslice is a multiple of gs (gs % 8 == 0), so a slice holds whole
// groups and each warp takes whole groups of it. part (planes x split, M,
// N) gets the slice's fp32 sums, the warps added in order; an int4 weight's
// two nibble planes keep sums of their own (plane p at split index p x
// split + s), which the second pass (q8.cuh::split_epilogue_at,
// split_gate_at) adds as the JAX kernel does: the low plane's total, then
// the high plane's (quant4.py:226-232).

template <bool INT4>
__global__ void __launch_bounds__(kThreads) a8_gemv_kernel(
    const int8_t* __restrict__ xi, const float* __restrict__ sx, const int8_t* __restrict__ q,
    const float* __restrict__ s, float* __restrict__ part, int M, int K, int N, int gs,
    int kslice) {
  constexpr int P = INT4 ? 2 : 1;  // weight planes: the low and high nibbles
  __shared__ __align__(16) int xw[kGvWords];  // [plane][k / 4][row]: 4 k of xi per word
  __shared__ float red[kWarps][kGvBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGvBN, split = blockIdx.y, m0 = blockIdx.z * kGvRows;
  const int mrows = min(kGvRows, M - m0);
  const int qrows = INT4 ? K / 2 : K;
  const int kbeg = split * kslice, kend = min(qrows, kbeg + kslice);
  const int nq = (kend - kbeg) / 4;
  const int G = K / gs;
  for (int i = tid; i < P * nq * kGvRows; i += kThreads) {
    const int m = i % kGvRows, w = (i / kGvRows) % nq, p = i / (kGvRows * nq);
    const int k = p * (K / 2) + kbeg + 4 * w;
    xw[i] = m < mrows ? *reinterpret_cast<const int*>(xi + (size_t)(m0 + m) * K + k) : 0;
  }
  __syncthreads();

  const int n = n0 + lane * 4;
  const bool live = n < N;  // N % 4 == 0: a lane's 4 columns are all in or all out
  float acc[P][kGvRows][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int m = 0; m < kGvRows; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][m][j] = 0.f;

  for (int gi = warp; gi < (kend - kbeg) / gs; gi += kWarps) {
    const int kg = kbeg + gi * gs;  // the group's first row of q
#pragma unroll
    for (int p = 0; p < P; ++p) {  // the high plane reads the group's rows again, from L1
      int ai[kGvRows][4];
#pragma unroll
      for (int m = 0; m < kGvRows; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) ai[m][j] = 0;
      for (int r0 = 0; r0 < gs; r0 += 8) {
        uint32_t raw[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          raw[r] = live ? __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(kg + r0 + r) * N + n))
                        : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = (kg - kbeg + r0) / 4 + h;  // the quad's word in the slice
          uint32_t rw[4], c[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) rw[j] = INT4 ? nib_codes(raw[4 * h + j], p == 1) : raw[4 * h + j];
          transpose4(rw, c);
          const int4 x0 = *reinterpret_cast<const int4*>(&xw[(p * nq + w) * kGvRows]);
          const int4 x1 = *reinterpret_cast<const int4*>(&xw[(p * nq + w) * kGvRows + 4]);
          const int xv[kGvRows] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int m = 0; m < kGvRows; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) ai[m][j] = __dp4a((int)c[j], xv[m], ai[m][j]);
        }
      }
      // the group's rescale: (f32(int32) * sx) * s
      const int grp = (p * (K / 2) + kg) / gs;
      const float4 sc = live ? __ldg(reinterpret_cast<const float4*>(s + (size_t)grp * N + n))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int m = 0; m < kGvRows; ++m) {
        const float sxm = m < mrows ? sx[(size_t)(m0 + m) * G + grp] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][m][j] += ((float)ai[m][j] * sxm) * sv[j];
      }
    }
  }

  // the 8 warps' sums of each plane and row, added in warp order
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int m = 0; m < mrows; ++m) {  // uniform across the block
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = acc[p][m][j];
      __syncthreads();
      if (tid < kGvBN && n0 + tid < N) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[w][tid];
        part[((size_t)(p * gridDim.y + split) * M + m0 + m) * N + n0 + tid] = v;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// GEMV path on the int8 tensor cores, at group sizes that are multiples of
// 32: the same tasks, the same part layout and the same fp32 arithmetic as
// a8_gemv_kernel, so that its outputs are a8_gemv_kernel's bit for bit. A
// task (strip of kGvBN columns, slice of kslice rows of q, chunk of 8
// rows) is taken by a CTA of a persistent grid, several a CTA where there
// are more tasks than fit on the card at once. Warp w takes the slice's
// groups w, w + 8, ... in order, as in a8_gemv_kernel; a group is gs / 32
// steps of 32 rows of q, which the warp streams through a cp.async ring of
// its own (kTcStages stages, on across the CTA's tasks): the step's rows
// of the strip (4 KB, XOR-swizzled by 16-byte chunk), the 32 columns of xi
// of each of the 8 rows (of each plane), and at the group's last step its
// scale row (of each plane) and the 8 rows' sx. A step is one
// mma.sync.m16n8k32.s32.s8.s8 per 16 columns (and plane): a lane loads 16
// adjacent columns of rows 4 t..4 t + 3 and 16 + 4 t.. (t = lane % 4),
// turns them into words of 4 consecutive k of one column by byte permutes
// (transpose4; for int4 the nibble codes of each plane after them), and
// those are its A fragments of 8 m16 tiles (tile j's row lane / 4 is the
// lane's column 2 j, its row lane / 4 + 8 column 2 j + 1); the 8 rows of
// xi are the B operand, k-major already. The group's int32 sums are exact
// in any order; at its last step the lane rescales them, (f32(sum) * sx) *
// s, into its fp32 sums (each plane apart), in the warp's group order.
// At the end of a task the 8 warps' sums are added in warp order through
// shared memory into part[(plane x split + sp, m, n)], as a8_gemv_kernel
// writes them. Bound on an H100: the weight bytes, as a8_gemv_kernel's.

constexpr int kTcStep = 32;   // rows of q a step: one m16n8k32 per 16 columns
constexpr int kTcStages = 4;  // ring stages a warp

template <bool INT4>
struct GemvTcSmem {
  static constexpr int P = INT4 ? 2 : 1;               // planes
  static constexpr int kW = kTcStep * kGvBN;            // the step's rows of q
  static constexpr int kX = P * kGvRows * kTcStep;      // xi: 8 rows of 32 k a plane
  static constexpr int kS = P * kGvBN * 4;              // the group's scale rows
  static constexpr int kStage = kW + kX + kS + P * kGvRows * 4;  // and its sx of 8 rows
  __align__(16) unsigned char ring[kWarps][kTcStages][kStage];
  __align__(16) float red[kWarps][kGvRows][kGvBN + 4];  // the warps' sums of one plane
};

// the 16-byte chunk (of 8) that holds chunk c of weight row r of a stage:
// rows 4 t + i of the 4 lanes t of two lane groups land in 8 different bank
// groups
__device__ __forceinline__ int tc_wchunk(int r, int c) { return c ^ (((r >> 2) & 3) << 1); }

template <bool INT4>
__global__ void __launch_bounds__(kThreads, 1) a8_gemv_tc_kernel(
    const int8_t* __restrict__ xi, const float* __restrict__ sx, const int8_t* __restrict__ q,
    const float* __restrict__ s, float* __restrict__ part, int M, int K, int N, int gs,
    int split, int kslice) {
  using Sm = GemvTcSmem<INT4>;
  constexpr int P = Sm::P;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(tc_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = lane >> 2, lt = lane & 3;  // the lane's 16 columns and its k 4 lt, ...
  const int qrows = INT4 ? K / 2 : K;
  const int G = K / gs, spg = gs / kTcStep;  // groups of a row of x, steps a group
  const int strips = (N + kGvBN - 1) / kGvBN;
  const int ntasks = strips * split * ((M + kGvRows - 1) / kGvRows);
  const uint32_t ring0 = mma::smem_u32(&sm.ring[warp][0][0]);

  // the warp's steps of task t: its groups of the slice, gs / 32 steps each
  auto steps = [&](int t) {
    const int sp = (t / strips) % split;
    const int ng = (min(qrows, (sp + 1) * kslice) - sp * kslice) / gs;
    return ng > warp ? (ng - warp + kWarps - 1) / kWarps * spg : 0;
  };
  // the first row of q of step i of the warp's steps in task t
  auto step_row = [&](int t, int i) {
    return (t / strips) % split * kslice + (warp + kWarps * (i / spg)) * gs + i % spg * kTcStep;
  };

  // the copies: step pi of the pn steps of task pt, the next to issue
  int pt = blockIdx.x, pi = 0, pn = 0;
  auto seek = [&]() {  // the first task from pt on where the warp has steps
    for (; pt < ntasks; pt += gridDim.x)
      if ((pn = steps(pt)) > 0) break;
    pi = 0;
  };
  auto issue = [&](int slot) {  // one commit group a step, empty past the last
    if (pt < ntasks) {
      const int n0 = pt % strips * kGvBN, m0 = pt / strips / split * kGvRows;
      const int k0 = step_row(pt, pi);
      const uint32_t st = ring0 + slot * Sm::kStage;
#pragma unroll
      for (int i = 0; i < Sm::kW / 16 / 32; ++i) {  // 32 rows of 8 chunks
        const int e = lane + 32 * i, r = e >> 3, c = e & 7;
        const bool live = n0 + 16 * c < N;
        mma::cp_async<16>(st + r * kGvBN + 16 * tc_wchunk(r, c),
                              live ? q + (size_t)(k0 + r) * N + n0 + 16 * c : q, live);
      }
      if (lane < 2 * kGvRows * P) {  // xi: 8 rows of two halves a plane, zero past M
        const int m = (lane >> 1) % kGvRows, h = lane & 1, p = lane / (2 * kGvRows);
        const bool live = m0 + m < M;
        mma::cp_async<16>(
            st + Sm::kW + p * kGvRows * kTcStep + m * kTcStep + 16 * q8::gemv_xhalf(m, h),
            live ? xi + (size_t)(m0 + m) * K + p * (K / 2) + k0 + 16 * h : xi, live);
      }
      if (pi % spg == spg - 1) {  // the group's last step: its scales
        const int grp = k0 / gs;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const bool live = n0 + 4 * lane < N;
          mma::cp_async<16>(st + Sm::kW + Sm::kX + p * kGvBN * 4 + 16 * lane,
                                live ? s + (size_t)(p * (G / 2) + grp) * N + n0 + 4 * lane : s,
                                live);
        }
        if (lane < kGvRows * P) {
          const int m = lane % kGvRows, p = lane / kGvRows;
          const bool live = m0 + m < M;
          mma::cp_async<4>(st + Sm::kW + Sm::kX + Sm::kS + 4 * lane,
                               live ? sx + (size_t)(m0 + m) * G + p * (G / 2) + grp : sx, live);
        }
      }
      if (++pi == pn) {
        pt += gridDim.x;
        seek();
      }
    }
    mma::cp_async_commit();
  };

  seek();
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) issue(i);

  int item = 0;  // steps this warp has consumed: the ring slot is item % kTcStages
  for (int t = blockIdx.x; t < ntasks; t += gridDim.x) {
    const int sp = (t / strips) % split, m0 = t / strips / split * kGvRows;
    const int n0 = t % strips * kGvBN, mrows = min(kGvRows, M - m0);
    const int n = steps(t);
    float acc[P][8][4];  // tile j: columns 16 lg + 2 j (+1 at 2, 3) of rows 2 lt, 2 lt + 1
    int ai[P][8][4];     // the open group's int32 sums
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[p][j][i] = 0.f;
          ai[p][j][i] = 0;
        }

    for (int i = 0; i < n; ++i, ++item) {
      issue((item + kTcStages - 1) % kTcStages);  // into the slot consumed last
      mma::cp_async_wait<kTcStages - 1>();     // this step's copies have landed
      __syncwarp();                                // ... for every lane
      const unsigned char* stage = sm.ring[warp][item % kTcStages];
      // B: xi row lg at k 4 lt.. and 16 + 4 lt.. of each plane
      uint32_t bx[P][2];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const unsigned char* xr = stage + Sm::kW + p * kGvRows * kTcStep + lg * kTcStep + 4 * lt;
        bx[p][0] = *reinterpret_cast<const uint32_t*>(xr + 16 * q8::gemv_xhalf(lg, 0));
        bx[p][1] = *reinterpret_cast<const uint32_t*>(xr + 16 * q8::gemv_xhalf(lg, 1));
      }
      // A: column words of k 4 lt.. (h 0) and 16 + 4 lt.. (h 1) of the
      // lane's 16 columns
      uint32_t cw[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t raw[4][4];  // rows 16 h + 4 lt + r, words of 4 columns
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * h + 4 * lt + r;
          const uint4 v =
              *reinterpret_cast<const uint4*>(stage + row * kGvBN + 16 * tc_wchunk(row, lg));
          raw[r][0] = v.x;
          raw[r][1] = v.y;
          raw[r][2] = v.z;
          raw[r][3] = v.w;
        }
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const uint32_t rr[4] = {raw[0][c4], raw[1][c4], raw[2][c4], raw[3][c4]};
          transpose4(rr, &cw[h][4 * c4]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t a[4] = {cw[0][2 * j], cw[0][2 * j + 1], cw[1][2 * j], cw[1][2 * j + 1]};
          if (INT4) {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = nib_codes(a[r], p == 1);
          }
          mma_s8(ai[p][j], a, bx[p]);
        }
      if (i % spg == spg - 1) {  // the group's end: (f32(sum) * sx) * s, then from zero
        const float* sr = reinterpret_cast<const float*>(stage + Sm::kW + Sm::kX);
        const float* sxr = reinterpret_cast<const float*>(stage + Sm::kW + Sm::kX + Sm::kS);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float sx0 = sxr[p * kGvRows + 2 * lt], sx1 = sxr[p * kGvRows + 2 * lt + 1];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 sv =
                *reinterpret_cast<const float2*>(sr + p * kGvBN + 16 * lg + 2 * j);
            acc[p][j][0] += ((float)ai[p][j][0] * sx0) * sv.x;
            acc[p][j][1] += ((float)ai[p][j][1] * sx1) * sv.x;
            acc[p][j][2] += ((float)ai[p][j][2] * sx0) * sv.y;
            acc[p][j][3] += ((float)ai[p][j][3] * sx1) * sv.y;
#pragma unroll
            for (int r = 0; r < 4; ++r) ai[p][j][r] = 0;
          }
        }
      }
      __syncwarp();  // every lane is done with the slot before it is filled again
    }

    // the 8 warps' sums of each plane in warp order; a thread adds 4
    // columns of one row
    const int rm = threadIdx.x >> 5, rc = threadIdx.x & 31;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      __syncthreads();  // red is free
#pragma unroll
      for (int ee = 0; ee < 2; ++ee) {  // row 2 lt + ee: column 16 lg + 2 j + h at acc[j][ee + 2 h]
        float* row = sm.red[warp][2 * lt + ee] + 16 * lg;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          *reinterpret_cast<float4*>(row + 4 * c4) =
              make_float4(acc[p][2 * c4][ee], acc[p][2 * c4][ee + 2], acc[p][2 * c4 + 1][ee],
                          acc[p][2 * c4 + 1][ee + 2]);
      }
      __syncthreads();
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 r = *reinterpret_cast<const float4*>(sm.red[w][rm] + 4 * rc);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      if (rm < mrows && n0 + 4 * rc < N)
        *reinterpret_cast<float4*>(part + ((size_t)(p * split + sp) * M + m0 + rm) * N + n0 +
                                   4 * rc) = v;
    }
  }
  mma::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// tiled path: 64 rows x 128 weight columns per CTA (GATE: 64 columns of W1
// and the same 64 of W3, at off3 columns further in q), 8 warps as 4 along M
// x 2 along N, each warp 16 rows x 64 weight columns as n8 tiles. Q8: q (K,
// ldq); INT4: q (K/2, ldq) packed, unpacked row k in plane k >= K/2. ncols:
// output columns (N, or H for the gate), a multiple of 16; K % 16 == 0.
//
// Any group size gs that is a multiple of 8 (and divides K, or K/2 for
// int4): the int32 sums of a group stay in registers across k steps and
// k tiles and are rescaled, (f32(sum) * sx) * s, where the group ends.
// KS = 32 (gs % 32 == 0) steps k by mma.sync.m16n8k32; KS = 16 by
// m16n8k16, whose k halves of 8 are each in one group (gs % 8 == 0): where
// a group ends inside a step, the step runs twice, once with each half of
// the x fragment zeroed, and the first group is rescaled between the two.
// The int32 sums are exact in any order, so KS and the split change no
// value. A k tile stages the scales of the groups it touches (at most
// kTileK / 8 + 1).

constexpr int kTileGroups = kTileK / 8 + 1;

// d += a (16 x 16, row-major) b (16 x 8, k-major columns) in int32
__device__ __forceinline__ void mma_s8_k16(int d[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <bool GATE, bool INT4, int KS>
__global__ void __launch_bounds__(kThreads) a8_mma_kernel(
    const int8_t* __restrict__ xi, const float* __restrict__ sx, const int8_t* __restrict__ q,
    const float* __restrict__ s, int M, int K, int ldq, int ncols, int off3, int gs, Epilogue e,
    bf16* __restrict__ out) {
  constexpr int NB = GATE ? 2 : 1;  // weights
  constexpr int WBN = kTileN / NB;  // columns of each weight per CTA
  constexpr int WN = WBN / 2;       // columns of each weight per warp
  constexpr int NT8 = WN / 8;       // n8 tiles of each weight per warp
  __shared__ __align__(16) uint32_t a_s[kTileM][kTileLd];  // xi rows, 4 k per word
  __shared__ __align__(16) uint32_t b_s[kTileN][kTileLd];  // weight columns, 4 k per word
  __shared__ float sx_s[kTileM][kTileGroups];              // the tile's groups' sx
  __shared__ float s_s[kTileGroups][kTileN];               // the tile's groups' s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread in group
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * WBN;
  const int G = K / gs;
  // this thread's staging: x row ar, bytes ac..ac+31 of the tile; weight
  // columns (chunk bn of 16) and k rows 4 bq..4 bq+3
  const int ar = tid >> 2, ac = (tid & 3) * 32;
  const int bn = (lane & 1) + 2 * (warp & 3), bq = (lane >> 1) + 16 * (warp >> 2);
  const int bsel = GATE ? bn / 4 : 0;
  const int bcol = n0 + 16 * (GATE ? bn % 4 : bn);
  const int bqc = bcol + bsel * off3;

  constexpr int P = INT4 ? 2 : 1;  // planes with sums of their own (see the GEMV path)
  float acc[P][NB][NT8][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][b][j][i] = 0.f;
  int ai[NB][NT8][4];  // the open group's int32 sums
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) ai[b][j][i] = 0;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    {
      uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
      const int gm = m0 + ar, gk = k0 + ac;
      if (gm < M) {  // K % 16 == 0: each 16-byte half is all in or all out
        const uint4* src = reinterpret_cast<const uint4*>(xi + (size_t)gm * K + gk);
        if (gk < K) v0 = src[0];
        if (gk + 16 < K) v1 = src[1];
      }
      *reinterpret_cast<uint4*>(&a_s[ar][ac / 4]) = v0;
      *reinterpret_cast<uint4*>(&a_s[ar][ac / 4 + 4]) = v1;
    }
    {
      const int k = k0 + 4 * bq;
      uint4 rv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rv[j] = make_uint4(0u, 0u, 0u, 0u);
        if (k < K && bcol < ncols) {
          const bool hi = INT4 && k >= K / 2;  // a quad never straddles K/2 (K/2 % gs == 0)
          const int row = hi ? k + j - K / 2 : k + j;
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(q + (size_t)row * ldq + bqc));
          rv[j] = INT4 ? make_uint4(nib_codes(w.x, hi), nib_codes(w.y, hi), nib_codes(w.z, hi),
                                    nib_codes(w.w, hi))
                       : w;
        }
      }
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(rv);
#pragma unroll
      for (int cw = 0; cw < 4; ++cw) {
        const uint32_t r[4] = {rw[cw], rw[4 + cw], rw[8 + cw], rw[12 + cw]};
        uint32_t c[4];
        transpose4(r, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) b_s[16 * bn + 4 * cw + j][bq] = c[j];
      }
    }
    // the scales of the groups this tile touches
    const int kend = min(K, k0 + kTileK);
    const int gfirst = k0 / gs, ngt = (kend - 1) / gs - gfirst + 1;
    for (int i = tid; i < ngt * kTileN; i += kThreads) {
      const int gi = i / kTileN, c = i % kTileN;
      const int grp = gfirst + gi, col = n0 + c % WBN;
      s_s[gi][c] = col < ncols ? s[(size_t)grp * ldq + col + (GATE ? c / WBN : 0) * off3] : 0.f;
    }
    for (int i = tid; i < kTileM * ngt; i += kThreads) {
      const int r = i / ngt, gi = i % ngt;
      sx_s[r][gi] = m0 + r < M ? sx[(size_t)(m0 + r) * G + gfirst + gi] : 0.f;
    }
    __syncthreads();

    // (f32(ai) * sx) * s into the group's plane, then the sums start over
    auto close_group = [&](int grp) {
      const int gi = grp - gfirst;
      const float sx0 = sx_s[wm * 16 + g][gi], sx1 = sx_s[wm * 16 + g + 8][gi];
      const bool hi = INT4 && grp * gs >= K / 2;  // the group's plane
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p != (int)hi) continue;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < NT8; ++j) {
            const int cb = b * WBN + wn * WN + j * 8 + 2 * t;
            const float s0 = s_s[gi][cb], s1 = s_s[gi][cb + 1];
            acc[p][b][j][0] += ((float)ai[b][j][0] * sx0) * s0;
            acc[p][b][j][1] += ((float)ai[b][j][1] * sx0) * s1;
            acc[p][b][j][2] += ((float)ai[b][j][2] * sx1) * s0;
            acc[p][b][j][3] += ((float)ai[b][j][3] * sx1) * s1;
          }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < NT8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) ai[b][j][i] = 0;
    };

    for (int k = k0; k < kend; k += KS) {
      const int kw = (k - k0) / 4;
      if (KS == 32) {
        const uint32_t af[4] = {a_s[wm * 16 + g][kw + t], a_s[wm * 16 + g + 8][kw + t],
                                a_s[wm * 16 + g][kw + 4 + t], a_s[wm * 16 + g + 8][kw + 4 + t]};
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < NT8; ++j) {
            const int cb = b * WBN + wn * WN + j * 8 + g;
            const uint32_t bf[2] = {b_s[cb][kw + t], b_s[cb][kw + 4 + t]};
            mma_s8(ai[b][j], af, bf);
          }
      } else {
        const uint32_t a0 = a_s[wm * 16 + g][kw + t], a1 = a_s[wm * 16 + g + 8][kw + t];
        // the step's product with the x fragment's k .. k + 7 (held by t < 2)
        // and k + 8 .. k + 15 (t >= 2) kept where lo and hi say
        auto step = [&](bool lo, bool hi) {
          const bool use = t < 2 ? lo : hi;
          const uint32_t af[2] = {use ? a0 : 0u, use ? a1 : 0u};
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int j = 0; j < NT8; ++j)
              mma_s8_k16(ai[b][j], af, b_s[b * WBN + wn * WN + j * 8 + g][kw + t]);
        };
        const int glo = k / gs;
        if (glo == (k + 8) / gs) {
          step(true, true);
        } else {  // a group ends at k + 8
          step(true, false);
          close_group(glo);
          step(false, true);
        }
      }
      if ((k + KS) % gs == 0) close_group((k + KS) / gs - 1);
    }
    __syncthreads();
  }

  // the low plane's sum, then the high plane's added
  if (INT4) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[0][b][j][i] += acc[P - 1][b][j][i];
  }
  // epilogue: fragment element (h, c) of n8 tile j is row g + 8 h, columns
  // 2 t and 2 t + 1
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const int col = n0 + wn * WN + j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 16 + g + 8 * h;
      if (row < M && col < ncols) {
        if (GATE) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ncols + col) =
              __floats2bfloat162_rn(silu_gate(acc[0][0][j][2 * h], acc[0][NB - 1][j][2 * h]),
                                    silu_gate(acc[0][0][j][2 * h + 1],
                                              acc[0][NB - 1][j][2 * h + 1]));
        } else {
          store_pair(e, row, col, ncols, acc[0][0][j][2 * h], acc[0][0][j][2 * h + 1], out);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: 0 or the CUDA error

// part (split, M, N): the GEMV path, K (or K/2 packed rows) in split slices
// of kslice rows
template <bool INT4>
int launch_gemv(const void* xi, const void* sx, const void* q, const void* s, float* part, int M,
                int K, int N, int gs, int split, int kslice, cudaStream_t st) {
  const int qrows = INT4 ? K / 2 : K;
  if (gs % 8 || kslice % gs || (INT4 ? 2 : 1) * kslice * kGvRows > 4 * kGvWords ||
      (long long)split * kslice < qrows || (long long)(split - 1) * kslice >= qrows)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kGvBN - 1) / kGvBN, split, (M + kGvRows - 1) / kGvRows);
  a8_gemv_kernel<INT4><<<grid, kThreads, 0, st>>>((const int8_t*)xi, (const float*)sx,
                                                  (const int8_t*)q, (const float*)s, part, M, K,
                                                  N, gs, kslice);
  return (int)cudaGetLastError();
}

// the same partials on the int8 tensor cores (a8_gemv_tc_kernel), gs a
// multiple of 32 and N of 16; a persistent grid of at most as many CTAs as
// fit on the card at once
template <bool INT4>
int launch_gemv_tc(const void* xi, const void* sx, const void* q, const void* s, float* part,
                   int M, int K, int N, int gs, int split, int kslice, cudaStream_t st) {
  const int qrows = INT4 ? K / 2 : K;
  if (M < 1 || gs < kTcStep || gs % kTcStep || N < 16 || N % 16 || kslice < gs ||
      kslice % gs || (long long)split * kslice < qrows || (long long)(split - 1) * kslice >= qrows)
    return (int)cudaErrorInvalidValue;
  auto kernel = a8_gemv_tc_kernel<INT4>;
  constexpr int bytes = sizeof(GemvTcSmem<INT4>);
  static int ctas = 0;  // CTAs that fit on the card at once
  if (ctas == 0) {
    const cudaError_t e = q8::resident_ctas(kernel, bytes, ctas);
    if (e != cudaSuccess) return (int)e;
  }
  const int tasks = (N + kGvBN - 1) / kGvBN * split * ((M + kGvRows - 1) / kGvRows);
  kernel<<<tasks < ctas ? tasks : ctas, kThreads, bytes, st>>>(
      (const int8_t*)xi, (const float*)sx, (const int8_t*)q, (const float*)s, part, M, K, N, gs,
      split, kslice);
  return (int)cudaGetLastError();
}

// the GEMV path's partials by group size: the int8 tensor cores where gs %
// 32 == 0 (tc), else dp4a
template <bool INT4>
int launch_gemv_any(bool tc, const void* xi, const void* sx, const void* q, const void* s,
                    float* part, int M, int K, int N, int gs, int split, int kslice,
                    cudaStream_t st) {
  return tc ? launch_gemv_tc<INT4>(xi, sx, q, s, part, M, K, N, gs, split, kslice, st)
            : launch_gemv<INT4>(xi, sx, q, s, part, M, K, N, gs, split, kslice, st);
}

// the tiled path into out (M, ncols) bf16: k steps of 32 where gs % 32 ==
// 0, else of 16
template <bool GATE, bool INT4>
int launch_mma(const void* xi, const void* sx, const void* q, const void* s, int M, int K,
               int ldq, int ncols, int off3, int gs, const Epilogue& e, void* out,
               cudaStream_t st) {
  if (gs < 8 || gs % 8 || K % gs || K % 16 || ncols % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((ncols + kTileN / (GATE ? 2 : 1) - 1) / (kTileN / (GATE ? 2 : 1)),
                  (M + kTileM - 1) / kTileM);
  auto kernel = gs % 32 ? a8_mma_kernel<GATE, INT4, 16> : a8_mma_kernel<GATE, INT4, 32>;
  kernel<<<grid, kThreads, 0, st>>>((const int8_t*)xi, (const float*)sx, (const int8_t*)q,
                                    (const float*)s, M, K, ldq, ncols, off3, gs, e, (bf16*)out);
  return (int)cudaGetLastError();
}

}  // namespace a8
}  // namespace hipllama
