// Device-memory bandwidth probes: the four Pallas kernels of tools/hbm_bw.py
// (K24-K27), the port bench's achievable-bandwidth denominator.
//
// On the TPU these kernels measure what the DMA engines deliver: their only
// work is block copies from HBM into VMEM, and the vector unit touches an
// (8, 128) corner of each block so that the result depends on the data. The
// Hopper analog is the Tensor Memory Accelerator's bulk copy
// (cp.async.bulk ... mbarrier::complete_tx::bytes): one thread asks for a
// contiguous run of bytes to land in shared memory, and the copy reports to
// an mbarrier. The bytes land whether or not a thread reads them, so no
// compiler can drop the loads, and no thread spends an instruction on a
// byte it does not read. Bound: bytes (each byte of the array read once;
// the copy also writes each once); there is no arithmetic to speak of.
//
// Every kernel runs one CTA per SM, each over a contiguous share of the
// array's pieces (runs of at most 32 KiB, 16-byte aligned, far below the
// mbarrier's 2^20 - 1 bytes of transactions), with a ring of slots in
// shared memory and one mbarrier per slot: a slot's next copy is issued as
// soon as its last one has been read.
//
// dma_read (K24) replaces tools/hbm_bw.py::dma_probe's read kernel (:114-138):
//   blocks of block_bytes (bm rows of 1024 int8) from `streams` disjoint
//   regions of `per` blocks each; out (8, 128) fp32 = seed + the sum over all
//   per * streams blocks of each block's [:8, :128] corner. A CTA's pieces
//   interleave the regions in the TPU grid's order (step i reads block i of
//   every region). The CTA that holds a block's first piece adds its corner
//   into per-CTA partials in registers; at the end one atomicAdd per element,
//   and CTA 0 adds the seed. The values are integers whose sums stay below
//   2^24 (the wrapper checks n_blocks), so fp32 adds them exactly and the
//   order of the atomics does not change the result.
// dma_copy (K25) replaces dma_probe(copy=True)'s kernel (:87-112): the same
//   pieces, each stored back from shared memory with a bulk store
//   (cp.async.bulk.global.shared::cta) to the same offset of `out` (output c
//   of the TPU kernel is rows [c per bm, (c + 1) per bm) of x, so the
//   outputs side by side are x's first per * streams blocks); a slot is
//   loaded again once its store has read it (bulk_group wait .read).
// wshape_read (K26) replaces wshape_probe's kernel (:177-199): (bk, bn) int8
//   tiles along the columns of a (bk, n_cols) array, the Q8 weight stream's
//   access; out = seed + sum over tiles j of x[:8, j bn : j bn + 128]. A
//   piece is `rows` rows of a tile, one 1D bulk copy per row (bn bytes at a
//   stride of n_cols), issued by the 32 lanes of warp 0 onto the slot's one
//   mbarrier. (The other design, a 2D tensor map, needs the driver's
//   cuTensorMapEncodeTiled; per-row copies need nothing.)
// deep_read (K27) replaces deep_probe's kernel (:234-259): `depth` bulk
//   copies kept in flight, one mbarrier per slot. The TPU probe is one
//   program with `depth` DMAs in flight; a GPU's analog of a deeper queue is
//   `depth` copies in flight per CTA on every SM. Pieces are flat runs of
//   the array; out = seed + the [:8, :128] corner of the block at
//   target_offset (the last block the TPU kernel's loop leaves in slot 0),
//   written by the CTA whose pieces hold it.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRow = 1024;        // bytes per row of the (n, 1024) int8 arrays
constexpr int kCornerRows = 8;    // the [:8, :128] corner
constexpr int kCornerCols = 128;
constexpr int kThreads = 128;     // one thread per corner column
constexpr int kMaxSlots = 32;
constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void init_slots(uint64_t* bars, int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// [j0, j1): this CTA's share of `total` pieces, contiguous and balanced
__device__ __forceinline__ void my_share(long long total, long long* j0, long long* j1) {
  *j0 = total * blockIdx.x / gridDim.x;
  *j1 = total * (blockIdx.x + 1) / gridDim.x;
}

// K24 and K25: piece J of the streamed blocks; J = (i * ppb + p) * streams + c
// is piece p of block i of region c. Returns its byte offset in x and
// whether it is the first piece of its block.
__device__ __forceinline__ long long stream_piece(long long J, long long per, int streams,
                                                  long long ppb, long long block_bytes,
                                                  int piece_bytes, bool* first) {
  const long long c = J % streams, t = J / streams;
  const long long p = t % ppb, i = t / ppb;
  *first = p == 0;
  return (c * per + i) * block_bytes + p * piece_bytes;
}

// the corner of the piece in shared memory at `buf` (rows of `pitch`
// bytes) into this thread's column partials
__device__ __forceinline__ void add_corner(float acc[kCornerRows], const int8_t* buf, int pitch) {
#pragma unroll
  for (int r = 0; r < kCornerRows; ++r) acc[r] += (float)buf[r * pitch + threadIdx.x];
}

__device__ __forceinline__ void flush_corner(const float acc[kCornerRows], const int* seed,
                                             float* out, bool any) {
  const float sd = blockIdx.x == 0 ? (float)*seed : 0.0f;
  if (!any && blockIdx.x != 0) return;
#pragma unroll
  for (int r = 0; r < kCornerRows; ++r) atomicAdd(&out[r * kCornerCols + threadIdx.x], acc[r] + sd);
}

__global__ void __launch_bounds__(kThreads) dma_read_kernel(const int8_t* __restrict__ x,
                                                            const int* __restrict__ seed,
                                                            float* __restrict__ out, long long per,
                                                            int streams, long long block_bytes,
                                                            int piece_bytes, int slots) {
  __shared__ uint64_t bars[kMaxSlots];
  extern __shared__ __align__(128) unsigned char ring[];
  init_slots(bars, slots);
  const long long ppb = block_bytes / piece_bytes;
  long long j0, j1;
  my_share(per * streams * ppb, &j0, &j1);
  const long long n = j1 - j0;
  bool first;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots && s < n; ++s) {
      const long long off = stream_piece(j0 + s, per, streams, ppb, block_bytes, piece_bytes,
                                         &first);
      mbar_expect(&bars[s], piece_bytes);
      bulk_load(ring + (size_t)s * piece_bytes, x + off, piece_bytes, &bars[s]);
    }
  }
  float acc[kCornerRows] = {};
  bool any = false;
  for (long long k = 0; k < n; ++k) {
    const int s = (int)(k % slots);
    mbar_wait(&bars[s], (uint32_t)((k / slots) & 1));
    stream_piece(j0 + k, per, streams, ppb, block_bytes, piece_bytes, &first);
    if (first) {
      add_corner(acc, reinterpret_cast<const int8_t*>(ring + (size_t)s * piece_bytes), kRow);
      any = true;
    }
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && k + slots < n) {
      const long long off = stream_piece(j0 + k + slots, per, streams, ppb, block_bytes,
                                         piece_bytes, &first);
      mbar_expect(&bars[s], piece_bytes);
      bulk_load(ring + (size_t)s * piece_bytes, x + off, piece_bytes, &bars[s]);
    }
  }
  flush_corner(acc, seed, out, any);
}

// one thread moves everything: loads into the ring, stores out of it
__global__ void dma_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                long long per, int streams, long long block_bytes,
                                int piece_bytes, int slots) {
  __shared__ uint64_t bars[kMaxSlots];
  extern __shared__ __align__(128) unsigned char ring[];
  init_slots(bars, slots);
  if (threadIdx.x != 0) return;
  const long long ppb = block_bytes / piece_bytes;
  long long j0, j1;
  my_share(per * streams * ppb, &j0, &j1);
  const long long n = j1 - j0;
  bool first;
  for (int s = 0; s < slots && s < n; ++s) {
    const long long off = stream_piece(j0 + s, per, streams, ppb, block_bytes, piece_bytes, &first);
    mbar_expect(&bars[s], piece_bytes);
    bulk_load(ring + (size_t)s * piece_bytes, x + off, piece_bytes, &bars[s]);
  }
  for (long long k = 0; k < n; ++k) {
    const int s = (int)(k % slots);
    mbar_wait(&bars[s], (uint32_t)((k / slots) & 1));
    const long long off = stream_piece(j0 + k, per, streams, ppb, block_bytes, piece_bytes,
                                       &first);
    bulk_store(out + off, ring + (size_t)s * piece_bytes, piece_bytes);
    // the previous piece's slot is free once its store has read it: load
    // the piece `slots` after it there, while this piece's store runs
    if (k >= 1 && k - 1 + slots < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      const int sp = (int)((k - 1) % slots);
      const long long offp = stream_piece(j0 + k - 1 + slots, per, streams, ppb, block_bytes,
                                          piece_bytes, &first);
      mbar_expect(&bars[sp], piece_bytes);
      bulk_load(ring + (size_t)sp * piece_bytes, x + offp, piece_bytes, &bars[sp]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// K26: piece J = j * (bk / rows) + p holds rows [p rows, (p + 1) rows) of
// tile j, one bulk copy per row, issued by warp 0
__device__ __forceinline__ void wshape_issue(const int8_t* x, unsigned char* slot, uint64_t* bar,
                                             long long J, long long ppt, int rows, int bn,
                                             long long n_cols) {
  const long long j = J / ppt, p = J % ppt;
  const int lane = threadIdx.x;
  if (lane == 0) mbar_expect(bar, (uint32_t)rows * bn);
  __syncwarp();
  for (int r = lane; r < rows; r += 32)
    bulk_load(slot + (size_t)r * bn, x + (p * rows + r) * n_cols + j * bn, bn, bar);
}

__global__ void __launch_bounds__(kThreads) wshape_read_kernel(const int8_t* __restrict__ x,
                                                               const int* __restrict__ seed,
                                                               float* __restrict__ out,
                                                               long long n_tiles, int bk, int bn,
                                                               long long n_cols, int rows,
                                                               int slots) {
  __shared__ uint64_t bars[kMaxSlots];
  extern __shared__ __align__(128) unsigned char ring[];
  init_slots(bars, slots);
  const long long ppt = bk / rows;
  const size_t piece = (size_t)rows * bn;
  long long j0, j1;
  my_share(n_tiles * ppt, &j0, &j1);
  const long long n = j1 - j0;
  if (threadIdx.x < 32)
    for (int s = 0; s < slots && s < n; ++s)
      wshape_issue(x, ring + s * piece, &bars[s], j0 + s, ppt, rows, bn, n_cols);
  float acc[kCornerRows] = {};
  bool any = false;
  for (long long k = 0; k < n; ++k) {
    const int s = (int)(k % slots);
    mbar_wait(&bars[s], (uint32_t)((k / slots) & 1));
    if ((j0 + k) % ppt == 0) {  // a tile's first rows
      add_corner(acc, reinterpret_cast<const int8_t*>(ring + s * piece), bn);
      any = true;
    }
    __syncthreads();
    if (threadIdx.x < 32 && k + slots < n)
      wshape_issue(x, ring + s * piece, &bars[s], j0 + k + slots, ppt, rows, bn, n_cols);
  }
  flush_corner(acc, seed, out, any);
}

// K27: flat pieces of the array, `depth` in flight, driven by one thread
__global__ void deep_read_kernel(const int8_t* __restrict__ x, const int* __restrict__ seed,
                                 float* __restrict__ out, long long total_bytes, int piece_bytes,
                                 int depth, long long target) {
  __shared__ uint64_t bars[kMaxSlots];
  extern __shared__ __align__(128) unsigned char ring[];
  init_slots(bars, depth);
  if (threadIdx.x != 0) return;
  const long long n_pieces = (total_bytes + piece_bytes - 1) / piece_bytes;
  long long j0, j1;
  my_share(n_pieces, &j0, &j1);
  const long long n = j1 - j0;
  auto issue = [&](long long J, int s) {
    const long long off = J * piece_bytes;
    const uint32_t bytes = (uint32_t)min((long long)piece_bytes, total_bytes - off);
    mbar_expect(&bars[s], bytes);
    bulk_load(ring + (size_t)s * piece_bytes, x + off, bytes, &bars[s]);
  };
  for (int s = 0; s < depth && s < n; ++s) issue(j0 + s, s);
  const float sd = (float)*seed;
  for (long long k = 0; k < n; ++k) {
    const int s = (int)(k % depth);
    mbar_wait(&bars[s], (uint32_t)((k / depth) & 1));
    // the target block's corner rows that lie in this piece (pieces are
    // whole rows, so a row's 128 corner bytes never straddle two)
    const long long lo = (j0 + k) * piece_bytes, hi = lo + piece_bytes;
    const int8_t* buf = reinterpret_cast<const int8_t*>(ring + (size_t)s * piece_bytes);
    for (int r = 0; r < kCornerRows; ++r) {
      const long long at = target + (long long)r * kRow;
      if (at >= lo && at < hi)
        for (int c = 0; c < kCornerCols; ++c)
          out[r * kCornerCols + c] = (float)buf[at - lo + c] + sd;
    }
    if (k + depth < n) issue(j0 + k + depth, s);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_ring(int slots, long long piece) {
  return slots < 1 || slots > kMaxSlots || piece < 16 || piece % 16 ||
         (long long)slots * piece > kMaxSmem;
}

}  // namespace

HIPLLAMA_EXPORT_ERROR_STRING

// x: (n, 1024) int8, 16-byte aligned, at least per * streams * block_bytes
// bytes; seed: one int32 on the device; out: (8, 128) fp32, zeroed by the
// caller. block_bytes a multiple of piece_bytes; piece_bytes a multiple of
// 16 and at least 8 rows (8192) so a block's corner lies in its first piece.
extern "C" int dma_read(const void* x, const void* seed, void* out, long long per, int streams,
                        long long block_bytes, int piece_bytes, int slots, void* stream) {
  if (bad_ring(slots, piece_bytes) || piece_bytes < kCornerRows * kRow || streams < 1 ||
      per < 1 || block_bytes % piece_bytes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)slots * piece_bytes;
  int e = set_smem(dma_read_kernel, smem);
  if (e) return e;
  const int grid = sm_count();
  if (grid < 1) return (int)cudaErrorNoDevice;
  dma_read_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)x, (const int*)seed, (float*)out, per, streams, block_bytes, piece_bytes,
      slots);
  return (int)cudaGetLastError();
}

// out: per * streams * block_bytes bytes, 16-byte aligned
extern "C" int dma_copy(const void* x, void* out, long long per, int streams,
                        long long block_bytes, int piece_bytes, int slots, void* stream) {
  if (bad_ring(slots, piece_bytes) || streams < 1 || per < 1 || block_bytes % piece_bytes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)slots * piece_bytes;
  int e = set_smem(dma_copy_kernel, smem);
  if (e) return e;
  const int grid = sm_count();
  if (grid < 1) return (int)cudaErrorNoDevice;
  dma_copy_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)x, (int8_t*)out, per, streams, block_bytes, piece_bytes, slots);
  return (int)cudaGetLastError();
}

// x: (bk, n_cols) int8, n_cols (the row stride) a multiple of 16 holding
// n_tiles tiles of bn; bn a multiple of 16, at least 128; rows (of a piece)
// divides bk and is at least 8
extern "C" int wshape_read(const void* x, const void* seed, void* out, long long n_tiles, int bk,
                           int bn, long long n_cols, int rows, int slots, void* stream) {
  if (bad_ring(slots, (long long)rows * bn) || bn % 16 || bn < kCornerCols ||
      rows < kCornerRows || bk % rows || n_cols % 16 || n_tiles < 1 || n_tiles * bn > n_cols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)slots * rows * bn;
  int e = set_smem(wshape_read_kernel, smem);
  if (e) return e;
  const int grid = sm_count();
  if (grid < 1) return (int)cudaErrorNoDevice;
  wshape_read_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)x, (const int*)seed, (float*)out, n_tiles, bk, bn, n_cols, rows, slots);
  return (int)cudaGetLastError();
}

// x: total_bytes of int8 rows of 1024; piece_bytes a multiple of 1024;
// target: the byte offset of the block whose corner goes out (a row start)
extern "C" int deep_read(const void* x, const void* seed, void* out, long long total_bytes,
                         int piece_bytes, int depth, long long target, void* stream) {
  if (bad_ring(depth, piece_bytes) || piece_bytes % kRow || total_bytes % kRow ||
      target % kRow || target < 0 || target + kCornerRows * kRow > total_bytes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)depth * piece_bytes;
  int e = set_smem(deep_read_kernel, smem);
  if (e) return e;
  const int grid = sm_count();
  if (grid < 1) return (int)cudaErrorNoDevice;
  deep_read_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)x, (const int*)seed, (float*)out, total_bytes, piece_bytes, depth, target);
  return (int)cudaGetLastError();
}
