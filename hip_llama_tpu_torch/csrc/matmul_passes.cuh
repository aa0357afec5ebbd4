// Passes shared by the weight-only matmuls (quant.cu, quant4.cu), with their
// host launchers: the rmsnorm prologue, one CTA per row, writing xn once;
// the `a8` mode's activation quantizer (a8.cuh), one CTA per row with the
// rmsnorm prologue fused, writing xi and sx once; and the second pass of
// the split-K GEMV path, which adds the splits' fp32 partials (split, M, N)
// in a fixed order through q8.cuh's epilogue (one thread per output column
// pair) or gate (one per output). Each source keeps its own copy (an
// anonymous namespace), as if written in it.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::q8;
using hipllama::to_f;
using hipllama::warp_max;

constexpr int kEltThreads = 256;  // threads per CTA of the elementwise passes

__global__ void __launch_bounds__(kThreads) rmsnorm_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ g, bf16* __restrict__ xn, int K,
    float eps) {
  __shared__ float red[kWarps];
  rmsnorm_row(x + (size_t)blockIdx.x * K, g, xn + (size_t)blockIdx.x * K, K, eps, red);
}

// row blockIdx.x of x (M, K), normed by g where g is given (rounded to bf16
// as rmsnorm_rows_kernel writes it), quantized per group of gs: sx[row,
// grp] = max|v| * fp32(1/127), 1 where zero; xi = round-half-even(v / sx),
// an IEEE division. A warp takes a group at a time.
__global__ void __launch_bounds__(kThreads) a8_quant_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ g, int8_t* __restrict__ xi,
    float* __restrict__ sx, int K, int gs, float eps) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * K;
  const float r = g != nullptr ? rms_rsqrt(xr, K, eps, red) : 1.f;
  const int G = K / gs;
  for (int gi = warp; gi < G; gi += kWarps) {
    const int kb = gi * gs;
    float am = 0.f;
    for (int i = lane; i < gs; i += 32)
      am = fmaxf(am, fabsf(g != nullptr ? normed(xr, g, r, kb + i) : to_f(xr[kb + i])));
    am = warp_max(am);
    float sc = am * (1.0f / 127.0f);
    if (sc == 0.f) sc = 1.f;
    for (int i = lane; i < gs; i += 32) {
      const float v = g != nullptr ? normed(xr, g, r, kb + i) : to_f(xr[kb + i]);
      xi[row * K + kb + i] = (int8_t)__float2int_rn(__fdiv_rn(v, sc));
    }
    if (lane == 0) sx[row * G + gi] = sc;
  }
}

__global__ void split_epilogue_kernel(const float* __restrict__ part, int split, int M, int N,
                                      Epilogue e, bf16* __restrict__ out, int planes) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * (N / 2)) split_epilogue_at(part, split, M, N, e, out, idx, planes);
}

__global__ void split_gate_kernel(const float* __restrict__ part, int split, int M, int H,
                                  bf16* __restrict__ out, int planes) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * H) split_gate_at(part, split, M, H, out, idx, planes);
}

// cs (M, hs) fp32: row m's RoPE cos and sin of each pair (q8.cuh::
// rope_cs_at), for an epilogue that reads them (Epilogue::rope_cs) rather
// than evaluating them for every column pair of every head
__global__ void rope_table_kernel(const int* __restrict__ pos, int M, int hs, float coef,
                                  float* __restrict__ cs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * (hs / 2)) return;
  const int m = idx / (hs / 2), p = idx % (hs / 2);
  *reinterpret_cast<float2*>(cs + (size_t)m * hs + 2 * p) = rope_cs_at(pos, m, p, coef);
}

int check_launch() { return (int)cudaGetLastError(); }

int blocks(long long n) { return (int)((n + kEltThreads - 1) / kEltThreads); }

int launch_rope_table(const void* pos, int M, int hs, float coef, float* cs, cudaStream_t st) {
  rope_table_kernel<<<blocks((long long)M * (hs / 2)), kEltThreads, 0, st>>>((const int*)pos, M,
                                                                            hs, coef, cs);
  return check_launch();
}

int launch_norm(const void* x, const void* g, void* xn, int M, int K, float eps, cudaStream_t st) {
  rmsnorm_rows_kernel<<<M, kThreads, 0, st>>>((const bf16*)x, (const float*)g, (bf16*)xn, K, eps);
  return check_launch();
}

int launch_a8_quant(const void* x, const void* g, void* xi, void* sx, int M, int K, int gs,
                    float eps, cudaStream_t st) {
  a8_quant_rows_kernel<<<M, kThreads, 0, st>>>((const bf16*)x, (const float*)g, (int8_t*)xi,
                                               (float*)sx, K, gs, eps);
  return check_launch();
}

// part (planes x split, M, N): planes 2 for an int4 weight in the `a8` mode
int launch_split_epilogue(const float* part, int split, int M, int N, const Epilogue& e, void* out,
                          cudaStream_t st, int planes = 1) {
  split_epilogue_kernel<<<blocks((long long)M * (N / 2)), kEltThreads, 0, st>>>(
      part, split, M, N, e, (bf16*)out, planes);
  return check_launch();
}

int launch_split_gate(const float* part, int split, int M, int H, void* out, cudaStream_t st,
                      int planes = 1) {
  split_gate_kernel<<<blocks((long long)M * H), kEltThreads, 0, st>>>(part, split, M, H,
                                                                      (bf16*)out, planes);
  return check_launch();
}

}  // namespace

#define HIPLLAMA_TRY(call)      \
  do {                          \
    const int rc_ = (call);     \
    if (rc_ != 0) return rc_;   \
  } while (0)
