// Passes shared by the weight-only matmuls (quant.cu, quant4.cu), with their
// host launchers: the rmsnorm prologue, one CTA per row, writing xn once;
// and the second pass of the split-K GEMV path, which adds the splits' fp32
// partials (split, M, N) in a fixed order through q8.cuh's epilogue (one
// thread per output column pair) or gate (one per output). Each source
// keeps its own copy (an anonymous namespace), as if written in it.
#pragma once

#include "common.cuh"
#include "q8.cuh"

namespace {

using namespace hipllama::q8;

constexpr int kEltThreads = 256;  // threads per CTA of the elementwise passes

__global__ void __launch_bounds__(kThreads) rmsnorm_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ g, bf16* __restrict__ xn, int K,
    float eps) {
  __shared__ float red[kWarps];
  rmsnorm_row(x + (size_t)blockIdx.x * K, g, xn + (size_t)blockIdx.x * K, K, eps, red);
}

__global__ void split_epilogue_kernel(const float* __restrict__ part, int split, int M, int N,
                                      Epilogue e, bf16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * (N / 2)) split_epilogue_at(part, split, M, N, e, out, idx);
}

__global__ void split_gate_kernel(const float* __restrict__ part, int split, int M, int H,
                                  bf16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * H) split_gate_at(part, split, M, H, out, idx);
}

int check_launch() { return (int)cudaGetLastError(); }

int blocks(long long n) { return (int)((n + kEltThreads - 1) / kEltThreads); }

int launch_norm(const void* x, const void* g, void* xn, int M, int K, float eps, cudaStream_t st) {
  rmsnorm_rows_kernel<<<M, kThreads, 0, st>>>((const bf16*)x, (const float*)g, (bf16*)xn, K, eps);
  return check_launch();
}

int launch_split_epilogue(const float* part, int split, int M, int N, const Epilogue& e, void* out,
                          cudaStream_t st) {
  split_epilogue_kernel<<<blocks((long long)M * (N / 2)), kEltThreads, 0, st>>>(
      part, split, M, N, e, (bf16*)out);
  return check_launch();
}

int launch_split_gate(const float* part, int split, int M, int H, void* out, cudaStream_t st) {
  split_gate_kernel<<<blocks((long long)M * H), kEltThreads, 0, st>>>(part, split, M, H,
                                                                      (bf16*)out);
  return check_launch();
}

}  // namespace

#define HIPLLAMA_TRY(call)      \
  do {                          \
    const int rc_ = (call);     \
    if (rc_ != 0) return rc_;   \
  } while (0)
