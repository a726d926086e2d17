// Shared by the two MX dequant x matmul sources: mx_matmul.cu (f32
// activations, CUDA cores) and mx_matmul_tc.cu (bf16 activations, tensor
// cores).
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;     // K rows per scale block

// Sum the split-K partial outputs in split order (deterministic):
// s = ((0 + p0) + p1) + ..., the order in which the prefill kernels close
// their K groups.
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, long long mn,
                                 int splits) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
  out[i] = s;
}

inline cudaError_t split_sum(const float* partial, float* out, long long mn,
                             int splits, cudaStream_t st) {
  split_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      partial, out, mn, splits);
  return cudaGetLastError();
}

}  // namespace
