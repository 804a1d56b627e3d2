// Shared helpers of the a-Tucker Hopper kernels (one shared library per
// source; every library gets its own copy of these).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace atucker {

// dtype codes passed from the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Launch figures of one kernel, for reports: out[0..3] = registers per
// thread, threads per block, resident blocks per SM (the occupancy
// calculator's, at smem bytes of dynamic shared memory) and grid blocks.
template <typename F>
cudaError_t describe(F* fn, int threads, long long blocks, int* out, size_t smem = 0) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  out[0] = attr.numRegs;
  out[1] = threads;
  out[2] = per_sm;
  out[3] = (int)blocks;
  return err;
}

}  // namespace atucker

extern "C" const char* atucker_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
