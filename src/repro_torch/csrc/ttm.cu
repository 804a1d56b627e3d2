// Interior-mode TTM on the (A, I, B) view:  out[a, r, b] = sum_i u[r, i] * x[a, i, b].
//
// Replaces the Pallas kernel repro/kernels/ttm.py::ttm_interior.  R is small
// (a few dozen at most) and x large, so the kernel is bound by the bytes of
// x.  Each thread owns one output column j = (a, b) of the flattened A*B
// axis -- consecutive threads take consecutive b, the contiguous axis, so
// every load of x is coalesced straight from its native layout with no
// unfold -- loops over I inside the block, and keeps all TR outputs of its
// column in registers.  u is staged in shared memory (transposed, read as a
// broadcast).  With R <= TR every element of x is read exactly once; a
// larger R takes more TR-wide slabs along grid.y, each reading x again.
// Flattening (a, b) keeps every thread busy whatever B is (a 264-wide B
// would waste half of a 256-wide b tile).  fp32 FFMA accumulation; ragged
// edges are masked, nothing is padded.
#include "common.cuh"

using namespace atucker;

namespace {

template <typename T, int TJ, int TR, int TI>
__global__ void __launch_bounds__(TJ)
ttm_interior_kernel(const T* __restrict__ u, const T* __restrict__ x,
                    float* __restrict__ out, int A, int I, int B, int R) {
  __shared__ __align__(16) float us[TI][TR];  // us[i][r] = u[r0 + r, i0 + i]
  const long long J = (long long)A * B;
  const long long j = (long long)blockIdx.x * TJ + threadIdx.x;
  const int r0 = blockIdx.y * TR;
  const bool valid = j < J;
  int a = 0, b = 0;
  if (valid) {
    a = (int)(j / B);
    b = (int)(j - (long long)a * B);
  }
  const T* xp = x + (long long)a * I * B + b;
  float acc[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = 0.f;

  for (int i0 = 0; i0 < I; i0 += TI) {
    for (int e = threadIdx.x; e < TI * TR; e += TJ) {
      const int ii = e % TI, rr = e / TI;  // consecutive threads walk i of u's row
      const int i = i0 + ii, r = r0 + rr;
      us[ii][rr] = (i < I && r < R) ? to_f32(u[(long long)r * I + i]) : 0.f;
    }
    __syncthreads();
    const int iend = min(TI, I - i0);
    if (valid) {
#pragma unroll 8
      for (int ii = 0; ii < iend; ++ii) {
        const float xv = to_f32(xp[(long long)(i0 + ii) * B]);
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) acc[rr] = fmaf(us[ii][rr], xv, acc[rr]);
      }
    }
    __syncthreads();
  }
  if (!valid) return;
  float* op = out + (long long)a * R * B + b;
#pragma unroll
  for (int rr = 0; rr < TR; ++rr) {
    const int r = r0 + rr;
    if (r < R) op[(long long)r * B] = acc[rr];
  }
}

template <typename T>
cudaError_t dispatch(const void* u, const void* x, float* out, int A, int I, int B, int R,
                     cudaStream_t st) {
  constexpr int TJ = 128, TR = 16, TI = 64;
  const long long blocks = ((long long)A * B + TJ - 1) / TJ;
  if (blocks > 0x7fffffffLL || ceil_div(R, TR) > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, ceil_div(R, TR));
  ttm_interior_kernel<T, TJ, TR, TI><<<grid, TJ, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(x), out, A, I, B, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" int atucker_ttm_interior(const void* u, const void* x, void* out, int A, int I,
                                    int B, int R, int dtype, void* stream) {
  if (A <= 0 || I <= 0 || B <= 0 || R <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == kFloat32) return (int)dispatch<float>(u, x, o, A, I, B, R, st);
  if (dtype == kBFloat16) return (int)dispatch<__nv_bfloat16>(u, x, o, A, I, B, R, st);
  return cudaErrorInvalidValue;
}
