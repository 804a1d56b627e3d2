// Boundary-mode TTM as one GEMM:  C (M, N) = A (M, K) @ B (K, N), fp32 out.
//
// Replaces the Pallas kernel repro/kernels/matmul.py::matmul.  The first mode
// computes u (R, I) @ X (I, J) and the last mode X (J, I) @ u^T (I, R); in
// both the TTM output is skinny (R of a few dozen at most) and the tensor X
// is large, so the kernel is bound by the bytes of X.  The design streams X
// through memory once: the output tile spans all R outputs of its row strip
// (last mode: a 128 x 16 tile, R <= 16) or column strip (first mode: 16 x
// 128), so a block reads its strip of X exactly once and R is never padded
// to a 128-wide tile.  The narrower of M and N takes the 16-wide side; an R
// above 16 takes more 16-wide tiles, each reading X again.  The tile kernel
// is contract.cuh's (shared with ttt.cu), reading A as a (1, M, K) view and
// B as a (K, N, 1) view: fp32 FFMA from shared-memory tiles into register
// micro-tiles, the next tile's loads in flight during the current tile's
// FFMA (TF32 cannot meet the fp32 tolerance).  Ragged edges are masked;
// nothing is padded.
#include "contract.cuh"

using namespace atucker;

namespace {

template <typename T>
cudaError_t dispatch(const void* a, const void* b, float* c, int M, int N, int K,
                     cudaStream_t st, int* info = nullptr) {
  const Operand P{a, K, (long long)M * K, M}, Q{b, 1, N, N};
  const long long k_all = ((long long)K + 31) / 32 * 32;  // one split: all of K
  if (N <= M)  // last mode: X (J, I) @ u^T
    return launch_contract<T, 128, 16, 32, 4, 2>(P, Q, c, K, 1, k_all, st, info);
  // first mode: u @ X (I, J)
  return launch_contract<T, 16, 128, 32, 2, 4>(P, Q, c, K, 1, k_all, st, info);
}

}  // namespace

extern "C" int atucker_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                              int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  if (dtype == kFloat32) return (int)dispatch<float>(a, b, out, M, N, K, st);
  if (dtype == kBFloat16) return (int)dispatch<__nv_bfloat16>(a, b, out, M, N, K, st);
  return cudaErrorInvalidValue;
}

// Launch figures of a call of this shape, for reports: out[0..3] =
// registers per thread, threads per block, resident blocks per SM and grid
// blocks (out[4..11] zero: one kernel).
extern "C" int atucker_matmul_info(int M, int N, int K, int dtype, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i) out[i] = 0;
  if (dtype == kFloat32) return (int)dispatch<float>(nullptr, nullptr, nullptr, M, N, K, 0, out);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, M, N, K, 0, out);
  return cudaErrorInvalidValue;
}
