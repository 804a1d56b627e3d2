// Boundary-mode TTM as one GEMM:  C (M, N) = A (M, K) @ B (K, N), fp32 out.
//
// Replaces the Pallas kernel repro/kernels/matmul.py::matmul.  The first mode
// computes u (R, I) @ X (I, J) and the last mode X (J, I) @ u^T (I, R); in
// both the TTM output is skinny (R of a few dozen) and the tensor X is large.
// Two routes, a pure function of (M, N) (mirrored in
// repro_torch/kernels/matmul.py, route()):
//
//   * slab (R = min(M, N) <= 16).  Bound by the bytes of X.  contract.cuh's
//     FFMA tile kernel (shared with ttt.cu), reading A as a (1, M, K) view
//     and B as a (K, N, 1) view: a 16 x 128 tile (first mode, N > M) or 128
//     x 16 (last mode, N <= M) holds all outputs of its strip of X, so a
//     block reads its strip once.  Ragged edges are masked; nothing is
//     padded.
//   * wide (R > 16).  16-wide slabs would read X once per 16 outputs, and
//     a single FFMA pass is above the bytes bound from R ~ 40 on (67
//     TFLOP/s), so the product runs on the tensor cores
//     at fp32 accuracy, reading X once for R <= 128: wgmma.cuh's wide route
//     with a batch of one (split-TF32 wgmma, X by TMA or plain loads, u
//     pre-split into the caller's workspace, each stage's hi*hi summed
//     exactly on a grid and added in fp32).  The first mode (N > M) gives it
//     X = B (K, N) and u = A; the last mode (N <= M) x = A (M, K), K-major
//     (the NK layout: TMA boxes of 32 k by 128 rows), and u = B^T, read
//     through strides from B (K, R); C (M, R) is written through strides.
#include "contract.cuh"
#include "wgmma.cuh"

using namespace atucker;

namespace {

constexpr int ROUTE_SLAB = 0, ROUTE_WIDE = 1;

// The route a call takes (mirrored in repro_torch/kernels/matmul.py, route()).
int route_of(int M, int N) { return (N > M ? M : N) > 16 ? ROUTE_WIDE : ROUTE_SLAB; }

// info != nullptr: report the launch figures (describe()) instead of launching
template <typename T>
cudaError_t dispatch(const void* a, const void* b, float* c, void* ws, int M, int N, int K,
                     int route, cudaStream_t st, int* info = nullptr) {
  if (info != nullptr) info[13] = route;
  if (route == ROUTE_WIDE) {
    if (N > M) {  // first mode: C (R, N) = u (R, K) @ X (K, N), X = b
      const bool tma = reinterpret_cast<uintptr_t>(b) % 16 == 0 && (long long)N * sizeof(T) % 16 == 0;
      const wide::Call q{a, b, c, ws, M, N, K, 1, (long long)K * N, 0, N, 1, K, 1, 0, tma, false};
      return wide::launch<T>(q, st, info);
    }
    // last mode: C (M, R) = x (M, K) @ u^T, u^T = b (K, R); x K-major
    const bool tma = reinterpret_cast<uintptr_t>(a) % 16 == 0 && (long long)K * sizeof(T) % 16 == 0;
    const wide::Call q{b, a, c, ws, N, M, K, 1, (long long)M * K, 0, 1, N, 1, N, 0, tma, true};
    return wide::launch<T>(q, st, info);
  }
  const Operand P{a, K, (long long)M * K, M}, Q{b, 1, N, N};
  const long long k_all = ((long long)K + 31) / 32 * 32;  // one split: all of K
  if (N <= M)  // last mode: X (J, I) @ u^T
    return launch_contract<T, 128, 16, 32, 4, 2>(P, Q, c, K, 1, k_all, st, info);
  // first mode, R <= 16: u @ X (I, J)
  return launch_contract<T, 16, 128, 32, 2, 4>(P, Q, c, K, 1, k_all, st, info);
}

}  // namespace

// ws: the wide route's image of u (kernels/matmul.py workspace_bytes); unused
// by the slab route.
extern "C" int atucker_matmul(const void* a, const void* b, void* c, void* ws, int M, int N,
                              int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int route = route_of(M, N);
  if (route == ROUTE_WIDE && ws == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  if (dtype == kFloat32) return (int)dispatch<float>(a, b, out, ws, M, N, K, route, st);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(a, b, out, ws, M, N, K, route, st);
  return cudaErrorInvalidValue;
}

// Launch figures of a call of these operands and shape, for reports:
// out[0..3] the GEMM kernel (registers per thread, threads per block,
// resident blocks per SM and grid blocks), out[4..7] the wide route's image
// kernel, out[12] the GEMM's dynamic shared memory in bytes (wide), out[13]
// the route (0 slab, 1 wide), out[14] 1 when X arrives by TMA plus 2 on the
// last mode (wide), out[15] the ring's stages (wide).  The wide route
// reports its first chunk of wide::CHUNK outputs.  a and b are only
// inspected for alignment.
extern "C" int atucker_matmul_info(const void* a, const void* b, int M, int N, int K, int dtype,
                                   int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  const int route = route_of(M, N);
  if (dtype == kFloat32)
    return (int)dispatch<float>(a, b, nullptr, nullptr, M, N, K, route, 0, out);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(a, b, nullptr, nullptr, M, N, K, route, 0, out);
  return cudaErrorInvalidValue;
}
