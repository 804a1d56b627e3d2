// TTT / Gram on (A, I, B) views:  z[i, r] = sum_{a,b} x[a, i, b] * y[a, r, b].
//
// Replaces the Pallas kernel repro/kernels/ttt.py::ttt_pallas3.  The output
// (I x R) is small and the reduction (K = A*B) long -- 76,800 deep for the
// last mode of a (320, 240, 7000) tensor -- so the reduction is split across
// blocks into fp32 partial sums, which a second small kernel adds in split
// order: deterministic, no atomics.
//
// Bound: for a skinny R (the ALS TTT, R = 10) the kernel reads x once and is
// bound by its bytes; for the Gram of a wide mode (I = R = 1340) it is bound
// by fp32 FFMA (TF32 tensor cores cannot meet the fp32 tolerance).  Three
// paths, all reading x in place with no padding or unfold:
//   * B == 1, R <= 16 (the last mode): one thread per column i.  Row k of x
//     is contiguous along i, so each load is coalesced; y's rows are staged
//     in shared memory and read as a broadcast; the R sums stay in registers.
//   * R <= 16 otherwise: the tile kernel of contract.cuh with a 128 x 16 tile.
//   * R > 16: the tile kernel with 128 x 128 tiles; for the Gram (y is x)
//     only the upper-triangular tiles are computed and the finish kernel
//     mirrors them, which halves the FFMA.
#include "contract.cuh"

using namespace atucker;

namespace {

template <typename T, int TJ, int TR, int TK>
__global__ void __launch_bounds__(TJ)
ttt_cols_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ out,
                int I, int R, long long K, long long k_per_split) {
  __shared__ __align__(16) float ys[TK][TR];
  const int i = blockIdx.x * TJ + threadIdx.x;
  const long long kb = (long long)blockIdx.y * k_per_split;
  const long long ke = min(K, kb + k_per_split);
  const bool valid = i < I;
  float acc[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = 0.f;
  for (long long k0 = kb; k0 < ke; k0 += TK) {
    for (int e = threadIdx.x; e < TK * TR; e += TJ) {
      const int kk = e / TR, r = e % TR;
      const long long k = k0 + kk;
      ys[kk][r] = (k < ke && r < R) ? to_f32(y[k * R + r]) : 0.f;
    }
    __syncthreads();
    const int kend = (int)min((long long)TK, ke - k0);
    if (valid) {
      const T* xp = x + k0 * I + i;
#pragma unroll 8
      for (int kk = 0; kk < kend; ++kk) {
        const float xv = to_f32(xp[(long long)kk * I]);
        float yv[TR];
        load_vec<TR>(yv, &ys[kk][0]);
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r] = fmaf(xv, yv[r], acc[r]);
      }
    }
    __syncthreads();
  }
  if (!valid) return;
  float* o = out + (long long)blockIdx.y * I * R + (long long)i * R;
#pragma unroll
  for (int r = 0; r < TR; ++r)
    if (r < R) o[r] = acc[r];
}

// z[i, r] = sum over splits of the partial sums, in split order.  With
// sym_tile > 0 only upper tiles (i / sym_tile <= r / sym_tile) were computed:
// a lower-tile entry reads its mirror (r, i).
__global__ void ttt_finish_kernel(const float* __restrict__ ws, float* __restrict__ z,
                                  int I, int R, int splits, int sym_tile) {
  const long long n = (long long)I * R;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  long long src = idx;
  if (sym_tile > 0) {
    const int i = (int)(idx / R), r = (int)(idx % R);
    if (i / sym_tile > r / sym_tile) src = (long long)r * R + i;
  }
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[(long long)p * n + src];
  z[idx] = s;
}

// info != nullptr: report the launch figures (describe()) instead of launching
template <typename T>
cudaError_t dispatch(const void* x, const void* y, float* part, int A, int I, int R,
                     int B, int splits, long long k_per_split, bool sym,
                     cudaStream_t st, int* info = nullptr) {
  // paths mirrored in repro_torch/kernels/ttt.py (_path)
  const long long K = (long long)A * B;
  if (B == 1 && R <= 16) {
    constexpr int TJ = 128, TK = 64;
    if (k_per_split % TK != 0) return cudaErrorInvalidValue;
    if (info != nullptr)
      return describe(ttt_cols_kernel<T, TJ, 16, TK>, TJ, (long long)ceil_div(I, TJ) * splits,
                      info);
    dim3 grid(ceil_div(I, TJ), splits);
    ttt_cols_kernel<T, TJ, 16, TK><<<grid, TJ, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), part, I, R, K, k_per_split);
    return cudaGetLastError();
  }
  const Operand P{x, B, (long long)I * B, I}, Q{y, B, (long long)R * B, R};
  if (R <= 16)
    return launch_contract<T, 128, 16, 32, 4, 2>(P, Q, part, K, splits, k_per_split,
                                                 false, st, info);
  return launch_contract<T, 128, 128, 16, 8, 8>(P, Q, part, K, splits, k_per_split, sym,
                                                st, info);
}

}  // namespace

// sym = 1 promises y == x (a Gram); it takes effect on the R > 16 path.
extern "C" int atucker_ttt(const void* x, const void* y, void* ws, void* z, int A, int I,
                           int R, int B, int dtype, int splits, long long k_per_split, int sym,
                           void* stream) {
  if (A <= 0 || I <= 0 || R <= 0 || B <= 0 || splits <= 0) return cudaErrorInvalidValue;
  const bool mirror = sym && R > 16;
  if (mirror && (R != I || x != y)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool finish = splits > 1 || mirror;
  float* part = finish ? static_cast<float*>(ws) : static_cast<float*>(z);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(x, y, part, A, I, R, B, splits, k_per_split, mirror, st);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(x, y, part, A, I, R, B, splits, k_per_split, mirror, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || !finish) return (int)err;
  const long long n = (long long)I * R;
  ttt_finish_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(z), I, R, splits, mirror ? 128 : 0);
  return (int)cudaGetLastError();
}

// Launch figures of a call of this shape, for reports: out[0..3] for the
// contraction kernel, out[4..7] for the finish kernel when it runs.
extern "C" int atucker_ttt_info(int A, int I, int R, int B, int dtype, int splits,
                                long long k_per_split, int sym, int* out) {
  if (A <= 0 || I <= 0 || R <= 0 || B <= 0 || splits <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i) out[i] = 0;
  const bool mirror = sym && R > 16;
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(nullptr, nullptr, nullptr, A, I, R, B, splits, k_per_split, mirror,
                          0, out);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, A, I, R, B, splits, k_per_split,
                                  mirror, 0, out);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || !(splits > 1 || mirror)) return (int)err;
  return (int)describe(ttt_finish_kernel, 256, ceil_div((long long)I * R, 256), out + 4);
}
