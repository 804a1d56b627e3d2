// Mamba-1 selective scan (S6), forward, with an initial and a final state:
//   h_t = exp(dt_t * a) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t,     y_t = h_t · C_t
// x, dt, y: (Bt, T, Di) row-major; B, C: (Bt, T, N) with the last axis
// contiguous and the two leading strides given (the model's B and C are
// column slices of one projection); a: (Di, N); h0, h_final: (Bt, Di, N).
// x, B and C are fp32 or bf16, converted on load; dt, a, h and y are fp32.
//
// Replaces the Pallas kernel repro/kernels/s6_scan.py::s6_scan_fwd and adds
// the h0 / h_final carry that serving needs (prefill starts from the cached
// state and hands its final state to decode; decode is this kernel at T = 1).
//
// What bounds it on the H100: the T·Di·N exponentials on the SFU (16 per
// clock per SM) and the ~10 bytes of x, dt and y per (t, d); at the longest
// prefill (1, 8191, 8192, 16) both are about 0.2-0.3 ms.
//
// Design.  The TPU kernel carries the state across a sequential grid axis;
// Hopper runs blocks in no order, so each block owns CH channels of one
// batch row and walks all of T itself.  Each channel is spread over L = 4
// neighbouring lanes, each holding S = ceil(N / 4) of its states in
// registers, and y_t is the sum over those 4 lanes (two xor shuffles): at
// batch 1 the 8192 channels then make 256 blocks of 128 threads, about two
// per SM, where one thread per channel would leave half the SMs empty.
// Chunks of TC steps of x and dt (coalesced along d) and of B and C (shared
// by every channel of the row) are staged in shared memory; y is staged
// there too and written back coalesced.  exp(dt·a) is exp2f(dt · a·log2 e)
// with a·log2 e folded in once per thread.  Ragged T, Di and N are masked,
// nothing is padded, and memory is indexed in 64 bits.
#include "common.cuh"

using namespace atucker;

namespace {

constexpr int L = 4;               // lanes per channel
constexpr int CH = 32;             // channels per block
constexpr int TC = 32;             // time steps per staged chunk
constexpr int THREADS = L * CH;
constexpr int kMaxN = 64;          // S <= 16 states per lane
constexpr float kLog2e = 1.4426950408889634f;

template <typename E, int S>
__global__ void __launch_bounds__(THREADS)
s6_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const E* __restrict__ bm, const E* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hf, int T, int Di,
               int N, long long sbb, long long sbt, long long scb,
               long long sct) {
  constexpr int NP = L * S;        // states per channel, padded
  __shared__ float xs[TC][CH];
  __shared__ float ds[TC][CH];
  __shared__ float ys[TC][CH];
  __shared__ float bs[TC][NP];
  __shared__ float cs[TC][NP];

  const int tid = threadIdx.x;
  const int c = tid / L;           // channel within the block
  const int lane = tid % L;        // which S states of it
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool dvalid = d < Di;
  const long long hrow = ((long long)b * Di + d) * N;

  float al[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    const bool ok = dvalid && n < N;
    al[s] = ok ? a[(long long)d * N + n] * kLog2e : 0.f;
    h[s] = (ok && h0 != nullptr) ? h0[hrow + n] : 0.f;
  }

  const long long row0 = (long long)b * T;  // (b, t = 0) row of x, dt, y
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tl = min(TC, T - t0);
    for (int e = tid; e < TC * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      const bool ok = tt < tl && d0 + cc < Di;
      const long long off = (row0 + t0 + tt) * Di + d0 + cc;
      xs[tt][cc] = ok ? to_f32(x[off]) : 0.f;
      ds[tt][cc] = ok ? dt[off] : 0.f;
    }
    for (int e = tid; e < TC * NP; e += THREADS) {
      const int tt = e / NP, n = e % NP;
      const bool ok = tt < tl && n < N;
      const long long t = t0 + tt;
      bs[tt][n] = ok ? to_f32(bm[b * sbb + t * sbt + n]) : 0.f;
      cs[tt][n] = ok ? to_f32(cm[b * scb + t * sct + n]) : 0.f;
    }
    __syncthreads();
    // the loop bound is uniform over the block, so every lane reaches the
    // shuffles; masked channels and states carry zeros through
    for (int tt = 0; tt < tl; ++tt) {
      const float dv = ds[tt][c];
      const float u = dv * xs[tt][c];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int n = lane * S + s;
        h[s] = fmaf(exp2f(dv * al[s]), h[s], u * bs[tt][n]);
        acc = fmaf(h[s], cs[tt][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) ys[tt][c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < tl * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      if (d0 + cc < Di) y[(row0 + t0 + tt) * Di + d0 + cc] = ys[tt][cc];
    }
    // the next chunk's loads overwrite xs/ds/bs/cs only, and its first
    // barrier orders this write-back before ys is written again
  }

  if (!dvalid) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    if (n < N) hf[hrow + n] = h[s];
  }
}

template <typename E, int S>
cudaError_t launch(const void* x, const float* dt, const void* bm, const void* cm,
                   const float* a, const float* h0, float* y, float* hf, int B, int T,
                   int Di, int N, long long sbb, long long sbt, long long scb,
                   long long sct, cudaStream_t st) {
  dim3 grid(ceil_div(Di, CH), B);
  s6_scan_kernel<E, S><<<grid, THREADS, 0, st>>>(
      static_cast<const E*>(x), dt, static_cast<const E*>(bm), static_cast<const E*>(cm),
      a, h0, y, hf, T, Di, N, sbb, sbt, scb, sct);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* x, const float* dt, const void* bm, const void* cm,
                     const float* a, const float* h0, float* y, float* hf, int B, int T,
                     int Di, int N, long long sbb, long long sbt, long long scb,
                     long long sct, cudaStream_t st) {
#define S6_LAUNCH(S) \
  launch<E, S>(x, dt, bm, cm, a, h0, y, hf, B, T, Di, N, sbb, sbt, scb, sct, st)
  if (N <= 1 * L) return S6_LAUNCH(1);
  if (N <= 2 * L) return S6_LAUNCH(2);
  if (N <= 4 * L) return S6_LAUNCH(4);
  if (N <= 8 * L) return S6_LAUNCH(8);
  return S6_LAUNCH(16);
#undef S6_LAUNCH
}

}  // namespace

extern "C" int atucker_s6_scan(const void* x, const void* dt, const void* bm,
                               const void* cm, const void* a, const void* h0, void* y,
                               void* hf, int B, int T, int Di, int N, long long sbb,
                               long long sbt, long long scb, long long sct, int dtype,
                               void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Di <= 0 || N <= 0 || N > kMaxN)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hfp = static_cast<float*>(hf);
  if (dtype == kFloat32)
    return (int)dispatch<float>(x, dtp, bm, cm, ap, h0p, yp, hfp, B, T, Di, N, sbb, sbt,
                                scb, sct, st);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(x, dtp, bm, cm, ap, h0p, yp, hfp, B, T, Di, N,
                                        sbb, sbt, scb, sct, st);
  return cudaErrorInvalidValue;
}
