// Mamba-1 selective scan (S6), forward, with an initial and a final state:
//   h_t = exp(dt_t * a) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t,     y_t = h_t · C_t
// x, dt, y: (Bt, T, Di) row-major; B, C: (Bt, T, N) with the last axis
// contiguous and the two leading strides given (the model's B and C are
// column slices of one projection); a: (Di, N); h0, h_final: (Bt, Di, N).
// x, B and C are fp32 or bf16, converted on load; dt, a, h and y are fp32.
//
// Replaces the Pallas kernel repro/kernels/s6_scan.py::s6_scan_fwd and adds
// the h0 / h_final carry that serving needs (prefill starts from the cached
// state and hands its final state to decode; decode is this scan at T = 1).
//
// What bounds it on the H100: the T·Di·N exponentials on the SFU (16 per
// clock per SM) and the ~10 bytes of x, dt and y per (t, d); at the longest
// prefill (1, 8191, 8192, 16) both are about 0.2-0.3 ms.
//
// Two routes, chosen by the Python wrapper from the shape alone:
//
// Both routes can keep, for the backward (csrc/s6_scan_bwd.cu), the state
// at the entry of every chunk of Lc steps, (K, Bt, Di, N) fp32: the chunked
// route's phase B forms them anyway, and the single pass writes them to
// `hs` at a stride given by the wrapper (a multiple of its TC steps) when
// `hs` is not null.
//
// Single pass (atucker_s6_scan), for short scans and decode: one launch.
// Each block owns CH channels of one batch row and walks all of T itself.
// Each channel is spread over L = 4 neighbouring lanes, each holding
// S = ceil(N / 4) of its states in registers, and y_t is the sum over those
// 4 lanes (two xor shuffles).  Chunks of TC steps of x and dt (coalesced
// along d) and of B and C (shared by every channel of the row) are staged in
// shared memory; y is staged there too and written back coalesced.  At batch
// 1 the grid is only 256 blocks, two per SM, so a long scan is a serial walk
// on too few warps: latency-bound at ~290 ns per step.
//
// Chunked (atucker_s6_scan_chunked), for long scans: parallel over T in
// chunks of Lc steps, in three launches.
//   A. every (chunk, b, d) scans its chunk from a zero state and writes its
//      local final state h_loc (N floats) and S = Σ dt over the chunk: the
//      chunk's decay of state n is exactly exp(a[d, n] · S);
//   B. every (b, d, n) chains the chunks in order from h0:
//      H_k = exp(a · S_k) · H_{k-1} + h_loc_k, overwriting h_loc_k with the
//      chunk's entry state H_{k-1}, and writes h_final;
//   C. every (chunk, b, d) rescans its chunk from its entry state and
//      writes y.
// In A and C one thread owns one channel with all N states in registers (no
// shuffles), and a batch-1 prefill of 8191 steps gives 64 × 64 blocks of
// 128 threads: enough independent warps to keep the SFU busy.  A and C
// each take the T·Di·N exponentials once, twice the function's count.
// Every exponent is dt·a <= 0 or a·S <= 0, so every factor lies in (0, 1]:
// nothing is formed as exp(-cumsum), which overflows fp32 at this model's
// step sizes; underflow to 0 is harmless.  Scratch (from the wrapper):
// h_loc (K, Bt, Di, N) and S (K, Bt, Di), fp32.
//
// exp(v) is ex2.approx.ftz(v · log2 e) with a·log2 e folded in once per
// state.  Ragged T, Di and N are masked, nothing is padded, and memory is
// indexed in 64 bits.
#include "common.cuh"

using namespace atucker;

namespace {

constexpr int L = 4;               // lanes per channel
constexpr int CH = 32;             // channels per block
constexpr int TC = 32;             // time steps per staged chunk
constexpr int THREADS = L * CH;
constexpr int kMaxN = 64;          // S <= 16 states per lane
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename E, int S>
__global__ void __launch_bounds__(THREADS)
s6_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const E* __restrict__ bm, const E* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hf,
               float* __restrict__ hs, int stride, int T, int Di,
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
    if (hs != nullptr && t0 % stride == 0 && dvalid) {
      // the entry state of chunk t0 / stride, (K, Bt, Di, N)
      const long long srow = ((long long)(t0 / stride) * gridDim.y + b) * Di + d;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int n = lane * S + s;
        if (n < N) hs[srow * N + n] = h[s];
      }
    }
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
                   const float* a, const float* h0, float* y, float* hf, float* hs,
                   int stride, int B, int T, int Di, int N, long long sbb, long long sbt,
                   long long scb, long long sct, cudaStream_t st) {
  dim3 grid(ceil_div(Di, CH), B);
  s6_scan_kernel<E, S><<<grid, THREADS, 0, st>>>(
      static_cast<const E*>(x), dt, static_cast<const E*>(bm), static_cast<const E*>(cm),
      a, h0, y, hf, hs, stride, T, Di, N, sbb, sbt, scb, sct);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* x, const float* dt, const void* bm, const void* cm,
                     const float* a, const float* h0, float* y, float* hf, float* hs,
                     int stride, int B, int T, int Di, int N, long long sbb,
                     long long sbt, long long scb, long long sct, cudaStream_t st) {
#define S6_LAUNCH(S)                                                                  \
  launch<E, S>(x, dt, bm, cm, a, h0, y, hf, hs, stride, B, T, Di, N, sbb, sbt, scb, sct, \
               st)
  if (N <= 1 * L) return S6_LAUNCH(1);
  if (N <= 2 * L) return S6_LAUNCH(2);
  if (N <= 4 * L) return S6_LAUNCH(4);
  if (N <= 8 * L) return S6_LAUNCH(8);
  return S6_LAUNCH(16);
#undef S6_LAUNCH
}

// ---------------------------------------------------------------------------
// chunked route
// ---------------------------------------------------------------------------

constexpr int CT = 128;            // channels per block in phases A and C
constexpr int TS = 32;             // steps per staged slice of B and C
// resident blocks per SM asked of the compiler: 32 warps to hide the
// per-step load and SFU latency (it holds the registers to 64 a thread)
constexpr int MIN_BLOCKS = 8;

// Phase A (EMIT_Y = false): scan chunk blockIdx.y of row blockIdx.z from a
// zero state; write h_loc to hs and Σ dt to ssum.  Phase C (EMIT_Y = true):
// scan it from the entry state in hs and write y.  NS >= N states per
// thread; the states n >= N carry zeros (a = 0, B = C = 0).
template <typename E, int NS, bool EMIT_Y>
__global__ void __launch_bounds__(CT, MIN_BLOCKS)
s6_chunk_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                const E* __restrict__ bm, const E* __restrict__ cm,
                const float* __restrict__ a, float* __restrict__ hs,
                float* __restrict__ ssum, float* __restrict__ y, int T, int Di,
                int N, int Lc, long long sbb, long long sbt, long long scb,
                long long sct) {
  __shared__ __align__(16) float bs[TS][NS];
  __shared__ __align__(16) float cs[EMIT_Y ? TS : 1][NS];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * CT + tid;
  const int k = blockIdx.y, b = blockIdx.z, Bt = gridDim.z;
  const bool dvalid = d < Di;
  const int t0 = k * Lc;
  const int tl = min(Lc, T - t0);
  const long long hrow = (((long long)k * Bt + b) * Di + d) * N;   // (K, Bt, Di, N)

  float al[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const bool ok = dvalid && n < N;
    al[n] = ok ? a[(long long)d * N + n] * kLog2e : 0.f;
    h[n] = (EMIT_Y && ok) ? hs[hrow + n] : 0.f;
  }
  float dsum = 0.f;

  const long long row0 = (long long)b * T + t0;   // (b, t0) row of x, dt, y
  for (int s0 = 0; s0 < tl; s0 += TS) {
    const int sl = min(TS, tl - s0);
    __syncthreads();                  // the previous slice's reads are done
    for (int e = tid; e < TS * NS; e += CT) {
      const int tt = e / NS, n = e % NS;
      const bool ok = tt < sl && n < N;
      const long long t = t0 + s0 + tt;
      bs[tt][n] = ok ? to_f32(bm[b * sbb + t * sbt + n]) : 0.f;
      if constexpr (EMIT_Y) cs[tt][n] = ok ? to_f32(cm[b * scb + t * sct + n]) : 0.f;
    }
    __syncthreads();
    if (dvalid) {
      const long long off0 = (row0 + s0) * Di + d;
#pragma unroll 4
      for (int tt = 0; tt < sl; ++tt) {
        const long long off = off0 + (long long)tt * Di;
        const float dv = dt[off];
        const float u = dv * to_f32(x[off]);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NS; n += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(&bs[tt][n]);
          h[n + 0] = fmaf(ex2(dv * al[n + 0]), h[n + 0], u * bv.x);
          h[n + 1] = fmaf(ex2(dv * al[n + 1]), h[n + 1], u * bv.y);
          h[n + 2] = fmaf(ex2(dv * al[n + 2]), h[n + 2], u * bv.z);
          h[n + 3] = fmaf(ex2(dv * al[n + 3]), h[n + 3], u * bv.w);
          if constexpr (EMIT_Y) {
            const float4 cv = *reinterpret_cast<const float4*>(&cs[tt][n]);
            acc = fmaf(h[n + 0], cv.x, acc);
            acc = fmaf(h[n + 1], cv.y, acc);
            acc = fmaf(h[n + 2], cv.z, acc);
            acc = fmaf(h[n + 3], cv.w, acc);
          }
        }
        if constexpr (EMIT_Y) y[off] = acc;
        else dsum += dv;
      }
    }
  }
  if (EMIT_Y || !dvalid) return;
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (n < N) hs[hrow + n] = h[n];
  ssum[((long long)k * Bt + b) * Di + d] = dsum;
}

// Phase B: one thread per state (b, d, n) walks the K chunks in order.
__global__ void __launch_bounds__(256)
s6_chain_kernel(const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ hs, const float* __restrict__ ssum,
                float* __restrict__ hf, int Bt, int Di, int N, int K) {
  const long long BDN = (long long)Bt * Di * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BDN) return;
  const long long bd = idx / N;                      // b * Di + d
  const int n = (int)(idx - bd * N);
  const int d = (int)(bd % Di);
  const float al = a[(long long)d * N + n] * kLog2e;
  const long long BD = (long long)Bt * Di;
  float H = h0 != nullptr ? h0[idx] : 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float s = ssum[k * BD + bd];
    float* slot = hs + k * BDN + idx;
    const float hl = *slot;
    *slot = H;                                       // the chunk's entry state
    H = fmaf(ex2(s * al), H, hl);
  }
  hf[idx] = H;
}

template <typename E, int NS>
cudaError_t launch_chunked(const void* x, const float* dt, const void* bm, const void* cm,
                           const float* a, const float* h0, float* y, float* hf, float* hs,
                           float* ssum, int B, int T, int Di, int N, int Lc, long long sbb,
                           long long sbt, long long scb, long long sct, cudaStream_t st) {
  const int K = ceil_div(T, Lc);
  const dim3 grid(ceil_div(Di, CT), K, B);
  const E* xe = static_cast<const E*>(x);
  const E* be = static_cast<const E*>(bm);
  const E* ce = static_cast<const E*>(cm);
  s6_chunk_kernel<E, NS, false><<<grid, CT, 0, st>>>(xe, dt, be, ce, a, hs, ssum, nullptr, T,
                                                     Di, N, Lc, sbb, sbt, scb, sct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long states = (long long)B * Di * N;
  s6_chain_kernel<<<(unsigned)((states + 255) / 256), 256, 0, st>>>(a, h0, hs, ssum, hf, B, Di,
                                                                    N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  s6_chunk_kernel<E, NS, true><<<grid, CT, 0, st>>>(xe, dt, be, ce, a, hs, nullptr, y, T, Di,
                                                    N, Lc, sbb, sbt, scb, sct);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_chunked(const void* x, const float* dt, const void* bm, const void* cm,
                             const float* a, const float* h0, float* y, float* hf, float* hs,
                             float* ssum, int B, int T, int Di, int N, int Lc, long long sbb,
                             long long sbt, long long scb, long long sct, cudaStream_t st) {
#define S6_CHUNKED(NS)                                                                   \
  launch_chunked<E, NS>(x, dt, bm, cm, a, h0, y, hf, hs, ssum, B, T, Di, N, Lc, sbb, sbt, \
                        scb, sct, st)
  if (N <= 4) return S6_CHUNKED(4);
  if (N <= 8) return S6_CHUNKED(8);
  if (N <= 16) return S6_CHUNKED(16);
  if (N <= 32) return S6_CHUNKED(32);
  return S6_CHUNKED(64);
#undef S6_CHUNKED
}

template <typename E, int NS>
cudaError_t info_for(int B, int T, int Di, int N, int Lc, int chunked, int* out) {
  if (!chunked)
    return describe(s6_scan_kernel<E, (NS + L - 1) / L>, THREADS,
                    (long long)ceil_div(Di, CH) * B, out);
  const long long blocks = (long long)ceil_div(Di, CT) * ceil_div(T, Lc) * B;
  cudaError_t err = describe(s6_chunk_kernel<E, NS, false>, CT, blocks, out);
  if (err == cudaSuccess)
    err = describe(s6_chain_kernel, 256, ((long long)B * Di * N + 255) / 256, out + 4);
  if (err == cudaSuccess) err = describe(s6_chunk_kernel<E, NS, true>, CT, blocks, out + 8);
  return err;
}

template <typename E>
cudaError_t info(int B, int T, int Di, int N, int Lc, int chunked, int* out) {
  if (N <= 4) return info_for<E, 4>(B, T, Di, N, Lc, chunked, out);
  if (N <= 8) return info_for<E, 8>(B, T, Di, N, Lc, chunked, out);
  if (N <= 16) return info_for<E, 16>(B, T, Di, N, Lc, chunked, out);
  if (N <= 32) return info_for<E, 32>(B, T, Di, N, Lc, chunked, out);
  return info_for<E, 64>(B, T, Di, N, Lc, chunked, out);
}

}  // namespace

// hs: null, or (ceil(T / stride), B, Di, N) fp32 receiving the state at the
// entry of every `stride` steps (stride a positive multiple of TC).
extern "C" int atucker_s6_scan(const void* x, const void* dt, const void* bm,
                               const void* cm, const void* a, const void* h0, void* y,
                               void* hf, void* hs, int stride, int B, int T, int Di, int N,
                               long long sbb, long long sbt, long long scb, long long sct,
                               int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Di <= 0 || N <= 0 || N > kMaxN ||
      (hs != nullptr && (stride <= 0 || stride % TC != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hfp = static_cast<float*>(hf);
  float* hsp = static_cast<float*>(hs);
  if (dtype == kFloat32)
    return (int)dispatch<float>(x, dtp, bm, cm, ap, h0p, yp, hfp, hsp, stride, B, T, Di, N,
                                sbb, sbt, scb, sct, st);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(x, dtp, bm, cm, ap, h0p, yp, hfp, hsp, stride, B, T,
                                        Di, N, sbb, sbt, scb, sct, st);
  return cudaErrorInvalidValue;
}

extern "C" int atucker_s6_scan_chunked(const void* x, const void* dt, const void* bm,
                                       const void* cm, const void* a, const void* h0,
                                       void* y, void* hf, void* hs, void* ssum, int B, int T,
                                       int Di, int N, int chunk, long long sbb, long long sbt,
                                       long long scb, long long sct, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Di <= 0 || N <= 0 || N > kMaxN || chunk <= 0 ||
      ceil_div(T, chunk) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hfp = static_cast<float*>(hf);
  float* hsp = static_cast<float*>(hs);
  float* ssp = static_cast<float*>(ssum);
  if (dtype == kFloat32)
    return (int)dispatch_chunked<float>(x, dtp, bm, cm, ap, h0p, yp, hfp, hsp, ssp, B, T, Di,
                                        N, chunk, sbb, sbt, scb, sct, st);
  if (dtype == kBFloat16)
    return (int)dispatch_chunked<__nv_bfloat16>(x, dtp, bm, cm, ap, h0p, yp, hfp, hsp, ssp, B,
                                                T, Di, N, chunk, sbb, sbt, scb, sct, st);
  return cudaErrorInvalidValue;
}

// Launch figures of the route a call of this shape takes, for reports:
// out[4 k .. 4 k + 3] = registers per thread, threads per block, resident
// blocks per SM and grid blocks of its k-th kernel (one single-pass kernel,
// or phases A, B and C).
extern "C" int atucker_s6_scan_info(int B, int T, int Di, int N, int chunk, int chunked,
                                    int dtype, int* out) {
  if (B <= 0 || T <= 0 || Di <= 0 || N <= 0 || N > kMaxN || chunk <= 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i) out[i] = 0;
  if (dtype == kFloat32) return (int)info<float>(B, T, Di, N, chunk, chunked, out);
  if (dtype == kBFloat16) return (int)info<__nv_bfloat16>(B, T, Di, N, chunk, chunked, out);
  return cudaErrorInvalidValue;
}
