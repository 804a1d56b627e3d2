// Mamba-1 selective scan (S6), backward.  The forward (csrc/s6_scan.cu) is
//   h_t = exp(dt_t * a) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t,     y_t = h_t · C_t
// Given dy (Bt, T, Di) and dh_final (Bt, Di, N) or none, the state's
// gradient runs backwards in time,
//   g_t = C_t ⊗ dy_t + exp(dt_{t+1} * a) ⊙ g_{t+1}      (g_T's carry: dh_final)
// and the inputs' gradients are
//   dx_t  = dt_t Σ_n g_t B_t          ddt_t = Σ_n g_t ⊙ (a ⊙ exp(dt_t a) ⊙ h_{t-1} + x_t B_t)
//   dB_t  = Σ_d g_t dt_t x_t          dC_t  = Σ_d dy_t h_t
//   da    = Σ_{b,t} g_t dt_t exp(dt_t a) ⊙ h_{t-1}     dh0 = exp(dt_1 a) ⊙ g_1.
//
// It replaces no TPU kernel: the reference's Pallas scan is forward-only and
// its training differentiates the chunked jnp scan (repro/models/ssm.py),
// which forms exp(-cumsum) and overflows fp32 at falcon-mamba's step sizes.
// Autograd through a stable scan in PyTorch would save O(Bt·T·Di·N) floats
// per layer; this kernel keeps only the forward's chunk entry states hs
// (K, Bt, Di, N), one per Lc steps, and recomputes the rest.
//
// What bounds it on the H100: the exponentials.  Each step takes N of them
// four times (the local pass's forward recompute and reverse walk, the
// chunk pass's recompute and reverse walk) on the SFU's 16 a clock per SM;
// the bytes (x, dt, dy read twice, dx and ddt written, the checkpoints)
// come to about half that time at the training shape.
//
// Four launches, parallel over chunks (one warp a block, one channel a
// lane, N states in its registers; grid (Di / 32, K, Bt)):
//   1. local:  from hs[k], recompute the chunk forward, writing the state
//      every SC steps to the checkpoints hck; then walk the chunk in reverse
//      from a zero carry: its local carry out exp(dt_{t0} a) ⊙ g_{t0} -> gl,
//      and S_k = Σ dt over the chunk (the chunk's decay is exp(a·S_k));
//   2. chain:  every (b, n, d) walks the chunks from the last:
//      G_in(k) = exp(a·S_{k+1}) ⊙ G_in(k+1) + gl_{k+1}, from dh_final; it
//      overwrites gl_k with G_in(k) and writes dh0;
//   3. chunk:  from G_in(k), walk the chunk's sub-chunks of SC steps in
//      reverse: recompute the sub-chunk's states from its checkpoint into
//      shared memory, then walk it back writing dx and ddt, a per-warp
//      partial of dB and dC (a reduce-scatter over the warp's 32 channels,
//      N/2 + N/4 + ... shuffles instead of 5 N) and accumulating da;
//   4. reduce: sum the partials of dB and dC over the Di / 32 warps and of
//      da over (K, Bt), each in a fixed order.
// No floating-point atomics: the result is bitwise the same run to run.
// Every exponent is dt·a <= 0 or a·S <= 0, so no factor exceeds 1.
//
// Operands as the forward's: x, B, C fp32 or bf16 (B and C with a
// contiguous last axis and the two leading strides given); dt, a, hs, dy,
// dh_final fp32.  dx, dB, dC come back in x's dtype, ddt, da and dh0 in
// fp32; every sum is fp32.  Memory is indexed in 32 bits (the wrapper
// checks every buffer's size): a 64-bit index costs registers and spills.
#include "common.cuh"

using namespace atucker;

namespace {

constexpr int W = 32;              // channels per block: one warp
constexpr int SC = 16;             // steps per sub-chunk (checkpoint stride)
constexpr int TS = 32;             // steps per staged slice of B or C
constexpr int kMaxN = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Reduce-scatter of v[0..CNT) over the warp: lanes exchange halves of
// their values along the high lane bits first, so after log2(CNT) rounds
// (or 5) each lane holds CNT / 32 (at least 1) sums over the lanes that
// share its remaining bits; the remaining bits are then summed plainly.
// Lane l ends with the full warp sums of states base .. base + CNT/32 - 1.
template <int CNT, int BIT>
__device__ __forceinline__ void rs_round(float* v, int lane, int& base) {
  if constexpr (BIT > 0) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = lane & BIT;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, BIT);
      }
      if (up) base += H;
      rs_round<H, BIT / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], BIT);
      rs_round<1, BIT / 2>(v, lane, base);
    }
  }
}

// values each lane holds after the reduce-scatter of NS states, and whether
// it is the lane that writes them (the one with its unused bits zero)
template <int NS> struct RsKept { static constexpr int value = NS > W ? NS / W : 1; };
template <int NS> __device__ __forceinline__ bool rs_writer(int lane) {
  if constexpr (NS >= W) return true;
  else return (lane & (W / NS - 1)) == 0;
}

// 1. local pass of chunk blockIdx.y, row blockIdx.z
template <typename E, int NS>
__global__ void __launch_bounds__(W)
s6_bwd_local_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const E* __restrict__ bm, const E* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ hs,
                    const float* __restrict__ dy, float* __restrict__ hck,
                    float* __restrict__ gl, float* __restrict__ ssum, int T, int Di, int N,
                    int Lc, int sbb, int sbt, int scb, int sct) {
  __shared__ __align__(16) float st[TS][NS];

  const int lane = threadIdx.x;
  const int d = blockIdx.x * W + lane;
  const int k = blockIdx.y, b = blockIdx.z, Bt = gridDim.z;
  const bool ok = d < Di;
  const int t0 = k * Lc;
  const int tl = min(Lc, T - t0);
  const int nsub = Lc / SC;
  const int row0 = b * T + t0;                       // (b, t0) row of x, dt, dy

  float al[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const bool on = ok && n < N;
    al[n] = on ? a[d * N + n] * kLog2e : 0.f;
    h[n] = on ? hs[((k * Bt + b) * Di + d) * N + n] : 0.f;
  }
  float dsum = 0.f;

  // forward recompute, the state every SC steps to the checkpoints
  for (int s0 = 0; s0 < tl; s0 += TS) {
    const int sl = min(TS, tl - s0);
    __syncthreads();
    for (int e = lane; e < TS * NS; e += W) {
      const int tt = e / NS, n = e % NS;
      st[tt][n] = (tt < sl && n < N) ? to_f32(bm[b * sbb + (t0 + s0 + tt) * sbt + n]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < sl; ++tt) {
      const int t = s0 + tt;
      if (t % SC == 0 && ok) {
        float* dst = hck + ((k * nsub + t / SC) * Bt + b) * N * Di + d;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (n < N) dst[n * Di] = h[n];
      }
      const int off = (row0 + t) * Di + d;
      const float dv = ok ? dt[off] : 0.f;
      const float u = ok ? dv * to_f32(x[off]) : 0.f;
#pragma unroll
      for (int n = 0; n < NS; n += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(&st[tt][n]);
        h[n + 0] = fmaf(ex2(dv * al[n + 0]), h[n + 0], u * bv.x);
        h[n + 1] = fmaf(ex2(dv * al[n + 1]), h[n + 1], u * bv.y);
        h[n + 2] = fmaf(ex2(dv * al[n + 2]), h[n + 2], u * bv.z);
        h[n + 3] = fmaf(ex2(dv * al[n + 3]), h[n + 3], u * bv.w);
      }
      dsum += dv;
    }
  }

  // reverse walk from a zero carry: c = exp(dt_t a) ⊙ g_t, local to the chunk
  float c[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) c[n] = 0.f;
  for (int s1 = tl; s1 > 0; s1 -= TS) {
    const int s0 = max(0, s1 - TS), sl = s1 - s0;
    __syncthreads();
    for (int e = lane; e < TS * NS; e += W) {
      const int tt = e / NS, n = e % NS;
      st[tt][n] = (tt < sl && n < N) ? to_f32(cm[b * scb + (t0 + s0 + tt) * sct + n]) : 0.f;
    }
    __syncthreads();
    for (int tt = sl - 1; tt >= 0; --tt) {
      const int off = (row0 + s0 + tt) * Di + d;
      const float dv = ok ? dt[off] : 0.f;
      const float gy = ok ? dy[off] : 0.f;
#pragma unroll
      for (int n = 0; n < NS; n += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(&st[tt][n]);
        c[n + 0] = ex2(dv * al[n + 0]) * fmaf(cv.x, gy, c[n + 0]);
        c[n + 1] = ex2(dv * al[n + 1]) * fmaf(cv.y, gy, c[n + 1]);
        c[n + 2] = ex2(dv * al[n + 2]) * fmaf(cv.z, gy, c[n + 2]);
        c[n + 3] = ex2(dv * al[n + 3]) * fmaf(cv.w, gy, c[n + 3]);
      }
    }
  }
  if (!ok) return;
  float* dst = gl + (k * Bt + b) * N * Di + d;       // (K, Bt, N, Di)
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (n < N) dst[n * Di] = c[n];
  ssum[(k * Bt + b) * Di + d] = dsum;
}

// 2. chain over the chunks, one thread a state (b, n, d)
__global__ void __launch_bounds__(256)
s6_bwd_chain_kernel(const float* __restrict__ a, const float* __restrict__ dhf,
                    float* __restrict__ gl, const float* __restrict__ ssum,
                    float* __restrict__ dh0, int Bt, int Di, int N, int K) {
  const int BND = Bt * N * Di;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;   // (b * N + n) * Di + d
  if (idx >= BND) return;
  const int d = idx % Di;
  const int bn = idx / Di;
  const int n = bn % N, b = bn / N;
  const float al = a[d * N + n] * kLog2e;
  float G = dhf != nullptr ? dhf[(b * Di + d) * N + n] : 0.f;
  for (int k = K - 1; k >= 0; --k) {
    float* slot = gl + k * BND + idx;
    const float loc = *slot;
    *slot = G;                                       // the carry into chunk k
    G = fmaf(ex2(ssum[(k * Bt + b) * Di + d] * al), G, loc);
  }
  dh0[(b * Di + d) * N + n] = G;
}

// 3. the chunk pass: gradients of chunk blockIdx.y, row blockIdx.z
template <typename E, int NS>
__global__ void __launch_bounds__(W)
s6_bwd_chunk_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const E* __restrict__ bm, const E* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dy,
                    const float* __restrict__ hck, const float* __restrict__ gl,
                    E* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ pb,
                    float* __restrict__ pc, float* __restrict__ pa, int T, int Di, int N,
                    int Lc, int sbb, int sbt, int scb, int sct) {
  extern __shared__ __align__(16) float hsm[];       // [SC + 1][NS][W]: h before/after each step
  __shared__ float xs[SC][W], ds[SC][W], ys[SC][W];
  __shared__ __align__(16) float bs[SC][NS];
  __shared__ __align__(16) float cs[SC][NS];
  constexpr int KEEP = RsKept<NS>::value;

  const int lane = threadIdx.x;
  const int d = blockIdx.x * W + lane;
  const int k = blockIdx.y, b = blockIdx.z, Bt = gridDim.z;
  const bool ok = d < Di;
  const int t0 = k * Lc;
  const int tl = min(Lc, T - t0);
  const int nsub = Lc / SC;
  const int row0 = b * T + t0;
  const bool writer = rs_writer<NS>(lane);

  float al[NS], c[NS], da[NS];
  const float* gin = gl + (k * Bt + b) * N * Di + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const bool on = ok && n < N;
    al[n] = on ? a[d * N + n] * kLog2e : 0.f;
    c[n] = on ? gin[n * Di] : 0.f;
    da[n] = 0.f;
  }

  for (int j = (tl + SC - 1) / SC - 1; j >= 0; --j) {
    const int s0 = j * SC, sl = min(SC, tl - s0);
    __syncthreads();                                 // the previous sub-chunk's reads are done
    for (int tt = 0; tt < SC; ++tt) {
      const bool on = ok && tt < sl;
      const int off = (row0 + s0 + tt) * Di + d;
      xs[tt][lane] = on ? to_f32(x[off]) : 0.f;
      ds[tt][lane] = on ? dt[off] : 0.f;
      ys[tt][lane] = on ? dy[off] : 0.f;
    }
    for (int e = lane; e < SC * NS; e += W) {
      const int tt = e / NS, n = e % NS;
      const bool on = tt < sl && n < N;
      const int t = t0 + s0 + tt;
      bs[tt][n] = on ? to_f32(bm[b * sbb + t * sbt + n]) : 0.f;
      cs[tt][n] = on ? to_f32(cm[b * scb + t * sct + n]) : 0.f;
    }
    __syncthreads();

    // recompute the sub-chunk's states from its checkpoint; each lane reads
    // back only its own column of hsm
    {
      const float* src = hck + ((k * nsub + j) * Bt + b) * N * Di + d;
      float h[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = (ok && n < N) ? src[n * Di] : 0.f;
        hsm[n * W + lane] = h[n];
      }
      for (int tt = 0; tt < sl; ++tt) {
        const float dv = ds[tt][lane];
        const float u = dv * xs[tt][lane];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          h[n] = fmaf(ex2(dv * al[n]), h[n], u * bs[tt][n]);
          hsm[((tt + 1) * NS + n) * W + lane] = h[n];
        }
      }
    }

    // walk it back
    for (int tt = sl - 1; tt >= 0; --tt) {
      const float dv = ds[tt][lane], xv = xs[tt][lane], gy = ys[tt][lane];
      const float u = dv * xv;
      float sgb = 0.f, sdt = 0.f;
      float vb[NS], vc[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float bn = bs[tt][n];
        const float g = fmaf(cs[tt][n], gy, c[n]);
        const float dec = ex2(dv * al[n]);
        const float dh = dec * hsm[(tt * NS + n) * W + lane];     // exp(dt a) ⊙ h_{t-1}
        sgb = fmaf(g, bn, sgb);
        sdt = fmaf(g, fmaf(al[n] * kLn2, dh, xv * bn), sdt);
        da[n] = fmaf(g * dv, dh, da[n]);
        vb[n] = g * u;
        vc[n] = gy * hsm[((tt + 1) * NS + n) * W + lane];
        c[n] = dec * g;
      }
      const int t = t0 + s0 + tt;
      if (ok) {
        const int off = (row0 + s0 + tt) * Di + d;
        store(dx + off, dv * sgb);
        ddt[off] = sdt;
      }
      int base = 0, base_c = 0;
      rs_round<NS, W / 2>(vb, lane, base);
      rs_round<NS, W / 2>(vc, lane, base_c);
      if (writer) {
        const int prow = ((blockIdx.x * Bt + b) * T + t) * N;    // (Di / W, Bt, T, N)
#pragma unroll
        for (int i = 0; i < KEEP; ++i) {
          if (base + i < N) {
            pb[prow + base + i] = vb[i];
            pc[prow + base + i] = vc[i];
          }
        }
      }
    }
  }
  if (!ok) return;
  float* dst = pa + ((k * Bt + b) * Di + d) * N;     // (K·Bt, Di, N)
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (n < N) dst[n] = da[n];
}

// 4. out[i] = Σ_p part[p * M + i], p in order
template <typename O>
__global__ void __launch_bounds__(256)
s6_bwd_reduce_kernel(const float* __restrict__ part, O* __restrict__ out, int P, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[p * M + i];
  store(out + i, s);
}

template <int NS>
constexpr size_t chunk_smem() { return (size_t)(SC + 1) * NS * W * sizeof(float); }

struct Args {
  const void *x, *bm, *cm;
  const float *dt, *a, *hs, *dy, *dhf;
  void *dx, *dbm, *dcm;
  float *ddt, *da, *dh0, *hck, *gl, *ssum, *pb, *pc, *pa;
  int B, T, Di, N, Lc, sbb, sbt, scb, sct;
};

template <typename O>
cudaError_t reduce(const float* part, O* out, int P, int M, cudaStream_t st) {
  s6_bwd_reduce_kernel<O><<<ceil_div(M, 256), 256, 0, st>>>(part, out, P, M);
  return cudaGetLastError();
}

template <typename E, int NS>
cudaError_t run(const Args& q, cudaStream_t st) {
  const int K = ceil_div(q.T, q.Lc);
  const int nd = ceil_div(q.Di, W);
  const dim3 grid(nd, K, q.B);
  const E* xe = static_cast<const E*>(q.x);
  const E* be = static_cast<const E*>(q.bm);
  const E* ce = static_cast<const E*>(q.cm);
  s6_bwd_local_kernel<E, NS><<<grid, W, 0, st>>>(xe, q.dt, be, ce, q.a, q.hs, q.dy, q.hck,
                                                 q.gl, q.ssum, q.T, q.Di, q.N, q.Lc, q.sbb,
                                                 q.sbt, q.scb, q.sct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int states = q.B * q.N * q.Di;
  s6_bwd_chain_kernel<<<ceil_div(states, 256), 256, 0, st>>>(q.a, q.dhf, q.gl, q.ssum, q.dh0,
                                                             q.B, q.Di, q.N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = chunk_smem<NS>();
  err = cudaFuncSetAttribute(s6_bwd_chunk_kernel<E, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  s6_bwd_chunk_kernel<E, NS><<<grid, W, smem, st>>>(
      xe, q.dt, be, ce, q.a, q.dy, q.hck, q.gl, static_cast<E*>(q.dx), q.ddt, q.pb, q.pc,
      q.pa, q.T, q.Di, q.N, q.Lc, q.sbb, q.sbt, q.scb, q.sct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce(q.pb, static_cast<E*>(q.dbm), nd, q.B * q.T * q.N, st);
  if (err == cudaSuccess) err = reduce(q.pc, static_cast<E*>(q.dcm), nd, q.B * q.T * q.N, st);
  if (err == cudaSuccess) err = reduce(q.pa, q.da, K * q.B, q.Di * q.N, st);
  return err;
}

template <typename E>
cudaError_t dispatch(const Args& q, cudaStream_t st) {
  if (q.N <= 4) return run<E, 4>(q, st);
  if (q.N <= 8) return run<E, 8>(q, st);
  if (q.N <= 16) return run<E, 16>(q, st);
  if (q.N <= 32) return run<E, 32>(q, st);
  return run<E, 64>(q, st);
}

template <typename E, int NS>
cudaError_t info_for(int B, int T, int Di, int N, int Lc, int* out) {
  const long long blocks = (long long)ceil_div(Di, W) * ceil_div(T, Lc) * B;
  constexpr size_t smem = chunk_smem<NS>();
  cudaError_t err = describe(s6_bwd_local_kernel<E, NS>, W, blocks, out);
  if (err == cudaSuccess)
    err = describe(s6_bwd_chain_kernel, 256, ceil_div((long long)B * N * Di, 256), out + 4);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(s6_bwd_chunk_kernel<E, NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = describe(s6_bwd_chunk_kernel<E, NS>, W, blocks, out + 8, smem);
  if (err == cudaSuccess)
    err = describe(s6_bwd_reduce_kernel<E>, 256, ceil_div((long long)B * T * N, 256),
                   out + 12);
  return err;
}

template <typename E>
cudaError_t info(int B, int T, int Di, int N, int Lc, int* out) {
  if (N <= 4) return info_for<E, 4>(B, T, Di, N, Lc, out);
  if (N <= 8) return info_for<E, 8>(B, T, Di, N, Lc, out);
  if (N <= 16) return info_for<E, 16>(B, T, Di, N, Lc, out);
  if (N <= 32) return info_for<E, 32>(B, T, Di, N, Lc, out);
  return info_for<E, 64>(B, T, Di, N, Lc, out);
}

bool shape_ok(int B, int T, int Di, int N, int Lc) {
  return B > 0 && B <= 65535 && T > 0 && Di > 0 && N > 0 && N <= kMaxN && Lc > 0 &&
         Lc % SC == 0 && ceil_div(T, Lc) <= 65535;
}

}  // namespace

// Scratch from the wrapper (fp32): hck (K·Lc/SC, B, N, Di), gl (K, B, N, Di),
// ssum (K, B, Di), pb and pc (ceil(Di/32), B, T, N), pa (K·B, Di, N), with
// K = ceil(T / Lc).  dhf may be null.  The wrapper has checked that every
// buffer holds fewer than 2**31 elements.
extern "C" int atucker_s6_scan_bwd(const void* x, const void* dt, const void* bm,
                                   const void* cm, const void* a, const void* hs,
                                   const void* dy, const void* dhf, void* dx, void* ddt,
                                   void* dbm, void* dcm, void* da, void* dh0, void* hck,
                                   void* gl, void* ssum, void* pb, void* pc, void* pa, int B,
                                   int T, int Di, int N, int Lc, int sbb, int sbt, int scb,
                                   int sct, int dtype, void* stream) {
  if (!shape_ok(B, T, Di, N, Lc)) return cudaErrorInvalidValue;
  Args q{x, bm, cm,
         static_cast<const float*>(dt), static_cast<const float*>(a),
         static_cast<const float*>(hs), static_cast<const float*>(dy),
         static_cast<const float*>(dhf), dx, dbm, dcm,
         static_cast<float*>(ddt), static_cast<float*>(da), static_cast<float*>(dh0),
         static_cast<float*>(hck), static_cast<float*>(gl), static_cast<float*>(ssum),
         static_cast<float*>(pb), static_cast<float*>(pc), static_cast<float*>(pa),
         B, T, Di, N, Lc, sbb, sbt, scb, sct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)dispatch<float>(q, st);
  if (dtype == kBFloat16) return (int)dispatch<__nv_bfloat16>(q, st);
  return cudaErrorInvalidValue;
}

// Launch figures, for reports: out[4 k .. 4 k + 3] for the local, chain,
// chunk and (dB's) reduce kernels.
extern "C" int atucker_s6_scan_bwd_info(int B, int T, int Di, int N, int Lc, int dtype,
                                        int* out) {
  if (!shape_ok(B, T, Di, N, Lc)) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  if (dtype == kFloat32) return (int)info<float>(B, T, Di, N, Lc, out);
  if (dtype == kBFloat16) return (int)info<__nv_bfloat16>(B, T, Di, N, Lc, out);
  return cudaErrorInvalidValue;
}
