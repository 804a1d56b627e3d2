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
// per layer; the forward here keeps the state every SC = 8 steps (its
// checkpoints ck, (ceil(T / SC), Bt, N, Di) fp32: csrc/s6_scan.cu writes
// them) and this kernel recomputes the states in between.
//
// What bounds it on the H100: the exponentials and the bytes, about equal.
// The gradient needs exp(dt·a) once a (b, t, d, n); the kernel takes it
// three times (the local pass's walk, the chunk pass's recompute and its
// walk) on the SFU's 16 a clock per SM.  The bytes: x, dt, dy, the
// checkpoints read, dx and ddt written, and dt, dy read once more by the
// local pass.
//
// Four launches, parallel over chunks of Lb steps (chosen by the wrapper,
// a multiple of SC) and over state groups of at most NG = 16 states (N > 16
// runs in ceil(N / 16) groups, so that no thread holds more than 16 states:
// the N = 64 case does not spill); blocks of CB = 128 channels, one a
// thread, all of one (chunk, batch row, state group); grid (Di / 128, K,
// Bt · groups):
//   1. local:  walk the chunk in reverse from a zero carry (dt, dy and C
//      only): its local carry out exp(dt_{t0} a) ⊙ g_{t0} -> gl, and
//      S_k = Σ dt over the chunk (the chunk's decay is exp(a·S_k));
//   2. chain:  every (b, n, d) walks the chunks from the last:
//      G_in(k) = exp(a·S_{k+1}) ⊙ G_in(k+1) + gl_{k+1}, from dh_final; it
//      overwrites gl_k with G_in(k) and writes dh0;
//   3. chunk:  from G_in(k), walk the chunk's sub-chunks of SC steps in
//      reverse: recompute the sub-chunk's states h_{t-1} from its
//      checkpoint into shared memory (SC rows of 128 channels a state),
//      sum dC_t = Σ_d dy_t h_t over the block's channels from those rows
//      (h_t of a step is the next step's h_{t-1}; the last step's by a
//      warp reduce-scatter), then walk it back writing dx and ddt (or,
//      with several state groups, their per-group partials), accumulating
//      da, and writing g·dt·x over each h_{t-1} it has read, whose rows
//      then sum to dB: one partial of dB and dC per block of 128 channels,
//      each a sum in channel order;
//   4. reduce: one launch sums the partials of dB and dC over the Di / 128
//      blocks, of da over (K, Bt), and with several state groups those of
//      dx and ddt over the groups, each in a fixed order.
// Shared memory of the chunk pass: SC · N · 4 bytes a channel, 70 KB for
// the block at N = 16 (h_{t-1} only, SC = 8, with dy, B and C of the
// sub-chunk), so three blocks, twelve warps, are resident on an SM.
// No floating-point atomics: the result is bitwise the same run to run.
// Every exponent is dt·a <= 0 or a·S <= 0, so no factor exceeds 1.
//
// Operands as the forward's: x, B, C fp32 or bf16 (B and C with a
// contiguous last axis and the two leading strides given); dt, a, ck, dy,
// dh_final fp32.  dx, dB, dC come back in x's dtype, ddt, da and dh0 in
// fp32; every sum is fp32.  Memory is indexed in 32 bits (the wrapper
// checks every buffer's size): a 64-bit index costs registers and spills.
#include "common.cuh"

using namespace atucker;

namespace {

constexpr int W = 32;              // lanes of a warp
constexpr int WB = 4;              // warps per block
constexpr int CB = W * WB;         // channels per block, one a thread
constexpr int SC = 8;              // steps per sub-chunk: the checkpoints' stride
constexpr int TS = 32;             // steps per staged slice of C in the local pass
constexpr int NG = 16;             // states per group
constexpr int kMaxN = 64;
// resident blocks per SM asked of the compiler: the local pass holds 32
// warps, the chunk pass 12 (its shared memory allows three blocks)
constexpr int LOCAL_BLOCKS = 8, CHUNK_BLOCKS = 3;
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
// each lane holds one sum over the lanes that share its remaining bits;
// the remaining bits are then summed plainly.  Lane l ends with the full
// warp sum of state `base` (CNT <= 32).
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

// the lane that writes its sum after the reduce-scatter of NS states: the
// one with its unused bits zero
template <int NS> __device__ __forceinline__ bool rs_writer(int lane) {
  return (lane & (W / NS - 1)) == 0;
}

// Where a block is: channel d, chunk k, batch row b, state group grp and
// its first state n0, of Bt rows and G groups.
struct Where {
  int d, k, b, grp, n0, Bt, G;
  __device__ Where(int N, int NS) {
    d = blockIdx.x * CB + threadIdx.x;
    k = blockIdx.y;
    G = (N + NS - 1) / NS;
    b = blockIdx.z / G;
    grp = blockIdx.z % G;
    n0 = grp * NS;
    Bt = gridDim.z / G;
  }
};

// 1. local pass: the reverse walk of one chunk from a zero carry
template <typename E, int NS>
__global__ void __launch_bounds__(CB, LOCAL_BLOCKS)
s6_bwd_local_kernel(const float* __restrict__ dt, const E* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dy,
                    float* __restrict__ gl, float* __restrict__ ssum, int T, int Di, int N,
                    int Lb, int scb, int sct) {
  __shared__ __align__(16) float cs[TS][NS];

  const Where w(N, NS);
  const int tid = threadIdx.x;
  const bool ok = w.d < Di;
  const int t0 = w.k * Lb;
  const int tl = min(Lb, T - t0);
  const int row0 = w.b * T + t0;                   // (b, t0) row of dt, dy

  float al[NS], c[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    al[n] = ok && w.n0 + n < N ? a[w.d * N + w.n0 + n] * kLog2e : 0.f;
    c[n] = 0.f;
  }
  float dsum = 0.f;
  for (int s1 = tl; s1 > 0; s1 -= TS) {
    const int s0 = max(0, s1 - TS), sl = s1 - s0;
    __syncthreads();                               // the previous slice's reads are done
    for (int e = tid; e < TS * NS; e += CB) {
      const int tt = e / NS, n = e % NS;
      cs[tt][n] = (tt < sl && w.n0 + n < N)
                      ? to_f32(cm[w.b * scb + (t0 + s0 + tt) * sct + w.n0 + n]) : 0.f;
    }
    __syncthreads();
    if (ok) {
#pragma unroll 4
      for (int tt = sl - 1; tt >= 0; --tt) {
        const int off = (row0 + s0 + tt) * Di + w.d;
        const float dv = dt[off], gy = dy[off];
#pragma unroll
        for (int n = 0; n < NS; n += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(&cs[tt][n]);
          c[n + 0] = ex2(dv * al[n + 0]) * fmaf(cv.x, gy, c[n + 0]);
          c[n + 1] = ex2(dv * al[n + 1]) * fmaf(cv.y, gy, c[n + 1]);
          c[n + 2] = ex2(dv * al[n + 2]) * fmaf(cv.z, gy, c[n + 2]);
          c[n + 3] = ex2(dv * al[n + 3]) * fmaf(cv.w, gy, c[n + 3]);
        }
        dsum += dv;
      }
    }
  }
  if (!ok) return;
  float* dst = gl + (w.k * w.Bt + w.b) * N * Di + w.d;   // (K, Bt, N, Di)
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (w.n0 + n < N) dst[(w.n0 + n) * Di] = c[n];
  if (w.grp == 0) ssum[(w.k * w.Bt + w.b) * Di + w.d] = dsum;
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

// Σ_d a[d] (· b[d]) over the CB channels of a row of shared memory, d in
// order within four interleaved partial sums, added in order at the end
template <bool DOT>
__device__ __forceinline__ float row_sum(const float* __restrict__ a,
                                         const float* __restrict__ b) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < CB; d += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (DOT) s[q] = fmaf(a[d + q], b[d + q], s[q]);
      else s[q] += a[d + q];
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// 3. the chunk pass: the gradients of one chunk
template <typename E, int NS>
__global__ void __launch_bounds__(CB, CHUNK_BLOCKS)
s6_bwd_chunk_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const E* __restrict__ bm, const E* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dy,
                    const float* __restrict__ ck, const float* __restrict__ gl,
                    E* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ px,
                    float* __restrict__ pdt, float* __restrict__ pb, float* __restrict__ pc,
                    float* __restrict__ pa, int T, int Di, int N, int Lb, int sbb, int sbt,
                    int scb, int sct) {
  // [SC][NS][CB + 1]: h_{t-1} of each step of the sub-chunk, one column a
  // channel; the walk writes g_t·dt_t·x_t over each value once it has read
  // it.  A row is CB + 1 floats (one of padding), so that the column sums'
  // threads, one a row, read different banks.
  extern __shared__ __align__(16) float hsm[];
  __shared__ __align__(16) float bs[SC][NS];
  __shared__ __align__(16) float cs[SC][NS];
  __shared__ float ys[SC][CB];                     // dy of the block's channels
  __shared__ float rc[WB][NS];                     // the warps' dC of the last step

  const Where w(N, NS);
  const int tid = threadIdx.x, lane = tid % W, warp = tid / W;
  const bool ok = w.d < Di;
  const int t0 = w.k * Lb;
  const int tl = min(Lb, T - t0);
  const int row0 = w.b * T + t0;
  // one state group writes dx and ddt itself; several write partials
  const bool direct = w.G == 1;
  const int part0 = w.grp * w.Bt * T * Di;
  const int prow0 = (blockIdx.x * w.Bt + w.b) * T + t0;   // (Di / CB, Bt, T, N) rows

  float al[NS], c[NS], da[NS];
  const float* gin = gl + (w.k * w.Bt + w.b) * N * Di + w.d;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const bool on = ok && w.n0 + n < N;
    al[n] = on ? a[w.d * N + w.n0 + n] * kLog2e : 0.f;
    c[n] = on ? gin[(w.n0 + n) * Di] : 0.f;
    da[n] = 0.f;
  }

  for (int j = (tl + SC - 1) / SC - 1; j >= 0; --j) {
    const int s0 = j * SC, sl = min(SC, tl - s0);
    __syncthreads();                               // the previous sub-chunk's reads are done
    for (int e = tid; e < SC * NS; e += CB) {
      const int tt = e / NS, n = e % NS;
      const bool on = tt < sl && w.n0 + n < N;
      const int t = t0 + s0 + tt;
      bs[tt][n] = on ? to_f32(bm[w.b * sbb + t * sbt + w.n0 + n]) : 0.f;
      cs[tt][n] = on ? to_f32(cm[w.b * scb + t * sct + w.n0 + n]) : 0.f;
    }
    // this channel's x, dt and dy of the sub-chunk, and its checkpoint
    float xr[SC], dr[SC], yr[SC], h[NS];
#pragma unroll
    for (int tt = 0; tt < SC; ++tt) {
      const bool on = ok && tt < sl;
      const int off = (row0 + s0 + tt) * Di + w.d;
      xr[tt] = on ? to_f32(x[off]) : 0.f;
      dr[tt] = on ? dt[off] : 0.f;
      yr[tt] = on ? dy[off] : 0.f;
      ys[tt][tid] = yr[tt];
    }
    const float* src = ck + ((t0 + s0) / SC * w.Bt + w.b) * N * Di + w.d;
#pragma unroll
    for (int n = 0; n < NS; ++n) h[n] = ok && w.n0 + n < N ? src[(w.n0 + n) * Di] : 0.f;
    __syncthreads();                               // bs and cs are staged

    // recompute h_{t-1} of each step, as the forward does, into this
    // thread's column; h ends as the last step's h_t
    float gy_last = 0.f;
#pragma unroll
    for (int tt = 0; tt < SC; ++tt) {
      if (tt < sl) {
        const float4* b4 = reinterpret_cast<const float4*>(bs[tt]);
#pragma unroll
        for (int n = 0; n < NS; ++n) hsm[(tt * NS + n) * (CB + 1) + tid] = h[n];
        const float u = dr[tt] * xr[tt];
#pragma unroll
        for (int q = 0; q < NS / 4; ++q) {
          const float4 bv = b4[q];
          h[4 * q + 0] = fmaf(ex2(dr[tt] * al[4 * q + 0]), h[4 * q + 0], u * bv.x);
          h[4 * q + 1] = fmaf(ex2(dr[tt] * al[4 * q + 1]), h[4 * q + 1], u * bv.y);
          h[4 * q + 2] = fmaf(ex2(dr[tt] * al[4 * q + 2]), h[4 * q + 2], u * bv.z);
          h[4 * q + 3] = fmaf(ex2(dr[tt] * al[4 * q + 3]), h[4 * q + 3], u * bv.w);
        }
        gy_last = yr[tt];
      }
    }
    // dC of the last step, whose h_t no row holds: over the warp (a
    // reduce-scatter; sl is the same for the whole block, so every lane
    // reaches the shuffles), then over the warps below
    {
      int base = 0;
#pragma unroll
      for (int n = 0; n < NS; ++n) h[n] *= gy_last;
      rs_round<NS, W / 2>(h, lane, base);
      if (rs_writer<NS>(lane)) rc[warp][base] = h[0];
    }
    __syncthreads();                               // the rows, ys and rc are complete
    // dC of the other steps: h_t of step tt is row tt + 1, summed against
    // dy over the block's channels in order; one (step, state) a thread
    for (int e = tid; e < sl * NS; e += CB) {
      const int tt = e / NS, n = e % NS;
      if (w.n0 + n >= N) continue;
      float sc;
      if (tt + 1 < sl) {
        sc = row_sum<true>(&hsm[((tt + 1) * NS + n) * (CB + 1)], ys[tt]);
      } else {
        sc = rc[0][n];
#pragma unroll
        for (int v = 1; v < WB; ++v) sc += rc[v][n];
      }
      pc[(prow0 + s0 + tt) * N + w.n0 + n] = sc;
    }
    __syncthreads();                               // the rows are read before the walk writes

    // walk it back
#pragma unroll
    for (int tt = SC - 1; tt >= 0; --tt) {
      if (tt < sl) {
        const float dv = dr[tt], xv = xr[tt], gy = yr[tt];
        const float u = dv * xv;
        const float4* b4 = reinterpret_cast<const float4*>(bs[tt]);
        const float4* c4 = reinterpret_cast<const float4*>(cs[tt]);
        float sgb = 0.f, sda = 0.f;                // Σ g B, Σ g (a log2 e) exp(dt a) h_{t-1}
#pragma unroll
        for (int q = 0; q < NS / 4; ++q) {
          const float4 bv = b4[q], cv = c4[q];
          const float bq[4] = {bv.x, bv.y, bv.z, bv.w}, cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int n = 4 * q + r;
            float* slot = &hsm[(tt * NS + n) * (CB + 1) + tid];
            const float dec = ex2(dv * al[n]);
            const float g = fmaf(cq[r], gy, c[n]);
            const float gdh = g * (dec * *slot);   // g ⊙ exp(dt a) ⊙ h_{t-1}
            sgb = fmaf(g, bq[r], sgb);
            da[n] = fmaf(gdh, dv, da[n]);
            sda = fmaf(gdh, al[n], sda);
            *slot = g * u;
            c[n] = dec * g;
          }
        }
        if (ok) {
          const int off = (row0 + s0 + tt) * Di + w.d;
          const float vx = dv * sgb, vdt = fmaf(sda, kLn2, xv * sgb);
          if (direct) {
            store(dx + off, vx);
            ddt[off] = vdt;
          } else {
            px[part0 + off] = vx;
            pdt[part0 + off] = vdt;
          }
        }
      }
    }
    __syncthreads();
    // dB: the rows of g·dt·x summed over the block's channels in order
    for (int e = tid; e < sl * NS; e += CB) {
      const int tt = e / NS, n = e % NS;
      if (w.n0 + n < N)
        pb[(prow0 + s0 + tt) * N + w.n0 + n] =
            row_sum<false>(&hsm[(tt * NS + n) * (CB + 1)], nullptr);
    }
  }
  if (!ok) return;
  float* dst = pa + ((w.k * w.Bt + w.b) * Di + w.d) * N + w.n0;   // (K·Bt, Di, N)
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (w.n0 + n < N) dst[n] = da[n];
}

// 4. out[i] = Σ_p part[p * M + i], p in order, for each of up to five
// segments (blockIdx.y): dB, dC, da, and with several state groups dx, ddt
struct Seg {
  const float* part;
  void* out;
  int P, M, bf16;
};
struct Segs {
  Seg s[5];
};

__device__ __forceinline__ Seg segment(const Segs& q, int y) {
  // constant indices only: a parameter array indexed at run time would be
  // copied to local memory
  return y == 0 ? q.s[0] : y == 1 ? q.s[1] : y == 2 ? q.s[2] : y == 3 ? q.s[3] : q.s[4];
}

__global__ void __launch_bounds__(256) s6_bwd_reduce_kernel(Segs q) {
  const Seg g = segment(q, blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.M) return;
  float s = 0.f;
  for (int p = 0; p < g.P; ++p) s += g.part[p * g.M + i];
  if (g.bf16) store(static_cast<__nv_bfloat16*>(g.out) + i, s);
  else store(static_cast<float*>(g.out) + i, s);
}

template <int NS>
constexpr size_t chunk_smem() { return (size_t)SC * NS * (CB + 1) * sizeof(float); }

struct Args {
  const void *x, *bm, *cm;
  const float *dt, *a, *ck, *dy, *dhf;
  void *dx, *dbm, *dcm;
  float *ddt, *da, *dh0, *gl, *ssum, *pb, *pc, *pa, *px, *pdt;
  int B, T, Di, N, Lb, sbb, sbt, scb, sct;
};

int groups(int N, int NS) { return ceil_div(N, NS); }

template <typename E, int NS>
cudaError_t run(const Args& q, cudaStream_t st) {
  const int K = ceil_div(q.T, q.Lb);
  const int nd = ceil_div(q.Di, CB);
  const int G = groups(q.N, NS);
  const dim3 grid(nd, K, q.B * G);
  const E* xe = static_cast<const E*>(q.x);
  const E* be = static_cast<const E*>(q.bm);
  const E* ce = static_cast<const E*>(q.cm);
  s6_bwd_local_kernel<E, NS><<<grid, CB, 0, st>>>(q.dt, ce, q.a, q.dy, q.gl, q.ssum, q.T,
                                                  q.Di, q.N, q.Lb, q.scb, q.sct);
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
  s6_bwd_chunk_kernel<E, NS><<<grid, CB, smem, st>>>(
      xe, q.dt, be, ce, q.a, q.dy, q.ck, q.gl, static_cast<E*>(q.dx), q.ddt, q.px, q.pdt,
      q.pb, q.pc, q.pa, q.T, q.Di, q.N, q.Lb, q.sbb, q.sbt, q.scb, q.sct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bf = sizeof(E) == 2;
  const int mbt = q.B * q.T * q.N, mdn = q.Di * q.N, mx = q.B * q.T * q.Di;
  Segs s{};
  s.s[0] = Seg{q.pb, q.dbm, nd, mbt, bf};
  s.s[1] = Seg{q.pc, q.dcm, nd, mbt, bf};
  s.s[2] = Seg{q.pa, q.da, K * q.B, mdn, 0};
  int nseg = 3, most = max(mbt, mdn);
  if (G > 1) {
    s.s[3] = Seg{q.px, q.dx, G, mx, bf};
    s.s[4] = Seg{q.pdt, q.ddt, G, mx, 0};
    nseg = 5;
    most = max(most, mx);
  }
  s6_bwd_reduce_kernel<<<dim3(ceil_div(most, 256), nseg), 256, 0, st>>>(s);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const Args& q, cudaStream_t st) {
  if (q.N <= 4) return run<E, 4>(q, st);
  if (q.N <= 8) return run<E, 8>(q, st);
  return run<E, NG>(q, st);
}

// Launch figures of one kernel: registers per thread, threads per block,
// resident blocks per SM, grid blocks, local memory per thread (spills and
// stack) and shared memory per block.
template <typename F>
cudaError_t describe6(F* fn, int threads, long long blocks, int* out, size_t smem = 0) {
  cudaError_t err = describe(fn, threads, blocks, out, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  out[4] = (int)attr.localSizeBytes;
  out[5] = (int)(attr.sharedSizeBytes + smem);
  return err;
}

template <typename E, int NS>
cudaError_t info_for(int B, int T, int Di, int N, int Lb, int* out) {
  const long long blocks = (long long)ceil_div(Di, CB) * ceil_div(T, Lb) * B * groups(N, NS);
  constexpr size_t smem = chunk_smem<NS>();
  cudaError_t err = describe6(s6_bwd_local_kernel<E, NS>, CB, blocks, out);
  if (err == cudaSuccess)
    err = describe6(s6_bwd_chain_kernel, 256, ceil_div((long long)B * N * Di, 256), out + 6);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(s6_bwd_chunk_kernel<E, NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = describe6(s6_bwd_chunk_kernel<E, NS>, CB, blocks, out + 12, smem);
  if (err == cudaSuccess) {
    const int G = groups(N, NS);
    long long most = (long long)B * T * N > (long long)Di * N ? (long long)B * T * N
                                                                : (long long)Di * N;
    if (G > 1 && (long long)B * T * Di > most) most = (long long)B * T * Di;
    err = describe6(s6_bwd_reduce_kernel, 256, ceil_div(most, 256) * (G > 1 ? 5 : 3),
                    out + 18);
  }
  return err;
}

template <typename E>
cudaError_t info(int B, int T, int Di, int N, int Lb, int* out) {
  if (N <= 4) return info_for<E, 4>(B, T, Di, N, Lb, out);
  if (N <= 8) return info_for<E, 8>(B, T, Di, N, Lb, out);
  return info_for<E, NG>(B, T, Di, N, Lb, out);
}

bool shape_ok(int B, int T, int Di, int N, int Lb) {
  return B > 0 && T > 0 && Di > 0 && N > 0 && N <= kMaxN && Lb > 0 && Lb % SC == 0 &&
         ceil_div(T, Lb) <= 65535 && (long long)B * ceil_div(N, NG) <= 65535;
}

}  // namespace

// ck: the forward's checkpoints, (ceil(T / 8), B, N, Di) fp32, the state
// entering every 8th step.  Scratch from the wrapper (fp32): gl (K, B, N,
// Di), ssum (K, B, Di), pb and pc (ceil(Di / 128), B, T, N), pa (K·B, Di,
// N), with K = ceil(T / Lb); px and pdt (groups, B, T, Di) when N > 16,
// else null.  dhf may be null.  The wrapper has checked that every buffer
// holds fewer than 2**31 elements.
extern "C" int atucker_s6_scan_bwd(const void* x, const void* dt, const void* bm,
                                   const void* cm, const void* a, const void* ck,
                                   const void* dy, const void* dhf, void* dx, void* ddt,
                                   void* dbm, void* dcm, void* da, void* dh0, void* gl,
                                   void* ssum, void* pb, void* pc, void* pa, void* px,
                                   void* pdt, int B, int T, int Di, int N, int Lb, int sbb,
                                   int sbt, int scb, int sct, int dtype, void* stream) {
  if (!shape_ok(B, T, Di, N, Lb) || (N > NG && (px == nullptr || pdt == nullptr)))
    return cudaErrorInvalidValue;
  Args q{x, bm, cm,
         static_cast<const float*>(dt), static_cast<const float*>(a),
         static_cast<const float*>(ck), static_cast<const float*>(dy),
         static_cast<const float*>(dhf), dx, dbm, dcm,
         static_cast<float*>(ddt), static_cast<float*>(da), static_cast<float*>(dh0),
         static_cast<float*>(gl), static_cast<float*>(ssum), static_cast<float*>(pb),
         static_cast<float*>(pc), static_cast<float*>(pa), static_cast<float*>(px),
         static_cast<float*>(pdt), B, T, Di, N, Lb, sbb, sbt, scb, sct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)dispatch<float>(q, st);
  if (dtype == kBFloat16) return (int)dispatch<__nv_bfloat16>(q, st);
  return cudaErrorInvalidValue;
}

// Launch figures, for reports: out[6 k .. 6 k + 5] for the local, chain,
// chunk and reduce kernels (describe6's six words each).
extern "C" int atucker_s6_scan_bwd_info(int B, int T, int Di, int N, int Lb, int dtype,
                                        int* out) {
  if (!shape_ok(B, T, Di, N, Lb)) return cudaErrorInvalidValue;
  for (int i = 0; i < 24; ++i) out[i] = 0;
  if (dtype == kFloat32) return (int)info<float>(B, T, Di, N, Lb, out);
  if (dtype == kBFloat16) return (int)info<__nv_bfloat16>(B, T, Di, N, Lb, out);
  return cudaErrorInvalidValue;
}
