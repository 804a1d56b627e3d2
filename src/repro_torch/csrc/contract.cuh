// The shared FFMA tile kernel of ttt.cu's skinny route (R <= 16, 128 x 16
// tiles) and matmul.cu (128 x 16 and 16 x 128 tiles):
//
//   out[w1, w2] = sum_k P(k, w1) * Q(k, w2)        (fp32 FFMA, fp32 out)
//
// Each operand is an (A, W, B) view read in place, with the reduction index
// k = a * B + b:  element (k, w) sits at  a * astride + w * B + b.  The TTT
// reads x (A, I, B) and y (A, R, B) this way; the boundary-mode GEMM reads
// A (M, K) as (1, M, K) and B (K, N) as (K, N, 1).  An operand with B > 1 is
// contiguous along k, so consecutive threads load consecutive k ("kfast");
// with B == 1 its rows are contiguous along w and consecutive threads load
// consecutive w.  Ragged edges load zeros; nothing is padded in memory.
//
// A block owns a TW1 x TW2 output tile and a k range (grid.z splits the
// reduction; the caller finishes the partial sums).  It stages TK-deep tiles
// of both operands in shared memory -- the next tile's global loads are
// issued into registers before the current tile is consumed, so their
// latency hides behind the FFMA -- and every thread accumulates an M1 x M2
// register micro-tile, read from shared memory as float4/float2 vectors.
#pragma once

#include "common.cuh"

namespace atucker {

struct Operand {
  const void* p;
  int B;               // inner extent of k (k = a * B + b)
  long long astride;   // stride of a
  int wdim;            // extent of w
};

// One operand's share of a TK x W tile, held in registers between the
// global load (fetch) and the shared-memory store (put).
template <typename T, int TK, int W, int THREADS>
struct Stage {
  static constexpr int N = TK * W / THREADS;
  static_assert(TK * W % THREADS == 0, "tile must divide among threads");
  static_assert(THREADS % TK == 0 && THREADS % W == 0, "thread/tile mismatch");
  float v[N];

  __device__ __forceinline__ void fetch(const Operand& o, long long k0, long long ke,
                                        int w0, int tid) {
    const T* __restrict__ p = static_cast<const T*>(o.p);
    if (o.B > 1) {  // kfast: one k per thread, one division per tile
      const int kk = tid % TK;
      const long long k = k0 + kk;
      const bool kv = k < ke;
      long long base = 0;
      if (kv) {
        const long long a = k / o.B;
        base = a * o.astride + (k - a * o.B);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int w = w0 + tid / TK + j * (THREADS / TK);
        v[j] = (kv && w < o.wdim) ? to_f32(p[base + (long long)w * o.B]) : 0.f;
      }
    } else {  // rows contiguous along w
      const int w = w0 + tid % W;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const long long k = k0 + tid / W + j * (THREADS / W);
        v[j] = (k < ke && w < o.wdim) ? to_f32(p[k * o.astride + w]) : 0.f;
      }
    }
  }

  template <int LD>
  __device__ __forceinline__ void put(float (*s)[LD], bool kfast, int tid) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (kfast)
        s[tid % TK][tid / TK + j * (THREADS / TK)] = v[j];
      else
        s[tid / W + j * (THREADS / W)][tid % W] = v[j];
    }
  }
};

template <int M>
__device__ __forceinline__ void load_vec(float (&dst)[M], const float* src) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int i = 0; i < M; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      dst[i] = t.x; dst[i + 1] = t.y; dst[i + 2] = t.z; dst[i + 3] = t.w;
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int i = 0; i < M; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + i);
      dst[i] = t.x; dst[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) dst[i] = src[i];
  }
}

// grid.x enumerates the output tiles (b1, b2) row-major, grid.z the splits.
template <typename T, int TW1, int TW2, int TK, int M1, int M2>
__global__ void __launch_bounds__((TW1 / M1) * (TW2 / M2))
contract_kernel(Operand P, Operand Q, float* __restrict__ out, long long K,
                long long k_per_split) {
  constexpr int N1 = TW1 / M1, N2 = TW2 / M2, THREADS = N1 * N2;
  constexpr int PAD = 4;  // keeps rows 16-byte aligned, spreads banks
  __shared__ __align__(16) float ps[TK][TW1 + PAD];
  __shared__ __align__(16) float qs[TK][TW2 + PAD];
  const int tid = threadIdx.x;
  const int t2 = tid % N2, t1 = tid / N2;
  const int n2 = (Q.wdim + TW2 - 1) / TW2;
  const int b1 = blockIdx.x / n2, b2 = blockIdx.x % n2;
  const int w10 = b1 * TW1, w20 = b2 * TW2;
  const long long kb = (long long)blockIdx.z * k_per_split;
  const long long ke = min(K, kb + k_per_split);
  const bool pk = P.B > 1, qk = Q.B > 1;

  float acc[M1][M2];
#pragma unroll
  for (int i = 0; i < M1; ++i)
#pragma unroll
    for (int j = 0; j < M2; ++j) acc[i][j] = 0.f;

  Stage<T, TK, TW1, THREADS> sp;
  Stage<T, TK, TW2, THREADS> sq;
  if (kb < ke) {
    sp.fetch(P, kb, ke, w10, tid);
    sq.fetch(Q, kb, ke, w20, tid);
  }
  for (long long k0 = kb; k0 < ke; k0 += TK) {
    sp.put(ps, pk, tid);
    sq.put(qs, qk, tid);
    __syncthreads();
    if (k0 + TK < ke) {  // next tile's loads fly while this one is consumed
      sp.fetch(P, k0 + TK, ke, w10, tid);
      sq.fetch(Q, k0 + TK, ke, w20, tid);
    }
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float pv[M1], qv[M2];
      load_vec<M1>(pv, &ps[kk][t1 * M1]);
      load_vec<M2>(qv, &qs[kk][t2 * M2]);
#pragma unroll
      for (int i = 0; i < M1; ++i)
#pragma unroll
        for (int j = 0; j < M2; ++j) acc[i][j] = fmaf(pv[i], qv[j], acc[i][j]);
    }
    __syncthreads();
  }
  // partial sums of split blockIdx.z, row-major (P.wdim, Q.wdim)
  float* o = out + (long long)blockIdx.z * P.wdim * Q.wdim;
#pragma unroll
  for (int i = 0; i < M1; ++i) {
    const int w1 = w10 + t1 * M1 + i;
    if (w1 >= P.wdim) continue;
#pragma unroll
    for (int j = 0; j < M2; ++j) {
      const int w2 = w20 + t2 * M2 + j;
      if (w2 < Q.wdim) o[(long long)w1 * Q.wdim + w2] = acc[i][j];
    }
  }
}

// info != nullptr: report the launch figures (describe()) instead of launching
template <typename T, int TW1, int TW2, int TK, int M1, int M2>
cudaError_t launch_contract(const Operand& P, const Operand& Q, float* out, long long K,
                            int splits, long long k_per_split, cudaStream_t st,
                            int* info = nullptr) {
  constexpr int THREADS = (TW1 / M1) * (TW2 / M2);
  if (k_per_split % TK != 0 || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  const long long n1 = (P.wdim + TW1 - 1) / TW1, n2 = (Q.wdim + TW2 - 1) / TW2;
  const long long gx = n1 * n2;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (info != nullptr)
    return describe(contract_kernel<T, TW1, TW2, TK, M1, M2>, THREADS, gx * splits, info);
  dim3 grid((unsigned)gx, 1, splits);
  contract_kernel<T, TW1, TW2, TK, M1, M2><<<grid, THREADS, 0, st>>>(
      P, Q, out, K, k_per_split);
  return cudaGetLastError();
}

}  // namespace atucker
