// Boundary-mode TTM as one GEMM:  C (M, N) = A (M, K) @ B (K, N), fp32 out.
//
// Replaces the Pallas kernel repro/kernels/matmul.py::matmul.  The first mode
// computes u (R, I) @ X (I, J) and the last mode X (J, I) @ u^T (I, R); in
// both the TTM output is skinny (R of a few dozen) and the tensor X is large.
// Two routes, a pure function of (M, N) (mirrored in
// repro_torch/kernels/matmul.py, route()):
//
//   * slab (R <= 16 on the first mode, N <= M: the last mode).  Bound by the
//     bytes of X.  contract.cuh's FFMA tile kernel (shared with ttt.cu),
//     reading A as a (1, M, K) view and B as a (K, N, 1) view: a 16 x 128
//     tile (first mode) or 128 x 16 (last mode) holds all outputs of its
//     strip of X, so a block reads its strip once; an R above 16 on the last
//     mode takes more 16-wide tiles, each reading X again.  Ragged edges are
//     masked; nothing is padded.
//   * wide (the first mode at R > 16: M > 16 and N > M).  16-row slabs would
//     read X once per 16 rows, and a single FFMA pass is above the bytes
//     bound from R ~ 40 on (67 TFLOP/s), so the tile is computed on the
//     tensor cores at fp32 accuracy, reading X once for R <= 256 (R > 256
//     runs in chunks of 256 outputs).  C^T = X^T u^T: X^T is wgmma's A
//     operand from registers (m64, 64 columns of X per consumer warpgroup),
//     u^T its B operand from shared memory.  fp32 operands are split into
//     hi = rna_tf32(v) and lo = rna_tf32(v - hi) and every k-step is hi*lo +
//     lo*hi + hi*hi (split TF32); bf16 operands are exact in TF32 and take
//     one product.  The tensor cores' fp32 accumulator truncates, so each
//     stage (32 k) is summed there from zero and added in fp32.
//       - X arrives by TMA (a 3-D map over (N, K, 1), 128-byte boxes of 32 k
//         rows, 128-byte swizzle, zero fill for the ragged K = 1021 and N)
//         into a ring of stages kept full by one producer thread; X rows
//         that are not 16-byte multiples, or a misaligned X, are loaded by
//         the producer warpgroup with plain loads into the same layout.
//       - u is split once per call by a small kernel into a pre-split image
//         in the caller's workspace: per stage, the hi and lo tiles in the
//         swizzled K-major layout wgmma reads, zero beyond R and K, copied
//         into the ring stage by one bulk copy beside X's boxes.
//       - Each thread reads its A fragment from the landed X tile and splits
//         it there.  Within a k-step, fragment column t + 4h takes X row 2t
//         + h (u's image is permuted the same way), so the 32 lanes' reads
//         of 4 rows x 8 columns fall in 32 distinct banks of the swizzle.
//       - A persistent block per SM walks 128-column tiles of X (64 when R >
//         128: both warpgroups then share the tile and take half of R each),
//         so the ring runs ahead across tiles; the sums go straight from
//         registers to C, each warp writing whole 32-byte sectors.
#include "contract.cuh"
#include "wgmma.cuh"

using namespace atucker;

namespace {

constexpr int ROUTE_SLAB = 0, ROUTE_WIDE = 1;
constexpr int CHUNK = 256;           // outputs per pass of the wide route
constexpr int TK = 32;               // k rows per stage
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block can use

// Geometry of a wide launch: NT outputs per consumer warpgroup (the wgmma
// width), SPLIT when the two warpgroups share a tile and split R.
template <typename T, int NT, bool SPLIT>
struct Geo {
  static constexpr int ES = sizeof(T);
  static constexpr int BOX_N = 128 / ES;               // X columns per box
  static constexpr int PLANES = ES == 4 ? 2 : 1;       // hi, lo (fp32)
  static constexpr int BNT = SPLIT ? 64 : 128;         // X columns per tile
  static constexpr int ROWS = SPLIT ? 2 * NT : NT;     // rows of u's image
  static constexpr int XBYTES = BNT * TK * ES;         // BNT / BOX_N boxes
  static constexpr int BBYTES = PLANES * ROWS * 128;   // one image stage
  static constexpr int STAGE = XBYTES + BBYTES;
  static constexpr int KS = TK / 8;                    // k-steps per stage
};

struct WideArgs {
  const void* x;       // (K, N) row-major
  const void* img;     // u's pre-split image: n_k stages of BBYTES
  float* c;            // (rows, N) row-major
  int rows, N, K;
  int n_k;             // stages: ceil(K / TK)
  int tiles;           // ceil(N / BNT)
  int tma;             // X by TMA, else plain loads
  int nst;             // ring stages
};

// Physical k (within a stage) of column `col` of u's image: the 8 columns of
// k-step j hold rows 8j + 2t + h at column 8j + t + 4h.
__device__ __forceinline__ int image_k(int col) {
  const int cc = col % 8;
  return col - cc + 2 * (cc % 4) + cc / 4;
}

// u (rows, K) -> its image: stage s, plane p (hi, lo), row r, column col at
// s * BBYTES + p * ROWS * 128 + swz(r, col, 4), zero beyond rows and K.
template <typename T, int ROWS, int PLANES>
__global__ void __launch_bounds__(256)
gemm_image_kernel(const T* __restrict__ u, unsigned char* __restrict__ img, int rows, int K,
                  int n_k) {
  const long long n = (long long)n_k * ROWS * TK;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int s = (int)(idx / (ROWS * TK));
  const int r = (int)(idx / TK % ROWS), col = (int)(idx % TK);
  const int k = s * TK + image_k(col);
  const float v = r < rows && k < K ? to_f32(u[(long long)r * K + k]) : 0.f;
  unsigned char* st = img + (long long)s * PLANES * ROWS * 128;
  if constexpr (PLANES == 2) {
    const float hi = tf32_rna(v);
    *reinterpret_cast<float*>(st + swz(r, col, 4)) = hi;
    *reinterpret_cast<float*>(st + ROWS * 128 + swz(r, col, 4)) = tf32_rna(v - hi);
  } else {
    *reinterpret_cast<float*>(st + swz(r, col, 4)) = v;  // bf16 is exact in TF32
  }
}

// The products of one stage for this warpgroup, launched and committed:
// acc = A (its 64 columns of the X tile at `st`, element q of k-step ks read
// at byte off[q] + 1024 ks and split in registers; the caller keeps
// `ahi`/`alo` until the wgmma are waited for) times the image's planes at
// `bimg` (hi, then lo).
template <typename T, int NT, int KS, int PLANES>
__device__ __forceinline__ void stage_products(float (&acc)[NT / 2], uint32_t (&ahi)[KS][4],
                                               uint32_t (&alo)[KS][4], const unsigned char* st,
                                               const unsigned char* bimg, int rows_img,
                                               const int (&off)[4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = to_f32(*reinterpret_cast<const T*>(st + off[q] + 1024 * ks));
      if constexpr (PLANES == 2) {
        const float h = tf32_rna(v);
        ahi[ks][q] = __float_as_uint(h);
        alo[ks][q] = __float_as_uint(tf32_rna(v - h));
      } else {
        ahi[ks][q] = __float_as_uint(v);
      }
    }
  wgmma_fence();
  const uint64_t bh = sw128_desc(bimg);
  if constexpr (PLANES == 2) {
    // the small products first, while the accumulator is small; 32-byte
    // k-steps advance the descriptors' 16-byte address field by 2
    const uint64_t bl = sw128_desc(bimg + rows_img * 128);
    wgmma_tf32<NT, true>(acc, ahi[0], bl);
    wgmma_tf32<NT, false>(acc, alo[0], bh);
#pragma unroll
    for (int ks = 1; ks < KS; ++ks) {
      wgmma_tf32<NT, false>(acc, ahi[ks], bl + 2 * ks);
      wgmma_tf32<NT, false>(acc, alo[ks], bh + 2 * ks);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_tf32<NT, false>(acc, ahi[ks], bh + 2 * ks);
  } else {
    wgmma_tf32<NT, true>(acc, ahi[0], bh);
#pragma unroll
    for (int ks = 1; ks < KS; ++ks) wgmma_tf32<NT, false>(acc, ahi[ks], bh + 2 * ks);
  }
  wgmma_commit();
}

// Shared memory (1024-byte aligned): nst stages of (X tile: BNT / BOX_N
// boxes of TK rows x 128 bytes; u's image stage), then the mbarriers.
// Warpgroup 2 feeds the ring and gives its registers to the two consumer
// warpgroups (setmaxnreg).
template <typename T, int NT, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_wide_kernel(__grid_constant__ const CUtensorMap mx, WideArgs p) {
  using G = Geo<T, NT, SPLIT>;
  constexpr int KS = G::KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.nst * G::STAGE);
  uint64_t* empty = full + p.nst;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      // TMA: the producer's expect_tx; plain: that and the four warps' loads
      mbar_init(&full[s], p.tma ? 1 : 5);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const unsigned char* img = static_cast<const unsigned char*>(p.img);
    const int pt = tid - CONSUMERS;  // 0 .. 127
    if (p.tma && pt != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = tile * G::BNT;
      for (int s = 0; s < p.n_k; ++s, ++it) {
        const int slot = it % p.nst;
        unsigned char* st = smem + slot * G::STAGE;
        mbar_wait(&empty[slot], (uint32_t)(((it / p.nst) & 1) ^ 1));
        if (p.tma) {
          mbar_arrive_tx(&full[slot], G::STAGE);
#pragma unroll
          for (int b = 0; b < G::BNT / G::BOX_N; ++b)
            tma_load_3d(st + b * TK * 128, &mx, n0 + b * G::BOX_N, s * TK, 0, &full[slot]);
          bulk_copy(st + G::XBYTES, img + (long long)s * G::BBYTES, G::BBYTES, &full[slot]);
          continue;
        }
        if (pt == 0) {
          mbar_arrive_tx(&full[slot], G::BBYTES);
          bulk_copy(st + G::XBYTES, img + (long long)s * G::BBYTES, G::BBYTES, &full[slot]);
        }
        // plain loads: consecutive threads on consecutive columns of a row
        const T* __restrict__ x = static_cast<const T*>(p.x);
        constexpr int PER = G::BNT * TK / 128, BATCH = 8;
        for (int j0 = 0; j0 < PER; j0 += BATCH) {
          T v[BATCH];
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            const int e = pt + (j0 + j) * 128, k = s * TK + e / G::BNT, n = n0 + e % G::BNT;
            v[j] = k < p.K && n < p.N ? x[(long long)k * p.N + n] : T(0.f);
          }
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            const int e = pt + (j0 + j) * 128, kk = e / G::BNT, nn = e % G::BNT;
            *reinterpret_cast<T*>(st + (nn / G::BOX_N) * TK * 128 +
                                  swz(kk, nn % G::BOX_N, G::ES)) = v[j];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[slot]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // ---- consumers ----
  const int nb = SPLIT ? 0 : wg * 64;   // this warpgroup's first column of the tile
  const int rb = SPLIT ? wg * NT : 0;   // its first output (row of u's image)
  const int g = lane / 4, t = lane % 4;
  // A element q of k-step ks: tile column nb + 16 warp + g + 8 (q % 2), X row
  // 8 ks + 2 t + q / 2 of the stage (image_k's permutation); a k-step is 8
  // rows, 1024 bytes further on, with the same swizzle
  int off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int nn = nb + 16 * warp + g + 8 * (q % 2);
    off[q] = (nn / G::BOX_N) * TK * 128 + swz(2 * t + q / 2, nn % G::BOX_N, G::ES);
  }
  float acc[NT / 2], sum[NT / 2];
  uint32_t ahi[KS][4], alo[KS][4];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) sum[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    for (int s = 0; s < p.n_k; ++s, ++it) {
      const int slot = it % p.nst;
      const unsigned char* st = smem + slot * G::STAGE;
      mbar_wait(&full[slot], (uint32_t)((it / p.nst) & 1));
      stage_products<T, NT, KS, G::PLANES>(acc, ahi, alo, st, st + G::XBYTES + rb * 128,
                                           G::ROWS, off);
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[slot]);
      fence_acc(acc);
      fence_frags(ahi);
      if constexpr (G::PLANES == 2) fence_frags(alo);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) sum[i] += acc[i];
    }
    // sum[4c + 2h + e] is C[rb + 8c + 2t + e][n0 + nb + 16 warp + g + 8h]
    const int n = tile * G::BNT + nb + 16 * warp + g;
    float* __restrict__ c = p.c;
#pragma unroll
    for (int v = 0; v < NT / 2; ++v) {
      const int r = rb + 8 * (v / 4) + 2 * t + v % 2, nn = n + 8 * ((v / 2) % 2);
      if (r < p.rows && nn < p.N) c[(long long)r * p.N + nn] = sum[v];
      sum[v] = 0.f;
    }
  }
}

// 3-D map over X (K, N) as dims (N, K, 1): boxes of 128 bytes x TK rows,
// 128-byte swizzle, zero fill outside
template <typename T>
cudaError_t encode_x(CUtensorMap* map, const void* x, int N, int K) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  constexpr int ES = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)N * ES, (cuuint64_t)N * K * ES};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / ES), (cuuint32_t)TK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map,
                         ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, const_cast<void*>(x), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One chunk of at most CHUNK outputs.  info != nullptr: report the launch
// figures (out[0..3] the GEMM, out[4..7] the image kernel, out[12] dynamic
// shared memory, out[14] TMA loads, out[15] ring stages) instead of
// launching.
template <typename T, int NT, bool SPLIT>
cudaError_t launch_chunk(const void* u, const void* x, float* c, void* ws, int rows, int N,
                         int K, cudaStream_t st, int* info) {
  using G = Geo<T, NT, SPLIT>;
  WideArgs p;
  p.x = x;
  p.img = ws;
  p.c = c;
  p.rows = rows;
  p.N = N;
  p.K = K;
  p.n_k = ceil_div(K, TK);
  p.tiles = ceil_div(N, G::BNT);
  p.tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (long long)N * G::ES % 16 == 0;
  p.nst = (SMEM_LIMIT - 1024 - 2 * MAX_STAGES * (int)sizeof(uint64_t)) / G::STAGE;
  if (p.nst > MAX_STAGES) p.nst = MAX_STAGES;
  if (p.nst < 2) return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)p.nst * G::STAGE + 2 * p.nst * sizeof(uint64_t);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  auto kernel = gemm_wide_kernel<T, NT, SPLIT>;
  auto image = gemm_image_kernel<T, G::ROWS, G::PLANES>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long img_elems = (long long)p.n_k * G::ROWS * TK;
  if (info != nullptr) {
    info[12] = (int)smem;
    info[14] = p.tma;
    info[15] = p.nst;
    err = describe(kernel, THREADS, grid, info, smem);
    if (err != cudaSuccess) return err;
    return describe(image, 256, ceil_div(img_elems, 256), info + 4);
  }
  image<<<ceil_div(img_elems, 256), 256, 0, st>>>(static_cast<const T*>(u),
                                                  static_cast<unsigned char*>(ws), rows, K,
                                                  p.n_k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CUtensorMap mx{};
  if (p.tma && (err = encode_x<T>(&mx, x, N, K)) != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, st>>>(mx, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* a, const void* x, float* c, void* ws, int M, int N, int K,
                        cudaStream_t st, int* info) {
  for (int r0 = 0; r0 < M; r0 += CHUNK) {
    const int rows = M - r0 < CHUNK ? M - r0 : CHUNK;
    const T* u = static_cast<const T*>(a) + (long long)r0 * K;
    float* cc = c == nullptr ? nullptr : c + (long long)r0 * N;
    cudaError_t err;
    if (rows <= 32)
      err = launch_chunk<T, 32, false>(u, x, cc, ws, rows, N, K, st, info);
    else if (rows <= 64)
      err = launch_chunk<T, 64, false>(u, x, cc, ws, rows, N, K, st, info);
    else if (rows <= 128)
      err = launch_chunk<T, 128, false>(u, x, cc, ws, rows, N, K, st, info);
    else
      err = launch_chunk<T, 128, true>(u, x, cc, ws, rows, N, K, st, info);
    if (err != cudaSuccess || info != nullptr) return err;  // report the first chunk
  }
  return cudaSuccess;
}

// The route a call takes (mirrored in repro_torch/kernels/matmul.py, route()).
int route_of(int M, int N) { return N > M && M > 16 ? ROUTE_WIDE : ROUTE_SLAB; }

// info != nullptr: report the launch figures (describe()) instead of launching
template <typename T>
cudaError_t dispatch(const void* a, const void* b, float* c, void* ws, int M, int N, int K,
                     int route, cudaStream_t st, int* info = nullptr) {
  if (info != nullptr) info[13] = route;
  if (route == ROUTE_WIDE) return launch_wide<T>(a, b, c, ws, M, N, K, st, info);
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
// the route (0 slab, 1 wide), out[14] 1 when X arrives by TMA (wide),
// out[15] the ring's stages (wide).  The wide route reports its first chunk
// of 256 outputs.  b (X on the first mode) is only inspected for
// alignment.
extern "C" int atucker_matmul_info(const void* b, int M, int N, int K, int dtype, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  const int route = route_of(M, N);
  if (dtype == kFloat32)
    return (int)dispatch<float>(nullptr, b, nullptr, nullptr, M, N, K, route, 0, out);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(nullptr, b, nullptr, nullptr, M, N, K, route, 0, out);
  return cudaErrorInvalidValue;
}
