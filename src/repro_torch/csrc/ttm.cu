// Interior-mode TTM on the (A, I, B) view:  out[a, r, b] = sum_i u[r, i] * x[a, i, b].
//
// Replaces the Pallas kernel repro/kernels/ttm.py::ttm_interior.  R is small
// (a few dozen at most) and x large, so the kernel is bound by the bytes of
// x: at u (10, 1340), x (1021, 1340, 264) fp32 that is 1.445 GB, 0.435 ms at
// 3.35 TB/s, against 0.108 ms of FFMA.  Three routes, a pure function of
// (R, B, dtype, alignment) (mirrored in repro_torch/kernels/ttm.py,
// route()): slab and plain (R <= 16, FFMA, below) and wide (R > 16).
//
// wide (R > 16).  One FFMA pass is above the bytes bound from R ~ 40 on (67
// TFLOP/s: at R = 64 the FFMA time is 0.690 ms against 0.452 ms of bytes),
// and 16-row slabs re-read x once per 16 rows (4 reads at R = 64, 5.3 ms
// measured).  For each a, out[a] (R, B) = u (R, I) @ x[a] (I, B): a batch of
// A first-mode GEMMs sharing u, which is wgmma.cuh's wide route with X_a =
// x[a] -- one pass over x for R <= 128 on split-TF32 wgmma, x by TMA through
// a 3-D map over (B, I, A) (rows of x a 16-byte multiple of at least 128
// bytes, x aligned; else the producer's plain loads, with columns packed
// across values of a), u pre-split once a call into the caller's workspace
// (kernels/ttm.py workspace_bytes), each stage's hi*hi summed exactly.
//
// slab / plain (R <= 16).  The output columns j = (a, b) of the flattened
// A*B axis are cut into tiles.  Every tile reads all I rows of
// its columns, so all work units are equally long, and a persistent grid --
// as many blocks as fit on the SMs, one per SM -- walks them in turn.  The
// one-thread-per-column design before it ran 2,106 whole-length blocks at 7
// per SM: two full waves and a thin third.
//
// Each block has one producer warp and 8 consumer warps.  The producer
// fills a double-buffered ring of 64 KB shared-memory stages, TI rows of the
// tile's columns each, by cp.async.bulk copies that complete on an mbarrier
// by transaction count.  When B <= NJ a tile is k whole values of a (k*B <=
// NJ, k chosen for the fewest rounds of the grid), so a stage is one
// contiguous copy of x[a, i0 : i0 + TI, :] per value of a; with B > NJ a
// tile is NJ consecutive columns and a stage takes one copy per row and
// value of a.  Few large copies per stage matter: on the H100 the same ring
// fed by row-sized copies streamed x markedly slower.
// Each consumer thread owns CPT columns of the tile and keeps their TR
// outputs in registers; u is loaded into shared memory once per block (as
// us[i][RP], read as float4 broadcasts), and again only when R*I does not
// fit in U_MAX_FLOATS, which takes u in segments of rows.
//
// R runs exactly: TR is a template on the widths the paths use (4, 8, 10,
// 12, 16); an R between them takes the next width, with zero rows of u.
//
// A bulk copy needs 16-byte aligned rows, so the ring (route slab) runs
// when a row of x (B elements) is a multiple of 16 bytes, at least 128
// bytes, and x is 16-byte aligned.  Any other shape (B = 1, odd B, small B)
// takes the plain path of the same kernel (route plain): no producer, each
// consumer thread loads its columns' elements from memory itself (coalesced
// along b).
//
// fp32 FFMA accumulation (TF32 cannot meet the fp32 tolerance); bf16 x and u
// are converted on load.  Ragged edges are masked, nothing is padded, and
// memory is indexed in 64 bits.
#include "wgmma.cuh"

using namespace atucker;

namespace {

constexpr int CONSUMER_WARPS = 8;
constexpr int CT = CONSUMER_WARPS * 32;  // consumer threads
constexpr int CPT = 4;                   // columns per consumer thread
constexpr int NJ = CT * CPT;             // columns a stage holds
constexpr int TI = 16;                   // rows of x per stage
constexpr int STAGES = 2;
constexpr int U_MAX_FLOATS = 24576;      // u in shared memory: <= 96 KB
constexpr int MIN_BULK_ROW_BYTES = 128;
constexpr int FFMA_MAX_R = 16;           // widest R of the FFMA routes
constexpr int ROUTE_SLAB = 0, ROUTE_PLAIN = 1, ROUTE_WIDE = 2;

__host__ __device__ constexpr int padded(int tr) { return (tr + 3) / 4 * 4; }

struct Plan {
  long long J;       // A * B columns
  long long W;       // columns per tile: NJ, or k whole rows of B when whole
  long long tiles;   // column tiles of W
  int iseg;          // rows of u per shared-memory segment (all of I, or a multiple of TI)
  int whole;         // tiles are whole values of a: one copy per a and stage
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(CT) : "memory");
}

// us[i][r] = u[r, i0 + i] for the rows [i0, i0 + n) (zeros past R);
// consumers only.
template <typename T, int RP>
__device__ void load_u(const T* __restrict__ u, float* us, int I, int rows, int i0, int n) {
  consumer_sync();  // nobody still reads the previous segment
  for (int e = threadIdx.x; e < n * RP; e += CT) {
    const int i = e % n, r = e / n;  // consecutive threads walk i of u's row
    us[i * RP + r] = r < rows ? to_f32(u[(long long)r * I + i0 + i]) : 0.f;
  }
  consumer_sync();
}

// acc[c][r] += sum over the rows of u[r, row] * x[row, column c]: from a
// shared-memory stage (column c at soff[c], rows rstride apart) ...
template <typename T, int TR, int UNROLL>
__device__ __forceinline__ void consume(float (&acc)[CPT][TR], const float* ub, const T* stage,
                                        const int (&soff)[CPT], int rstride, int rows) {
  constexpr int RP = padded(TR);
#pragma unroll UNROLL
  for (int row = 0; row < rows; ++row) {
    float uv[RP];
#pragma unroll
    for (int r = 0; r < RP; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ub + row * RP + r);
      uv[r] = v.x, uv[r + 1] = v.y, uv[r + 2] = v.z, uv[r + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float xv = to_f32(stage[soff[c] + row * rstride]);
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[c][r] = fmaf(uv[r], xv, acc[c][r]);
    }
  }
}

// ... or straight from x (the plain path: row stride B, column c at col_off[c])
template <typename T, int TR, int UNROLL>
__device__ __forceinline__ void consume_global(float (&acc)[CPT][TR], const float* ub,
                                               const T* __restrict__ xr,
                                               const long long (&col_off)[CPT], int B,
                                               int rows) {
  constexpr int RP = padded(TR);
#pragma unroll UNROLL
  for (int row = 0; row < rows; ++row) {
    float uv[RP];
#pragma unroll
    for (int r = 0; r < RP; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ub + row * RP + r);
      uv[r] = v.x, uv[r + 1] = v.y, uv[r + 2] = v.z, uv[r + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float xv = to_f32(xr[col_off[c] + (long long)row * B]);
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[c][r] = fmaf(uv[r], xv, acc[c][r]);
    }
  }
}

template <typename T, int TR, bool BULK>
__global__ void __launch_bounds__(BULK ? CT + 32 : CT, 1)
ttm_interior_kernel(const T* __restrict__ u, const T* __restrict__ x, float* __restrict__ out,
                    int A, int I, int B, int R, Plan p) {
  constexpr int RP = padded(TR);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  T* xs = reinterpret_cast<T*>(smem + 128);  // STAGES x TI x NJ
  float* us = reinterpret_cast<float*>(smem + 128 + (BULK ? STAGES * TI * NJ * sizeof(T) : 0));

  const int tid = threadIdx.x;
  if constexpr (BULK) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMER_WARPS);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }
  const int n_iblocks = (I + TI - 1) / TI;

  if (BULK && tid >= CT) {
    // ---- producer warp: fill the ring ----
    const int lane = tid - CT;
    long long it = 0;
    for (long long unit = blockIdx.x; unit < p.tiles; unit += gridDim.x) {
      const long long j0 = unit * p.W;
      const long long j1 = min(p.J, j0 + p.W);
      const long long a_lo = j0 / B;
      const int nseg = (int)((j1 - 1) / B - a_lo + 1);
      for (int ib = 0; ib < n_iblocks; ++ib, ++it) {
        const int s = (int)(it % STAGES);
        const uint32_t parity = (uint32_t)((it / STAGES) & 1);
        const int i0 = ib * TI;
        const int rows = min(TI, I - i0);
        mbar_wait(&empty[s], parity ^ 1);
        if (lane == 0) mbar_arrive_tx(&full[s], (uint32_t)(rows * (j1 - j0) * sizeof(T)));
        __syncwarp();
        T* stage = xs + (long long)s * TI * NJ;
        if (p.whole) {
          // x[a, i0 : i0 + rows, :] is contiguous: one copy per value of a
          for (int q = lane; q < nseg; q += 32) {
            const long long a = a_lo + q;
            bulk_copy(stage + (long long)q * TI * B, x + (a * I + i0) * (long long)B,
                      (uint32_t)((long long)rows * B * sizeof(T)), &full[s]);
          }
        } else {
          for (int q = lane; q < rows * nseg; q += 32) {
            const int row = q / nseg;
            const long long a = a_lo + q % nseg;
            const long long lo = max(j0, a * B), hi = min(j1, (a + 1) * B);
            bulk_copy(stage + row * NJ + (lo - j0),
                      x + (a * I + i0 + row) * (long long)B + (lo - a * B),
                      (uint32_t)((hi - lo) * sizeof(T)), &full[s]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int lane = tid % 32;
  const int nseg_u = (I + p.iseg - 1) / p.iseg;
  bool u_loaded = false;
  long long it = 0;
  for (long long unit = blockIdx.x; unit < p.tiles; unit += gridDim.x) {
    const long long j0 = unit * p.W;
    const long long j1 = min(p.J, j0 + p.W);
    long long col_off[CPT];  // plain path: offset of (a, 0, b) of each column
    int soff[CPT];           // bulk path: offset of the column in a stage
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const long long j = min(j0 + tid + c * CT, p.J - 1);
      const long long a = j / B, b = j - a * B;
      col_off[c] = a * I * (long long)B + b;
      const bool mine = j0 + tid + c * CT < j1;  // else read, never stored
      soff[c] = !p.whole ? tid + c * CT : mine ? (int)((a - j0 / B) * TI * B + b) : 0;
    }
    const int rstride = p.whole ? B : NJ;
    float acc[CPT][TR];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[c][r] = 0.f;

    for (int ib = 0; ib < n_iblocks; ++ib, ++it) {
      const int i0 = ib * TI;
      if (i0 % p.iseg == 0 && (nseg_u > 1 || !u_loaded)) {
        load_u<T, RP>(u, us, I, R, i0, min(p.iseg, I - i0));
        u_loaded = true;
      }
      const int rows = min(TI, I - i0);
      const float* ub = us + (i0 % p.iseg) * RP;
      if (BULK) {
        const int s = (int)(it % STAGES);
        mbar_wait(&full[s], (uint32_t)((it / STAGES) & 1));
        const T* stage = xs + (long long)s * TI * NJ;
        if (rows == TI)
          consume<T, TR, TI>(acc, ub, stage, soff, rstride, TI);
        else
          consume<T, TR, 1>(acc, ub, stage, soff, rstride, rows);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      } else {
        const T* xr = x + (long long)i0 * B;
        if (rows == TI)
          consume_global<T, TR, TI>(acc, ub, xr, col_off, B, TI);
        else
          consume_global<T, TR, 1>(acc, ub, xr, col_off, B, rows);
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const long long j = j0 + tid + c * CT;
      if (j >= j1) continue;
      const long long a = j / B, b = j - a * B;
      float* op = out + a * R * (long long)B + b;
#pragma unroll
      for (int r = 0; r < TR; ++r)
        if (r < R) op[(long long)r * B] = acc[c][r];
    }
  }
}

Plan make_plan(int A, int I, int B, int tr) {
  Plan p;
  p.J = (long long)A * B;
  p.W = NJ;
  p.whole = 0;
  p.tiles = (p.J + NJ - 1) / NJ;
  const int fit = U_MAX_FLOATS / padded(tr) / TI * TI;
  p.iseg = I <= fit ? I : fit;
  return p;
}

int width_template(int w) {
  if (w <= 4) return 4;
  if (w <= 8) return 8;
  if (w <= 10) return 10;
  if (w <= 12) return 12;
  return 16;
}

bool use_bulk(const void* x, int B, int esize) {
  const long long row = (long long)B * esize;
  return row % 16 == 0 && row >= MIN_BULK_ROW_BYTES &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T, int TR, bool BULK>
size_t smem_bytes(const Plan& p) {
  return 128 + (BULK ? (size_t)STAGES * TI * NJ * sizeof(T) : 0) +
         (size_t)p.iseg * padded(TR) * sizeof(float);
}

// resident = blocks per SM x SMs at this launch's shared memory
template <typename T, int TR, bool BULK>
cudaError_t configure(size_t smem, long long* resident) {
  auto kernel = ttm_interior_kernel<T, TR, BULK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BULK ? CT + 32 : CT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = (long long)per_sm * sms;
  return cudaSuccess;
}

// Bulk path with B <= NJ: tiles of k whole values of a, so that a stage
// takes one contiguous copy per a.  k <= NJ / B is chosen for the fewest
// rounds of the resident grid (ties: the larger k).
void whole_tiles(Plan& p, int A, int B, long long resident) {
  long long best = -1;
  for (int k = NJ / B; k >= 1; --k) {
    const long long tiles = (A + k - 1) / k;
    const long long cost = (tiles + resident - 1) / resident * k;
    if (best < 0 || cost < best) {
      best = cost;
      p.W = (long long)k * B;
      p.tiles = tiles;
    }
  }
  p.whole = 1;
}

template <typename T, int TR, bool BULK>
cudaError_t run(const void* u, const void* x, float* o, int A, int I, int B, int R,
                cudaStream_t st, int* info) {
  Plan p = make_plan(A, I, B, TR);
  const size_t smem = smem_bytes<T, TR, BULK>(p);
  int grid = 0;
  long long resident = 0;
  cudaError_t err = configure<T, TR, BULK>(smem, &resident);
  if (err != cudaSuccess) return err;
  if (BULK && B <= NJ) whole_tiles(p, A, B, resident);
  grid = (int)(p.tiles < resident ? p.tiles : resident);
  if (info != nullptr) return describe(ttm_interior_kernel<T, TR, BULK>, BULK ? CT + 32 : CT,
                                       grid, info, smem);
  ttm_interior_kernel<T, TR, BULK><<<grid, BULK ? CT + 32 : CT, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(x), o, A, I, B, R, p);
  return cudaGetLastError();
}

// The route a call takes (mirrored in repro_torch/kernels/ttm.py, route()).
int route_of(const void* x, int B, int R, int esize) {
  if (R > FFMA_MAX_R) return ROUTE_WIDE;
  return use_bulk(x, B, esize) ? ROUTE_SLAB : ROUTE_PLAIN;
}

// info != nullptr: report the launch figures instead of launching
template <typename T>
cudaError_t dispatch(const void* u, const void* x, float* o, void* ws, int A, int I, int B,
                     int R, cudaStream_t st, int* info) {
  const int route = route_of(x, B, R, sizeof(T));
  if (info != nullptr) info[13] = route;
  if (route == ROUTE_WIDE) {
    // out[a] (R, B) = u (R, I) @ x[a] (I, B); x by TMA on the FFMA ring's rule
    const wide::Call q{u, x, o, ws, R, B, I, A, (long long)I * B, (long long)R * B,
                       B, 1, I, 1, 0, use_bulk(x, B, sizeof(T)), false};
    return wide::launch<T>(q, st, info);
  }
  const int tr = width_template(R);
  const bool bulk = route == ROUTE_SLAB;
#define TTM_RUN(TR)                                                          \
  return bulk ? run<T, TR, true>(u, x, o, A, I, B, R, st, info)              \
              : run<T, TR, false>(u, x, o, A, I, B, R, st, info)
  switch (tr) {
    case 4: TTM_RUN(4);
    case 8: TTM_RUN(8);
    case 10: TTM_RUN(10);
    case 12: TTM_RUN(12);
    default: TTM_RUN(16);
  }
#undef TTM_RUN
}

}  // namespace

// ws: the wide route's image of u (kernels/ttm.py workspace_bytes); unused
// by the FFMA routes.
extern "C" int atucker_ttm_interior(const void* u, const void* x, void* out, void* ws, int A,
                                    int I, int B, int R, int dtype, void* stream) {
  if (A <= 0 || I <= 0 || B <= 0 || R <= 0) return cudaErrorInvalidValue;
  if (R > FFMA_MAX_R && ws == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == kFloat32) return (int)dispatch<float>(u, x, o, ws, A, I, B, R, st, nullptr);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(u, x, o, ws, A, I, B, R, st, nullptr);
  return cudaErrorInvalidValue;
}

// Launch figures of a call of this shape, for reports: out[0..3] =
// registers per thread, threads per block, resident blocks per SM and grid
// blocks of the TTM kernel, out[4..7] the wide route's image kernel,
// out[12] its dynamic shared memory, out[13] the route (0 slab, 1 plain, 2
// wide), out[14] 1 when the wide route loads x by TMA, out[15] its ring
// stages.  x is only inspected for alignment.
extern "C" int atucker_ttm_interior_info(const void* x, int A, int I, int B, int R, int dtype,
                                         int* out) {
  if (A <= 0 || I <= 0 || B <= 0 || R <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  if (dtype == kFloat32)
    return (int)dispatch<float>(nullptr, x, nullptr, nullptr, A, I, B, R, 0, out);
  if (dtype == kBFloat16)
    return (int)dispatch<__nv_bfloat16>(nullptr, x, nullptr, nullptr, A, I, B, R, 0, out);
  return cudaErrorInvalidValue;
}
