// TTT / Gram on (A, I, B) views:  z[i, r] = sum_{a,b} x[a, i, b] * y[a, r, b].
//
// Replaces the Pallas kernel repro/kernels/ttt.py::ttt_pallas3.  The output
// (I x R) is small and the reduction (K = A*B) long -- 76,800 deep for the
// last mode of a (320, 240, 7000) tensor -- so the reduction is split across
// blocks into fp32 partial sums, which a second small kernel adds in split
// order: deterministic, no atomics.  x and y are read in place: no padding,
// no unfold.  Five routes, a pure function of R, B, the symmetry, dtype and
// alignment (mirrored in repro_torch/kernels/ttt.py, route()):
//
//   * cols (B == 1, R <= 16: the last mode's ALS TTT).  Bound by the bytes
//     of x.  One thread per column i: row k of x is contiguous along i, so
//     each load is coalesced; y's rows are staged in shared memory and read
//     as a broadcast; the R sums stay in registers.
//   * tile16 (R <= 16 otherwise).  Bound by the bytes of x.  The FFMA tile
//     kernel of contract.cuh with a 128 x 16 tile.
//   * wgmma_cols (B == 1, R > 16, y is not x: Cavity's last-mode ALS TTT,
//     x (10000, 10000) against y (10000, 20)).  Bound by the bytes of x.
//     z^T (R, I) = y^T @ x runs on wgmma.cuh's wide GEMM: x (A, I) is its X
//     (K, N), MN-major, by TMA boxes (or plain loads) from which each thread
//     reads and splits its A fragment; y^T is its u, split once a call into
//     the K-major pre-split image (hi cut to each stage's grid); one pass
//     over x, split along A into items whose partial sums the finish kernel
//     adds.  The tiled routes below would load these MN-major tiles without
//     TMA and run 128-wide output tiles at R = 20.
//   * wgmma_tma and wgmma_plain (R > 16 otherwise: the EIG Gram of a wide
//     mode, I = R = 1340 on the HSI tensor, and any wide TTT).  Bound by
//     arithmetic, so it runs on the tensor cores.  TF32 alone keeps 10
//     mantissa bits and misses the fp32 tolerance by 5x, so fp32 operands
//     are split into hi = rna_tf32(v) and lo = rna_tf32(v - hi) and every
//     tile product is hi*hi + hi*lo + lo*hi (split TF32, "3xTF32"):
//     fp32-class accuracy at a third of the TF32 rate, 495 / 3 = 165 TFLOP/s
//     of fp32 work against 67 for FFMA.  bf16 operands take one bf16 product
//     (exact products, fp32 sums).  A block owns an output tile of 128 rows
//     of x by TR columns of y and one split of the reduction.  TR fits R
//     (tile_r: 32, 64 or 128, the wgmma widths), so that R = 20 or 64 does
//     not run the tensor cores on 108 or 64 columns of zeros; a Gram's tiles
//     are 128 square: only the upper tiles run, a diagonal tile loads one
//     operand, and the finish kernel mirrors the rest.  Two consumer
//     warpgroups run wgmma.m64nTRk8 (tf32) or m64nTRk16 (bf16) on K-major
//     tiles of 128-byte rows in 128-byte-swizzled shared memory.  For fp32
//     each warpgroup reads its 64 rows of the x tile into registers and
//     splits them there (wgmma's A operand from registers); the B operand --
//     the y tile, or the x tile itself on a diagonal Gram tile -- is split
//     once into hi and lo tiles that both read.  The tensor cores' own fp32
//     sum truncates, so each stage's products are summed there from zero
//     and then added in fp32.
//       - wgmma_tma: the rows of x and y (B elements) are 16-byte multiples
//         of at least 128 bytes, and both are 16-byte aligned.  A producer
//         warp copies each (a, 128- or TR-row, 128-byte b-run) box by TMA
//         from a 3-D tensor map over (B, W, A) into a 4-stage mbarrier ring,
//         and three more warps split the B operands, beside the consumers;
//         the box's ragged edges (I = 1340 = 10*128 + 60, B = 264 = 8*32 +
//         8) are zero-filled by the copy, and the zeros are multiplied like
//         data: 8.3% of the products at B = 264.  Skipping those k-steps
//         costs more than it saves: ptxas serializes a wgmma that sits
//         behind a branch.
//       - wgmma_plain: any other shape (a Gram of B == 1 and so MN-major, a
//         row that is not a 16-byte multiple, a misaligned base).  The
//         consumers load the tiles from memory themselves over the flat
//         k = a*B + b into the same swizzled layout, double-buffered.
#include "contract.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// The wide route (R > 16): split-TF32 / bf16 products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE = 128;                  // output tile: TILE rows x TR columns
constexpr int TILE_BYTES = TILE * 128;     // one operand tile: TILE rows of 128 bytes
constexpr int CONSUMERS = 256;             // two consumer warpgroups, 64 rows each
constexpr int RING = 4;                    // TMA stages
constexpr int BSPLIT = 3;                  // buffers of the split B operand (fp32)
constexpr int ROUTE_COLS = 0, ROUTE_TILE16 = 1, ROUTE_TMA = 2, ROUTE_PLAIN = 3,
              ROUTE_WCOLS = 4;

// The output tile's R side (mirrored in kernels/ttt.py, tile_r()): the
// Gram's square tiles are TILE wide; a TTT's fit R -- 32, 64 or 128
// columns, the wgmma widths -- so that at R = 20 or 64 the tensor cores do
// not run on 108 or 64 columns of zeros
inline int tile_r(int R, bool sym) { return sym || R > 64 ? TILE : R > 32 ? 64 : 32; }

// TK: elements of k per stage (128 bytes a row); KSTEP: k per wgmma;
// PRODUCTS: wgmma per k-step (hi*hi + hi*lo + lo*hi, or one bf16 product)
template <typename T> struct Wide;
template <> struct Wide<float> { static constexpr int TK = 32, KSTEP = 8, PRODUCTS = 3; };
template <> struct Wide<__nv_bfloat16> {
  static constexpr int TK = 64, KSTEP = 16, PRODUCTS = 1;
};

struct WideArgs {
  const void* x;
  const void* y;
  int I, R, B;
  int nb;                // TMA: b-runs of TK per value of a
  long long kspace;      // TMA: A * nb * TK (padded); plain: A * B
  long long k_per_split; // a multiple of TK
  int tiles_r;           // column tiles of a non-sym launch
  int sym;               // upper tiles only (y is x)
};

// Upper-triangular tile pair (b1 <= b2) number t of an n x n tile grid.
__device__ __forceinline__ void upper_tile(int t, int n, int& b1, int& b2) {
  b1 = 0;
  while (t >= n - b1) { t -= n - b1; ++b1; }
  b2 = b1 + t;
}

// Four 8 x 8 matrices of 16-bit pairs from shared memory, one row address
// per lane (lanes 8m .. 8m + 7 give matrix m's rows); lane l receives row
// l / 4, pair l % 4 of each.  On fp32 data a matrix is 8 rows x 4 values
// and lane l gets value (l / 4, l % 4): the tf32 A fragment of wgmma.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// d (64 x N, fp32) = A (64 x 16, bf16) * B (N x 16, bf16)^T + (INIT ? 0 :
// d), both operands K-major in shared memory, N = 32, 64 or 128.  INIT
// writes d without reading it: the accumulator is never set by other
// instructions, which would make ptxas fence (and, behind a branch,
// serialize) the wgmma.
#define WGMMA_BF16(NSTR, DREGS, DA, DB, PRED, OUTS)                               \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " PRED ", 0;\n"                  \
               " wgmma.mma_async.sync.aligned.m64n" NSTR "k16.f32.bf16.bf16 " DREGS \
               ", " DA ", " DB ", p, 1, 1, 0, 0;\n}"                                \
               : OUTS                                                              \
               : "l"(da), "l"(db), "r"(INIT ? 0 : 1)                               \
               : "memory")
template <int N, bool INIT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_bf16: N is 32, 64 or 128");
  if constexpr (N == 128) {
    if constexpr (INIT) WGMMA_BF16("128", WGMMA_D64, "%64", "%65", "%66", WGMMA_D64_OUTPUTS);
    else WGMMA_BF16("128", WGMMA_D64, "%64", "%65", "%66", WGMMA_D64_OPERANDS);
  } else if constexpr (N == 64) {
    if constexpr (INIT) WGMMA_BF16("64", WGMMA_D32, "%32", "%33", "%34", WGMMA_D32_OUTPUTS);
    else WGMMA_BF16("64", WGMMA_D32, "%32", "%33", "%34", WGMMA_D32_OPERANDS);
  } else {
    if constexpr (INIT) WGMMA_BF16("32", WGMMA_D16, "%16", "%17", "%18", WGMMA_D16_OUTPUTS);
    else WGMMA_BF16("32", WGMMA_D16, "%16", "%17", "%18", WGMMA_D16_OPERANDS);
  }
}
#undef WGMMA_BF16

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(CONSUMERS) : "memory");
}

// fp32 tile of `bytes` -> hi and lo tiles, same layout, by `threads`
// threads (t = 0 .. threads - 1).  Elementwise, so the swizzle does not
// matter.
__device__ __forceinline__ void split_tile(const unsigned char* src, unsigned char* hi,
                                           unsigned char* lo, int t, int threads, int bytes) {
  const float4* x = reinterpret_cast<const float4*>(src);
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
  for (int q = t; q < bytes / 16; q += threads) {
    const float4 v = x[q];
    float4 a, b;
    a.x = tf32_rna(v.x); b.x = tf32_rna(v.x - a.x);
    a.y = tf32_rna(v.y); b.y = tf32_rna(v.y - a.y);
    a.z = tf32_rna(v.z); b.z = tf32_rna(v.z - a.z);
    a.w = tf32_rna(v.w); b.w = tf32_rna(v.w - a.w);
    h[q] = a;
    l[q] = b;
  }
}

// Plain route: rows w0 .. w0 + ROWS of the (A, W, B) operand p over the flat
// k range [k0, k0 + TK) (k < ke), zeros outside, into the swizzled tile
// `tile` -- the layout a TMA box lands in.  B > 1: consecutive threads take
// consecutive k of a row (contiguous along b); B == 1 (a Gram): the operand
// is MN-major, consecutive threads take consecutive rows (contiguous along
// w).  ASYNC (fp32): by cp.async, which the caller commits and waits for;
// else by loads and stores.
template <typename T, int ROWS, bool ASYNC>
__device__ __forceinline__ void load_tile(const T* __restrict__ p, int W, int B, int w0,
                                          long long k0, long long ke, unsigned char* tile,
                                          int tid) {
  constexpr int TK = Wide<T>::TK, ES = sizeof(T);
  constexpr int PER = ROWS * TK / CONSUMERS;  // elements per thread
  // element j of this thread: row r0 + j * dr, column c0 + j * dc
  int r0, dr, c0, dc;
  long long base, step;  // its offset in p: base + j * step, valid when k < ke
  if (B > 1) {
    r0 = tid / TK, dr = CONSUMERS / TK, c0 = tid % TK, dc = 0;
    const long long k = k0 + c0;
    const long long a = k / B;
    base = a * W * (long long)B + (k - a * B) + (long long)(w0 + r0) * B;
    step = (long long)dr * B;
  } else {
    r0 = tid % ROWS, dr = 0, c0 = tid / ROWS, dc = CONSUMERS / ROWS;
    base = (k0 + c0) * W + w0 + r0;
    step = (long long)dc * W;
  }
  if constexpr (ASYNC) {
    static_assert(ES == 4, "load_tile: cp.async copies 4-byte elements");
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const bool ok = k0 + c0 + j * dc < ke && w0 + r0 + j * dr < W;
      cp_async_4(tile + swz(r0 + j * dr, c0 + j * dc, ES), ok ? p + base + j * step : p, ok);
    }
    return;
  }
  T v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool ok = k0 + c0 + j * dc < ke && w0 + r0 + j * dr < W;
    v[j] = ok ? p[base + j * step] : T(0.f);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    *reinterpret_cast<T*>(tile + swz(r0 + j * dr, c0 + j * dc, ES)) = v[j];
}

// Adds (add) or stores this warpgroup's fp32 sums into its 64 x TR block
// of the partial sums `o` (row-major, I x R; the block's own region, so no
// other thread touches it) and zeroes them.  sum[4c + 2h + e] is (row
// i + 8 h, column r + 8 c + e) with i = 16 warp + lane / 4 and r = 2 (lane
// % 4) from the block's corner.  Loads go out in batches of 16 before
// their stores; no register that a wgmma uses is touched here (ptxas
// serializes every wgmma of a kernel that writes such a register behind a
// branch).
template <int TR>
__device__ __forceinline__ void flush_sums(float (&sum)[TR / 2], float* __restrict__ o, int I,
                                           int R, int i, int r, bool add) {
#pragma unroll
  for (int v0 = 0; v0 < TR / 2; v0 += 16) {
    float old[16];
#pragma unroll
    for (int v = v0; v < v0 + 16; ++v) {
      const int ii = i + 8 * ((v / 2) % 2), rr = r + 8 * (v / 4) + v % 2;
      old[v - v0] = add && ii < I && rr < R ? o[(long long)ii * R + rr] : 0.f;
    }
#pragma unroll
    for (int v = v0; v < v0 + 16; ++v) {
      const int ii = i + 8 * ((v / 2) % 2), rr = r + 8 * (v / 4) + v % 2;
      if (ii < I && rr < R) o[(long long)ii * R + rr] = sum[v] + old[v - v0];
      sum[v] = 0.f;
    }
  }
}

// The products of one stage for this warpgroup, launched and committed:
// acc = A (its 64 rows of the x tile `st`) * B^T.  fp32: the A rows are read
// into registers by ldmatrix and split there into hi and lo (`ahi`, `alo`,
// kept by the caller until the wgmma are waited for); B is the split tile
// pair `bs` (hi, lo), and the products are hi*lo + lo*hi, then hi*hi -- the
// small ones first, while the accumulator is small.  bf16: A and B straight
// from the stage (B at `st + yoff`).  `arow` is the lane's ldmatrix row.
template <typename T, int KS, int TR>
__device__ __forceinline__ void stage_products(float (&acc)[TR / 2], uint32_t (&ahi)[KS][4],
                                               uint32_t (&alo)[KS][4], const unsigned char* st,
                                               const unsigned char* bs, int yoff, int wg,
                                               int arow, int lane) {
  if constexpr (Wide<T>::PRODUCTS == 3) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(ahi[ks], st + arow * 128 + (((2 * ks + (lane >> 4)) ^ (lane & 7)) << 4));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __uint_as_float(ahi[ks][q]);
        const float h = tf32_rna(v);
        ahi[ks][q] = __float_as_uint(h);
        alo[ks][q] = __float_as_uint(tf32_rna(v - h));
      }
    }
    wgmma_fence();
    const uint64_t bh = sw128_desc(bs), bl = sw128_desc(bs + TR * 128);
    // 32-byte k-steps advance the descriptors' 16-byte address field by 2
    wgmma_tf32<TR, true>(acc, ahi[0], bl);
    wgmma_tf32<TR, false>(acc, alo[0], bh);
#pragma unroll
    for (int ks = 1; ks < KS; ++ks) {
      wgmma_tf32<TR, false>(acc, ahi[ks], bl + 2 * ks);
      wgmma_tf32<TR, false>(acc, alo[ks], bh + 2 * ks);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_tf32<TR, false>(acc, ahi[ks], bh + 2 * ks);
  } else {
    const uint64_t ah = sw128_desc(st + wg * 64 * 128), bh = sw128_desc(st + yoff);
    wgmma_fence();
    wgmma_bf16<TR, true>(acc, ah, bh);
#pragma unroll
    for (int ks = 1; ks < KS; ++ks) wgmma_bf16<TR, false>(acc, ah + 2 * ks, bh + 2 * ks);
  }
  wgmma_commit();
}

// One block: output tile (b1, b2) -- TILE rows of x by TR of y -- and split
// blockIdx.y of the reduction.  Two consumer warpgroups of 64 rows each run
// the products; on the TMA route a third warpgroup feeds them.
//
// Shared memory (1024-byte aligned): the operand tiles as loaded -- RING
// stages of (x: TILE rows, y: TR rows) for TMA, three for the plain route
// (two for bf16) --
// then (fp32) BSPLIT buffers of the split B operand (hi, lo: TR rows each),
// then the mbarriers.
//
// fp32: each consumer warpgroup reads its A rows (64 of x) from the loaded
// tile into registers and splits them there; the B operand (the y tile, or
// the x tile of a diagonal Gram tile) is split once into hi and lo tiles in
// shared memory for both.  bf16: both operands straight from the tiles.
//
// TMA route (warp-specialized, 384 threads).  Warpgroup 2 gives up
// registers (setmaxnreg) to the consumers: its first warp's lane 0 keeps
// the RING-stage ring full by TMA; its other three warps split each
// landed stage's B operand into one of BSPLIT buffers.  The consumers wait
// for a stage (full) and its split B (ready), run the products, and hand
// the ring slot (empty) and the B buffer (bfree) back.  So the copies and
// the split run beside the consumers' chain -- A split, wgmma launch, the
// fp32 adds -- instead of in it.  Plain route (256 threads): the consumers
// copy each stage themselves (fp32 by cp.async into three stages, two
// ahead), split B, and meet at barriers.
template <typename T, bool TMA, int TR>
__global__ void __launch_bounds__(TMA ? CONSUMERS + 128 : CONSUMERS, 1)
ttt_wide_kernel(__grid_constant__ const CUtensorMap mx, __grid_constant__ const CUtensorMap my,
                WideArgs p, float* __restrict__ out) {
  constexpr int TK = Wide<T>::TK, KSTEP = Wide<T>::KSTEP, KS = TK / KSTEP;
  constexpr bool SPLIT = Wide<T>::PRODUCTS == 3;
  // the plain route's stages: fp32 by cp.async, two stages ahead; bf16 by
  // loads, one ahead
  constexpr int NST = TMA ? RING : SPLIT ? 3 : 2;
  constexpr int YB = TR * 128, STB = TILE_BYTES + YB;   // a y tile; a stage (x, y)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;                           // NST x (x, y)
  unsigned char* bsplit = ring + NST * STB;             // BSPLIT x (hi, lo), fp32 only
  uint64_t* full = reinterpret_cast<uint64_t*>(bsplit + (SPLIT ? BSPLIT * 2 * YB : 0));
  uint64_t* empty = full + NST;   // ring slot free: the 8 consumer warps
  uint64_t* ready = empty + NST;  // B buffer split: the 3 split warps
  uint64_t* bfree = ready + BSPLIT;  // B buffer free: the 8 consumer warps

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  int b1, b2;
  if (p.sym) {
    upper_tile(blockIdx.x, (p.I + TILE - 1) / TILE, b1, b2);
  } else {
    b1 = blockIdx.x / p.tiles_r;
    b2 = blockIdx.x % p.tiles_r;
  }
  const int i0 = b1 * TILE, r0 = b2 * TR;
  const bool diag = p.sym && b1 == b2;  // the y tile is the x tile
  const int yoff = diag ? 0 : TILE_BYTES;  // the B operand's tile within a stage
  const long long kb = (long long)blockIdx.y * p.k_per_split;
  const long long ke = min(p.kspace, kb + p.k_per_split);
  const int n = (int)((ke - kb + TK - 1) / TK);  // stages of this block, >= 1

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < NST; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS / 32);
      }
      for (int s = 0; s < BSPLIT; ++s) {
        mbar_init(&ready[s], 3);
        mbar_init(&bfree[s], CONSUMERS / 32);
      }
      mbar_init_fence();
    }
    __syncthreads();
    if (wg == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
      if (warp == 0) {
        // ---- producer: lane 0 copies stage j into slot j % RING ----
        if (lane == 0) {
          const long long u0 = kb / TK;
          int la = (int)(u0 / p.nb), lb = (int)(u0 % p.nb);  // a and b-run of stage j
          for (int j = 0; j < n; ++j) {
            const int s = j % NST;
            mbar_wait(&empty[s], (uint32_t)(((j / NST) & 1) ^ 1));
            unsigned char* st = ring + s * STB;
            mbar_arrive_tx(&full[s], diag ? TILE_BYTES : STB);
            tma_load_3d(st, &mx, lb * TK, i0, la, &full[s]);
            if (!diag) tma_load_3d(st + TILE_BYTES, &my, lb * TK, r0, la, &full[s]);
            if (++lb == p.nb) {
              lb = 0;
              ++la;
            }
          }
        }
      } else if constexpr (SPLIT) {
        // ---- three warps split each stage's B operand ----
        const int t = tid - 128 * 2 - 32;  // 0 .. 95
        for (int j = 0; j < n; ++j) {
          const unsigned char* src = ring + (j % NST) * STB + yoff;
          unsigned char* bs = bsplit + (j % BSPLIT) * 2 * YB;
          mbar_wait(&full[j % NST], (uint32_t)((j / NST) & 1));
          mbar_wait(&bfree[j % BSPLIT], (uint32_t)(((j / BSPLIT) & 1) ^ 1));
          split_tile(src, bs, bs + YB, t, 96, YB);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&ready[j % BSPLIT]);
        }
      }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  }

  // ---- consumers ----
  // Accumulation in three levels.  The tensor cores' fp32 accumulator
  // truncates on every add, so a long sum in it drifts low (by ~1e-3 of
  // the diagonal over a split of the main path's Gram); it only ever holds
  // one stage, from zero: `acc`.  `acc` is added to `sum` by FADD, rounding
  // to nearest, and `sum` to the block's own partial sums in `out` every
  // `fold` ~ 4 sqrt(n) stages: a two-level fp32 sum, whose rounding grows
  // with n far slower than one running sum's over a split.
  float acc[TR / 2], sum[TR / 2];
  uint32_t ahi[KS][4], alo[KS][4];  // fp32: this warpgroup's A fragments
#pragma unroll
  for (int i = 0; i < TR / 2; ++i) sum[i] = 0.f;
  const int fold = max(1, (int)ceilf(4.f * sqrtf((float)n)));
  int left = fold;  // stages until the next flush
  float* o = out + (long long)blockIdx.y * p.I * p.R;
  const int oi = i0 + wg * 64 + warp * 16 + lane / 4, orr = r0 + 2 * (lane % 4);
  // this lane's ldmatrix row: matrix lane / 8, rows + 8 for the odd ones
  const int arow = wg * 64 + warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#define FINISH_STAGE(it)                                    \
  do { /* after the stage's wgmma are waited for */        \
    fence_acc(acc);                                         \
    if constexpr (SPLIT) {                                  \
      fence_frags(ahi);                                     \
      fence_frags(alo);                                     \
    }                                                       \
    _Pragma("unroll") for (int i = 0; i < TR / 2; ++i) sum[i] += acc[i]; \
    if (--left == 0 || (it) + 1 == n) {                     \
      flush_sums<TR>(sum, o, p.I, p.R, oi, orr, (it) + 1 > fold); \
      left = fold;                                          \
    }                                                       \
  } while (0)

  if constexpr (TMA) {
    for (int it = 0; it < n; ++it) {
      const int s = it % NST, b = it % BSPLIT;
      const unsigned char* st = ring + s * STB;
      mbar_wait(&full[s], (uint32_t)((it / NST) & 1));
      if (SPLIT) mbar_wait(&ready[b], (uint32_t)((it / BSPLIT) & 1));
      stage_products<T, KS, TR>(acc, ahi, alo, st, bsplit + b * 2 * YB, yoff, wg, arow, lane);
      wgmma_wait_all();
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        if (SPLIT) mbar_arrive(&bfree[b]);
      }
      FINISH_STAGE(it);
    }
  } else {
    // plain route.  fp32: the copies of stage it + 2 and the B split of
    // stage it + 1 go on while the tensor cores run stage it.  bf16: the
    // loads of stage it + 1.
    auto issue = [&](int it) {
      unsigned char* st = ring + (it % NST) * STB;
      const long long k0 = kb + (long long)it * TK;
      load_tile<T, TILE, SPLIT>(static_cast<const T*>(p.x), p.I, p.B, i0, k0, ke, st, tid);
      if (!diag)
        load_tile<T, TR, SPLIT>(static_cast<const T*>(p.y), p.R, p.B, r0, k0, ke,
                                st + TILE_BYTES, tid);
      if constexpr (SPLIT) cp_async_commit();
    };
    // stage it has landed in this thread's copies: split its B for all
    auto split = [&](int it) {
      if constexpr (SPLIT) {
        consumers_sync();  // the whole B tile is loaded
        unsigned char* bs = bsplit + (it % BSPLIT) * 2 * YB;
        split_tile(ring + (it % NST) * STB + yoff, bs, bs + YB, tid, CONSUMERS, YB);
      }
      fence_proxy_async();
    };
    issue(0);
    if constexpr (SPLIT) {
      if (n > 1) {
        issue(1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    split(0);
    consumers_sync();
    for (int it = 0; it < n; ++it) {
      stage_products<T, KS, TR>(acc, ahi, alo, ring + (it % NST) * STB,
                                bsplit + (it % BSPLIT) * 2 * YB, yoff, wg, arow, lane);
      if constexpr (SPLIT) {
        // stage it + 2 takes the slot of stage it - 1, done with at the
        // last barrier
        if (it + 2 < n) issue(it + 2);
        if (it + 1 < n) {
          if (it + 2 < n) cp_async_wait<1>();
          else cp_async_wait<0>();
          split(it + 1);
        }
      } else if (it + 1 < n) {
        issue(it + 1);
        split(it + 1);
      }
      wgmma_wait_all();
      FINISH_STAGE(it);
      consumers_sync();  // the next copies overwrite an earlier stage
    }
  }
#undef FINISH_STAGE
}

// 3-D map over an (A, W, B) operand: dims (B, W, A), boxes of (TK, rows, 1)
// -- 128 bytes by `rows` rows -- with the 128-byte swizzle and zero fill
template <typename T>
cudaError_t encode(CUtensorMap* map, const void* base, int A, int W, int B, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  constexpr int ES = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)W, (cuuint64_t)A};
  const cuuint64_t strides[2] = {(cuuint64_t)B * ES, (cuuint64_t)W * B * ES};
  const cuuint32_t box[3] = {(cuuint32_t)Wide<T>::TK, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map,
                         ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool TMA, int TR>
size_t wide_smem() {
  const int nst = TMA ? RING : Wide<T>::PRODUCTS == 3 ? 3 : 2;
  return 1024 + (size_t)nst * (TILE_BYTES + TR * 128) +
         (Wide<T>::PRODUCTS == 3 ? BSPLIT * 2 * TR * 128 : 0) +
         (2 * nst + 2 * BSPLIT) * sizeof(uint64_t);
}

template <typename T, bool TMA, int TR>
cudaError_t launch_wide(const void* x, const void* y, float* part, int A, int I, int R, int B,
                        int splits, long long k_per_split, bool sym, cudaStream_t st,
                        int* info) {
  constexpr int TK = Wide<T>::TK;
  WideArgs p;
  p.x = x;
  p.y = y;
  p.I = I;
  p.R = R;
  p.B = B;
  p.nb = (B + TK - 1) / TK;
  p.kspace = TMA ? (long long)A * p.nb * TK : (long long)A * B;
  p.k_per_split = k_per_split;
  const long long n1 = (I + TILE - 1) / TILE, n2 = (R + TR - 1) / TR;
  p.tiles_r = (int)n2;
  p.sym = sym ? 1 : 0;
  if (k_per_split % TK != 0 || splits > 65535 ||
      (long long)(splits - 1) * k_per_split >= p.kspace || (long long)splits * k_per_split < p.kspace)
    return cudaErrorInvalidValue;
  if (sym && (I != R || TR != TILE)) return cudaErrorInvalidValue;
  const long long tiles = sym ? n1 * (n1 + 1) / 2 : n1 * n2;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = wide_smem<T, TMA, TR>();
  const int threads = TMA ? CONSUMERS + 128 : CONSUMERS;
  auto kernel = ttt_wide_kernel<T, TMA, TR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[12] = (int)smem;
    return describe(kernel, threads, tiles * splits, info, smem);
  }
  CUtensorMap mx{}, my{};
  if (TMA) {
    if ((err = encode<T>(&mx, x, A, I, B, TILE)) != cudaSuccess) return err;
    if (sym) my = mx;
    else if ((err = encode<T>(&my, y, A, R, B, TR)) != cudaSuccess) return err;
  }
  dim3 grid((unsigned)tiles, splits);
  kernel<<<grid, threads, smem, st>>>(mx, my, p, part);
  return cudaGetLastError();
}

// The route a call takes (mirrored in repro_torch/kernels/ttt.py, route()).
int route_of(const void* x, const void* y, int R, int B, int esize, bool sym) {
  if (R <= 16) return B == 1 ? ROUTE_COLS : ROUTE_TILE16;
  if (B == 1 && !sym) return ROUTE_WCOLS;
  const long long row = (long long)B * esize;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return row % 16 == 0 && row >= 128 && aligned ? ROUTE_TMA : ROUTE_PLAIN;
}

// Where the wgmma_cols route keeps u's image in the workspace: after the
// partial sums (256-byte aligned) when the reduction is split, else at its
// start (mirrored in kernels/ttt.py, _workspace)
long long image_offset(int I, int R, int splits) {
  return splits > 1 ? ((long long)splits * I * R * 4 + 255) / 256 * 256 : 0;
}

// wgmma_cols (B = 1, y is not x, R > 16): z^T (R, I) = y^T (R, A) @ x (A,
// I) on wgmma.cuh's wide GEMM -- x (A, I) row-major is its X (K, N), MN-major
// tiles by TMA (rows a 16-byte multiple, x aligned) or plain loads, and y^T
// its u, read through strides and split once into the K-major image; z is
// written through strides.  Split along K = A: item p covers a in [p
// k_per_split, (p + 1) k_per_split) and writes its partial sums.
template <typename T>
cudaError_t launch_cols(const void* x, const void* y, float* part, unsigned char* ws, int A,
                        int I, int R, int splits, long long k_per_split, cudaStream_t st,
                        int* info) {
  if (k_per_split % wide::TK != 0 || k_per_split > 0x7fffffffLL ||
      (long long)(splits - 1) * k_per_split >= A || (long long)splits * k_per_split < A)
    return cudaErrorInvalidValue;
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (long long)I * sizeof(T) % 16 == 0;
  const wide::Call q{y, x, part, ws == nullptr ? nullptr : ws + image_offset(I, R, splits), R, I, A,
                     splits, (long long)A * I, (long long)I * R, 1, R, 1, R, (int)k_per_split,
                     tma, false};
  return wide::launch<T>(q, st, info);
}

// info != nullptr: report the launch figures (describe()) instead of launching
template <typename T>
cudaError_t dispatch(const void* x, const void* y, float* part, void* ws, int A, int I, int R,
                     int B, int splits, long long k_per_split, bool sym,
                     cudaStream_t st, int* info = nullptr) {
  const long long K = (long long)A * B;
  const int route = route_of(x, y, R, B, sizeof(T), sym);
  if (info != nullptr) info[13] = route;
  if (route == ROUTE_COLS) {
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
  if (route == ROUTE_TILE16) {
    const Operand P{x, B, (long long)I * B, I}, Q{y, B, (long long)R * B, R};
    return launch_contract<T, 128, 16, 32, 4, 2>(P, Q, part, K, splits, k_per_split, st, info);
  }
  if (route == ROUTE_WCOLS)
    return launch_cols<T>(x, y, part, static_cast<unsigned char*>(ws), A, I, R, splits,
                          k_per_split, st, info);
  const int tr = tile_r(R, sym);
#define TTT_WIDE(TMA)                                                                     \
  return tr == 32    ? launch_wide<T, TMA, 32>(x, y, part, A, I, R, B, splits, k_per_split, \
                                               sym, st, info)                            \
         : tr == 64  ? launch_wide<T, TMA, 64>(x, y, part, A, I, R, B, splits, k_per_split, \
                                               sym, st, info)                            \
                     : launch_wide<T, TMA, TILE>(x, y, part, A, I, R, B, splits,         \
                                                 k_per_split, sym, st, info)
  if (route == ROUTE_TMA) TTT_WIDE(true);
  TTT_WIDE(false);
#undef TTT_WIDE
}

}  // namespace

// sym = 1 promises y == x (a Gram); it takes effect on the R > 16 routes.
// ws: the split-K partial sums (splits x I x R fp32) when the reduction is
// split or the Gram mirrored, and on wgmma_cols u's image after them
// (kernels/ttt.py workspace_bytes).
extern "C" int atucker_ttt(const void* x, const void* y, void* ws, void* z, int A, int I,
                           int R, int B, int dtype, int splits, long long k_per_split, int sym,
                           void* stream) {
  if (A <= 0 || I <= 0 || R <= 0 || B <= 0 || splits <= 0) return cudaErrorInvalidValue;
  const bool mirror = sym && R > 16;
  if (mirror && (R != I || x != y)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool finish = splits > 1 || mirror;
  if ((finish || (R > 16 && B == 1 && !mirror)) && ws == nullptr) return cudaErrorInvalidValue;
  float* part = finish ? static_cast<float*>(ws) : static_cast<float*>(z);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(x, y, part, ws, A, I, R, B, splits, k_per_split, mirror, st);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(x, y, part, ws, A, I, R, B, splits, k_per_split, mirror, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || !finish) return (int)err;
  const long long n = (long long)I * R;
  ttt_finish_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(z), I, R, splits, mirror ? TILE : 0);
  return (int)cudaGetLastError();
}

// Launch figures of a call of these operands and shape, for reports:
// out[0..3] for the contraction kernel, then the finish kernel when it runs
// (registers per thread, threads, resident blocks per SM, grid blocks) --
// at out[4..7], or on wgmma_cols at out[8..11] after the kernel that splits
// y (out[4..7]) -- out[12] the contraction kernel's dynamic shared memory in
// bytes (wide routes) and out[13] the route (0 cols, 1 tile16, 2 wgmma_tma,
// 3 wgmma_plain, 4 wgmma_cols).  x and y are only inspected for alignment.
extern "C" int atucker_ttt_info(const void* x, const void* y, int A, int I, int R, int B,
                                int dtype, int splits, long long k_per_split, int sym,
                                int* out) {
  if (A <= 0 || I <= 0 || R <= 0 || B <= 0 || splits <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  const bool mirror = sym && R > 16;
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(x, y, nullptr, nullptr, A, I, R, B, splits, k_per_split, mirror, 0,
                          out);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(x, y, nullptr, nullptr, A, I, R, B, splits, k_per_split,
                                  mirror, 0, out);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || !(splits > 1 || mirror)) return (int)err;
  return (int)describe(ttt_finish_kernel, 256, ceil_div((long long)I * R, 256),
                       out + (out[13] == ROUTE_WCOLS ? 8 : 4));
}
