// The tensor-core pieces shared by the kernels that run split-TF32
// products on Hopper's wgmma (ttt.cu's wide route, and the wide route of
// matmul.cu and ttm.cu): the TF32 rounding of the hi/lo split, the 128-byte
// swizzle that TMA writes and wgmma reads, shared-memory matrix
// descriptors, the wgmma fences and the tf32 wgmma itself (A from
// registers, B from shared memory) at widths 32, 64 and 128, the register
// pins that keep ptxas from serializing every wgmma of a kernel (C7520),
// the tensor-map encoder -- and, in namespace wide, the whole batched
// GEMM C_a = u @ X_a that matmul.cu's boundary modes, ttm.cu's interior
// mode and ttt.cu's B = 1 TTT run at R > 16.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "async.cuh"
#include "common.cuh"

namespace atucker {

// fp32 rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero -- cvt.rna.tf32.f32, less its special case for infinities and
// NaN, which ptxas spends two more instructions a value on: half a TF32
// unit added to the magnitude's bits, the 13 low bits cleared.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// byte offset of element kk (es bytes each) of row `row` in a 1024-byte
// aligned tile of 128-byte rows with the 128-byte swizzle: 16-byte chunk c
// of row r sits at chunk c ^ (r % 8) -- the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with layout type 1
__device__ __forceinline__ int swz(int row, int kk, int es) {
  const int byte = kk * es;
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// wgmma shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (SBO), leading offset unused (1)
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins registers that a wgmma in flight reads or writes: the accumulator,
// so that no read of it moves above the wait, and the A fragments, so that
// ptxas does not reuse their registers before the wait (it would fence the
// wgmma there, and behind a branch serialize every wgmma of the kernel).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[k][q])::"memory");
}

#define WGMMA_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_D16_OPERANDS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WGMMA_D16_OUTPUTS \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
#define WGMMA_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WGMMA_D32_OPERANDS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31])
#define WGMMA_D32_OUTPUTS \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), \
      "=f"(d[31])
#define WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define WGMMA_D64_OPERANDS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_D64_OUTPUTS \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), \
      "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), \
      "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), \
      "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), \
      "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), \
      "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), \
      "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), \
      "=f"(d[61]), "=f"(d[62]), "=f"(d[63])

// d (64 x N, fp32) = A (64 x 8, tf32, registers) * B (N x 8, tf32, K-major
// in shared memory)^T + (INIT ? 0 : d), N = 32, 64 or 128.  a[q] holds
// (row g + 8 (q % 2), column t + 4 (q / 2)) of this warp's 16 rows, g =
// lane / 4, t = lane % 4; d[4c + 2h + e] is (row g + 8 h, column 8 c + 2 t
// + e).  INIT writes d without reading it: the accumulator is never set by
// other instructions, which would make ptxas fence (and, behind a branch,
// serialize) the wgmma.  Otherwise d is added to when `keep` is non-zero
// and overwritten when it is zero (wgmma's scale-d predicate, a run-time
// value: no branch).
template <int N, bool INIT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db, int keep = 1) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_tf32: N is 32, 64 or 128");
  if constexpr (N == 128) {
    if constexpr (INIT)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D64
          ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
          : WGMMA_D64_OUTPUTS
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D64
          ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
          : WGMMA_D64_OPERANDS
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep)
          : "memory");
  } else if constexpr (N == 64) {
    if constexpr (INIT)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGMMA_D32
          ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
          : WGMMA_D32_OUTPUTS
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGMMA_D32
          ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
          : WGMMA_D32_OPERANDS
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep)
          : "memory");
  } else if constexpr (N == 32) {
    if constexpr (INIT)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WGMMA_D16
          ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
          : WGMMA_D16_OUTPUTS
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WGMMA_D16
          ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
          : WGMMA_D16_OPERANDS
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep)
          : "memory");
  }
}

// cuTensorMapEncodeTiled (libcuda), fetched through the runtime's entry-point
// query so that the library links against nothing but cudart
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}


// ---------------------------------------------------------------------------
// The wide route: C_a (R, N) = u (R, K) @ X_a (K, N), fp32 out, for a batch
// of X_a that share u (or, split along K, share X).  matmul.cu runs it with
// one X on the first mode (u @ X) and on the last mode (x @ u^T, X = x^T);
// ttm.cu with X_a = x[a, :, :] of the (A, I, B) view (the interior mode);
// ttt.cu for a TTT of B = 1 (z^T = y^T @ x, split along K).  Bound by the
// bytes of X at the R of the sketch (a few dozen): one pass over X for R <=
// CHUNK (R above runs in chunks of CHUNK outputs), on the tensor cores at
// fp32 accuracy.
//
//   * C_a^T = X_a^T u^T: X_a^T is wgmma's A operand from registers (m64, 64
//     columns of X per consumer warpgroup), u^T its B operand from shared
//     memory.  fp32 operands are split into hi and lo = rna_tf32(v - hi),
//     and every k-step is hi*lo + lo*hi + hi*hi (split TF32); bf16
//     operands are exact in TF32 and take one product.
//   * X comes in one of two layouts.  KN: X_a (K, N) row-major, N
//     contiguous (the first and the interior mode): a stage of X is TK rows
//     of k, each 128-byte box holding 128 / sizeof(T) columns.  NK: x (N,
//     K) row-major, K contiguous (the last mode, X = x^T): a stage is BNT
//     rows of n, each TK values of k long (128 bytes fp32 with the 128-byte
//     swizzle, 64 bytes bf16 with the 64-byte swizzle), one box a stage.
//     Either way a thread reads its fragment from the landed tile; the
//     k-order within a k-step (image_k, or none on NK) keeps the 32 lanes'
//     reads in distinct banks.
//   * The sums.  The tensor cores' fp32 accumulator rounds toward zero, so
//     a sum kept there drifts low whenever it is inexact: summing each
//     32-deep stage of split-TF32 products in it biased the energy of C by
//     about -2e-7 of itself, which lifted the rank-adaptive sketch's
//     certificate.  So hi is cut to a grid on which a stage's hi*hi sum is
//     exact.  Per stage (32 k), u's hi is its row's value rounded to a
//     multiple of 2^(e - 11), where 2^e bounds the row's 32 magnitudes in
//     the stage (11 bits, which a TF32 holds), and X's hi is its column's
//     rounded to 2^(e - 10).  A product is then a whole number of units
//     (under 2^21), and a stage's 32 products sum exactly while the sum
//     stays under 2^24 units: always for signed data; past it (products of
//     one sign near both bounds) the sum is cut by less than one unit in
//     2^23, toward zero, the safe side.  A stage's hi*hi sums run in one
//     accumulator from zero and are added to the fp32 sum (one FADD a
//     stage, rounding to nearest); the cross terms hi*lo + lo*hi, 2^-10 of
//     the products, run in a second accumulator over the whole tile, where
//     truncation moves the energy by ~1e-10.  lo holds the rest of v to
//     2^-22 of its group's bound, as the plain split holds each value.  No
//     constant is fitted to the card: the emulation, kernels/ref.py
//     matmul_tf32x3_ref(scheme="grid"), reads the energy within 5e-9 on
//     signed, non-negative and integer data where the stage sums read
//     -2e-7.  bf16 operands take one product a k-step, summed a stage at a
//     time; those sums may truncate, which only lowers the energy.  A
//     warpgroup computes at most 64 outputs: R <= 64 has the two
//     warpgroups take 64 columns of a 128-column tile each; 64 < R <= 128
//     has them share a 64-column tile and take half of R each.
//   * X arrives by TMA (a 3-D map, 128-byte swizzle -- 64-byte for bf16 on
//     NK -- zero fill for a ragged K or N) into a ring of stages kept full
//     by one producer thread, when the caller asks for it (rows of X a
//     16-byte multiple, X aligned); otherwise the producer warpgroup loads X
//     with plain loads into the same layout.
//   * u is split once per call by a small kernel into a pre-split image in
//     the caller's workspace: per stage, the hi and lo tiles in the swizzled
//     K-major layout wgmma reads, zero beyond R and K, copied into the ring
//     stage by one bulk copy beside X's boxes.  u is read through strides:
//     (K, 1) for u (R, K), (1, R) for u^T (K, R) as the last mode and the
//     TTT hold it.
//   * The tiles run over the batch's columns laid end to end, nv columns an
//     item: on KN with TMA nv is N rounded up to whole 128-byte boxes, so
//     that no box straddles two items (B = 264 fp32 fills 264 of 288
//     columns); with plain loads nv = N, so a small N packs densely; on NK,
//     and whenever the items split K, nv is N rounded up to whole tiles.
//     A persistent block per SM walks the tiles, so the ring runs ahead
//     across tiles; the sums go straight from registers to C (element (r,
//     n) of C_a at c + a c_batch + r ldr + n ldn).
//   * Split along K (k_item > 0): item a is the same X over k in [a k_item,
//     (a + 1) k_item) and the same columns, with u's image stages from a
//     k_item / TK on; C_a holds its partial sums, which the caller adds.
namespace wide {

// Bits of u's and X's hi parts over their group's bound (see above): a
// product holds U_BITS + X_BITS, a stage's sum five more
constexpr int U_BITS = 11, X_BITS = 10;

// 1.5 * 2^(e - bits + 23) for a group whose magnitudes are at most m < 2^e:
// fl(v + s) - s is v rounded to nearest (even) on the grid 2^(e - bits)
__device__ __forceinline__ float grid_shift(float m, int bits) {
  int e = (int)((__float_as_uint(m) >> 23) & 0xffu) + 24 - bits;
  e = e > 254 ? 254 : e;  // |v| >= 2^113: a coarser grid, still exact sums
  return __uint_as_float(((uint32_t)e << 23) | 0x400000u);
}
__device__ __forceinline__ float on_grid(float v, float s) {
  return __fsub_rn(__fadd_rn(v, s), s);
}

constexpr int CHUNK = 128;           // outputs per pass over X
constexpr int TK = 32;               // k rows per stage
constexpr int KS = TK / 8;           // wgmma k-steps per stage
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block can use

// Geometry of a launch: NT outputs per consumer warpgroup (the wgmma width,
// 32 or 64), SPLIT when the two warpgroups share a tile and split R, NK for
// x (N, K) K-major (else X (K, N)).
template <typename T, int NT, bool SPLIT, bool NK>
struct Geo {
  static constexpr int ES = sizeof(T);
  static constexpr int BOX_N = 128 / ES;               // KN: X columns per box
  static constexpr int PLANES = ES == 4 ? 2 : 1;       // hi, lo (fp32)
  static constexpr int BNT = SPLIT ? 64 : 128;         // X columns per tile
  static constexpr int ROWS = SPLIT ? 2 * NT : NT;     // rows of u's image
  static constexpr int XBYTES = BNT * TK * ES;         // one X tile
  static constexpr int BBYTES = PLANES * ROWS * 128;   // one image stage
  static constexpr int STAGE = XBYTES + BBYTES;
};

// byte offset of x (n, kk) in an NK tile: rows of TK values, 128-byte
// swizzle for fp32 (chunk c of row n at c ^ (n % 8)), 64-byte for bf16
// (chunk c of row n at c ^ (n / 2 % 4)): the address functions TMA writes
template <int ES>
__device__ __forceinline__ int nk_off(int n, int kk) {
  if constexpr (ES == 4) return swz(n, kk, 4);
  const int byte = kk * 2;
  return n * 64 + ((((byte >> 4) ^ (n >> 1)) & 3) << 4) + (byte & 15);
}

struct Args {
  const void* x;       // X_0 (KN) or x (NK); X_a starts x_batch elements on
  const void* img;     // u's pre-split image: n_k stages of BBYTES (an item's)
  float* c;            // C_0: element (r, n) at r * ldr + n * ldn
  long long x_batch, c_batch;
  int tiles;           // ceil(batch * nv / BNT); batch * nv < 2^31 (launch_chunk)
  int rows, N, K, ldr, ldn, batch;
  int nv;              // columns of the tiles per batch item
  int n_k;             // stages an item: ceil(K / TK), or k_item / TK
  int k_item;          // split along K: the depth of an item (0: items are X_a)
  int tma;             // X by TMA, else plain loads
  int nst;             // ring stages
};

// Physical k (within a stage) of column `col` of u's image: on KN the 8
// columns of k-step j hold rows 8j + 2t + h at column 8j + t + 4h; on NK
// column col holds k = col.
template <bool NK>
__device__ __forceinline__ int image_k(int col) {
  if constexpr (NK) return col;
  const int cc = col % 8;
  return col - cc + 2 * (cc % 4) + cc / 4;
}

// u (rows, K), element (r, k) at u[r * su_r + k * su_k] -> its image: stage
// s, plane p (hi, lo), row r, column col at s * BBYTES + p * ROWS * 128 +
// swz(r, col, 4), zero beyond rows and K.  A warp takes one row of one
// stage (TK = 32 columns), whose largest magnitude sets the grid of the
// row's hi there.
template <typename T, int ROWS, int PLANES, bool NK>
__global__ void __launch_bounds__(256)
image_kernel(const T* __restrict__ u, unsigned char* __restrict__ img, int rows, int K, int n_k,
             long long su_r, long long su_k) {
  static_assert(TK == 32, "image_kernel: a warp is one stage of a row");
  const long long n = (long long)n_k * ROWS * TK;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;  // n is whole warps
  const int s = (int)(idx / (ROWS * TK));
  const int r = (int)(idx / TK % ROWS), col = (int)(idx % TK);
  const long long k = (long long)s * TK + image_k<NK>(col);
  const float v = r < rows && k < K ? to_f32(u[r * su_r + k * su_k]) : 0.f;
  unsigned char* st = img + (long long)s * PLANES * ROWS * 128;
  if constexpr (PLANES == 2) {
    float m = fabsf(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float hi = on_grid(v, grid_shift(m, U_BITS));
    *reinterpret_cast<float*>(st + swz(r, col, 4)) = hi;
    *reinterpret_cast<float*>(st + ROWS * 128 + swz(r, col, 4)) = tf32_rna(v - hi);
  } else {
    *reinterpret_cast<float*>(st + swz(r, col, 4)) = v;  // bf16 is exact in TF32
  }
}

// Byte offset (from the lane's off[q]) of element q of k-step ks of the A
// fragment: KN a k-step is 8 rows of k, 1024 bytes further on; NK it is the
// next 8 values of the row, whose 16-byte chunk the swizzle moves (xo: the
// lane's row bits of the swizzle, << 4)
template <int ES, bool NK>
__device__ __forceinline__ int frag_step(int ks, int q, int xo) {
  if constexpr (!NK) return 1024 * ks;
  if constexpr (ES == 4) return ((2 * ks + q / 2) << 4) ^ xo;
  return (ks << 4) ^ xo;
}

// This warpgroup's A fragments of one stage: element q of k-step ks of its
// 64 columns of the X tile at `st`, read at off[q] + frag_step(ks, q) and
// split in registers (the caller keeps `ahi`/`alo` until the wgmma that
// read them are waited for).  A column's 32 values of the stage lie with
// the four lanes of a quad (two a k-step each), which agree on its grid.
template <typename T, int PLANES, bool NK>
__device__ __forceinline__ void stage_fragments(uint32_t (&ahi)[KS][4], uint32_t (&alo)[KS][4],
                                                const unsigned char* st, const int (&off)[4],
                                                int xo) {
  float v[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[ks][q] = to_f32(
          *reinterpret_cast<const T*>(st + off[q] + frag_step<(int)sizeof(T), NK>(ks, q, xo)));
  if constexpr (PLANES == 2) {
    float m[2] = {0.f, 0.f};  // this lane's two columns: q % 2
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) m[q % 2] = fmaxf(m[q % 2], fabsf(v[ks][q]));
    float sh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      sh[h] = grid_shift(m[h], X_BITS);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float h = on_grid(v[ks][q], sh[q % 2]);
        ahi[ks][q] = __float_as_uint(h);
        alo[ks][q] = __float_as_uint(tf32_rna(v[ks][q] - h));
      }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) ahi[ks][q] = __float_as_uint(v[ks][q]);
  }
}

// The products of one stage for this warpgroup, launched and committed:
// `hh` = the stage's hi*hi from zero, `cross` += hi*lo + lo*hi (from zero
// when `keep` is 0, at a tile's first stage); bf16 has hh alone.
template <int NT, int PLANES>
__device__ __forceinline__ void stage_products(float (&hh)[NT / 2], float (&cross)[NT / 2],
                                               const uint32_t (&ahi)[KS][4],
                                               const uint32_t (&alo)[KS][4],
                                               const unsigned char* bimg, int rows_img, int keep) {
  wgmma_fence();
  // 32-byte k-steps advance the descriptors' 16-byte address field by 2
  const uint64_t bh = sw128_desc(bimg);
  const uint64_t bl = sw128_desc(bimg + rows_img * 128);
  if constexpr (PLANES == 2) {
    wgmma_tf32<NT, false>(cross, ahi[0], bl, keep);
    wgmma_tf32<NT, false>(cross, alo[0], bh);
  }
  wgmma_tf32<NT, true>(hh, ahi[0], bh);
#pragma unroll
  for (int j = 1; j < KS; ++j) {
    if constexpr (PLANES == 2) {
      wgmma_tf32<NT, false>(cross, ahi[j], bl + 2 * j);
      wgmma_tf32<NT, false>(cross, alo[j], bh + 2 * j);
    }
    wgmma_tf32<NT, false>(hh, ahi[j], bh + 2 * j);
  }
  wgmma_commit();
}

// Shared memory (1024-byte aligned): nst stages of (X tile; u's image
// stage), then the mbarriers.  Warpgroup 2 feeds the ring and gives its
// registers to the two consumer warpgroups (setmaxnreg).
template <typename T, int NT, bool SPLIT, bool NK>
__global__ void __launch_bounds__(THREADS, 1)
kernel(__grid_constant__ const CUtensorMap mx, Args p) {
  using G = Geo<T, NT, SPLIT, NK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.nst * G::STAGE);
  uint64_t* empty = full + p.nst;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int img_item = p.k_item / TK;  // image stages an item moves on

  // plain loads of fp32 go by cp.async, each of the 128 producer threads
  // arriving when its copies of a stage have landed; bf16 (2-byte
  // elements, which cp.async does not copy) by loads and stores, each warp
  // arriving after its stores
  constexpr bool ASYNC = sizeof(T) == 4;
  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      // TMA: the producer's expect_tx; plain: that and the loads' arrivals
      mbar_init(&full[s], p.tma ? 1 : ASYNC ? 129 : 5);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // 56 registers: the producer's tile and stage bookkeeping fits without
    // spilling (at 40 it spilled 24-32 bytes); the consumers keep 224
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;" ::: "memory");
    const unsigned char* img = static_cast<const unsigned char*>(p.img);
    const int pt = tid - CONSUMERS;  // 0 .. 127
    if (p.tma && pt != 0) return;
    // plain loads, KN: thread pt fills column pt % BNT of the tile, rows pt /
    // BNT + STEP q; consecutive threads read consecutive columns of a row.
    // NK: lane l of warp w fills k = l of tile rows w + 4 q; consecutive
    // threads read consecutive k of a row.
    constexpr int STEP = NK ? 4 : 128 / G::BNT;
    constexpr int PER = NK ? G::BNT / STEP : TK / STEP, BATCH = 8;
    const int col = NK ? pt / 32 : pt % G::BNT;
    const int kk0 = NK ? pt % 32 : pt / G::BNT;
    int it = 0;
    // column j of the batch laid end to end is column j % nv of item j / nv
    // (32-bit: a 64-bit division is a called routine, which spills)
    const unsigned nv = (unsigned)p.nv;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const unsigned j0 = (unsigned)tile * G::BNT;
      const unsigned a0 = j0 / nv, n0 = j0 - a0 * nv;  // the tile's first column
      const int kb = (int)a0 * p.k_item;               // its item's first k (split K)
      const int ta = p.k_item ? 0 : (int)a0;           // its item in the map
      const unsigned char* img0 = img + (long long)a0 * img_item * G::BBYTES;
      const T* __restrict__ src = nullptr;  // this thread's column (KN) or rows (NK) of X
      if (!p.tma) {
        if constexpr (NK) {
          src = static_cast<const T*>(p.x) + a0 * p.x_batch + (long long)(n0 + col) * p.K + kb;
        } else {
          const unsigned j = j0 + col, a = j / nv, n = j - a * nv;
          if ((int)a < p.batch && (int)n < p.N)
            src = static_cast<const T*>(p.x) + a * p.x_batch + (long long)(a * p.k_item) * p.N + n;
        }
      }
      for (int s = 0; s < p.n_k; ++s, ++it) {
        const int slot = it % p.nst;
        unsigned char* st = smem + slot * G::STAGE;
        mbar_wait(&empty[slot], (uint32_t)(((it / p.nst) & 1) ^ 1));
        if (p.tma) {
          mbar_arrive_tx(&full[slot], G::STAGE);
          if constexpr (NK) {
            tma_load_3d(st, &mx, kb + s * TK, (int)n0, ta, &full[slot]);
          } else {
            // boxes never straddle two items: nv is a whole number of boxes
            unsigned a = a0, n = n0;
#pragma unroll
            for (int b = 0; b < G::BNT / G::BOX_N; ++b) {
              tma_load_3d(st + b * TK * 128, &mx, (int)n, kb + s * TK, p.k_item ? 0 : (int)a,
                          &full[slot]);
              n += G::BOX_N;
              if (n == nv) n = 0, ++a;
            }
          }
          bulk_copy(st + G::XBYTES, img0 + (long long)s * G::BBYTES, G::BBYTES, &full[slot]);
          continue;
        }
        if (pt == 0) {
          mbar_arrive_tx(&full[slot], G::BBYTES);
          bulk_copy(st + G::XBYTES, img0 + (long long)s * G::BBYTES, G::BBYTES, &full[slot]);
        }
        if constexpr (ASYNC) {
          // nothing waits here: the ring's stages stay in flight
#pragma unroll 8
          for (int q = 0; q < PER; ++q) {
            if constexpr (NK) {
              const int n = (int)n0 + col + STEP * q, k = kb + s * TK + kk0;
              const bool ok = n < p.N && k < p.K;
              cp_async_4(st + nk_off<G::ES>(col + STEP * q, kk0),
                         ok ? static_cast<const void*>(src + (long long)STEP * q * p.K + s * TK + kk0)
                            : p.x,
                         ok);
            } else {
              const int k = kb + s * TK + kk0 + STEP * q;
              const bool ok = src != nullptr && k < p.K;
              cp_async_4(st + (col / G::BOX_N) * TK * 128 + swz(kk0 + STEP * q, col % G::BOX_N, 4),
                         ok ? static_cast<const void*>(src + (long long)(k - kb) * p.N) : p.x,
                         ok);
            }
          }
          cp_async_arrive(&full[slot]);
          continue;
        }
        for (int q0 = 0; q0 < PER; q0 += BATCH) {
          T v[BATCH];
#pragma unroll
          for (int q = 0; q < BATCH; ++q) {
            if constexpr (NK) {
              const int n = (int)n0 + col + STEP * (q0 + q), k = kb + s * TK + kk0;
              v[q] = n < p.N && k < p.K ? src[(long long)STEP * (q0 + q) * p.K + s * TK + kk0]
                                        : T(0.f);
            } else {
              const int k = kb + s * TK + kk0 + STEP * (q0 + q);
              v[q] = src != nullptr && k < p.K ? src[(long long)(k - kb) * p.N] : T(0.f);
            }
          }
#pragma unroll
          for (int q = 0; q < BATCH; ++q) {
            if constexpr (NK)
              *reinterpret_cast<T*>(st + nk_off<G::ES>(col + STEP * (q0 + q), kk0)) = v[q];
            else
              *reinterpret_cast<T*>(st + (col / G::BOX_N) * TK * 128 +
                                    swz(kk0 + STEP * (q0 + q), col % G::BOX_N, G::ES)) = v[q];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[slot]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;" ::: "memory");

  // ---- consumers ----
  const int nb = SPLIT ? 0 : wg * 64;   // this warpgroup's first column of the tile
  const int rb = SPLIT ? wg * NT : 0;   // its first output (row of u's image)
  const int g = lane / 4, t = lane % 4;
  // A element q of k-step ks: tile column nn = nb + 16 warp + g + 8 (q % 2).
  // KN: X row 8 ks + 2 t + q / 2 of the stage (image_k's permutation).  NK:
  // k 8 ks + t + 4 (q / 2) of row nn, its chunk moved by the swizzle (xo).
  int off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int nn = nb + 16 * warp + g + 8 * (q % 2);
    if constexpr (NK)
      off[q] = G::ES == 4 ? nn * 128 + 4 * t : nn * 64 + 2 * t + 8 * (q / 2);
    else
      off[q] = (nn / G::BOX_N) * TK * 128 + swz(2 * t + q / 2, nn % G::BOX_N, G::ES);
  }
  const int xo = NK ? (G::ES == 4 ? g : g >> 1) << 4 : 0;
  // The stages of this block's tiles in order: it = (tile's index among
  // them) * n_k + s.  While the products of stage `it` run, the fragments
  // of stage it + 1 are read and split (nhi/nlo), off the tensor cores'
  // critical path, and moved into ahi/alo after the wait.  cross is first
  // written by a wgmma with keep = 0 (a tile's first stage).
  float hh[NT / 2], cross[NT / 2], sum[NT / 2];
  uint32_t ahi[KS][4], alo[KS][4], nhi[KS][4], nlo[KS][4];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) sum[i] = 0.f;
  const long long total = (long long)((p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.n_k;
  const unsigned nv = (unsigned)p.nv;
  mbar_wait(&full[0], 0u);
  stage_fragments<T, G::PLANES, NK>(ahi, alo, smem, off, xo);
  int tile = blockIdx.x;
  int s = 0, slot = 0;
  uint32_t phase = 0;  // of the ring's pass over `slot`
  for (long long it = 0; it < total; ++it) {
    stage_products<NT, G::PLANES>(hh, cross, ahi, alo, smem + slot * G::STAGE + G::XBYTES + rb * 128,
                                  G::ROWS, s != 0);
    const int next = slot + 1 == p.nst ? 0 : slot + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1u : phase;
    if (it + 1 < total) {
      mbar_wait(&full[next], next_phase);
      stage_fragments<T, G::PLANES, NK>(nhi, nlo, smem + next * G::STAGE, off, xo);
    }
    wgmma_wait_all();
    fence_acc(hh);
    if constexpr (G::PLANES == 2) fence_acc(cross);
    fence_frags(ahi);
    if constexpr (G::PLANES == 2) fence_frags(alo);
    if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sum[i] += hh[i];
    if (s == p.n_k - 1) {
      if constexpr (G::PLANES == 2) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) sum[i] += cross[i];
      }
      // sum[4c + 2h + e] is C[rb + 8c + 2t + e] at tile column nb + 16 warp + g + 8h
      float* cp[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned j = (unsigned)tile * G::BNT + nb + 16 * warp + g + 8 * h, a = j / nv,
                       n = j - a * nv;
        cp[h] = (int)a < p.batch && (int)n < p.N ? p.c + a * p.c_batch + (long long)n * p.ldn
                                                 : nullptr;
      }
#pragma unroll
      for (int v = 0; v < NT / 2; ++v) {
        const int r = rb + 8 * (v / 4) + 2 * t + v % 2;
        float* q = cp[(v / 2) % 2];
        if (q != nullptr && r < p.rows) q[(long long)r * p.ldr] = sum[v];
        sum[v] = 0.f;
      }
      tile += gridDim.x;
    }
    s = s + 1 == p.n_k ? 0 : s + 1;
    slot = next;
    phase = next_phase;
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ahi[k][q] = nhi[k][q];
        if constexpr (G::PLANES == 2) alo[k][q] = nlo[k][q];
      }
  }
}

// 3-D map over X: KN dims (N, K, batch), boxes of 128 bytes x TK rows;
// NK dims (K, N, batch), boxes of TK values x BNT rows.  128-byte swizzle
// (64-byte for bf16 on NK: its rows are 64 bytes), zero fill outside.
template <typename T, bool NK>
cudaError_t encode_x(CUtensorMap* map, const void* x, int N, int K, int batch,
                     long long x_batch, int bnt) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  constexpr int ES = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)(NK ? K : N), (cuuint64_t)(NK ? N : K),
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(NK ? K : N) * ES, (cuuint64_t)x_batch * ES};
  const cuuint32_t box[3] = {(cuuint32_t)(NK ? TK : 128 / ES), (cuuint32_t)(NK ? bnt : TK), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      NK && ES == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = enc(map,
                         ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, const_cast<void*>(x), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The operands of one call: u (R, K), element (r, k) at u + r su_r + k su_k;
// X_a at x + a x_batch: (K, N) row-major, or (N, K) with nk; C_a at c + a
// c_batch, element (r, n) at r ldr + n ldn; k_item > 0 (a multiple of TK):
// split along K, item a covering k in [a k_item, (a + 1) k_item) of the one
// X (x_batch unused); tma: X by TMA (rows a 16-byte multiple and X aligned,
// which the caller checks).
struct Call {
  const void* u;
  const void* x;
  float* c;
  void* ws;
  int R, N, K, batch;
  long long x_batch, c_batch, ldr, ldn, su_r, su_k;
  int k_item;
  bool tma, nk;
};

// Stages of u's image the call needs (an item's, or all items' when split
// along K)
inline long long image_stages(const Call& q) {
  return q.k_item ? (long long)q.batch * (q.k_item / TK) : ceil_div(q.K, TK);
}

// One chunk of at most CHUNK outputs (rows of u from r0).  info != nullptr:
// report the launch figures (out[0..3] the GEMM, out[4..7] the image
// kernel, out[12] dynamic shared memory, out[14] 1 for TMA loads plus 2 for
// the NK layout, out[15] ring stages) instead of launching.
template <typename T, int NT, bool SPLIT, bool NK>
cudaError_t launch_chunk(const Call& q, int r0, int rows, cudaStream_t st, int* info) {
  using G = Geo<T, NT, SPLIT, NK>;
  Args p;
  p.x = q.x;
  p.img = q.ws;
  p.c = q.c == nullptr ? nullptr : q.c + r0 * q.ldr;
  p.x_batch = q.k_item ? 0 : q.x_batch;  // split along K: one X
  p.c_batch = q.c_batch;
  p.rows = rows;
  p.N = q.N;
  p.K = q.K;
  p.ldr = (int)q.ldr;
  p.ldn = (int)q.ldn;
  p.tma = q.tma;
  p.k_item = q.k_item;
  if (q.ldr != p.ldr || q.ldn != p.ldn || (q.k_item % TK) != 0) return cudaErrorInvalidValue;
  p.nv = NK || q.k_item ? ceil_div(q.N, G::BNT) * G::BNT
                        : q.tma ? ceil_div(q.N, G::BOX_N) * G::BOX_N : q.N;
  // the kernel indexes the batch's columns in 32 bits: items run in groups
  // of fewer than 2^31 - BNT columns (one item wider than that is refused;
  // so is a split along K that does not fit one group)
  const int per = p.nv > 0 ? (0x7fffffff - G::BNT) / p.nv : 0;
  if (per < 1 || (q.k_item && q.batch > per)) return cudaErrorInvalidValue;
  p.batch = q.batch < per ? q.batch : per;
  p.tiles = ceil_div(p.batch * p.nv, G::BNT);
  p.n_k = q.k_item ? q.k_item / TK : ceil_div(q.K, TK);
  p.nst = (SMEM_LIMIT - 1024 - 2 * MAX_STAGES * (int)sizeof(uint64_t)) / G::STAGE;
  if (p.nst > MAX_STAGES) p.nst = MAX_STAGES;
  if (p.nst < 2) return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)p.nst * G::STAGE + 2 * p.nst * sizeof(uint64_t);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = (int)(p.tiles < sms ? p.tiles : sms);
  auto gemm = kernel<T, NT, SPLIT, NK>;
  auto image = image_kernel<T, G::ROWS, G::PLANES, NK>;
  err = cudaFuncSetAttribute(gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long img_elems = image_stages(q) * G::ROWS * TK;
  if (info != nullptr) {
    info[12] = (int)smem;
    info[14] = p.tma | (NK ? 2 : 0);
    info[15] = p.nst;
    err = describe(gemm, THREADS, grid, info, smem);
    if (err != cudaSuccess) return err;
    return describe(image, 256, ceil_div(img_elems, 256), info + 4);
  }
  image<<<ceil_div(img_elems, 256), 256, 0, st>>>(
      static_cast<const T*>(q.u) + r0 * q.su_r, static_cast<unsigned char*>(q.ws), rows, q.K,
      (int)image_stages(q), q.su_r, q.su_k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* const c0 = p.c;
  for (int a0 = 0; a0 < q.batch; a0 += per) {
    p.batch = q.batch - a0 < per ? q.batch - a0 : per;
    p.tiles = ceil_div(p.batch * p.nv, G::BNT);
    p.x = static_cast<const T*>(q.x) + a0 * q.x_batch;
    p.c = c0 == nullptr ? nullptr : c0 + a0 * q.c_batch;
    CUtensorMap mx{};
    if (p.tma && (err = encode_x<T, NK>(&mx, p.x, q.N, q.K, q.k_item ? 1 : p.batch, q.x_batch,
                                        G::BNT)) != cudaSuccess)
      return err;
    gemm<<<p.tiles < grid ? p.tiles : grid, THREADS, smem, st>>>(mx, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Rows of u's image for a chunk of `rows` outputs (mirrored in
// kernels/matmul.py image_rows): the wgmma width, or 2 x 64 when the two
// warpgroups split R
inline int image_rows(int rows) { return rows <= 32 ? 32 : rows <= 64 ? 64 : 128; }

// Bytes of u's image for a call (the first, largest chunk's)
template <typename T>
long long image_bytes(const Call& q) {
  return image_stages(q) * (sizeof(T) == 4 ? 2 : 1) * image_rows(q.R < CHUNK ? q.R : CHUNK) * 128;
}

// The whole call, chunk by chunk (the image workspace holds one chunk's);
// with info, the first chunk's figures.
template <typename T, bool NK>
cudaError_t launch_layout(const Call& q, cudaStream_t st, int* info) {
  for (int r0 = 0; r0 < q.R; r0 += CHUNK) {
    const int rows = q.R - r0 < CHUNK ? q.R - r0 : CHUNK;
    cudaError_t err;
    if (rows <= 32)
      err = launch_chunk<T, 32, false, NK>(q, r0, rows, st, info);
    else if (rows <= 64)
      err = launch_chunk<T, 64, false, NK>(q, r0, rows, st, info);
    else
      err = launch_chunk<T, 64, true, NK>(q, r0, rows, st, info);
    if (err != cudaSuccess || info != nullptr) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Call& q, cudaStream_t st, int* info) {
  return q.nk ? launch_layout<T, true>(q, st, info) : launch_layout<T, false>(q, st, info);
}

}  // namespace wide

}  // namespace atucker
