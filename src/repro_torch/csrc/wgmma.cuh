// The tensor-core pieces shared by the kernels that run split-TF32
// products on Hopper's wgmma (ttt.cu's wide route, matmul.cu's wide route):
// the TF32 rounding of the hi/lo split, the 128-byte swizzle that TMA
// writes and wgmma reads, shared-memory matrix descriptors, the wgmma
// fences and the tf32 wgmma itself (A from registers, B from shared
// memory) at widths 32, 64 and 128, the register pins that keep ptxas from
// serializing every wgmma of a kernel (C7520), and the tensor-map encoder.
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
// serialize) the wgmma.
template <int N, bool INIT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
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
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
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
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
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
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
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

}  // namespace atucker
