// PTX helpers for 16-bit tensor-core kernels on sm_90a, shared by the
// attention kernels (attention_kernels.cuh) and the WOQ prefill GEMM
// (woq_gemm.cu): cp.async copies into shared memory, ldmatrix, the
// mma.sync.m16n8k16 product with fp32 accumulators, fp32 -> 16-bit packing,
// and the lane addresses ldmatrix takes for A and B tiles. Each source
// includes this header once, into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, or 16 zero bytes (nothing
// read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 16-bit matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i holds matrix i in the mma's fragment
// layout (row lane / 4, columns 2 (lane % 4) and + 1), transposed by .trans.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8, fp32) += a (16x16, row) . b (16x8, col)
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats rounded to T (nearest even) and packed, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// The A fragments of a 16x16 product taken from two C fragments (columns
// 8i..8i+7 and 8i+8..8i+15 of the same 16 rows), rounded to T.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Lane addresses for ldmatrix.x4 over a tile with rows LD elements apart:
//   a_at:   the A fragment of rows r0..r0+15, columns k0..k0+15 (row-major A)
//   bn_at:  the B fragments of two 8-column tiles n0, n0+8 at depth k0..k0+15,
//           B stored [n][k] (registers 0-1: tile n0, 2-3: tile n0+8)
//   bk_at:  the same with B stored [k][n], for ldsm_x4_t
template <int LD, typename T>
__device__ __forceinline__ const T* a_at(const T* base, int r0, int k0, int lane) {
  return base + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8;
}
template <int LD, typename T>
__device__ __forceinline__ const T* bn_at(const T* base, int n0, int k0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}
template <int LD, typename T>
__device__ __forceinline__ const T* bk_at(const T* base, int k0, int n0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

}  // namespace
