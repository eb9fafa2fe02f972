// Warp-level tensor-core building blocks for sm_90a, as inline PTX:
// bf16 and f16 mma.sync tiles, ldmatrix, and cp.async copies into shared
// memory.
//
// Fragment layouts of mma.sync.m16n8k16 (row.col, bf16 or f16 in, f32
// out; the two input types share them), for lane l of the warp, g = l / 4
// and t = l % 4:
//   A (16 x 16, 4 regs of 2 halves): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//       a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
//   B (16 x 8, 2 regs): b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
//   C (16 x 8, 4 f32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..).
// The C layout of two n-adjacent 16 x 8 tiles is the A layout of one
// 16 x 16 tile, so a product's result can feed the next product from
// registers (frag_a_from_acc).  ldmatrix.x4 loads four 8 x 8 16-bit
// matrices: lanes 8i..8i+7 give the row addresses of matrix i, and
// register i of lane l holds row g, columns 2t..2t+1 of matrix i (with
// .trans: rows 2t..2t+1, column g, i.e. the matrix read transposed).
// ldmatrix moves 16-bit elements whatever their type.  The templates over
// T (__nv_bfloat16 or __half) pick the input type's pack and product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// row and column, inside its 16 x 8 tile, of element e (0..3) of an
// m16n8 accumulator fragment held by `lane`
__device__ __forceinline__ int acc_row(int lane, int e) {
  return (lane >> 2) + ((e & 2) << 2);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return ((lane & 3) << 1) + (e & 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two f32 -> one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the same for f16
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__host__ __device__ constexpr bool is_f16() {
  static_assert(std::is_same<T, __nv_bfloat16>::value ||
                    std::is_same<T, __half>::value,
                "16-bit inputs: __nv_bfloat16 or __half");
  return std::is_same<T, __half>::value;
}

// two f32 -> one register of two T, rounded to nearest even
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    return pack_f16(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

// one register of two T -> two f32 (lo in .x)
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (is_f16<T>()) {
    return __half22float2(*reinterpret_cast<const __half2*>(&r));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  }
}

// the A fragment (16 x 16) made of two n-adjacent accumulator tiles
// c0 (columns 0-7) and c1 (columns 8-15), rounded to T
template <typename T>
__device__ __forceinline__ void frag_a_from_acc(uint32_t (&a)[4],
                                                const float (&c0)[4],
                                                const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// d += a . b on the tensor cores, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (is_f16<T>()) {
    mma_f16(d, a, b0, b1);
  } else {
    mma_bf16(d, a, b0, b1);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Address that `lane` gives ldmatrix.x4 for a 16 x 16 16-bit block at
// (row0, col0) of a row-major tile with row stride ld (elements), such
// that the four registers come out as:
//   a_operand: the A fragment of the block (a0..a3);
//   b_operand: the B fragments of two n8 tiles of a [n][k] tile (rows n,
//              columns k): r0, r1 for rows row0..+7, r2, r3 for row0+8..;
//   b_trans:   with ldsm_x4_trans, the B fragments of two n8 tiles of a
//              [k][n] tile (rows k, columns n): r0, r1 for columns
//              col0..+7, r2, r3 for col0+8...
__device__ __forceinline__ int a_operand(int lane, int row0, int col0,
                                         int ld) {
  return (row0 + (lane & 15)) * ld + col0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_operand(int lane, int row0, int col0,
                                         int ld) {
  return (row0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 +
         (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int b_trans(int lane, int row0, int col0,
                                       int ld) {
  return (row0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + col0 +
         ((lane >> 4) << 3);
}

// 16 bytes global -> shared, asynchronous, bypassing L1; the bytes past
// src_bytes (0 or 16) are written as zeros and not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, the same way (src_bytes 0 or 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace hopper
