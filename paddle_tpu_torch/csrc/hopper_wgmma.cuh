// Hopper's asynchronous building blocks for sm_90a, as inline PTX: TMA
// tensor copies between device and shared memory, mbarriers that count
// the bytes a copy delivers, named barriers, register rebalancing
// between warpgroups, and wgmma (the warpgroup tensor-core product) with
// its shared-memory matrix descriptor.  csrc/hopper_mma.cuh holds the
// warp-level mma.sync blocks; this header builds on its smem_addr.
//
// The tiles these descriptors describe are written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B and a 64-element (128-byte) inner box of a
// 16-bit type (bf16 or f16),
// into shared memory aligned to 1024 bytes: row r of a box lies at
// r * 128 bytes, its eight 16-byte chunks permuted as c -> c ^ (r % 8)
// (address bits 4-6 xor bits 7-9).  The same swizzle is layout type 1
// (128B) of the descriptor:
//   K-major operand (x's [rows, 64 k] box): 8-row core groups 1024
//     bytes apart (SBO), the leading offset unused (16); the k16 step
//     moves the start address 32 bytes along the row.
//   MN-major operand (w's [64 k, 64 n] boxes, n contiguous, read with
//     the transpose-B immediate): a core group is 8 k-rows of 128 bytes,
//     groups 1024 bytes apart (SBO), and the next 64 columns lie in the
//     next box, LBO bytes on; the k16 step moves the start 16 rows =
//     2048 bytes.
//
// wgmma accumulator fragment of m64nNk16 (f32), thread t of the
// warpgroup, warp w = t / 32, lane l: d[4j + 2h + e] is row 16w + l/4 +
// 8h, column 8j + 2(l % 4) + e, for j < N/8 and h, e in {0, 1}.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace hopper {

// --- mbarriers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` more of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed.  A wait that
// never ends (a lost phase) traps after 2^35 clocks (~20 s), so a fault
// in a ring fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// bar.sync on a named barrier (1..15; 0 is __syncthreads) among
// `threads` threads, a multiple of 32
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- TMA ---------------------------------------------------------------

// box at (c0 inner, c1 outer) of a 2-d tensor map -> shared memory; the
// box's bytes (zero-filled past the tensor's edge) complete on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// shared memory -> the box at (c0, c1); elements past the tensor's edge
// are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until every committed store has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- registers -----------------------------------------------------------

// every warp of the warpgroup runs these together
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- wgmma -------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across a
// wgmma fence, commit or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . b for one m64n256k16 tile: T (bf16 or f16) operands from
// shared memory, 128 f32 accumulators a thread; TransB = 1 reads an
// MN-major b.  The two input types differ only in the instruction's type
// suffix (PTT_WGMMA_M64N256K16 spells it out once for each).
#define PTT_WGMMA_M64N256K16(TY) \
  asm volatile(                                                                             \
      "{\n"                                                                                 \
      ".reg .pred p;\n"                                                                     \
      "setp.ne.b32 p, %130, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                                    \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                              \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                                            \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                                            \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                                            \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                                            \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                                            \
      " %56, %57, %58, %59, %60, %61, %62, %63,"                                            \
      " %64, %65, %66, %67, %68, %69, %70, %71,"                                            \
      " %72, %73, %74, %75, %76, %77, %78, %79,"                                            \
      " %80, %81, %82, %83, %84, %85, %86, %87,"                                            \
      " %88, %89, %90, %91, %92, %93, %94, %95,"                                            \
      " %96, %97, %98, %99, %100, %101, %102, %103,"                                        \
      " %104, %105, %106, %107, %108, %109, %110, %111,"                                    \
      " %112, %113, %114, %115, %116, %117, %118, %119,"                                    \
      " %120, %121, %122, %123, %124, %125, %126, %127}, "                                  \
      "%128, %129, p, 1, 1, 0, %131;\n"                                                     \
      "}\n"                                                                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),             \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),       \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),       \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),       \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),       \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),       \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),       \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),       \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),       \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),       \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),     \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
        "+f"(d[126]), "+f"(d[127])                                                          \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB))

template <int TransB, typename T>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  if constexpr (is_f16<T>()) {
    PTT_WGMMA_M64N256K16("f16");
  } else {
    PTT_WGMMA_M64N256K16("bf16");
  }
}

#undef PTT_WGMMA_M64N256K16

}  // namespace hopper
