// Fused matmul + bias + GELU for Hopper (sm_90a): the forward and the
// recompute backward, f32 accumulation, in two designs chosen by dtype
// and shape.
//
// Replaces the TPU kernels of paddle_tpu/ops/fused_gelu_linear.py:
//   ptt_linear_gelu_fwd <- _fwd_kernel (:72)
//   ptt_linear_gelu_bwd <- _bwd_kernel (:84)
// Same functions over row-major x [M, K], w [K, N], an optional f32 bias
// b [N] and (backward) dy [M, N]:
//   forward : y  = gelu(x @ w + b)
//   backward: dz = dy * gelu'(x @ w + b)
// with x @ w accumulated in f32 inside the kernel, bias and GELU (tanh
// form, or erf form with approximate = 0) applied to the f32
// accumulator in the epilogue, and the output in x's dtype (f32, bf16
// or f16).  The backward recomputes z = x @ w + b rather than reading a
// saved [M, N] pre-activation: the reference's design point, kept.  The
// other backward products (dx = dz @ w^T, dw = x^T @ dz, db = sum dz)
// stay outside, as the reference leaves them to XLA.
//
// Bound: at BERT-base's MLP shape (M 8192, K 768, N 3072, bf16) each
// kernel does 2*M*N*K = 38.7 GFLOP, 39.1 us at the bf16 tensor-core peak
// of 989 TFLOP/s, against 20.2 us (forward, 67.6 MB) or 35.2 us
// (backward, 117.9 MB) of bytes: bound by operations, so the products
// belong on the tensor cores.
//
// Routing, decided by the caller before the launch (the `tensor_cores`
// argument; the Python wrapper's tensor_core_route) and checked here:
//   * bf16 or f16 with K % 8 == 0, N % 8 == 0 and 16-byte-aligned x, w
//     and y (every row then starts on 16 bytes, as TMA requires) takes
//     the tensor-core kernel, linear_gelu_wgmma (the wgmma and the TMA
//     maps take the input type: .bf16 or .f16);
//   * f32 takes the SIMT kernel, linear_gelu: TF32 would change f32's
//     numbers, and the port keeps TF32 off;
//   * bf16 or f16 whose rows are not 16-byte aligned (K or N not a
//     multiple of 8) takes the SIMT kernel too.
// This is a choice by dtype and shape, not a fallback: a launch that
// fails, or arguments the chosen kernel does not take, return an error.
//
// Tensor-core design (linear_gelu_wgmma): wgmma fed by TMA in a
// persistent, warp-specialised kernel.  One 384-thread block (three
// warpgroups) an SM, 209 KB of shared memory; block i computes the
// 128 x 256 output tiles i, i + gridDim.x, ... (768 tiles, 5.8 a block,
// at the main shape), tiles along N first so that neighbouring blocks
// share x's rows in L2.
//   * K is walked in 64-deep slices through a 3-stage shared-memory
//     ring with a "full" and an "empty" mbarrier per stage; the ring
//     runs on across tiles, so the next tile's slices load while the
//     consumers finish the last one's epilogue.
//   * Warpgroup 0 is the producer: it gives up registers (setmaxnreg 40)
//     and one thread issues, per slice, the TMA load of x's [128, 64]
//     box (K-major) and four of w's [64 k, 64 n] boxes.  w is [K, N]
//     row-major, i.e. MN-major: wgmma reads it through its transpose-B
//     immediate, so w is never transposed in memory.  Both maps use the
//     128-byte swizzle that the wgmma descriptors name
//     (csrc/hopper_wgmma.cuh); TMA zero-fills boxes past M, N or K, so
//     the main loop has no masks.  In the backward it also loads each
//     tile's dy [128, 256] into a tile buffer of its own, once the
//     previous tile's result has left it ("y_free").
//   * Warpgroups 1 and 2 are the consumers (setmaxnreg 232): each runs
//     four wgmma.m64n256k16 per slice over its 64 rows, 128 f32
//     accumulators a thread (written by wgmma alone: a tile's first
//     product scales them by 0; a plain move into them would serialise
//     the products), keeps one wgmma group in flight and frees the
//     previous slice's stage.
//   * Epilogue: bias and GELU, or dy * GELU' (dy read from the tile
//     buffer at the fragment's positions as 16-bit pairs), on the
//     accumulator fragment; the 16-bit result goes to the tile buffer in
//     the same 128-byte swizzle (over dy, element for element) and out
//     by TMA stores, which clip rows past M and columns past N.  The
//     GELU form is a template argument, so the epilogue carries one of
//     the two (a choice at run time inside it evaluates both for every
//     element); the tanh form is computed by its identity z *
//     sigmoid(2u) (gelu_tc below).
// No atomics: a second launch repeats the first bit for bit.
//
// SIMT design (linear_gelu), f32 and unaligned 16-bit: the classic shared-
// memory SGEMM.  One 256-thread block per 128 x 128 output tile; the K
// axis, which the TPU kernel walked as a sequential grid axis with an
// f32 VMEM accumulator, is a loop in the block over 16-deep slices: x's
// 128 x 16 slice is stored transposed (As[k][m], rows padded by 4 floats
// against bank conflicts on the transposing store) and w's 16 x 128
// slice as it is (Bs[k][n]), both converted to f32.  A thread owns an
// 8 x 8 block of accumulators in registers: rows ty*4 + {0..3} and 64 +
// ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}, read as
// float4s from shared memory.  Loads are scalar and bounds-checked (zero
// beyond M, N or K), so any M, N, K >= 1 work and the ragged edge is
// masked in the kernel; the TPU's block-divisibility gate (_pick_blocks)
// and its required bias do not apply.  Each 16-deep slice is loaded,
// synchronised and consumed.  Shared memory 16.6 KB per block; at most
// 128 registers a thread, so two blocks fit on an SM.  The grid's y axis
// (M / 128 blocks) holds at most 65535: a larger M is launched in chunks
// of 65535 * 128 rows, x, dy and the output offset per chunk.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16, an 8 x 8 output block each
constexpr int kLdA = kBM + 4;

constexpr float kSqrt2OverPi = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kSqrt2Pi = 2.5066282746310002f;  // sqrt(2 * pi)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// the reference's _gelu_f32 and _gelu_grad_f32, term for term
__device__ __forceinline__ float gelu(float z, int approximate) {
  if (approximate) {
    const float inner = kSqrt2OverPi * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.f + tanhf(inner));
  }
  return 0.5f * z * (1.f + erff(z / kSqrt2));
}

__device__ __forceinline__ float gelu_grad(float z, int approximate) {
  if (approximate) {
    const float inner = kSqrt2OverPi * (z + 0.044715f * z * z * z);
    const float t = tanhf(inner);
    const float sech2 = 1.f - t * t;
    const float dinner = kSqrt2OverPi * (1.f + 3.f * 0.044715f * z * z);
    return 0.5f * (1.f + t) + 0.5f * z * sech2 * dinner;
  }
  const float cdf = 0.5f * (1.f + erff(z / kSqrt2));
  const float pdf = expf(-0.5f * z * z) / kSqrt2Pi;
  return cdf + z * pdf;
}

// The tensor-core epilogue's GELU: the same tanh form by its identity
// 0.5 z (1 + tanh(u)) = z * s, s = sigmoid(2u) = 1 / (1 + exp(-2u)), with
// one ex2.approx and one fast division (a few ulp of f32, far below the
// bf16 rounding that follows) in place of tanhf's branch and polynomial,
// and gelu'(z) = s + 2 z s (1 - s) u'.  The epilogue is latency-bound
// (eight warps an SM), so its instruction count is its time.  The erf
// form is the reference's, as gelu/gelu_grad above.
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float sigmoid_2u(float z) {
  constexpr float kMinus2Log2e = -2.8853900817779268f;  // -2 / ln 2
  const float u = kSqrt2OverPi * (z + 0.044715f * z * z * z);
  return __fdividef(1.f, 1.f + exp2_approx(kMinus2Log2e * u));
}

template <bool APPROX>
__device__ __forceinline__ float gelu_tc(float z) {
  return APPROX ? z * sigmoid_2u(z) : gelu(z, 0);
}

template <bool APPROX>
__device__ __forceinline__ float gelu_grad_tc(float z) {
  if (!APPROX) return gelu_grad(z, 0);
  const float s = sigmoid_2u(z);
  const float du = kSqrt2OverPi * (1.f + 3.f * 0.044715f * z * z);
  return s + 2.f * z * s * (1.f - s) * du;
}

// ---------------------------------------------------------------------
// SIMT kernel
// ---------------------------------------------------------------------

// row (or column) of the i-th of a thread's 8 accumulators
__device__ __forceinline__ int frag(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads, 2)
    linear_gelu(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ b, const T* __restrict__ dy,
                T* __restrict__ out, int M, int N, int K, int approximate) {
  __shared__ __align__(16) float As[kBK][kLdA];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x slice: 128 rows x 16 k, a row's 16 k on 16 neighbouring threads
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK;
      const int kk = e % kBK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K)
                      ? to_f32(x[static_cast<size_t>(gm) * K + gk])
                      : 0.f;
    }
    // w slice: 16 k x 128 columns, a row's columns on neighbouring threads
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / kBN;
      const int c = e % kBN;
      const int gk = k0 + kk;
      const int gn = n0 + c;
      Bs[kk][c] = (gk < K && gn < N)
                      ? to_f32(w[static_cast<size_t>(gk) * N + gn])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue on the f32 accumulator: bias, then GELU or dy * GELU'
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + frag(ty, i);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + frag(tx, j);
      if (gn >= N) continue;
      const float z = acc[i][j] + (b != nullptr ? b[gn] : 0.f);
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if (BWD) {
        store(out + o, to_f32(dy[o]) * gelu_grad(z, approximate));
      } else {
        store(out + o, gelu(z, approximate));
      }
    }
  }
}

// rows of one SIMT launch: the grid's y axis holds 65535 blocks
constexpr int kSimtChunkRows = 65535 * kBM;

template <typename T, bool BWD>
int launch_simt(const void* x, const void* w, const void* b, const void* dy,
                void* out, int M, int N, int K, int approximate,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* ot = static_cast<T*>(out);
  for (long long m0 = 0; m0 < M; m0 += kSimtChunkRows) {
    const int rows = static_cast<int>(
        M - m0 < kSimtChunkRows ? M - m0 : kSimtChunkRows);
    const dim3 grid((N - 1) / kBN + 1, (rows - 1) / kBM + 1);
    linear_gelu<T, BWD><<<grid, kThreads, 0, s>>>(
        xt + static_cast<size_t>(m0) * K, static_cast<const T*>(w),
        static_cast<const float*>(b),
        BWD ? dyt + static_cast<size_t>(m0) * N : nullptr,
        ot + static_cast<size_t>(m0) * N, rows, N, K, approximate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <bool BWD>
int run_simt(const void* x, const void* w, const void* b, const void* dy,
             void* out, int M, int N, int K, int approximate, int dtype,
             cudaStream_t s) {
  if (M < 0 || N < 0 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0) {
    return launch_simt<float, BWD>(x, w, b, dy, out, M, N, K, approximate, s);
  }
  if (dtype == 1) {
    return launch_simt<__nv_bfloat16, BWD>(x, w, b, dy, out, M, N, K,
                                           approximate, s);
  }
  if (dtype == 2) {
    return launch_simt<__half, BWD>(x, w, b, dy, out, M, N, K, approximate,
                                    s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------
// Tensor-core kernel (bf16 or f16): wgmma fed by TMA
// ---------------------------------------------------------------------

constexpr int kTcBM = 128;            // two consumer warpgroups of 64 rows
constexpr int kTcBN = 256;            // one wgmma m64n256k16 wide
constexpr int kTcBK = 64;             // 128 bytes of 16-bit: one swizzle row
constexpr int kTcStages = 3;
constexpr int kTcThreads = 384;       // producer + two consumer warpgroups
constexpr int kBox = 64;              // TMA box side for w, dy and y
constexpr int kBoxBytes = kBox * kBox * 2;                  // 8 KB
constexpr int kTileA = kTcBM * kTcBK * 2;                   // 16 KB
constexpr int kTileB = kTcBK * kTcBN * 2;                   // 32 KB
constexpr int kStageBytes = kTileA + kTileB;                // 48 KB
constexpr int kRingBytes = kTcStages * kStageBytes;         // 144 KB
constexpr int kTileY = kTcBM * kTcBN * 2;                   // 64 KB
constexpr int kHalfY = kTileY / 2;    // a consumer's 64 rows: 4 boxes
constexpr int kTcSmem =
    kRingBytes + kTileY + (2 * kTcStages + 2) * 8 + 1024;   // + align
constexpr int kAcc = kTcBN / 2;       // f32 accumulators a consumer thread

// APPROX: the tanh form (true) or the erf form, fixed at compile time so
// the epilogue carries one of them; T: the 16-bit type of x, w, dy, y
template <bool BWD, bool APPROX, typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
    linear_gelu_wgmma(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_dy,
                      const __grid_constant__ CUtensorMap map_y,
                      const float* __restrict__ b, int M, int N,
                      int K) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);
  uint8_t* ring_a = smem;                         // stages x [128][64]
  uint8_t* ring_b = smem + kTcStages * kTileA;    // stages x 4 x [64][64]
  uint8_t* tile_y = smem + kRingBytes;            // 2 x 4 x [64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_y + kTileY);
  uint64_t* empty = full + kTcStages;
  uint64_t* dy_full = empty + kTcStages;
  uint64_t* y_free = dy_full + 1;

  const int wg = threadIdx.x / 128;
  const int n_k = (K + kTcBK - 1) / kTcBK;
  const int tiles_n = (N + kTcBN - 1) / kTcBN;
  const int tiles = tiles_n * ((M + kTcBM - 1) / kTcBM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);    // the producer's expect_tx
      hopper::mbar_init(&empty[s], 2);   // one arrival per consumer
    }
    hopper::mbar_init(dy_full, 1);
    hopper::mbar_init(y_free, 2);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full across this block's
    // tiles and, in the backward, brings each tile's dy into tile_y once
    // the previous tile's result has left it
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x, li = 0; tile < tiles;
           tile += gridDim.x, ++li) {
        const int m0 = (tile / tiles_n) * kTcBM;
        const int n0 = (tile % tiles_n) * kTcBN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kTcStages;
          if (it >= kTcStages) {
            hopper::mbar_wait(&empty[s], ((it / kTcStages) - 1) & 1);
          }
          hopper::mbar_expect_tx(&full[s], kStageBytes);
          hopper::tma_load_2d(ring_a + s * kTileA, &map_x, &full[s],
                              kt * kTcBK, m0);
#pragma unroll
          for (int c = 0; c < kTcBN / kBox; ++c) {
            hopper::tma_load_2d(ring_b + s * kTileB + c * kBoxBytes, &map_w,
                                &full[s], n0 + c * kBox, kt * kTcBK);
          }
          if (BWD && kt == min(n_k, kTcStages) - 1) {
            if (li > 0) hopper::mbar_wait(y_free, (li - 1) & 1);
            hopper::mbar_expect_tx(dy_full, kTileY);
#pragma unroll
            for (int i = 0; i < kTileY / kBoxBytes; ++i) {
              const int half = i / (kTcBN / kBox), c = i % (kTcBN / kBox);
              hopper::tma_load_2d(tile_y + i * kBoxBytes, &map_dy, dy_full,
                                  n0 + c * kBox, m0 + half * (kTcBM / 2));
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows cw*64 .. cw*64 + 63 of each tile
  hopper::regs_inc<232>();
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = (t / 32) * 16 + lane / 4;   // and row0 + 8
  uint8_t* half_y = tile_y + cw * kHalfY;
  float acc[kAcc];
  int it = 0;
  for (int tile = blockIdx.x, li = 0; tile < tiles;
       tile += gridDim.x, ++li) {
    const int m0 = (tile / tiles_n) * kTcBM;
    const int n0 = (tile % tiles_n) * kTcBN;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % kTcStages;
      hopper::mbar_wait(&full[s], (it / kTcStages) & 1);
      const uint8_t* a = ring_a + s * kTileA + cw * (kTcBM / 2) * 128;
      const uint8_t* bt = ring_b + s * kTileB;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        const uint64_t da = hopper::wgmma_desc(a + kk * 32, 16, 1024);
        const uint64_t db =
            hopper::wgmma_desc(bt + kk * 16 * 128, kBoxBytes, 1024);
        hopper::wgmma_m64n256k16<1, T>(acc, da, db, kt > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      // the previous slice's products are done: free its stage
      hopper::wgmma_wait<1>();
      if (kt > 0 && t == 0) {
        hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (t == 0) hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);

    // epilogue: the T result goes to this consumer's half of tile_y,
    // in the 128-byte swizzle of the store map, over dy where the
    // backward read it from the same place.  The previous tile's stores
    // have read tile_y (thread 0 waited for them before this barrier)
    if (BWD) {
      hopper::mbar_wait(dy_full, li & 1);
    } else {
      hopper::named_sync(1 + cw, 128);
    }
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
      const int gcol = n0 + j * 8 + (lane % 4) * 2;
      // N % 8 == 0: a pair is wholly inside N or wholly past it
      float b0 = 0.f, b1 = 0.f;
      if (b != nullptr && gcol < N) {
        b0 = b[gcol];
        b1 = b[gcol + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + h * 8;
        const float z0 = acc[4 * j + 2 * h] + b0;
        const float z1 = acc[4 * j + 2 * h + 1] + b1;
        uint32_t* at = reinterpret_cast<uint32_t*>(
            half_y + (j / 8) * kBoxBytes + row * 128 +
            (((j % 8) ^ (row % 8)) * 16) + (lane % 4) * 4);
        float v0, v1;
        if (BWD) {
          const float2 d = hopper::unpack2<T>(*at);
          v0 = d.x * gelu_grad_tc<APPROX>(z0);
          v1 = d.y * gelu_grad_tc<APPROX>(z1);
        } else {
          v0 = gelu_tc<APPROX>(z0);
          v1 = gelu_tc<APPROX>(z1);
        }
        *at = hopper::pack2<T>(v0, v1);
      }
    }
    hopper::fence_async_shared();
    hopper::named_sync(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < kTcBN / kBox; ++c) {
        hopper::tma_store_2d(&map_y, half_y + c * kBoxBytes, n0 + c * kBox,
                             m0 + cw * (kTcBM / 2));
      }
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
      if (BWD) hopper::mbar_arrive(y_free);
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// the library needs no -lcuda; null if the driver lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a row-major 16-bit [rows, cols] matrix (dtype 1 bf16, 2 f16), read or
// written in boxes of box_rows x 64 columns with the 128-byte swizzle
bool tile_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows, int dtype) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool BWD>
int run_wgmma(const void* x, const void* w, const void* b, const void* dy,
              void* out, int M, int N, int K, int approximate, int dtype,
              cudaStream_t s) {
  const long long tiles = ((static_cast<long long>(N) + kTcBN - 1) / kTcBN) *
                          ((static_cast<long long>(M) + kTcBM - 1) / kTcBM);
  if ((dtype != 1 && dtype != 2) || M < 0 || N < 0 || K < 8 || K % 8 != 0 ||
      N % 8 != 0 ||
      tiles > 0x7fffffff || !aligned16(x) || !aligned16(w) ||
      !aligned16(out) || (BWD && !aligned16(dy))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap map_x, map_w, map_dy, map_y;
  if (!tile_map(&map_x, x, M, K, kTcBM, dtype) ||
      !tile_map(&map_w, w, K, N, kBox, dtype) ||
      !tile_map(&map_y, out, M, N, kBox, dtype) ||
      !tile_map(&map_dy, BWD ? dy : out, M, N, kBox, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // persistent: one block an SM walks tiles blockIdx.x, + gridDim.x, ...
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  auto kernel =
      dtype == 2
          ? (approximate ? linear_gelu_wgmma<BWD, true, __half>
                         : linear_gelu_wgmma<BWD, false, __half>)
          : (approximate ? linear_gelu_wgmma<BWD, true, __nv_bfloat16>
                         : linear_gelu_wgmma<BWD, false, __nv_bfloat16>);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kTcThreads, kTcSmem, s>>>(map_x, map_w, map_dy, map_y,
                                           static_cast<const float*>(b), M,
                                           N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool BWD>
int run(const void* x, const void* w, const void* b, const void* dy,
        void* out, int M, int N, int K, int approximate, int dtype,
        int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    return run_wgmma<BWD>(x, w, b, dy, out, M, N, K, approximate, dtype, s);
  }
  return run_simt<BWD>(x, w, b, dy, out, M, N, K, approximate, dtype, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w, y); b is f32 or
// null.  tensor_cores: 1 takes linear_gelu_wgmma (bf16 or f16, K % 8 ==
// 0, N % 8 == 0, x, w, y on 16 bytes), 0 the SIMT kernel.
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int ptt_linear_gelu_fwd(const void* x, const void* w,
                                   const void* b, void* y, int M, int N,
                                   int K, int approximate, int dtype,
                                   int tensor_cores, void* stream) {
  return run<false>(x, w, b, nullptr, y, M, N, K, approximate, dtype,
                    tensor_cores, stream);
}

// dy and dz in x's dtype.
extern "C" int ptt_linear_gelu_bwd(const void* x, const void* w,
                                   const void* b, const void* dy, void* dz,
                                   int M, int N, int K, int approximate,
                                   int dtype, int tensor_cores,
                                   void* stream) {
  return run<true>(x, w, b, dy, dz, M, N, K, approximate, dtype,
                   tensor_cores, stream);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
