// Fused matmul + bias + GELU for Hopper (sm_90a): the forward and the
// recompute backward, SIMT, f32 accumulation.
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
// accumulator in the epilogue, and the output in x's dtype (f32 or
// bf16).  The backward recomputes z = x @ w + b rather than reading a
// saved [M, N] pre-activation: the reference's design point, kept.  The
// other backward products (dx = dz @ w^T, dw = x^T @ dz, db = sum dz)
// stay outside, as the reference leaves them to XLA.
//
// Bound: at BERT-base's MLP shape (M 8192, K 768, N 3072, bf16) each
// kernel does 2*M*N*K = 38.7 GFLOP, 39.1 us at the bf16 tensor-core peak
// of 989 TFLOP/s, against 20.2 us (forward, 67.6 MB) or 35.2 us
// (backward, 117.9 MB) of bytes: bound by operations.  These kernels do
// not use the tensor cores: every product is an f32 FMA on the SIMT
// pipes (67 TFLOP/s peak), so they sit far above the bound; wgmma with
// TMA-fed tiles is later work.
//
// Design, simple first: the classic shared-memory SGEMM.  One 256-thread
// block per 128 x 128 output tile; the K axis, which the TPU kernel
// walked as a sequential grid axis with an f32 VMEM accumulator, is a
// loop in the block over 16-deep slices: x's 128 x 16 slice is stored
// transposed (As[k][m], rows padded by 4 floats against bank conflicts
// on the transposing store) and w's 16 x 128 slice as it is (Bs[k][n]),
// both converted to f32.  A thread owns an 8 x 8 block of accumulators
// in registers: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// tx*4 + {0..3} and 64 + tx*4 + {0..3}, read as float4s from shared
// memory.  Loads are scalar and bounds-checked (zero beyond M, N or K),
// so any M, N, K >= 1 work and the ragged edge is masked in the kernel;
// the TPU's block-divisibility gate (_pick_blocks) and its required bias
// do not apply.  No double buffering, no cp.async: each 16-deep slice is
// loaded, synchronised and consumed.  Shared memory 16.6 KB per block;
// at most 128 registers a thread, so two blocks fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

template <bool BWD>
int run(const void* x, const void* w, const void* b, const void* dy,
        void* out, int M, int N, int K, int approximate, int dtype,
        void* stream) {
  if (M < 0 || N < 0 || K < 1 || M > 65535 * kBM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N - 1) / kBN + 1, (M - 1) / kBM + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    linear_gelu<float, BWD><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bf,
        static_cast<const float*>(dy), static_cast<float*>(out), M, N, K,
        approximate);
  } else if (dtype == 1) {
    linear_gelu<__nv_bfloat16, BWD><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), bf,
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(out), M, N, K, approximate);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, y); b is f32 or null.
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int ptt_linear_gelu_fwd(const void* x, const void* w,
                                   const void* b, void* y, int M, int N,
                                   int K, int approximate, int dtype,
                                   void* stream) {
  return run<false>(x, w, b, nullptr, y, M, N, K, approximate, dtype,
                    stream);
}

// dy and dz in x's dtype.
extern "C" int ptt_linear_gelu_bwd(const void* x, const void* w,
                                   const void* b, const void* dy, void* dz,
                                   int M, int N, int K, int approximate,
                                   int dtype, void* stream) {
  return run<true>(x, w, b, dy, dz, M, N, K, approximate, dtype, stream);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
