// Fused LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/fused_norm.py::_fwd_kernel.
// Same function: LayerNorm over the last axis of x [N, H] with f32
// statistics (mean first, then the two-pass variance
// mean((x - mean)^2), rstd = rsqrt(var + eps)), y = (x - mean) * rstd *
// gamma + beta cast to x's dtype, plus mean and rstd as f32 [N] for the
// backward (the TPU kernel stored them broadcast to 128 lanes; here
// they are flat).
//
// Bound: the op moves N*H*(in + out dtype bytes) + 8N + 2H*4 bytes (x
// read once, y written once, mean/rstd written, gamma/beta read) and
// does about 8 flops per element, so it is bound by bytes, at 3.35 TB/s
// on an H100 SXM.  At the serving decode shape (64 x 768 f32, about
// 0.4 MB) that is about 0.12 us, far below a kernel launch, so launch
// latency and not bandwidth sets its time there; the prefill shape
// (512 x 768 f32, about 3.1 MB) is about 0.9 us of bytes.
//
// Design, simple first.  Rows up to 2048 (gpt_1p3b's width): one warp
// per row.  The warp keeps the whole row in registers (NV four-element
// groups per lane), so the second pass over (x - mean) reads no memory
// again.  Where H % 4 == 0 and x, y, gamma and beta start on 16 bytes,
// a lane's group is one vector load (16 bytes for f32, 8 for bf16 and
// f16); otherwise (H % 4 != 0: rows off 16 bytes) every element is a
// scalar load, element c = 32 * (4 i + j) + lane, so a warp's loads stay
// consecutive.  Longer rows: one 256-thread block per row with scalar
// loads, three passes over the row (the sum, the squared deviations from
// the mean, the write), which stay in L1/L2, and block sums combined
// through shared memory in a fixed order.  Sums are __shfl_xor_sync
// butterflies: no atomics, so a launch repeats bit for bit.  Rows are
// independent, so nothing carries between blocks (the TPU's sequential
// row-block grid has no counterpart here).
//
// Limits the wrapper (paddle_tpu_torch/ops/fused_norm.py) enforces:
// x contiguous, f32, bf16 or f16, gamma/beta f32 or absent, any H >= 1.
// The TPU's H % 128 and row-block gate does not apply.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxVecsPerLane = 16;
constexpr int kMaxWarpHidden = 32 * 4 * kMaxVecsPerLane;  // 2048
constexpr int kBlockThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the block, on every thread (red: one float a warp)
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = lane < kBlockThreads / 32 ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();  // red is free again
  return t;
}

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

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 to_f32x2(__half2 v) {
  return __half22float2(v);
}

// four 16-bit values (8 bytes; H2 the type of a pair) -> f32
template <typename H2>
__device__ __forceinline__ void load4_16(const void* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  H2 lo, hi;
  memcpy(&lo, &t.x, sizeof(lo));
  memcpy(&hi, &t.y, sizeof(hi));
  const float2 a = to_f32x2(lo);
  const float2 b = to_f32x2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  load4_16<__nv_bfloat162>(p, v);
}

__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  load4_16<__half2>(p, v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  memcpy(&t.x, &lo, sizeof(lo));
  memcpy(&t.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  const __half2 lo = __floats2half2_rn(v[0], v[1]);
  const __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 t;
  memcpy(&t.x, &lo, sizeof(lo));
  memcpy(&t.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = t;
}

// element of group i, slot j held by `lane`: VEC, the 4 consecutive
// elements of vector i * 32 + lane; scalar, element 32 * (4 i + j) + lane
template <bool VEC>
__device__ __forceinline__ int elem(int i, int j, int lane) {
  return VEC ? 4 * (i * 32 + lane) + j : 32 * (4 * i + j) + lane;
}

template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layer_norm_warp(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int n, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;

  float v[NV][4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (VEC) {
      const int c = elem<true>(i, 0, lane);
      if (c < h) {
        load4(xr + c, v[i]);
      } else {
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = elem<false>(i, j, lane);
        v[i][j] = c < h ? to_f32(xr[c]) : 0.f;
      }
    }
    s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  }
  const float hf = static_cast<float>(h);
  const float mean = warp_sum(s) / hf;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (elem<VEC>(i, j, lane) < h) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / hf + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (VEC) {
      const int c = elem<true>(i, 0, lane);
      if (c < h) {
        float g[4] = {1.f, 1.f, 1.f, 1.f};
        float b[4] = {0.f, 0.f, 0.f, 0.f};
        if (gamma != nullptr) load4(gamma + c, g);
        if (beta != nullptr) load4(beta + c, b);
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = (v[i][j] - mean) * rstd * g[j] + b[j];
        store4(yr + c, o);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = elem<false>(i, j, lane);
        if (c < h) {
          const float g = gamma != nullptr ? gamma[c] : 1.f;
          const float b = beta != nullptr ? beta[c] : 0.f;
          store(yr + c, (v[i][j] - mean) * rstd * g + b);
        }
      }
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    layer_norm_block(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int h, float eps) {
  __shared__ float red[kBlockThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;
  const float hf = static_cast<float>(h);

  float s = 0.f;
  for (int c = threadIdx.x; c < h; c += kBlockThreads) s += to_f32(xr[c]);
  const float mean = block_sum(s, red) / hf;
  float q = 0.f;
  for (int c = threadIdx.x; c < h; c += kBlockThreads) {
    const float d = to_f32(xr[c]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / hf + eps);
  for (int c = threadIdx.x; c < h; c += kBlockThreads) {
    const float g = gamma != nullptr ? gamma[c] : 1.f;
    const float b = beta != nullptr ? beta[c] : 0.f;
    store(yr + c, (to_f32(xr[c]) - mean) * rstd * g + b);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool VEC>
void launch_warp(const T* x, const float* g, const float* b, T* y, float* m,
                 float* r, int n, int h, float eps, cudaStream_t stream) {
  const int need = (h + 127) / 128;  // four-element groups per lane
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
#define PTT_LN_CASE(NV)                                                  \
  if (need <= NV) {                                                      \
    layer_norm_warp<T, NV, VEC>                                          \
        <<<grid, block, 0, stream>>>(x, g, b, y, m, r, n, h, eps);       \
    return;                                                              \
  }
  PTT_LN_CASE(1)
  PTT_LN_CASE(2)
  PTT_LN_CASE(3)
  PTT_LN_CASE(4)
  PTT_LN_CASE(6)
  PTT_LN_CASE(8)
  PTT_LN_CASE(12)
  PTT_LN_CASE(16)
#undef PTT_LN_CASE
}

template <typename T>
void launch(const void* x, const void* gamma, const void* beta, void* y,
            void* mean, void* rstd, int n, int h, float eps,
            cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (h > kMaxWarpHidden) {
    layer_norm_block<T><<<n, kBlockThreads, 0, stream>>>(xt, g, b, yt, m, r,
                                                          h, eps);
  } else if (h % 4 == 0 && aligned16(x) && aligned16(y) &&
             (gamma == nullptr || aligned16(gamma)) &&
             (beta == nullptr || aligned16(beta))) {
    launch_warp<T, true>(xt, g, b, yt, m, r, n, h, eps, stream);
  } else {
    launch_warp<T, false>(xt, g, b, yt, m, r, n, h, eps, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  gamma/beta may be null
// (no affine).  Returns cudaGetLastError() after the launch; 0 means it
// was queued.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int n, int h, float eps,
                                  int dtype, void* stream) {
  if (n < 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, gamma, beta, y, mean, rstd, n, h, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps, s);
  } else if (dtype == 2) {
    launch<__half>(x, gamma, beta, y, mean, rstd, n, h, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
