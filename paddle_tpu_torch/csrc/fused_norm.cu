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
// 0.4 MB) that is about 0.12 us, far below a kernel launch: there the
// time is latency, the launch and one row's chain of memory trips and
// reductions; at BERT's and GPT's training shapes (8192 x 768 bf16,
// 25 MB) it is bandwidth.
//
// Designs (the wrapper picks one per launch and names it; the entry
// point refuses a design the row does not fit):
//  - warp (H <= 2048): one warp a row and one row a 32-thread block, so
//    decode's 64 rows spread over 64 SMs; the whole row in registers (NV
//    four-element groups a lane), so the second pass over (x - mean)
//    reads no memory again; up to H 1024 gamma/beta are loaded together
//    with x, before the reductions: one trip to memory a row.  (Four
//    rows a 128-thread block with gamma/beta loaded after the reductions
//    took 7.9-8.3 us at 8192 x 768 bf16 on an H100 where this takes 7.5;
//    PERF.md.)
//  - block (H > 2048): one block a row (128 threads up to H 4096, 256
//    up to 8192, 1024 up to 24576), each thread holding NG <= 8 (<= 6 at
//    1024 threads, at most 64 registers) four-element groups in
//    registers: the row is read from memory once; gamma/beta (L2 hits)
//    are loaded after the reductions, which keeps the registers, and so
//    the rows in flight, low (a 256-thread block with gamma/beta in
//    registers took 39.9 us at 8192 x 2560 bf16 on an H100 where 128
//    threads take 31.5).  Block sums go through shared memory in a fixed order.  Rows
//    above 24576 take a 256-thread loop over the row, three passes (the
//    sum, the squared deviations, the write), the second and third from
//    L1/L2.
// Where H % 4 == 0 and x, y, gamma and beta start on 16 bytes, a
// group is one vector load (16 bytes for f32, 8 for bf16 and f16);
// otherwise element c = W * (4 i + j) + t (W the threads of a row, t
// the thread), so a warp's loads stay consecutive.  Sums are
// __shfl_xor_sync butterflies: no atomics, so a launch repeats bit for
// bit.  Rows are independent, so nothing carries between blocks (the
// TPU's sequential row-block grid has no counterpart here).
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

constexpr int kWarpMaxH = 2048;       // the warp design's widest row
constexpr int kPrefetchMaxNV = 8;     // gamma/beta with x up to H 1024
constexpr int kBlockRegMaxH = 24576;  // the block design's rows in registers
constexpr int kLoopThreads = 256;     // and its loop above that

// the designs, as ops/fused_norm.py's VARIANTS orders them
constexpr int kWarp = 0;
constexpr int kBlock = 1;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over a block of THREADS, on every thread (red: one float
// a warp); the warps' sums are added in a fixed order
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = lane < THREADS / 32 ? red[lane] : 0.f;
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

// element of group i, slot j held by thread t of W on a row: VEC, the 4
// consecutive elements of vector i * W + t; scalar, W * (4 i + j) + t
template <bool VEC, int W>
__device__ __forceinline__ int elem(int i, int j, int t) {
  return VEC ? 4 * (i * W + t) + j : W * (4 * i + j) + t;
}

// group i of p (x, gamma or beta) held by thread t, `fill` past h
template <bool VEC, int W, typename T>
__device__ __forceinline__ void load_group(const T* p, int i, int t, int h,
                                           float fill, float (&v)[4]) {
  if (VEC) {
    const int c = elem<true, W>(i, 0, t);
    if (c < h) {
      load4(p + c, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = fill;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = elem<false, W>(i, j, t);
      v[j] = c < h ? to_f32(p[c]) : fill;
    }
  }
}

// gamma (fill 1) or beta (fill 0), either of which may be absent
template <bool VEC, int W>
__device__ __forceinline__ void load_affine(const float* p, int i, int t,
                                            int h, float fill,
                                            float (&v)[4]) {
  if (p != nullptr) {
    load_group<VEC, W>(p, i, t, h, fill, v);
  } else {
    v[0] = v[1] = v[2] = v[3] = fill;
  }
}

// y of group i from its x values, the statistics and gamma/beta
template <bool VEC, int W, typename T>
__device__ __forceinline__ void store_group(T* yr, int i, int t, int h,
                                            const float (&v)[4], float mean,
                                            float rstd, const float (&g)[4],
                                            const float (&b)[4]) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = (v[j] - mean) * rstd * g[j] + b[j];
  if (VEC) {
    const int c = elem<true, W>(i, 0, t);
    if (c < h) store4(yr + c, o);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = elem<false, W>(i, j, t);
      if (c < h) store(yr + c, o[j]);
    }
  }
}

// the sum of the row's deviations squared over this thread's groups
template <bool VEC, int W, int NG>
__device__ __forceinline__ float sq_dev(const float (&v)[NG][4], int t,
                                        int h, float mean) {
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (elem<VEC, W>(i, j, t) < h) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  return q;
}

// one row a 32-thread block; PRE: gamma/beta loaded with x, before the
// reductions
template <typename T, int NV, bool VEC, bool PRE>
__global__ void __launch_bounds__(32)
    layer_norm_warp(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;

  float v[NV][4];
  float g[PRE ? NV : 1][4], b[PRE ? NV : 1][4];
#pragma unroll
  for (int i = 0; i < NV; ++i) load_group<VEC, 32>(xr, i, lane, h, 0.f, v[i]);
  if (PRE) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      load_affine<VEC, 32>(gamma, i, lane, h, 1.f, g[i]);
      load_affine<VEC, 32>(beta, i, lane, h, 0.f, b[i]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  const float hf = static_cast<float>(h);
  const float mean = warp_sum(s) / hf;
  const float rstd =
      rsqrtf(warp_sum(sq_dev<VEC, 32>(v, lane, h, mean)) / hf + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (PRE) {
      store_group<VEC, 32>(yr, i, lane, h, v[i], mean, rstd, g[i], b[i]);
    } else {
      float gl[4], bl[4];
      load_affine<VEC, 32>(gamma, i, lane, h, 1.f, gl);
      load_affine<VEC, 32>(beta, i, lane, h, 0.f, bl);
      store_group<VEC, 32>(yr, i, lane, h, v[i], mean, rstd, gl, bl);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// one block of THREADS a row, NG groups a thread in registers
template <typename T, int NG, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
    layer_norm_block(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int h, float eps) {
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;

  float v[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i) load_group<VEC, THREADS>(xr, i, tid, h, 0.f, v[i]);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  const float hf = static_cast<float>(h);
  const float mean = block_sum<THREADS>(s, red) / hf;
  const float rstd = rsqrtf(
      block_sum<THREADS>(sq_dev<VEC, THREADS>(v, tid, h, mean), red) / hf +
      eps);

#pragma unroll
  for (int i = 0; i < NG; ++i) {
    float g[4], b[4];
    load_affine<VEC, THREADS>(gamma, i, tid, h, 1.f, g);
    load_affine<VEC, THREADS>(beta, i, tid, h, 0.f, b);
    store_group<VEC, THREADS>(yr, i, tid, h, v[i], mean, rstd, g, b);
  }
  if (tid == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// rows above kBlockRegMaxH: three passes over the row, scalar loads
template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
    layer_norm_loop(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int h, float eps) {
  __shared__ float red[kLoopThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;
  const float hf = static_cast<float>(h);

  float s = 0.f;
  for (int c = threadIdx.x; c < h; c += kLoopThreads) s += to_f32(xr[c]);
  const float mean = block_sum<kLoopThreads>(s, red) / hf;
  float q = 0.f;
  for (int c = threadIdx.x; c < h; c += kLoopThreads) {
    const float d = to_f32(xr[c]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum<kLoopThreads>(q, red) / hf + eps);
  for (int c = threadIdx.x; c < h; c += kLoopThreads) {
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
#define PTT_LN_CASE(NV)                                                  \
  if (need <= NV) {                                                      \
    layer_norm_warp<T, NV, VEC, (NV <= kPrefetchMaxNV)>                  \
        <<<n, 32, 0, stream>>>(x, g, b, y, m, r, h, eps);                \
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

template <typename T, int THREADS>
void launch_block(bool vec, const T* x, const float* g, const float* b,
                  T* y, float* m, float* r, int n, int h, float eps,
                  cudaStream_t stream) {
  const int need = ((h + 3) / 4 + THREADS - 1) / THREADS;  // groups a thread
#define PTT_LN_BLOCK(NG)                                                 \
  if (need <= NG) {                                                      \
    if (vec) {                                                           \
      layer_norm_block<T, NG, true, THREADS>                             \
          <<<n, THREADS, 0, stream>>>(x, g, b, y, m, r, h, eps);         \
    } else {                                                             \
      layer_norm_block<T, NG, false, THREADS>                            \
          <<<n, THREADS, 0, stream>>>(x, g, b, y, m, r, h, eps);         \
    }                                                                    \
    return;                                                              \
  }
  // 128 and 256 threads take 5-8 groups (H above 2048 and 4096), 1024
  // threads 3-6 (at most 64 registers a thread).  At 128 threads the
  // 6-group f32 kernel with scalar loads took an 8-byte stack frame, so
  // 8 groups hold those rows.
  if constexpr (THREADS == 1024) {
    PTT_LN_BLOCK(3)
    PTT_LN_BLOCK(4)
  }
  PTT_LN_BLOCK(5)
  if constexpr (THREADS != 128) {
    PTT_LN_BLOCK(6)
  }
  if constexpr (THREADS <= 256) {
    PTT_LN_BLOCK(8)
  }
#undef PTT_LN_BLOCK
}

// queues the named design; false if the row does not fit it
template <typename T>
bool launch(const void* x, const void* gamma, const void* beta, void* y,
            void* mean, void* rstd, int n, int h, float eps, int design,
            cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const bool vec = h % 4 == 0 && aligned16(x) && aligned16(y) &&
                   (gamma == nullptr || aligned16(gamma)) &&
                   (beta == nullptr || aligned16(beta));
  if (design == kWarp) {
    if (h > kWarpMaxH) return false;
    if (vec) {
      launch_warp<T, true>(xt, g, b, yt, m, r, n, h, eps, stream);
    } else {
      launch_warp<T, false>(xt, g, b, yt, m, r, n, h, eps, stream);
    }
    return true;
  }
  if (design != kBlock || h <= kWarpMaxH) return false;
  if (h > kBlockRegMaxH) {
    layer_norm_loop<T><<<n, kLoopThreads, 0, stream>>>(xt, g, b, yt, m, r,
                                                        h, eps);
  } else if (h > 8192) {
    launch_block<T, 1024>(vec, xt, g, b, yt, m, r, n, h, eps, stream);
  } else if (h > 4096) {
    launch_block<T, 256>(vec, xt, g, b, yt, m, r, n, h, eps, stream);
  } else {
    launch_block<T, 128>(vec, xt, g, b, yt, m, r, n, h, eps, stream);
  }
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; design: 0 = warp (H <=
// 2048), 1 = block (H > 2048).  gamma/beta may be null (no affine).
// Returns cudaGetLastError() after the launch, 0 meaning it was queued,
// or cudaErrorInvalidValue for a dtype or design the row does not fit.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int n, int h, float eps,
                                  int dtype, int design, void* stream) {
  if (n < 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = launch<float>(x, gamma, beta, y, mean, rstd, n, h, eps, design, s);
  } else if (dtype == 1) {
    ok = launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps,
                               design, s);
  } else if (dtype == 2) {
    ok = launch<__half>(x, gamma, beta, y, mean, rstd, n, h, eps, design, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
