// Fused softmax over the last axis for Hopper (sm_90a), plain and masked.
//
// Replaces the TPU kernels of paddle_tpu/ops/fused_softmax.py:
//   ptt_softmax_fwd        <- _kernel        (:26)
//   ptt_softmax_masked_fwd <- _masked_kernel (:33)
// Same function: for each row of x [n, h] (row-major, contiguous),
// y = exp(t - max(t)) / sum(exp(t - max(t))) in f32, where t = x, or
// t = x + mask in the masked variant (mask read as f32); y in x's dtype
// (f32, bf16 or f16).
//
// The mask is not materialised.  The TPU wrapper broadcast it to x's
// shape in HBM (fused_softmax.py:99); here the kernel indexes the
// caller's mask through strides: x's leading dims, coalesced by the
// wrapper to at most four, map a row to an offset into the mask (stride
// 0 on a broadcast dim), and the last axis has its own stride (1, or 0
// for a mask broadcast along the row).  BERT's [B, 1, 1, T] padding mask
// over [B, H, T, T] scores is thus B*T floats read from L2, not a
// second [B, H, T, T] tensor.
//
// Bound: the op moves n*h*(in + out dtype bytes) plus the mask's own
// bytes and does ~4 flops per element (max, subtract, exp, divide), so it
// is bound by bytes at 3.35 TB/s on an H100 SXM: BERT-base's attention
// scores [64*12*128, 128] f32 are 100.7 MB, about 30 us.
//
// Design, simple first.  Rows up to 1024 (BERT's 128, GPT's 1024): one
// warp per row, the row held in registers (NV values per lane, column
// c = 32*i + lane, so a warp's loads are consecutive), max and sum as
// __shfl_xor_sync butterflies; x is read once and y written once.
// Longer rows: one 256-thread block per row, two passes over the row
// (an online max/sum, then the write) with a shared-memory combine of
// the per-thread (max, sum) pairs.  Rows are independent, so nothing
// carries between blocks (the TPU's sequential row-block grid has no
// counterpart).  Loads are scalar, so any h >= 1 and any alignment work;
// the TPU's h % 128 and row-block gates do not apply.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 32;
constexpr int kMaxWarpRow = 32 * kMaxPerLane;  // 1024
constexpr int kBlockThreads = 256;

// row r = ((i0 * d1 + i1) * d2 + i2) * d3 + i3 over x's (coalesced)
// leading dims; the mask element of (r, c) is at
// i0*s0 + i1*s1 + i2*s2 + i3*s3 + c*sh
struct MaskIndex {
  long long d1, d2, d3;
  long long s0, s1, s2, s3, sh;
};

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

__device__ __forceinline__ const float* mask_row(const float* mask,
                                                 const MaskIndex& mi,
                                                 long long row) {
  const long long i3 = row % mi.d3;
  row /= mi.d3;
  const long long i2 = row % mi.d2;
  row /= mi.d2;
  const long long i1 = row % mi.d1;
  row /= mi.d1;
  return mask + row * mi.s0 + i1 * mi.s1 + i2 * mi.s2 + i3 * mi.s3;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (m, s) <- the running (max, sum of exp(t - max)) of both halves
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) {
    s = 0.f;
  } else {
    s = s * expf(m - mx) + s2 * expf(m2 - mx);
  }
  m = mx;
}

template <typename T, int NV, bool MASKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    softmax_warp(const T* __restrict__ x, const float* __restrict__ mask,
                 T* __restrict__ y, int n, int h, MaskIndex mi) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;
  const float* mr = MASKED ? mask_row(mask, mi, row) : nullptr;

  float v[NV];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < h) {
      float t = to_f32(xr[c]);
      if (MASKED) t += mr[c * mi.sh];
      v[i] = t;
      m = fmaxf(m, t);
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < h) {
      v[i] = expf(v[i] - m);
      s += v[i];
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < h) store(yr + c, v[i] / s);
  }
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kBlockThreads)
    softmax_block(const T* __restrict__ x, const float* __restrict__ mask,
                  T* __restrict__ y, int h, MaskIndex mi) {
  __shared__ float sm[kBlockThreads / 32];
  __shared__ float ss[kBlockThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;
  const float* mr = MASKED ? mask_row(mask, mi, row) : nullptr;

  // pass 1: each thread's running (max, sum) over its columns
  float m = -INFINITY, s = 0.f;
  for (int c = threadIdx.x; c < h; c += kBlockThreads) {
    float t = to_f32(xr[c]);
    if (MASKED) t += mr[c * mi.sh];
    combine(m, s, t, 1.f);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    combine(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kBlockThreads / 32; ++w) combine(m, s, sm[w], ss[w]);
    sm[0] = m;
    ss[0] = s;
  }
  __syncthreads();
  m = sm[0];
  s = ss[0];

  // pass 2: the row again, normalised
  for (int c = threadIdx.x; c < h; c += kBlockThreads) {
    float t = to_f32(xr[c]);
    if (MASKED) t += mr[c * mi.sh];
    store(yr + c, expf(t - m) / s);
  }
}

template <typename T, bool MASKED>
void launch(const void* x, const float* mask, void* y, int n, int h,
            const MaskIndex& mi, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (h > kMaxWarpRow) {
    softmax_block<T, MASKED>
        <<<n, kBlockThreads, 0, stream>>>(xt, mask, yt, h, mi);
    return;
  }
  const int need = (h + 31) / 32;  // values per lane
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
#define PTT_SM_CASE(NV)                                                  \
  if (need <= NV) {                                                      \
    softmax_warp<T, NV, MASKED>                                          \
        <<<grid, block, 0, stream>>>(xt, mask, yt, n, h, mi);            \
    return;                                                              \
  }
  PTT_SM_CASE(1)
  PTT_SM_CASE(2)
  PTT_SM_CASE(4)
  PTT_SM_CASE(8)
  PTT_SM_CASE(16)
  PTT_SM_CASE(32)
#undef PTT_SM_CASE
}

template <bool MASKED>
int run(const void* x, const float* mask, void* y, int n, int h,
        const MaskIndex& mi, int dtype, void* stream) {
  if (n < 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, MASKED>(x, mask, y, n, h, mi, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, MASKED>(x, mask, y, n, h, mi, s);
  } else if (dtype == 2) {
    launch<__half, MASKED>(x, mask, y, n, h, mi, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and y).  Returns
// cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int ptt_softmax_fwd(const void* x, void* y, int n, int h,
                               int dtype, void* stream) {
  const MaskIndex none = {1, 1, 1, 0, 0, 0, 0, 0};
  return run<false>(x, nullptr, y, n, h, none, dtype, stream);
}

// mask: f32; meta (host memory): d1, d2, d3, s0, s1, s2, s3, sh in
// elements (MaskIndex above).
extern "C" int ptt_softmax_masked_fwd(const void* x, const void* mask,
                                      void* y, int n, int h,
                                      const long long* meta, int dtype,
                                      void* stream) {
  if (meta[0] < 1 || meta[1] < 1 || meta[2] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MaskIndex mi = {meta[0], meta[1], meta[2], meta[3],
                        meta[4], meta[5], meta[6], meta[7]};
  return run<true>(x, static_cast<const float*>(mask), y, n, h, mi, dtype,
                   stream);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
