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
// bytes and does ~4 flops per element, so it is bound by bytes at 3.35
// TB/s on an H100 SXM: GPT-2 small's attention scores [2*12*1024, 1024]
// f32 are 201 MB, 60 us; BERT-base's [64*12*128, 128] f32 100.7 MB, 30 us.
//
// Designs (the wrapper picks one per launch and names it; the entry
// points refuse a design the row does not fit):
//  - vec (h <= 1024, h * sizeof(T) % 16 == 0, x and y on 16 bytes):
//    LANES threads take a row (the next power of two to h's 16-byte
//    vectors, at most 32; so 32 / LANES rows a warp) and each holds NV
//    vectors of 16 bytes (4 f32 or 8 bf16/f16), vector j * LANES + lane,
//    so a warp's loads are consecutive 16-byte pieces.  A 1024-column f32
//    row is 8 loads and 8 stores of 16 bytes a lane, all loads in flight
//    before the first use, and 32 f32 values a lane in registers.
//  - scalar (h <= 512, any alignment): one warp a row, element
//    c = 32 * i + lane, one 2- or 4-byte load and store each (at 32
//    values a lane the 16-bit types spilled, so longer rows that the vec
//    design does not take go to the block design).
//  - block (any other row: h > 1024, or h > 512 off the vec design's
//    alignment): one 256-thread block a row, two passes over the
//    row (a running (max, sum), then the write), 16-byte loads where the
//    row and pointers allow; the per-thread (max, sum) pairs are combined
//    by shuffles and then by thread 0 over the warps in a fixed order.
// Arithmetic, every design: e = exp2f((t - max) * log2(e)), one
// reciprocal r = 1 / sum a row, y = e * r (tests/test_torch_fused_softmax.py
// replays it on the CPU, the sum in the vec and scalar designs' order).
// Sums are __shfl_xor_sync butterflies: no atomics, so a launch repeats
// bit for bit.  Rows are independent, so nothing carries between blocks
// (the TPU's sequential row-block grid has no counterpart), and the
// TPU's h % 128 and row-block gates do not apply.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;        // every design's block
constexpr int kMaxVecRow = 1024;     // the vec design's longest row
constexpr int kMaxScalarRow = 512;   // the scalar design's
constexpr float kLog2e = 1.4426950408889634f;

// the designs, as ops/fused_softmax.py's VARIANTS orders them
constexpr int kVec = 0;
constexpr int kScalar = 1;
constexpr int kBlock = 2;

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

__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 to_f32x2(__half2 v) {
  return __half22float2(v);
}
__device__ __forceinline__ void pack2(__nv_bfloat162* p, float a, float b) {
  *p = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void pack2(__half2* p, float a, float b) {
  *p = __floats2half2_rn(a, b);
}

// 16 bytes of T <-> kN f32 values
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&v)[kN]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void save(float* p, const float (&v)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// bf16 and f16: eight values, T2 the type of a pair
template <typename T, typename T2>
struct Pack16 {
  static constexpr int kN = 8;
  __device__ static void load(const T* p, float (&v)[kN]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    T2 h[4];
    memcpy(h, &t, sizeof(t));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = to_f32x2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void save(T* p, const float (&v)[kN]) {
    T2 h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) pack2(&h[k], v[2 * k], v[2 * k + 1]);
    uint4 t;
    memcpy(&t, h, sizeof(t));
    *reinterpret_cast<uint4*>(p) = t;
  }
};

template <>
struct Pack<__nv_bfloat16> : Pack16<__nv_bfloat16, __nv_bfloat162> {};
template <>
struct Pack<__half> : Pack16<__half, __half2> {};

// rows and the mask's dims are below 2^31 (the wrapper checks n), so the
// row's split into (i0, i1, i2, i3) takes 32-bit divisions
__device__ __forceinline__ const float* mask_row(const float* mask,
                                                 const MaskIndex& mi,
                                                 long long row) {
  unsigned r = static_cast<unsigned>(row);
  const unsigned d3 = static_cast<unsigned>(mi.d3);
  const unsigned d2 = static_cast<unsigned>(mi.d2);
  const unsigned d1 = static_cast<unsigned>(mi.d1);
  const unsigned i3 = r % d3;
  r /= d3;
  const unsigned i2 = r % d2;
  r /= d2;
  const unsigned i1 = r % d1;
  r /= d1;
  return mask + r * mi.s0 + i1 * mi.s1 + i2 * mi.s2 + i3 * mi.s3;
}

// max and sum over the LANES lanes of a row's group (xor offsets below
// LANES stay inside it; every lane of the warp takes part)
template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float exp2_scaled(float t, float m) {
  return exp2f((t - m) * kLog2e);
}

// (m, s) <- the running (max, sum of exp(t - max)) of both halves
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) {
    s = 0.f;
  } else {
    s = s * exp2_scaled(m, mx) + s2 * exp2_scaled(m2, mx);
  }
  m = mx;
}

// (m, s) <- (m, s) with K more values v folded in
template <int K>
__device__ __forceinline__ void absorb(float& m, float& s,
                                       const float (&v)[K]) {
  float mx = m;
#pragma unroll
  for (int k = 0; k < K; ++k) mx = fmaxf(mx, v[k]);
  if (mx == -INFINITY) return;
  float t = s * exp2_scaled(m, mx);
#pragma unroll
  for (int k = 0; k < K; ++k) t += exp2_scaled(v[k], mx);
  m = mx;
  s = t;
}

template <typename T, int NV, int LANES, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    softmax_vec(const T* __restrict__ x, const float* __restrict__ mask,
                T* __restrict__ y, int n, int h, MaskIndex mi) {
  constexpr int VW = Pack<T>::kN;
  const int lane = threadIdx.x & (LANES - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / LANES) +
      threadIdx.x / LANES;
  // no early return: every lane of the warp takes part in the shuffles
  const bool live = row < n;
  const int nvec = h / VW;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * h;
  T* yr = y + static_cast<size_t>(live ? row : 0) * h;
  const float* mr = MASKED ? mask_row(mask, mi, live ? row : 0) : nullptr;

  float v[NV][VW];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = j * LANES + lane;
    if (live && q < nvec) Pack<T>::load(xr + q * VW, v[j]);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = j * LANES + lane;
    if (live && q < nvec) {
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        if (MASKED) v[j][k] += mr[static_cast<long long>(q * VW + k) * mi.sh];
        m = fmaxf(m, v[j][k]);
      }
    }
  }
  m = group_max<LANES>(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (live && j * LANES + lane < nvec) {
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        v[j][k] = exp2_scaled(v[j][k], m);
        s += v[j][k];
      }
    }
  }
  const float r = 1.f / group_sum<LANES>(s);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = j * LANES + lane;
    if (live && q < nvec) {
#pragma unroll
      for (int k = 0; k < VW; ++k) v[j][k] *= r;
      Pack<T>::save(yr + q * VW, v[j]);
    }
  }
}

template <typename T, int NV, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    softmax_scalar(const T* __restrict__ x, const float* __restrict__ mask,
                   T* __restrict__ y, int n, int h, MaskIndex mi) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: one row a warp
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
      if (MASKED) t += mr[static_cast<long long>(c) * mi.sh];
      v[i] = t;
      m = fmaxf(m, t);
    }
  }
  m = group_max<32>(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < h) {
      v[i] = exp2_scaled(v[i], m);
      s += v[i];
    }
  }
  const float r = 1.f / group_sum<32>(s);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < h) store(yr + c, v[i] * r);
  }
}

template <typename T, bool VEC, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    softmax_block(const T* __restrict__ x, const float* __restrict__ mask,
                  T* __restrict__ y, int h, MaskIndex mi) {
  constexpr int VW = Pack<T>::kN;
  __shared__ float sm[kThreads / 32];
  __shared__ float ss[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * h;
  T* yr = y + static_cast<size_t>(row) * h;
  const float* mr = MASKED ? mask_row(mask, mi, row) : nullptr;
  const int nvec = h / VW;

  // pass 1: each thread's running (max, sum) over its columns
  float m = -INFINITY, s = 0.f;
  if (VEC) {
    for (int q = threadIdx.x; q < nvec; q += kThreads) {
      float v[VW];
      Pack<T>::load(xr + q * VW, v);
      if (MASKED) {
#pragma unroll
        for (int k = 0; k < VW; ++k)
          v[k] += mr[static_cast<long long>(q * VW + k) * mi.sh];
      }
      absorb(m, s, v);
    }
  } else {
    for (int c = threadIdx.x; c < h; c += kThreads) {
      float v[1] = {to_f32(xr[c])};
      if (MASKED) v[0] += mr[static_cast<long long>(c) * mi.sh];
      absorb(m, s, v);
    }
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
    for (int w = 1; w < kThreads / 32; ++w) combine(m, s, sm[w], ss[w]);
    sm[0] = m;
    ss[0] = s;
  }
  __syncthreads();
  m = sm[0];
  const float r = 1.f / ss[0];

  // pass 2: the row again, normalised
  if (VEC) {
    for (int q = threadIdx.x; q < nvec; q += kThreads) {
      float v[VW];
      Pack<T>::load(xr + q * VW, v);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        float t = v[k];
        if (MASKED) t += mr[static_cast<long long>(q * VW + k) * mi.sh];
        v[k] = exp2_scaled(t, m) * r;
      }
      Pack<T>::save(yr + q * VW, v);
    }
  } else {
    for (int c = threadIdx.x; c < h; c += kThreads) {
      float t = to_f32(xr[c]);
      if (MASKED) t += mr[static_cast<long long>(c) * mi.sh];
      store(yr + c, exp2_scaled(t, m) * r);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool MASKED>
void launch_vec(const T* x, const float* mask, T* y, int n, int h,
                const MaskIndex& mi, cudaStream_t stream) {
  const int nvec = h / Pack<T>::kN;
  int lanes = 1;
  while (lanes < 32 && lanes < nvec) lanes <<= 1;
  const int rows = kThreads / lanes;  // a block's
  const dim3 grid((n + rows - 1) / rows);
#define PTT_SM_VEC(NV, LANES)                                           \
  softmax_vec<T, NV, LANES, MASKED>                                     \
      <<<grid, kThreads, 0, stream>>>(x, mask, y, n, h, mi)
  switch (lanes) {
    case 1: PTT_SM_VEC(1, 1); return;
    case 2: PTT_SM_VEC(1, 2); return;
    case 4: PTT_SM_VEC(1, 4); return;
    case 8: PTT_SM_VEC(1, 8); return;
    case 16: PTT_SM_VEC(1, 16); return;
    default: break;
  }
  const int need = (nvec + 31) / 32;  // vectors a lane
  if (need <= 1) {
    PTT_SM_VEC(1, 32);
  } else if (need <= 2) {
    PTT_SM_VEC(2, 32);
  } else if (need <= 4) {
    PTT_SM_VEC(4, 32);
  } else {
    PTT_SM_VEC(8, 32);
  }
#undef PTT_SM_VEC
}

template <typename T, bool MASKED>
void launch_scalar(const T* x, const float* mask, T* y, int n, int h,
                   const MaskIndex& mi, cudaStream_t stream) {
  const int need = (h + 31) / 32;  // values per lane
  const dim3 grid((n + kThreads / 32 - 1) / (kThreads / 32));
#define PTT_SM_CASE(NV)                                                  \
  if (need <= NV) {                                                      \
    softmax_scalar<T, NV, MASKED>                                        \
        <<<grid, kThreads, 0, stream>>>(x, mask, y, n, h, mi);           \
    return;                                                              \
  }
  PTT_SM_CASE(1)
  PTT_SM_CASE(2)
  PTT_SM_CASE(4)
  PTT_SM_CASE(8)
  PTT_SM_CASE(16)
#undef PTT_SM_CASE
}

// queues the named design; false if the row does not fit it
template <typename T, bool MASKED>
bool launch(const void* x, const float* mask, void* y, int n, int h,
            const MaskIndex& mi, int design, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool vec_ok = h % Pack<T>::kN == 0 && aligned16(x) && aligned16(y);
  if (design == kBlock) {
    if (h <= kMaxScalarRow) return false;
    if (vec_ok) {
      softmax_block<T, true, MASKED>
          <<<n, kThreads, 0, stream>>>(xt, mask, yt, h, mi);
    } else {
      softmax_block<T, false, MASKED>
          <<<n, kThreads, 0, stream>>>(xt, mask, yt, h, mi);
    }
    return true;
  }
  if (design == kVec) {
    if (!vec_ok || h > kMaxVecRow) return false;
    launch_vec<T, MASKED>(xt, mask, yt, n, h, mi, stream);
    return true;
  }
  if (design != kScalar || h > kMaxScalarRow) return false;
  launch_scalar<T, MASKED>(xt, mask, yt, n, h, mi, stream);
  return true;
}

template <bool MASKED>
int run(const void* x, const float* mask, void* y, int n, int h,
        const MaskIndex& mi, int dtype, int design, void* stream) {
  if (n < 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = launch<float, MASKED>(x, mask, y, n, h, mi, design, s);
  } else if (dtype == 1) {
    ok = launch<__nv_bfloat16, MASKED>(x, mask, y, n, h, mi, design, s);
  } else if (dtype == 2) {
    ok = launch<__half, MASKED>(x, mask, y, n, h, mi, design, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and y); design: 0 =
// vec, 1 = scalar, 2 = block (header).  Returns cudaGetLastError() after
// the launch, 0 meaning it was queued, or cudaErrorInvalidValue for a
// dtype or design the row does not fit.
extern "C" int ptt_softmax_fwd(const void* x, void* y, int n, int h,
                               int dtype, int design, void* stream) {
  const MaskIndex none = {1, 1, 1, 0, 0, 0, 0, 0};
  return run<false>(x, nullptr, y, n, h, none, dtype, design, stream);
}

// mask: f32; meta (host memory): d1, d2, d3, s0, s1, s2, s3, sh in
// elements (MaskIndex above).
extern "C" int ptt_softmax_masked_fwd(const void* x, const void* mask,
                                      void* y, int n, int h,
                                      const long long* meta, int dtype,
                                      int design, void* stream) {
  if (meta[0] < 1 || meta[1] < 1 || meta[2] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MaskIndex mi = {meta[0], meta[1], meta[2], meta[3],
                        meta[4], meta[5], meta[6], meta[7]};
  return run<true>(x, static_cast<const float*>(mask), y, n, h, mi, dtype,
                   design, stream);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
