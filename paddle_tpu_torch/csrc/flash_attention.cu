// Flash attention for Hopper (sm_90a): the forward and its two backward
// kernels, SIMT, f32 accumulation.
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py:
//   flash_fwd     <- _fwd_kernel     (:151)
//   flash_bwd_dq  <- _bwd_dq_kernel  (:245)
//   flash_bwd_dkv <- _bwd_dkv_kernel (:295)
// Same functions over [B*H, T, D] (row-major, contiguous): online-softmax
// attention with o and the per-row logsumexp (lse) out of the forward,
// and the recompute backward p = exp(min(s - lse, 0)),
// ds = p * (do.v^T - delta) * scale, dq = ds.k, dk = ds^T.q, dv = p^T.do,
// with delta = rowsum(do * o) - g_lse computed outside (the lse
// cotangent folds in there, as in the reference).  Causal modes: 0 none,
// 1 causal (col <= row), 2 strict (col < row); a cell that is masked, or
// lies beyond T (the ragged last tile), gets p = 0 exactly, so strict
// mode's row 0 (no valid column) yields o = 0 and lse = -1e29 + log(1e-30)
// (the plain twin's clamp of the row max), not a uniform row.  lse is
// stored flat [B*H, T] f32: the reference's [.., 8] layout was a TPU
// tiling constraint.
//
// Bound: at the training shape (B*H 96, T 1024, D 64, bf16, causal) the
// forward moves ~50 MB and does 4*D flops per unmasked (q, k) pair
// (~12.9 GFLOP); the backward ~6*D (dq) and ~8*D (dk/dv) per pair.  At
// the bf16 tensor-core peak the flops take ~13 us against ~15 us of
// bytes, so on paper the forward sits near the ridge.  These kernels do
// not use the tensor cores: every product is an f32 FMA on the SIMT
// pipes (67 TFLOP/s peak), fed from shared memory, so they are bound by
// shared-memory loads and FMA issue, tens of times above the bound.
// wgmma, TMA and a producer/consumer pipeline are later work.
//
// Design, simple first.  The TPU kernel carried its running max, sum and
// accumulator (m_sc, l_sc, acc_sc, dq_sc, dk_sc) across the sequential
// third grid axis; blocks here run in parallel and in no order, so that
// axis becomes a loop inside one block:
//   forward: one block per (bh, 64-row q-tile), streaming 64-row K/V
//            tiles through shared memory;
//   dq:      one block per (bh, q-tile), looping over k-tiles;
//   dk/dv:   one block per (bh, 64-row k-tile), looping over q-tiles;
// no atomics anywhere.  In causal modes the tiles strictly above the
// diagonal are skipped.  256 threads form a 16 x 16 grid; a thread owns
// rows ty + 16i (i < 4) and columns tx + 16j of each 64 x 64 score tile,
// and head-dim columns tx + 16j (j < D/16) of its accumulators, so a
// row's statistics live in the same 16 lanes of one warp (shuffle
// reductions, no shared memory).  At D = 128 a thread holds at most 32
// (forward, dq) or 64 (dk/dv) f32 accumulators: D is split across the 16
// lanes of a row, never held whole by one thread, which keeps the
// registers from spilling.  Tiles are loaded from bf16 or f32 and kept
// as f32 in shared memory with rows padded to D + 1 (and 64 + 1) floats,
// so that the column-strided reads of the score loops hit 16 distinct
// banks.  Shared memory per block: 4 tiles of 64 x (D+1) plus one or two
// 64 x 65 probability tiles, at most ~166 KB (dk/dv, D = 128), set with
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Limits the wrapper (paddle_tpu_torch/ops/flash_attention.py) enforces:
// contiguous q/k/v/do of one dtype (f32 or bf16), D % 16 == 0 and
// 16 <= D <= 128, any T >= 1, B*H <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;        // rows of a q-tile and of a k-tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxNJ = 8;        // D / 16 <= 8
constexpr int kLdT = kTile + 1;  // padded row of a 64 x 64 tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ bool kept(int row, int col, int tq, int tk,
                                     int causal) {
  if (row >= tq || col >= tk) return false;
  if (causal == 1) return col <= row;
  if (causal == 2) return col < row;
  return true;
}

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of a [n, d] matrix into dst (row stride ld),
// as f32; rows at or beyond n are zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                          int row0, int n, int d) {
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < n ? to_f32(src[static_cast<size_t>(gr) * d + c])
                             : 0.f;
  }
}

// 64 values of a per-row f32 vector; 0 beyond n
__device__ void load_rows(float* dst, const float* __restrict__ src,
                          int row0, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < n ? src[row0 + r] : 0.f;
}

// number of k-tiles a q-tile starting at q0 visits: all of them, or in
// causal modes those with k0 <= q0 + 63 (the reference's skip rule)
__device__ __forceinline__ int k_tiles(int q0, int tk, int causal) {
  const int n = (tk + kTile - 1) / kTile;
  return causal ? min(n, (q0 + kTile - 1) / kTile + 1) : n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int tq, int tk, int d, float scale,
              int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;             // [64][d+1]
  float* Ks = Qs + kTile * ld;  // [64][d+1]
  float* Vs = Ks + kTile * ld;  // [64][d+1]
  float* Ps = Vs + kTile * ld;  // [64][65]

  const int nj = d >> 4;
  const int bh = blockIdx.y;
  // heaviest causal q-tiles (most k-tiles) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* qb = q + static_cast<size_t>(bh) * tq * d;
  const T* kb = k + static_cast<size_t>(bh) * tk * d;
  const T* vb = v + static_cast<size_t>(bh) * tk * d;

  load_tile(Qs, ld, qb, q0, tq, d);

  float m[4], l[4], acc[4][kMaxNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) acc[i][j] = 0.f;
  }

  const int nkt = k_tiles(q0, tk, causal);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    load_tile(Ks, ld, kb, k0, tk, d);
    load_tile(Vs, ld, vb, k0, tk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = kept(row, col, tq, tk, causal) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            s[i][j] <= 0.5f * kNegInf ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdT + tx + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kLdT + c];
#pragma unroll
      for (int j = 0; j < kMaxNJ; ++j) {
        if (j < nj) {
          const float vv = Vs[c * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * tq + row) * d;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j)
      if (j < nj) store(orow + tx + 16 * j, acc[i][j] / safe_l);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * tq + row] =
          fmaxf(m[i], -1e29f) + logf(safe_l);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int tq,
                 int tk, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;              // [64][d+1]
  float* dOs = Qs + kTile * ld;  // [64][d+1]
  float* Ks = dOs + kTile * ld;  // [64][d+1]
  float* Vs = Ks + kTile * ld;   // [64][d+1]
  float* dSs = Vs + kTile * ld;  // [64][65]

  const int nj = d >> 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t qoff = static_cast<size_t>(bh) * tq * d;
  const size_t koff = static_cast<size_t>(bh) * tk * d;

  load_tile(Qs, ld, q + qoff, q0, tq, d);
  load_tile(dOs, ld, dout + qoff, q0, tq, d);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = static_cast<size_t>(bh) * tq + row;
    lse_r[i] = row < tq ? lse[at] : 0.f;
    delta_r[i] = row < tq ? delta[at] : 0.f;
  }
  float acc[4][kMaxNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) acc[i][j] = 0.f;

  const int nkt = k_tiles(q0, tk, causal);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, ld, k + koff, k0, tk, d);
    load_tile(Vs, ld, v + koff, k0, tk, d);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * ld + c];
        g[i] = dOs[(ty + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * ld + c];
        w[j] = Vs[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kept(row, col, tq, tk, causal)) {
          const float p = expf(fminf(s[i][j] * scale - lse_r[i], 0.f));
          ds = p * (dp[i][j] - delta_r[i]) * scale;
        }
        dSs[(ty + 16 * i) * kLdT + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ty + 16 * i) * kLdT + c];
#pragma unroll
      for (int j = 0; j < kMaxNJ; ++j) {
        if (j < nj) {
          const float kk = Ks[c * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kk, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    T* out = dq + qoff + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j)
      if (j < nj) store(out + tx + 16 * j, acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int tq, int tk, int d, float scale,
                  int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Ks = smem;               // [64][d+1]
  float* Vs = Ks + kTile * ld;    // [64][d+1]
  float* Qs = Vs + kTile * ld;    // [64][d+1]
  float* dOs = Qs + kTile * ld;   // [64][d+1]
  float* Ps = dOs + kTile * ld;   // [64 k][65]
  float* dSs = Ps + kTile * kLdT; // [64 k][65]
  float* lse_s = dSs + kTile * kLdT;  // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int nj = d >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t qoff = static_cast<size_t>(bh) * tq * d;
  const size_t koff = static_cast<size_t>(bh) * tk * d;
  const float* lse_b = lse + static_cast<size_t>(bh) * tq;
  const float* delta_b = delta + static_cast<size_t>(bh) * tq;

  load_tile(Ks, ld, k + koff, k0, tk, d);
  load_tile(Vs, ld, v + koff, k0, tk, d);
  // thread rows are k positions k0 + ty + 16i, its tile columns q
  // positions q0 + tx + 16j
  float dk_acc[4][kMaxNJ], dv_acc[4][kMaxNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nqt = (tq + kTile - 1) / kTile;
  // causal: q-tiles whose last row lies above k0 see only masked cells
  const int qt0 = causal ? min(nqt, k0 / kTile) : 0;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(Qs, ld, q + qoff, q0, tq, d);
    load_tile(dOs, ld, dout + qoff, q0, tq, d);
    load_rows(lse_s, lse_b, q0, tq);
    load_rows(delta_s, delta_b, q0, tq);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty + 16 * i) * ld + c];
        w[i] = Vs[(ty + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Qs[(tx + 16 * j) * ld + c];
        g[j] = dOs[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (kept(q0 + r, col, tq, tk, causal)) {
          p = expf(fminf(s[i][j] * scale - lse_s[r], 0.f));
          ds = p * (dp[i][j] - delta_s[r]) * scale;
        }
        Ps[(ty + 16 * i) * kLdT + r] = p;
        dSs[(ty + 16 * i) * kLdT + r] = ds;
      }
    }
    __syncthreads();

    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[(ty + 16 * i) * kLdT + r];
        ds[i] = dSs[(ty + 16 * i) * kLdT + r];
      }
#pragma unroll
      for (int j = 0; j < kMaxNJ; ++j) {
        if (j < nj) {
          const float g = dOs[r * ld + tx + 16 * j];
          const float a = Qs[r * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(p[i], g, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], a, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= tk) continue;
    T* dkr = dk + koff + static_cast<size_t>(col) * d;
    T* dvr = dv + koff + static_cast<size_t>(col) * d;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) {
      if (j < nj) {
        store(dkr + tx + 16 * j, dk_acc[i][j]);
        store(dvr + tx + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

bool bad_shape(int bh, int tq, int tk, int d, int causal, int dtype) {
  return bh < 0 || bh > 65535 || tq < 0 || tk < 0 || d < 16 || d > 128 ||
         d % 16 != 0 || causal < 0 || causal > 2 || dtype < 0 || dtype > 1;
}

size_t tiles_bytes(int d, int n_tiles, int n_prob) {
  return sizeof(float) *
         (static_cast<size_t>(n_tiles) * kTile * (d + 1) +
          static_cast<size_t>(n_prob) * kTile * kLdT);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int bh, int tq, int tk, int d, float scale, int causal,
        cudaStream_t s) {
  const size_t smem = tiles_bytes(d, 3, 1);
  cudaError_t err = prepare(flash_fwd<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tq + kTile - 1) / kTile, bh);
  flash_fwd<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int tq,
           int tk, int d, float scale, int causal, cudaStream_t s) {
  const size_t smem = tiles_bytes(d, 4, 1);
  cudaError_t err = prepare(flash_bwd_dq<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tq + kTile - 1) / kTile, bh);
  flash_bwd_dq<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int tq, int tk, int d, float scale, int causal,
            cudaStream_t s) {
  const size_t smem = tiles_bytes(d, 4, 2) + 2 * kTile * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dkv<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tk + kTile - 1) / kTile, bh);
  flash_bwd_dkv<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 none, 1 causal, 2 strict.
// Each returns cudaGetLastError() after its launch (0: queued).
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  if (bad_shape(bh, tq, tk, d, causal, dtype) || tk == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? fwd<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s)
             : fwd<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                  causal, s);
}

extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
    int d, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(bh, tq, tk, d, causal, dtype) || tk == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_dq<float>(q, k, v, dout, lse, delta, dq, bh, tq,
                                    tk, d, scale, causal, s)
                    : bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq,
                                            bh, tq, tk, d, scale, causal, s);
}

extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(bh, tq, tk, d, causal, dtype) || tq == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tk == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                              d, scale, causal, s)
             : bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      tq, tk, d, scale, causal, s);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
