// Flash attention for Hopper (sm_90a): the forward and its two backward
// kernels.
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py:
//   flash_fwd_mma, flash_fwd         <- _fwd_kernel     (:151)
//   flash_bwd_dq_mma, flash_bwd_dq   <- _bwd_dq_kernel  (:245)
//   flash_bwd_dkv_mma, flash_bwd_dkv <- _bwd_dkv_kernel (:295)
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
// tiling constraint.  The TPU kernel carried its running max, sum and
// accumulators (m_sc, l_sc, acc_sc, dq_sc, dk_sc) across the sequential
// third grid axis; blocks here run in parallel and in no order, so that
// axis is a loop inside one block, and no kernel uses atomics: a launch
// is deterministic.  In causal modes the tiles strictly above the
// diagonal are skipped, and the heaviest tiles are launched first.  B*H
// is the grid's y axis, which holds 65535 blocks: the entry points launch
// larger B*H in chunks of 65535 heads, every pointer offset per chunk.
//
// Bound: at the training shape (B*H 96, T 1024, D 64, bf16, causal) the
// forward moves ~50 MB and does 4*D flops per unmasked (q, k) pair
// (~12.9 GFLOP); dq ~6*D and dk/dv ~8*D per pair.  At the bf16
// tensor-core peak (989 TFLOP/s) the forward's flops take ~13 us against
// ~15 us of bytes (near the ridge), dq's ~20 us and dk/dv's ~26 us
// against ~20 us: all are bound by the tensor cores and by feeding them,
// not by HBM.
//
// 16-bit inputs (bf16 or f16; the element type T is a template parameter
// of each design): tensor cores.  Every product is mma.sync.m16n8k16
// (T operands, f32 accumulators in registers; hopper_mma.cuh has the
// fragment layouts, which the two types share).  Tiles live in shared
// memory as T, rows padded by 16 bytes (row stride D + 8 elements, an odd
// multiple of 16 bytes modulo 128), so that the 8 row addresses of each
// ldmatrix hit 8 distinct groups of 4 banks: no conflicts for any D.
// Loads are cp.async (16 bytes a thread, rows beyond T and columns beyond
// D zero-filled through the src-size operand), double-buffered: the copy
// of tile i+1 is issued before the math on tile i.  4 warps, each owning
// 16 rows of the block's tile.
//   forward (flash_fwd_mma): one block per (bh, 64-row q-tile), heaviest
//     causal tiles first; Q's A fragments stay in registers for the whole
//     loop over 64-key K/V tiles; S = Q.K^T lands in accumulator
//     fragments, the online max and sum run on them (exp2 with log2(e)
//     folded into the scale; the row's max combined by __shfl_xor_sync
//     over the quad of lanes that shares it, the sum kept per lane until
//     the end), and P, rounded to T in registers, is the A operand of P.V
//     (ldmatrix .trans on V).  The mask is applied only on tiles that
//     straddle the diagonal or the ragged edge.  (128-row q-tiles, 4 warps
//     of two m16 tiles each, reuse every K/V fragment twice but need 248
//     registers at D = 64: 2 blocks an SM, and 28% slower on the card;
//     over 8 warps at D = 128 the 128-register cap spills.)
//   dq (flash_bwd_dq_mma): the forward's shape.  One block per (bh,
//     64-row q-tile), heaviest causal tiles first; the warp's Q and dO A
//     fragments and its rows' lse and delta stay in registers for the
//     whole loop, while 64-key (D <= 64) or 32-key (D > 64, to bound the
//     registers) K/V tiles stream past.  S = Q.K^T and dP = dO.V^T come
//     out in accumulator fragments (K and V as non-transposed B operands,
//     as K is in the forward's S); P = exp2(min(S * scale * log2(e) -
//     lse * log2(e), 0)) and dS = P o (dP - delta) * scale are formed on
//     them, masked (columns >= T and causal cells) on every tile that
//     straddles the diagonal or the ragged edge, and dS, rounded to T in
//     registers, is the A operand of dQ += dS.K (ldmatrix .trans on K, as
//     the forward reads V).  dQ is written once, in T.  Rows >= T of the
//     last q-tile read zero-filled Q and dO and lse = delta = 0, so their
//     dS is 0; they are not written.
//   dk/dv (flash_bwd_dkv_mma): one block per (bh, 64-key k-tile); K and V
//     stay resident in shared memory while 64-row (D <= 64) or 32-row
//     (D > 64, to bound the registers) Q/dO tiles stream past with their
//     lse and delta rows.  S^T = K.Q^T and dP^T = V.dO^T come out indexed
//     by key, so P^T and dS^T = P^T o (dP^T - delta) * scale are formed in
//     registers, rounded to T, and fed as A operands to dV += P^T.dO and
//     dK += dS^T.Q (ldmatrix.trans on dO and Q).  dK and dV are written
//     once, in T.
// Rounding P and dS to the input type for the second products is what the
// TPU kernels do too: their f32 dot_general at default precision rounds
// the operands to bf16 on the matrix unit.  D is a template parameter (32,
// 64, 128): a D of 16, 48, 80, 96 or 112 runs in the next instantiation
// up, its extra columns zero-filled.  Shared memory per block: forward
// (64 + 4 * 64) rows, dq (2 * 64 + 4 * BK) rows, dk/dv (2 * 64 + 4 * BQ)
// rows of D + 8 elements, plus 4 * BQ floats for dk/dv: at most ~85 KB
// (forward, D = 128), set with cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// f32 inputs (flash_fwd, flash_bwd_dq, flash_bwd_dkv): SIMT, every
// product an f32 FMA (67 TFLOP/s peak), kept for f32 accuracy (the f32
// parity runs hold 1e-5; TF32 would not).  forward and dq: one block per
// (bh, 64-row q-tile) looping over k-tiles; dk/dv: one block per (bh,
// 64-row k-tile) looping over q-tiles.  256 threads form a 16 x 16 grid; a
// thread owns rows ty + 16i (i < 4) and columns tx + 16j of each 64 x 64
// score tile, and head-dim columns tx + 16j (j < D/16) of its
// accumulators, so a row's statistics live in the same 16 lanes of one
// warp (shuffle reductions, no shared memory).  At D = 128 a thread holds
// at most 32 (forward, dq) or 64 (dk/dv) f32 accumulators: D is split
// across the 16 lanes of a row, never held whole by one thread, which
// keeps the registers from spilling.  Tiles are kept as f32 in shared
// memory with rows padded to D + 1 (and 64 + 1) floats, so that the
// column-strided reads of the score loops hit 16 distinct banks.  Shared
// memory per block: 4 tiles of 64 x (D+1) plus one or two 64 x 65
// probability tiles, at most ~166 KB (dk/dv, D = 128).  These are bound
// by shared-memory loads and FMA issue, tens of times above the bound.
//
// Limits the wrapper (paddle_tpu_torch/ops/flash_attention.py) enforces:
// contiguous q/k/v/do of one dtype (f32, bf16 or f16), 16-bit ones 16-byte
// aligned, D % 16 == 0 and 16 <= D <= 128, any T >= 1, any B*H.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kTile = 64;        // rows of a q-tile and of a k-tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxNJ = 8;        // D / 16 <= 8
constexpr int kLdT = kTile + 1;  // padded row of a 64 x 64 tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---- 16-bit inputs on the tensor cores: flash_fwd_mma,
// ---- flash_bwd_dq_mma, flash_bwd_dkv_mma

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
// rows of a block's own tile, 16 per warp: the forward's and dq's q-tile,
// dk/dv's k-tile
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMmaKeys = 64;  // keys of a forward K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// q rows of a dk/dv Q/dO tile: above D = 64, 32 rows keep S^T and dP^T
// (BQ / 2 floats a lane each) in registers beside dK and dV (D / 2 each)
template <int DP>
__host__ __device__ constexpr int dkv_q_rows() {
  return DP <= 64 ? 64 : 32;
}

// keys of a dq K/V tile: above D = 64, 32 keys keep S and dP (BK / 2
// floats a lane each) in registers beside the resident Q and dO fragments
// (D / 4 each) and the dQ accumulators (D / 2)
template <int DP>
__host__ __device__ constexpr int dq_k_keys() {
  return DP <= 64 ? 64 : 32;
}

// rows [row0, row0 + ROWS) of a [n, d] 16-bit matrix into a shared tile
// of DP + 8 elements a row, asynchronously; rows >= n and columns >= d
// are zero-filled (src-size 0), nothing past them is read
template <int ROWS, int DP, typename T>
__device__ __forceinline__ void load_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int n, int d) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  static_assert(ROWS * kChunks % kMmaThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks;
    const int c = e % kChunks * 8;
    const bool in = row0 + r < n && c < d;
    hopper::cp_async16(dst + r * (DP + 8) + c,
                       in ? src + static_cast<size_t>(row0 + r) * d + c : src,
                       in ? 16 : 0);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int tq, int tk, int d, float scale,
                  int causal) {
  constexpr int LD = DP + 8;
  constexpr int NT = kMmaKeys / 8;  // n8 tiles of a warp's score rows
  constexpr int DT = DP / 8;        // n8 tiles of a warp's output rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kMmaRows][LD]
  T* Ks = Qs + kMmaRows * LD;              // [2][kMmaKeys][LD]
  T* Vs = Ks + 2 * kMmaKeys * LD;          // [2][kMmaKeys][LD]

  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int bh = blockIdx.y;
  // heaviest causal q-tiles (most k-tiles) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const T* qb = q + static_cast<size_t>(bh) * tq * d;
  const T* kb = k + static_cast<size_t>(bh) * tk * d;
  const T* vb = v + static_cast<size_t>(bh) * tk * d;
  // all k-tiles, or in causal modes those with k0 <= the tile's last row
  const int nkt = causal ? min(ceil_div(tk, kMmaKeys),
                               (q0 + kMmaRows - 1) / kMmaKeys + 1)
                         : ceil_div(tk, kMmaKeys);

  load_tile_async<kMmaRows, DP>(Qs, qb, q0, tq, d);
  load_tile_async<kMmaKeys, DP>(Ks, kb, 0, tk, d);
  load_tile_async<kMmaKeys, DP>(Vs, vb, 0, tk, d);
  hopper::cp_async_commit();

  uint32_t qf[DP / 16][4];  // the warp's 16 Q rows as A fragments
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (log2 domain) and this lane's share of the running sum,
  // for the lane's rows g and g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {  // the next tile's copy overlaps this tile's math
      const int nb = (kt + 1) & 1;
      load_tile_async<kMmaKeys, DP>(Ks + nb * kMmaKeys * LD, kb,
                                    (kt + 1) * kMmaKeys, tk, d);
      load_tile_async<kMmaKeys, DP>(Vs + nb * kMmaKeys * LD, vb,
                                    (kt + 1) * kMmaKeys, tk, d);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::ldsm_x4(qf[kk], Qs + hopper::a_operand(lane, wrow, kk * 16,
                                                       LD));
    }
    const T* Kt = Ks + (kt & 1) * kMmaKeys * LD;
    const T* Vt = Vs + (kt & 1) * kMmaKeys * LD;

    // S = Q.K^T for the warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        hopper::ldsm_x4(b, Kt + hopper::b_operand(lane, j * 8, kk * 16, LD));
        hopper::mma<T>(s[j], qf[kk], b[0], b[1]);
        hopper::mma<T>(s[j + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale into the log2 domain; mask only a tile that straddles the
    // diagonal or the ragged edge
    const int k0 = kt * kMmaKeys;
    const bool edge =
        k0 + kMmaKeys > tk || (causal && k0 + kMmaKeys - 1 >= q0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sl2;
        if (edge && !kept(q0 + wrow + hopper::acc_row(lane, e),
                          k0 + j * 8 + hopper::acc_col(lane, e), tq, tk,
                          causal))
          s[j][e] = kNegInf;
      }

    // online softmax: a row's max over the quad of lanes that holds it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[h] - mx);
      m[h] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p =
              s[j][e] <= 0.5f * kNegInf ? 0.f : exp2f(s[j][e] - mx);
          s[j][e] = p;
          rs += p;
        }
      l[h] = alpha * l[h] + rs;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // acc += P.V, P rounded to T in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      hopper::frag_a_from_acc<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t b[4];
        hopper::ldsm_x4_trans(b, Vt + hopper::b_trans(lane, kk * 16, n * 8,
                                                      LD));
        hopper::mma<T>(acc[n], a, b[0], b[1]);
        hopper::mma<T>(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile kt + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + wrow + (lane >> 2) + 8 * h;
    if (row >= tq) continue;
    const float safe_l = fmaxf(sum, 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * tq + row) * d;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      if (col < d)
        *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack2<T>(
            acc[n][2 * h] / safe_l, acc[n][2 * h + 1] / safe_l);
    }
    if ((lane & 3) == 0)
      lse[static_cast<size_t>(bh) * tq + row] =
          fmaxf(m[h] * kLn2, -1e29f) + logf(safe_l);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int tq, int tk, int d, float scale, int causal) {
  constexpr int LD = DP + 8;
  constexpr int BK = dq_k_keys<DP>();
  constexpr int NT = BK / 8;  // n8 tiles of a warp's score rows
  constexpr int DT = DP / 8;  // n8 tiles of a warp's dQ rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kMmaRows][LD]
  T* dOs = Qs + kMmaRows * LD;             // [kMmaRows][LD]
  T* Ks = dOs + kMmaRows * LD;             // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int bh = blockIdx.y;
  // heaviest causal q-tiles (most k-tiles) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const size_t qoff = static_cast<size_t>(bh) * tq * d;
  const T* kb = k + static_cast<size_t>(bh) * tk * d;
  const T* vb = v + static_cast<size_t>(bh) * tk * d;
  // all k-tiles, or in causal modes those with k0 <= the tile's last row
  const int nkt = causal ? min(ceil_div(tk, BK), (q0 + kMmaRows - 1) / BK + 1)
                         : ceil_div(tk, BK);

  load_tile_async<kMmaRows, DP>(Qs, q + qoff, q0, tq, d);
  load_tile_async<kMmaRows, DP>(dOs, dout + qoff, q0, tq, d);
  load_tile_async<BK, DP>(Ks, kb, 0, tk, d);
  load_tile_async<BK, DP>(Vs, vb, 0, tk, d);
  hopper::cp_async_commit();

  // the lane's rows g and g + 8: -lse in the log2 domain, and delta;
  // rows past tq read 0 (their Q and dO rows are zero-filled, so dS = 0)
  float nl2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + (lane >> 2) + 8 * h;
    const size_t at = static_cast<size_t>(bh) * tq + row;
    nl2[h] = row < tq ? -lse[at] * kLog2e : 0.f;
    dl[h] = row < tq ? delta[at] : 0.f;
  }
  uint32_t qf[DP / 16][4], of[DP / 16][4];  // the warp's Q and dO rows
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {  // the next tile's copy overlaps this tile's math
      const int nb = (kt + 1) & 1;
      load_tile_async<BK, DP>(Ks + nb * BK * LD, kb, (kt + 1) * BK, tk, d);
      load_tile_async<BK, DP>(Vs + nb * BK * LD, vb, (kt + 1) * BK, tk, d);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        hopper::ldsm_x4(qf[kk], Qs + hopper::a_operand(lane, wrow, kk * 16,
                                                       LD));
        hopper::ldsm_x4(of[kk], dOs + hopper::a_operand(lane, wrow, kk * 16,
                                                        LD));
      }
    }
    const T* Kt = Ks + (kt & 1) * BK * LD;
    const T* Vt = Vs + (kt & 1) * BK * LD;

    // S = Q.K^T and dP = dO.V^T for the warp's 16 rows and the tile's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        hopper::ldsm_x4(b, Kt + hopper::b_operand(lane, j * 8, kk * 16, LD));
        hopper::mma<T>(s[j], qf[kk], b[0], b[1]);
        hopper::mma<T>(s[j + 1], qf[kk], b[2], b[3]);
        hopper::ldsm_x4(b, Vt + hopper::b_operand(lane, j * 8, kk * 16, LD));
        hopper::mma<T>(dp[j], of[kk], b[0], b[1]);
        hopper::mma<T>(dp[j + 1], of[kk], b[2], b[3]);
      }
    }

    // P and dS in place of dP; the mask only on a tile that straddles the
    // diagonal or the ragged edge (zero-filled keys past tk would give
    // p = exp(-lse) otherwise)
    const int k0 = kt * BK;
    const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 >= q0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(fminf(fmaf(s[j][e], sl2, nl2[h]), 0.f));
        if (edge && !kept(q0 + wrow + hopper::acc_row(lane, e),
                          k0 + j * 8 + hopper::acc_col(lane, e), tq, tk,
                          causal))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[h]) * scale;
      }

    // dQ += dS.K, dS rounded to T in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      hopper::frag_a_from_acc<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t b[4];
        hopper::ldsm_x4_trans(b, Kt + hopper::b_trans(lane, kk * 16, n * 8,
                                                      LD));
        hopper::mma<T>(acc[n], a, b[0], b[1]);
        hopper::mma<T>(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile kt + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + (lane >> 2) + 8 * h;
    if (row >= tq) continue;
    T* out = dq + qoff + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      if (col < d)
        *reinterpret_cast<uint32_t*>(out + col) =
            hopper::pack2<T>(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// the Q and dO rows of dk/dv's q-tile qt, with their lse and delta
// (4-byte copies: a row of lse need not be 16-byte aligned), into buffer
// buf
template <int DP, typename T>
__device__ __forceinline__ void load_q_tile_async(
    T* Qs, T* dOs, float* Ls, float* Ds, const T* __restrict__ q,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int qt, int buf, int tq, int d) {
  constexpr int BQ = dkv_q_rows<DP>();
  static_assert(2 * BQ <= kMmaThreads, "one row value a thread");
  const int q0 = qt * BQ;
  load_tile_async<BQ, DP>(Qs + buf * BQ * (DP + 8), q, q0, tq, d);
  load_tile_async<BQ, DP>(dOs + buf * BQ * (DP + 8), dout, q0, tq, d);
  const int e = threadIdx.x;
  if (e < 2 * BQ) {
    const int r = e % BQ;
    const bool in = q0 + r < tq;
    const float* src = e < BQ ? lse : delta;
    hopper::cp_async4((e < BQ ? Ls : Ds) + buf * BQ + r,
                      in ? src + q0 + r : src, in ? 4 : 0);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int tq, int tk, int d, float scale,
                      int causal) {
  constexpr int LD = DP + 8;
  constexpr int BQ = dkv_q_rows<DP>();
  constexpr int NT = BQ / 8;  // n8 tiles of a warp's score rows (q columns)
  constexpr int DT = DP / 8;  // n8 tiles of a warp's dK/dV rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [kMmaRows][LD]
  T* Vs = Ks + kMmaRows * LD;              // [kMmaRows][LD]
  T* Qs = Vs + kMmaRows * LD;              // [2][BQ][LD]
  T* dOs = Qs + 2 * BQ * LD;               // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                  // [2][BQ]

  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's keys in the tile
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kMmaRows;  // heaviest causal k-tiles first
  const size_t qoff = static_cast<size_t>(bh) * tq * d;
  const size_t koff = static_cast<size_t>(bh) * tk * d;
  const float* lse_b = lse + static_cast<size_t>(bh) * tq;
  const float* delta_b = delta + static_cast<size_t>(bh) * tq;
  const int nqt = ceil_div(tq, BQ);
  // causal: q-tiles whose last row lies above k0 see only masked cells
  const int qt0 = causal ? min(nqt, k0 / BQ) : 0;

  load_tile_async<kMmaRows, DP>(Ks, k + koff, k0, tk, d);
  load_tile_async<kMmaRows, DP>(Vs, v + koff, k0, tk, d);
  if (qt0 < nqt)
    load_q_tile_async<DP>(Qs, dOs, Ls, Ds, q + qoff, dout + qoff, lse_b,
                          delta_b, qt0, 0, tq, d);
  hopper::cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < nqt) {  // the next tile's copy overlaps this tile's math
      load_q_tile_async<DP>(Qs, dOs, Ls, Ds, q + qoff, dout + qoff, lse_b,
                            delta_b, qt + 1, buf ^ 1, tq, d);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + buf * BQ * LD;
    const T* dOt = dOs + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T: the warp's 16 keys by BQ q rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      hopper::ldsm_x4(ka, Ks + hopper::a_operand(lane, wrow, kk * 16, LD));
      hopper::ldsm_x4(va, Vs + hopper::a_operand(lane, wrow, kk * 16, LD));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        hopper::ldsm_x4(b, Qt + hopper::b_operand(lane, j * 8, kk * 16, LD));
        hopper::mma<T>(s[j], ka, b[0], b[1]);
        hopper::mma<T>(s[j + 1], ka, b[2], b[3]);
        hopper::ldsm_x4(b, dOt + hopper::b_operand(lane, j * 8, kk * 16, LD));
        hopper::mma<T>(dp[j], va, b[0], b[1]);
        hopper::mma<T>(dp[j + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T in place; lse and delta are indexed by the q column
    const int q0 = qt * BQ;
    const bool edge = q0 + BQ > tq || k0 + kMmaRows > tk ||
                      (causal && q0 <= k0 + kMmaRows - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + hopper::acc_col(lane, e);
        float p = exp2f(fminf(fmaf(s[j][e], sl2, -Lt[c] * kLog2e), 0.f));
        if (edge && !kept(q0 + c, k0 + wrow + hopper::acc_row(lane, e), tq,
                          tk, causal))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - Dt[c]) * scale;
        s[j][e] = p;
      }

    // dV += P^T.dO and dK += dS^T.Q, P^T and dS^T rounded to T in
    // registers as the A operands
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4], da[4];
      hopper::frag_a_from_acc<T>(pa, s[2 * kk], s[2 * kk + 1]);
      hopper::frag_a_from_acc<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t b[4];
        hopper::ldsm_x4_trans(b, dOt + hopper::b_trans(lane, kk * 16, n * 8,
                                                       LD));
        hopper::mma<T>(dva[n], pa, b[0], b[1]);
        hopper::mma<T>(dva[n + 1], pa, b[2], b[3]);
        hopper::ldsm_x4_trans(b, Qt + hopper::b_trans(lane, kk * 16, n * 8,
                                                      LD));
        hopper::mma<T>(dka[n], da, b[0], b[1]);
        hopper::mma<T>(dka[n + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile qt + 2
  }
  hopper::cp_async_wait<0>();  // K/V copies of a block with no q-tile

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wrow + (lane >> 2) + 8 * h;
    if (row >= tk) continue;
    T* dkr = dk + koff + static_cast<size_t>(row) * d;
    T* dvr = dv + koff + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      if (col < d) {
        *reinterpret_cast<uint32_t*>(dkr + col) =
            hopper::pack2<T>(dka[n][2 * h], dka[n][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvr + col) =
            hopper::pack2<T>(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

bool bad_shape(int bh, int tq, int tk, int d, int causal, int dtype) {
  return bh < 0 || tq < 0 || tk < 0 || d < 16 || d > 128 || d % 16 != 0 ||
         causal < 0 || causal > 2 || dtype < 0 || dtype > 2;
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

template <typename T, int DP>
int fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
            int bh, int tq, int tk, int d, float scale, int causal,
            cudaStream_t s) {
  const size_t smem =
      sizeof(T) * (kMmaRows + 4 * kMmaKeys) * static_cast<size_t>(DP + 8);
  cudaError_t err = prepare(flash_fwd_mma<T, DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(tq, kMmaRows), bh);
  flash_fwd_mma<T, DP><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, int bh, int tq,
               int tk, int d, float scale, int causal, cudaStream_t s) {
  const size_t smem = sizeof(T) * (2 * kMmaRows + 4 * dq_k_keys<DP>()) *
                      static_cast<size_t>(DP + 8);
  cudaError_t err = prepare(flash_bwd_dq_mma<T, DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(tq, kMmaRows), bh);
  flash_bwd_dq_mma<T, DP><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dkv_mma(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int bh, int tq, int tk, int d,
                float scale, int causal, cudaStream_t s) {
  constexpr int BQ = dkv_q_rows<DP>();
  const size_t smem =
      sizeof(T) * (2 * kMmaRows + 4 * BQ) * static_cast<size_t>(DP + 8) +
      sizeof(float) * 4 * BQ;
  cudaError_t err = prepare(flash_bwd_dkv_mma<T, DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(tk, kMmaRows), bh);
  flash_bwd_dkv_mma<T, DP><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core kernels copy their inputs 16 bytes at a time
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the instantiation of D: 32, 64 or 128 (D itself rounded up)
#define PTT_BY_HEAD_DIM(FN, T, ...)                               \
  (d <= 32 ? FN<T, 32>(__VA_ARGS__)                               \
           : d <= 64 ? FN<T, 64>(__VA_ARGS__) : FN<T, 128>(__VA_ARGS__))

// One launch of a chunk of at most 65535 heads, by dtype: f32 on the SIMT
// kernels, bf16 and f16 on the tensor-core ones.
int fwd_chunk(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int tq, int tk, int d, float scale,
              int causal, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return fwd<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1 ? PTT_BY_HEAD_DIM(fwd_mma, __nv_bfloat16, q, k, v, o, lse,
                                      bh, tq, tk, d, scale, causal, s)
                    : PTT_BY_HEAD_DIM(fwd_mma, __half, q, k, v, o, lse, bh,
                                      tq, tk, d, scale, causal, s);
}

int bwd_dq_chunk(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int tq, int tk, int d, float scale,
                 int causal, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return bwd_dq<float>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale,
                         causal, s);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1
             ? PTT_BY_HEAD_DIM(bwd_dq_mma, __nv_bfloat16, q, k, v, dout, lse,
                               delta, dq, bh, tq, tk, d, scale, causal, s)
             : PTT_BY_HEAD_DIM(bwd_dq_mma, __half, q, k, v, dout, lse, delta,
                               dq, bh, tq, tk, d, scale, causal, s);
}

int bwd_dkv_chunk(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int tq, int tk, int d,
                  float scale, int causal, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
                          scale, causal, s);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1
             ? PTT_BY_HEAD_DIM(bwd_dkv_mma, __nv_bfloat16, q, k, v, dout, lse,
                               delta, dk, dv, bh, tq, tk, d, scale, causal, s)
             : PTT_BY_HEAD_DIM(bwd_dkv_mma, __half, q, k, v, dout, lse,
                               delta, dk, dv, bh, tq, tk, d, scale, causal,
                               s);
}

#undef PTT_BY_HEAD_DIM

// heads of one launch: the grid's y axis holds 65535 blocks
constexpr int kChunkHeads = 65535;

// p advanced by `heads` heads of `per_head` elements of `esize` bytes
template <typename P>
P* at_head(P* p, long long heads, long long per_head, size_t esize) {
  using Byte = typename std::conditional<std::is_const<P>::value,
                                         const char, char>::type;
  return static_cast<P*>(static_cast<Byte*>(p) +
                              static_cast<size_t>(heads) * per_head * esize);
}

size_t elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16, 2 = float16 (the
// tensor-core kernels, which take 16-byte aligned q/k/v/do); causal: 0
// none, 1 causal, 2 strict.  Any B*H: chunks of 65535 heads, one launch
// each.  Each returns cudaGetLastError() after its launches (0: queued),
// or cudaErrorInvalidValue for what it does not take.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int tq, int tk, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  if (bad_shape(bh, tq, tk, d, causal, dtype) || tk == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t es = elem_size(dtype);
  const long long qh = 1LL * tq * d, kh = 1LL * tk * d;  // elements a head
  for (long long h0 = 0; h0 < bh && tq > 0; h0 += kChunkHeads) {
    const int n = static_cast<int>(bh - h0 < kChunkHeads ? bh - h0
                                                         : kChunkHeads);
    const int err = fwd_chunk(at_head(q, h0, qh, es), at_head(k, h0, kh, es),
                              at_head(v, h0, kh, es), at_head(o, h0, qh, es),
                              at_head(lse, h0, tq, 4), n, tq, tk, d, scale,
                              causal, dtype, s);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
    int d, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(bh, tq, tk, d, causal, dtype) || tk == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t es = elem_size(dtype);
  const long long qh = 1LL * tq * d, kh = 1LL * tk * d;  // elements a head
  for (long long h0 = 0; h0 < bh && tq > 0; h0 += kChunkHeads) {
    const int n = static_cast<int>(bh - h0 < kChunkHeads ? bh - h0
                                                         : kChunkHeads);
    const int err = bwd_dq_chunk(
        at_head(q, h0, qh, es), at_head(k, h0, kh, es),
        at_head(v, h0, kh, es), at_head(dout, h0, qh, es),
        at_head(lse, h0, tq, 4), at_head(delta, h0, tq, 4),
        at_head(dq, h0, qh, es), n, tq, tk, d, scale, causal, dtype,
        s);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(bh, tq, tk, d, causal, dtype) || tq == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t es = elem_size(dtype);
  const long long qh = 1LL * tq * d, kh = 1LL * tk * d;  // elements a head
  for (long long h0 = 0; h0 < bh && tk > 0; h0 += kChunkHeads) {
    const int n = static_cast<int>(bh - h0 < kChunkHeads ? bh - h0
                                                         : kChunkHeads);
    const int err = bwd_dkv_chunk(
        at_head(q, h0, qh, es), at_head(k, h0, kh, es),
        at_head(v, h0, kh, es), at_head(dout, h0, qh, es),
        at_head(lse, h0, tq, 4), at_head(delta, h0, tq, 4),
        at_head(dk, h0, kh, es), at_head(dv, h0, kh, es), n, tq, tk, d,
        scale, causal, dtype, s);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
