// Swin-V2 window attention core for Hopper (sm_90a), float32, bound to Python
// with ctypes (event_representation_study_tpu_torch/ops/window_attention.py).
//
// Replaces no TPU kernel: the JAX package computes this attention with plain
// jnp operations (models/swin_vit.py, WindowAttentionV2.__call__), which XLA
// fuses. On the card the port's plain PyTorch version runs ~9 separate passes
// forward and ~12 backward over every (window, head) score matrix; these
// kernels keep that matrix on the chip.
//
// What it computes, for each window w and head h of a (B_, n, 3, heads, 32)
// qkv tensor (the qkv projection's output, n <= 144 tokens a window):
//   q^ = q / (|q| + 1e-6),  k^ = k / (|k| + 1e-6)          (each row)
//   S  = scale[h] * q^ k^T + bias[h] + mask[w mod nW]       (n x n; mask optional)
//   P  = softmax(S) over each row,  O = P v
// written as (B_, n, heads * 32), the layout the output projection reads, with
// each row's log-sum-exp saved for the backward when asked. The backward, from
// dO: P again from q^, k^ and the log-sum-exp; dP = dO v^T; D = rowsum(dO o O);
// dS = P o (dP - D); dv = P^T dO; dq^ = scale dS k^; dk^ = scale dS^T q^; then
// the normalisation's Jacobian, dq = dq^ / (|q| + eps) - q^ (q^ . dq^) / |q|,
// gives dq and dk; dq, dk and dv fill one gradient of qkv's layout. The bias
// and the scale take sums over all windows: d_bias[h] = sum_w dS and
// d_scale[h] = sum_w sum_i q^_i . (dS k^)_i. The mask takes no gradient.
// Float32 throughout: FFMA on the CUDA cores, IEEE division, expf/logf, no
// tensor cores and no fast math.
//
// Bound. At N = 144 and head dim 32 a (window, head) is 2 x 144 x 144 x 32
// multiply-adds forward (q^ k^T, P v) and 5 x that backward, against 73 KB
// read and written forward (q, k, v in, O out) and 146 KB backward: ~36
// FLOP a byte, so both kernels are bound by float32 arithmetic (67 TFLOP/s).
//
// Design. A block of 384 threads is a 16 x 24 grid (tx, ty); thread (tx, ty)
// owns the 6 x 9 scores of rows i = ty + 24 r and columns j = tx + 16 c, so a
// row's 144 scores lie in one half-warp and its max and sum are four
// shuffles. 12 warps an SM, at up to 168 registers a thread, hide the
// latency that 8 warps with 9 x 9 tiles left bare, and spill less than 18
// warps with 4 x 9 tiles at 96 registers (at the Swin-V2-L detector's
// stage-0 shape on an H100: forward 1.6x and 1.07x slower, backward 1.7x
// and 1.04x). q^, k^ (and v, dO) sit in shared memory row-major at a stride of 34
// floats: a half-warp reading 16 rows with 8-byte loads hits 32 distinct
// banks, and the two rows a warp's half-warps read are broadcasts. Each
// second product contracts over 144, so its operand goes through shared
// memory.
// - Forward: a block takes one head and a chunk of windows that share one
//   mask, in order. It builds the 144 x 144 table bias[h] + mask once, and
//   fetches the next window's q, k and v into registers while the current
//   one is computed. P is staged row-major at stride 148 and v at stride
//   36, and P v gives each thread 3 rows x 4 dims: 7 loads (4 rows of P on
//   distinct banks, one 128-byte row of v each) for 48 multiply-adds.
//   188.9 KB of shared memory, one block an SM.
// - Backward: a block takes one head and a group of consecutive windows. It
//   loads this window's bias + mask into the dS registers before q^ k^T is
//   computed (they are spent on P before dP needs them), fetches the next
//   window's q, k, v, dO and O while dq^ is computed, and stages P^T, dS^T
//   (stride 148) and dS (stride 144) for the 6 x 2 tiles of dv, dk^, dq^. It
//   adds each dS into a 144 x 144 sum in shared memory and each row's
//   q^ . (dS k^) into a register, and at the end writes both as its group's
//   partial; a third kernel adds the partials in group order. No float
//   atomics: two runs give equal bits. 229.2 KB, one block an SM.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kN = 144;          // most tokens a window (12 x 12)
constexpr int kD = 32;           // head dim
constexpr int kTx = 16;          // thread columns: thread (tx, ty) owns columns j = tx + 16 c
constexpr int kTy = 24;          // thread rows: ... and rows i = ty + 24 r of the scores
constexpr int kTC = kN / kTx;    // 9 columns a thread
constexpr int kTR = kN / kTy;    // 6 rows a thread
constexpr int kThreads = kTx * kTy;  // 384
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kN / kWarps;  // rows of a window a warp fetches
constexpr int kLd = kD + 2;      // row stride of q^, k^, v, dO in shared memory
constexpr int kLdP = kN;         // row stride of dS staged row-major (backward)
constexpr int kLdV = kD + 4;     // row stride of v in the forward: 16-byte rows
constexpr int kLdPt = kN + 4;    // row stride of P^T and dS^T
constexpr float kEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kFwdFloats = kN * kN + kN * kLdPt + kN * kLdV;  // bias + mask, P (over q^, k^), v
constexpr int kBwdFloats = kN * kN + 3 * kN * kLd + kN * kLdPt + 4 * kN;
static_assert(2 * kN * kLd <= kN * kLdPt, "P overlays q^ and k^");
static_assert(kN * kLd <= kN * kLdPt, "the staging area holds v first");
static_assert(kFwdFloats * 4 <= 232448, "forward shared memory");
static_assert(kN % kTy == 0 && kN % kWarps == 0 && kN * 8 % kThreads == 0, "tiles");
static_assert(kBwdFloats * 4 <= 232448, "backward shared memory");

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Fetches rows i = warp + 8 u (u < kRows) of one 32-wide slice (row i at
// src + i * stride) into registers, a lane a dim; rows >= n are zeros. All
// the loads are in flight before any value is used.
__device__ __forceinline__ void fetch_rows(const float* __restrict__ src, size_t stride, int n,
                                           float (&x)[kRows]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = warp + kWarps * u;
    x[u] = i < n ? src[i * stride + lane] : 0.f;
  }
}

// Stores fetched rows into shared memory at stride ld. With kNorm each row
// is divided by (its norm + eps), as the plain version does, and the norm is
// kept in norms[i] when norms is given.
template <bool kNorm>
__device__ __forceinline__ void put_rows(const float (&x)[kRows], float* sm, float* norms,
                                         int ld = kLd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = warp + kWarps * u;
    float v = x[u];
    if (kNorm) {
      float ss = v * v;
#pragma unroll
      for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
      const float nrm = sqrtf(ss);
      v = v / (nrm + kEps);
      if (norms != nullptr && lane == 0) norms[i] = nrm;
    }
    sm[i * ld + lane] = v;
  }
}

// acc[r][c] = sum over the 32 dims of a[ty + 24 r] . b[tx + 16 c], a and b
// row-major at stride kLd, the dims taken in order, kStep (1 or 2) a load.
template <int kStep>
__device__ __forceinline__ void scores_tile(const float* a, const float* b, int tx, int ty,
                                            float (&acc)[kTR][kTC]) {
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int c = 0; c < kTC; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += kStep) {
    float x[kTR][kStep], y[kTC][kStep];
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const float* row = a + (ty + kTy * r) * kLd + d;
      if constexpr (kStep == 2) {
        const float2 t = *reinterpret_cast<const float2*>(row);
        x[r][0] = t.x;
        x[r][1] = t.y;
      } else {
        x[r][0] = *row;
      }
    }
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const float* row = b + (tx + kTx * c) * kLd + d;
      if constexpr (kStep == 2) {
        const float2 t = *reinterpret_cast<const float2*>(row);
        y[c][0] = t.x;
        y[c][1] = t.y;
      } else {
        y[c][0] = *row;
      }
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c)
#pragma unroll
        for (int e = 0; e < kStep; ++e) acc[r][c] = fmaf(x[r][e], y[c][e], acc[r][c]);
  }
}

// acc[r] (dims 2 tx, 2 tx + 1) = sum over k < kN of m[ty + 24 r][k] * b[k][2 tx ..],
// m at stride ld (16-byte aligned rows), b row-major at stride kLd, k in order.
__device__ __forceinline__ void contract_tile(const float* m, int ld, const float* b, int tx,
                                              int ty, float2 (&acc)[kTR]) {
#pragma unroll
  for (int r = 0; r < kTR; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll 2
  for (int k = 0; k < kN; k += 4) {
    float4 p[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) p[r] = *reinterpret_cast<const float4*>(m + (ty + kTy * r) * ld + k);
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float2*>(b + (k + u) * kLd + 2 * tx);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      acc[r].x = fmaf(p[r].x, v[0].x, acc[r].x);
      acc[r].y = fmaf(p[r].x, v[0].y, acc[r].y);
      acc[r].x = fmaf(p[r].y, v[1].x, acc[r].x);
      acc[r].y = fmaf(p[r].y, v[1].y, acc[r].y);
      acc[r].x = fmaf(p[r].z, v[2].x, acc[r].x);
      acc[r].y = fmaf(p[r].z, v[2].y, acc[r].y);
      acc[r].x = fmaf(p[r].w, v[3].x, acc[r].x);
      acc[r].y = fmaf(p[r].w, v[3].y, acc[r].y);
    }
  }
}

// The forward's P v: thread (g, rp) = (tid % 8, tid / 8) takes dims 4 g ..
// 4 g + 3 of rows rp + (kThreads / 8) h, h < kPvRows: acc[h] = sum over k < kN
// of m[row][k] * b[k][4 g ..], m (P) at stride kLdPt, b (v) at stride kLdV,
// k in order. A warp's loads of P read 4 rows on distinct banks (stride
// 148), and each load of v one 128-byte row.
constexpr int kPvRows = kN * 8 / kThreads;
__device__ __forceinline__ void contract_rows(const float* m, const float* b, int g, int rp,
                                              float4 (&acc)[kPvRows]) {
#pragma unroll
  for (int h = 0; h < kPvRows; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int k = 0; k < kN; k += 4) {
    float4 a[kPvRows], v[4];
#pragma unroll
    for (int h = 0; h < kPvRows; ++h) {
      a[h] = *reinterpret_cast<const float4*>(m + (rp + kThreads / 8 * h) * kLdPt + k);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(b + (k + u) * kLdV + 4 * g);
#pragma unroll
    for (int h = 0; h < kPvRows; ++h) {
      const float x[4] = {a[h].x, a[h].y, a[h].z, a[h].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[h].x = fmaf(x[u], v[u].x, acc[h].x);
        acc[h].y = fmaf(x[u], v[u].y, acc[h].y);
        acc[h].z = fmaf(x[u], v[u].z, acc[h].z);
        acc[h].w = fmaf(x[u], v[u].w, acc[h].w);
      }
    }
  }
}

// s[r][c] <- scale * s + t at (i, j) = (ty + 24 r, tx + 16 c), t = bias + mask
// of (i, j) from shared memory (stride kN); -inf outside the n x n scores.
__device__ __forceinline__ void add_table(float (&s)[kTR][kTC], float sc, const float* ts, int n,
                                          int tx, int ty) {
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int i = ty + kTy * r;
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const int j = tx + kTx * c;
      s[r][c] = i < n && j < n ? fmaf(sc, s[r][c], ts[i * kN + j]) : -INFINITY;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
window_attention_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ scale,
                            const float* __restrict__ bias, const float* __restrict__ mask,
                            float* __restrict__ out, float* __restrict__ lse, int windows, int n,
                            int heads, int mask_windows, int chunk) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ts = sm;                 // [kN][kN] bias + mask of the block's head and position
  float* ps = ts + kN * kN;       // [kN][kLdPt] P, over q^ and k^
  float* qs = ps;                 // [kN][kLd] q^
  float* ks = ps + kN * kLd;      // [kN][kLd] k^
  float* vs = ps + kN * kLdPt;    // [kN][kLdV] v
  // windows pos + positions * b, b in [b0, b1), all with mask[pos]
  const int positions = mask != nullptr ? mask_windows : 1;
  const int hd = blockIdx.x % heads;
  const int pos = blockIdx.x / heads % positions;
  const int b0 = blockIdx.x / (heads * positions) * chunk;
  const int b1 = min(windows / positions, b0 + chunk);
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int C = heads * kD;
  const size_t rs = 3 * static_cast<size_t>(C);
  const float* head = qkv + hd * kD;
  float xq[kRows], xk[kRows], xv[kRows];
  const float* src = head + (pos + static_cast<size_t>(positions) * b0) * n * rs;
  fetch_rows(src, rs, n, xq);
  fetch_rows(src + C, rs, n, xk);
  fetch_rows(src + 2 * C, rs, n, xv);
  const float* bh = bias + static_cast<size_t>(hd) * n * n;
  const float* mw = mask != nullptr ? mask + static_cast<size_t>(pos) * n * n : nullptr;
#pragma unroll 9
  for (int e = tid; e < kN * kN; e += kThreads) {
    const int i = e / kN, j = e % kN;
    float t = 0.f;
    if (i < n && j < n) {
      t = bh[i * n + j];
      if (mw != nullptr) t += mw[i * n + j];
    }
    ts[e] = t;
  }
  const float sc = scale[hd];

  for (int b = b0; b < b1; ++b) {
    const size_t w = pos + static_cast<size_t>(positions) * b;
    __syncthreads();  // the table is written; the previous window's P and v are read
    put_rows<true>(xq, qs, nullptr);
    put_rows<true>(xk, ks, nullptr);
    put_rows<false>(xv, vs, nullptr, kLdV);
    __syncthreads();
    if (b + 1 < b1) {  // the next window's rows arrive while this one is computed
      src = head + (w + positions) * n * rs;
      fetch_rows(src, rs, n, xq);
      fetch_rows(src + C, rs, n, xk);
      fetch_rows(src + 2 * C, rs, n, xv);
    }
    float s[kTR][kTC];
    scores_tile<2>(qs, ks, tx, ty, s);
    add_table(s, sc, ts, n, tx, ty);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int i = ty + kTy * r;
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTC; ++c) m = fmaxf(m, s[r][c]);
      m = half_warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const float e = i < n ? expf(s[r][c] - m) : 0.f;  // exp(-inf) = 0 past column n
        s[r][c] = e;
        l += e;
      }
      l = half_warp_sum(l);
      const float inv = 1.f / l;
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[r][c] = i < n ? s[r][c] * inv : 0.f;
      if (lse != nullptr && tx == 0 && i < n) lse[(w * heads + hd) * n + i] = m + logf(l);
    }
    __syncthreads();  // every warp is done with q^ and k^
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) ps[(ty + kTy * r) * kLdPt + tx + kTx * c] = s[r][c];
    __syncthreads();
    float4 o[kPvRows];
    contract_rows(ps, vs, tid % 8, tid / 8, o);
#pragma unroll
    for (int h = 0; h < kPvRows; ++h) {
      const int i = tid / 8 + kThreads / 8 * h;
      if (i < n) *reinterpret_cast<float4*>(out + (w * n + i) * C + hd * kD + 4 * (tid % 8)) = o[h];
    }
  }
}

// dx for x^ = x / (|x| + eps), from g = dL/dx^ at dims (2 tx, 2 tx + 1) of a
// row; xh = x^ there, nrm = |x|, dot = x^ . g over the row's 32 dims.
__device__ __forceinline__ float2 norm_backward(float2 g, float2 xh, float nrm, float dot) {
  const float a = nrm + kEps;
  const float b = nrm > 0.f ? dot / nrm : 0.f;
  return make_float2(g.x / a - xh.x * b, g.y / a - xh.y * b);
}

__global__ void __launch_bounds__(kThreads, 1)
window_attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ out,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            const float* __restrict__ mask, float* __restrict__ dqkv,
                            float* __restrict__ dbias_part, float* __restrict__ dscale_part,
                            int windows, int n, int heads, int mask_windows, int group) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* db = sm;                 // [kN][kN] sum of dS over the group's windows
  float* qs = db + kN * kN;       // [kN][kLd] q^
  float* ks = qs + kN * kLd;      // [kN][kLd] k^
  float* gs = ks + kN * kLd;      // [kN][kLd] dO
  float* st = gs + kN * kLd;      // v [kN][kLd], then P^T, dS^T [kN][kLdPt], dS [kN][kLdP]
  float* nq = st + kN * kLdPt;    // [kN] |q|
  float* nk = nq + kN;            // [kN] |k|
  float* dd = nk + kN;            // [kN] rowsum(dO o O)
  float* ls = dd + kN;            // [kN] log-sum-exp
  __shared__ float red[kWarps];

  const int g = blockIdx.x, hd = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int lane = tid & 31;
  const int C = heads * kD;
  const size_t rs = 3 * static_cast<size_t>(C);
  const float sc = scale[hd];
  const float* bh = bias + static_cast<size_t>(hd) * n * n;
  for (int e = tid; e < kN * kN; e += kThreads) db[e] = 0.f;
  float dscale_acc = 0.f;

  const int w_begin = g * group, w_end = min(windows, w_begin + group);
  float xq[kRows], xk[kRows], xv[kRows], xg[kRows], xo[kRows];
  auto fetch = [&](size_t w) {
    const float* src = qkv + w * n * rs + hd * kD;
    const size_t orow = w * n * C + hd * kD;
    fetch_rows(src, rs, n, xq);
    fetch_rows(src + C, rs, n, xk);
    fetch_rows(src + 2 * C, rs, n, xv);
    fetch_rows(dout + orow, C, n, xg);
    fetch_rows(out + orow, C, n, xo);
  };
  fetch(w_begin);
  for (int w = w_begin; w < w_end; ++w) {
    __syncthreads();  // the previous window's reads are done
    put_rows<true>(xq, qs, nq);
    put_rows<true>(xk, ks, nk);
    put_rows<false>(xv, st, nullptr);
    put_rows<false>(xg, gs, nullptr);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float p = xg[u] * xo[u];
#pragma unroll
      for (int k = 16; k; k >>= 1) p += __shfl_xor_sync(kFull, p, k);
      if (lane == 0) dd[(tid >> 5) + kWarps * u] = p;
    }
    if (tid < kN) ls[tid] = tid < n ? lse[(static_cast<size_t>(w) * heads + hd) * n + tid] : 0.f;
    // bias + mask of this window's scores, in ds until dP is computed
    float ds[kTR][kTC];
    const float* mw = mask != nullptr ? mask + static_cast<size_t>(w % mask_windows) * n * n
                                      : nullptr;
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int i = min(ty + kTy * r, n - 1);
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int j = min(tx + kTx * c, n - 1);
        ds[r][c] = bh[i * n + j];
        if (mw != nullptr) ds[r][c] += mw[i * n + j];
      }
    }
    __syncthreads();

    // P from q^ k^T and the log-sum-exp, dP = dO v^T, dS = P o (dP - D)
    float p[kTR][kTC];
    scores_tile<1>(qs, ks, tx, ty, p);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int i = ty + kTy * r;
      const float l = ls[i];
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int j = tx + kTx * c;
        p[r][c] = i < n && j < n ? expf(fmaf(sc, p[r][c], ds[r][c]) - l) : 0.f;
      }
    }
    scores_tile<1>(gs, st, tx, ty, ds);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const float dr = dd[ty + kTy * r];
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        ds[r][c] = p[r][c] * (ds[r][c] - dr);
        float* cell = db + (ty + kTy * r) * kN + tx + kTx * c;
        *cell += ds[r][c];
      }
    }
    __syncthreads();  // v is no longer read

    // dv = P^T dO
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) st[(tx + kTx * c) * kLdPt + ty + kTy * r] = p[r][c];
    __syncthreads();
    float2 acc[kTR];
    contract_tile(st, kLdPt, gs, tx, ty, acc);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int j = ty + kTy * r;
      if (j < n) {
        *reinterpret_cast<float2*>(dqkv + (static_cast<size_t>(w) * n + j) * rs + 2 * C + hd * kD +
                                   2 * tx) = acc[r];
      }
    }
    __syncthreads();

    // dk^ = scale dS^T q^, then dk
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) st[(tx + kTx * c) * kLdPt + ty + kTy * r] = ds[r][c];
    __syncthreads();
    contract_tile(st, kLdPt, qs, tx, ty, acc);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int j = ty + kTy * r;
      const float2 gk = make_float2(sc * acc[r].x, sc * acc[r].y);
      const float2 kh = *reinterpret_cast<const float2*>(ks + j * kLd + 2 * tx);
      const float dot = half_warp_sum(kh.x * gk.x + kh.y * gk.y);
      if (j < n) {
        *reinterpret_cast<float2*>(dqkv + (static_cast<size_t>(w) * n + j) * rs + C + hd * kD +
                                   2 * tx) = norm_backward(gk, kh, nk[j], dot);
      }
    }
    __syncthreads();

    // G = dS k^ (dq^ = scale G), d_scale += q^ . G, then dq
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) st[(ty + kTy * r) * kLdP + tx + kTx * c] = ds[r][c];
    __syncthreads();
    if (w + 1 < w_end) fetch(w + 1);  // arrives while G is computed
    contract_tile(st, kLdP, ks, tx, ty, acc);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int i = ty + kTy * r;
      const float2 qh = *reinterpret_cast<const float2*>(qs + i * kLd + 2 * tx);
      const float dot = half_warp_sum(qh.x * acc[r].x + qh.y * acc[r].y);
      if (i < n) {
        if (tx == 0) dscale_acc += dot;
        const float2 gq = make_float2(sc * acc[r].x, sc * acc[r].y);
        *reinterpret_cast<float2*>(dqkv + (static_cast<size_t>(w) * n + i) * rs + hd * kD +
                                   2 * tx) = norm_backward(gq, qh, nq[i], sc * dot);
      }
    }
  }
  __syncthreads();
  float* part = dbias_part + (static_cast<size_t>(g) * heads + hd) * n * n;
  for (int e = tid; e < n * n; e += kThreads) part[e] = db[(e / n) * kN + e % n];
#pragma unroll
  for (int k = 16; k; k >>= 1) dscale_acc += __shfl_xor_sync(kFull, dscale_acc, k);
  if (lane == 0) red[tid >> 5] = dscale_acc;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int k = 0; k < kWarps; ++k) t += red[k];
    dscale_part[static_cast<size_t>(g) * heads + hd] = t;
  }
}

// d_bias[e] = sum over groups, in group order, of dbias_part[g][e]; the same
// for d_scale.
__global__ void window_attention_sum_kernel(const float* __restrict__ dbias_part,
                                            const float* __restrict__ dscale_part,
                                            float* __restrict__ dbias, float* __restrict__ dscale,
                                            int groups, int heads, int per_head) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(heads) * per_head;
  if (e < total) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += dbias_part[g * total + e];
    dbias[e] = t;
  }
  if (e < static_cast<size_t>(heads)) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += dscale_part[static_cast<size_t>(g) * heads + e];
    dscale[e] = t;
  }
}

bool shapes_ok(int windows, int n, int heads, int mask_windows, const void* mask) {
  return windows >= 1 && n >= 1 && n <= kN && heads >= 1 &&
         (mask == nullptr || (mask_windows >= 1 && windows % mask_windows == 0));
}

}  // namespace

// Forward on `stream`: qkv (windows, n, 3, heads, 32), scale (heads),
// bias (heads, n, n), mask (mask_windows, n, n) or null -> out (windows, n,
// heads * 32), and lse (windows, heads, n) unless null. A block takes `chunk`
// windows of one head that share one mask (all windows share it when there
// is none). Returns cudaGetLastError() as an int: 0 when the launch was
// accepted.
extern "C" int window_attention_fwd(const void* qkv, const void* scale, const void* bias,
                                    const void* mask, void* out, void* lse, int windows, int n,
                                    int heads, int mask_windows, int chunk, void* stream) {
  if (!shapes_ok(windows, n, heads, mask_windows, mask) || chunk < 1 || !qkv || !scale ||
      !bias || !out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int positions = mask != nullptr ? mask_windows : 1;
  const int blocks = heads * positions * ((windows / positions + chunk - 1) / chunk);
  const int smem = kFwdFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<float*>(out),
      static_cast<float*>(lse), windows, n, heads, mask_windows, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`: from dout (windows, n, heads * 32) and the forward's
// inputs, out and lse, writes dqkv (qkv's layout), dbias (heads, n, n) and
// dscale (heads). The windows are cut into ceil(windows / group) groups; the
// scratch dbias_part holds (groups, heads, n, n) floats, dscale_part (groups,
// heads). Returns cudaGetLastError() as an int after both launches.
extern "C" int window_attention_bwd(const void* qkv, const void* out, const void* dout,
                                    const void* lse, const void* scale, const void* bias,
                                    const void* mask, void* dqkv, void* dbias_part,
                                    void* dscale_part, void* dbias, void* dscale, int windows,
                                    int n, int heads, int mask_windows, int group, void* stream) {
  if (!shapes_ok(windows, n, heads, mask_windows, mask) || group < 1 || !qkv || !out || !dout ||
      !lse || !scale || !bias || !dqkv || !dbias_part || !dscale_part || !dbias || !dscale) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (windows + group - 1) / group;
  const int smem = kBwdFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  window_attention_bwd_kernel<<<dim3(groups, heads), kThreads, smem, st>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(dqkv), static_cast<float*>(dbias_part),
      static_cast<float*>(dscale_part), windows, n, heads, mask_windows, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = heads * n * n;
  window_attention_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dbias_part), static_cast<const float*>(dscale_part),
      static_cast<float*>(dbias), static_cast<float*>(dscale), groups, heads, n * n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* window_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
