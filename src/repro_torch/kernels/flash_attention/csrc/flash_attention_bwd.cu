// FlashAttention backward over the forward's layout, for Hopper (sm_90a).
//
// No Pallas kernel is replaced: the reference trains through its jnp
// attention (src/repro/models/transformer.py::_block_attention) and has no
// backward kernel.  This is the gradient of the function the forward
// (flash_attention.cu) computes, for the LM's training path, in fp32 (the
// wrapper casts bf16 operands to fp32 and the gradients back):
//   q, dout    [B, Sq, Kh, G, hd]   grouped query heads and the gradient
//                                   of the forward's output
//   k, v       [B, Skv, Kh, hd]
//   q_start[B], kv_len[B]           int32, as the forward reads them
//   dq [B, Sq, Kh, G, hd], dk, dv [B, Skv, Kh, hd]
// Key j is admissible for the query at position p when j < kv_len,
// j <= p and j > p - window; scores s = (q k) / sqrt(hd), capped as
// c = cap * tanh(s / cap) before the mask.  With P = softmax(c) over the
// admissible keys (P = exp(c - lse) for the row's log-sum-exp lse),
// o = P v and D = rowsum(dout * o):
//   dv_j = sum_r P_rj dout_r,  dP_rj = dout_r . v_j,
//   dS_rj = P_rj (dP_rj - D_r) (1 - tanh^2(s_rj / cap) under a cap),
//   dq_r = sum_j dS_rj k_j / sqrt(hd),  dk_j = sum_r dS_rj q_r / sqrt(hd).
// A row with no admissible key has o = 0 and takes part in no pair: its
// dq is 0 and it adds nothing to dk, dv (no NaN), as in the plain version.
// Rows of one (batch, kv head) are r = sq * G + g, R = Sq * G of them; lse
// and D are fp32 [B, Kh, R].
//
// Bound on this card by operations: ~10 hd flops per admissible (query,
// key) pair (the five products above) against ~8 hd bytes of operands per
// query row and key, on the fp32 FMA units (TF32 stays off).  The kernels
// spend 14 hd a pair: S and dP are computed twice, once for dq and once for
// dk, dv, because a sum over the other side of the pair without atomics
// keeps the gradients bit-identical from run to run.  Two routes, chosen by
// the wrapper from what it is given:
// * saved (the training path): the forward's rows route kept each row's
//   log-sum-exp, and its fp32 output gives D in attn_bwd_dsum_kernel, a
//   pass over dout and o;
// * recompute (no log-sum-exp given: bf16 from the tc forward, a direct
//   call): attn_bwd_lse_kernel recomputes each row's log-sum-exp and its
//   output o in fp32 (the bf16 output is rounded, and dq = P (dP - D) k
//   cancels, so the rounding of o would reach dq far beyond one bf16 step),
//   then D.  Scalar 4x4 tiles; it is off the training path.
// Then, on both routes, two kernels of 128 threads, each warp owning 16
// query rows (dq) or 16 keys (dk/dv) of its block, so a step needs one
// block barrier (its tiles have arrived) and one warp barrier (the warp's
// own dS is written):
// * attn_bwd_dq_kernel (6 hd a pair): a block per 64 query rows of one
//   (batch, kv head) walks the 32-key tiles its rows can see; S = Q K^T and
//   dP = dO V^T as 4x4 register tiles, the warp's dS into shared memory,
//   then dQ += dS K with 8 rows x 4 (hd 128: 8) columns a thread;
// * attn_bwd_dkv_kernel (8 hd a pair): a block per 64 keys walks the
//   32-row query tiles that can see them (causal order and the window bound
//   the range); S^T and dP^T as 4x4 tiles, the warp's P and dS into shared
//   memory, then dV += P^T dO and dK += dS^T Q with 8 keys x 4 (8) columns
//   a thread.  A warp skips a step none of its rows (keys) can see.
// Every operand tile is [rows][hd + 4] floats: an inner step reads 16-byte
// vectors of both operands, along hd for the products over hd (rows of a
// warp 4 floats apart: no bank conflict) and along the output rows and
// columns for the products over rows or keys.  A warp's 16-byte read takes
// 4 of the SM's shared-memory cycles whatever it broadcasts, so a 4x4 tile
// (8 floats read for 16 FMAs) can use at most half of the FMA rate and an
// 8x4 tile two thirds; larger tiles do not fit the registers of two blocks
// an SM.  The next step's tiles (q and dout with lse and D for dk/dv, k and
// v for dq) load by cp.async into a second stage while the current one
// computes.  Blocks with the longest walks start first: early keys for
// dk/dv, late query rows for dq.  Where G is 1 (a kv head per query head)
// no row index is divided by G.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "../../_hopper/hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;      // the recompute pre-pass
constexpr int kTile = 64;          // its query rows and keys per tile
constexpr int kPS = kTile + 1;     // its padded row of a score tile

constexpr int kBwdThreads = 128;   // dq and dk/dv blocks
constexpr int kKeysB = 64;         // keys of a dk/dv block
constexpr int kRowsT = 32;         // query rows of a dk/dv step
constexpr int kRowsB = 64;         // query rows of a dq block
constexpr int kKeysT = 32;         // keys of a dq step
constexpr int kWarps = kBwdThreads / 32;
constexpr int kWarpRows = 16;      // query rows or keys a warp owns
constexpr int kLDW = kWarpRows + 4;  // row of a warp's P / dS tile

// ------------------------------------------------------------ loads, stores

__device__ __forceinline__ float ld(const float* p) { return *p; }

// 4 consecutive elements; p is aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ bool admissible(int j, int pos, int kv_end,
                                           int window) {
  return j < kv_end && j <= pos && j > pos - window;
}

// offset of q/dout row (b, sq, kh, g) and of k/v row (b, j, kh)
__device__ __forceinline__ size_t q_off(int b, int sq, int kh, int g, int Sq,
                                        int Kh, int G, int hd) {
  return ((((size_t)b * Sq + sq) * Kh + kh) * G + g) * hd;
}
__device__ __forceinline__ size_t kv_off(int b, int j, int kh, int Skv,
                                         int Kh, int hd) {
  return (((size_t)b * Skv + j) * Kh + kh) * hd;
}

// The capped score of a raw score s (the forward's arithmetic) and the
// derivative of the cap, 1 - tanh^2(s / cap) (1 without a cap).
__device__ __forceinline__ float cap_score(float s, float softcap,
                                           float* dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    *dcap = 1.f - t * t;
    return softcap * t;
  }
  *dcap = 1.f;
  return s;
}

// ------------------------------------------- recompute pre-pass: tile helpers

// Rows [row0, row0 + 64) of one (b, kh) of a query-layout tensor into
// S[64][HD + 1] as floats times mul; zeros at or past R.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* S, const T* src, int b,
                                          int kh, int row0, int R, int Sq,
                                          int Kh, int G, float mul) {
  for (int e = threadIdx.x * 4; e < kTile * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < R) load4(src + q_off(b, row / G, kh, row % G, Sq, Kh, G, HD) + d, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) S[r * (HD + 1) + d + i] = t[i] * mul;
  }
}

// Keys [j0, j0 + 64) of one (b, kh) into S[64][HD + 1]; zeros at or past
// j_end (never read there).
template <typename T, int HD>
__device__ __forceinline__ void load_keys(float* S, const T* src, int b,
                                          int kh, int j0, int j_end, int Skv,
                                          int Kh) {
  for (int e = threadIdx.x * 4; e < kTile * HD; e += kThreads * 4) {
    const int j = e / HD, d = e % HD;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (j0 + j < j_end) load4(src + kv_off(b, j0 + j, kh, Skv, Kh, HD) + d, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) S[j * (HD + 1) + d + i] = t[i];
  }
}

// acc[i][c] += A[ty*4 + i] . Bm[tx + 16c] over HD (both [64][HD + 1])
template <int HD>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = Bm[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], bb[c], acc[i][c]);
  }
}

// acc[i][c] += sum_j P[ty*4 + i][j] * M[j][tx + 16c]
// (P a [64][65] score tile, M a [64][HD + 1] operand tile)
template <int HD>
__device__ __forceinline__ void tile_acc(const float* P, const float* M,
                                         int ty, int tx,
                                         float (&acc)[4][HD / 16]) {
  constexpr int LD = HD + 1, DC = HD / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[4], m[DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * kPS + j];
#pragma unroll
    for (int c = 0; c < DC; ++c) m[c] = M[j * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], m[c], acc[i][c]);
  }
}

template <int HD>
__host__ __device__ constexpr size_t lse_smem_bytes() {
  return sizeof(float) * (3 * kTile * (HD + 1) + kTile * kPS);
}

// ------------------------------------ recompute pre-pass: log-sum-exp and D

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const int32_t* __restrict__ q_start,
                    const int32_t* __restrict__ kv_len,
                    float* __restrict__ lse, float* __restrict__ dsum, int Sq,
                    int Skv, int Kh, int G, int window, float softcap,
                    float scale) {
  constexpr int DC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [64][HD + 1], pre-scaled
  float* Ks = Qs + kTile * (HD + 1);         // [64][HD + 1]
  float* Vs = Ks + kTile * (HD + 1);         // [64][HD + 1]
  float* Ps = Vs + kTile * (HD + 1);         // [64][kPS]: exp(c - m)
  const int b = blockIdx.z, kh = blockIdx.y, row0 = blockIdx.x * kTile;
  const int R = Sq * G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  load_rows<T, HD>(Qs, q, b, kh, row0, R, Sq, Kh, G, scale);

  int pos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    live[i] = row < R;
    pos[i] = qs + (live[i] ? row / G : 0);
  }
  const int last_row = min(row0 + kTile, R) - 1;
  const int kv_hi = min(kv_end, qs + last_row / G + 1);
  const int first_pos = qs + row0 / G;
  const int kv_lo = (max(0, first_pos - window + 1) / kTile) * kTile;

  float m[4], l[4], acc[4][DC] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();  // the last tile's K, V and P are read
    load_keys<T, HD>(Ks, k, b, kh, kv0, kv_hi, Skv, Kh);
    load_keys<T, HD>(Vs, v, b, kh, kv0, kv_hi, Skv, Kh);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<HD>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = -1e30f, dcap;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = live[i] && admissible(kv0 + tx + 16 * c, pos[i], kv_hi,
                                      window);
        s[i][c] = ok[c] ? cap_score(s[i][c], softcap, &dcap) : -1e30f;
        mt = fmaxf(mt, s[i][c]);
      }
      // the 16 lanes of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? __expf(s[i][c] - m_new) : 0.f;
        Ps[(ty * 4 + i) * kPS + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = __expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    tile_acc<HD>(Ps, Vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    const float inv_l = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float d = 0.f;
    if (live[i]) {
      const size_t off = q_off(b, row / G, kh, row % G, Sq, Kh, G, HD);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        d = fmaf(acc[i][c] * inv_l, ld(dout + off + tx + 16 * c), d);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (live[i] && tx == 0) {
      const size_t at = ((size_t)b * Kh + kh) * R + row;
      lse[at] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      dsum[at] = d;
    }
  }
}

// ------------------------------------------------- saved pre-pass: D rows

// D = rowsum(dout * o) from the forward's fp32 output: HD / 4 lanes a row,
// a float4 each, summed by shuffles.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dsum_kernel(const float* __restrict__ dout,
                     const float* __restrict__ out, float* __restrict__ dsum,
                     long long rows, int Sq, int Kh, int G) {
  constexpr int C4 = HD / 4;   // 4, 8, 16 or 32 lanes: a divisor of a warp
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = e / C4;
  const int c = (int)(e % C4);
  float d = 0.f;
  if (row < rows) {
    const float4 a = *reinterpret_cast<const float4*>(dout + row * HD + 4 * c);
    const float4 o = *reinterpret_cast<const float4*>(out + row * HD + 4 * c);
    d = fmaf(a.x, o.x, fmaf(a.y, o.y, fmaf(a.z, o.z, a.w * o.w)));
  }
#pragma unroll
  for (int off = C4 / 2; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (row < rows && c == 0) {
    // row = ((b * Sq + sq) * Kh + kh) * G + g, stored at (b, kh, sq * G + g)
    const int g = (int)(row % G);
    long long t = row / G;
    const int kh = (int)(t % Kh);
    t /= Kh;
    const int sq = (int)(t % Sq);
    const long long b = t / Sq;
    dsum[((b * Kh + kh) * Sq + sq) * G + g] = d;
  }
}

// ------------------------------------------------------- dq, dk/dv tiles

// acc[i][c] += A[a0 + 4i] . Bm[b0 + 8c] over HD: a 4x4 tile of a product
// over the head dim, A and Bm [rows][HD + 4].  Both operands are read as
// float4 along HD; the 4 (8) rows a warp reads of A (Bm) are consecutive,
// HD + 4 floats apart, so their 16-byte pieces fall in distinct banks.
template <int HD>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int a0, int b0, float (&acc)[4][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (a0 + 4 * i) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(Bm + (b0 + 8 * c) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = fmaf(a[i].x, b[c].x, acc[i][c]);
        acc[i][c] = fmaf(a[i].y, b[c].y, acc[i][c]);
        acc[i][c] = fmaf(a[i].z, b[c].z, acc[i][c]);
        acc[i][c] = fmaf(a[i].w, b[c].w, acc[i][c]);
      }
  }
}

// The [16][HD] gradient tile a warp accumulates (its 16 query rows in dq,
// its 16 keys in dk/dv), over its 32 lanes: kDG column groups of kV
// float4s (columns (td + kDG h) * 4 .. + 3) and 32 / kDG row groups of kNR
// consecutive rows.
template <int HD>
struct OutTile {
  static constexpr int kDG = HD / 4 < 16 ? HD / 4 : 16;
  static constexpr int kV = HD / 4 / kDG;
  static constexpr int kNR = kWarpRows * kDG / 32;
  static constexpr int kCols = 4 * kV;
};

// acc[r][4h + e] += sum_k P[k][tr * kNR + r] * M[k][(td + kDG h) * 4 + e]
// over the 32 rows k of P (a warp's [32][kLDW] tile: its 16 output rows
// contiguous) and M ([32][HD + 4]): an outer product a step, both read as
// vectors.
template <int HD>
__device__ __forceinline__ void acc_tile(
    const float* P, const float* M, int tr, int td,
    float (&acc)[OutTile<HD>::kNR][OutTile<HD>::kCols]) {
  using O = OutTile<HD>;
  constexpr int LD = HD + 4;
#pragma unroll 8
  for (int kk = 0; kk < 32; ++kk) {
    float p[O::kNR];
    const float* pr = P + kk * kLDW + tr * O::kNR;
    if constexpr (O::kNR % 4 == 0) {
#pragma unroll
      for (int u = 0; u < O::kNR / 4; ++u) {
        const float4 t = *reinterpret_cast<const float4*>(pr + 4 * u);
        p[4 * u] = t.x; p[4 * u + 1] = t.y;
        p[4 * u + 2] = t.z; p[4 * u + 3] = t.w;
      }
    } else {
      const float2 t = *reinterpret_cast<const float2*>(pr);
      p[0] = t.x; p[1] = t.y;
    }
    float4 m[O::kV];
#pragma unroll
    for (int h = 0; h < O::kV; ++h)
      m[h] = *reinterpret_cast<const float4*>(M + kk * LD +
                                              (td + O::kDG * h) * 4);
#pragma unroll
    for (int r = 0; r < O::kNR; ++r)
#pragma unroll
      for (int h = 0; h < O::kV; ++h) {
        acc[r][4 * h] = fmaf(p[r], m[h].x, acc[r][4 * h]);
        acc[r][4 * h + 1] = fmaf(p[r], m[h].y, acc[r][4 * h + 1]);
        acc[r][4 * h + 2] = fmaf(p[r], m[h].z, acc[r][4 * h + 2]);
        acc[r][4 * h + 3] = fmaf(p[r], m[h].w, acc[r][4 * h + 3]);
      }
  }
}

// Writes a lane's row of a gradient tile, times mul, as float4s.
template <int HD>
__device__ __forceinline__ void store_row(
    float* dst, const float (&acc)[OutTile<HD>::kCols], int td, float mul) {
  using O = OutTile<HD>;
#pragma unroll
  for (int h = 0; h < O::kV; ++h) {
    *reinterpret_cast<float4*>(dst + (td + O::kDG * h) * 4) =
        make_float4(acc[4 * h] * mul, acc[4 * h + 1] * mul,
                    acc[4 * h + 2] * mul, acc[4 * h + 3] * mul);
  }
}

// The position offset of row r = sq * G + g of a (batch, kv head), r / G,
// without the division where G is 1 (every head its own kv head).
__device__ __forceinline__ int row_pos(int r, int G) {
  return G == 1 ? r : r / G;
}

// Rows [r0, r0 + n) of one (b, kh) of two query-layout tensors (q and
// dout) into dst_a, dst_b [n][HD + 4] by cp.async; zeros at or past R.
template <int HD>
__device__ __forceinline__ void copy_rows(float* dst_a, const float* src_a,
                                          float* dst_b, const float* src_b,
                                          int n, int b, int kh, int r0,
                                          int R, int Sq, int Kh, int G) {
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < n * C4; e += kBwdThreads) {
    const int r = e / C4, c = e % C4, row = r0 + r;
    const bool ok = row < R;
    const int sq = row_pos(row, G);
    const size_t off = ok ? q_off(b, sq, kh, row - sq * G, Sq, Kh, G, HD)
                                + 4 * c
                          : 0;
    cp_async16(dst_a + r * (HD + 4) + 4 * c, src_a + off, ok);
    cp_async16(dst_b + r * (HD + 4) + 4 * c, src_b + off, ok);
  }
}

// Keys [j0, j0 + n) of one (b, kh) of k and v into dst_k, dst_v
// [n][HD + 4] by cp.async; zeros at or past j_end.
template <int HD>
__device__ __forceinline__ void copy_keys(float* dst_k, const float* k,
                                          float* dst_v, const float* v,
                                          int n, int b, int kh, int j0,
                                          int j_end, int Skv, int Kh) {
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < n * C4; e += kBwdThreads) {
    const int j = e / C4, c = e % C4;
    const bool ok = j0 + j < j_end;
    const size_t off = ok ? kv_off(b, j0 + j, kh, Skv, Kh, HD) + 4 * c : 0;
    cp_async16(dst_k + j * (HD + 4) + 4 * c, k + off, ok);
    cp_async16(dst_v + j * (HD + 4) + 4 * c, v + off, ok);
  }
}

template <int HD>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kRowsB * (HD + 4) + 4 * kKeysT * (HD + 4) +
                          kWarps * kKeysT * kLDW);
}
template <int HD>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKeysB * (HD + 4) + 4 * kRowsT * (HD + 4) +
                          2 * kWarps * kRowsT * kLDW + 4 * kRowsT);
}

// ------------------------------------------------------------------- dq

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 2)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const int32_t* __restrict__ q_start,
                   const int32_t* __restrict__ kv_len,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, float* __restrict__ dq,
                   int B, int Sq, int Skv, int Kh, int G, int window,
                   float softcap, float scale, int row_tiles) {
  using O = OutTile<HD>;
  constexpr int LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qs = smem;                       // [64][LD]
  float* dOs = Qs + kRowsB * LD;          // [64][LD]
  float* Ks = dOs + kRowsB * LD;          // [2 stages][32][LD]
  float* Vs = Ks + 2 * kKeysT * LD;       // [2 stages][32][LD]
  // this warp's dS of a step: [32 keys][kLDW], its 16 rows contiguous
  float* Sw = Vs + 2 * kKeysT * LD + warp * kKeysT * kLDW;
  const int bh = B * Kh;
  // the latest rows (the longest walks under the causal mask) first
  const int tile = row_tiles - 1 - (int)(blockIdx.x / bh);
  const int b = (int)(blockIdx.x % bh) / Kh, kh = (int)(blockIdx.x % Kh);
  const int row0 = tile * kRowsB, R = Sq * G;
  // dot tiles: block rows a0 + 4i, keys kb + 8c; the dq tile: rows
  // 16 warp + tr * kNR + r
  const int a0 = warp * kWarpRows + (lane >> 3), kb = lane & 7;
  const int tr = lane / O::kDG, td = lane % O::kDG;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  copy_rows<HD>(Qs, q, dOs, dout, kRowsB, b, kh, row0, R, Sq, Kh, G);

  const size_t base = ((size_t)b * Kh + kh) * R;
  int pos[4];
  bool live[4];
  float lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + a0 + 4 * i;
    live[i] = row < R;
    pos[i] = qs + (live[i] ? row_pos(row, G) : 0);
    lrow[i] = live[i] ? lse[base + row] : 0.f;
    drow[i] = live[i] ? dsum[base + row] : 0.f;
  }
  // keys the block's rows can see: up to its last row's position, from its
  // first row's window start, below kv_len
  const int last_row = min(row0 + kRowsB, R) - 1;
  const int kv_hi = min(kv_end, qs + last_row / G + 1);
  const int first_pos = qs + row0 / G;
  const int kv_lo = (max(0, first_pos - window + 1) / kKeysT) * kKeysT;
  const int n_steps = kv_hi > kv_lo ? (kv_hi - kv_lo + kKeysT - 1) / kKeysT
                                    : 0;
  // the positions of this warp's rows: a step wholly outside them is
  // skipped (its dS would be 0)
  const int w_first = row0 + warp * kWarpRows;
  const bool w_live = w_first < R;
  const int w_lo = qs + w_first / G;
  const int w_hi = qs + (min(w_first + kWarpRows, R) - 1) / G;
  if (n_steps > 0)
    copy_keys<HD>(Ks, k, Vs, v, kKeysT, b, kh, kv_lo, kv_hi, Skv, Kh);
  cp_async_commit();

  float acc[O::kNR][O::kCols] = {};
  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1, kv0 = kv_lo + step * kKeysT;
    cp_async_wait<0>();
    __syncthreads();  // this step's keys are in; the last step's are read
    if (step + 1 < n_steps) {
      copy_keys<HD>(Ks + (st ^ 1) * kKeysT * LD, k,
                    Vs + (st ^ 1) * kKeysT * LD, v, kKeysT, b, kh,
                    kv0 + kKeysT, kv_hi, Skv, Kh);
    }
    cp_async_commit();
    if (!w_live || kv0 > w_hi ||
        (long long)kv0 + kKeysT - 1 <= (long long)w_lo - window) {
      continue;
    }
    const float* Kt = Ks + st * kKeysT * LD;
    const float* Vt = Vs + st * kKeysT * LD;
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<HD>(Qs, Kt, a0, kb, s);
    dot_tile<HD>(dOs, Vt, a0, kb, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = kv0 + kb + 8 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ds = 0.f;
        if (live[i] && admissible(j, pos[i], kv_hi, window)) {
          float dcap;
          const float x = cap_score(s[i][c] * scale, softcap, &dcap);
          ds = __expf(x - lrow[i]) * (dp[i][c] - drow[i]) * dcap;
        }
        Sw[(kb + 8 * c) * kLDW + (lane >> 3) + 4 * i] = ds;
      }
    }
    __syncwarp();
    acc_tile<HD>(Sw, Kt, tr, td, acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < O::kNR; ++r) {
    const int row = w_first + tr * O::kNR + r;
    if (row < R) {
      store_row<HD>(dq + q_off(b, row / G, kh, row % G, Sq, Kh, G, HD),
                    acc[r], td, scale);
    }
  }
}

// --------------------------------------------------------------- dk, dv

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 2)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const int32_t* __restrict__ q_start,
                    const int32_t* __restrict__ kv_len,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dk,
                    float* __restrict__ dv, int B, int Sq, int Skv, int Kh,
                    int G, int window, float softcap, float scale) {
  using O = OutTile<HD>;
  constexpr int LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = smem;                       // [64][LD]: this block's keys
  float* Vs = Ks + kKeysB * LD;           // [64][LD]
  float* Qs = Vs + kKeysB * LD;           // [2 stages][32][LD]: a row tile
  float* dOs = Qs + 2 * kRowsT * LD;      // [2 stages][32][LD]
  float* Tiles = dOs + 2 * kRowsT * LD;
  // this warp's P and dS of a step: [32 rows][kLDW], its 16 keys
  // contiguous
  float* Pw = Tiles + warp * 2 * kRowsT * kLDW;
  float* Sw = Pw + kRowsT * kLDW;
  float* Ls = Tiles + kWarps * 2 * kRowsT * kLDW;   // [2 stages][32]: lse
  float* Ds = Ls + 2 * kRowsT;                      // [2 stages][32]: D
  const int bh = B * Kh;
  // the earliest keys (the longest walks under the causal mask) first
  const int j0 = (int)(blockIdx.x / bh) * kKeysB;
  const int b = (int)(blockIdx.x % bh) / Kh, kh = (int)(blockIdx.x % Kh);
  const int R = Sq * G;
  // dot tiles: this warp's keys ka + 4i, rows rb + 8c; the dk, dv tiles:
  // keys tr * kNR + r of the warp's 16
  const int ka = lane >> 3, rb = lane & 7;
  const int tr = lane / O::kDG, td = lane % O::kDG;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  const size_t base = ((size_t)b * Kh + kh) * R;
  copy_keys<HD>(Ks, k, Vs, v, kKeysB, b, kh, j0, kv_end, Skv, Kh);

  // rows whose position can see a key of [j0, j_last]: pos >= j0 and
  // pos < j_last + window
  int r_lo = 0, n_steps = 0;
  if (j0 < kv_end) {
    const int j_last = min(j0 + kKeysB, kv_end) - 1;
    const long long sq_hi_ll =
        min((long long)Sq, (long long)j_last + window - qs);
    const int sq_lo = max(0, j0 - qs);
    const int sq_hi = (int)max((long long)sq_lo, sq_hi_ll);
    r_lo = sq_lo * G;
    n_steps = (sq_hi * G - r_lo + kRowsT - 1) / kRowsT;
  }
  // this warp's keys: a step whose rows see none of them is skipped
  const int wk_lo = j0 + warp * kWarpRows;
  const int wk_hi = min(wk_lo + kWarpRows, kv_end) - 1;
  auto copy_step = [&](int step, int st) {
    const int r0 = r_lo + step * kRowsT;
    copy_rows<HD>(Qs + st * kRowsT * LD, q, dOs + st * kRowsT * LD, dout,
                  kRowsT, b, kh, r0, R, Sq, Kh, G);
    if (tid < kRowsT) {
      const int row = r0 + tid;
      const bool ok = row < R;
      cp_async4(Ls + st * kRowsT + tid, lse + base + (ok ? row : 0), ok);
      cp_async4(Ds + st * kRowsT + tid, dsum + base + (ok ? row : 0), ok);
    }
  };
  if (n_steps > 0) copy_step(0, 0);
  cp_async_commit();

  float acc_k[O::kNR][O::kCols] = {}, acc_v[O::kNR][O::kCols] = {};
  const float* Kw = Ks + warp * kWarpRows * LD;
  const float* Vw = Vs + warp * kWarpRows * LD;
  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1, r0 = r_lo + step * kRowsT;
    cp_async_wait<0>();
    __syncthreads();  // this step's rows are in; the last step's are read
    if (step + 1 < n_steps) copy_step(step + 1, st ^ 1);
    cp_async_commit();
    const int p_lo = qs + row_pos(r0, G);
    const int p_hi = qs + row_pos(min(r0 + kRowsT, R) - 1, G);
    if (wk_lo > wk_hi || p_hi < wk_lo ||
        (long long)p_lo >= (long long)wk_hi + window) {
      continue;
    }
    const float* Qt = Qs + st * kRowsT * LD;
    const float* dOt = dOs + st * kRowsT * LD;
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<HD>(Kw, Qt, ka, rb, s);
    dot_tile<HD>(Vw, dOt, ka, rb, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = rb + 8 * c, row = r0 + r;
      const bool live = row < R;
      const int pos = qs + (live ? row_pos(row, G) : 0);
      const float lr = Ls[st * kRowsT + r], dr = Ds[st * kRowsT + r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.f, ds = 0.f;
        if (live && admissible(wk_lo + ka + 4 * i, pos, kv_end, window)) {
          float dcap;
          const float x = cap_score(s[i][c] * scale, softcap, &dcap);
          p = __expf(x - lr);
          ds = p * (dp[i][c] - dr) * dcap;
        }
        Pw[r * kLDW + ka + 4 * i] = p;
        Sw[r * kLDW + ka + 4 * i] = ds;
      }
    }
    __syncwarp();
    acc_tile<HD>(Pw, dOt, tr, td, acc_v);
    acc_tile<HD>(Sw, Qt, tr, td, acc_k);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < O::kNR; ++r) {
    const int j = wk_lo + tr * O::kNR + r;
    if (j < Skv) {
      const size_t off = kv_off(b, j, kh, Skv, Kh, HD);
      store_row<HD>(dk + off, acc_k[r], td, scale);
      store_row<HD>(dv + off, acc_v[r], td, 1.f);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* dout, const int32_t* q_start,
               const int32_t* kv_len, const float* out, const float* lse_in,
               float* dq, float* dk, float* dv, float* lse_buf, float* dsum,
               int B, int Sq, int Skv, int Kh, int G, int window,
               float softcap, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  static bool smem_set = false;  // above 48 KB needs the opt-in
  if (!smem_set) {
    cudaError_t err =
        allow_smem(attn_bwd_lse_kernel<float, HD>, lse_smem_bytes<HD>());
    if (err == cudaSuccess)
      err = allow_smem(attn_bwd_dq_kernel<HD>, dq_smem_bytes<HD>());
    if (err == cudaSuccess)
      err = allow_smem(attn_bwd_dkv_kernel<HD>, dkv_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int R = Sq * G;
  const long long bh = (long long)B * Kh;
  const int row_tiles = (R + kRowsB - 1) / kRowsB;
  const int key_tiles = (Skv + kKeysB - 1) / kKeysB;
  if (bh * row_tiles > INT_MAX || bh * key_tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* lse = lse_in;
  if (out != nullptr && lse_in != nullptr) {
    const long long rows = bh * R;
    const long long blocks = (rows * (HD / 4) + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    attn_bwd_dsum_kernel<HD><<<(unsigned)blocks, kThreads, 0, stream>>>(
        dout, out, dsum, rows, Sq, Kh, G);
  } else {
    attn_bwd_lse_kernel<float, HD>
        <<<dim3((R + kTile - 1) / kTile, Kh, B), kThreads,
           lse_smem_bytes<HD>(), stream>>>(q, k, v, dout, q_start, kv_len,
                                           lse_buf, dsum, Sq, Skv, Kh, G,
                                           window, softcap, scale);
    lse = lse_buf;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<HD><<<(unsigned)(bh * row_tiles), kBwdThreads,
                           dq_smem_bytes<HD>(), stream>>>(
      q, k, v, dout, q_start, kv_len, lse, dsum, dq, B, Sq, Skv, Kh, G,
      window, softcap, scale, row_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<HD><<<(unsigned)(bh * key_tiles), kBwdThreads,
                            dkv_smem_bytes<HD>(), stream>>>(
      q, k, v, dout, q_start, kv_len, lse, dsum, dk, dv, B, Sq, Skv, Kh, G,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the route's kernels on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for what it does not take.
// Every pointer is fp32 device memory, contiguous, 16-byte aligned, except
// the int32 q_start and kv_len.  With `out` (the forward's output) and
// `lse` ([B, Kh, Sq * G], the forward's log-sum-exp) both given, the saved
// route runs; with either null the recompute route, which writes the
// log-sum-exp into `lse_buf`.  `dsum` is scratch of B * Kh * Sq * G
// floats (`lse_buf` too, on the recompute route); window >= 1 (1 << 30
// for none); softcap <= 0 for none; head_dim 16, 32, 64 or 128.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* q_start, const void* kv_len,
                                   const void* out, const void* lse,
                                   void* dq, void* dk, void* dv,
                                   void* lse_buf, void* dsum, int B, int Sq,
                                   int Skv, int Kh, int G, int hd, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || G <= 0) return 0;
  if (B > 65535 || Kh > 65535) return (int)cudaErrorInvalidValue;
#define FA_BWD(HD)                                                          \
  return launch_bwd<HD>(                                                    \
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, \
      (const int32_t*)q_start, (const int32_t*)kv_len, (const float*)out,   \
      (const float*)lse, (float*)dq, (float*)dk, (float*)dv,                \
      (float*)lse_buf, (float*)dsum, B, Sq, Skv, Kh, G, window, softcap,    \
      (cudaStream_t)stream)
  switch (hd) {
    case 16: FA_BWD(16);
    case 32: FA_BWD(32);
    case 64: FA_BWD(64);
    case 128: FA_BWD(128);
  }
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
