// FlashAttention backward over the forward's layout, for Hopper (sm_90a).
//
// No Pallas kernel is replaced: the reference trains through its jnp
// attention (src/repro/models/transformer.py::_block_attention) and has no
// backward kernel.  This is the gradient of the function the forward
// (flash_attention.cu) computes, for the LM's training path:
//   q, dout    [B, Sq, Kh, G, hd]   grouped query heads and the gradient
//                                   of the forward's output
//   k, v       [B, Skv, Kh, hd]
//   q_start[B], kv_len[B]           int32, as the forward reads them
//   dq [B, Sq, Kh, G, hd], dk, dv [B, Skv, Kh, hd]   in q's type
// Key j is admissible for the query at position p when j < kv_len,
// j <= p and j > p - window; scores s = (q k) / sqrt(hd), capped as
// c = cap * tanh(s / cap) before the mask.  With P = softmax(c) over the
// admissible keys, o = P v and D = rowsum(dout * o):
//   dv_j = sum_r P_rj dout_r,  dP_rj = dout_r . v_j,
//   dS_rj = P_rj (dP_rj - D_r) (1 - tanh^2(s_rj / cap) under a cap),
//   dq_r = sum_j dS_rj k_j / sqrt(hd),  dk_j = sum_r dS_rj q_r / sqrt(hd).
// A row with no admissible key has o = 0 and takes part in no pair: its
// dq is 0 and it adds nothing to dk, dv (no NaN), as in the plain version.
//
// Bound on this card by operations: ~10 hd flops per admissible (query,
// key) pair (the five products above) against ~8 hd bytes of operands per
// query row and key.  Simple fp32 FMA tiles in the spirit of the forward's
// rows route, in three kernels, none with atomics, so the result does not
// depend on the schedule:
// * attn_bwd_lse_kernel: a block per 64 query rows of one (batch, kv
//   head) recomputes each row's log-sum-exp under the same mask (the
//   forward does not keep it) and its output o in fp32, online, then D,
//   into fp32 scratch.  D is not taken from the forward's output: in bf16
//   that is rounded, and dq = P (dP - D) k cancels, so the rounding of o
//   would reach dq far beyond one bf16 step;
// * attn_bwd_dq_kernel: a block per 64 query rows walks the 64-key tiles
//   the rows can see, recomputes P from the log-sum-exp and dP from dout
//   and v, and sums dS k into dq;
// * attn_bwd_dkv_kernel: a block per 64 keys of one kv head walks every
//   query row of its G query heads that can see them (causal order and the
//   window bound the range), and sums P^T dout into dv and dS^T q into dk.
// Every tile in shared memory has rows padded to hd + 1 floats, so both the
// row-broadcast and the column reads are free of bank conflicts; 256
// threads hold 4x4 score tiles and 4 x hd/16 accumulators each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kPS = kTile + 1;     // padded row of a score tile

// ------------------------------------------------------------ loads, stores

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 4 consecutive elements as floats; p is aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
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

// ------------------------------------------------------------ tile helpers

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
template <int HD>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (HD + 1) + kTile * kPS);
}
template <int HD>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (HD + 1) + 2 * kTile * kPS + 2 * kTile);
}

// ------------------------------------------------- log-sum-exp and D rows

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
  extern __shared__ float smem[];
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

// ------------------------------------------------------------------- dq

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const int32_t* __restrict__ q_start,
                   const int32_t* __restrict__ kv_len,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dq, int Sq,
                   int Skv, int Kh, int G, int window, float softcap,
                   float scale) {
  constexpr int DC = HD / 16, LD = HD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [64][LD], pre-scaled
  float* dOs = Qs + kTile * LD;        // [64][LD]
  float* Ks = dOs + kTile * LD;        // [64][LD]
  float* Vs = Ks + kTile * LD;         // [64][LD]
  float* Ss = Vs + kTile * LD;         // [64][kPS]: dS of the tile
  const int b = blockIdx.z, kh = blockIdx.y, row0 = blockIdx.x * kTile;
  const int R = Sq * G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  load_rows<T, HD>(Qs, q, b, kh, row0, R, Sq, Kh, G, scale);
  load_rows<T, HD>(dOs, dout, b, kh, row0, R, Sq, Kh, G, 1.f);

  int pos[4];
  bool live[4];
  float lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    live[i] = row < R;
    pos[i] = qs + (live[i] ? row / G : 0);
    const size_t at = ((size_t)b * Kh + kh) * R + (live[i] ? row : 0);
    lrow[i] = live[i] ? lse[at] : 0.f;
    drow[i] = live[i] ? dsum[at] : 0.f;
  }
  const int last_row = min(row0 + kTile, R) - 1;
  const int kv_hi = min(kv_end, qs + last_row / G + 1);
  const int first_pos = qs + row0 / G;
  const int kv_lo = (max(0, first_pos - window + 1) / kTile) * kTile;

  float acc[4][DC] = {};
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();  // the last tile's K and dS are read
    load_keys<T, HD>(Ks, k, b, kh, kv0, kv_hi, Skv, Kh);
    load_keys<T, HD>(Vs, v, b, kh, kv0, kv_hi, Skv, Kh);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<HD>(Qs, Ks, ty, tx, s);
    tile_dot<HD>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float ds = 0.f;
        if (live[i] && admissible(kv0 + tx + 16 * c, pos[i], kv_hi, window)) {
          float dcap;
          const float x = cap_score(s[i][c], softcap, &dcap);
          ds = __expf(x - lrow[i]) * (dp[i][c] - drow[i]) * dcap;
        }
        Ss[(ty * 4 + i) * kPS + tx + 16 * c] = ds;
      }
    __syncthreads();
    tile_acc<HD>(Ss, Ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row < R) {
      T* out = dq + q_off(b, row / G, kh, row % G, Sq, Kh, G, HD);
#pragma unroll
      for (int c = 0; c < DC; ++c) store(out + tx + 16 * c, acc[i][c] * scale);
    }
  }
}

// --------------------------------------------------------------- dk, dv

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const int32_t* __restrict__ q_start,
                    const int32_t* __restrict__ kv_len,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Skv, int Kh, int G,
                    int window, float softcap, float scale) {
  constexpr int DC = HD / 16, LD = HD + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [64][LD]: this block's keys
  float* Vs = Ks + kTile * LD;         // [64][LD]
  float* Qs = Vs + kTile * LD;         // [64][LD]: a row tile, pre-scaled
  float* dOs = Qs + kTile * LD;        // [64][LD]
  float* Ps = dOs + kTile * LD;        // [64 keys][kPS rows]: P^T
  float* Ss = Ps + kTile * kPS;        // [64 keys][kPS rows]: dS^T
  float* Ls = Ss + kTile * kPS;        // [64]: the row tile's lse
  float* Ds = Ls + kTile;              // [64]: its D
  const int b = blockIdx.z, kh = blockIdx.y, j0 = blockIdx.x * kTile;
  const int R = Sq * G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  load_keys<T, HD>(Ks, k, b, kh, j0, kv_end, Skv, Kh);
  load_keys<T, HD>(Vs, v, b, kh, j0, kv_end, Skv, Kh);

  float acc_k[4][DC] = {}, acc_v[4][DC] = {};
  if (j0 < kv_end) {
    // rows whose position can see a key of [j0, j_last]: pos >= j0 and
    // pos < j_last + window
    const int j_last = min(j0 + kTile, kv_end) - 1;
    const long long sq_hi_ll =
        min((long long)Sq, (long long)j_last + window - qs);
    const int sq_lo = max(0, j0 - qs);
    const int sq_hi = (int)max((long long)sq_lo, sq_hi_ll);
    const size_t base = ((size_t)b * Kh + kh) * R;
    for (int r0 = sq_lo * G; r0 < sq_hi * G; r0 += kTile) {
      __syncthreads();  // the last row tile, P and dS are read
      load_rows<T, HD>(Qs, q, b, kh, r0, R, Sq, Kh, G, scale);
      load_rows<T, HD>(dOs, dout, b, kh, r0, R, Sq, Kh, G, 1.f);
      if (tid < kTile) {
        const int row = r0 + tid;
        Ls[tid] = row < R ? lse[base + row] : 0.f;
        Ds[tid] = row < R ? dsum[base + row] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      tile_dot<HD>(Ks, Qs, ty, tx, s);
      tile_dot<HD>(Vs, dOs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = tx + 16 * c, row = r0 + r;
          float p = 0.f, ds = 0.f;
          if (row < R &&
              admissible(j0 + ty * 4 + i, qs + row / G, kv_end, window)) {
            float dcap;
            const float x = cap_score(s[i][c], softcap, &dcap);
            p = __expf(x - Ls[r]);
            ds = p * (dp[i][c] - Ds[r]) * dcap;
          }
          Ps[(ty * 4 + i) * kPS + r] = p;
          Ss[(ty * 4 + i) * kPS + r] = ds;
        }
      __syncthreads();
      tile_acc<HD>(Ps, dOs, ty, tx, acc_v);
      tile_acc<HD>(Ss, Qs, ty, tx, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty * 4 + i;
    if (j < Skv) {
      const size_t off = kv_off(b, j, kh, Skv, Kh, HD);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        store(dk + off + tx + 16 * c, acc_k[i][c]);
        store(dv + off + tx + 16 * c, acc_v[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* dout, const void* q_start, const void* kv_len,
               void* dq, void* dk, void* dv, float* lse, float* dsum, int B,
               int Sq, int Skv, int Kh, int G, int window, float softcap,
               cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  static bool smem_set = false;  // above 48 KB needs the opt-in
  if (!smem_set) {
    cudaError_t err =
        allow_smem(attn_bwd_lse_kernel<T, HD>, lse_smem_bytes<HD>());
    if (err == cudaSuccess)
      err = allow_smem(attn_bwd_dq_kernel<T, HD>, dq_smem_bytes<HD>());
    if (err == cudaSuccess)
      err = allow_smem(attn_bwd_dkv_kernel<T, HD>, dkv_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int R = Sq * G;
  const dim3 rows((R + kTile - 1) / kTile, Kh, B);
  const dim3 keys((Skv + kTile - 1) / kTile, Kh, B);
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v;
  const T* tdo = (const T*)dout;
  const int32_t *st = (const int32_t*)q_start, *ln = (const int32_t*)kv_len;
  attn_bwd_lse_kernel<T, HD><<<rows, kThreads, lse_smem_bytes<HD>(),
                               stream>>>(tq, tk, tv, tdo, st, ln, lse, dsum,
                                         Sq, Skv, Kh, G, window, softcap,
                                         scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<T, HD><<<rows, kThreads, dq_smem_bytes<HD>(), stream>>>(
      tq, tk, tv, tdo, st, ln, lse, dsum, (T*)dq, Sq, Skv, Kh, G, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<T, HD><<<keys, kThreads, dkv_smem_bytes<HD>(),
                               stream>>>(tq, tk, tv, tdo, st, ln, lse, dsum,
                                         (T*)dk, (T*)dv, Sq, Skv, Kh, G,
                                         window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for what it does not take.
// Pointers are device memory, contiguous, 16-byte aligned; lse and dsum
// are fp32 scratch of B * Kh * Sq * G floats each; window >= 1 (1 << 30
// for none); softcap <= 0 for none; dtype 0 is fp32, 1 bf16; head_dim 16,
// 32, 64 or 128.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* q_start, const void* kv_len,
                                   void* dq, void* dk, void* dv, void* lse,
                                   void* dsum, int B,
                                   int Sq, int Skv, int Kh, int G, int hd,
                                   int window, float softcap, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || G <= 0) return 0;
  if (B > 65535 || Kh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float *pl = (float*)lse, *pd = (float*)dsum;
#define FA_BWD(T, HD)                                                       \
  return launch_bwd<T, HD>(q, k, v, dout, q_start, kv_len, dq, dk, dv,     \
                           pl, pd, B, Sq, Skv, Kh, G, window, softcap, s)
  if (dtype == 0) {
    switch (hd) {
      case 16: FA_BWD(float, 16);
      case 32: FA_BWD(float, 32);
      case 64: FA_BWD(float, 64);
      case 128: FA_BWD(float, 128);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: FA_BWD(__nv_bfloat16, 16);
      case 32: FA_BWD(__nv_bfloat16, 32);
      case 64: FA_BWD(__nv_bfloat16, 64);
      case 128: FA_BWD(__nv_bfloat16, 128);
    }
  }
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
