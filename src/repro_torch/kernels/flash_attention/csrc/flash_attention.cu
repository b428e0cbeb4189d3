// FlashAttention forward over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py::flash_attention_pallas, and computes the wider
// function of the reference model's attention (src/repro/models/
// transformer.py::_block_attention) that the serving path needs:
//   q   [B, Sq, Kh, G, hd]   grouped query heads (G per kv head)
//   k,v [B, Skv, Kh, hd]     the cache itself, read in place: no transpose
//                            and no repeat of the kv heads to G copies
//   q_start[B], kv_len[B]    int32: query i of batch b sits at position
//                            q_start[b] + i; keys at or past kv_len[b]
//                            are not read (or reach no product)
//   out [B, Sq, Kh, G, hd]   q's type (fp32 or bf16)
// A key j is admissible for a query at position p when j <= p,
// j > p - window and j < kv_len (after the softcap cap*tanh(s/cap)).
// Softmax statistics and the accumulator are fp32; the output is
// acc / max(l, 1e-30), so a query with no admissible key gets zeros.
// The rows of one (batch, kv head) are r = sq*G + g, R = Sq*G of them.
//
// Three routes, one launch each (split: two), chosen by the wrapper before
// launch (ops.py::route):
//
// * tc (bf16, hd 64/128, R > 8, G dividing 128; prefill).  Bound by
//   operations: ~4*hd flops per admissible (query, key) pair against ~4*hd
//   bytes of k/v per key.  FA3-style tiles on the tensor cores: a block
//   owns 128 query rows of one (batch, kv head), two consumer warpgroups of
//   64 rows and one producer warp.  The producer issues TMA loads of Q
//   once (a 5-D map (hd, G, Kh, Sq, B): rows past Sq zero-filled) and of
//   128-key K and V tiles (4-D maps (hd, Kh, Skv, B) over the cache in
//   place) into a 2-stage ring of 128-byte-swizzled 64-column boxes, with
//   a full and an empty mbarrier per stage.  Each consumer computes
//   S = Q K^T with wgmma.m64n128k16 (both operands K-major in shared
//   memory), runs the online softmax on S in registers (exp2 with log2(e)
//   folded into the scale), converts P to bf16 in registers, where the
//   accumulator fragment of S is the A fragment of the next product, and
//   accumulates O += P V with the register-A wgmma (V MN-major: the
//   transpose bit).  Rounding P to bf16 is where tc differs from rows
//   (the reference's bf16 tolerance is 2e-2).  Tiles wholly outside a
//   warpgroup's causal, kv_len and window range are skipped; only tiles
//   that straddle an edge are masked.  TMA zero-fills only past Skv, so on
//   the tile that straddles kv_len the V rows past it are zeroed in shared
//   memory before the product (p = 0 there, but 0 * NaN is NaN).  Blocks
//   run the heaviest row tiles (the last causal ones) first, so the last
//   wave is made of short tiles.
// * split (R <= 8, hd % 32 == 0, fp32 or bf16; every decode tick).  Bound
//   by bytes: every cached key is read once for a handful of flops.
//   Flash-decoding: the grid is (Kh, B, n_split) over 256-key chunks of
//   the cache, n_split from Skv (a static shape), so the wrapper never
//   reads kv_len on the host; a chunk at or past a slot's kv_len exits at
//   once.  Each warp streams its keys with 16-byte loads (one key row per
//   hd*sizeof(T)/16 lanes), and the G query rows of the kv head share
//   every load.  Partial (m, l, acc) go to fp32 scratch; a second kernel
//   merges a slot's chunks by log-sum-exp and writes q's type.
// * rows (everything else: fp32 prefill, hd 16/32).  Scalar fp32 FMA: a
//   block owns 64 query rows of one kv head and walks 64-key tiles in
//   shared memory with an online softmax, 4x4 register tiles.  Tiles at or
//   past kv_len, past the block's last causal position and wholly before
//   its window are skipped.  Given an `lse` pointer (the training path's
//   forward), it also writes each row's log-sum-exp m + log(l), fp32
//   [B, Kh, Sq * G] (0 for a row with no admissible key), which the
//   backward (flash_attention_bwd.cu) reads instead of recomputing it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "../../_hopper/hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;   // rows and split blocks

// ------------------------------------------------------------ loads, stores

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

__device__ __forceinline__ float capped(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

__device__ __forceinline__ bool admissible(int j, int pos, int kv_end,
                                           int window) {
  return j < kv_end && j <= pos && j > pos - window;
}

// offset of q/out row (b, sq, kh, g) and of k/v row (b, j, kh)
__device__ __forceinline__ size_t q_off(int b, int sq, int kh, int g, int Sq,
                                        int Kh, int G, int hd) {
  return ((((size_t)b * Sq + sq) * Kh + kh) * G + g) * hd;
}
__device__ __forceinline__ size_t kv_off(int b, int j, int kh, int Skv,
                                         int Kh, int hd) {
  return (((size_t)b * Skv + j) * Kh + kh) * hd;
}

// -------------------------------------------------------------- rows kernel

constexpr int kBQ = 64;    // query rows per block
constexpr int kBKV = 64;   // keys per tile

template <int HD>
__host__ __device__ constexpr int rows_k_floats() {
  // the K tile (padded rows) and, after the scores, the P tile share it
  return kBKV * (HD + 1) > kBQ * (kBKV + 1) ? kBKV * (HD + 1)
                                            : kBQ * (kBKV + 1);
}

template <int HD>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return sizeof(float) * (kBQ * HD + rows_k_floats<HD>() + kBKV * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ q_start,
                 const int32_t* __restrict__ kv_len, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int Kh, int G,
                 int window, float softcap, float scale) {
  constexpr int DC = HD / 16;               // output dims per thread
  constexpr int KS = HD + 1;                // padded K row: no bank conflicts
  constexpr int PS = kBKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                         // [kBQ][HD], pre-scaled
  float* Ks = Qs + kBQ * HD;                // [kBKV][KS]; then P [kBQ][PS]
  float* Vs = Ks + rows_k_floats<HD>();     // [kBKV][HD]

  const int b = blockIdx.z, kh = blockIdx.y, row0 = blockIdx.x * kBQ;
  const int R = Sq * G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);

  for (int e = tid * 4; e < kBQ * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < R) {
      load4(q + q_off(b, row / G, kh, row % G, Sq, Kh, G, HD) + d, t);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) Qs[r * HD + d + i] = t[i] * scale;
  }

  int pos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    live[i] = row < R;
    pos[i] = qs + (live[i] ? row / G : 0);
  }
  // keys this block can need: up to its last row's position, from its
  // first row's window start, below kv_len
  const int last_row = min(row0 + kBQ, R) - 1;
  const int kv_hi = min(kv_end, qs + last_row / G + 1);
  const int first_pos = qs + row0 / G;
  const int kv_lo = (max(0, first_pos - window + 1) / kBKV) * kBKV;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kBKV) {
    __syncthreads();  // the last tile's P and V are read
    for (int e = tid * 4; e < kBKV * HD; e += kThreads * 4) {
      const int j = e / HD, d = e % HD;
      float tk[4] = {0.f, 0.f, 0.f, 0.f}, tv[4] = {0.f, 0.f, 0.f, 0.f};
      if (kv0 + j < kv_hi) {
        const size_t off = kv_off(b, kv0 + j, kh, Skv, Kh, HD) + d;
        load4(k + off, tk);
        load4(v + off, tv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Ks[j * KS + d + i] = tk[i];
        Vs[j * HD + d + i] = tv[i];
      }
    }
    __syncthreads();

    // scores of rows ty*4+i against keys tx+16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * HD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = live[i] && admissible(kv0 + tx + 16 * c, pos[i], kv_hi,
                                      window);
        s[i][c] = ok[c] ? capped(s[i][c], softcap) : kNegInf;
        mt = fmaxf(mt, s[i][c]);
      }
      // the 16 lanes of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      corr[i] = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = ok[c] ? __expf(s[i][c] - m_new) : 0.f;
        rs += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done reading K
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty * 4 + i) * PS + tx + 16 * c] = s[i][c];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row < R) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* o = out + q_off(b, row / G, kh, row % G, Sq, Kh, G, HD);
#pragma unroll
      for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[i][c] * inv);
      // m and l are the same on the 16 lanes of the row
      if (lse != nullptr && tx == 0) {
        lse[((size_t)b * Kh + kh) * R + row] =
            l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      }
    }
  }
}

// ------------------------------------------------------------ split route

constexpr int kSplitKeys = 256;   // keys per chunk (ops.py SPLIT_KEYS)
constexpr int kMaxRows = 8;       // query rows per (batch, kv head)
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;

// 16 bytes of the cache, read through the non-coherent path (the cache is
// not written during the launch), and unpacked to floats where used
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void unpack16(const uint4& t, float* o, float) {
  o[0] = __uint_as_float(t.x); o[1] = __uint_as_float(t.y);
  o[2] = __uint_as_float(t.z); o[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack16(const uint4& t, float* o,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The keys of chunk blockIdx.z of one (kv head, slot) against its R <= ROWS
// query rows; writes the chunk's fp32 partial softmax state (m, l, acc)
// at index ((b * Kh + kh) * n_split + chunk) * R + r.
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int32_t* __restrict__ q_start,
                  const int32_t* __restrict__ kv_len,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int Sq, int Skv, int Kh,
                  int G, int window, float softcap, float scale,
                  int n_split) {
  constexpr int DPL = 16 / sizeof(T);   // dims per lane: one 16-byte load
  constexpr int LK = HD / DPL;          // lanes per key row
  constexpr int KW = 32 / LK;           // keys per warp-wide load
  // K (and V) loads per lane per step, all in flight at once; with more
  // than 2 rows, 8 would spill
  constexpr int U = ROWS <= 2 ? 8 : 4;
  constexpr int STEP = KW * U;          // keys per warp per step
  static_assert(LK >= 2 && LK <= 32, "a key row spans 2..32 lanes");
  __shared__ float m_s[kWarps][ROWS], l_s[kWarps][ROWS];
  __shared__ __align__(16) float a_s[kWarps][ROWS][HD];

  const int kh = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int R = Sq * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LK, d0 = (lane % LK) * DPL;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  const int kv_hi = min(kv_end, qs + (R - 1) / G + 1);
  const int kv_lo = max(0, qs - window + 1);
  const int lo = max(kv_lo, c * kSplitKeys);
  const int hi = min(kv_hi, (c + 1) * kSplitKeys);
  const size_t part = ((size_t)b * Kh + kh) * n_split + c;
  if (lo >= hi) {   // no key of this slot in the chunk
    if (threadIdx.x < R) {
      part_m[part * R + threadIdx.x] = kNegInf;
      part_l[part * R + threadIdx.x] = 0.f;
    }
    return;
  }

  float qr[ROWS][DPL], acc[ROWS][DPL], m[ROWS], l[ROWS];
  int pos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    pos[r] = qs + r / G;
#pragma unroll
    for (int t = 0; t < DPL; ++t) qr[r][t] = acc[r][t] = 0.f;
    if (r < R) {
      unpack16(load16(q + q_off(b, r / G, kh, r % G, Sq, Kh, G, HD) + d0),
               qr[r], T());
#pragma unroll
      for (int t = 0; t < DPL; ++t) qr[r][t] *= scale;
    }
  }

  for (int j0 = lo + warp * STEP; j0 < hi; j0 += kWarps * STEP) {
    // every load of the step in flight at once, kept packed (4 registers
    // per 16 bytes) until used
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * KW + sub;
      if (j < hi) {
        const size_t off = kv_off(b, j, kh, Skv, Kh, HD) + d0;
        kr[u] = load16(k + off);
        vr[u] = load16(v + off);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= R) break;
      float s[U];
      bool ok[U];
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[DPL], d = 0.f;
        unpack16(kr[u], kf, T());
#pragma unroll
        for (int t = 0; t < DPL; ++t) d = fmaf(qr[r][t], kf[t], d);
#pragma unroll
        for (int off = LK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const int j = j0 + u * KW + sub;
        ok[u] = j < hi && admissible(j, pos[r], kv_hi, window);
        s[u] = ok[u] ? capped(d, softcap) : kNegInf;
        mt = fmaxf(mt, s[u]);
      }
#pragma unroll
      for (int off = LK; off < 32; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float corr = __expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? __expf(s[u] - m_new) : 0.f;
        float vf[DPL];
        unpack16(vr[u], vf, T());
        rs += p;
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[r][t] = fmaf(p, vf[t], acc[r][t]);
      }
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
    }
  }

  // the lanes of one key row hold the warp's sums once the key groups
  // (lanes LK apart) are added; then the warps merge in shared memory
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int off = LK; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int t = 0; t < DPL; ++t)
        acc[r][t] += __shfl_xor_sync(0xffffffffu, acc[r][t], off);
    }
    if (lane < LK) {
#pragma unroll
      for (int t = 0; t < DPL; ++t) a_s[warp][r][d0 + t] = acc[r][t];
    }
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(m_s[w][r] - M);
      L += l_s[w][r] * f;
      A += a_s[w][r][d] * f;
    }
    part_acc[(part * R + r) * HD + d] = A;
    if (d == 0) {
      part_m[part * R + r] = M;
      part_l[part * R + r] = L;
    }
  }
}

// Merges the chunks that hold keys of one (kv head, slot) by log-sum-exp
// and writes its R output rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
attn_combine_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc,
                    const int32_t* __restrict__ q_start,
                    const int32_t* __restrict__ kv_len, T* __restrict__ out,
                    int Sq, int Skv, int Kh, int G, int window, int n_split) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int R = Sq * G;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  const int kv_hi = min(kv_end, qs + (R - 1) / G + 1);
  const int kv_lo = max(0, qs - window + 1);
  // the chunks s_lo .. s_end - 1 hold this slot's keys
  const int s_lo = kv_lo / kSplitKeys;
  const int s_end = kv_hi > kv_lo ? (kv_hi - 1) / kSplitKeys + 1 : s_lo;
  const size_t base = ((size_t)b * Kh + kh) * n_split;
  for (int e = threadIdx.x; e < R * HD; e += kCombineThreads) {
    const int r = e / HD, d = e % HD;
    float M = kNegInf;
    for (int s = s_lo; s < s_end; ++s)
      M = fmaxf(M, part_m[(base + s) * R + r]);
    float L = 0.f, A = 0.f;
    for (int s = s_lo; s < s_end; ++s) {
      const size_t i = (base + s) * R + r;
      const float f = __expf(part_m[i] - M);
      L += part_l[i] * f;
      A += part_acc[i * HD + d] * f;
    }
    store(out + q_off(b, r / G, kh, r % G, Sq, Kh, G, HD) + d,
          A / fmaxf(L, 1e-30f));
  }
}

// --------------------------------------------------------------- tc route

constexpr int kTcRows = 128;     // query rows per block: 2 warpgroups x 64
constexpr int kTcKeys = 128;     // keys per K/V tile
constexpr int kTcStages = 2;
constexpr int kTcThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kTcRow = 128;      // bytes of one swizzled box row: 64 bf16
constexpr int kTcBox = 128 * kTcRow;   // a 64-column box of 128 rows: 16 KB
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcAttnShape {
  static constexpr int kBoxes = HD / 64;            // boxes of a 128-row tile
  static constexpr int kTile = kBoxes * kTcBox;     // Q, or K or V of a stage
  static constexpr int kStage = 2 * kTile;          // K and V
  // Q and the ring, 1 KB to align them to the swizzle pattern, and the
  // barriers: full and empty per stage, one for Q
  static constexpr int kSmem =
      1024 + kTile + kTcStages * kStage + 8 * (2 * kTcStages + 1);
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Block i owns row tile n_tiles - 1 - i / (B * Kh) (heaviest first) of
// kv head i % Kh, batch (i / Kh) % B.  Warpgroups 0 and 1 consume (rows
// 0-63 and 64-127 of the tile); warp 8 produces (one thread).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const int32_t* __restrict__ q_start,
               const int32_t* __restrict__ kv_len,
               __nv_bfloat16* __restrict__ out, int B, int Sq, int Skv,
               int Kh, int G, int window, float softcap, float scale,
               int n_tiles) {
  using S = TcAttnShape<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qt = (raw + 1023u) & ~1023u;   // Q, swizzle-aligned
  const uint32_t ring = qt + S::kTile;
  uint8_t* const base = smem_raw + (qt - raw);  // generic address of qt
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + S::kTile + kTcStages * S::kStage);
  uint64_t* empty = full + kTcStages;
  uint64_t* q_full = empty + kTcStages;

  const int tile = n_tiles - 1 - (int)blockIdx.x / (B * Kh);
  const int kh = (int)blockIdx.x % Kh, b = ((int)blockIdx.x / Kh) % B;
  const int R = Sq * G, row0 = tile * kTcRows;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  // keys the block can need: up to its last row's position, from its first
  // row's window start (rounded down to a tile), below kv_len
  const int kv_hi = min(kv_end, qs + (min(row0 + kTcRows, R) - 1) / G + 1);
  const int kv_lo = max(0, qs + row0 / G - window + 1) / kTcKeys * kTcKeys;
  const int n_kv = kv_hi > kv_lo ? (kv_hi - kv_lo + kTcKeys - 1) / kTcKeys
                                 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, S::kTile);
      for (int j = 0; j < S::kBoxes; ++j)
        tma_load_5d(qt + j * kTcBox, &tm_q, q_full, 64 * j, 0, kh, row0 / G,
                    b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages)
          mbar_wait(&empty[s], ((it / kTcStages) - 1) & 1);
        const uint32_t kt = ring + s * S::kStage, vt = kt + S::kTile;
        const int kv0 = kv_lo + it * kTcKeys;
        mbar_expect_tx(&full[s], S::kStage);
        for (int j = 0; j < S::kBoxes; ++j) {
          tma_load_4d(kt + j * kTcBox, &tm_k, &full[s], 64 * j, kh, kv0, b);
          tma_load_4d(vt + j * kTcBox, &tm_v, &full[s], 64 * j, kh, kv0, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  // this warpgroup's rows and the positions of its first and last row
  const int wrow0 = row0 + wg * 64;
  const bool rows_live = wrow0 < R;
  const int w_first = qs + wrow0 / G;
  const int w_last = qs + (min(wrow0 + 64, R) - 1) / G;
  // this thread's two rows (accumulator rows l/4 and l/4 + 8 of its warp)
  const int ra = wrow0 + warp * 16 + lane / 4;
  const int pos[2] = {qs + ra / G, qs + (ra + 8) / G};
  const float scale_log2 = scale * kLog2e;

  constexpr int kO = HD / 2;   // O accumulator registers
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kTcStages;
    const int kv0 = kv_lo + it * kTcKeys;
    const uint32_t kt = ring + s * S::kStage, vt = kt + S::kTile;
    mbar_wait(&full[s], (it / kTcStages) & 1);
    // the tile is needed when one of its keys is admissible for one row
    const bool need = rows_live && kv0 <= w_last &&
                      kv0 + kTcKeys - 1 > w_first - window;
    if (need) {
      // masking only where the tile straddles the diagonal, kv_len or the
      // window's edge
      const bool edge = kv0 + kTcKeys - 1 > w_first ||
                        kv0 + kTcKeys > kv_end || kv0 <= w_last - window;
      if (kv0 + kTcKeys > kv_end) {
        // V rows past kv_len reach the product with p = 0, and 0 * NaN is
        // NaN: zero them (whole 128-byte rows, so the swizzle is moot)
        const int z0 = kv_end - kv0;
        const int n16 = (kTcKeys - z0) * (kTcRow / 16);
        uint8_t* const vg = base + (vt - qt);
        for (int e = t; e < S::kBoxes * n16; e += 128) {
          *reinterpret_cast<uint4*>(vg + (e / n16) * kTcBox + z0 * kTcRow +
                                    (e % n16) * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }

      // S = Q K^T: A is this warpgroup's 64 Q rows, B the K tile, both
      // K-major (hd contiguous); a k16 step moves 32 bytes in a swizzled
      // row, and every 4 steps to the next 64-column box
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTcBox + (kk % 4) * 32;
        wgmma_n128<0>(sc, smem_desc(qt + wg * 64 * kTcRow + off, 16, 1024),
                      smem_desc(kt + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // online softmax in the log2 domain
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j * 4 + e];
          x = softcap > 0.f ? softcap * tanhf(x * scale / softcap) * kLog2e
                            : x * scale_log2;
          if (edge) {
            const int col = kv0 + j * 8 + (lane % 4) * 2 + (e & 1);
            const int p = pos[e >> 1];
            const bool ok = col <= p /* causal */
                            && col < kv_end && col > p - window;
            x = ok ? x : kNegInf;
          }
          sc[j * 4 + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], mb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        // a row with no admissible key yet: masked scores give p = 0
        mb[i] = m_new == kNegInf ? 0.f : m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(sc[j * 4 + e] - mb[e >> 1]);
          sc[j * 4 + e] = p;
          rs[e >> 1] += p;
        }
      }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
      // P in bf16 as the A fragments of P V: keys 16kk .. 16kk + 15 are
      // accumulator chunks 2kk and 2kk + 1
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j * 4 + 0] *= corr[0];
        o[j * 4 + 1] *= corr[0];
        o[j * 4 + 2] *= corr[1];
        o[j * 4 + 3] *= corr[1];
      }

      // O += P V: B is the V tile, MN-major (hd contiguous): 64-column
      // boxes 16 KB apart, 8-key groups 1 KB apart; a k16 step is 2 KB
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t db = smem_desc(vt + kk * 16 * kTcRow, kTcBox, 1024);
        if constexpr (HD == 128) {
          wgmma_n128_rs<1>(o, pa[kk], db);
        } else {
          wgmma_n64_rs<1>(o, pa[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
    }
    __syncwarp();
    if (t == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= R) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + q_off(b, r / G, kh, r % G, Sq, Kh, G, HD);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(o[j * 4 + 2 * i] * inv,
                                o[j * 4 + 2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int HD>
int launch_rows(const void* q, const void* k, const void* v,
                const void* q_start, const void* kv_len, void* out,
                float* lse, int B, int Sq, int Skv, int Kh, int G, int window,
                float softcap, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  static bool smem_set = false;  // above 48 KB needs the opt-in
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_rows_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((Sq * G + kBQ - 1) / kBQ, Kh, B);
  attn_rows_kernel<T, HD><<<grid, kThreads, rows_smem_bytes<HD>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)q_start,
      (const int32_t*)kv_len, (T*)out, lse, Sq, Skv, Kh, G, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int ROWS>
int launch_split_rows(const void* q, const void* k, const void* v,
                      const void* q_start, const void* kv_len, float* part_m,
                      float* part_l, float* part_acc, int B, int Sq, int Skv,
                      int Kh, int G, int window, float softcap, int n_split,
                      cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  attn_split_kernel<T, HD, ROWS><<<dim3(Kh, B, n_split), kThreads, 0,
                                   stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)q_start,
      (const int32_t*)kv_len, part_m, part_l, part_acc, Sq, Skv, Kh, G,
      window, softcap, scale, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_split(const void* q, const void* k, const void* v,
                 const void* q_start, const void* kv_len, void* out,
                 float* part_m, float* part_l, float* part_acc, int B, int Sq,
                 int Skv, int Kh, int G, int window, float softcap,
                 int n_split, cudaStream_t stream) {
  const int R = Sq * G;
  int err;
  if (R <= 1) {
    err = launch_split_rows<T, HD, 1>(q, k, v, q_start, kv_len, part_m,
                                      part_l, part_acc, B, Sq, Skv, Kh, G,
                                      window, softcap, n_split, stream);
  } else if (R <= 2) {
    err = launch_split_rows<T, HD, 2>(q, k, v, q_start, kv_len, part_m,
                                      part_l, part_acc, B, Sq, Skv, Kh, G,
                                      window, softcap, n_split, stream);
  } else if (R <= 4) {
    err = launch_split_rows<T, HD, 4>(q, k, v, q_start, kv_len, part_m,
                                      part_l, part_acc, B, Sq, Skv, Kh, G,
                                      window, softcap, n_split, stream);
  } else {
    err = launch_split_rows<T, HD, 8>(q, k, v, q_start, kv_len, part_m,
                                      part_l, part_acc, B, Sq, Skv, Kh, G,
                                      window, softcap, n_split, stream);
  }
  if (err != 0) return err;
  attn_combine_kernel<T, HD><<<dim3(Kh, B), kCombineThreads, 0, stream>>>(
      part_m, part_l, part_acc, (const int32_t*)q_start,
      (const int32_t*)kv_len, (T*)out, Sq, Skv, Kh, G, window, n_split);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v,
              const void* q_start, const void* kv_len, void* out, int B,
              int Sq, int Skv, int Kh, int G, int window, float softcap,
              cudaStream_t stream) {
  using S = TcAttnShape<HD>;
  const cuuint64_t e = 2;   // bytes of a bf16
  // q as (hd, G, Kh, Sq, B): a box of 128 rows r = sq * G + g
  const cuuint64_t q_dims[5] = {(cuuint64_t)HD, (cuuint64_t)G,
                                (cuuint64_t)Kh, (cuuint64_t)Sq,
                                (cuuint64_t)B};
  const cuuint64_t q_strides[4] = {e * HD, e * HD * G, e * HD * G * Kh,
                                   e * HD * G * Kh * Sq};
  const cuuint32_t q_box[5] = {64, (cuuint32_t)G, 1,
                               (cuuint32_t)(kTcRows / G), 1};
  // the cache as (hd, Kh, Skv, B): a box of 128 keys of one kv head
  const cuuint64_t kv_dims[4] = {(cuuint64_t)HD, (cuuint64_t)Kh,
                                 (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kv_strides[3] = {e * HD, e * HD * Kh, e * HD * Kh * Skv};
  const cuuint32_t kv_box[4] = {64, 1, kTcKeys, 1};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bf16(&tm_q, q, 5, q_dims, q_strides, q_box) ||
      !encode_bf16(&tm_k, k, 4, kv_dims, kv_strides, kv_box) ||
      !encode_bf16(&tm_v, v, 4, kv_dims, kv_strides, kv_box)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (Sq * G + kTcRows - 1) / kTcRows;
  const long long blocks = (long long)n_tiles * B * Kh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return (int)err;
  attn_tc_kernel<HD><<<(unsigned)blocks, kTcThreads, S::kSmem, stream>>>(
      tm_q, tm_k, tm_v, (const int32_t*)q_start, (const int32_t*)kv_len,
      (__nv_bfloat16*)out, B, Sq, Skv, Kh, G, window, softcap,
      (float)(1.0 / sqrt((double)HD)), n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for what its route does not take.
// Pointers are device memory, contiguous, 16-byte aligned; window >= 1
// (1 << 30 for none); softcap <= 0 for none; dtype 0 is fp32, 1 bf16.

// The rows route: head_dim 16, 32, 64 or 128, any R.  `lse` is null, or
// fp32 [B, Kh, Sq * G] for each row's log-sum-exp.
extern "C" int flash_attention_rows(const void* q, const void* k,
                                    const void* v, const void* q_start,
                                    const void* kv_len, void* out, void* lse,
                                    int B, int Sq, int Skv, int Kh, int G,
                                    int hd, int window, float softcap,
                                    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_ROWS(T, HD)                                                      \
  return launch_rows<T, HD>(q, k, v, q_start, kv_len, out, (float*)lse, B, \
                            Sq, Skv, Kh, G, window, softcap, s)
  if (dtype == 0) {
    switch (hd) {
      case 16: FA_ROWS(float, 16);
      case 32: FA_ROWS(float, 32);
      case 64: FA_ROWS(float, 64);
      case 128: FA_ROWS(float, 128);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: FA_ROWS(__nv_bfloat16, 16);
      case 32: FA_ROWS(__nv_bfloat16, 32);
      case 64: FA_ROWS(__nv_bfloat16, 64);
      case 128: FA_ROWS(__nv_bfloat16, 128);
    }
  }
#undef FA_ROWS
  return (int)cudaErrorInvalidValue;
}

// The split route: R = Sq * G <= 8, head_dim 32, 64 or 128, n_split chunks
// of 256 keys covering Skv.  part_m and part_l hold B * Kh * n_split * R
// floats, part_acc that many times hd (fp32 scratch).
extern "C" int flash_attention_split(const void* q, const void* k,
                                     const void* v, const void* q_start,
                                     const void* kv_len, void* out,
                                     void* part_m, void* part_l,
                                     void* part_acc, int B, int Sq, int Skv,
                                     int Kh, int G, int hd, int window,
                                     float softcap, int dtype, int n_split,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return 0;
  if (Sq * G > kMaxRows || n_split < 1 || n_split > 65535 || B > 65535 ||
      (long long)n_split * kSplitKeys < Skv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float *pm = (float*)part_m, *pl = (float*)part_l, *pa = (float*)part_acc;
#define FA_SPLIT(T, HD)                                                      \
  return launch_split<T, HD>(q, k, v, q_start, kv_len, out, pm, pl, pa, B,  \
                             Sq, Skv, Kh, G, window, softcap, n_split, s)
  if (dtype == 0) {
    switch (hd) {
      case 32: FA_SPLIT(float, 32);
      case 64: FA_SPLIT(float, 64);
      case 128: FA_SPLIT(float, 128);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: FA_SPLIT(__nv_bfloat16, 32);
      case 64: FA_SPLIT(__nv_bfloat16, 64);
      case 128: FA_SPLIT(__nv_bfloat16, 128);
    }
  }
#undef FA_SPLIT
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route, bf16 only: head_dim 64 or 128, G dividing 128,
// 16-byte aligned bases; a tensor map cuTensorMapEncodeTiled refuses or a
// grid too large gives cudaErrorInvalidValue.
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, const void* q_start,
                                  const void* kv_len, void* out, int B,
                                  int Sq, int Skv, int Kh, int G, int hd,
                                  int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return 0;
  if (kTcRows % G || Skv <= 0 || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
      (uintptr_t)v % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return launch_tc<64>(q, k, v, q_start, kv_len, out, B, Sq, Skv, Kh, G,
                         window, softcap, s);
  if (hd == 128)
    return launch_tc<128>(q, k, v, q_start, kv_len, out, B, Sq, Skv, Kh, G,
                          window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
