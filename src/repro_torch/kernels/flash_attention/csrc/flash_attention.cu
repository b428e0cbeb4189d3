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
//                            are not read
//   out [B, Sq, Kh, G, hd]   q's type (fp32 or bf16)
// A key j is admissible for a query at position p when j <= p,
// j > p - window and j < kv_len (after the softcap cap*tanh(s/cap)).
// Softmax statistics and the accumulator are fp32; the output is
// acc / max(l, 1e-30), so a query with no admissible key gets zeros.
//
// Bound on this card.  Prefill (many queries per kv head) does ~4*hd flops
// per admissible (query, key) pair against ~4*hd bytes of k/v per key, so
// it is bound by operations; decode (one query per head per slot) reads
// every cached key once for a handful of flops, so it is bound by bytes.
// Design, one launch per call, two kernels chosen by the number of query
// rows R = Sq*G per (batch, kv head):
//  * rows kernel (R > 8): a block owns 64 query rows of one kv head,
//    walks 64-key tiles in shared memory with an online softmax, scalar
//    fp32 FMA from 4x4 register tiles.  Tiles at or past kv_len, past the
//    block's last causal position and wholly before its window are
//    skipped.  Tensor cores (wgmma) and TMA are later work.
//  * decode kernel (R <= 8): a block owns one (batch, kv head); its 8 warps
//    split the admissible keys, each lane holding hd/32 dims, so the G
//    query heads of the kv head share every k/v load (the Pallas wrapper
//    broadcast kv to all heads first).  Each warp keeps 16 row loads in
//    flight; the warps' partial softmax states merge in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

// ------------------------------------------------------------ loads, stores

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive elements as floats; p is aligned to N elements
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
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
                 int Sq, int Skv, int Kh, int G, int window, float softcap,
                 float scale) {
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
      load_n<4>(q + q_off(b, row / G, kh, row % G, Sq, Kh, G, HD) + d, t);
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
        load_n<4>(k + off, tk);
        load_n<4>(v + off, tv);
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
    }
  }
}

// ------------------------------------------------------------ decode kernel

constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;     // query rows per (batch, kv head)
constexpr int kKeys = 8;        // keys per warp step

template <int HD>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  return sizeof(float) * kWarps * kMaxRows * (2 + HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const int32_t* __restrict__ q_start,
                   const int32_t* __restrict__ kv_len, T* __restrict__ out,
                   int Sq, int Skv, int Kh, int G, int window, float softcap,
                   float scale) {
  constexpr int V = HD / 32;      // dims per lane
  extern __shared__ float smem[];
  float* m_s = smem;                            // [kWarps][kMaxRows]
  float* l_s = m_s + kWarps * kMaxRows;         // [kWarps][kMaxRows]
  float* a_s = l_s + kWarps * kMaxRows;         // [kWarps][kMaxRows][HD]

  const int kh = blockIdx.x, b = blockIdx.y;
  const int R = Sq * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  const int kv_hi = min(kv_end, qs + (R - 1) / G + 1);
  const int kv_lo = max(0, qs - window + 1);

  float qr[kMaxRows][V], acc[kMaxRows][V], m[kMaxRows], l[kMaxRows];
  int pos[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    pos[r] = qs + r / G;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      qr[r][t] = 0.f;
      acc[r][t] = 0.f;
    }
    if (r < R) {
      load_n<V>(q + q_off(b, r / G, kh, r % G, Sq, Kh, G, HD) + lane * V,
                qr[r]);
#pragma unroll
      for (int t = 0; t < V; ++t) qr[r][t] *= scale;
    }
  }

  for (int j0 = kv_lo + warp * kKeys; j0 < kv_hi; j0 += kWarps * kKeys) {
    float kk[kKeys][V], vv[kKeys][V];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
#pragma unroll
      for (int t = 0; t < V; ++t) kk[u][t] = vv[u][t] = 0.f;
      if (j0 + u < kv_hi) {
        const size_t off = kv_off(b, j0 + u, kh, Skv, Kh, HD) + lane * V;
        load_n<V>(k + off, kk[u]);
        load_n<V>(v + off, vv[u]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= R) break;
      float s[kKeys];
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        float d = 0.f;
#pragma unroll
        for (int t = 0; t < V; ++t) d = fmaf(qr[r][t], kk[u][t], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = admissible(j0 + u, pos[r], kv_hi, window) ? capped(d, softcap)
                                                         : kNegInf;
        mt = fmaxf(mt, s[u]);
      }
      const float m_new = fmaxf(m[r], mt);
      const float corr = __expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < V; ++t) acc[r][t] *= corr;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const float p = admissible(j0 + u, pos[r], kv_hi, window)
                            ? __expf(s[u] - m_new) : 0.f;
        rs += p;
#pragma unroll
        for (int t = 0; t < V; ++t) acc[r][t] = fmaf(p, vv[u][t], acc[r][t]);
      }
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (lane == 0) {
      m_s[warp * kMaxRows + r] = m[r];
      l_s[warp * kMaxRows + r] = l[r];
    }
#pragma unroll
    for (int t = 0; t < V; ++t)
      a_s[(warp * kMaxRows + r) * HD + lane * V + t] = acc[r][t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * kMaxRows + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(m_s[w * kMaxRows + r] - M);
      L += l_s[w * kMaxRows + r] * f;
      A += a_s[(w * kMaxRows + r) * HD + d] * f;
    }
    store(out + q_off(b, r / G, kh, r % G, Sq, Kh, G, HD) + d,
          A / fmaxf(L, 1e-30f));
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* q_start,
           const void* kv_len, void* out, int B, int Sq, int Skv, int Kh,
           int G, int window, float softcap, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int R = Sq * G;
  if (R <= kMaxRows && HD % 32 == 0) {
    if constexpr (HD % 32 == 0) {
      attn_decode_kernel<T, HD>
          <<<dim3(Kh, B), kThreads, decode_smem_bytes<HD>(), stream>>>(
              (const T*)q, (const T*)k, (const T*)v, (const int32_t*)q_start,
              (const int32_t*)kv_len, (T*)out, Sq, Skv, Kh, G, window,
              softcap, scale);
    }
  } else {
    static bool smem_set = false;  // above 48 KB needs the opt-in
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          attn_rows_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)rows_smem_bytes<HD>());
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    const dim3 grid((R + kBQ - 1) / kBQ, Kh, B);
    attn_rows_kernel<T, HD><<<grid, kThreads, rows_smem_bytes<HD>(), stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int32_t*)q_start,
        (const int32_t*)kv_len, (T*)out, Sq, Skv, Kh, G, window, softcap,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* q_start, const void* kv_len, void* out, int B,
                int Sq, int Skv, int Kh, int G, int window, float softcap,
                cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, q_start, kv_len, out, B, Sq, Skv, Kh, G,
                           window, softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, q_start, kv_len, out, B, Sq, Skv, Kh, G,
                           window, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_start, kv_len, out, B, Sq, Skv, Kh, G,
                           window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_start, kv_len, out, B, Sq, Skv, Kh, G,
                            window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head_dim outside {16, 32, 64, 128} or a
// dtype code other than 0 (fp32) / 1 (bf16).  Pointers are device memory,
// contiguous, 16-byte aligned; window >= 1 (1 << 30 for none); softcap
// <= 0 for none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* q_start,
                                   const void* kv_len, void* out, int B,
                                   int Sq, int Skv, int Kh, int G, int hd,
                                   int window, float softcap, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Kh <= 0 || G <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, q_start, kv_len, out, B, Sq, Skv,
                              Kh, G, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, q_start, kv_len, out, B,
                                      Sq, Skv, Kh, G, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
