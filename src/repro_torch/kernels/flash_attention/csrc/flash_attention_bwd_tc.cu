// FlashAttention backward on the tensor cores, for Hopper (sm_90a): the
// bf16 route ("tc") of ops.py::flash_attention_bwd.
//
// No Pallas kernel is replaced: the reference trains through its jnp
// attention (src/repro/models/transformer.py::_block_attention) and has no
// backward kernel.  This is the gradient of the function the forward
// (flash_attention.cu) computes, for the bf16 training path (the operands
// the forward's tc route takes: head_dim 64 or 128, G dividing 128,
// 16-byte aligned bases), in the notation of flash_attention_bwd.cu:
//   q, dout [B, Sq, Kh, G, hd] bf16; k, v [B, Skv, Kh, hd] bf16;
//   q_start[B], kv_len[B] int32; dq, dk, dv bf16 in q's and k's layouts.
// Rows of one (batch, kv head) are r = sq * G + g, R = Sq * G of them.
// With P = exp(c - lse) over a row's admissible keys (c the capped score),
// dP = dout v^T and D = rowsum(P * dP) (= rowsum(dout * o)):
//   dS = P (dP - D) (times 1 - tanh^2(s / cap) under a cap),
//   dq = dS k / sqrt(hd),  dk = dS^T q / sqrt(hd),  dv = P^T dout.
//
// Bound on this card by operations: 10 hd flops an admissible pair (S, dP,
// dq, dk, dv) at the bf16 tensor-core rate.  The three kernels spend 26
// hd: S and dP are formed again for the row statistics, for dq and for dk
// and dv (S twice there, below), because sums over the other side of a
// pair without atomics keep the gradients bit-equal from call to call; and
// each gradient product runs twice, on the high and the low bf16 part of
// dS or P (mma_grad_split).  Every product is a wgmma with fp32 sums on
// bf16 tiles that TMA loads from the tensors in place: the forward's
// tensor maps (q-layout 5-D, cache-layout 4-D, 128-byte swizzle, zero fill
// past Sq and Skv), with boxes of 64 columns and 64 rows.  A block has two
// consumer warpgroups and a producer warp, one thread of which keeps TMA
// loads in a 2-stage ring with a full and an empty mbarrier a stage.
// * attn_bwd_tc_stats_kernel: a block per 128 query rows (64 a warpgroup)
//   of one (batch, kv head) walks the 64-key tiles its rows can see;
//   S = Q K^T and dP = dO V^T (both operands K-major) and, per row, the
//   running max, sum of exp and sum of P dP in fp32.  It writes lse (base
//   2) and D = sum(P dP) / sum(P) for the other two kernels, fp32 [B, Kh,
//   R_pad] (R rounded up to 128; 0 past R).  D comes from fp32 P and the
//   exact products dout . v: never from an output rounded to bf16, whose
//   error dq = P (dP - D) k does not cancel (flash_attention_bwd.cu's
//   recompute route exists for that reason), nor from P V with P rounded
//   to bf16, which errs as much.
// * attn_bwd_tc_dq_kernel: the same blocks and walk; S and dP again, dS in
//   registers, converted to bf16 as the A fragments of dQ += dS K (the
//   register-A wgmma, K read MN-major from the same tile, as the forward's
//   P V).  K rows past kv_len are zeroed in shared memory on the tile that
//   straddles it (0 * NaN is NaN).
// * attn_bwd_tc_dkv_kernel: a block per 128 keys (64 a warpgroup) walks
//   the 64-row query steps that can see them twice (causal order and the
//   window bound the range; the G query heads of the kv head in order, so
//   the heads' sum is fixed).  S^T = K Q^T (and dP^T = V dO^T) put keys in
//   the accumulator's rows; the first walk sums dV += P^T dO and writes
//   dV, the second dK += dS^T Q, with P^T and dS^T as register A
//   fragments.  Both gradients and both score tiles at once would take 192
//   fp32 registers a thread at head_dim 128, past the 168 that ptxas
//   allots a 288-thread block (it rounds the block up to 384 threads); one
//   gradient at a time costs S^T once more and spills nothing.  A step's
//   lse and D arrive with its Q and dO tiles (two bulk copies), loaded
//   again on the second walk.
// At head_dim 128 dq and dk/dv form a step's scores in two halves of 32
// columns (kScoreCols), which keeps them within those registers too.
// A warpgroup skips a tile none of its pairs can use; only tiles that
// straddle the diagonal, the window's edge, kv_len or R are masked, by
// select, so nothing read past kv_len reaches a sum.  A row with no
// admissible key gets dq = 0 and adds nothing to dk and dv.  A simple tile:
// each warpgroup waits for its products before the next (FA3's ping-pong
// and intra-warpgroup overlap are not here).

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = 128;            // bytes of a swizzled box row: 64 bf16
// rows of every tile: a warpgroup's query rows (stats, dq) or keys (dk/dv),
// a step's keys (stats, dq) or query rows (dk/dv)
constexpr int kRows = 64;
constexpr int kBox = kRows * kRow;   // a 64-column box of a tile: 8 KB
constexpr int kBlockRows = 128;      // query rows (stats, dq) or keys (dk/dv)
constexpr int kStages = 2;
constexpr int kThreads = 288;        // two consumer warpgroups + a producer
constexpr int kConsumerWarps = 8;
// The keys (dq) or query rows (dk/dv) of a step whose scores are formed at
// once: the whole step at head_dim 64; at 128 two halves, one after the
// other.  Whole steps there would hold the gradient accumulator (64 fp32
// registers), S, dP (32 each) and temporaries past the 168 registers that
// ptxas allots a 288-thread block (it rounds the block up to 384 threads):
// it spilled 4 bytes in dq and 24 in dk/dv.
template <int HD> constexpr int kScoreCols = HD == 128 ? 32 : 64;

// The bytes of a tile of 64 rows x HD columns: HD / 64 boxes.
template <int HD> constexpr int kTileBytes = (HD / 64) * kBox;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool admissible(int j, int pos, int kv_end,
                                           int window) {
  return j < kv_end && j <= pos && j > pos - window;
}

// offset of q/dq row (b, sq, kh, g) and of k/dk row (b, j, kh)
__device__ __forceinline__ size_t q_off(int b, int sq, int kh, int g, int Sq,
                                        int Kh, int G, int hd) {
  return ((((size_t)b * Sq + sq) * Kh + kh) * G + g) * hd;
}
__device__ __forceinline__ size_t kv_off(int b, int j, int kh, int Skv,
                                         int Kh, int hd) {
  return (((size_t)b * Skv + j) * Kh + kh) * hd;
}

// A raw product s = q . k as the score in the log2 domain (capped under a
// softcap), and the cap's derivative 1 - tanh^2 (1 without a cap).  Every
// kernel computes it the same way, so P = exp2(x - lse) is consistent with
// the statistics.
__device__ __forceinline__ float score2(float s, float scale,
                                        float scale_log2, float softcap,
                                        float* dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(s * scale / softcap);
    *dcap = 1.f - t * t;
    return softcap * t * kLog2e;
  }
  *dcap = 1.f;
  return s * scale_log2;
}

// wgmma descriptors of k16 step kk of a tile (from any of its rows that
// is a multiple of 8): K-major (the product runs over the tile's columns:
// 32 bytes a step in a swizzled row, a box every 4 steps) and MN-major
// (over its rows: 16 rows a step; 64-column boxes kBox apart along N,
// 8-row groups 1 KB)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * kRow, kBox, 1024);
}

// acc[64 x N] = A B^T over HD: A a tile, B N rows of a tile, both K-major
// (HD contiguous)
template <int HD, int N>
__device__ __forceinline__ void mma_scores(float (&acc)[N / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = desc_k(a, kk);
    const uint64_t db = desc_k(b, kk);
    if constexpr (N == 64) {
      wgmma_n64<0>(acc, da, db, kk > 0);
    } else {
      wgmma_n32<0>(acc, da, db, kk > 0);
    }
  }
}

// acc[64 x HD] += A B over N: A the bf16 fragments of a 64 x N accumulator
// (to_frags), B N rows of a tile read MN-major
template <int HD, int N>
__device__ __forceinline__ void mma_grad(float (&acc)[HD / 2],
                                         const uint32_t (&a)[N / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db = desc_mn(b, kk);
    if constexpr (HD == 128) {
      wgmma_n128_rs<1>(acc, a[kk], db);
    } else {
      wgmma_n64_rs<1>(acc, a[kk], db);
    }
  }
}

// A 64 x N fp32 accumulator as the bf16 A fragments of m64k16 products:
// columns 16kk .. 16kk + 15 are accumulator chunks 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// The bf16 A fragments of the high part of x (to_frags), and x less that
// part in place: the low part, which to_frags makes the second operand.
template <int N>
__device__ __forceinline__ void split_frags(float (&x)[N / 2],
                                            uint32_t (&hi)[N / 16][4]) {
  to_frags<N>(x, hi);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    x[i] -= __bfloat162float(__float2bfloat16_rn(x[i]));
}

// Issues acc += X B, B N rows of a tile read MN-major, X (dS or P, fp32) as
// two bf16 A operands: its high part and what bf16 drops of it (x is left
// holding that low part); the caller commits and waits.  X rounded once to
// bf16 errs past bf16's tolerance: dq = P (dP - D) k sums terms that
// cancel, and so do dk's and dv's sums on real data (up to 1.9 of the
// 2e-2 tolerance on OLMoE's layer 0; 0.37 split).  Every fragment is
// written before the wgmma fence, and none again before the wait.
template <int HD, int N>
__device__ __forceinline__ void mma_grad_split(float (&acc)[HD / 2],
                                               float (&x)[N / 2],
                                               uint32_t b) {
  uint32_t hi[N / 16][4], lo[N / 16][4];
  split_frags<N>(x, hi);
  to_frags<N>(x, lo);
  fence_acc(acc);
  wgmma_fence();
  mma_grad<HD, N>(acc, hi, b);
  mma_grad<HD, N>(acc, lo, b);
}

// 64 query rows from row r0 (a multiple of 64) of one (b, kh) of a q-layout
// map, whose box is (64, min(G, 64), 1, 64 / min(G, 64), 1)
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* m,
                                          uint64_t* bar, int r0, int G,
                                          int gshift, int kh, int b) {
#pragma unroll
  for (int j = 0; j < HD / 64; ++j)
    tma_load_5d(dst + j * kBox, m, bar, 64 * j, r0 & (G - 1), kh,
                r0 >> gshift, b);
}

// 64 keys from key j0 of one (b, kh) of a cache-layout map
template <int HD>
__device__ __forceinline__ void load_keys(uint32_t dst, const CUtensorMap* m,
                                          uint64_t* bar, int j0, int kh,
                                          int b) {
#pragma unroll
  for (int j = 0; j < HD / 64; ++j)
    tma_load_4d(dst + j * kBox, m, bar, 64 * j, kh, j0, b);
}

// ---------------------------------------------- row blocks: stats and dq

template <int HD>
struct RowSmem {
  static constexpr int kTile = kTileBytes<HD>;
  // Q and dO of both warpgroups, then the K and V ring, 1 KB to align to
  // the swizzle pattern, and the barriers: full and empty a stage, Q's
  static constexpr int kRing = 4 * kTile;
  static constexpr int kBars = kRing + kStages * 2 * kTile;
  static constexpr int kBytes = 1024 + kBars + 8 * (2 * kStages + 1);
};

// The geometry of a row block: block i owns row tile n_tiles - 1 -
// i / (B * Kh) (the longest walks first) of kv head i % Kh, batch
// (i / Kh) % B, and walks 64-key tiles from kv_lo.
struct RowBlock {
  int b, kh, row0, qs, kv_end, kv_lo, n_kv;
};

__device__ __forceinline__ RowBlock row_block(const int32_t* q_start,
                                              const int32_t* kv_len, int B,
                                              int Kh, int R, int Skv,
                                              int gshift, int window,
                                              int n_tiles) {
  RowBlock rb;
  const int tile = n_tiles - 1 - (int)blockIdx.x / (B * Kh);
  rb.kh = (int)blockIdx.x % Kh;
  rb.b = ((int)blockIdx.x / Kh) % B;
  rb.row0 = tile * kBlockRows;
  rb.qs = q_start[rb.b];
  rb.kv_end = min(kv_len[rb.b], Skv);
  // keys the block can need: up to its last row's position, from its first
  // row's window start (rounded down to a tile), below kv_len
  const int kv_hi = min(rb.kv_end,
                        rb.qs + ((min(rb.row0 + kBlockRows, R) - 1) >> gshift)
                            + 1);
  rb.kv_lo = max(0, rb.qs + (rb.row0 >> gshift) - window + 1) / kRows * kRows;
  rb.n_kv = kv_hi > rb.kv_lo ? (kv_hi - rb.kv_lo + kRows - 1) / kRows : 0;
  return rb;
}

// The producer thread of a row block: both warpgroups' Q and dO once (a
// warpgroup whose rows all lie past R loads none), then the K and V tiles.
template <int HD>
__device__ __forceinline__ void produce_rows(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do,
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, uint32_t qt,
    uint64_t* q_full, uint64_t* full, uint64_t* empty, const RowBlock& rb,
    int R, int G, int gshift) {
  using S = RowSmem<HD>;
  const int wgs = rb.row0 + kRows < R ? 2 : 1;
  mbar_expect_tx(q_full, wgs * 2 * S::kTile);
  for (int w = 0; w < wgs; ++w) {
    const int r0 = rb.row0 + w * kRows;
    load_rows<HD>(qt + w * S::kTile, tm_q, q_full, r0, G, gshift, rb.kh,
                  rb.b);
    load_rows<HD>(qt + (2 + w) * S::kTile, tm_do, q_full, r0, G, gshift,
                  rb.kh, rb.b);
  }
  const uint32_t ring = qt + S::kRing;
  for (int it = 0; it < rb.n_kv; ++it) {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
    const uint32_t kt = ring + s * 2 * S::kTile;
    const int kv0 = rb.kv_lo + it * kRows;
    mbar_expect_tx(&full[s], 2 * S::kTile);
    load_keys<HD>(kt, tm_k, &full[s], kv0, rb.kh, rb.b);
    load_keys<HD>(kt + S::kTile, tm_v, &full[s], kv0, rb.kh, rb.b);
  }
}

// A consumer thread's rows in a row block: its warpgroup's 64 (live when
// the first lies below R; the positions of the first and last live one)
// and the first of its own two (accumulator rows lane / 4 and + 8 of its
// warp).
struct RowView {
  bool live;
  int first, last, ra;
};

__device__ __forceinline__ RowView row_view(const RowBlock& rb, int wg,
                                            int warp, int lane, int R,
                                            int gshift) {
  RowView v;
  const int wrow0 = rb.row0 + wg * kRows;
  v.live = wrow0 < R;
  v.first = rb.qs + (wrow0 >> gshift);
  v.last = rb.qs + ((min(wrow0 + kRows, R) - 1) >> gshift);
  v.ra = wrow0 + warp * 16 + lane / 4;
  return v;
}

// Whether a warpgroup's rows use the 64-key tile at kv0 (one of its keys is
// admissible for one of its rows), and whether the tile needs masking
// (it straddles the diagonal, kv_len or the window's edge).
__device__ __forceinline__ bool tile_needed(const RowView& v, int kv0,
                                            int window) {
  return v.live && kv0 <= v.last && kv0 + kRows - 1 > v.first - window;
}
__device__ __forceinline__ bool tile_edge(const RowView& v, int kv0,
                                          int kv_end, int window) {
  return kv0 + kRows - 1 > v.first || kv0 + kRows > kv_end ||
         kv0 <= v.last - window;
}

// -------------------------------------------------------- row statistics

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_tc_stats_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const int32_t* __restrict__ q_start,
                         const int32_t* __restrict__ kv_len,
                         float* __restrict__ lse, float* __restrict__ dsum,
                         int B, int Sq, int Skv, int Kh, int G, int gshift,
                         int window, float softcap, float scale,
                         int n_tiles) {
  using S = RowSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qt = (raw + 1023u) & ~1023u;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem_raw + (qt - raw) + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  const int R = Sq * G;
  const RowBlock rb = row_block(q_start, kv_len, B, Kh, R, Skv, gshift,
                                window, n_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256)
      produce_rows<HD>(&tm_q, &tm_do, &tm_k, &tm_v, qt, q_full, full, empty,
                       rb, R, G, gshift);
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const RowView rv = row_view(rb, wg, warp, lane, R, gshift);
  const uint32_t qw = qt + wg * S::kTile, dow = qt + (2 + wg) * S::kTile;
  const float scale_log2 = scale * kLog2e;
  // running max (log2 domain), sum of exp and sum of exp * dP of the
  // thread's two rows
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < rb.n_kv; ++it) {
    const int s = it % kStages;
    const int kv0 = rb.kv_lo + it * kRows;
    const uint32_t kt = qt + S::kRing + s * 2 * S::kTile;
    mbar_wait(&full[s], (it / kStages) & 1);
    if (tile_needed(rv, kv0, window)) {
      const bool edge = tile_edge(rv, kv0, rb.kv_end, window);
      float sc[32], dp[32];
      wgmma_fence();
      mma_scores<HD, kRows>(sc, qw, kt);
      mma_scores<HD, kRows>(dp, dow, kt + S::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dcap;
          float x = score2(sc[j * 4 + e], scale, scale_log2, softcap, &dcap);
          if (edge) {
            const int col = kv0 + j * 8 + (lane % 4) * 2 + (e & 1);
            const int pos = rb.qs + ((rv.ra + 8 * (e >> 1)) >> gshift);
            const bool ok = admissible(col, pos, rb.kv_end, window);
            x = ok ? x : kNegInf;
            dp[j * 4 + e] = ok ? dp[j * 4 + e] : 0.f;
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
      float rs[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(sc[j * 4 + e] - mb[e >> 1]);
          rs[e >> 1] += p;
          rd[e >> 1] = fmaf(p, dp[j * 4 + e], rd[e >> 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] * corr[i] + rs[i];
        d[i] = d[i] * corr[i] + rd[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    d[i] += __shfl_xor_sync(0xffffffffu, d[i], 1);
    d[i] += __shfl_xor_sync(0xffffffffu, d[i], 2);
  }
  if (lane % 4 == 0) {
    const size_t base = ((size_t)rb.b * Kh + rb.kh) * n_tiles * kBlockRows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rv.ra + 8 * i;
      const bool seen = r < R && l[i] > 0.f;
      lse[base + r] = seen ? m[i] + log2f(l[i]) : 0.f;
      dsum[base + r] = seen ? d[i] / l[i] : 0.f;
    }
  }
}

// -------------------------------------------------------------------- dq

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const int32_t* __restrict__ q_start,
                      const int32_t* __restrict__ kv_len,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv,
                      int Kh, int G, int gshift, int window, float softcap,
                      float scale, int n_tiles) {
  using S = RowSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qt = (raw + 1023u) & ~1023u;
  uint8_t* const base = smem_raw + (qt - raw);   // generic address of qt
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  const int R = Sq * G;
  const RowBlock rb = row_block(q_start, kv_len, B, Kh, R, Skv, gshift,
                                window, n_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256)
      produce_rows<HD>(&tm_q, &tm_do, &tm_k, &tm_v, qt, q_full, full, empty,
                       rb, R, G, gshift);
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const RowView rv = row_view(rb, wg, warp, lane, R, gshift);
  const uint32_t qw = qt + wg * S::kTile, dow = qt + (2 + wg) * S::kTile;
  const float scale_log2 = scale * kLog2e;
  float lrow[2], drow[2];
  {
    const size_t at = ((size_t)rb.b * Kh + rb.kh) * n_tiles * kBlockRows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] = lse[at + rv.ra + 8 * i];
      drow[i] = dsum[at + rv.ra + 8 * i];
    }
  }
  constexpr int kAcc = HD / 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < rb.n_kv; ++it) {
    const int s = it % kStages;
    const int kv0 = rb.kv_lo + it * kRows;
    const uint32_t kt = qt + S::kRing + s * 2 * S::kTile;
    mbar_wait(&full[s], (it / kStages) & 1);
    if (tile_needed(rv, kv0, window)) {
      const bool edge = tile_edge(rv, kv0, rb.kv_end, window);
      if (kv0 + kRows > rb.kv_end) {
        // K rows past kv_len reach dQ += dS K with dS = 0, and 0 * NaN is
        // NaN: zero them (whole 128-byte rows, so the swizzle is moot)
        const int z0 = rb.kv_end - kv0;
        const int n16 = (kRows - z0) * (kRow / 16);
        uint8_t* const kg = base + (kt - qt);
        for (int e = t; e < (HD / 64) * n16; e += 128) {
          *reinterpret_cast<uint4*>(kg + (e / n16) * kBox + z0 * kRow +
                                    (e % n16) * 16) =
              make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }
      // the tile's keys kScoreCols at a time
      constexpr int CW = kScoreCols<HD>;
#pragma unroll
      for (int h = 0; h < kRows / CW; ++h) {
        const uint32_t kth = kt + h * CW * kRow;   // its first key's row
        float sc[CW / 2], dp[CW / 2];
        wgmma_fence();
        mma_scores<HD, CW>(sc, qw, kth);
        mma_scores<HD, CW>(dp, dow, kth + S::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);
        // dS = P (dP - D) (times the cap's derivative), 0 where
        // inadmissible
#pragma unroll
        for (int j = 0; j < CW / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float dcap;
            const float x =
                score2(sc[j * 4 + e], scale, scale_log2, softcap, &dcap);
            float ds = fast_exp2(x - lrow[i]) * (dp[j * 4 + e] - drow[i]) *
                       dcap;
            if (edge) {
              const int col =
                  kv0 + h * CW + j * 8 + (lane % 4) * 2 + (e & 1);
              const int pos = rb.qs + ((rv.ra + 8 * i) >> gshift);
              ds = admissible(col, pos, rb.kv_end, window) ? ds : 0.f;
            }
            sc[j * 4 + e] = ds;
          }
        }
        mma_grad_split<HD, CW>(acc, sc, kth);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rv.ra + 8 * i;
    if (r >= R) continue;
    const int sq = r >> gshift;
    __nv_bfloat16* row =
        dq + q_off(rb.b, sq, rb.kh, r - (sq << gshift), Sq, Kh, G, HD);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc[j * 4 + 2 * i] * scale,
                                acc[j * 4 + 2 * i + 1] * scale);
    }
  }
}

// ----------------------------------------------------------------- dk, dv

template <int HD>
struct KeySmem {
  static constexpr int kTile = kTileBytes<HD>;
  // K and V of both warpgroups, the ring of a step's Q and dO, the ring of
  // its lse and D (kRows floats each), 1 KB to align to the swizzle pattern,
  // and the barriers: full and empty a stage, K and V's
  static constexpr int kRing = 4 * kTile;
  static constexpr int kStats = kRing + kStages * 2 * kTile;
  static constexpr int kBars = kStats + kStages * 2 * kRows * 4;
  static constexpr int kBytes = 1024 + kBars + 8 * (2 * kStages + 1);
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_tc_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const int32_t* __restrict__ q_start,
                       const int32_t* __restrict__ kv_len,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int B, int Sq,
                       int Skv, int Kh, int G, int gshift, int window,
                       float softcap, float scale, int r_pad) {
  using S = KeySmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t kvt = (raw + 1023u) & ~1023u;
  uint8_t* const base = smem_raw + (kvt - raw);   // generic address of kvt
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  const float* const stats = reinterpret_cast<const float*>(base + S::kStats);

  // the earliest keys (the longest walks under the causal mask) first
  const int bh = B * Kh;
  const int j0 = (int)(blockIdx.x / bh) * kBlockRows;
  const int kh = (int)blockIdx.x % Kh, b = ((int)blockIdx.x / Kh) % B;
  const int R = Sq * G;
  const int qs = q_start[b];
  const int kv_end = min(kv_len[b], Skv);
  // query rows whose position can see a key of [j0, j_last]: pos >= j0
  // and pos < j_last + window, from a multiple of kRows
  int r_lo = 0, n_steps = 0;
  if (j0 < kv_end) {
    const int j_last = min(j0 + kBlockRows, kv_end) - 1;
    const int sq_lo = max(0, j0 - qs);
    const int sq_hi =
        (int)min((long long)Sq, (long long)j_last + window - qs);
    if (sq_hi > sq_lo) {
      r_lo = (sq_lo << gshift) / kRows * kRows;
      n_steps = ((sq_hi << gshift) - r_lo + kRows - 1) / kRows;
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256 && n_steps > 0) {
      // K and V of both warpgroups (one whose keys all lie past Skv loads
      // none), then each step's Q, dO, lse and D, on both walks
      const int wgs = j0 + kRows < Skv ? 2 : 1;
      mbar_expect_tx(kv_full, wgs * 2 * S::kTile);
      for (int w = 0; w < wgs; ++w) {
        load_keys<HD>(kvt + w * S::kTile, &tm_k, kv_full, j0 + w * kRows, kh,
                      b);
        load_keys<HD>(kvt + (2 + w) * S::kTile, &tm_v, kv_full,
                      j0 + w * kRows, kh, b);
      }
      const size_t at = ((size_t)b * Kh + kh) * r_pad;
      for (int it = 0; it < 2 * n_steps; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        const int r0 = r_lo + (it % n_steps) * kRows;
        const uint32_t qs_t = kvt + S::kRing + s * 2 * S::kTile;
        const uint32_t st = kvt + S::kStats + s * 2 * kRows * 4;
        mbar_expect_tx(&full[s], 2 * S::kTile + 2 * kRows * 4);
        load_rows<HD>(qs_t, &tm_q, &full[s], r0, G, gshift, kh, b);
        load_rows<HD>(qs_t + S::kTile, &tm_do, &full[s], r0, G, gshift, kh,
                      b);
        bulk_load(st, lse + at + r0, kRows * 4, &full[s]);
        bulk_load(st + kRows * 4, dsum + at + r0, kRows * 4, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  // this warpgroup's keys (the admissible ones end at wk_hi) and the first
  // of the thread's two (accumulator rows lane / 4 and + 8 of its warp)
  const int wk_lo = j0 + wg * kRows;
  const int wk_hi = min(wk_lo + kRows, kv_end) - 1;
  const int key0 = wk_lo + warp * 16 + lane / 4;
  const uint32_t kw = kvt + wg * S::kTile;
  const uint32_t vw = kvt + (2 + wg) * S::kTile;
  const float scale_log2 = scale * kLog2e;
  constexpr int kAcc = HD / 2;
  if (n_steps > 0) mbar_wait(kv_full, 0);

  // walk 0 sums dV, walk 1 dK.  Not unrolled: unrolled, ptxas spills 136
  // bytes at head_dim 128 and the kernel took 1.63 ms on OLMoE's layer 0
  // against 1.37 rolled.
#pragma unroll 1
  for (int walk = 0; walk < 2; ++walk) {
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int step = 0; step < n_steps; ++step) {
      const int it = walk * n_steps + step, s = it % kStages;
      const int r0 = r_lo + step * kRows;
      const uint32_t qs_t = kvt + S::kRing + s * 2 * S::kTile;
      const uint32_t dos_t = qs_t + S::kTile;
      const float* const lrow = stats + s * 2 * kRows;
      const float* const drow = lrow + kRows;
      mbar_wait(&full[s], (it / kStages) & 1);
      const int p_lo = qs + (r0 >> gshift);
      const int p_hi = qs + ((min(r0 + kRows, R) - 1) >> gshift);
      if (wk_lo <= wk_hi && p_hi >= wk_lo &&
          (long long)p_lo < (long long)wk_hi + window) {
        // masking where a pair may be inadmissible: a row before a key, a
        // key out of a row's window, keys past kv_len, rows past R
        const bool edge = p_lo < wk_lo + kRows - 1 ||
                          (long long)p_hi - window >= (long long)wk_lo ||
                          wk_lo + kRows > kv_end || r0 + kRows > R;
        // the step's query rows kScoreCols at a time
        constexpr int CW = kScoreCols<HD>;
#pragma unroll
        for (int h = 0; h < kRows / CW; ++h) {
          const uint32_t qh = qs_t + h * CW * kRow;   // its first row
          const uint32_t doh = dos_t + h * CW * kRow;
          float st[CW / 2], dpt[CW / 2];
          wgmma_fence();
          mma_scores<HD, CW>(st, kw, qh);
          if (walk == 1) mma_scores<HD, CW>(dpt, vw, doh);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(st);
          if (walk == 1) fence_acc(dpt);
          // P^T (walk 0) or dS^T (walk 1) in place: keys in the
          // accumulator's rows, the half's query rows in its columns
#pragma unroll
          for (int j = 0; j < CW / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = h * CW + j * 8 + (lane % 4) * 2 + (e & 1);
              float dcap;
              const float x =
                  score2(st[j * 4 + e], scale, scale_log2, softcap, &dcap);
              float g = fast_exp2(x - lrow[rr]);
              if (walk == 1) g *= (dpt[j * 4 + e] - drow[rr]) * dcap;
              if (edge) {
                const int row = r0 + rr;
                g = row < R && admissible(key0 + 8 * (e >> 1),
                                          qs + (row >> gshift), kv_end,
                                          window)
                        ? g : 0.f;
              }
              st[j * 4 + e] = g;
            }
          }
          mma_grad_split<HD, CW>(acc, st, walk == 0 ? doh : qh);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* const grad = walk == 0 ? dv : dk;
    const float mul = walk == 0 ? 1.f : scale;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Skv) continue;
      __nv_bfloat16* const row = grad + kv_off(b, key, kh, Skv, Kh, HD);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + (lane % 4) * 2) =
            __floats2bfloat162_rn(acc[j * 4 + 2 * i] * mul,
                                  acc[j * 4 + 2 * i + 1] * mul);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// A bf16 q-layout tensor (hd, G, Kh, Sq, B) as a map of boxes of 64 rows
// r = sq * G + g: (64, min(G, 64), 1, 64 / min(G, 64), 1).
template <int HD>
bool encode_rows(CUtensorMap* map, const void* ptr, int Sq, int Kh, int G,
                 int B) {
  const cuuint64_t e = 2;
  const cuuint64_t dims[5] = {(cuuint64_t)HD, (cuuint64_t)G, (cuuint64_t)Kh,
                              (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t strides[4] = {e * HD, e * HD * G, e * HD * G * Kh,
                                 e * HD * G * Kh * Sq};
  const int gb = G < kRows ? G : kRows;
  const cuuint32_t box[5] = {64, (cuuint32_t)gb, 1, (cuuint32_t)(kRows / gb),
                             1};
  return encode_bf16(map, ptr, 5, dims, strides, box);
}

// A bf16 cache-layout tensor (hd, Kh, Skv, B) as a map of 64-key boxes.
template <int HD>
bool encode_keys(CUtensorMap* map, const void* ptr, int Skv, int Kh,
                 int B) {
  const cuuint64_t e = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Kh,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {e * HD, e * HD * Kh, e * HD * Kh * Skv};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kRows, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* dout, const int32_t* q_start,
                  const int32_t* kv_len, void* dq, void* dk, void* dv,
                  float* lse, float* dsum, int B, int Sq, int Skv, int Kh,
                  int G, int window, float softcap, cudaStream_t stream) {
  using RS = RowSmem<HD>;
  using KS = KeySmem<HD>;
  static bool smem_set = false;  // above 48 KB needs the opt-in
  if (!smem_set) {
    cudaError_t err = allow_smem(attn_bwd_tc_stats_kernel<HD>, RS::kBytes);
    if (err == cudaSuccess)
      err = allow_smem(attn_bwd_tc_dq_kernel<HD>, RS::kBytes);
    if (err == cudaSuccess)
      err = allow_smem(attn_bwd_tc_dkv_kernel<HD>, KS::kBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int gshift = __builtin_ctz((unsigned)G);
  const int n_tiles = (Sq * G + kBlockRows - 1) / kBlockRows;
  const long long bh = (long long)B * Kh;
  const long long key_tiles = (Skv + kBlockRows - 1) / kBlockRows;
  if (bh * n_tiles > INT_MAX || bh * key_tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!encode_rows<HD>(&tm_q, q, Sq, Kh, G, B) ||
      !encode_rows<HD>(&tm_do, dout, Sq, Kh, G, B) ||
      !encode_keys<HD>(&tm_k, k, Skv, Kh, B) ||
      !encode_keys<HD>(&tm_v, v, Skv, Kh, B)) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale = (float)(1.0 / sqrt((double)HD));
  const unsigned row_blocks = (unsigned)(bh * n_tiles);
  attn_bwd_tc_stats_kernel<HD><<<row_blocks, kThreads, RS::kBytes, stream>>>(
      tm_q, tm_do, tm_k, tm_v, q_start, kv_len, lse, dsum, B, Sq, Skv, Kh, G,
      gshift, window, softcap, scale, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_tc_dq_kernel<HD><<<row_blocks, kThreads, RS::kBytes, stream>>>(
      tm_q, tm_do, tm_k, tm_v, q_start, kv_len, lse, dsum,
      (__nv_bfloat16*)dq, B, Sq, Skv, Kh, G, gshift, window, softcap, scale,
      n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_tc_dkv_kernel<HD>
      <<<(unsigned)(bh * key_tiles), kThreads, KS::kBytes, stream>>>(
          tm_q, tm_do, tm_k, tm_v, q_start, kv_len, lse, dsum,
          (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, Sq, Skv, Kh, G, gshift,
          window, softcap, scale, n_tiles * kBlockRows);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for what the route does not take:
// head_dim other than 64 or 128, G not a power of two dividing 128, a base
// of q, k, v or dout not 16-byte aligned, a tensor map
// cuTensorMapEncodeTiled refuses or a grid too large.  q, k, v, dout, dq,
// dk, dv are contiguous bf16 device memory, q_start and kv_len int32 [B];
// lse and dsum are fp32 scratch of B * Kh * R_pad floats each (R = Sq * G
// rounded up to a multiple of 128), 16-byte aligned; window >= 1 (1 << 30
// for none); softcap <= 0 for none.
extern "C" int flash_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* q_start,
                                      const void* kv_len, void* dq, void* dk,
                                      void* dv, void* lse, void* dsum, int B,
                                      int Sq, int Skv, int Kh, int G, int hd,
                                      int window, float softcap,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || G <= 0) return 0;
  if (G > kBlockRows || kBlockRows % G || (uintptr_t)q % 16 ||
      (uintptr_t)k % 16 || (uintptr_t)v % 16 || (uintptr_t)dout % 16 ||
      (uintptr_t)lse % 16 || (uintptr_t)dsum % 16) {
    return (int)cudaErrorInvalidValue;
  }
#define FA_BWD_TC(HD)                                                       \
  return launch_bwd_tc<HD>(q, k, v, dout, (const int32_t*)q_start,          \
                           (const int32_t*)kv_len, dq, dk, dv, (float*)lse, \
                           (float*)dsum, B, Sq, Skv, Kh, G, window, softcap, \
                           (cudaStream_t)stream)
  if (hd == 64) FA_BWD_TC(64);
  if (hd == 128) FA_BWD_TC(128);
#undef FA_BWD_TC
  return (int)cudaErrorInvalidValue;
}
