// Grouped matrix product x[G, M, K] @ w[G, K, N] -> out[G, M, N], for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul/
// grouped_matmul.py::grouped_matmul_pallas: fp32 accumulation over K tiles,
// the output in x's type (fp32 or bf16).  Its consumer on the serving path
// is the MoE expert FFN (src/repro/models/transformer.py, the three
// [E, C, D] @ [E, D, F] einsums of moe_mlp).
//
// Bound on this card.  On the serving path both regimes are bound by bytes:
// the expert weights (268 MB for OLMoE) are read once per product, whether
// an expert holds 311 rows (prefill) or 8 (decode).
//
// Two routes, chosen by the wrapper before launch (ops.py::route):
//
// * gmm_kernel_tc (bf16; K and N multiples of 8; 16-byte aligned bases):
//   tensor cores through wgmma, fed by TMA.  A block owns one output tile
//   of one expert.  One producer thread issues TMA loads of the x tile
//   [BM x 64] and of the w tile [64 x BN] (BN/64 boxes of 64 columns) into
//   a ring of stages in dynamic shared memory, with a full and an empty
//   mbarrier per stage; one or two consumer warpgroups (64 rows each) run
//   wgmma.m64nBNk16 on the stages that have arrived, keeping one group of
//   products in flight.  Both tiles use the 128-byte swizzle: x is K-major
//   (the A operand), w is [K, N] with N contiguous, so B is MN-major and
//   the instruction's B-transpose bit is set.  The tensor maps are 3-D
//   (inner, rows, G): rows past M, columns past N and K past its end are
//   zero-filled, and no tile reads the next expert.  Blocks run the row
//   tiles of one (g, column tile) next to each other, so w is read from
//   device memory about once and from L2 by the other row tiles.
//   M > 64 (prefill): BM = 128, BN = 256, 4 stages, one block per SM
//   (x is read once per column tile, so the wider tile moves fewer bytes
//   from L2 than BN = 128 did, and ran faster on the serving shapes).
//   M <= 64 (decode): BM = 64, BN = 64, 6 stages, two blocks per SM, so
//   G * N / 64 blocks (1,024 for OLMoE's w1) keep w streaming.
// * gmm_kernel_simt (fp32, and bf16 shapes TMA cannot take; the LM's
//   training path in fp32, TF32 off): scalar fp32 FMA, bound by operations
//   on the training shapes (2 G M K N flops at 67 TFLOP/s).  A block of
//   256 threads owns a 128 x 128 output tile of one expert, each thread
//   8 x 8 outputs: two float4s of each operand a k step for 64 FMAs, which
//   is what keeps the FMA units fed, since a warp's 16-byte shared-memory
//   read takes 4 of the SM's cycles whatever it broadcasts (PERF.md
//   section 6).  Where 128-row tiles would leave SMs idle (fewer tiles
//   than SMs: the backward's dw) or rows idle (M <= 64: decode), a 64 x
//   128 tile, 4 x 8 a thread (ops.py::simt_tile picks from the shape).
//   16-deep K stages in shared memory, double buffered with one barrier a
//   stage:
//   the operand whose rows are contiguous in the stage's layout is copied
//   by cp.async 16-byte copies, the other loaded into registers while the
//   current stage computes.  Layout flags read the backward's operands in
//   place: trans_x reads x stored [G, K, M] (dw = x^T dy), trans_w w
//   stored [G, N, K] (dx = dy w^T).  K is summed in order in every output,
//   never split: the backward's gradients then equal the plain version's
//   (cuBLAS, the same order) bit for bit, where a split K differs from it
//   by more than the 1e-4 tolerance on K = 5,120 (PERF.md section 6).
//   16-byte copies need fp32, M, K, N multiples of 4 and 16-byte aligned
//   bases (`vec`); anything else loads element by element,
//   bounds-checked, so any M, N, K runs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "../../_hopper/hopper.cuh"

namespace {

using namespace hopper;

// the wgmma B-transpose immediate: 1 reads w's [K, N] tile as MN-major
constexpr int kTransB = 1;

// ------------------------------------------- scalar route (gmm_kernel_simt)

constexpr int kThreads = 256;
constexpr int kBN = 128, kBK = 16;   // tile columns, K of a stage

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// out[g] = op(x[g]) @ op(w[g]), one (64 H) x 128 output tile a block.
// TA: x stored [K, M]; TB: w stored [N, K]; VEC: 16-byte loads and copies
// (fp32; M, K, N multiples of 4, aligned).
//
// Thread (ty, tx) owns rows ty*4 + i + 64 hm (i < 4, hm < H) and columns
// tx*4 + j + 64 hn (j < 4, hn < 2), or with TB columns tx + 16j (j < 8):
// 4H x 8 outputs.  Each output sums its K products in order, k = 0, 1, ...
// (as cuBLAS does: the two agree bit for bit).  x's tile is k-major
// [k][m]: copied so where x is stored [K, M], else loaded into registers
// during the previous stage's products and stored transposed.  w's tile is
// k-major [k][n] where w is [K, N]; where it is stored [N, K] it is
// [k / 4][n][4]: each row's 4-float pieces copied as they lie, and read as
// float4s along k (4 k steps a read) whose 8 columns of a warp are 8
// neighbouring pieces, 128 contiguous bytes.
template <typename T, int H, bool TA, bool TB, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel_simt(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int M, int K, int N) {
  static_assert(!VEC || sizeof(T) == 4, "16-byte copies are fp32 only");
  constexpr int BM = 64 * H;           // tile rows
  constexpr int kAS = BM + 4;          // padded row of the k-major x tile
  constexpr int kBS = kBN + 4;         // padded row of the k-major w tile
  constexpr int kBFloats = TB ? kBK * kBN : kBK * kBS;
  // loads a thread makes of x's and of w's stage
  constexpr int kVA = VEC ? H : 4 * H, kVB = VEC ? 2 : 8;
  __shared__ __align__(16) float As[2][kBK][kAS];        // x tile, [k][m]
  __shared__ __align__(16) float Bs[2][kBFloats];        // w tile
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, g = blockIdx.z;
  const int nt = (K + kBK - 1) / kBK;
  const T* xg = x + (size_t)g * M * K;
  const T* wg = w + (size_t)g * K * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a warp covers 4 row groups x 8 column groups: its reads of a stage
  // touch 4 and 8 distinct 16-byte pieces, all in distinct banks
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  // the register-staged part of a stage: x's where it is [M, K], w's
  // element-wise loads
  float ra[4 * H], rb[8];

  // Issues the loads of the stage at k0 into buffer st: cp.async for
  // every operand the 16-byte copies can fill as it lies, registers for
  // x [M, K] and for element-wise loads.
  auto fetch = [&](int k0, int st) {
#pragma unroll
    for (int h = 0; h < kVA; ++h) {
      const int e = tid + kThreads * h;
      if constexpr (!TA && VEC) {          // x [M, K]: 4 k of a row
        const int r = e >> 2, kc = (e & 3) * 4;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < M && k0 + kc < K)
          t = *reinterpret_cast<const float4*>(
              xg + (size_t)(m0 + r) * K + k0 + kc);
        ra[4 * h] = t.x; ra[4 * h + 1] = t.y;
        ra[4 * h + 2] = t.z; ra[4 * h + 3] = t.w;
      } else if constexpr (!TA) {
        const int r = e >> 4, kk = e & 15;
        ra[h] = (m0 + r < M && k0 + kk < K)
                    ? to_f(xg[(size_t)(m0 + r) * K + k0 + kk]) : 0.f;
      } else if constexpr (VEC) {          // x stored [K, M]: 4 m of a k
        const int kk = e / (BM / 4), mc = (e % (BM / 4)) * 4;
        const bool ok = k0 + kk < K && m0 + mc < M;
        cp_async16(&As[st][kk][mc],
                   ok ? xg + (size_t)(k0 + kk) * M + m0 + mc : xg, ok);
      } else {
        const int kk = e / BM, m = e % BM;
        ra[h] = (k0 + kk < K && m0 + m < M)
                    ? to_f(xg[(size_t)(k0 + kk) * M + m0 + m]) : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < kVB; ++h) {
      const int e = tid + kThreads * h;
      if constexpr (!TB && VEC) {          // w [K, N]: 4 n of a k
        const int kk = e >> 5, nc = (e & 31) * 4;
        const bool ok = k0 + kk < K && n0 + nc < N;
        cp_async16(&Bs[st][kk * kBS + nc],
                   ok ? wg + (size_t)(k0 + kk) * N + n0 + nc : wg, ok);
      } else if constexpr (!TB) {
        const int kk = e >> 7, n = e & 127;
        rb[h] = (k0 + kk < K && n0 + n < N)
                    ? to_f(wg[(size_t)(k0 + kk) * N + n0 + n]) : 0.f;
      } else if constexpr (VEC) {          // w stored [N, K]: 4 k of a row
        const int n = e >> 2, kc = e & 3;
        const bool ok = n0 + n < N && k0 + 4 * kc < K;
        cp_async16(&Bs[st][(kc * kBN + n) * 4],
                   ok ? wg + (size_t)(n0 + n) * K + k0 + 4 * kc : wg, ok);
      } else {
        const int n = e >> 4, kk = e & 15;
        rb[h] = (n0 + n < N && k0 + kk < K)
                    ? to_f(wg[(size_t)(n0 + n) * K + k0 + kk]) : 0.f;
      }
    }
  };

  // Stores the register-staged part of a stage into buffer st.
  auto deposit = [&](int st) {
#pragma unroll
    for (int h = 0; h < kVA; ++h) {
      const int e = tid + kThreads * h;
      if constexpr (!TA && VEC) {
        const int r = e >> 2, kc = (e & 3) * 4;
#pragma unroll
        for (int u = 0; u < 4; ++u) As[st][kc + u][r] = ra[4 * h + u];
      } else if constexpr (!TA) {
        As[st][e & 15][e >> 4] = ra[h];
      } else if constexpr (!VEC) {
        As[st][e / BM][e % BM] = ra[h];
      }
    }
    if constexpr (!VEC) {
#pragma unroll
      for (int h = 0; h < kVB; ++h) {
        const int e = tid + kThreads * h;
        if constexpr (TB) {
          Bs[st][(((e & 15) >> 2) * kBN + (e >> 4)) * 4 + (e & 3)] = rb[h];
        } else {
          Bs[st][(e >> 7) * kBS + (e & 127)] = rb[h];
        }
      }
    }
  };

  float acc[4 * H][8];
#pragma unroll
  for (int i = 0; i < 4 * H; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nt > 0) {
    fetch(0, 0);
    deposit(0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < nt;
    // the next stage's copies fly while this one computes; buffer st ^ 1
    // was last read before the barrier that ended the previous stage
    if (more) fetch((t + 1) * kBK, st ^ 1);
    cp_async_commit();
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float bq[8][4];   // TB: columns tx + 16j at k steps kq .. kq + 3
      if constexpr (TB) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              &Bs[st][((kq >> 2) * kBN + tx + 16 * j) * 4]);
          bq[j][0] = v.x; bq[j][1] = v.y; bq[j][2] = v.z; bq[j][3] = v.w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = kq + u;
        float a[4 * H], b[8];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float4 av =
              *reinterpret_cast<const float4*>(&As[st][kk][64 * h + ty * 4]);
          a[4 * h] = av.x; a[4 * h + 1] = av.y;
          a[4 * h + 2] = av.z; a[4 * h + 3] = av.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (TB) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) b[4 * h + jj] = bq[4 * h + jj][u];
          } else {
            const float4 bv = *reinterpret_cast<const float4*>(
                &Bs[st][kk * kBS + 64 * h + tx * 4]);
            b[4 * h] = bv.x; b[4 * h + 1] = bv.y;
            b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4 * H; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) deposit(st ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4 * H; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= M) continue;
    T* row = out + ((size_t)g * M + m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (TB) {
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < N) store(row + n, acc[i][j]);
        }
      } else {
        const int n = n0 + 64 * h + tx * 4;
        const float* v = &acc[i][4 * h];
        if constexpr (VEC) {   // N % 4 == 0: all four columns or none
          if (n < N)
            *reinterpret_cast<float4*>(row + n) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (n + jj < N) store(row + n + jj, v[jj]);
        }
      }
    }
  }
}

template <typename T, int H, bool VEC>
int launch_simt(const void* x, const void* w, void* out, int G, int M,
                int K, int N, bool trans_x, bool trans_w,
                cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + 64 * H - 1) / (64 * H), G);
  const T *tx = (const T*)x, *tw = (const T*)w;
  T* to = (T*)out;
  if (trans_x && trans_w)
    gmm_kernel_simt<T, H, true, true, VEC>
        <<<grid, kThreads, 0, stream>>>(tx, tw, to, M, K, N);
  else if (trans_x)
    gmm_kernel_simt<T, H, true, false, VEC>
        <<<grid, kThreads, 0, stream>>>(tx, tw, to, M, K, N);
  else if (trans_w)
    gmm_kernel_simt<T, H, false, true, VEC>
        <<<grid, kThreads, 0, stream>>>(tx, tw, to, M, K, N);
  else
    gmm_kernel_simt<T, H, false, false, VEC>
        <<<grid, kThreads, 0, stream>>>(tx, tw, to, M, K, N);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_simt_tile(const void* x, const void* w, void* out, int G, int M,
                     int K, int N, bool trans_x, bool trans_w, int tile_m,
                     cudaStream_t s) {
  if (tile_m == 128)
    return launch_simt<T, 2, VEC>(x, w, out, G, M, K, N, trans_x, trans_w,
                                  s);
  if (tile_m == 64)
    return launch_simt<T, 1, VEC>(x, w, out, G, M, K, N, trans_x, trans_w,
                                  s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------- tensor-core route (gmm_kernel_tc)

constexpr int kTcBK = 64;               // K per stage: 64 bf16, 128 bytes
constexpr int kRow = kTcBK * 2;         // bytes of one swizzled tile row
constexpr int kBox = 64 * kRow;         // one 64 x 64 TMA box: 8 KB

template <int kWG, int kTileN, int kStages>
struct TcShape {
  static constexpr int kRows = 64 * kWG;             // BM
  static constexpr int kABytes = kRows * kRow;       // x tile of a stage
  static constexpr int kBoxes = kTileN / 64;         // w boxes of a stage
  static constexpr int kStageBytes = kABytes + kBoxes * kBox;
  static constexpr int kThreads = 128 * (kWG + 1);   // + the producer
  // the ring, 1 KB to align it to the swizzle pattern, two barriers a stage
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
};

// Block b owns row tile b % m_tiles of column tile (b / m_tiles) % n_tiles
// of expert b / (m_tiles * n_tiles).  Warpgroups 0 .. kWG-1 consume,
// warpgroup kWG produces (one thread; the others leave at once).
template <int kWG, int kTileN, int kStages>
__global__ void __launch_bounds__(128 * (kWG + 1), kWG == 1 ? 2 : 1)
gmm_kernel_tc(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              __nv_bfloat16* __restrict__ out, int M, int K, int N,
              int m_tiles, int n_tiles) {
  using S = TcShape<kWG, kTileN, kStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;    // swizzle-aligned ring
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem_raw + (ring - raw) + kStages * S::kStageBytes);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x;
  const int m0 = (b % m_tiles) * S::kRows;
  const int n0 = ((b / m_tiles) % n_tiles) * kTileN;
  const int g = b / (m_tiles * n_tiles);
  const int nk = (K + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kWG) {
    if (t == 0) {
      // w boxes that hold a column below N; a box wholly past N is not
      // loaded (it would feed only output columns that are not stored)
      const int boxes = min(S::kBoxes, (N - n0 + 63) / 64);
      const uint32_t bytes = S::kABytes + boxes * kBox;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        const uint32_t a = ring + s * S::kStageBytes;
        mbar_expect_tx(&full[s], bytes);
        tma_load_3d(a, &tm_x, &full[s], kt * kTcBK, m0, g);
        for (int j = 0; j < boxes; ++j) {
          tma_load_3d(a + S::kABytes + j * kBox, &tm_w, &full[s],
                      n0 + j * 64, kt * kTcBK, g);
        }
      }
    }
    return;
  }

  constexpr int kRegs = kTileN / 2;
  float acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = 0.f;

  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[s], phase);
    const uint32_t a = ring + s * S::kStageBytes + wg * 64 * kRow;
    const uint32_t bt = ring + s * S::kStageBytes + S::kABytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // A: K-major, 8-row groups 1 KB apart; 16 K values are 32 bytes of
      // the swizzled row.  B: MN-major, 64-column boxes 8 KB apart (the
      // leading offset), 8-row K groups 1 KB apart; 16 K rows are 2 KB.
      const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
      const uint64_t db = smem_desc(bt + kk * 16 * kRow, kBox, 1024);
      if constexpr (kTileN == 256) {
        wgmma_n256<kTransB>(acc, da, db);
      } else if constexpr (kTileN == 128) {
        wgmma_n128<kTransB>(acc, da, db);
      } else {
        wgmma_n64<kTransB>(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();          // the previous stage's products have retired
    fence_acc(acc);
    if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
    __syncwarp();
    prev = s;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator layout of wgmma.m64nN: n8 chunk j of warp w, lane l holds
  // rows w*16 + l/4 (+8), columns j*8 + (l%4)*2 (+1)
  const int warp = t / 32, lane = t % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  __nv_bfloat16* og = out + (size_t)g * M * N;
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col >= N) continue;     // N % 8 == 0: col + 1 < N as well
    if (r0 < M) {
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * N + col) =
          __floats2bfloat162_rn(acc[j * 4], acc[j * 4 + 1]);
    }
    if (r0 + 8 < M) {
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)(r0 + 8) * N + col) =
          __floats2bfloat162_rn(acc[j * 4 + 2], acc[j * 4 + 3]);
    }
  }
}

// A bf16 [G, rows, inner] tensor (inner contiguous) as a 3-D tensor map of
// boxes [1, box_rows, 64] with the 128-byte swizzle and zero fill.
bool encode_3d(CUtensorMap* map, const void* ptr, int inner, int rows, int G,
               int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16(map, ptr, 3, dims, strides, box);
}

template <int kWG, int kTileN, int kStages>
int launch_tc(const void* x, const void* w, void* out, int G, int M, int K,
              int N, cudaStream_t stream) {
  using S = TcShape<kWG, kTileN, kStages>;
  CUtensorMap tm_x, tm_w;
  if (!encode_3d(&tm_x, x, K, M, G, S::kRows) ||
      !encode_3d(&tm_w, w, N, K, G, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = (M + S::kRows - 1) / S::kRows;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const long long blocks = (long long)G * m_tiles * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = gmm_kernel_tc<kWG, kTileN, kStages>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, S::kThreads, S::kSmem, stream>>>(
      tm_x, tm_w, (__nv_bfloat16*)out, M, K, N, m_tiles, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The scalar route: launches on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a dtype code other than 0
// (fp32) / 1 (bf16), tile rows other than 64 / 128, `vec` on bf16, or a grid
// the card cannot launch.  x is [G, M, K] ([G, K, M] with trans_x), w
// [G, K, N] ([G, N, K] with trans_w), out [G, M, N], all contiguous device
// memory.  `vec` (fp32; M, K, N multiples of 4; x, w 16-byte aligned)
// enables the 16-byte copies.
extern "C" int grouped_matmul(const void* x, const void* w, void* out,
                              int G, int M, int K, int N, int trans_x,
                              int trans_w, int tile_m, int vec, int dtype,
                              void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if (G > 65535 || (M + 63) / 64 > 65535 || (vec && dtype != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vec)
    return launch_simt_tile<float, true>(x, w, out, G, M, K, N, trans_x,
                                         trans_w, tile_m, s);
  if (dtype == 0)
    return launch_simt_tile<float, false>(x, w, out, G, M, K, N, trans_x,
                                          trans_w, tile_m, s);
  if (dtype == 1)
    return launch_simt_tile<__nv_bfloat16, false>(x, w, out, G, M, K, N,
                                                  trans_x, trans_w, tile_m,
                                                  s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route, bf16 only: launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for what TMA
// cannot take (K or N not a multiple of 8, K = 0, a base not 16-byte
// aligned), a tensor map cuTensorMapEncodeTiled refuses or a grid too
// large.
extern "C" int grouped_matmul_tc(const void* x, const void* w, void* out,
                                 int G, int M, int K, int N, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8 || (uintptr_t)x % 16 || (uintptr_t)w % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 64) return launch_tc<1, 64, 6>(x, w, out, G, M, K, N, s);
  return launch_tc<2, 256, 4>(x, w, out, G, M, K, N, s);
}
