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
// * gmm_kernel (fp32, and bf16 shapes TMA cannot take): one block per
//   (g, 64-row tile, 64-column tile), 256 threads, each computing a 4x4
//   register tile with scalar fp32 FMA from 16-deep K tiles staged in
//   shared memory (x transposed, so both operands are read as float4).
//   Every load is bounds-checked, so any M, N, K runs.

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

// ------------------------------------------------ scalar route (gmm_kernel)

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kAS = kBM + 4;   // padded row of the transposed x tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float As[kBK][kAS];   // x tile, [k][m]
  __shared__ __align__(16) float Bs[kBK][kBN];   // w tile, [k][n]
  const int g = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* xg = x + (size_t)g * M * K;
  const T* wg = w + (size_t)g * K * N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const int m = m0 + r, kx = k0 + kk;
      As[kk][r] = (m < M && kx < K) ? to_f(xg[(size_t)m * K + kx]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / kBN, c = e % kBN;
      const int kx = k0 + kk, n = n0 + c;
      Bs[kk][c] = (kx < K && n < N) ? to_f(wg[(size_t)kx * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    T* o = out + ((size_t)g * M + m) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store(o + n, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int G, int M, int K,
           int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, G);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)w,
                                              (T*)out, M, K, N);
  return (int)cudaGetLastError();
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

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a dtype code other than 0 (fp32) / 1 (bf16)
// or a grid the card cannot launch.  Pointers are device memory,
// contiguous.
extern "C" int grouped_matmul(const void* x, const void* w, void* out, int G,
                              int M, int K, int N, int dtype, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if (G > 65535 || (M + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, out, G, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, G, M, K, N, s);
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
