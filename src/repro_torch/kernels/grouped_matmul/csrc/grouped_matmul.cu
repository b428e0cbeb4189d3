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

// the wgmma B-transpose immediate: 1 reads w's [K, N] tile as MN-major
#define GMM_TRANS_B "1"

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait of more than
// a second traps, so a pipeline fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if ((++spins & 4095u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 1000000000ull) {
        __trap();
      }
    }
  }
}

// 3-D TMA load of one box at (c0, c1, c2) into shared memory at `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
template <int kRegs>
__device__ __forceinline__ void fence_acc(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] += A[64 x 16] (K-major) * B[16 x 64] (MN-major), fp32 sums
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, " GMM_TRANS_B ";\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major), fp32 sums
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, " GMM_TRANS_B ";\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major), fp32 sums
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, " GMM_TRANS_B ";\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
        wgmma_n256(acc, da, db);
      } else if constexpr (kTileN == 128) {
        wgmma_n128(acc, da, db);
      } else {
        wgmma_n64(acc, da, db);
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

// cuTensorMapEncodeTiled lives in libcuda, not the CUDA runtime the build
// links, so it is fetched through the runtime's entry-point query.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 [G, rows, inner] tensor (inner contiguous) as a 3-D tensor map of
// boxes [1, box_rows, 64] with the 128-byte swizzle and zero fill.
bool encode_3d(CUtensorMap* map, const void* ptr, int inner, int rows, int G,
               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
