// Embedding bag (multi-hot lookup and bag sum) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/
// embedding_bag.py::embedding_bag_pallas.  That kernel tiles the table over
// its grid and turns each lookup into a one-hot product on the MXU, because
// the TPU has no fast gather from HBM.  Hopper gathers rows directly, so
// this kernel reads only the rows the bags name.
//
//   ids   [B, L] int32, already offset into the concatenated table
//   table [V, D] float32 or bfloat16
//   out   [B, D] in the table's type: the fp32 sum of table[id] over the
//         slots with 0 <= id < V.  A negative id is padding; an id >= V
//         contributes nothing (the Pallas kernel matches no tile for it).
//
// Bound on this card: bytes.  Each valid slot reads one row (D elements,
// 128 bytes at D = 32 in fp32) from anywhere in a table of up to ~14 GB;
// the ids and the output stream once.  Design: one warp per bag, the lanes
// striding over D, so a row at D = 32 in fp32 is one coalesced 128-byte
// load.  The warp reads 32 of the bag's ids with one coalesced load and
// broadcasts them with shuffles; the slot loop is unrolled so several row
// loads are in flight at once.  Accumulation is fp32 in registers; one
// launch covers all B bags.
//
// Row addressing is 64-bit: the full Wide & Deep table has 3.4e9 elements,
// so id * D overflows 32 bits for every row at or above 2^26 (at D = 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

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
embedding_bag_kernel(const int32_t* __restrict__ ids,
                     const T* __restrict__ table, T* __restrict__ out,
                     int64_t B, int L, int64_t V, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= B) {
    return;  // the whole warp leaves together: no shuffle below misses it
  }
  const int32_t* bag_ids = ids + bag * L;
  T* bag_out = out + bag * D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int s0 = 0; s0 < L; s0 += 32) {
      const int n = min(32, L - s0);
      const int32_t my_id = lane < n ? __ldg(bag_ids + s0 + lane) : -1;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int32_t id = __shfl_sync(0xffffffffu, my_id, j);
        if (id >= 0 && (int64_t)id < V && d < D) {
          acc += to_f(__ldg(table + (int64_t)id * D + d));
        }
      }
    }
    if (d < D) {
      store(bag_out + d, acc);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Every
// pointer is device memory; dtype 0 is float32, 1 bfloat16.
extern "C" int embedding_bag(const void* ids, const void* table, void* out,
                             int64_t B, int L, int64_t V, int D, int dtype,
                             void* stream) {
  if (B <= 0 || L <= 0 || D <= 0) {
    return 0;
  }
  const int64_t blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    embedding_bag_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)ids, (const float*)table, (float*)out, B, L, V, D);
  } else if (dtype == 1) {
    embedding_bag_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)ids, (const __nv_bfloat16*)table,
        (__nv_bfloat16*)out, B, L, V, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
