// Embedding bag (multi-hot lookup and bag sum) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/
// embedding_bag.py::embedding_bag_pallas.  That kernel tiles the table over
// its grid and turns each lookup into a one-hot product on the MXU, because
// the TPU has no fast gather from HBM.  Hopper gathers rows directly, so
// these kernels read only the rows the bags name.
//
//   ids   [N, L] int32, already offset into the concatenated table
//   table [V, D] float32 or bfloat16
//   out   N bags of D values in the table's type: bag i at
//         out + (i / G) * row_stride + (i % G) * D (G = 1, row_stride = D
//         for a plain [N, D] output).  Each is the fp32 sum of table[id]
//         over the bag's slots with 0 <= id < V, in slot order.  A negative
//         id is padding; an id >= V contributes nothing (the Pallas kernel
//         matches no tile for it).
//
// Bound on this card: bytes.  Each valid slot names one row (128 bytes at
// D = 32 in fp32) anywhere in a table of up to ~14 GB; the ids and the
// output stream once.  With Zipf-skewed ids most slots repeat a row, so
// the least traffic is the distinct rows plus the two streams, and the
// slot rows that repeat should come from L1 or L2, not device memory.
//
// Two kernels; the wrapper (ops.py: route) picks one before the launch.
//
// vec  (a row is a whole number of 16-byte pieces, bases and the output
//      row stride 16-byte aligned): a group of W lanes owns one bag, W the
//      power of two at or above the row's piece count P (up to 32; a lane
//      takes pieces p, p + W, ... past that), so a warp sums 32 / W bags at
//      once.  Per chunk of 8 slots the group's lanes read the chunk's ids
//      (the warp's groups own consecutive bags, so at L = 8, W = 8 that is
//      one coalesced 128-byte load across the warp), shuffle them within
//      the group, then every lane issues all 8 of its 16-byte row loads
//      before summing them: 8 independent loads in flight a lane (16
//      measured 24% slower: 98 registers against 64).  Cache policy:
//      table rows are read through L1 (__ldg), the ids with a streaming
//      load (__ldcs) and the output with a streaming store (__stcs), so
//      the ~1.7 GB of streams at Wide & Deep's serve_bulk are marked
//      evict-first and leave the hot rows in L1 and L2 (1.6% faster than
//      cached streams).  No shared memory.
// warp (the rest: unaligned bases, rows that are not whole 16-byte
//      pieces): one warp per bag, the lanes striding over D with 4- or
//      2-byte loads; the warp reads 32 of the bag's ids at once and
//      broadcasts them by shuffle, 8 slots per unrolled chunk.
//
// Row addressing is 64-bit: the full Wide & Deep table has 3.4e9 elements,
// so id * D overflows 32 bits for every row at or above 2^26 (at D = 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kChunk = 8;  // slots whose row loads a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ------------------------------------------------------------------- vec

// One 16-byte piece of a table row, through L1 on the non-coherent path
// with the default eviction policy.  An L1 evict-last hint, or that and an
// L2 evict-last access policy (createpolicy + L2::cache_hint), measured no
// faster at serve_bulk (0.1% and 0.5% slower: scripts/
// embedding_bag_variants.py); such a hint pins the rows read only once as
// well as the hot ones.
__device__ __forceinline__ uint4 load_row_piece(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A piece's values in fp32: 4 floats, or 8 bf16.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kVals = 4;
  __device__ __forceinline__ static void add(float* acc, uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  __device__ __forceinline__ static void put(float* dst, const float* acc) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
};

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kVals = 8;
  __device__ __forceinline__ static void add2(float* acc, uint32_t w) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    acc[0] += f.x;
    acc[1] += f.y;
  }
  __device__ __forceinline__ static void add(float* acc, uint4 v) {
    add2(acc + 0, v.x);
    add2(acc + 2, v.y);
    add2(acc + 4, v.z);
    add2(acc + 6, v.w);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* dst,
                                             const float* acc) {
    __stcs(reinterpret_cast<uint4*>(dst),
           make_uint4(bf16x2_bits(acc[0], acc[1]),
                      bf16x2_bits(acc[2], acc[3]),
                      bf16x2_bits(acc[4], acc[5]),
                      bf16x2_bits(acc[6], acc[7])));
  }
};

// W lanes a bag (a power of two); P pieces a row; G bags an output row.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel_vec(const int32_t* __restrict__ ids,
                         const T* __restrict__ table, T* __restrict__ out,
                         int64_t N, int L, int64_t V, int D, int P,
                         int64_t G, int64_t row_stride) {
  constexpr int kGroups = 32 / W;                  // bags a warp sums
  constexpr int kIdLanes = W < kChunk ? W : kChunk;  // lanes reading ids
  constexpr int kIdsPerLane = kChunk / kIdLanes;
  constexpr int kVals = Piece<T>::kVals;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (W - 1);                   // lane within the group
  const int64_t k =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kGroups +
      lane / W;
  const bool live = k < N;  // no early exit: the shuffles need every lane
  // bag k lands in the output's row r, columns f * D onwards; neighbouring
  // groups take neighbouring bags, so the ids and the output stream in
  // order (walking one field down the examples, to share its hot rows in
  // L1, measured 10% slower: scripts/embedding_bag_variants.py)
  const int64_t r = k / G, f = k % G;
  const int32_t* bag_ids = ids + k * L;

  for (int p0 = 0; p0 < P; p0 += W) {  // one pass unless P > 32
    const int p = p0 + gl;
    const bool has = live && p < P;
    float acc[kVals];
#pragma unroll
    for (int c = 0; c < kVals; ++c) {
      acc[c] = 0.f;
    }
    for (int s0 = 0; s0 < L; s0 += kChunk) {
      const int n = min(kChunk, L - s0);  // the same for the whole warp
      // the chunk's ids: slot s0 + r * kIdLanes + gl in register r
      int32_t mine[kIdsPerLane];
#pragma unroll
      for (int r = 0; r < kIdsPerLane; ++r) {
        const int s = r * kIdLanes + gl;
        mine[r] = (live && gl < kIdLanes && s < n)
                      ? __ldcs(bag_ids + s0 + s)
                      : -1;
      }
      uint4 v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int32_t id =
            __shfl_sync(kFull, mine[j / kIdLanes], j % kIdLanes, W);
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (has && j < n && id >= 0 && (int64_t)id < V) {
          v[j] = load_row_piece(table + (int64_t)id * D + p * kVals);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) {
          Piece<T>::add(acc, v[j]);
        }
      }
    }
    if (has) {
      Piece<T>::put(out + r * row_stride + f * D + p * kVals, acc);
    }
  }
}

// ------------------------------------------------------------------ warp

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel_warp(const int32_t* __restrict__ ids,
                          const T* __restrict__ table, T* __restrict__ out,
                          int64_t N, int L, int64_t V, int D, int64_t G,
                          int64_t row_stride) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= N) {
    return;  // the whole warp leaves together: no shuffle below misses it
  }
  const int32_t* bag_ids = ids + bag * L;
  T* bag_out = out + (bag / G) * row_stride + (bag % G) * D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < D;
    float acc = 0.f;
    for (int s0 = 0; s0 < L; s0 += 32) {
      const int n = min(32, L - s0);
      const int32_t my_id = lane < n ? __ldg(bag_ids + s0 + lane) : -1;
      for (int c0 = 0; c0 < n; c0 += kChunk) {
        float v[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int32_t id = __shfl_sync(kFull, my_id, (c0 + j) & 31);
          v[j] = 0.f;
          if (col && c0 + j < n && id >= 0 && (int64_t)id < V) {
            v[j] = to_f(__ldg(table + (int64_t)id * D + d));
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          acc += v[j];
        }
      }
    }
    if (col) {
      store(bag_out + d, acc);
    }
  }
}

template <typename T, int W>
void launch_vec(const void* ids, const void* table, void* out, int64_t N,
                int L, int64_t V, int D, int P, int64_t G,
                int64_t row_stride, int64_t blocks, cudaStream_t s) {
  embedding_bag_kernel_vec<T, W><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)ids, (const T*)table, (T*)out, N, L, V, D, P, G,
      row_stride);
}

template <typename T>
int dispatch_vec(const void* ids, const void* table, void* out, int64_t N,
                 int L, int64_t V, int D, int64_t G, int64_t row_stride,
                 cudaStream_t s) {
  const int P = (int)(D * sizeof(T) / 16);
  int w_log2 = 0;  // W = 2^w_log2 lanes a bag: P rounded up, at most 32
  while ((1 << w_log2) < P && w_log2 < 5) {
    ++w_log2;
  }
  const int64_t bags_per_block = (int64_t)kWarpsPerBlock * (32 >> w_log2);
  const int64_t blocks = (N + bags_per_block - 1) / bags_per_block;
  if (blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  using Launch = void (*)(const void*, const void*, void*, int64_t, int,
                          int64_t, int, int, int64_t, int64_t, int64_t,
                          cudaStream_t);
  const Launch by_width[] = {launch_vec<T, 1>, launch_vec<T, 2>,
                             launch_vec<T, 4>, launch_vec<T, 8>,
                             launch_vec<T, 16>, launch_vec<T, 32>};
  by_width[w_log2](ids, table, out, N, L, V, D, P, G, row_stride, blocks, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  Every pointer is device memory; dtype 0 is float32, 1
// bfloat16; bag i lands at out + (i / G) * row_stride + (i % G) * D
// (elements).  The vec entry point expects what ops.route checks: D times
// the element size a multiple of 16 bytes, table and out 16-byte aligned,
// row_stride times the element size a multiple of 16 bytes.
extern "C" int embedding_bag_vec(const void* ids, const void* table,
                                 void* out, int64_t N, int L, int64_t V,
                                 int D, int64_t G, int64_t row_stride,
                                 int dtype, void* stream) {
  if (N <= 0 || L <= 0 || D <= 0 || G <= 0) {
    return 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_vec<float>(ids, table, out, N, L, V, D, G, row_stride, s);
  }
  if (dtype == 1) {
    return dispatch_vec<__nv_bfloat16>(ids, table, out, N, L, V, D, G,
                                       row_stride, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int embedding_bag_warp(const void* ids, const void* table,
                                  void* out, int64_t N, int L, int64_t V,
                                  int D, int64_t G, int64_t row_stride,
                                  int dtype, void* stream) {
  if (N <= 0 || L <= 0 || D <= 0 || G <= 0) {
    return 0;
  }
  const int64_t blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    embedding_bag_kernel_warp<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)ids, (const float*)table, (float*)out, N, L, V, D, G,
        row_stride);
  } else if (dtype == 1) {
    embedding_bag_kernel_warp<__nv_bfloat16>
        <<<(unsigned)blocks, kThreads, 0, s>>>(
            (const int32_t*)ids, (const __nv_bfloat16*)table,
            (__nv_bfloat16*)out, N, L, V, D, G, row_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
