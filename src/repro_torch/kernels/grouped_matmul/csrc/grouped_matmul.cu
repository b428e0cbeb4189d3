// Grouped matrix product x[G, M, K] @ w[G, K, N] -> out[G, M, N], for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul/
// grouped_matmul.py::grouped_matmul_pallas: fp32 accumulation over K tiles,
// the output in x's type (fp32 or bf16).  Its consumer on the serving path
// is the MoE expert FFN (src/repro/models/transformer.py, the three
// [E, C, D] @ [E, D, F] einsums of moe_mlp).
//
// Bound on this card.  At prefill (C in the hundreds of rows) the products
// are bound by operations; at decode (C = 8) each product reads every
// expert's weights for 8 rows, so it is bound by bytes.
// Design: one block per (g, 64-row tile, 64-column tile), 256 threads, each
// computing a 4x4 register tile with scalar fp32 FMA from 16-deep K tiles
// staged in shared memory (x transposed, so both operands are read as
// float4).  Every load is bounds-checked, so any M, N, K runs without the
// padding copies of the reference wrapper.  A fixed 64-row tile wastes 7/8
// of its rows at decode; tensor cores (wgmma), TMA and a row tile fitted
// to M are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
