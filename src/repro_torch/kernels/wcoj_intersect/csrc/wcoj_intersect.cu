// WCOJ membership probe over a sorted CSR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wcoj_intersect/
// wcoj_intersect.py::wcoj_intersect_pallas.  That kernel compare-scans a
// padded-ELL tile [rows, D <= 1024] held in VMEM, and the reference backend
// sends rows of higher degree to a jit binary search instead.  The graphs
// this engine probes have Zipf-skewed in-degrees reaching 10^5, so a padded
// layout would move mostly padding; this kernel searches the CSR in place
// and covers every degree with one launch.
//
// For each probe i: lower bound of targets[i] in
// indices[indptr[rows[i]] : indptr[rows[i] + 1]] (rows sorted ascending).
//   found[i] = the bound holds targets[i]                    (bool)
//   epos[i]  = pos_map[slot] for the hit's flat slot in indices (the slot
//              itself when pos_map is null), else 0         (int32)
// Callers guarantee 0 <= rows[i] < len(indptr) - 1.
//
// Bound on this card: memory.  Streamed traffic is about R * 21 bytes
// (rows 4, targets 4, two indptr words 8, found 1, epos 4) plus
// about R * ceil(log2(deg + 1)) dependent random 32-byte sectors of
// indices, so the search is latency-bound on those loads.  Design: one
// thread per probe in a grid-stride loop — neighbouring threads read
// neighbouring rows/targets (coalesced), and the upper levels of a hot
// row's search tree stay in L1/L2 across the many probes of that row.
// Warp-cooperative search and sorting probes by row are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void wcoj_probe_kernel(const int32_t* __restrict__ indptr,
                                  const int32_t* __restrict__ indices,
                                  const int32_t* __restrict__ rows,
                                  const int32_t* __restrict__ targets,
                                  const int32_t* __restrict__ pos_map,
                                  int64_t n,
                                  bool* __restrict__ found,
                                  int32_t* __restrict__ epos) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t r = rows[i];
    const int32_t t = targets[i];
    int32_t lo = __ldg(indptr + r);
    const int32_t end = __ldg(indptr + r + 1);
    int32_t hi = end;
    // lower bound: first slot whose value is >= t (the first match when a
    // row repeats a value)
    while (lo < hi) {
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(indices + mid) < t) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const bool hit = lo < end && __ldg(indices + lo) == t;
    found[i] = hit;
    epos[i] = hit ? (pos_map != nullptr ? __ldg(pos_map + lo) : lo) : 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Every
// pointer is device memory; pos_map may be null.
extern "C" int wcoj_probe(const void* indptr, const void* indices,
                          const void* rows, const void* targets,
                          const void* pos_map, int64_t n, void* found,
                          void* epos, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const int threads = 256;
  // grid-stride: enough blocks to fill every SM many times over, capped so
  // huge probe sets reuse threads instead of exceeding the grid limit
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65536) {
    blocks = 65536;
  }
  wcoj_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const int32_t*)rows,
      (const int32_t*)targets, (const int32_t*)pos_map, n, (bool*)found,
      (int32_t*)epos);
  return (int)cudaGetLastError();
}
