// WCOJ membership probe over a sorted CSR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wcoj_intersect/
// wcoj_intersect.py::wcoj_intersect_pallas.  That kernel compare-scans a
// padded-ELL tile [rows, D <= 1024] held in VMEM, and the reference backend
// sends rows of higher degree to a jit binary search instead.  The graphs
// this engine probes have Zipf-skewed in-degrees reaching 10^5, so a padded
// layout would move mostly padding; both kernels here search the CSR in
// place and cover every degree with one launch.
//
// For each probe i: lower bound of targets[i] in
// indices[indptr[rows[i]] : indptr[rows[i] + 1]] (each row sorted).
//   found[i] = the bound holds targets[i]                    (bool)
//   epos[i]  = pos_map[slot] for the hit's flat slot in indices (the slot
//              itself when pos_map is null), else 0         (int32)
// Callers guarantee 0 <= rows[i] < len(indptr) - 1.
//
// Bound on this card.  The compulsory traffic is about 21 bytes a probe
// (rows, targets, two indptr words, found, epos), but a search is a chain
// of dependent reads into scattered 32-byte sectors: a binary search over
// a row of degree d takes ceil(log2(d + 1)) of them, each waiting on the
// last.  Where the CSR sits in L2 the limit is the L1's rate for scattered
// requests and the instructions a probe issues; where it misses L2, the
// latency of each dependent miss with too few of them in flight.  Not HBM
// bytes.
//
// Route `fence` (the main path): a walk down a per-CSR fence index built
// once on the device (ops.build_search_index), so a probe waits on fewer
// dependent reads, each a whole sector.  Level 1 holds the first key of
// every aligned kNode-slot node of indices, level 2 the first of every node
// of level 1, and so on until a level fits one node; the levels lie back to
// back, each padded with INT32_MAX to whole nodes, so their bases follow
// from nnz (computed on the host, passed as a grid constant).  A probe
// starts at the lowest level k at which its row spans at most two nodes
// (found from the degree's top bit and one shift test), reads those two,
// then one aligned node a level (kNode keys = one 32-byte sector, two
// 16-byte loads) down to indices: about log8(d) + 1 dependent sector reads,
// 6 for d = 131,922 where the binary search takes 17.  At each level the
// node's keys are compared with the target in registers (strict <) into a
// bit mask, the bits outside the row's range are cleared (a node's head and
// tail may hold the neighbouring rows' keys; the entry the walk descended
// through counts as below), and the popcount picks the child: the count of
// keys below the target, so the walk ends on the first slot of a repeated
// value.  The lower bound's slot is then read once to decide membership,
// so no level carries an equality test.  The compares, not the reads, are
// most of a level's instructions, and with the CSR in L2 the walk is bound
// by issue: rows of degree < kSmallRow (at most five sectors, all of
// GLogue's low-degree CSRs) are binary-searched in place instead, which
// issues fewer instructions and stays in L1.  kProbes probes of a tile can
// be interleaved a thread (all their loads of a level before any compare),
// but each adds ~25 registers and costs more occupancy than the overlap
// gains: one a thread is the fastest (scripts/wcoj_intersect_variants.py).
//
// Route `search`: the binary search of the port's first kernel, one probe a
// thread (kSearchProbes), for callers with no index or an indices base
// that is not 32-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNode = 8;          // keys a node of the fence route
constexpr int kProbes = 1;        // probes in flight a thread, fence route
constexpr int kSmallRow = 32;     // rows below this degree: binary search
constexpr int kSearchProbes = 1;  // probes in flight a thread, search route
constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;    // > log2(2^31): any nnz, any node width
constexpr int kMaxBlocks = 65536;
// Occupancy of the fence route, one build for each: where the CSR sits in
// L2, 8 blocks an SM (32 registers, every warp slot filled); from kWideNnz
// keys on (16 MB of keys, more with the pos map) the probes miss L2, and
// 6 blocks an SM of a build free to use 36 registers wait on those misses
// better (scripts/wcoj_intersect_variants.py `blocks6`, `wide8`).
constexpr int kBlocksL2 = 8;
constexpr int kBlocksWide = 6;
constexpr int64_t kWideNnz = int64_t{1} << 22;

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v >> 1); }
constexpr int kShift = log2i(kNode);
static_assert((1 << kShift) == kNode && kNode >= 4 && kNode <= 16,
              "a node is a power of two of 4 to 16 keys (two fit a mask)");

// Level k's first entry: indices at k = 0, the index's level k above.
struct Levels {
  const int32_t* base[kMaxLevels];
};

// The kNode keys of the aligned node at p, as 16-byte loads from one
// sector (kNode = 8).  The last node of indices may run past nnz: its tail
// is read all the same (an aligned sector holding a key of the array lies
// in mapped memory) and lies outside every row, so its bits are cleared.
__device__ __forceinline__ void load_node(const int32_t* __restrict__ p,
                                          int32_t (&k)[kNode]) {
  const int4* v = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int c = 0; c < kNode / 4; ++c) {
    const int4 x = __ldg(v + c);
    k[4 * c] = x.x;
    k[4 * c + 1] = x.y;
    k[4 * c + 2] = x.z;
    k[4 * c + 3] = x.w;
  }
}

// Bit q set where key q is below t.
__device__ __forceinline__ uint32_t below_bits(const int32_t (&k)[kNode],
                                               int32_t t) {
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < kNode; ++q) {
    m |= (k[q] < t ? 1u : 0u) << q;
  }
  return m;
}

// One level's step.  `lt` holds the below-t bits of the entries read at
// level k from entry n0 on (one node, or two at the start level); the row's
// entries at level k are (head, hi] plus the head fence, at the leaves
// [lo, last].  Returns the child: the node to read at level k - 1, or at
// k = 0 the lower bound's slot.
__device__ __forceinline__ int32_t descend(uint32_t lt, int k, int32_t n0,
                                           int32_t lo, int32_t last) {
  const int sh = kShift * k;
  const int32_t head = lo >> sh;
  const int32_t hi = last >> sh;
  // the entry the walk came down through (or the head fence) is below t
  const int32_t start = head > n0 ? head : n0;
  const int32_t a = start + (k > 0 ? 1 : 0) - n0;   // 0 .. kNode
  const int32_t z = hi - n0 < 31 ? hi - n0 : 31;    // >= a - 1
  const uint32_t in_row = (~0u << a) & (~0u >> (31 - z));
  return start + __popc(lt & in_row);
}

// The lowest level whose nodes the row [lo, last] spans at most two of:
// span_k = (last >> s) - (lo >> s), s = kShift * (k + 1), is <= 1 only if
// d = last - lo < 2^(s + 1) and always if d < 2^s, so k is the least level
// with s >= floor(log2 d), or the next.  Never above the top level, whose
// one node holds every slot.
__device__ __forceinline__ int start_level(int32_t lo, int32_t last) {
  const int32_t d = last - lo;
  const int m = 31 - __clz(d);                      // -1 for d = 0
  int k = (m + kShift - 1) / kShift - 1;
  k = k > 0 ? k : 0;
  const int s = kShift * (k + 1);
  return k + ((last >> s) - (lo >> s) > 1 ? 1 : 0);
}

template <int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fence_kernel(const int32_t* __restrict__ indptr,
             const __grid_constant__ Levels lv,
             const int32_t* __restrict__ rows,
             const int32_t* __restrict__ targets,
             const int32_t* __restrict__ pos_map, int64_t n,
             bool* __restrict__ found, int32_t* __restrict__ epos) {
  const int32_t* __restrict__ indices = lv.base[0];
  // 32-bit probe indices (the wrapper keeps n below 2^31)
  const uint32_t tile = (uint32_t)kThreads * kProbes;
  for (uint32_t base = blockIdx.x * tile; base < (uint32_t)n;
       base += gridDim.x * tile) {
    int32_t t[kProbes], lo[kProbes], last[kProbes], b[kProbes];
    int lvl[kProbes];  // level of the next read; -1 once at the leaves
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const uint32_t i = base + p * kThreads + threadIdx.x;
      t[p] = 0;
      lo[p] = 0;
      last[p] = -1;
      if (i < n) {
        const int32_t r = __ldcs(rows + i);
        t[p] = __ldcs(targets + i);
        lo[p] = __ldg(indptr + r);
        last[p] = __ldg(indptr + r + 1) - 1;
      }
    }
    // the start level: one or two nodes
    int32_t k0[kProbes][kNode], k1[kProbes][kNode];
    int32_t n0[kProbes];
    bool two[kProbes];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      lvl[p] = -1;
      two[p] = false;
      n0[p] = 0;
      b[p] = lo[p];
      if (lo[p] <= last[p]) {
        if (last[p] - lo[p] < kSmallRow - 1) {
          // a short row spans at most five sectors: a binary search over
          // it issues fewer instructions than a walk and stays in L1
          int32_t l = lo[p], h = last[p] + 1;
          while (l < h) {
            const int32_t mid = (l + h) >> 1;
            if (__ldg(indices + mid) < t[p]) {
              l = mid + 1;
            } else {
              h = mid;
            }
          }
          b[p] = l;
          continue;
        }
        const int k = start_level(lo[p], last[p]);
        const int sh = kShift * k;
        const int32_t b0 = (lo[p] >> sh) >> kShift;
        two[p] = ((last[p] >> sh) >> kShift) != b0;
        n0[p] = b0 << kShift;
        const int32_t* at = lv.base[k] + n0[p];
        load_node(at, k0[p]);
        if (two[p]) {
          load_node(at + kNode, k1[p]);
        }
        lvl[p] = k;
      }
    }
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      if (lvl[p] >= 0) {
        uint32_t lt = below_bits(k0[p], t[p]);
        if (two[p]) {
          lt |= below_bits(k1[p], t[p]) << kNode;
        }
        b[p] = descend(lt, lvl[p], n0[p], lo[p], last[p]);
        --lvl[p];
      }
    }
    // one node a level down to the leaves
    for (;;) {
      bool any = false;
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        any = any || lvl[p] >= 0;
      }
      if (!any) {
        break;
      }
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        if (lvl[p] >= 0) {
          const int k = lvl[p];
          n0[p] = b[p] << kShift;
          load_node(lv.base[k] + n0[p], k0[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        if (lvl[p] >= 0) {
          b[p] = descend(below_bits(k0[p], t[p]), lvl[p], n0[p], lo[p],
                         last[p]);
          --lvl[p];
        }
      }
    }
    // b is the lower bound's slot: one read decides membership
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const uint32_t i = base + p * kThreads + threadIdx.x;
      if (i < n) {
        const bool hit = b[p] <= last[p] && __ldg(indices + b[p]) == t[p];
        __stcs(reinterpret_cast<signed char*>(found) + i,
               (signed char)(hit ? 1 : 0));
        __stcs(epos + i,
               hit ? (pos_map != nullptr ? __ldg(pos_map + b[p]) : b[p]) : 0);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
search_kernel(const int32_t* __restrict__ indptr,
              const int32_t* __restrict__ indices,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ targets,
              const int32_t* __restrict__ pos_map, int64_t n,
              bool* __restrict__ found, int32_t* __restrict__ epos) {
  const int64_t tile = (int64_t)kThreads * kSearchProbes;
  for (int64_t base = (int64_t)blockIdx.x * tile; base < n;
       base += (int64_t)gridDim.x * tile) {
    int32_t lo[kSearchProbes], hi[kSearchProbes], end[kSearchProbes],
        t[kSearchProbes];
#pragma unroll
    for (int p = 0; p < kSearchProbes; ++p) {
      const int64_t i = base + p * kThreads + threadIdx.x;
      lo[p] = end[p] = t[p] = 0;
      if (i < n) {
        const int32_t r = rows[i];
        t[p] = targets[i];
        lo[p] = __ldg(indptr + r);
        end[p] = __ldg(indptr + r + 1);
      }
      hi[p] = end[p];
    }
    // lower bound: first slot whose value is >= t (the first match when a
    // row repeats a value)
    for (;;) {
      bool any = false;
      int32_t v[kSearchProbes];
#pragma unroll
      for (int p = 0; p < kSearchProbes; ++p) {
        v[p] = 0;
        if (lo[p] < hi[p]) {
          any = true;
          v[p] = __ldg(indices + lo[p] + ((hi[p] - lo[p]) >> 1));
        }
      }
      if (!any) {
        break;
      }
#pragma unroll
      for (int p = 0; p < kSearchProbes; ++p) {
        if (lo[p] < hi[p]) {
          const int32_t mid = lo[p] + ((hi[p] - lo[p]) >> 1);
          if (v[p] < t[p]) {
            lo[p] = mid + 1;
          } else {
            hi[p] = mid;
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kSearchProbes; ++p) {
      const int64_t i = base + p * kThreads + threadIdx.x;
      if (i < n) {
        const bool hit = lo[p] < end[p] && __ldg(indices + lo[p]) == t[p];
        found[i] = hit;
        epos[i] = hit ? (pos_map != nullptr ? __ldg(pos_map + lo[p]) : lo[p])
                      : 0;
      }
    }
  }
}

int64_t grid_for(int64_t n, int probes) {
  const int64_t tile = (int64_t)kThreads * probes;
  const int64_t blocks = (n + tile - 1) / tile;
  // grid-stride: huge probe sets reuse threads instead of exceeding the
  // grid limit
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  Every pointer is device memory; pos_map may be null.  `index`
// is ops.build_search_index(indices) for `fence`, 32-byte aligned as
// indices is; `search` ignores it.
extern "C" int wcoj_probe_fence(const void* indptr, const void* indices,
                                const void* index, const void* rows,
                                const void* targets, const void* pos_map,
                                int64_t nnz, int64_t n, void* found,
                                void* epos, void* stream) {
  if (n <= 0) {
    return 0;
  }
  // level k's base: the levels follow one another, each padded to whole
  // nodes (ops.search_levels)
  Levels lv = {};
  lv.base[0] = (const int32_t*)indices;
  int64_t m = nnz, off = 0;
  for (int k = 1; m > kNode && k < kMaxLevels; ++k) {
    m = (m + kNode - 1) >> kShift;
    lv.base[k] = (const int32_t*)index + off;
    off += ((m + kNode - 1) >> kShift) << kShift;
  }
  const unsigned grid = (unsigned)grid_for(n, kProbes);
  auto kernel = nnz >= kWideNnz ? fence_kernel<kBlocksWide>
                                : fence_kernel<kBlocksL2>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, lv, (const int32_t*)rows,
      (const int32_t*)targets, (const int32_t*)pos_map, n,
      (bool*)found, (int32_t*)epos);
  return (int)cudaGetLastError();
}

extern "C" int wcoj_probe_search(const void* indptr, const void* indices,
                                 const void* index, const void* rows,
                                 const void* targets, const void* pos_map,
                                 int64_t nnz, int64_t n, void* found,
                                 void* epos, void* stream) {
  (void)index;
  (void)nnz;
  if (n <= 0) {
    return 0;
  }
  search_kernel<<<(unsigned)grid_for(n, kSearchProbes), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const int32_t*)rows,
      (const int32_t*)targets, (const int32_t*)pos_map, n, (bool*)found,
      (int32_t*)epos);
  return (int)cudaGetLastError();
}
