// Backward of the embedding bag (the table's gradient) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains Wide & Deep through its
// jnp lookup (src/repro/models/recsys.py::embedding_bag, a jnp.take whose
// gradient XLA scatters), and its Pallas embedding bag is a serving
// stand-in with no backward.  This is the gradient of the function the
// forward (embedding_bag.cu) computes, for Wide & Deep's training:
//   keys  [S] int32   the S = N * L slots' table rows, sorted stably by the
//                     wrapper (each row's slots in slot order); V stands
//                     for padding and ids past the table, and sorts last
//   order [S] int64   the slot each sorted key came from (slot s is in bag
//                     s / L)
//   grad  the N bags' gradients, D fp32 each: bag i at
//         grad + (i / G) * row_stride + (i % G) * D
//   out   [V, D] fp32, zeroed by the wrapper: row r becomes the sum of the
//         gradients of the bags over the slots whose id is r.
//
// Bound on this card: bytes.  The dense gradient is written once (13.7 GB
// at Wide & Deep's full table, 107.4M rows of 128 bytes), which the
// wrapper's zero fill does at the memory's rate; these kernels add the
// sorted keys and slots, one gradient row (D * 4 bytes) read for each
// valid slot, and each touched row written again.
//
// Deterministic, without atomics.  A warp sums one chunk of `chunk`
// consecutive sorted slots (bag_bwd_chunks), walking them in order, so a
// row's slots within a chunk add in slot order.  A row whose slots all lie
// in one chunk is written there.  A row that crosses a chunk boundary
// leaves a partial sum in every chunk it touches: the chunk's first piece
// in partial[2c], its last piece in partial[2c + 1].  bag_bwd_merge then
// gives each such row to the warp of the chunk where the row starts, which
// adds the partials in chunk order and writes the row.  So every sum is
// taken in one fixed order and no row is written by two warps.  The
// Zipf-skewed ids put ~52k slots of Wide & Deep's train_batch on each
// field's row 0: one warp walking them would add 52k rows in a chain while
// the card idles; in chunks of 256 they are ~205 warps and ~205 partials,
// which the merge reads 8 at a time.
//
// Loads: lane d of a warp holds column d (at D = 32 one gradient row is one
// coalesced 128-byte read, 4 bytes a lane, so a row stride that is not a
// multiple of 16 bytes, as the deep tower's 1,293 columns, costs nothing);
// a warp reads 32 keys and slots at once, each lane turns its slot into a
// gradient offset, and both are broadcast by shuffle; 8 gradient rows are
// in flight a warp.  Row and gradient offsets are 64-bit: V * D passes 2^31
// at Wide & Deep's full table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 8;  // gradient rows (or partials) a lane loads ahead
constexpr unsigned kFull = 0xffffffffu;

// Sums of each chunk's pieces: complete rows into out, pieces of rows that
// cross the chunk's boundaries into partial.
__global__ void __launch_bounds__(kThreads)
bag_bwd_chunks(const int32_t* __restrict__ keys,
               const long long* __restrict__ order,
               const float* __restrict__ grad, float* __restrict__ out,
               float* __restrict__ partial, int64_t S, int L, int64_t V,
               int D, int64_t G, int64_t row_stride, int chunk,
               int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) {
    return;  // the whole warp: no shuffle below misses a lane
  }
  const int64_t lo = c * chunk;
  const int64_t hi = lo + chunk < S ? lo + chunk : S;
  const int32_t first = keys[lo];
  if ((int64_t)first >= V) {
    return;  // padding only (it sorts last)
  }
  const int32_t before = lo > 0 ? keys[lo - 1] : -1;
  const int32_t after = hi < S ? keys[hi] : -1;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < D;
    float acc = 0.f;
    int32_t cur = first;
    bool head = true;   // acc holds the chunk's first piece
    bool stop = false;  // reached the padding
    for (int64_t s0 = lo; s0 < hi && !stop; s0 += 32) {
      const int n = hi - s0 < 32 ? (int)(hi - s0) : 32;
      int32_t my_key = -1;
      long long my_off = 0;
      if (lane < n) {
        my_key = __ldcs(keys + s0 + lane);
        const long long bag = __ldcs(order + s0 + lane) / L;
        my_off = (bag / G) * row_stride + (bag % G) * D;
      }
      for (int j0 = 0; j0 < n && !stop; j0 += kInFlight) {
        int32_t k[kInFlight];
        float v[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int src = (j0 + j) & 31;
          k[j] = __shfl_sync(kFull, my_key, src);
          const long long off = __shfl_sync(kFull, my_off, src);
          v[j] = 0.f;
          if (col && j0 + j < n && (int64_t)k[j] < V) {
            v[j] = __ldg(grad + off + d);
          }
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          if (stop || j0 + j >= n) {
            continue;  // the same for the whole warp
          }
          if ((int64_t)k[j] >= V) {
            stop = true;
            continue;
          }
          if (k[j] != cur) {
            // cur's piece ends inside the chunk: open only where it is the
            // chunk's first piece and the row began in an earlier chunk
            if (col) {
              if (head && before == cur) {
                partial[2 * c * D + d] = acc;
              } else {
                out[(int64_t)cur * D + d] = acc;
              }
            }
            head = false;
            cur = k[j];
            acc = 0.f;
          }
          acc += v[j];
        }
      }
    }
    // the chunk's last piece: open where the row began earlier or goes on
    // past the chunk (after is padding once the walk reached it)
    if (col) {
      if ((head && before == cur) || after == cur) {
        partial[(2 * c + (head ? 0 : 1)) * D + d] = acc;
      } else {
        out[(int64_t)cur * D + d] = acc;
      }
    }
  }
}

// Each row that crosses a chunk boundary, summed by the warp of the chunk
// where it starts: its partials in chunk order.
__global__ void __launch_bounds__(kThreads)
bag_bwd_merge(const int32_t* __restrict__ keys,
              const float* __restrict__ partial, float* __restrict__ out,
              int64_t V, int D, int chunk, int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks - 1) {
    return;  // the last chunk's rows go on into no other
  }
  const int64_t lo = c * chunk, hi = lo + chunk;  // hi < S
  const int32_t row = keys[hi - 1];
  if ((int64_t)row >= V || keys[hi] != row) {
    return;  // padding, or the chunk's last row ends in the chunk
  }
  if (lo > 0 && keys[lo - 1] == row) {
    return;  // the row starts in an earlier chunk, whose warp sums it
  }
  const int64_t own = keys[lo] == row ? 2 * c : 2 * c + 1;
  // the last chunk e the row reaches: keys[e' * chunk] == row exactly for
  // c < e' <= e (the keys are sorted)
  int64_t a = c + 1, b = n_chunks - 1;
  while (a < b) {
    const int64_t m = (a + b + 1) / 2;
    if (keys[m * chunk] == row) {
      a = m;
    } else {
      b = m - 1;
    }
  }
  const int64_t e = a;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    if (d >= D) {
      break;  // no shuffle follows
    }
    float acc = partial[own * D + d];
    for (int64_t c1 = c + 1; c1 <= e; c1 += kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        v[j] = c1 + j <= e ? partial[2 * (c1 + j) * D + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (c1 + j <= e) {
          acc += v[j];
        }
      }
    }
    out[(int64_t)row * D + d] = acc;
  }
}

}  // namespace

// Launches both kernels on `stream`, back to back, and returns
// cudaGetLastError() (0 on success).  Every pointer is device memory:
// keys int32 [S] sorted, order int64 [S], grad fp32 (bag i at
// (i / G) * row_stride + (i % G) * D, 4-byte aligned), out fp32 [V, D]
// zeroed, partial fp32 [2 * ceil(S / chunk), D] scratch.
extern "C" int embedding_bag_bwd(const void* keys, const void* order,
                                 const void* grad, void* out, void* partial,
                                 int64_t S, int L, int64_t V, int D,
                                 int64_t G, int64_t row_stride, int chunk,
                                 void* stream) {
  if (S <= 0 || L <= 0 || V <= 0 || D <= 0 || G <= 0 || chunk <= 0) {
    return 0;
  }
  const int64_t n_chunks = (S + chunk - 1) / chunk;
  const int64_t blocks = (n_chunks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = (cudaStream_t)stream;
  bag_bwd_chunks<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)keys, (const long long*)order, (const float*)grad,
      (float*)out, (float*)partial, S, L, V, D, G, row_stride, chunk,
      n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  bag_bwd_merge<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)keys, (const float*)partial, (float*)out, V, D, chunk,
      n_chunks);
  return (int)cudaGetLastError();
}
