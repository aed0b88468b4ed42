// K5: the greedy tile sweep.  Records in best-first order add their aligned
// query bases into uint16 coverage counts, saturating at a cap; a record's
// tile level is the ((n+1)/2)-th smallest of its n new counts, or 32767
// when it has no aligned base.
//
// Replaces paffy_tpu/ops/tile_device.py::_tile_scan (a lax.scan over the
// records of one coverage segment, each step building the record's mask
// over a padded [K] interval row, adding it into the carried counts and
// bisecting for the median) and ::_tile_scan_groups (the same, vmapped over
// segments); the host sweep native.tile_sweep (paffy_io.cpp) is its
// reference.  Semantics of impl/paf_tile.c:36-93: the smallest L with
// |{counts <= L}| >= n/2.0 is, for integer counts, the ((n+1)/2)-th
// smallest.
//
// Inputs are the host sweep's arguments, on the device: the records'
// aligned query intervals in CSR form (run_off, istart, iend, from
// native.match_intervals; the intervals of one record are disjoint), each
// record's offset arena_off into one uint16 arena holding the counts of
// every distinct query sequence end to end, and the order -- grouped here
// by sequence (seq_off / order), stable, because records on different
// query sequences commute.
//
// Design: one block per query sequence walks its records in order, so no
// two blocks touch the same counts and no order between blocks is needed.
// For a record, the block takes its intervals 1024 at a time into shared
// memory with an exclusive scan of their lengths, and its threads stride
// over the chunk's bases, each finding its interval by a binary search of
// that scan; a base is read, incremented (saturating) and written back by
// one thread.  The new counts go into a histogram in shared memory (cap+1
// bins of 4 bytes, 128 KB at the default cap, dynamic shared memory); a
// thread adds to it once per run of equal new counts it sees, and the
// warp's flush at the end of a chunk is one atomic for the lanes that
// agree with lane 0 (most bases of a record share a count).  Then a block
// scan over the bins up to the largest count seen finds the level, and
// those bins are cleared.
//
// Bound: memory, 4 bytes per aligned base (a 2-byte read and write of its
// count), 16 per interval and 8 per record.  With one query sequence this
// design uses one block, one SM of 132: that is the simple form, and its
// time is recorded beside the bound; spreading a sequence's records over
// the card is a later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // bases whose loads are issued together
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr int64_t kEmptyLevel = 32767;

// Inclusive scan of v over the block; *total gets the block's sum.  Every
// thread must call it; it ends with the block synchronized.
__device__ __forceinline__ int64_t block_scan(int64_t v, int64_t* warp_sums,
                                              int64_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    int64_t x = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += u;
    }
    warp_sums[lane] = x;
  }
  __syncthreads();
  const int64_t out = v + (w ? warp_sums[w - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return out;
}

// Add a thread's run of equal counts to the histogram.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned value,
                                         unsigned n) {
  if (n) atomicAdd(hist + value, n);
}

__global__ void __launch_bounds__(kThreads, 1)
tile_sweep_kernel(const int64_t* __restrict__ seq_off,
                  const int64_t* __restrict__ order,
                  const int64_t* __restrict__ arena_off,
                  const int64_t* __restrict__ run_off,
                  const int64_t* __restrict__ istart,
                  const int64_t* __restrict__ iend, uint16_t* arena,
                  unsigned cap, int64_t* __restrict__ levels) {
  extern __shared__ unsigned hist[];          // cap + 1 bins
  __shared__ int64_t s_pre[kThreads];         // exclusive scan of lengths
  __shared__ int64_t s_start[kThreads];
  __shared__ int64_t s_warp[kWarps];
  __shared__ unsigned s_max;
  const int tid = threadIdx.x, lane = tid & 31;
  for (unsigned b = tid; b <= cap; b += kThreads) hist[b] = 0;
  if (tid == 0) s_max = 0;
  __syncthreads();
  for (int64_t oi = seq_off[blockIdx.x]; oi < seq_off[blockIdx.x + 1]; ++oi) {
    const int64_t rec = order[oi];
    const int64_t r0 = run_off[rec], r1 = run_off[rec + 1];
    uint16_t* cov = arena + arena_off[rec];
    int64_t n_rec = 0;
    unsigned my_max = 0;
    for (int64_t c0 = r0; c0 < r1; c0 += kThreads) {
      const int64_t r = c0 + tid;
      int64_t len = 0, st = 0;
      if (r < r1) {
        st = istart[r];
        len = iend[r] - st;
      }
      int64_t chunk;
      const int64_t incl = block_scan(len, s_warp, &chunk);
      s_pre[tid] = incl - len;
      s_start[tid] = st;
      __syncthreads();
      const int m = static_cast<int>(r1 - c0 < kThreads ? r1 - c0 : kThreads);
      unsigned run_val = kNone, run_n = 0;
      for (int64_t j0 = tid; j0 < chunk; j0 += kUnroll * kThreads) {
        int64_t pos[kUnroll];
        unsigned c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t j = j0 + u * kThreads;
          pos[u] = -1;
          if (j < chunk) {
            // the last interval whose first base is not after j (a
            // zero-length interval shares its scan value with the next)
            int lo = 0, hi = m - 1;
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (s_pre[mid] <= j) lo = mid; else hi = mid - 1;
            }
            pos[u] = s_start[lo] + (j - s_pre[lo]);
            c[u] = cov[pos[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (pos[u] < 0) continue;
          const unsigned v = c[u] < cap ? c[u] + 1 : cap;
          cov[pos[u]] = static_cast<uint16_t>(v);
          if (v != run_val) {
            if (run_val != kNone) hist_add(hist, run_val, run_n);
            run_val = v;
            run_n = 0;
            my_max = max(my_max, v);
          }
          ++run_n;
        }
      }
      // flush: one atomic for the lanes that agree with lane 0
      const unsigned key = run_n ? run_val : kNone;
      const unsigned key0 = __shfl_sync(kFull, key, 0);
      const bool same = key == key0;
      const unsigned sum = __reduce_add_sync(kFull, same ? run_n : 0u);
      if (lane == 0 && key0 != kNone) atomicAdd(hist + key0, sum);
      if (!same) hist_add(hist, run_val, run_n);
      n_rec += chunk;
      __syncthreads();   // before the next chunk overwrites s_pre, s_start
    }
    if (n_rec == 0) {    // the same on every thread
      if (tid == 0) levels[rec] = kEmptyLevel;
      continue;
    }
    atomicMax(&s_max, my_max);
    __syncthreads();
    const unsigned n_bins = s_max + 1;
    const unsigned per = (n_bins + kThreads - 1) / kThreads;
    const unsigned b0 = min(tid * per, n_bins), b1 = min(b0 + per, n_bins);
    int64_t mine = 0;
    for (unsigned b = b0; b < b1; ++b) mine += hist[b];
    int64_t total;
    const int64_t incl = block_scan(mine, s_warp, &total);
    const int64_t k = (n_rec + 1) / 2;   // the k-th smallest count
    int64_t acc = incl - mine;
    if (acc < k && k <= incl) {
      for (unsigned b = b0; b < b1; ++b) {
        acc += hist[b];
        if (acc >= k) {
          levels[rec] = b;
          break;
        }
      }
    }
    __syncthreads();   // every thread has read the histogram
    for (unsigned b = b0; b < b1; ++b) hist[b] = 0;
    if (tid == 0) s_max = 0;
    __syncthreads();
  }
}

}  // namespace

extern "C" int paffy_tile_sweep(int device, int64_t n_seqs,
                                const void* seq_off,
                                const void* order, const void* arena_off,
                                const void* run_off, const void* istart,
                                const void* iend, void* arena, int64_t cap,
                                void* levels, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  // the attribute is per device: this sets it on the launch's device
  const int dyn = static_cast<int>(4 * (cap + 1));
  cudaError_t err = cudaFuncSetAttribute(
      tile_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_seqs > 0) {
    tile_sweep_kernel<<<static_cast<unsigned>(n_seqs), kThreads, dyn,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(seq_off),
        static_cast<const int64_t*>(order),
        static_cast<const int64_t*>(arena_off),
        static_cast<const int64_t*>(run_off),
        static_cast<const int64_t*>(istart),
        static_cast<const int64_t*>(iend), static_cast<uint16_t*>(arena),
        static_cast<unsigned>(cap), static_cast<int64_t*>(levels));
  }
  return static_cast<int>(cudaGetLastError());
}
