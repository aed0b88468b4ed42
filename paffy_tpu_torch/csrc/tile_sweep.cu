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
// Inputs: the records' aligned query intervals in CSR form (run_off,
// istart, iend, from native.match_intervals: a record's intervals are
// disjoint and in ascending order), each record's offset arena_off into
// one position space holding every distinct query sequence end to end, and
// the plan of ops/tile_device.tile_plan, built on the card from the order.
//
// Design.  The counts start at zero and each record adds exactly 1 to each
// of its bases, so the count record r leaves at position p is min(cap, 1 +
// the records before r in the order, on r's sequence, covering p): the
// positions are independent.  The position space is cut into tiles of T
// consecutive positions, and one block owns one tile: its uint16 counts
// live in shared memory (2T bytes), zeroed at the start, and no count is in
// device memory at all.  The plan lists, for each tile that some record
// touches, the records whose span [first aligned position, last] meets the
// tile, in processing order; the block walks them in that order, one
// barrier apart.  A tile may cover the end of one sequence and the start of
// the next: its records then interleave, which is safe, since a position is
// only ever touched by records of its own sequence and records on
// different sequences commute.
//
// For one (tile, record) pair two warps find the record's intervals inside
// the tile by a 32-way search of its ascending CSR slice (first interval
// ending after the tile's start, first starting at or after its end); the
// block then takes those intervals 256 at a time, clipped to the tile, with
// an exclusive scan of their lengths in shared memory, and its threads
// stride over the chunk's bases, each finding its interval by a binary
// search of that scan.  A base is read, incremented (saturating) and
// written back in shared memory by one thread.
//
// The median.  A record's new counts lie in [1, B_r], where B_r = min(cap,
// the largest 1 + rank of r among the records of one of its tiles): a
// count at p is 1 + the earlier records covering p, all of them earlier in
// that tile's list.  Each record has a histogram row of B_r uint32 bins in
// device memory (row_off, zeroed by the wrapper); a thread adds to it once
// per run of equal new counts it sees, and the warp's flush at the end of
// a chunk is one atomic for the lanes that agree with lane 0.  A second
// kernel, one warp per record, sums its row to n and scans it for the
// ((n+1)/2)-th smallest count, or writes 32767 when n = 0.
//
// Bound: memory, the function's own bytes -- 16 per interval (istart,
// iend), 8 per record each of run_off, arena_off and the order read, and 8
// per record of levels written.  The rows add 4 bytes per bin written and
// read; the counts never leave the SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr int64_t kEmptyLevel = 32767;

// Inclusive scan of v over the block; *total gets the block's sum.  Every
// thread must call it; it ends with the block synchronized.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    int x = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += u;
    }
    if (lane < kWarps) warp_sums[lane] = x;
  }
  __syncthreads();
  const int out = v + (w ? warp_sums[w - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return out;
}

// The first k in [lo, hi) with key[k] >= x, or hi; key ascends on [lo, hi).
// The whole warp calls it and gets the answer: 32 probes a round.
__device__ int64_t warp_lower_bound(const int64_t* __restrict__ key,
                                    int64_t lo, int64_t hi, int64_t x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t q = lo + (lane + 1) * step - 1;
    const unsigned hit = __ballot_sync(kFull, q >= hi || key[q] >= x);
    if (hit == 0) {                 // past every probe: after the last
      lo = lo + 32 * step;
      continue;
    }
    const int f = __ffs(hit) - 1;
    const int64_t qf = lo + (f + 1) * step - 1;
    if (f > 0) lo = lo + f * step;
    hi = qf < hi ? qf : hi;         // key[qf] >= x: the answer is <= qf
  }
  const int64_t q = lo + lane;
  const unsigned hit = __ballot_sync(kFull, q < hi && key[q] >= x);
  return hit ? lo + __ffs(hit) - 1 : hi;
}

__global__ void __launch_bounds__(kThreads)
tile_walk_kernel(const int64_t* __restrict__ tile_ids,
                 const int64_t* __restrict__ pair_off,
                 const int64_t* __restrict__ pair_rec,
                 const int64_t* __restrict__ arena_off,
                 const int64_t* __restrict__ run_off,
                 const int64_t* __restrict__ istart,
                 const int64_t* __restrict__ iend,
                 const int64_t* __restrict__ row_off, unsigned* hist,
                 unsigned cap, int tile) {
  extern __shared__ uint16_t cnt[];   // the tile's counts
  __shared__ int s_pre[kThreads];     // exclusive scan of clipped lengths
  __shared__ int s_start[kThreads];   // clipped starts, tile-relative
  __shared__ int s_warp[kWarps];
  __shared__ int64_t s_range[2][2];   // [pair parity][first, end interval]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = tile_ids[blockIdx.x] * tile, t1 = t0 + tile;
  for (int i = tid; i < tile; i += kThreads) cnt[i] = 0;
  const int64_t p1 = pair_off[blockIdx.x + 1];
  for (int64_t p = pair_off[blockIdx.x]; p < p1; ++p) {
    const int64_t rec = pair_rec[p];
    const int64_t base = arena_off[rec];
    int64_t* range = s_range[p & 1];
    // the record's intervals in the tile: ends after t0, starts before t1
    if (warp < 2) {
      const int64_t a = run_off[rec], e = run_off[rec + 1];
      const int64_t k = warp == 0
          ? warp_lower_bound(iend, a, e, t0 - base + 1)
          : warp_lower_bound(istart, a, e, t1 - base);
      if (lane == 0) range[warp] = k;
    }
    __syncthreads();   // also orders the zeroing before the first pair
    const int64_t k0 = range[0], k1 = range[1];
    const int64_t row0 = row_off[rec] - 1;   // bin of count v: row0 + v
    for (int64_t c0 = k0; c0 < k1; c0 += kThreads) {
      const int64_t r = c0 + tid;
      int st = 0, len = 0;
      if (r < k1) {
        int64_t s = istart[r] + base - t0, e = iend[r] + base - t0;
        s = s > 0 ? s : 0;
        e = e < tile ? e : tile;
        st = static_cast<int>(s);
        len = e > s ? static_cast<int>(e - s) : 0;
      }
      int chunk;
      const int incl = block_scan(len, s_warp, &chunk);
      s_pre[tid] = incl - len;
      s_start[tid] = st;
      __syncthreads();
      const int m = static_cast<int>(k1 - c0 < kThreads ? k1 - c0 : kThreads);
      unsigned run_val = kNone, run_n = 0;
      for (int j = tid; j < chunk; j += kThreads) {
        // the last interval whose first base is not after j (a zero-length
        // interval shares its scan value with the next)
        int lo = 0, hi = m - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_pre[mid] <= j) lo = mid; else hi = mid - 1;
        }
        const int pos = s_start[lo] + (j - s_pre[lo]);
        const unsigned c = cnt[pos];
        const unsigned v = c < cap ? c + 1 : cap;
        cnt[pos] = static_cast<uint16_t>(v);
        if (v != run_val) {
          if (run_n) atomicAdd(hist + row0 + run_val, run_n);
          run_val = v;
          run_n = 0;
        }
        ++run_n;
      }
      // flush: one atomic for the lanes that agree with lane 0
      const unsigned key = run_n ? run_val : kNone;
      const unsigned key0 = __shfl_sync(kFull, key, 0);
      const bool same = key == key0;
      const unsigned sum = __reduce_add_sync(kFull, same ? run_n : 0u);
      if (lane == 0 && key0 != kNone) atomicAdd(hist + row0 + key0, sum);
      if (!same && run_n) atomicAdd(hist + row0 + run_val, run_n);
      __syncthreads();   // before the next chunk overwrites s_pre, s_start
    }
  }
}

// One warp per record: n = the sum of its row, then the ((n+1)/2)-th
// smallest count, or kEmptyLevel when n = 0.
__global__ void __launch_bounds__(kThreads)
tile_median_kernel(int64_t n_records, const int64_t* __restrict__ row_off,
                   const unsigned* __restrict__ hist,
                   int64_t* __restrict__ levels) {
  const int lane = threadIdx.x & 31;
  const int64_t rec = (static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x) >> 5;
  if (rec >= n_records) return;     // the same on the whole warp
  const int64_t a = row_off[rec], b = row_off[rec + 1];
  unsigned long long n = 0;
  for (int64_t k = a + lane; k < b; k += 32) n += hist[k];
#pragma unroll
  for (int d = 16; d; d >>= 1) n += __shfl_xor_sync(kFull, n, d);
  if (n == 0) {
    if (lane == 0) levels[rec] = kEmptyLevel;
    return;
  }
  const unsigned long long k = (n + 1) / 2;
  unsigned long long acc = 0;
  for (int64_t c0 = a; c0 < b; c0 += 32) {
    unsigned long long x = c0 + lane < b ? hist[c0 + lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += u;
    }
    const unsigned hit = __ballot_sync(kFull, acc + x >= k);
    if (hit) {
      if (lane == 0) levels[rec] = c0 - a + __ffs(hit);   // bin f: count f+1
      return;
    }
    acc += __shfl_sync(kFull, x, 31);
  }
}

}  // namespace

extern "C" int paffy_tile_sweep(int device, int64_t n_tiles,
                                const void* tile_ids, const void* pair_off,
                                const void* pair_rec, const void* arena_off,
                                const void* run_off, const void* istart,
                                const void* iend, const void* row_off,
                                void* hist, int64_t n_records, int64_t cap,
                                int64_t tile, void* levels, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  auto p = [](const void* x) { return static_cast<const int64_t*>(x); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    // the attribute is per device: this sets it on the launch's device
    const int dyn = static_cast<int>(2 * tile);
    const cudaError_t err = cudaFuncSetAttribute(
        tile_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_walk_kernel<<<static_cast<unsigned>(n_tiles), kThreads, dyn, s>>>(
        p(tile_ids), p(pair_off), p(pair_rec), p(arena_off), p(run_off),
        p(istart), p(iend), p(row_off), static_cast<unsigned*>(hist),
        static_cast<unsigned>(cap), static_cast<int>(tile));
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  if (n_records > 0) {
    const int64_t blocks = (32 * n_records + kThreads - 1) / kThreads;
    tile_median_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        n_records, p(row_off), static_cast<const unsigned*>(hist),
        static_cast<int64_t*>(levels));
  }
  return static_cast<int>(cudaGetLastError());
}
