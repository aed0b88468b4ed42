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
// one position space holding every distinct query sequence end to end, the
// processing order, and the plan of ops/tile_device.tile_plan, built on the
// card from the order.
//
// Design.  The counts start at zero and each record adds exactly 1 to each
// of its bases, so the count record r leaves at position p is min(cap, 1 +
// the records before r in the order, on r's sequence, covering p): the
// positions are independent.  The position space is cut into tiles of T
// consecutive positions, and one block owns one tile: its uint16 counts
// live in shared memory (2T bytes), zeroed at the start.  The plan lists,
// for each tile that some record touches, the processing positions of the
// records whose span [first aligned position, last] meets the tile, in
// processing order; the block walks them in that order, one barrier apart.
// A tile may cover the end of one sequence and the start of the next: its
// records then interleave, which is safe, since a position is only ever
// touched by records of its own sequence and records on different
// sequences commute.
//
// Batches.  The histogram rows (below) grow with the square of the records
// stacked on one tile, so the plan cuts the order into batches whose rows
// fit one buffer, and each batch is one launch of both kernels.  A batch's
// pairs are one sub-range of each tile's list, which two warps find by a
// 32-way search of its positions; a block whose tile has no pair in the
// batch returns at once.  Between batches a tile's counts wait in device
// memory (2T bytes per tile, ``carry``): a block loads them when its tile
// had pairs in an earlier batch and stores them when it has pairs in a
// later one.  With one batch (``carry`` null) the kernel searches, loads
// and stores nothing, and no count is in device memory at all.
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
// device memory, laid out in processing order (row_off, less the batch's
// first row; the buffer is zeroed by the wrapper before each batch); a
// thread adds to it once per run of equal new counts it sees, and the
// warp's flush at the end of a chunk is one atomic for the lanes that
// agree with lane 0.  A second kernel, one warp per record of the batch,
// sums its row to n and scans it for the ((n+1)/2)-th smallest count, or
// writes 32767 when n = 0.
//
// Bound: memory, the function's own bytes -- 16 per interval (istart,
// iend), 8 per record each of run_off, arena_off and the order read, and 8
// per record of levels written.  The rows add 4 bytes per bin written and
// read; with B batches the carried counts add 2 bytes read and 2 written
// per position of each tile that a later batch touches.

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
                 const int64_t* __restrict__ pair_pos,
                 const int64_t* __restrict__ order,
                 const int64_t* __restrict__ arena_off,
                 const int64_t* __restrict__ run_off,
                 const int64_t* __restrict__ istart,
                 const int64_t* __restrict__ iend,
                 const int64_t* __restrict__ row_off, unsigned* hist,
                 int64_t hist_base, int64_t pos_lo, int64_t pos_hi,
                 uint16_t* carry, unsigned cap, int tile) {
  extern __shared__ uint16_t cnt[];   // the tile's counts
  __shared__ int s_pre[kThreads];     // exclusive scan of clipped lengths
  __shared__ int s_start[kThreads];   // clipped starts, tile-relative
  __shared__ int s_warp[kWarps];
  __shared__ int64_t s_range[2][2];   // [pair parity][first, end interval]
  __shared__ int64_t s_batch[2];      // the batch's first, end pair
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = tile_ids[blockIdx.x] * tile, t1 = t0 + tile;
  const int64_t first = pair_off[blockIdx.x], last = pair_off[blockIdx.x + 1];
  int64_t p0 = first, p1 = last;
  uint16_t* kept = nullptr;           // the tile's counts between batches
  if (carry != nullptr) {
    // the batch's pairs of the tile: positions in [pos_lo, pos_hi)
    if (warp < 2) {
      const int64_t k = warp_lower_bound(pair_pos, first, last,
                                         warp == 0 ? pos_lo : pos_hi);
      if (lane == 0) s_batch[warp] = k;
    }
    __syncthreads();
    p0 = s_batch[0];
    p1 = s_batch[1];
    if (p0 == p1) return;             // the same in the whole block
    kept = carry + static_cast<int64_t>(blockIdx.x) * tile;
  }
  if (kept != nullptr && p0 > first) {
    for (int i = tid; i < tile; i += kThreads) cnt[i] = kept[i];
  } else {
    for (int i = tid; i < tile; i += kThreads) cnt[i] = 0;
  }
  for (int64_t p = p0; p < p1; ++p) {
    const int64_t pos = pair_pos[p];
    const int64_t rec = order[pos];
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
    __syncthreads();   // also orders the counts' start before the first pair
    const int64_t k0 = range[0], k1 = range[1];
    const int64_t row0 = row_off[pos] - hist_base - 1;   // bin of count v
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
        const int at = s_start[lo] + (j - s_pre[lo]);
        const unsigned c = cnt[at];
        const unsigned v = c < cap ? c + 1 : cap;
        cnt[at] = static_cast<uint16_t>(v);
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
  if (kept != nullptr && p1 < last) {   // a later batch goes on from here
    __syncthreads();
    for (int i = tid; i < tile; i += kThreads) kept[i] = cnt[i];
  }
}

// One warp per processing position of the batch: n = the sum of its
// record's row, then the ((n+1)/2)-th smallest count, or kEmptyLevel when
// n = 0.
__global__ void __launch_bounds__(kThreads)
tile_median_kernel(int64_t pos_lo, int64_t pos_hi,
                   const int64_t* __restrict__ order,
                   const int64_t* __restrict__ row_off,
                   const unsigned* __restrict__ hist, int64_t hist_base,
                   int64_t* __restrict__ levels) {
  const int lane = threadIdx.x & 31;
  const int64_t pos = pos_lo + ((static_cast<int64_t>(blockIdx.x) *
                                 kThreads + threadIdx.x) >> 5);
  if (pos >= pos_hi) return;        // the same on the whole warp
  const int64_t rec = order[pos];
  const int64_t a = row_off[pos] - hist_base;
  const int64_t b = row_off[pos + 1] - hist_base;
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

// One batch's walk: the blocks of the plan's n_tiles tiles over the pairs
// at processing positions [pos_lo, pos_hi), their rows at row_off -
// hist_base in hist; carry is null for a sweep of one batch.
extern "C" int paffy_tile_walk(int device, int64_t n_tiles,
                               const void* tile_ids, const void* pair_off,
                               const void* pair_pos, const void* order,
                               const void* arena_off, const void* run_off,
                               const void* istart, const void* iend,
                               const void* row_off, void* hist,
                               int64_t hist_base, int64_t pos_lo,
                               int64_t pos_hi, void* carry, int64_t cap,
                               int64_t tile, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  auto p = [](const void* x) { return static_cast<const int64_t*>(x); };
  // the attribute is per device: this sets it on the launch's device
  const int dyn = static_cast<int>(2 * tile);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_walk_kernel<<<static_cast<unsigned>(n_tiles), kThreads, dyn,
                     static_cast<cudaStream_t>(stream)>>>(
      p(tile_ids), p(pair_off), p(pair_pos), p(order), p(arena_off),
      p(run_off), p(istart), p(iend), p(row_off),
      static_cast<unsigned*>(hist), hist_base, pos_lo, pos_hi,
      static_cast<uint16_t*>(carry), static_cast<unsigned>(cap),
      static_cast<int>(tile));
  return static_cast<int>(cudaGetLastError());
}

// One batch's medians: the levels of the records at processing positions
// [pos_lo, pos_hi) of order.
extern "C" int paffy_tile_median(int device, int64_t pos_lo, int64_t pos_hi,
                                 const void* order, const void* row_off,
                                 const void* hist, int64_t hist_base,
                                 void* levels, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (pos_hi <= pos_lo) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (32 * (pos_hi - pos_lo) + kThreads - 1) / kThreads;
  tile_median_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos_lo, pos_hi, static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(row_off),
      static_cast<const unsigned*>(hist), hist_base,
      static_cast<int64_t*>(levels));
  return static_cast<int>(cudaGetLastError());
}
