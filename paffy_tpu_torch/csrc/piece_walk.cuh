// The warp walk over a piece table of the extended pool, shared by K1
// (piece_compare.cu, whose header describes the design) and K7
// (group_stats.cu).  The table is int64 [4, n_pieces], rows qsrc, tsrc, n,
// slot: n >= 1 columns whose query bytes are ext[qsrc, qsrc+n) and target
// bytes ext[tsrc, tsrc+n).  A warp takes kPiecesPerWarp consecutive pieces
// and walks their 512-byte target windows as one sequence of steps, 16
// aligned bytes a lane; the equal bytes of a slot stay in registers while
// the slot stays the same and are flushed with __reduce_add_sync and one
// 64-bit atomicAdd per (warp, slot), so every output is exact in any order.
//
// kStats = false is K1: match[slot] += equal bytes.  kStats = true is K7,
// which also adds each piece's n to cols[slot] (once, at the piece's first
// step: no per-column work) and, once at the warp's end, its matches and
// mismatches to totals[0] and totals[1].

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "words.cuh"

namespace paffy {
// internal linkage: each source that includes this has its own copy
namespace {

constexpr int kWalkWarpsPerBlock = 4;
constexpr int kWalkThreads = 32 * kWalkWarpsPerBlock;
constexpr int kPiecesPerWarp = 8;    // table entries held by lanes 0..7
constexpr int kWindow = 32 * 16;     // target bytes of one warp step
constexpr int kUnroll = 2;           // steps whose loads are issued together

// The four words' equal-byte flags are folded into one word: byte b of word
// k sets bit 8b + 7 - k.  kFlagsBelow[x] has the bits of bytes 0..x-1.
constexpr uint32_t flags_below(int x) {
  uint32_t m = 0;
  for (int i = 0; i < x; ++i) m |= 1u << (8 * (i & 3) + 7 - (i >> 2));
  return m;
}
__constant__ uint32_t kFlagsBelow[17] = {
    flags_below(0),  flags_below(1),  flags_below(2),  flags_below(3),
    flags_below(4),  flags_below(5),  flags_below(6),  flags_below(7),
    flags_below(8),  flags_below(9),  flags_below(10), flags_below(11),
    flags_below(12), flags_below(13), flags_below(14), flags_below(15),
    flags_below(16)};

// Adds the warp's count of the slot to match[slot] (and with kStats its
// columns to cols[slot]); returns the warp's count.
template <bool kStats>
__device__ __forceinline__ unsigned flush(unsigned count,
                                          unsigned long long n_cols,
                                          int slot,
                                          unsigned long long* match,
                                          unsigned long long* cols) {
  const unsigned sum = __reduce_add_sync(kFull, count);
  if ((threadIdx.x & 31) == 0) {
    if (sum != 0) {
      atomicAdd(match + slot, static_cast<unsigned long long>(sum));
    }
    if constexpr (kStats) {
      atomicAdd(cols + slot, n_cols);
    }
  }
  return sum;
}

template <bool kStats>
__global__ void __launch_bounds__(kWalkThreads)
piece_walk_kernel(const uint8_t* __restrict__ ext, int64_t ext_len,
                  const int64_t* __restrict__ table, int64_t n_pieces,
                  unsigned long long* __restrict__ match,
                  unsigned long long* __restrict__ cols,
                  unsigned long long* __restrict__ totals) {
  __shared__ uint32_t below[17];   // kFlagsBelow, indexed per lane
  if (threadIdx.x < 17) below[threadIdx.x] = kFlagsBelow[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kWalkWarpsPerBlock +
                      (threadIdx.x >> 5)) * kPiecesPerWarp;
  if (p0 >= n_pieces) return;   // the whole warp
  const int cnt = static_cast<int>(
      n_pieces - p0 < kPiecesPerWarp ? n_pieces - p0 : kPiecesPerWarp);
  // lane k holds piece p0 + k: its table entry and its window count
  int64_t my_q = 0, my_t = 0;
  int my_n = 0, my_rec = 0, my_windows = 0;
  if (lane < cnt) {
    my_q = table[p0 + lane];
    my_t = table[n_pieces + p0 + lane];
    my_n = static_cast<int>(table[2 * n_pieces + p0 + lane]);
    my_rec = static_cast<int>(table[3 * n_pieces + p0 + lane]);
    my_windows = (static_cast<int>(my_t & 15) + my_n + kWindow - 1) / kWindow;
  }
  // the piece's first step: an exclusive scan of the window counts
  int incl = my_windows;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int my_first = incl - my_windows;   // lanes >= cnt: the step count
  const int steps = __shfl_sync(kFull, incl, 31);
  const int l16 = 16 * lane;
  int cur = __shfl_sync(kFull, my_rec, 0);
  unsigned count = 0;
  unsigned long long n_cols = 0;        // kStats: the slot's columns so far
  unsigned long long all_match = 0, all_cols = 0;   // kStats: the warp's
#pragma unroll 1
  for (int s = 0; s < steps; s += kUnroll) {
    uint4 tw[kUnroll], qa[kUnroll], qb[kUnroll];
    int lo[kUnroll], hi[kUnroll], sh[kUnroll], rec[kUnroll];
    int piece_n[kUnroll];               // n at a piece's first step, else 0
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int step = s + u;
      const bool valid = step < steps;          // the same on every lane
      // the step's piece is the last lane whose first step is not after it
      // (first steps ascend along the lanes)
      const int src = valid
          ? __popc(__ballot_sync(kFull, my_first <= step)) - 1 : 0;
      const int64_t ts = __shfl_sync(kFull, my_t, src);
      const int64_t qs = __shfl_sync(kFull, my_q, src);
      const int n = __shfl_sync(kFull, my_n, src);
      const int first = __shfl_sync(kFull, my_first, src);
      rec[u] = __shfl_sync(kFull, my_rec, src);
      piece_n[u] = (valid && step == first) ? n : 0;
      const int head = static_cast<int>(ts & 15);
      // this lane's word starts off bytes after the piece's first aligned
      // target word and holds the piece's columns at its bytes [lo, hi)
      const int off = (step - first) * kWindow + l16;
      lo[u] = max(head - off, 0);
      hi[u] = valid ? min(head + n - off, 16) : 0;
      const int64_t qbyte = qs - head;   // the query byte of the word's byte 0
      sh[u] = static_cast<int>(qbyte & 15);
      const int64_t qword = (qbyte & ~int64_t{15}) + off;
      tw[u] = qa[u] = qb[u] = make_uint4(0u, 0u, 0u, 0u);
      if (hi[u] > lo[u]) {
        tw[u] = __ldg(reinterpret_cast<const uint4*>(ext + (ts - head) + off));
        if (static_cast<uint64_t>(qword) < static_cast<uint64_t>(ext_len)) {
          qa[u] = __ldg(reinterpret_cast<const uint4*>(ext + qword));
        }
        if (sh[u] != 0 && static_cast<uint64_t>(qword + 16) <
                              static_cast<uint64_t>(ext_len)) {
          qb[u] = __ldg(reinterpret_cast<const uint4*>(ext + qword + 16));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned c = 0;
      if (hi[u] > lo[u]) {
        const uint4 q = realign(qa[u], qb[u], sh[u]);
        const uint4 t = tw[u];
        const uint32_t flags = zero_byte_flags(q.x ^ t.x) |
                               (zero_byte_flags(q.y ^ t.y) >> 1) |
                               (zero_byte_flags(q.z ^ t.z) >> 2) |
                               (zero_byte_flags(q.w ^ t.w) >> 3);
        c = __popc(flags & below[hi[u]] & ~below[lo[u]]);
      }
      if (s + u < steps) {
        if (rec[u] != cur) {   // the same on every lane
          const unsigned sum = flush<kStats>(count, n_cols, cur, match, cols);
          if constexpr (kStats) {
            all_match += sum;
            all_cols += n_cols;
            n_cols = 0;
          }
          count = 0;
          cur = rec[u];
        }
        count += c;
        if constexpr (kStats) n_cols += static_cast<unsigned>(piece_n[u]);
      }
    }
  }
  const unsigned sum = flush<kStats>(count, n_cols, cur, match, cols);
  if constexpr (kStats) {
    all_match += sum;
    all_cols += n_cols;
    if (lane == 0) {
      atomicAdd(totals, all_match);
      atomicAdd(totals + 1, all_cols - all_match);
    }
  }
}

inline unsigned walk_blocks(int64_t n_pieces) {
  const int64_t warps = (n_pieces + kPiecesPerWarp - 1) / kPiecesPerWarp;
  return static_cast<unsigned>((warps + kWalkWarpsPerBlock - 1) /
                               kWalkWarpsPerBlock);
}

}  // namespace
}  // namespace paffy
