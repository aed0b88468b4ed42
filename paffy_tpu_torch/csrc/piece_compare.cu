// K1: per-record match counts over M-run pieces of the extended pool.
//
// Replaces paffy_tpu/ops/pallas_compare.py::_compare_kernel (the Pallas DMA
// compare, launched by _piece_match_counts, reduced per record by
// _reduce_to_records).  The piece table comes from the host side
// (paffy_tpu_torch/ops/compare.py::build_piece_table): int64 [4, n_pieces],
// rows qsrc, tsrc, n, rec, pieces in record order.  A piece is n columns of
// one M run: the query bytes ext[qsrc, qsrc+n) and the target bytes
// ext[tsrc, tsrc+n), both ascending (reverse pieces read the pre-complemented
// mirror half of ext, see ext_pool.cu).  The kernel adds the number of equal
// byte pairs of each piece to match[rec]; the caller gets mismatches as the
// record's M columns minus its matches.
//
// Bound: memory.  Each column reads 2 bytes of ext, plus 32 bytes of table
// per piece and 8 bytes of output per record: about 2.57e8 bytes for the
// 1.25e8 columns of a chromosome-scale pair, 0.077 ms at the H100's
// 3.35 TB/s.  The design answers what held the one-byte-load version at 28%
// of that bound:
//
// * 16-byte loads.  A piece is walked in windows of 512 target bytes, the
//   32 aligned 16-byte words from floor16(tsrc) + 512w.  Lane j loads word j
//   of the window and the two aligned query words that cover the same 16
//   columns, and realigns the query with __funnelshift_r (the shift is the
//   same for every lane of a piece).  Equal bytes are the zero bytes of
//   q ^ t, flagged in their top bits without carries between bytes; the
//   four words' flags are folded into one word and masked to the piece's
//   columns with two lookups, then counted with one __popc.  Query words
//   outside [0, ext_len) are not read (they hold no column of the piece);
//   ext_len is a multiple of 16, so aligned words are wholly inside or
//   outside.
// * Warp-sized work.  One warp takes 8 consecutive pieces and walks their
//   windows as one sequence of steps, so a run of median length (~420
//   columns) fills most of a warp's step instead of under two strides of a
//   256-thread block, and a longer run takes one step per window with no
//   table entry per window (the host cuts runs only every 4096 columns, to
//   bound a warp's work).  Few pieces a warp and 4-warp blocks keep the
//   warps' work even: a run's windows vary from 1 to 8.  The count stays in
//   registers while the record stays the same and is flushed with
//   __reduce_add_sync and one 64-bit atomicAdd per (warp, record): exact
//   in any order.
// * Bytes in flight.  Lane k loads the table entry of the warp's k-th piece
//   up front (one coalesced load per row, no dependent load per piece), and
//   each step finds its piece with one ballot over the lanes' first steps
//   and takes the entry by __shfl_sync.  Each iteration issues the loads of
//   kUnroll steps before comparing any.  Two steps an iteration keep the
//   register count low (nvcc's -Xptxas -v count is printed by
//   chip_smoke.py's build phase).
//
// All addressing is int64: pools past 2^31 bytes stay on the device (the
// TPU kernel asserted 2L < 2^31, pallas_compare.py:146).  Record indices and
// piece lengths are int32 (the host cuts pieces far shorter; the wrapper
// checks n_records < 2^31).

#include <cstdint>
#include <cuda_runtime.h>

#include "words.cuh"

namespace {

using paffy::kFull;
using paffy::realign;
using paffy::zero_byte_flags;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
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

__device__ __forceinline__ void flush(unsigned count, int rec,
                                      unsigned long long* match) {
  const unsigned sum = __reduce_add_sync(kFull, count);
  if ((threadIdx.x & 31) == 0 && sum != 0) {
    atomicAdd(match + rec, static_cast<unsigned long long>(sum));
  }
}

__global__ void __launch_bounds__(kThreads)
piece_compare_kernel(const uint8_t* __restrict__ ext, int64_t ext_len,
                     const int64_t* __restrict__ table, int64_t n_pieces,
                     unsigned long long* __restrict__ match) {
  __shared__ uint32_t below[17];   // kFlagsBelow, indexed per lane
  if (threadIdx.x < 17) below[threadIdx.x] = kFlagsBelow[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
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
#pragma unroll 1
  for (int s = 0; s < steps; s += kUnroll) {
    uint4 tw[kUnroll], qa[kUnroll], qb[kUnroll];
    int lo[kUnroll], hi[kUnroll], sh[kUnroll], rec[kUnroll];
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
          flush(count, cur, match);
          count = 0;
          cur = rec[u];
        }
        count += c;
      }
    }
  }
  flush(count, cur, match);
}

}  // namespace

extern "C" int paffy_piece_counts(const void* ext, int64_t ext_len,
                                  const void* table, int64_t n_pieces,
                                  void* match, void* stream) {
  if (n_pieces > 0) {
    const int64_t warps = (n_pieces + kPiecesPerWarp - 1) / kPiecesPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    piece_compare_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ext), ext_len,
        static_cast<const int64_t*>(table), n_pieces,
        static_cast<unsigned long long*>(match));
  }
  return static_cast<int>(cudaGetLastError());
}
