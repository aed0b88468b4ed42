// K4: =/X run starts over the M-run pieces of the extended pool, in two
// kernels: a count per piece, then a fill of each run's start column and
// match state at its output index.
//
// Replaces the run extraction of paffy_tpu's mismatch encoder:
// ops/tiled.py::_tiled_boundaries (run-start flags over a chunk grid, with
// the previous column carried across chunks as tprev/qprev),
// _count_runs_tiled and _extract_runs_tiled (count and compaction to
// (start column, state)), driven by tiled_runs; and
// ops/mismatch_device.py::_column_runs, the per-column form.
//
// The table comes from the host side (paffy_tpu_torch/ops/runs.py::
// build_run_table): int64 [5, n_pieces], rows qsrc, tsrc, n, col, first,
// pieces in column order.  A piece is n columns of one M op, cut as K1's
// pieces are (piece_compare.cu): its query bytes ext[qsrc, qsrc+n) and
// target bytes ext[tsrc, tsrc+n), both ascending; col is the batch-global
// index of its first column; first is 1 when it is its M op's first piece.
// A column starts a run when it is its op's first column, or when its
// match state (query byte == target byte) differs from the previous
// column's.  Runs never merge across ops, so "5M5M" stays two groups.
//
// Bound: memory.  Both kernels read 2 bytes of ext per column and 40 bytes
// of table per piece; the count writes 4 bytes per piece, the fill reads 8
// bytes of output index per piece and writes 9 bytes per run (an int64
// column and a uint8 state).  The walk is K1's (see piece_compare.cu): a
// warp takes 8 consecutive pieces and walks their windows of 512 target
// bytes, lane j holding the 16 columns of aligned target word j and the
// realigned query bytes of the same columns.  From the zero-byte flags of
// q ^ t each lane forms a 16-bit equal mask; the run starts among its
// columns are the bits where the mask differs from itself shifted up by
// one column, the carried-in bit being the previous lane's top column
// (__shfl_up_sync), for lane 0 the previous step's lane 31, and at a
// piece's first column that is not its op's first the column before it,
// re-read from ext once per piece (for a reverse piece, the byte just below
// in the mirrored half: both reads ascend).  Every piece but an op's first
// starts on an aligned target word (the host cuts every 4096 columns from
// the first aligned word), so that carried-in bit is the only one taken
// from outside the loaded words.
//
// The count needs no atomics: a warp owns its pieces and lane 0 stores each
// piece's total.  The fill takes each piece's first output index (an
// exclusive scan of the counts, done by the caller) and orders the starts
// inside a step by a warp scan of the lanes' counts and each lane's set
// bits, so the output is in column order, as paffy_tpu's compaction gives
// it.  One step at a time: the loads of the next step are not issued early
// (K1 issues two steps' loads together); that is left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "words.cuh"

namespace {

using paffy::kFull;
using paffy::realign;
using paffy::zero_byte_flags;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kPiecesPerWarp = 8;    // table entries held by lanes 0..7
constexpr int kWindow = 32 * 16;     // target bytes of one warp step

// bit b: byte b of q equals byte b of t (b = 0..15)
__device__ __forceinline__ uint32_t equal_mask16(uint4 q, uint4 t) {
  auto nibble = [](uint32_t x) {
    const uint32_t f = zero_byte_flags(x);   // bits 7, 15, 23, 31
    return ((f >> 7) & 1u) | ((f >> 14) & 2u) | ((f >> 21) & 4u) |
           ((f >> 28) & 8u);
  };
  return nibble(q.x ^ t.x) | (nibble(q.y ^ t.y) << 4) |
         (nibble(q.z ^ t.z) << 8) | (nibble(q.w ^ t.w) << 12);
}

template <bool kFill>
__global__ void __launch_bounds__(kThreads)
encode_runs_kernel(const uint8_t* __restrict__ ext, int64_t ext_len,
                   const int64_t* __restrict__ table, int64_t n_pieces,
                   int* __restrict__ counts,
                   const int64_t* __restrict__ first_out,
                   int64_t* __restrict__ starts,
                   uint8_t* __restrict__ states) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5)) * kPiecesPerWarp;
  if (p0 >= n_pieces) return;   // the whole warp
  const int cnt = static_cast<int>(
      n_pieces - p0 < kPiecesPerWarp ? n_pieces - p0 : kPiecesPerWarp);
  // lane k holds piece p0 + k
  int64_t my_q = 0, my_t = 0, my_col = 0, my_out = 0;
  int my_n = 0, my_opfirst = 0, my_windows = 0;
  unsigned my_before = 0;   // match state of the column before the piece
  if (lane < cnt) {
    const int64_t p = p0 + lane;
    my_q = table[p];
    my_t = table[n_pieces + p];
    my_n = static_cast<int>(table[2 * n_pieces + p]);
    my_col = table[3 * n_pieces + p];
    my_opfirst = static_cast<int>(table[4 * n_pieces + p]);
    my_windows = (static_cast<int>(my_t & 15) + my_n + kWindow - 1) / kWindow;
    if (!my_opfirst) my_before = ext[my_q - 1] == ext[my_t - 1];
    if (kFill) my_out = first_out[p];
  }
  int incl = my_windows;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int my_step0 = incl - my_windows;   // the piece's first step
  const int steps = __shfl_sync(kFull, incl, 31);
  const int l16 = 16 * lane;
  int cur = 0;            // lane holding the current piece (warp-uniform)
  int64_t done = 0;       // run starts of the current piece in earlier steps
  unsigned carry = 0;     // top column's state of the previous step's lane 31
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    // the step's piece is the last lane whose first step is not after it
    const int src = __popc(__ballot_sync(kFull, my_step0 <= s)) - 1;
    if (src != cur) {
      if (!kFill && lane == 0) counts[p0 + cur] = static_cast<int>(done);
      cur = src;
      done = 0;
    }
    const int64_t ts = __shfl_sync(kFull, my_t, src);
    const int64_t qs = __shfl_sync(kFull, my_q, src);
    const int n = __shfl_sync(kFull, my_n, src);
    const int step0 = __shfl_sync(kFull, my_step0, src);
    const int opfirst = __shfl_sync(kFull, my_opfirst, src);
    const unsigned before = __shfl_sync(kFull, my_before, src);
    const int head = static_cast<int>(ts & 15);
    // this lane's word starts off bytes after the piece's first aligned
    // target word and holds the piece's columns at its bytes [lo, hi)
    const int off = (s - step0) * kWindow + l16;
    const int lo = max(head - off, 0);
    const int hi = min(head + n - off, 16);
    const int64_t qbyte = qs - head;   // the query byte of the word's byte 0
    const int sh = static_cast<int>(qbyte & 15);
    const int64_t qword = (qbyte & ~int64_t{15}) + off;
    uint4 tw = make_uint4(0u, 0u, 0u, 0u), qa = tw, qb = tw;
    if (hi > lo) {
      tw = __ldg(reinterpret_cast<const uint4*>(ext + (ts - head) + off));
      if (static_cast<uint64_t>(qword) < static_cast<uint64_t>(ext_len)) {
        qa = __ldg(reinterpret_cast<const uint4*>(ext + qword));
      }
      if (sh != 0 && static_cast<uint64_t>(qword + 16) <
                         static_cast<uint64_t>(ext_len)) {
        qb = __ldg(reinterpret_cast<const uint4*>(ext + qword + 16));
      }
    }
    const uint32_t eq = equal_mask16(realign(qa, qb, sh), tw);
    const uint32_t up = __shfl_up_sync(kFull, eq, 1);
    const uint32_t cin = lane != 0 ? (up >> 15) & 1u
                                   : (s == step0 ? before : carry);
    carry = (__shfl_sync(kFull, eq, 31) >> 15) & 1u;
    const uint32_t valid = hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u)
                                   : 0u;
    uint32_t st = (eq ^ ((eq << 1) | cin)) & valid;
    if (off == 0 && opfirst) st |= 1u << head;   // the op's first column
    const int c = __popc(st);
    if (kFill) {
      int pre = c;   // inclusive scan of the lanes' start counts
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, pre, d);
        if (lane >= d) pre += v;
      }
      int64_t idx = __shfl_sync(kFull, my_out, src) + done + (pre - c);
      const int64_t col0 = __shfl_sync(kFull, my_col, src) + off - head;
      while (st) {
        const int b = __ffs(st) - 1;
        st &= st - 1;
        starts[idx] = col0 + b;
        states[idx] = static_cast<uint8_t>((eq >> b) & 1u);
        ++idx;
      }
      done += __shfl_sync(kFull, pre, 31);
    } else {
      done += __reduce_add_sync(kFull, static_cast<unsigned>(c));
    }
  }
  if (!kFill && lane == 0) counts[p0 + cur] = static_cast<int>(done);
}

unsigned grid_of(int64_t n_pieces) {
  const int64_t warps = (n_pieces + kPiecesPerWarp - 1) / kPiecesPerWarp;
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int paffy_run_counts(int device, const void* ext,
                                int64_t ext_len, const void* table,
                                int64_t n_pieces, void* counts,
                                void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_pieces > 0) {
    encode_runs_kernel<false><<<grid_of(n_pieces), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ext), ext_len,
        static_cast<const int64_t*>(table), n_pieces,
        static_cast<int*>(counts), nullptr, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int paffy_run_fill(int device, const void* ext,
                              int64_t ext_len, const void* table,
                              int64_t n_pieces,
                              const void* first_out, void* starts,
                              void* states, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_pieces > 0) {
    encode_runs_kernel<true><<<grid_of(n_pieces), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ext), ext_len,
        static_cast<const int64_t*>(table), n_pieces, nullptr,
        static_cast<const int64_t*>(first_out),
        static_cast<int64_t*>(starts), static_cast<uint8_t*>(states));
  }
  return static_cast<int>(cudaGetLastError());
}
