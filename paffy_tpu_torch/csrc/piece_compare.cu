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
// The walk itself is in piece_walk.cuh, which K7 (group_stats.cu) shares.
//
// All addressing is int64: pools past 2^31 bytes stay on the device (the
// TPU kernel asserted 2L < 2^31, pallas_compare.py:146).  Record indices and
// piece lengths are int32 (the host cuts pieces far shorter; the wrapper
// checks n_records < 2^31).

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "piece_walk.cuh"

extern "C" int paffy_piece_counts(int device, const void* ext,
                                  int64_t ext_len, const void* table,
                                  int64_t n_pieces, void* match,
                                  void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_pieces > 0) {
    paffy::piece_walk_kernel<false>
        <<<paffy::walk_blocks(n_pieces), paffy::kWalkThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(ext), ext_len,
            static_cast<const int64_t*>(table), n_pieces,
            static_cast<unsigned long long*>(match), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
