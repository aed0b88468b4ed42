// K7: per-slot matches and columns, and their totals, over a piece table of
// the extended pool: the column stats step of the mesh path.
//
// Replaces paffy_tpu/parallel/pipeline.py::_batched_group_tiled_stats (the
// XLA body of sharded_view_stats): aligned 512-byte rows of ext compared
// with phase-view query windows, equal and valid lanes counted per chunk,
// reduced per record by cumsums and boundary gathers group by group, and
// two global totals.  The chunk grid, the phase views and the roll chain
// work around XLA's gathers on a TPU and are not ported: on the card, K1's
// walk over a piece table computes the matches of any column set exactly.
//
// The table is K1's (paffy_tpu_torch/ops/compare.py::build_piece_table),
// int64 [4, n_pieces], rows qsrc, tsrc, n, slot, for the pieces one mesh
// slot holds: one record group's, or a contiguous range of them when the
// group's columns are cut over the mesh's seq axis.  For each piece the
// kernel adds its equal byte pairs to match[slot] and its n to cols[slot],
// and the matches and mismatches of all pieces to totals[0] and totals[1].
// Every output is u64 and added to, never stored: a record whose pieces
// lie on two slots of a row gets partial counts on each, and their sum is
// exact in any order.  The caller zeroes the outputs.
//
// Bound: memory, as K1's: 2 bytes of ext per column and 32 bytes of table
// per piece read, 16 bytes per slot (match and cols) and 16 of totals
// written.  The design is K1's walk (piece_walk.cuh, kStats = true): 16-byte
// loads, 512-byte windows, 8 pieces a warp, a ballot for each step's piece.
// A warp holds (matches, columns) while the slot stays the same and flushes
// them with __reduce_add_sync and one 64-bit atomicAdd each per (warp,
// slot); a piece's columns are counted once, at its first step, from its n;
// each warp adds its running totals once, at its end.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "piece_walk.cuh"

extern "C" int paffy_group_stats(int device, const void* ext,
                                 int64_t ext_len, const void* table,
                                 int64_t n_pieces, void* match, void* cols,
                                 void* totals, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_pieces > 0) {
    paffy::piece_walk_kernel<true>
        <<<paffy::walk_blocks(n_pieces), paffy::kWalkThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(ext), ext_len,
            static_cast<const int64_t*>(table), n_pieces,
            static_cast<unsigned long long*>(match),
            static_cast<unsigned long long*>(cols),
            static_cast<unsigned long long*>(totals));
  }
  return static_cast<int>(cudaGetLastError());
}
