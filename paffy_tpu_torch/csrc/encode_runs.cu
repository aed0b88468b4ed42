// K4: the =/X runs of the M ops of a column batch, in two kernels over the
// M-run pieces of the extended pool: a count of run starts per piece, then
// the fill of the cigar, which writes every run's op code ('=' or 'X') and
// length at its final slot in the rebuilt cigar.
//
// Replaces the run extraction of paffy_tpu's mismatch encoder on the TPU:
// ops/tiled.py::_tiled_boundaries :273 (run-start flags over a chunk grid,
// the previous column carried across chunks as tprev/qprev),
// _count_runs_tiled :302 and _extract_runs_tiled :307 (count and compaction
// to (start column, state)), driven by tiled_runs :343;
// ops/mismatch_device.py::_column_runs :107, the per-column form; and the
// host placement that follows them (ops/mismatch.py:391-437: run lengths
// as differences of starts, then fancy-index scatters to each M op's
// slots).  The fill is the device counterpart of the C fill pass
// encode_runs_fill_cigar (paffy_tpu_torch/native/paffy_io.cpp), which
// paffy_tpu's host route runs, and gives the same arrays.
//
// The table comes from the host side (paffy_tpu_torch/ops/runs.py::
// build_run_table): int64 [5, n_pieces], rows qsrc, tsrc, n, col, first,
// pieces in column order.  A piece is n columns of one M op, cut as K1's
// pieces are (piece_compare.cu): its query bytes ext[qsrc, qsrc+n) and
// target bytes ext[tsrc, tsrc+n), both ascending; col is the batch-global
// index of its first column (an op's pieces are contiguous in col); first
// is 1 when it is its M op's first piece.  A column starts a run when it is
// its op's first column, or when its match state (query byte == target
// byte) differs from the previous column's.  Runs never merge across ops,
// so "5M5M" stays two groups.  The fill also takes first_dest[p], the slot
// of piece p's first run start in the rebuilt cigar (its op's first slot
// plus the runs of the op's earlier pieces, reckoned by the host from the
// counts); the non-M ops are already in place.
//
// Bound: memory.  The count reads 2 bytes of ext per column and 40 bytes
// of table per piece and writes 4 bytes per piece; the fill reads the
// same, 8 bytes of first_dest per piece, and writes 9 bytes per run (a
// uint8 op and an int64 length).
//
// The walk is K1's and K7's: its step loads are piece_walk.cuh's
// load_step, shared rather than copied.  A warp takes 8 consecutive pieces
// and walks their windows of 512 target bytes, lane j holding the 16
// columns of aligned target word j and the realigned query bytes of the
// same columns.  Each iteration issues the loads of two steps (kUnroll)
// before either is worked out, so a step's three 16-byte loads no longer
// stall the warp on their own.  Only the loads are shared: K1 folds the
// equal-byte flags into a count, while K4 needs each lane's 16-bit equal
// mask in column order and a carry.  The run starts among a lane's columns
// are the bits where the mask differs from itself shifted up by one
// column; the carried-in bit is the previous lane's top column
// (__shfl_up_sync), for lane 0 the previous step's lane 31 and, at a
// piece's first column that is not its op's first, the column before it,
// re-read from ext once per piece (for a reverse piece, the byte just below
// in the mirrored half: both reads ascend).  The carry is taken after each
// step is worked out, in step order, so it stays exact across the two
// steps of an iteration.  Every piece but an op's first starts on an
// aligned target word (the host cuts every 4096 columns from the first
// aligned word), so that carried-in bit is the only one taken from outside
// the loaded words.
//
// The per-step work is kept small, since both kernels issue many
// instructions per byte: the piece's constants (first of its op, the
// column before it, the fill's first slot and column) are taken by
// __shfl_sync once per piece, not once per step; the mask is gathered by
// multiplies (equal_mask16).  The count needs no atomics: a warp owns its
// pieces, each lane adds up its starts while the piece stays the same, and
// at the piece's end one __reduce_add_sync gives lane 0 the total to store.
//
// The fill: a run's length is the column of the next run start of its op,
// or the op's end, less its own first column.  Within a step the lanes'
// starts are ranked by a warp scan and staged in shared memory (position in
// the step and state); the warp then writes the step's op codes and the
// lengths of the runs that end in the step as contiguous ranges, lane i
// taking entry i, so a warp's stores of a step (tens of runs at
// chromosome scale) are a byte store and an 8-byte store instruction over
// consecutive slots, not one scattered pair per run.
// (Stores straight from registers, each lane's runs at its own slots with
// the next start found by a warp suffix-min, were measured slower on the
// H100, as were a third step's loads in flight, 16 or 32 pieces a warp,
// and 40 registers a thread.)  A step's last run stays open until the next
// start or the op's end, which may lie in a later step, a later piece of
// the same op, or the pieces of the next warps: a run of identical bases
// can span many pieces.  Inside the warp the open run is carried from step
// to step and closed at the first start after it or at its op's end.  A
// warp whose last run is still open when its op goes on into the next
// warp's pieces walks those pieces itself until the first column whose
// state differs, or the op ends (one step for most runs; a run over k
// pieces costs at most its own columns once more).  The first piece of a
// warp, when it is not its op's first, writes nothing for the columns
// before its first start: they belong to the run the previous warp closes.
// So every slot is written once, by one plain store, with no atomics and
// no zeroing, and the result is exact.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "piece_walk.cuh"

namespace {

using paffy::kFull;
using paffy::kPiecesPerWarp;
using paffy::kUnroll;
using paffy::kWalkThreads;
using paffy::kWalkWarpsPerBlock;
using paffy::kWindow;
using paffy::load_step;
using paffy::realign;
using paffy::StepWords;
using paffy::zero_byte_flags;

constexpr uint8_t kSeqMatch = 3;      // '=' (the reference's op codes)
constexpr uint8_t kSeqMismatch = 4;   // 'X'
constexpr unsigned kPosMask = 0x7fffu;   // a staged start's position bits

// bit b: column b of the lane's word matches (b = 0..15).  The top bits
// of a word's zero bytes (bits 7, 15, 23, 31) are gathered into bits
// 28..31 by one multiply: 0x00204081 = 1 + 2^7 + 2^14 + 2^21 sends bit
// 8j+7 to 8j+7+7i, which is 28+j for i = 3-j, and no two of the sixteen
// products share a bit, so nothing carries.
__device__ __forceinline__ uint32_t equal_mask16(const StepWords& w) {
  const uint4 q = realign(w.qa, w.qb, w.sh);
  auto nibble = [](uint32_t x) {
    return (zero_byte_flags(x) * 0x00204081u) >> 28;
  };
  return nibble(q.x ^ w.tw.x) | (nibble(q.y ^ w.tw.y) << 4) |
         (nibble(q.z ^ w.tw.z) << 8) | (nibble(q.w ^ w.tw.w) << 12);
}

// the bits [lo, hi) of a lane's 16 columns
__device__ __forceinline__ uint32_t column_bits(int lo, int hi) {
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

template <bool kFill>
__global__ void __launch_bounds__(kWalkThreads)
encode_runs_kernel(const uint8_t* __restrict__ ext, int64_t ext_len,
                   const int64_t* __restrict__ table, int64_t n_pieces,
                   int* __restrict__ counts,
                   const int64_t* __restrict__ first_dest,
                   uint8_t* __restrict__ new_ops,
                   int64_t* __restrict__ new_lens) {
  // the fill's run starts of a warp's step, in column order: position in
  // the step, the run's state at bit 15; one buffer per step of an
  // iteration, so a step's reads and the next step's writes need no
  // barrier between them
  __shared__ uint16_t staged[kFill ? kWalkWarpsPerBlock : 1]
                            [kFill ? kUnroll * kWindow : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kWalkWarpsPerBlock +
                      warp) * kPiecesPerWarp;
  if (p0 >= n_pieces) return;   // the whole warp
  const int cnt = static_cast<int>(
      n_pieces - p0 < kPiecesPerWarp ? n_pieces - p0 : kPiecesPerWarp);
  // lane k holds piece p0 + k
  int64_t my_q = 0, my_t = 0, my_col = 0, my_dest = 0;
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
    if (kFill) my_dest = first_dest[p];
  }
  int incl = my_windows;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int my_first = incl - my_windows;   // lanes >= cnt: the step count
  const int steps = __shfl_sync(kFull, incl, 31);
  // the current piece (warp-uniform): its lane, whether it is its op's
  // first, and for the fill its first slot and first column
  int cur = 0;
  int opfirst = __shfl_sync(kFull, my_opfirst, 0);
  int64_t dest = __shfl_sync(kFull, my_dest, 0);
  int64_t col = __shfl_sync(kFull, my_col, 0);
  // state of the column before the step's first (lane 0's carried-in bit):
  // at a piece's first step the column before the piece, then the top
  // column of the previous step's lane 31
  unsigned carry = __shfl_sync(kFull, my_before, 0);
  unsigned lane_starts = 0;   // the count's run starts of the current piece
  int64_t done = 0;           // the fill's: in the piece's earlier steps
  // the fill's open run, whose end is not found yet: its slot, first column
  // and state (warp-uniform)
  bool open = false;
  int64_t open_slot = 0, open_col = 0;
  uint32_t open_state = 0;
#pragma unroll 1
  for (int s = 0; s < steps; s += kUnroll) {
    StepWords w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = load_step(ext, ext_len, my_t, my_q, my_n, my_first, s + u,
                       steps);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int step = s + u;
      if (step < steps) {   // the same on every lane
        const int src = w[u].src;
        if (src != cur) {   // the step opens the warp's next piece
          if constexpr (!kFill) {
            const unsigned total = __reduce_add_sync(kFull, lane_starts);
            if (lane == 0) counts[p0 + cur] = static_cast<int>(total);
            lane_starts = 0;
          }
          opfirst = __shfl_sync(kFull, my_opfirst, src);
          if (kFill && open && opfirst) {
            // the open run ends with its op, at the previous piece's end
            const int64_t end = col + __shfl_sync(kFull, my_n, cur);
            if (lane == 0) new_lens[open_slot] = end - open_col;
            open = false;
          }
          cur = src;
          carry = __shfl_sync(kFull, my_before, src);
          if constexpr (kFill) {
            dest = __shfl_sync(kFull, my_dest, src);
            col = __shfl_sync(kFull, my_col, src);
            done = 0;
          }
        }
        const uint32_t eq = equal_mask16(w[u]);
        const uint32_t up = __shfl_up_sync(kFull, eq, 1);
        const uint32_t cin = lane != 0 ? (up >> 15) & 1u : carry;
        carry = (__shfl_sync(kFull, eq, 31) >> 15) & 1u;
        uint32_t st = (eq ^ ((eq << 1) | cin)) & column_bits(w[u].lo, w[u].hi);
        if (w[u].off == 0 && opfirst) st |= 1u << w[u].head;   // op's first
        const int c = __popc(st);
        if constexpr (!kFill) {
          lane_starts += static_cast<unsigned>(c);
        } else {
          int pre = c;   // inclusive scan of the lanes' start counts
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFull, pre, d);
            if (lane >= d) pre += v;
          }
          const int total = __shfl_sync(kFull, pre, 31);
          uint16_t* buf = staged[warp] + u * kWindow;
          for (int k = pre - c; st; ++k) {
            const int b = __ffs(st) - 1;
            st &= st - 1;
            buf[k] = static_cast<uint16_t>((16 * lane + b) |
                                           (((eq >> b) & 1u) << 15));
          }
          __syncwarp();
          // the slot of the step's first start, and the column of its
          // position 0
          const int64_t idx0 = dest + done;
          const int64_t col0 = col + (step - w[u].first) * kWindow - w[u].head;
          // each start's op, and the length of each run but the step's
          // last, which ends at the next start
          for (int i = lane; i < total; i += 32) {
            const unsigned e = buf[i];
            new_ops[idx0 + i] = (e >> 15) ? kSeqMatch : kSeqMismatch;
            if (i + 1 < total) {
              new_lens[idx0 + i] = static_cast<int>(buf[i + 1] & kPosMask) -
                                   static_cast<int>(e & kPosMask);
            }
          }
          if (total > 0) {
            if (open && lane == 0) {   // the open run ends at the first
              new_lens[open_slot] = col0 + (buf[0] & kPosMask) - open_col;
            }
            const unsigned last = buf[total - 1];
            open = true;
            open_slot = idx0 + total - 1;
            open_col = col0 + (last & kPosMask);
            open_state = last >> 15;
          }
          done += total;
        }
      }
    }
  }
  if constexpr (!kFill) {
    const unsigned total = __reduce_add_sync(kFull, lane_starts);
    if (lane == 0) counts[p0 + cur] = static_cast<int>(total);
  } else if (open) {
    // the open run ends with its op: at the end of the warp's last piece,
    // or, where the op goes on into the following pieces, at its first
    // column there whose state differs from the run's
    int64_t end = col + __shfl_sync(kFull, my_n, cur);
    bool found = false;
    for (int64_t q = p0 + cnt;
         !found && q < n_pieces && table[4 * n_pieces + q] == 0; ++q) {
      const int64_t qs = table[q];
      const int64_t ts = table[n_pieces + q];
      const int n = static_cast<int>(table[2 * n_pieces + q]);
      const int64_t q_col = table[3 * n_pieces + q];
      const int windows = (static_cast<int>(ts & 15) + n + kWindow - 1) /
                          kWindow;
      for (int v = 0; v < windows; ++v) {
        // every lane holds the piece, so the step's piece is lane 31's
        const StepWords x = load_step(ext, ext_len, ts, qs, n, 0, v,
                                      windows);
        const uint32_t flip = (equal_mask16(x) ^ (open_state ? 0xffffu : 0u))
                              & column_bits(x.lo, x.hi);
        const unsigned who = __ballot_sync(kFull, flip != 0);
        if (who != 0) {
          const int l = __ffs(who) - 1;
          const int b = __ffs(__shfl_sync(kFull, flip, l)) - 1;
          end = q_col + static_cast<int64_t>(v) * kWindow + 16 * l + b -
                x.head;
          found = true;
          break;
        }
      }
      if (!found) end = q_col + n;
    }
    if (lane == 0) new_lens[open_slot] = end - open_col;
  }
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
    encode_runs_kernel<false><<<paffy::walk_blocks(n_pieces), kWalkThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ext), ext_len,
        static_cast<const int64_t*>(table), n_pieces,
        static_cast<int*>(counts), nullptr, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int paffy_run_fill_cigar(int device, const void* ext,
                                    int64_t ext_len, const void* table,
                                    int64_t n_pieces, const void* first_dest,
                                    void* new_ops, void* new_lens,
                                    void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_pieces > 0) {
    encode_runs_kernel<true><<<paffy::walk_blocks(n_pieces), kWalkThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ext), ext_len,
        static_cast<const int64_t*>(table), n_pieces, nullptr,
        static_cast<const int64_t*>(first_dest),
        static_cast<uint8_t*>(new_ops), static_cast<int64_t*>(new_lens));
  }
  return static_cast<int>(cudaGetLastError());
}
