// K6: the windowed chain DP.  For each record i of a (qname, tname) group,
// in processing order (ascending query start),
//
//   cs[i] = max(score[i], max_j score[i] + cs[j] - g(i, j))
//
// over the candidates j of its window [lo[i], lo[i] + w[i]) of the group's
// query-end order with j < i, 0 <= tgap <= max_gap and g < score[i], where
// g = 0 for a zero total gap and gap_open + gap_extend * (qgap + tgap)
// otherwise; pred[i] is the best j, ties going to the largest (te, qe, j),
// or -1 when no candidate beats score[i].  All int64: chain scores of a
// chromosome pass 2^31.
//
// Replaces paffy_tpu/ops/chain_device.py::_dp_scan (a lax.scan over the
// records of one group, each step a w_pad-wide masked window and nested max
// reductions) and ::_dp_scan_groups (the same, vmapped over groups padded
// to one size); the C DP chain_dp (paffy_io.cpp) is its reference.
//
// Inputs: the groups of one strand set end to end, no padding
// (ops/chain.dp_arguments).  goff[g]..goff[g+1] are group g's slots; in
// processing order qs, ts, score, lo, w, pos (the record's own slot in the
// query-end order); in query-end order qe_s, te_s, idx_s (the record's
// processing slot), so a window is one contiguous, coalesced slice.
// cs_sorted is scratch: the chain scores in query-end order, as _dp_scan's
// carry, written through pos.
//
// Design: one block per group walks its records in order, as the DP is
// serial within a group.  The block's threads stride over the record's
// window, each keeping its best candidate by the key (val, te, qe, j); a
// warp reduction with shuffles of the four keys and a second one over the
// warps' bests in shared memory pick the block's best.  Thread 0 writes cs,
// pred and cs_sorted; the __syncthreads that ends the record makes that
// write visible to the next record's reads, so nothing of cs is cached
// across records.  256 threads: windows of the chromosome-scale input are
// ~1,600 records (median; at most ~1,840), 7 strides; per record the cost
// is the two barriers and the 5-level shuffle reduction, which a wider
// block makes no shorter.
//
// Bound: operations, ~30 32-bit integer instructions per candidate of the
// windows, over the card's integer rate; the bytes (72 read and 16 written
// per record) are far below.  The serial depth is the largest group's
// record count: with one group per strand set this design keeps one or two
// SMs of 132 busy, the simple form; spreading a group over the card is a
// later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Cand {
  int64_t val, te, qe, idx;
};

__device__ __forceinline__ Cand no_cand() {
  return {INT64_MIN, INT64_MIN, INT64_MIN, -1};
}

// a before b in descending (val, te, qe, idx): one lexicographic compare
__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  if (a.val != b.val) return a.val > b.val;
  if (a.te != b.te) return a.te > b.te;
  if (a.qe != b.qe) return a.qe > b.qe;
  return a.idx > b.idx;
}

__device__ __forceinline__ int64_t shfl_xor(int64_t v, int m) {
  return static_cast<int64_t>(
      __shfl_xor_sync(kFull, static_cast<long long>(v), m));
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    const Cand o{shfl_xor(c.val, m), shfl_xor(c.te, m), shfl_xor(c.qe, m),
                 shfl_xor(c.idx, m)};
    if (better(o, c)) c = o;
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
chain_dp_kernel(const int64_t* __restrict__ goff,
                const int64_t* __restrict__ qs, const int64_t* __restrict__ ts,
                const int64_t* __restrict__ score,
                const int64_t* __restrict__ qe_s,
                const int64_t* __restrict__ te_s,
                const int64_t* __restrict__ idx_s,
                const int64_t* __restrict__ lo, const int64_t* __restrict__ w,
                const int64_t* __restrict__ pos, int64_t gap_open,
                int64_t gap_extend, int64_t max_gap, int64_t* cs_sorted,
                int64_t* __restrict__ cs, int64_t* __restrict__ pred) {
  __shared__ Cand s_best[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t g1 = goff[blockIdx.x + 1];
  for (int64_t i = goff[blockIdx.x]; i < g1; ++i) {
    const int64_t a = lo[i], b = a + w[i];
    const int64_t qs_i = qs[i], ts_i = ts[i], sc_i = score[i];
    Cand best = no_cand();
    if (b > a) {    // the same on every thread
      for (int64_t k = a + tid; k < b; k += kThreads) {
        const int64_t j = idx_s[k];
        if (j >= i) continue;              // processed before i only
        const int64_t te = te_s[k];
        const int64_t tgap = ts_i - te;
        if (tgap < 0 || tgap > max_gap) continue;
        // the window holds 0 <= qgap <= max_gap
        const int64_t qe = qe_s[k];
        const int64_t gap = (qs_i - qe) + tgap;
        const int64_t g = gap == 0 ? 0 : gap_open + gap_extend * gap;
        if (g >= sc_i) continue;           // impl/chaining.c:195
        const Cand c{sc_i + cs_sorted[k] - g, te, qe, j};
        if (better(c, best)) best = c;
      }
      best = warp_best(best);
      if (lane == 0) s_best[warp] = best;
      __syncthreads();
      if (warp == 0) best = warp_best(lane < kWarps ? s_best[lane] : no_cand());
    }
    if (tid == 0) {
      const bool adopt = best.idx >= 0 && best.val > sc_i;
      const int64_t c = adopt ? best.val : sc_i;
      cs[i] = c;
      pred[i] = adopt ? best.idx : -1;
      cs_sorted[pos[i]] = c;
    }
    __syncthreads();   // cs_sorted written; s_best read
  }
}

}  // namespace

extern "C" int paffy_chain_dp(int device, int64_t n_groups,
                              const void* goff,
                              const void* qs, const void* ts,
                              const void* score, const void* qe_s,
                              const void* te_s, const void* idx_s,
                              const void* lo, const void* w, const void* pos,
                              int64_t gap_open, int64_t gap_extend,
                              int64_t max_gap, void* cs_sorted, void* cs,
                              void* pred, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_groups > 0) {
    auto p = [](const void* x) { return static_cast<const int64_t*>(x); };
    chain_dp_kernel<<<static_cast<unsigned>(n_groups), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        p(goff), p(qs), p(ts), p(score), p(qe_s), p(te_s), p(idx_s), p(lo),
        p(w), p(pos), gap_open, gap_extend, max_gap,
        static_cast<int64_t*>(cs_sorted), static_cast<int64_t*>(cs),
        static_cast<int64_t*>(pred));
  }
  return static_cast<int>(cudaGetLastError());
}
