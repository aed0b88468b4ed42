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
// Inputs: groups laid end to end, no padding (ops/chain.dp_arguments; one
// launch takes both strand sets' groups).  goff[g]..goff[g+1] are group g's
// slots; in processing order qs, ts, score, lo, w, pos (the record's own
// slot in the query-end order); in query-end order qe_s, te_s, idx_s (the
// record's processing slot), so a window is one contiguous, coalesced
// slice.  cs_sorted is scratch: the chain scores in query-end order, as
// _dp_scan's carry, written through pos.
//
// Design: one block per group; the DP is serial within a group, so what
// the design shortens is the time per record on that path.  The candidates
// of record i split by processing index into the recent ones, j in
// [i - K, i), and the old ones, j < i - K, whose chain scores were final K
// records before i.
//
//  * One walker warp finalises the records in order.  It checks the K
//    recent candidates itself, one per lane (j is in i's window iff lo[i]
//    <= pos[j] < lo[i] + w[i]), from a ring in shared memory that holds
//    each record's fields and chain score, merges the best of them with the
//    helpers' best old candidate for i in one warp reduction (the largest
//    val by two 32-bit warp reductions, then its lane's j; the four-key
//    reduction of (val, te, qe, j) only on a tie), writes cs, pred and
//    cs_sorted, and advances a progress counter.  Its path has no
//    __syncthreads and reads no device memory.
//  * The other warps are helpers.  Helper h takes records h, h + H, ...:
//    it loads the record's fields, waits until the walker has finalised
//    every record before i - K (the progress counter, volatile, with
//    block-scope fences on both sides), reduces the old candidates of i's
//    window against cs_sorted (four window strides of loads in flight, a
//    lane's best kept as (val, slot), an equal val compared on (te, qe, j)
//    read back), and publishes the record's fields (ts - max_gap, qs + ts,
//    qe + te precomputed for the walker), its best and a tag in i's ring
//    slot.  Helpers run up to K records ahead of the walker.
//
// The ring has R slots, a power of two above 2K: the walker reads the slots
// of records i - K .. i while helpers fill those up to i + K.  The split is
// exact -- every candidate is either recent or old -- and the four-key
// compare is the nested maxima of _dp_scan, so results, ties included,
// equal the sequential DP's.  K = 32 and 512 threads (15 helpers) were
// the fastest of the sizes chip_smoke.py sweeps on the card (PERF.md).
//
// Bound: operations, ~30 32-bit integer instructions per candidate of the
// windows, over the card's integer rate; the bytes (72 read and 16 written
// per record) are far below.  The serial depth is the largest group's
// record count: with one group per strand set one launch keeps two SMs of
// 132 busy.  On that one SM the helpers' instructions bound a group's
// time, as does the walker's latency per record, and the two share the
// SM's warp schedulers; helpers in other blocks, through device memory,
// are the next step.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;           // window strides a helper loads at once

// The ring's fields, each an int64 array of R slots in dynamic shared
// memory: a record's own fields, from its helper (its window [lo, hi), ts
// - max_gap and ts, qs + ts, its score, its query-end slot, qe and te and
// qe + te), its helper's best old candidate (val, te, qe, j), its chain
// score, from the walker, and the tag: the record a slot holds once its
// helper has published it.
enum Field {
  kLo, kHi, kTlo, kTs, kSum, kSc, kPos, kQe, kTe, kEnd, kBval, kBte, kBqe,
  kBj, kCs, kTag, kFields
};

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

__device__ __forceinline__ int64_t shfl(int64_t v, int src) {
  return static_cast<int64_t>(
      __shfl_sync(kFull, static_cast<long long>(v), src));
}

__device__ __forceinline__ Cand warp_best_all(Cand c) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    const Cand o{shfl_xor(c.val, m), shfl_xor(c.te, m), shfl_xor(c.qe, m),
                 shfl_xor(c.idx, m)};
    if (better(o, c)) c = o;
  }
  return c;
}

// The largest int64 of the warp: the high words' maximum, then the low
// words' among the lanes that hold it, one warp reduction each.
__device__ __forceinline__ int64_t warp_max(int64_t v) {
  const int hi = static_cast<int>(v >> 32);
  const int top = __reduce_max_sync(kFull, hi);
  const unsigned lo = __reduce_max_sync(
      kFull, hi == top ? static_cast<unsigned>(v) : 0u);
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(top)) << 32) | lo);
}

// The warp's best candidate's (val, idx).  Ties in val between lanes are
// rare, so the common path reduces val alone and takes idx from the one
// lane that holds it; on a tie, the full four-key reduction.
__device__ __forceinline__ Cand warp_best(Cand c) {
  const int64_t v = warp_max(c.val);
  const unsigned tied = __ballot_sync(kFull, c.val == v);
  if (tied & (tied - 1)) return warp_best_all(c);
  return {v, 0, 0, shfl(c.idx, __ffs(tied) - 1)};
}

// A lane's best old candidate is kept as (val, its slot k): a larger val
// takes the slot; an equal one is compared on (te, qe, j), read back for
// the slot held -- rare, as equal values are.
__device__ __forceinline__ bool tie_wins(int64_t te, int64_t qe, int64_t j,
                                         int64_t k,
                                         const int64_t* __restrict__ te_s,
                                         const int64_t* __restrict__ qe_s,
                                         const int64_t* __restrict__ idx_s) {
  const int64_t bte = te_s[k], bqe = qe_s[k];
  if (te != bte) return te > bte;
  if (qe != bqe) return qe > bqe;
  return j > idx_s[k];
}

// Candidate j of record i: valid iff its target end lies in [ts_i -
// max_gap, ts_i] and its gap cost g < score_i (impl/chaining.c:195), g = 0
// for a zero total gap (qs_i + ts_i == qe_j + te_j) and gap_open +
// gap_extend * gap otherwise (the window holds 0 <= qgap <= max_gap).
__device__ __forceinline__ int64_t cand_val(int64_t te, int64_t end,
                                            int64_t cs_j, int64_t tlo,
                                            int64_t ts, int64_t sum,
                                            int64_t sc, int64_t gap_open,
                                            int64_t gap_extend) {
  const int64_t gap = sum - end;
  const int64_t g = gap == 0 ? 0 : gap_open + gap_extend * gap;
  const bool ok = te >= tlo && te <= ts && g < sc;
  return ok ? sc + cs_j - g : INT64_MIN;
}

__global__ void __launch_bounds__(kMaxThreads)
chain_dp_kernel(const int64_t* __restrict__ goff,
                const int64_t* __restrict__ qs, const int64_t* __restrict__ ts,
                const int64_t* __restrict__ score,
                const int64_t* __restrict__ qe_s,
                const int64_t* __restrict__ te_s,
                const int64_t* __restrict__ idx_s,
                const int64_t* __restrict__ lo, const int64_t* __restrict__ w,
                const int64_t* __restrict__ pos, int64_t gap_open,
                int64_t gap_extend, int64_t max_gap, int k_recent, int ring,
                int64_t* cs_sorted, int64_t* __restrict__ cs,
                int64_t* __restrict__ pred) {
  extern __shared__ int64_t smem[];
  __shared__ int64_t s_done;         // records the walker has finalised
  // field f of slot s, indexed straight off the shared array
  auto at = [&](int f, int64_t s) -> int64_t& { return smem[f * ring + s]; };
  volatile int64_t* tag = smem + kTag * ring;
  volatile int64_t* done = &s_done;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t g0 = goff[blockIdx.x], n = goff[blockIdx.x + 1] - g0;
  const int64_t mask = ring - 1;
  for (int s = tid; s < ring; s += blockDim.x) tag[s] = -1;
  if (tid == 0) *done = 0;
  __syncthreads();                   // the only barrier

  if (warp == 0) {                   // the walker
    for (int64_t li = 0; li < n; ++li) {
      const int64_t s = li & mask, i = g0 + li;
      while (tag[s] != li) {
      }
      __threadfence_block();         // the slot's fields after its tag
      const int64_t lo_i = at(kLo, s), hi_i = at(kHi, s);
      const int64_t tlo = at(kTlo, s), ts_i = at(kTs, s);
      const int64_t sum = at(kSum, s), sc_i = at(kSc, s);
      const int64_t pos_i = at(kPos, s);
      Cand best = lane == 0 ? Cand{at(kBval, s), at(kBte, s), at(kBqe, s),
                                   at(kBj, s)}
                            : no_cand();
      for (int m = lane; m < k_recent && m < li; m += 32) {
        const int64_t sj = (li - 1 - m) & mask;
        const int64_t pj = at(kPos, sj), te = at(kTe, sj);
        const int64_t val = cand_val(te, at(kEnd, sj), at(kCs, sj), tlo,
                                     ts_i, sum, sc_i, gap_open, gap_extend);
        const Cand c{pj >= lo_i && pj < hi_i ? val : INT64_MIN, te,
                     at(kQe, sj), i - 1 - m};
        if (better(c, best)) best = c;
      }
      best = warp_best(best);
      const bool adopt = best.idx >= 0 && best.val > sc_i;
      const int64_t c = adopt ? best.val : sc_i;
      if (lane == 0) {
        cs_sorted[pos_i] = c;
        at(kCs, s) = c;
        __threadfence_block();       // cs_sorted and the ring before done
        *done = li + 1;
        cs[i] = c;
        pred[i] = adopt ? best.idx : -1;
      }
      __syncwarp();                  // the ring's cs for the next records
    }
    return;
  }

  // a helper
  const int helpers = (blockDim.x >> 5) - 1;
  for (int64_t li = warp - 1; li < n; li += helpers) {
    const int64_t s = li & mask, i = g0 + li;
    const int64_t a = lo[i], b = a + w[i];
    const int64_t ts_i = ts[i], sc_i = score[i], p = pos[i];
    const int64_t tlo = ts_i - max_gap, sum = qs[i] + ts_i;
    const int64_t qe_i = qe_s[p], te_i = te_s[p];
    // records before i - K final: their cs_sorted is written
    if (li > k_recent) {
      while (*done < li - k_recent) __nanosleep(32);
      __threadfence_block();
    }
    const int64_t old_end = i - k_recent;   // old candidates: j < old_end
    int64_t bval = INT64_MIN, bk = -1;      // this lane's best: val, slot
    for (int64_t k0 = a + lane; k0 < b; k0 += 32 * kUnroll) {
      // every load of kUnroll strides in flight at once; a slot's chain
      // score is read even where its record is not old (and the value may
      // not be final): it is then never used
      int64_t j[kUnroll], te[kUnroll], qe[kUnroll], cv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = k0 + 32 * u;
        j[u] = old_end;
        if (k < b) {
          j[u] = idx_s[k];
          te[u] = te_s[k];
          qe[u] = qe_s[k];
          cv[u] = cs_sorted[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j[u] >= old_end) continue;
        const int64_t val = cand_val(te[u], qe[u] + te[u], cv[u], tlo, ts_i,
                                     sum, sc_i, gap_open, gap_extend);
        if (val > bval ||
            (val == bval && val != INT64_MIN &&
             tie_wins(te[u], qe[u], j[u], bk, te_s, qe_s, idx_s))) {
          bval = val;
          bk = k0 + 32 * u;
        }
      }
    }
    // the warp's best: on a tie in val, every tied lane's full key
    const int64_t v = warp_max(bval);
    const unsigned tied = __ballot_sync(kFull, bval == v && bk >= 0);
    Cand best = no_cand();
    if (tied & (tied - 1)) {
      if (bval == v && bk >= 0) best = {v, te_s[bk], qe_s[bk], idx_s[bk]};
      best = warp_best_all(best);
    } else if (tied) {
      const int64_t k = shfl(bk, __ffs(tied) - 1);
      best = {v, te_s[k], qe_s[k], idx_s[k]};
    }
    if (lane == 0) {
      at(kLo, s) = a;
      at(kHi, s) = b;
      at(kTlo, s) = tlo;
      at(kTs, s) = ts_i;
      at(kSum, s) = sum;
      at(kSc, s) = sc_i;
      at(kPos, s) = p;
      at(kQe, s) = qe_i;
      at(kTe, s) = te_i;
      at(kEnd, s) = qe_i + te_i;
      at(kBval, s) = best.val;
      at(kBte, s) = best.te;
      at(kBqe, s) = best.qe;
      at(kBj, s) = best.idx;
      __threadfence_block();         // the fields before the tag
      tag[s] = li;
    }
    __syncwarp();
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
                              int64_t max_gap, int64_t k_recent, int64_t ring,
                              int64_t threads, void* cs_sorted, void* cs,
                              void* pred, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n_groups > 0) {
    // the attribute is per device: this sets it on the launch's device
    const int dyn = static_cast<int>(kFields * 8 * ring);
    const cudaError_t err = cudaFuncSetAttribute(
        chain_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto p = [](const void* x) { return static_cast<const int64_t*>(x); };
    chain_dp_kernel<<<static_cast<unsigned>(n_groups),
                      static_cast<unsigned>(threads), dyn,
                      static_cast<cudaStream_t>(stream)>>>(
        p(goff), p(qs), p(ts), p(score), p(qe_s), p(te_s), p(idx_s), p(lo),
        p(w), p(pos), gap_open, gap_extend, max_gap,
        static_cast<int>(k_recent), static_cast<int>(ring),
        static_cast<int64_t*>(cs_sorted), static_cast<int64_t*>(cs),
        static_cast<int64_t*>(pred));
  }
  return static_cast<int>(cudaGetLastError());
}
