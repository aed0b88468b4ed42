// K2: the extended sequence pool, ext = upper(pool) ++ comp(upper(flip(pool))).
//
// Replaces paffy_tpu/ops/mismatch_device.py::build_ext_pool (an XLA-jitted
// dense pass; complement pairs at mismatch_device.py:29).  For i < L:
//   ext[i]        = upper(pool[i])
//   ext[2L-1-i]   = comp(upper(pool[i]))       (== ext[L + (L-1-i)])
// so a reverse-complement walk down the query from pool position s is an
// ascending plain read of ext from 2L-1-s, and the compare kernel (K1,
// piece_compare.cu) reduces to a byte equality for every alphabet.
//
// Complement pairs over uppercased bytes: A/T, C/G, M/K, R/Y, V/B, H/D;
// every other byte maps to itself.
//
// Bound: memory.  One pass reads L bytes and writes 2L.  Each thread maps
// one byte per step of a grid-stride loop through a 256-entry table in
// shared memory (filled once per block); a warp's loads and both of its
// stores each touch one contiguous 32-byte run.  Wider (4- or 16-byte)
// accesses are left for a later change: the mirrored store then needs
// a byte reversal inside the word.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__device__ __forceinline__ uint8_t upper_byte(uint8_t c) {
  return (c >= 'a' && c <= 'z') ? static_cast<uint8_t>(c - 32) : c;
}

__device__ uint8_t comp_of_upper(uint8_t u) {
  switch (u) {
    case 'A': return 'T';
    case 'T': return 'A';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'M': return 'K';
    case 'K': return 'M';
    case 'R': return 'Y';
    case 'Y': return 'R';
    case 'V': return 'B';
    case 'B': return 'V';
    case 'H': return 'D';
    case 'D': return 'H';
    default: return u;
  }
}

__global__ void __launch_bounds__(kThreads)
build_ext_kernel(const uint8_t* __restrict__ pool, int64_t L,
                 uint8_t* __restrict__ ext) {
  __shared__ uint8_t comp_upper[256];
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    comp_upper[c] = comp_of_upper(upper_byte(static_cast<uint8_t>(c)));
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < L; i += stride) {
    const uint8_t c = pool[i];
    ext[i] = upper_byte(c);
    ext[2 * L - 1 - i] = comp_upper[c];
  }
}

}  // namespace

extern "C" int paffy_build_ext(int device, const void* pool, int64_t L,
                               void* ext, void* stream) {
  const paffy::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (L > 0) {
    int64_t blocks = (L + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    build_ext_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pool), L, static_cast<uint8_t*>(ext));
  }
  return static_cast<int>(cudaGetLastError());
}
