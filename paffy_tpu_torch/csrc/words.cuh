// Byte-compare helpers over 16-byte words of the extended pool, shared by
// K1 (piece_compare.cu) and K4 (encode_runs.cu).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace paffy {

constexpr unsigned kFull = 0xffffffffu;

// The top bit of each zero byte of x: (x & 0x7F) + 0x7F sets a byte's top
// bit unless its low seven bits are 0, and never carries into the next byte.
__device__ __forceinline__ uint32_t zero_byte_flags(uint32_t x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
}

// Bytes [sh, sh+16) of the 32 bytes lo ++ hi (little-endian words).  The
// word shift is done with selects, so no register array is indexed at run
// time.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int sh) {
  uint32_t v0 = lo.x, v1 = lo.y, v2 = lo.z, v3 = lo.w;
  uint32_t v4 = hi.x, v5 = hi.y;
  const uint32_t v6 = hi.z, v7 = hi.w;
  if (sh & 8) { v0 = v2; v1 = v3; v2 = v4; v3 = v5; v4 = v6; v5 = v7; }
  if (sh & 4) { v0 = v1; v1 = v2; v2 = v3; v3 = v4; v4 = v5; }
  const unsigned bits = 8u * static_cast<unsigned>(sh & 3);
  return make_uint4(__funnelshift_r(v0, v1, bits), __funnelshift_r(v1, v2, bits),
                    __funnelshift_r(v2, v3, bits), __funnelshift_r(v3, v4, bits));
}

}  // namespace paffy
