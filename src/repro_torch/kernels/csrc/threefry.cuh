// Counter-convention direction generator shared by the ZO kernels.
//
// A direction element is v_n[i] = gen(kind, threefry2x32(key, (n, i))): the
// same (key, n, flat index) gives the same float on every end of the ZO
// round, so directions are regenerated where they are used and never stored.
// This is the device twin of counter_gen in kernels/zo_axpy.py, which is
// itself the twin of repro/kernels/zo_axpy.py:counter_gen.
//
// Numerics: build without --use_fast_math (it would swap in __logf/__cosf and
// break Box-Muller parity) and with --fmad=false (so x + a*g stays a multiply
// and an add, in the plain version's order). sqrtf, logf and cosf are the
// accurate library functions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

enum Kind : int { kNormal = 0, kSign = 1 };

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (five groups of four, key injection after each).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#define RT_MIX(r)        \
  x0 += x1;              \
  x1 = rotl32(x1, r);    \
  x1 ^= x0;
#define RT_GROUP_A RT_MIX(13) RT_MIX(15) RT_MIX(26) RT_MIX(6)
#define RT_GROUP_B RT_MIX(17) RT_MIX(29) RT_MIX(16) RT_MIX(24)
  RT_GROUP_A x0 += k1; x1 += k2 + 1u;
  RT_GROUP_B x0 += k2; x1 += k0 + 2u;
  RT_GROUP_A x0 += k0; x1 += k1 + 3u;
  RT_GROUP_B x0 += k1; x1 += k2 + 4u;
  RT_GROUP_A x0 += k2; x1 += k0 + 5u;
#undef RT_GROUP_B
#undef RT_GROUP_A
#undef RT_MIX
  o0 = x0;
  o1 = x1;
}

template <int KIND>
__device__ __forceinline__ float counter_gen(uint32_t k0, uint32_t k1,
                                             uint32_t n, uint32_t idx) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, n, idx, b0, b1);
  if (KIND == kSign) {
    return (b0 & 1u) ? 1.0f : -1.0f;
  }
  // Box-Muller: u1 in (0, 1), u2 in [0, 1); 2^-24, 2^-25, float32(2*pi)
  const float u1 = __uint2float_rn(b0 >> 8) * 5.9604644775390625e-08f +
                   2.98023223876953125e-08f;
  const float u2 = __uint2float_rn(b1 >> 8) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.28318548202514648438f * u2);
}

// The key words of row `row` from the [M, 2] int64 key tensor.
__device__ __forceinline__ void row_key(const long long* keys, int row,
                                        uint32_t& k0, uint32_t& k1) {
  k0 = static_cast<uint32_t>(keys[2 * row]);
  k1 = static_cast<uint32_t>(keys[2 * row + 1]);
}

}  // namespace rt
