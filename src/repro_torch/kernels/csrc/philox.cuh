// Philox-4x32-10 in XLA's RngBitGenerator layout, shared by the kernels.
//
// The 4-word key w gives the Philox key (w0, w1) and the 128-bit counter
// C + i of block i, with C = w2 | w3<<32 | w0<<64 | w1<<96 (the carry out of
// the low 64 bits runs into the high words). Block i yields output words
// 4i..4i+3. This is the device twin of philox_block_words in
// kernels/philox.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox_block(uint32_t w0, uint32_t w1,
                                              uint32_t w2, uint32_t w3,
                                              unsigned long long i) {
  const unsigned long long lo =
      ((static_cast<unsigned long long>(w3) << 32) | w2) + i;
  const unsigned long long hi =
      ((static_cast<unsigned long long>(w1) << 32) | w0) + (lo < i ? 1ull : 0ull);
  uint32_t c0 = static_cast<uint32_t>(lo), c1 = static_cast<uint32_t>(lo >> 32);
  uint32_t c2 = static_cast<uint32_t>(hi), c3 = static_cast<uint32_t>(hi >> 32);
  uint32_t k0 = w0, k1 = w1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

}  // namespace rt
