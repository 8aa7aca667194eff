// philox_bits: words [4*b0, 4*b0 + n) of XLA's RngBitGenerator stream
// (Philox-4x32-10) for one 4-word key, the bits of every rbg and unsafe_rbg
// draw. One thread per 4-word block; a full block is one 16-byte store, the
// last, ragged block stores its valid words one by one. A grid-stride loop
// covers streams longer than the grid.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 CUDA blocks per H100 SM

__global__ void __launch_bounds__(kThreads)
    philox_bits_kernel(uint32_t* __restrict__ out, uint32_t w0, uint32_t w1,
                       uint32_t w2, uint32_t w3, unsigned long long b0,
                       unsigned long long n) {
  const unsigned long long blocks = (n + 3) / 4;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < blocks; i += stride) {
    const uint4 r = rt::philox_block(w0, w1, w2, w3, b0 + i);
    const unsigned long long w = 4 * i;
    if (w + 4 <= n) {
      reinterpret_cast<uint4*>(out)[i] = r;
    } else {
      out[w] = r.x;
      if (w + 1 < n) out[w + 1] = r.y;
      if (w + 2 < n) out[w + 2] = r.z;
    }
  }
}

}  // namespace

extern "C" {

// out: n uint32 words, 16-byte aligned; w0..w3: the key; b0: the first
// Philox block (the stream's word 4*b0 lands in out[0]).
int philox_bits_launch(unsigned* out, unsigned w0, unsigned w1, unsigned w2,
                       unsigned w3, unsigned long long b0,
                       unsigned long long n, void* stream) {
  if (n == 0) return 0;
  const unsigned long long blocks = (n + 3) / 4;
  unsigned long long grid = (blocks + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  philox_bits_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<uint32_t*>(out), w0, w1, w2, w3, b0, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
