// ZO parameter-streaming kernels on the flat [M, N] client buffer.
//
// Replace the TPU kernels of repro/kernels/zo_axpy.py:
//   zo_walk_kernel      <- zo_walk     (_walk_kernel)
//   zo_replay_kernel    <- zo_replay   (_replay_kernel)
//   dirnorm_*_kernel    <- zo_dirnorms (_dirnorm_kernel)
//
// What bounds them on an H100: every element costs two (walk) or b2 (replay)
// 20-round Threefry-2x32 evaluations, about 75 32-bit integer operations
// each, plus Box-Muller's logf/cosf/sqrtf for the normal kind, against 8 bytes
// of device-memory traffic (one float read, one written): about 19 (walk) and
// 190 (replay, b2 = 20) integer operations per byte, where the card balances
// at about 5 (16.7 T int32 op/s against 3.35 TB/s). So the integer pipes
// bind, not memory. The dirnorms kernel moves no direction through memory.
//
// What the design does about it: one thread per element keeps every Threefry
// in registers and makes no redundant generation; the direction is never
// written; the replay keeps its b2-term sum in one fp32 register so x is read
// and written once for the whole update. Rows (clients) are the grid's y
// dimension, so one launch covers the cohort. The kernels index the flat
// buffer directly and mask their own ragged edge (N need not be a multiple of
// the block). The norms reduce deterministically in two stages (fixed-order
// tree in the block, then a fixed-order sum over chunks), never with atomics,
// so a result is the same from run to run.
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNormThreads = 256;
constexpr int kNormPerThread = 16;
constexpr int kNormChunk = kNormThreads * kNormPerThread;  // 4096 elements

template <int KIND>
__global__ void zo_walk_kernel(const float* __restrict__ x,
                               float* __restrict__ out,
                               const long long* __restrict__ keys,
                               const float* __restrict__ ab, uint32_t n0,
                               uint32_t n1, int N) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t k0, k1;
  rt::row_key(keys, row, k0, k1);
  const float a = ab[2 * row];
  const float b = ab[2 * row + 1];
  const float gp = rt::counter_gen<KIND>(k0, k1, n0, static_cast<uint32_t>(i));
  const float gn = rt::counter_gen<KIND>(k0, k1, n1, static_cast<uint32_t>(i));
  const size_t off = static_cast<size_t>(row) * N + i;
  const float t = x[off] + a * gp;
  out[off] = t + b * gn;
}

template <int KIND>
__global__ void zo_replay_kernel(const float* __restrict__ x,
                                 float* __restrict__ out,
                                 const long long* __restrict__ keys,
                                 const float* __restrict__ coeffs, int b2,
                                 int N) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t k0, k1;
  rt::row_key(keys, row, k0, k1);
  const float* c = coeffs + static_cast<size_t>(row) * b2;
  float acc = 0.0f;
  for (int n = 0; n < b2; ++n) {
    const float g = rt::counter_gen<KIND>(k0, k1, static_cast<uint32_t>(n),
                                          static_cast<uint32_t>(i));
    acc = acc + c[n] * g;
  }
  const size_t off = static_cast<size_t>(row) * N + i;
  out[off] = x[off] + acc;
}

// Stage 1: grid (chunks, b2, M). Each block sums g^2 over one 4096-element
// chunk of the valid prefix [0, d) with a fixed-order shared-memory tree.
template <int KIND>
__global__ void dirnorm_partial_kernel(const long long* __restrict__ keys,
                                       float* __restrict__ partial, int d,
                                       int n_chunks) {
  __shared__ float sm[kNormThreads];
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;
  const int row = blockIdx.z;
  const int b2 = gridDim.y;
  uint32_t k0, k1;
  rt::row_key(keys, row, k0, k1);
  float s = 0.0f;
  for (int j = 0; j < kNormPerThread; ++j) {
    const int i = chunk * kNormChunk + j * kNormThreads + threadIdx.x;
    if (i < d) {
      const float g = rt::counter_gen<KIND>(k0, k1, static_cast<uint32_t>(n),
                                            static_cast<uint32_t>(i));
      s = s + g * g;
    }
  }
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int w = kNormThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sm[threadIdx.x] = sm[threadIdx.x] + sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[(static_cast<size_t>(row) * b2 + n) * n_chunks + chunk] = sm[0];
  }
}

// Stage 2: one thread per output sums its partials in ascending order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int count,
                                    int n_parts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const float* p = partial + static_cast<size_t>(t) * n_parts;
  float s = 0.0f;
  for (int c = 0; c < n_parts; ++c) s = s + p[c];
  out[t] = s;
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace

extern "C" {

int zo_norm_chunk() { return kNormChunk; }

int zo_walk_launch(const float* x, float* out, const long long* keys,
                   const float* ab, unsigned n0, unsigned n1, int M, int N,
                   int kind, void* stream) {
  const dim3 grid(ceil_div(N, kThreads), M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == rt::kSign) {
    zo_walk_kernel<rt::kSign><<<grid, kThreads, 0, s>>>(x, out, keys, ab, n0,
                                                        n1, N);
  } else {
    zo_walk_kernel<rt::kNormal><<<grid, kThreads, 0, s>>>(x, out, keys, ab,
                                                          n0, n1, N);
  }
  return static_cast<int>(cudaGetLastError());
}

int zo_replay_launch(const float* x, float* out, const long long* keys,
                     const float* coeffs, int b2, int M, int N, int kind,
                     void* stream) {
  const dim3 grid(ceil_div(N, kThreads), M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == rt::kSign) {
    zo_replay_kernel<rt::kSign><<<grid, kThreads, 0, s>>>(x, out, keys,
                                                          coeffs, b2, N);
  } else {
    zo_replay_kernel<rt::kNormal><<<grid, kThreads, 0, s>>>(x, out, keys,
                                                            coeffs, b2, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial: scratch of M*b2*n_chunks floats with n_chunks = ceil(d / 4096).
int zo_dirnorms_launch(const long long* keys, float* partial, float* out,
                       int d, int b2, int M, int kind, void* stream) {
  const int n_chunks = ceil_div(d, kNormChunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, b2, M);
  if (kind == rt::kSign) {
    dirnorm_partial_kernel<rt::kSign><<<grid, kNormThreads, 0, s>>>(
        keys, partial, d, n_chunks);
  } else {
    dirnorm_partial_kernel<rt::kNormal><<<grid, kNormThreads, 0, s>>>(
        keys, partial, d, n_chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = M * b2;
  sum_partials_kernel<<<ceil_div(count, kThreads), kThreads, 0, s>>>(
      partial, out, count, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
