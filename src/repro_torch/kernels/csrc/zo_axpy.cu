// ZO parameter-streaming kernels on the flat [M, N] client buffer.
//
// Replace the TPU kernels of repro/kernels/zo_axpy.py:
//   zo_walk_kernel      <- zo_walk     (_walk_kernel)
//   zo_replay_kernel    <- zo_replay   (_replay_kernel)
//   dirnorm_kernel      <- zo_dirnorms (_dirnorm_kernel)
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
// the block).
//
// The norms (dirnorm_kernel) are one launch over (chunk, n, row) blocks: a
// thread makes 4-64 evaluations (the wrapper picks the count so the grid
// has at least 1024 blocks where d allows), kNormUnroll independent ones at
// a time so the integer pipes have instruction-level parallelism, and masks
// only in the chunk that crosses d; a block sums its squares with warp
// shuffles and one shared-memory step. The last block of each output to
// finish sums that output's partials with a parallel fixed-order tree. An
// atomic ticket tells a block whether it is the last; it never carries a
// value of the sum, so the result is the same from run to run, and
// kernels/zo_axpy.py:dirnorm_order_sum is its summation order in torch.
// (A second launch in which one thread summed all partials of an output
// took 2.3 ms of 23.3 at the Qwen2-0.5B step's width on an H100.)
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormUnroll = 4;  // independent evaluations in flight a thread

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

// A block's fixed-order sum of one float a thread: the xor-shuffle tree in
// each warp (offsets 16, ..., 1), then the 8 warp sums by the same tree
// (offsets 4, 2, 1) in warp 0. The total is valid in thread 0. ws: 8 floats
// of shared memory, free when the call starts.
__device__ __forceinline__ float block_sum(float s, float* ws) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) ws[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x < 32) {
    t = lane < kNormWarps ? ws[lane] : 0.0f;
#pragma unroll
    for (int o = kNormWarps / 2; o > 0; o >>= 1) {
      t = t + __shfl_xor_sync(0xffffffffu, t, o);
    }
  }
  return t;
}

// The finish of one output: thread t sums the partials t, t + 256, ... in
// ascending order (eight loads in flight before their adds), then
// block_sum. The partials are read from L2 (ld.global.cg), never from a
// stale L1 line: other blocks wrote them, each fencing its store before it
// took its ticket (the CUDA Programming Guide's memory-fence pattern).
__device__ __forceinline__ float finish_sum(const float* __restrict__ p,
                                            int n_parts, float* ws) {
  constexpr int kAhead = 8;
  float f = 0.0f;
  int c = threadIdx.x;
  for (; c + (kAhead - 1) * kNormThreads < n_parts;
       c += kAhead * kNormThreads) {
    float a[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) a[u] = __ldcg(p + c + u * kNormThreads);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) f = f + a[u];
  }
  for (; c < n_parts; c += kNormThreads) f = f + __ldcg(p + c);
  return block_sum(f, ws);
}

// Grid (chunks, b2, M), one launch. The block of chunk c sums g^2 over the
// elements [c * span, (c + 1) * span) of [0, d), span = 256 * per: thread t
// takes the elements c * span + j * 256 + t for j = 0, ..., per - 1, in
// that order, kNormUnroll independent evaluations at a time; only the chunk
// that crosses d masks. The block's total goes to partial[row, n, c]; the
// last block of (row, n) to finish, known from an atomic ticket that counts
// finished blocks and is used for nothing else, sums that output's partials
// with finish_sum and resets the ticket to 0 for the next call. With one
// chunk the block writes its total directly.
template <int KIND>
__global__ void __launch_bounds__(kNormThreads)
    dirnorm_kernel(const long long* __restrict__ keys,
                   float* __restrict__ partial,
                   unsigned* __restrict__ tickets, float* __restrict__ out,
                   int d, int per, int n_chunks) {
  __shared__ float ws[kNormWarps];
  __shared__ bool last;
  const int chunk = blockIdx.x;
  const uint32_t n = blockIdx.y;
  const int slot = blockIdx.z * gridDim.y + blockIdx.y;  // row * b2 + n
  uint32_t k0, k1;
  rt::row_key(keys, blockIdx.z, k0, k1);
  const uint32_t span = static_cast<uint32_t>(per) * kNormThreads;
  const uint32_t base = static_cast<uint32_t>(chunk) * span;
  uint32_t i = base + threadIdx.x;
  float s = 0.0f;
  if (base + span <= static_cast<uint32_t>(d)) {
    for (int j = 0; j < per; j += kNormUnroll) {
      float g[kNormUnroll];
#pragma unroll
      for (int u = 0; u < kNormUnroll; ++u) {
        g[u] = rt::counter_gen<KIND>(k0, k1, n, i + u * kNormThreads);
      }
#pragma unroll
      for (int u = 0; u < kNormUnroll; ++u) s = s + g[u] * g[u];
      i += kNormUnroll * kNormThreads;
    }
  } else {
    for (int j = 0; j < per; ++j, i += kNormThreads) {
      if (i < static_cast<uint32_t>(d)) {
        const float g = rt::counter_gen<KIND>(k0, k1, n, i);
        s = s + g * g;
      }
    }
  }
  const float total = block_sum(s, ws);
  if (n_chunks == 1) {
    if (threadIdx.x == 0) out[slot] = total;
    return;
  }
  if (threadIdx.x == 0) {
    partial[static_cast<size_t>(slot) * n_chunks + chunk] = total;
    __threadfence();  // the partial is visible before the ticket counts it
    const unsigned done = atomicAdd(tickets + slot, 1u);
    last = done == static_cast<unsigned>(n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  const float f = finish_sum(partial + static_cast<size_t>(slot) * n_chunks,
                             n_chunks, ws);
  if (threadIdx.x == 0) {
    out[slot] = f;
    tickets[slot] = 0u;
  }
}

// The finish alone, one block per output, on partials already written: the
// same finish_sum, launched on its own only to time it.
__global__ void __launch_bounds__(kNormThreads)
    dirnorm_finish_kernel(const float* __restrict__ partial,
                          float* __restrict__ out, int n_chunks) {
  __shared__ float ws[kNormWarps];
  const float f = finish_sum(
      partial + static_cast<size_t>(blockIdx.x) * n_chunks, n_chunks, ws);
  if (threadIdx.x == 0) out[blockIdx.x] = f;
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace

extern "C" {

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

// Squared norms out[M, b2] in one launch. per: evaluations a thread (a
// multiple of kNormUnroll); partial: scratch of M*b2*n_chunks floats with
// n_chunks = ceil(d / (256 * per)) (unused when n_chunks is 1); tickets:
// M*b2 counters that are 0 when the call starts and are 0 again when it
// ends (the caller zeroes them once, when it allocates them).
int zo_dirnorms_launch(const long long* keys, float* partial,
                       unsigned* tickets, float* out, int d, int b2, int M,
                       int per, int kind, void* stream) {
  if (d < 1 || per < kNormUnroll || per % kNormUnroll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long span = static_cast<long long>(per) * kNormThreads;
  const int n_chunks = ceil_div(d, span);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, b2, M);
  if (kind == rt::kSign) {
    dirnorm_kernel<rt::kSign><<<grid, kNormThreads, 0, s>>>(
        keys, partial, tickets, out, d, per, n_chunks);
  } else {
    dirnorm_kernel<rt::kNormal><<<grid, kNormThreads, 0, s>>>(
        keys, partial, tickets, out, d, per, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// The finish on its own over partial[count, n_chunks] (for timing).
int zo_dirnorms_finish_launch(const float* partial, float* out, int count,
                              int n_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dirnorm_finish_kernel<<<count, kNormThreads, 0, s>>>(partial, out,
                                                       n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
