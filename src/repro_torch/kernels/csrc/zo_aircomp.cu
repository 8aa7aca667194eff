// Fused AirComp reduction over the stacked client deltas [M, N].
//
// Replaces the TPU kernel repro/kernels/zo_aircomp.py:aircomp_reduce
// (_reduce_kernel): in one read of the matrix it gives the weighted row
// combination mean[c] = sum_m scale[m] * x[m, c] (the masked scaled mean; the
// caller folds mask and divisor into scale) and the per-row squared norms over
// the valid prefix, sq[m] = sum_{c < d} x[m, c]^2 (for Delta_max, Eq. 15).
//
// What bounds it on an H100: memory. Each element is read once and costs
// three floating-point operations (a multiply-add for the mean, a square-add
// for the norm), far below the card's ~20 fp32 operations per byte of memory
// rate; the output is N + M floats.
//
// What the design does about it: each thread owns four columns (strided by
// the block, so a warp reads 128 consecutive floats per row) and walks the M
// rows in ascending order, so the matrix is read exactly once and the mean is
// accumulated in registers in the plain version's order. The per-row norm
// partials are reduced deterministically: a fixed-order warp shuffle, the
// warp sums of each row in shared memory summed in warp order, one partial per
// (row, block) in device memory, then a fixed-order sum over blocks. No
// atomics, so a result is the same from run to run. N need not be a multiple
// of the block: the kernel masks its own ragged edge.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;
constexpr int kBlockCols = kThreads * kCols;  // 1024 columns per block

__global__ void aircomp_reduce_kernel(const float* __restrict__ x,
                                      const float* __restrict__ scale,
                                      float* __restrict__ mean,
                                      float* __restrict__ partial, int M,
                                      int N, int d, int n_blocks) {
  extern __shared__ float warp_sums[];  // [M][kWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kBlockCols + threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
  for (int m = 0; m < M; ++m) {
    const float sc = scale[m];
    const float* xm = x + static_cast<size_t>(m) * N;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = base + j * kThreads;
      if (c < N) {
        const float v = xm[c];
        acc[j] = acc[j] + sc * v;
        if (c < d) s = s + v * v;
      }
    }
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sums[m * kWarps + warp] = s;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = base + j * kThreads;
    if (c < N) mean[c] = acc[j];
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = s + warp_sums[m * kWarps + w];
    partial[static_cast<size_t>(m) * n_blocks + blockIdx.x] = s;
  }
}

__global__ void sum_row_partials_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int M,
                                        int n_parts) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* p = partial + static_cast<size_t>(m) * n_parts;
  float s = 0.0f;
  for (int c = 0; c < n_parts; ++c) s = s + p[c];
  out[m] = s;
}

}  // namespace

extern "C" {

int aircomp_block_cols() { return kBlockCols; }

int aircomp_max_rows() { return (48 * 1024) / (kWarps * sizeof(float)); }

// partial: scratch of M * ceil(N / 1024) floats.
int aircomp_reduce_launch(const float* x, const float* scale, float* mean,
                          float* partial, float* sq, int M, int N, int d,
                          void* stream) {
  const int n_blocks = (N + kBlockCols - 1) / kBlockCols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(M) * kWarps * sizeof(float);
  aircomp_reduce_kernel<<<n_blocks, kThreads, smem, s>>>(x, scale, mean,
                                                        partial, M, N, d,
                                                        n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_row_partials_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, sq, M, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
