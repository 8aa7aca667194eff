// RMSNorm over the last dimension of a row-major [R, D] matrix.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm (_rmsnorm_kernel):
// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale, computed in
// float32 and stored in x's dtype (float32 or bfloat16; scale may be either).
// In the dense transformer it normalises every block's two inputs and the
// final hidden state (R = batch * seq rows of D = d_model), and the q/k heads
// under qk_norm (D = head_dim).
//
// What bounds it on an H100: memory. Each element is read once, written once
// and costs four floating-point operations (a square-add, two multiplies),
// about 0.5 operations per byte against the card's ~20 fp32 operations per
// byte of memory rate. At the Qwen2-0.5B train step's [512, 896] float32 the
// whole call moves 3.7 MB, so it is short enough that launch latency and the
// number of rows in flight matter as much as bandwidth.
//
// What the design does about it: one warp per row, eight rows per block, so a
// row's sum of squares never leaves the warp. Each lane walks the row with a
// stride of 32 elements (a warp reads 32 consecutive values per step) and
// keeps its partial sum in a float32 register; the 32 partials are combined
// by a fixed xor-shuffle tree, so the result is the same from run to run and
// every lane ends with the same total. The second pass reads the row again
// (from L1/L2: a row is at most a few KB) and writes the output. The operation
// order is the reference's: x * r, then * scale, with r = 1 / sqrtf(ms + eps)
// (correctly rounded sqrt and divide; the build never uses fast math).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   TX* __restrict__ out, int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + static_cast<size_t>(row) * D;
  TX* orow = out + static_cast<size_t>(row) * D;
  float acc = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f32(xr[i]);
    acc = acc + v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
  }
  const float ms = acc / static_cast<float>(D);
  const float r = 1.0f / sqrtf(ms + eps);
  for (int i = lane; i < D; i += 32) {
    const float t = to_f32(xr[i]) * r;
    orow[i] = from_f32<TX>(t * to_f32(scale[i]));
  }
}

template <typename TX, typename TS>
void launch(const void* x, const void* scale, void* out, int rows, int D,
            float eps, cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<TX, TS><<<blocks, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(scale),
      static_cast<TX*>(out), rows, D, eps);
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16. out has x's dtype and shape.
int rmsnorm_launch(const void* x, const void* scale, void* out, int rows,
                   int D, float eps, int x_dtype, int scale_dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (x_dtype == 0 && scale_dtype == 0) {
    launch<float, float>(x, scale, out, rows, D, eps, s);
  } else if (x_dtype == 0 && scale_dtype == 1) {
    launch<float, __nv_bfloat16>(x, scale, out, rows, D, eps, s);
  } else if (x_dtype == 1 && scale_dtype == 0) {
    launch<__nv_bfloat16, float>(x, scale, out, rows, D, eps, s);
  } else if (x_dtype == 1 && scale_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
