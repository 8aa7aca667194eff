// Blocked online-softmax (flash) attention, forward, with GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): out = softmax(scale * q k^T + mask) v for each (batch,
// query head), the kv head being h / (Hq / Hkv), with causal and sliding-window
// masks by position (q and k positions both start at 0). Layout is the
// reference wrapper's [B, S, H, D] (repro/kernels/ops.py:attention), read in
// place: no transpose and no padding to a block multiple.
//
// What bounds it on an H100: at the Qwen2-0.5B train step (B 4, S 128, Hq 14,
// Hkv 2, D 64, causal) a call needs 0.12 GFLOP of float32 multiply-adds and
// moves 4.2 MB, about 28 operations per byte: near the card's float32 balance
// point (67 TFLOP/s over 3.35 TB/s, ~20), so both bounds are about 1-2 us and
// neither is what limits this simple kernel. It is limited by latency: 112
// blocks of two warps cannot fill 132 SMs, and each thread walks its dot
// products in sequence. Tensor cores (mma.sync or wgmma) and more rows in
// flight are the work of a later version.
//
// What the design does about it, and how it stays right:
// - One block per (64-row q tile, query head, batch); one thread per q row.
//   The row of q (pre-scaled, as the reference scales q before the dot
//   product) and its float32 accumulator stay in registers.
// - K/V tiles of 64 keys of the kv head are staged through shared memory as
//   float32 and read by all threads at the same address (a broadcast). Scores
//   go to a per-thread column of shared memory (conflict-free).
// - Running max, denominator and accumulator are float32 and follow the
//   reference's order per tile: m_new = max(m, max_j s_j), corr = exp(m -
//   m_new), l = l * corr + sum_j p_j, acc = acc * corr + sum_j p_j v_j, with
//   masked scores set to -1e30 (not -inf); out = acc / max(l, 1e-30).
// - Keys beyond Sk (the ragged edge) are masked by position and their V rows
//   staged as zeros. q rows beyond Sq are computed and not written.
// - Under the causal mask, tiles wholly above the diagonal of the whole q tile
//   are skipped. That is bitwise neutral: every row meets its diagonal key in
//   an earlier, processed tile, so m is a finite score and such a tile would
//   give p = exp(-1e30 - m) = 0 exactly and corr = 1.
// - Each dot product is summed in ascending d, four keys at a time for
//   instruction-level parallelism; no atomics, so results repeat exactly.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // q rows per block = threads per block
constexpr int kKeys = 64;  // keys per K/V tile (the plain version's BLOCK_K)
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return (2 * kKeys * D + kKeys * kRows) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Sk, int Hq, int Hkv, int causal, int window,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kKeys][D]
  float* vs = ks + kKeys * D;                   // [kKeys][D]
  float* ss = vs + kKeys * D;                   // [kKeys][kRows]
  const int tid = threadIdx.x;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int qi = qt * kRows + tid;
  const bool row_ok = qi < Sq;

  float qr[D];
  float acc[D];
  {
    const T* qrow = q + ((static_cast<size_t>(b) * Sq + (row_ok ? qi : 0)) *
                             Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? to_f32(qrow[d]) * scale : 0.0f;
      acc[d] = 0.0f;
    }
  }
  float m = kNegInf;
  float l = 0.0f;

  int n_tiles = (Sk + kKeys - 1) / kKeys;
  if (causal) {
    const int q_last = min(qt * kRows + kRows, Sq) - 1;
    n_tiles = min(n_tiles, q_last / kKeys + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKeys * D; idx += kRows) {
      const int j = idx / D;
      const int d = idx % D;
      const int kp = k0 + j;
      float kv = 0.0f;
      float vv = 0.0f;
      if (kp < Sk) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + kp) * Hkv + hk) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    __syncthreads();

    // scores of this tile, masked, into this thread's column of ss
    float mt = kNegInf;
    for (int j = 0; j < kKeys; j += 4) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 kk =
              *reinterpret_cast<const float4*>(ks + (j + u) * D + d);
          s[u] = s[u] + qr[d] * kk.x;
          s[u] = s[u] + qr[d + 1] * kk.y;
          s[u] = s[u] + qr[d + 2] * kk.z;
          s[u] = s[u] + qr[d + 3] * kk.w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kp = k0 + j + u;
        bool ok = kp < Sk;
        if (causal) ok = ok && (qi >= kp);
        if (window) ok = ok && (qi - kp < window);
        const float sv = ok ? s[u] : kNegInf;
        ss[(j + u) * kRows + tid] = sv;
        mt = fmaxf(mt, sv);
      }
    }

    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = acc[d] * corr;
    float psum = 0.0f;
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(ss[j * kRows + tid] - m_new);
      psum = psum + p;
      const float* vj = vs + j * D;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vj + d);
        acc[d] = acc[d] + p * vv.x;
        acc[d + 1] = acc[d + 1] + p * vv.y;
        acc[d + 2] = acc[d + 2] + p * vv.z;
        acc[d + 3] = acc[d + 3] + p * vv.w;
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kRows, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
             float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The head dims a launch takes (the kernel is instantiated per head dim).
int flash_head_dim_ok(int D) { return D == 32 || D == 64 || D == 128; }

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], out [B, Sq, Hq, D], all contiguous
// and of one dtype (code 0 float32, 1 bfloat16). window 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int D, int causal, int window, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_d<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window,
                           scale, s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                   causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
