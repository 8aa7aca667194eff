// Materialized-direction axpy kernels on flat vectors.
//
// Replace the TPU kernels of repro/kernels/zo_axpy.py:
//   axpy_kernel<1, ...>  <- zo_axpy  (_axpy_kernel):  out = x + a*u
//   axpy_kernel<2, ...>  <- zo_axpy2 (_axpy2_kernel): out = x + a*u + b*v
// computed in float32 in that order, (x + a*u) + b*v, and stored in x's
// dtype. x, u and v are each float32 or bfloat16 (on the pytree route a
// bfloat16 direction moves float32 or bfloat16 parameters). The
// scalars a and (a, b) are read from device memory, as the Pallas kernels
// read their SMEM scalars: on the pytree FedZO route a = lr*c_n/b2 is a
// tensor on the card, and a host float would cost a synchronisation per
// launch.
//
// What bounds them on an H100: memory. One multiply and one add per term
// against 12 bytes (axpy, float32) or 16 bytes (axpy2) of traffic per
// element: about 0.15 operations per byte where the card balances at ~20.
//
// What the design does about it: a one-pass grid over the vector body. A
// block takes kUnroll x kThreads consecutive 16-byte vectors (a float4, or 8
// bfloat16) per array, the thread every kThreads-th of them, and each thread
// issues all its loads (kUnroll vectors of x, u and v) before any
// arithmetic, so 8-12 loads of 16 bytes are in flight per thread. Stores
// carry the streaming hint (st.global.cs: out is not read again); on the
// loads the same hint (ld.global.cs) measured slower on the H100 and is not
// used. The scalars are read once per block into shared memory. One pass
// measured faster than a persistent grid (132 SMs x 8 blocks) looping over
// the same unrolled body.
// The Pallas wrapper pads to a 64Ki block; here nothing is padded: a
// scalar loop after the body, laid out as the body, finishes a length that
// is not a multiple of the vector width. A leaf may be a view at any
// element offset (a counter-convention direction is a slice of one flat
// buffer), while the output is always freshly allocated; so the vector
// body runs only when every pointer is 16-byte aligned, and otherwise the
// whole call runs as the scalar loop. The build never contracts the
// multiply-add (--fmad=false), so the result is bitwise the plain
// version's.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors per thread and array, loaded together

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

// VEC consecutive elements at a 16-byte aligned address, as raw 16-byte
// chunks
template <int VEC, typename T>
struct Vec {
  static constexpr int kChunks = VEC * static_cast<int>(sizeof(T)) / 16;
  static_assert(kChunks * 16 == VEC * static_cast<int>(sizeof(T)),
                "a vector is a whole number of 16-byte chunks");
  uint4 raw[kChunks];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      raw[c] = reinterpret_cast<const uint4*>(p)[c];
    }
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(raw)[i]);
  }
};

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  constexpr int kChunks = VEC * static_cast<int>(sizeof(T)) / 16;
  uint4 raw[kChunks];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(in[i]);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    __stcs(reinterpret_cast<uint4*>(p) + c, raw[c]);
  }
}

// TERMS = 1: out = x + s[0]*u. TERMS = 2: out = (x + s[0]*u) + s[1]*v.
// The nvec vectors of [0, nvec*VEC) start at 16-byte aligned addresses;
// the elements [nvec*VEC, n) take the scalar loop after them.
template <int TERMS, int VEC, typename TX, typename TU, typename TV>
__global__ void __launch_bounds__(kThreads)
    axpy_kernel(const TX* __restrict__ x, const TU* __restrict__ u,
                const TV* __restrict__ v, TX* __restrict__ out,
                const float* __restrict__ s, long long n, long long nvec) {
  __shared__ float ab[TERMS];
  if (threadIdx.x < TERMS) ab[threadIdx.x] = s[threadIdx.x];
  __syncthreads();
  const float a = ab[0];
  const float b = TERMS == 2 ? ab[TERMS - 1] : 0.0f;
  constexpr long long kSpan = static_cast<long long>(kUnroll) * kThreads;
  for (long long k0 = blockIdx.x * kSpan + threadIdx.x; k0 < nvec;
       k0 += gridDim.x * kSpan) {
    Vec<VEC, TX> xs[kUnroll];
    Vec<VEC, TU> us[kUnroll];
    Vec<VEC, TV> vs[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long k = k0 + i * kThreads;
      if (k < nvec) {
        xs[i].load(x + k * VEC);
        us[i].load(u + k * VEC);
        if constexpr (TERMS == 2) vs[i].load(v + k * VEC);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long k = k0 + i * kThreads;
      if (k < nvec) {
        float t[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          t[e] = xs[i].get(e) + a * us[i].get(e);
          if constexpr (TERMS == 2) t[e] = t[e] + b * vs[i].get(e);
        }
        store_vec<VEC>(out + k * VEC, t);
      }
    }
  }
  // the scalar loop, laid out as the body: kUnroll elements a thread,
  // loaded before any arithmetic
  for (long long j0 = nvec * VEC + blockIdx.x * kSpan + threadIdx.x; j0 < n;
       j0 += gridDim.x * kSpan) {
    float xs[kUnroll], us[kUnroll], vs[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long j = j0 + i * kThreads;
      if (j < n) {
        xs[i] = to_f32(x[j]);
        us[i] = to_f32(u[j]);
        if constexpr (TERMS == 2) vs[i] = to_f32(v[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long j = j0 + i * kThreads;
      if (j < n) {
        float t = xs[i] + a * us[i];
        if constexpr (TERMS == 2) t = t + b * vs[i];
        out[j] = from_f32<TX>(t);
      }
    }
  }
}

template <int TERMS, typename TX, typename TU, typename TV>
int launch(const void* x, const void* u, const void* v, void* out,
           const float* s, long long n, cudaStream_t stream) {
  // 8 elements per vector when any array is bfloat16 (16 bytes of it),
  // else a float4
  constexpr bool kAllF32 = sizeof(TX) == 4 && sizeof(TU) == 4 &&
                           (TERMS == 1 || sizeof(TV) == 4);
  constexpr int VEC = kAllF32 ? 4 : 8;
  constexpr long long kSpan = static_cast<long long>(kUnroll) * kThreads;
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(u) |
      reinterpret_cast<uintptr_t>(out) |
      (TERMS == 2 ? reinterpret_cast<uintptr_t>(v) : 0);
  const long long nvec = addr_bits % 16 == 0 ? n / VEC : 0;
  const long long tail = n - nvec * VEC;
  // one pass over the body (the tail is then under VEC elements); with no
  // body the scalar loop takes kUnroll elements a thread
  const long long work = nvec > 0 ? nvec : tail;
  long long blocks = (work + kSpan - 1) / kSpan;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  axpy_kernel<TERMS, VEC, TX, TU, TV>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TU*>(u),
          static_cast<const TV*>(v), static_cast<TX*>(out), s, n, nvec);
  return static_cast<int>(cudaGetLastError());
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16. x, u and v are each float32 or
// bfloat16; out has x's dtype and n elements.
int zo_axpy_launch(const void* x, const void* u, const float* a, void* out,
                   long long n, int x_dtype, int u_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (x_dtype * 2 + u_dtype) {
    case 0: return launch<1, float, float, float>(x, u, nullptr, out, a, n, s);
    case 1: return launch<1, float, bf16, float>(x, u, nullptr, out, a, n, s);
    case 2: return launch<1, bf16, float, float>(x, u, nullptr, out, a, n, s);
    case 3: return launch<1, bf16, bf16, float>(x, u, nullptr, out, a, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int zo_axpy2_launch(const void* x, const void* u, const void* v,
                    const float* ab, void* out, long long n, int x_dtype,
                    int u_dtype, int v_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (x_dtype * 4 + u_dtype * 2 + v_dtype) {
    case 0: return launch<2, float, float, float>(x, u, v, out, ab, n, s);
    case 1: return launch<2, float, float, bf16>(x, u, v, out, ab, n, s);
    case 2: return launch<2, float, bf16, float>(x, u, v, out, ab, n, s);
    case 3: return launch<2, float, bf16, bf16>(x, u, v, out, ab, n, s);
    case 4: return launch<2, bf16, float, float>(x, u, v, out, ab, n, s);
    case 5: return launch<2, bf16, float, bf16>(x, u, v, out, ab, n, s);
    case 6: return launch<2, bf16, bf16, float>(x, u, v, out, ab, n, s);
    case 7: return launch<2, bf16, bf16, bf16>(x, u, v, out, ab, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
