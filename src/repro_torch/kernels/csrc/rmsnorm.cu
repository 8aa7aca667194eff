// RMSNorm over the last dimension of a row-major [R, D] matrix.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm (_rmsnorm_kernel):
// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale, computed in
// float32 and stored in x's dtype (float32 or bfloat16; scale may be either).
// In the dense transformer it normalises every block's two inputs and the
// final hidden state (R = batch * seq rows of D = d_model), and the q/k heads
// under qk_norm (D = head_dim).
//
// scale is [G, D] (row g at scale + g * scale_stride): the R rows fall into G
// equal contiguous groups and group g takes scale row g. G = 1 is one scale
// for every row; G = M is the client-batched forward of the flat FedZO round,
// where each of the M clients has its own weights (the reference's norm_fwd
// under vmap).
//
// What bounds it on an H100: memory. Each element is read once, written once
// and costs four floating-point operations (a square-add, two multiplies),
// about 0.5 operations per byte against the card's ~20 fp32 operations per
// byte of memory rate. At the Qwen2-0.5B train step's [512, 896] float32 the
// whole call moves 3.7 MB, so it is short enough that launch latency, the
// number of rows in flight and the round trips on a row's critical path
// matter as much as bandwidth.
//
// What the design does about it:
// - A row is read once, into registers, as 16-byte vectors (VEC = 4 float32
//   or 8 bfloat16 elements): a group of LPR lanes owns the row, lane l the
//   vectors l, l + LPR, l + 2*LPR, ... (at most MAXV of them; the last one
//   predicated where LPR does not divide the row). All of a lane's loads
//   are issued before any arithmetic, the sum of squares is formed from the
//   registers, and the output is written from the same registers: one
//   round trip to memory per row.
// - Narrow rows share a warp: LPR = 32 lanes per row for D > 128, else 16
//   (more than 8 vectors) or 8, so a qk_norm's 64-wide heads take 2 or 4
//   rows per warp.
// - 4 warps per block, so the 512 rows of the train step make 128 blocks
//   over the 132 SMs (eight warps per block gave 64). A warp walks its rows
//   with a grid stride and keeps scale, converted to float32, in registers
//   across all of them. With G > 1 a lane loads its row's scale row (a
//   row's group is row / (R / G), by a multiply-high, not a division) only
//   when it differs from the one it holds, before the row's own loads, so
//   the two round trips overlap. (Loaded after them, the scale's bf16
//   conversions waited on it inside the branch: 1.29x the time of G = 1 at
//   [512, 896] bf16 on an H100, against 1.01x.)
// - Rows whose start is not 16-byte aligned (a view at an odd element
//   offset) or whose length D*size is not a multiple of 16 take the same
//   layout with scalar loads and stores: lane l still owns the elements of
//   the "vectors" l, l + LPR, ..., so the summation order is the same. A row
//   longer than 8 vectors a lane (D > 1024 float32, > 2048 bfloat16) does
//   not fit in registers and takes the streaming kernel below, which reads
//   it twice in the same order.
//
// Summation order of the mean square (the only order that differs from the
// reference's): each lane sums its elements' squares in ascending element
// order (vector by vector, and within a vector), each term a float32
// multiply then add (the build never contracts them, --fmad=false); the LPR
// lane sums are combined by a fixed xor-shuffle tree (offsets LPR/2, ...,
// 1), so every lane of the group ends with the same total and the result is
// the same from run to run. kernels/rmsnorm.py:rmsnorm_kernel_order is this
// order in torch. Then the reference's operations in its order: ms = sum /
// D, r = 1 / sqrtf(ms + eps) (correctly rounded sqrt and divide; the build
// never uses fast math), out = (x * r) * scale.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 132 * 16;  // a full card of resident blocks

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

// VEC elements of a lane's "vector" at element i0 of a row of D: one 16-byte
// load when vec (the caller guarantees alignment), else scalar loads of the
// elements below D; zeros elsewhere.
template <int VEC, typename T>
__device__ __forceinline__ void load_elems(const T* __restrict__ row, int i0,
                                           int D, bool vec, bool live,
                                           float (&o)[VEC]) {
  if (live && vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + i0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      o[k] = (live && i0 + k < D) ? to_f32(row[i0 + k]) : 0.0f;
    }
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_elems(T* __restrict__ row, int i0,
                                            int D, bool vec,
                                            const float (&v)[VEC]) {
  if (vec) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f32<T>(v[k]);
    *reinterpret_cast<uint4*>(row + i0) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (i0 + k < D) row[i0 + k] = from_f32<T>(v[k]);
    }
  }
}

// the group's fixed xor-shuffle tree over LPR lanes
template <int LPR>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
  }
  return acc;
}


// row / rpg for 0 <= row < 2^31: m = min(floor(2^32 / rpg), 2^32 - 1) makes
// __umulhi(row, m) the quotient or one less (its error is below row / 2^32
// < 1/2), so one compare corrects it
__device__ __forceinline__ int group_of(int row, int rpg, unsigned m) {
  int g = static_cast<int>(__umulhi(static_cast<unsigned>(row), m));
  if (static_cast<long long>(g + 1) * rpg <= row) ++g;
  return g;
}
// A lane's share of one scale row, converted to float32: the elements of its
// vectors sub, sub + LPR, ..., as the lane holds the row of x.
template <typename TX, typename TS, int LPR, int MAXV>
__device__ __forceinline__ void load_scale(const TS* __restrict__ srow,
                                           int sub, int nvec, int D,
                                           bool svec,
                                           float (&sc)[MAXV][16 / sizeof(TX)]) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TX));
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int vi = j * LPR + sub;
    const bool live = vi < nvec;
    if constexpr (sizeof(TS) == sizeof(TX)) {
      load_elems<VEC>(srow, vi * VEC, D, svec, live, sc[j]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int i = vi * VEC + k;
        sc[j][k] = (live && i < D) ? to_f32(srow[i]) : 0.0f;
      }
    }
  }
}

// Rows in registers: LPR lanes a row, at most MAXV vectors a lane. vec: x's
// and out's rows are 16-byte vectors; svec: so is every scale row (of x's
// element size). GROUPED (G > 1): rpg rows per scale group (magic: its
// group_of multiplier), sstride elements between two scale rows; without
// it (G = 1) the one scale row is loaded before the first row.
template <typename TX, typename TS, int LPR, int MAXV, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   TX* __restrict__ out, int rows, int D, float eps, bool vec,
                   bool svec, int rpg, long long sstride, unsigned magic) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TX));
  constexpr int kRowsPerWarp = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nvec = (D + VEC - 1) / VEC;
  [[maybe_unused]] int group = -1;  // the scale row in sc (G > 1)
  float sc[MAXV][VEC];
  if constexpr (!GROUPED) {
    load_scale<TX, TS, LPR, MAXV>(scale, sub, nvec, D, svec, sc);
  }
  for (int r0 = warp * kRowsPerWarp; r0 < rows;
       r0 += gridDim.x * kWarps * kRowsPerWarp) {
    const int row = r0 + lane / LPR;
    const bool live_row = row < rows;
    if constexpr (GROUPED) {
      if (live_row) {
        const int g = group_of(row, rpg, magic);
        if (g != group) {
          group = g;
          load_scale<TX, TS, LPR, MAXV>(scale + group * sstride, sub, nvec, D,
                                        svec, sc);
        }
      }
    }
    const TX* xr = x + static_cast<size_t>(row) * D;
    float v[MAXV][VEC];
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int vi = j * LPR + sub;
      load_elems<VEC>(xr, vi * VEC, D, vec, live_row && vi < nvec, v[j]);
    }

    // the zeros beyond the row add exact zeros
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc = acc + v[j][k] * v[j][k];
    }
    acc = group_sum<LPR>(acc);
    const float ms = acc / static_cast<float>(D);
    const float r = 1.0f / sqrtf(ms + eps);
    if (!live_row) continue;
    TX* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int vi = j * LPR + sub;
      if (vi < nvec) {
        float o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = (v[j][k] * r) * sc[j][k];
        store_elems<VEC>(orow, vi * VEC, D, vec, o);
      }
    }
  }
}

// Rows too long for registers: one warp a row, the same lane layout and
// summation order, the row read a second time (from L1/L2) for the output.
template <typename TX, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_long_kernel(const TX* __restrict__ x,
                        const TS* __restrict__ scale, TX* __restrict__ out,
                        int rows, int D, float eps, bool vec, int rpg,
                        long long sstride) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TX));
  const int lane = threadIdx.x & 31;
  const int nvec = (D + VEC - 1) / VEC;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const TX* xr = x + static_cast<size_t>(row) * D;
    float acc = 0.0f;
    for (int vi = lane; vi < nvec; vi += 32) {
      float v[VEC];
      load_elems<VEC>(xr, vi * VEC, D, vec, true, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc = acc + v[k] * v[k];
    }
    acc = group_sum<32>(acc);
    const float ms = acc / static_cast<float>(D);
    const float r = 1.0f / sqrtf(ms + eps);
    TX* orow = out + static_cast<size_t>(row) * D;
    for (int vi = lane; vi < nvec; vi += 32) {
      float v[VEC], o[VEC];
      load_elems<VEC>(xr, vi * VEC, D, vec, true, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int i = vi * VEC + k;
        // the scale row's offset taken here: a pointer to it kept live
        // across the divisions above cost register spills
        const long long si = (row / rpg) * sstride + i;
        o[k] = (v[k] * r) * (i < D ? to_f32(scale[si]) : 0.0f);
      }
      store_elems<VEC>(orow, vi * VEC, D, vec, o);
    }
  }
}

template <typename TX, typename TS, int LPR, int MAXV>
void launch_rows(int grid, cudaStream_t s, const TX* x, const TS* scale,
                 TX* out, int rows, int D, float eps, bool vec, bool svec,
                 int rpg, long long sstride) {
  if (rpg < rows) {
    const unsigned long long m = (1ull << 32) / rpg;
    const unsigned magic =
        m > 0xffffffffull ? 0xffffffffu : static_cast<unsigned>(m);
    rmsnorm_kernel<TX, TS, LPR, MAXV, true><<<grid, kThreads, 0, s>>>(
        x, scale, out, rows, D, eps, vec, svec, rpg, sstride, magic);
  } else {
    rmsnorm_kernel<TX, TS, LPR, MAXV, false><<<grid, kThreads, 0, s>>>(
        x, scale, out, rows, D, eps, vec, svec, rpg, sstride, 0u);
  }
}

inline int grid_for(long long warps_needed) {
  long long b = (warps_needed + kWarps - 1) / kWarps;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

template <typename TX, typename TS>
int launch(const void* xv, const void* sv, void* ov, int rows, int D,
           float eps, int n_groups, long long sstride, cudaStream_t s) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TX));
  const TX* x = static_cast<const TX*>(xv);
  const TS* scale = static_cast<const TS*>(sv);
  TX* out = static_cast<TX*>(ov);
  const int rpg = rows / n_groups;
  const bool vec = (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
                   (static_cast<long long>(D) * sizeof(TX)) % 16 == 0;
  const bool svec = vec && sizeof(TS) == sizeof(TX) &&
                    reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                    (n_groups == 1 || (sstride * sizeof(TS)) % 16 == 0);
  const int nvec = (D + VEC - 1) / VEC;
  // lanes per row, and vectors per lane
  const int lpr = D > 128 ? 32 : (nvec > 8 ? 16 : 8);
  const int nv = (nvec + lpr - 1) / lpr;
  const long long groups = (static_cast<long long>(rows) * lpr + 31) / 32;
  const int grid = grid_for(groups);
  if (lpr == 8) {
    launch_rows<TX, TS, 8, 2>(grid, s, x, scale, out, rows, D, eps, vec,
                              svec, rpg, sstride);
  } else if (lpr == 16) {
    launch_rows<TX, TS, 16, 2>(grid, s, x, scale, out, rows, D, eps, vec,
                               svec, rpg, sstride);
  } else if (nv <= 4) {
    launch_rows<TX, TS, 32, 4>(grid, s, x, scale, out, rows, D, eps, vec,
                               svec, rpg, sstride);
  } else if (nv <= 8) {
    launch_rows<TX, TS, 32, 8>(grid, s, x, scale, out, rows, D, eps, vec,
                               svec, rpg, sstride);
  } else {
    rmsnorm_long_kernel<TX, TS><<<grid_for(rows), kThreads, 0, s>>>(
        x, scale, out, rows, D, eps, vec, rpg, sstride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16. out has x's dtype and shape. groups
// divides rows; scale row g starts scale_stride elements after row g - 1.
int rmsnorm_launch(const void* x, const void* scale, void* out, int rows,
                   int D, float eps, int x_dtype, int scale_dtype, int groups,
                   long long scale_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return 0;
  if (groups < 1 || rows % groups != 0 || scale_stride < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_dtype == 0 && scale_dtype == 0) {
    return launch<float, float>(x, scale, out, rows, D, eps, groups,
                                scale_stride, s);
  }
  if (x_dtype == 0 && scale_dtype == 1) {
    return launch<float, __nv_bfloat16>(x, scale, out, rows, D, eps, groups,
                                        scale_stride, s);
  }
  if (x_dtype == 1 && scale_dtype == 0) {
    return launch<__nv_bfloat16, float>(x, scale, out, rows, D, eps, groups,
                                        scale_stride, s);
  }
  if (x_dtype == 1 && scale_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, eps,
                                                 groups, scale_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
