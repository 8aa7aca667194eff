// Fused AirComp reduction over the stacked client deltas [M, N].
//
// Replaces the TPU kernel repro/kernels/zo_aircomp.py:aircomp_reduce
// (_reduce_kernel): in one read of the matrix it gives the weighted row
// combination mean[c] = sum_m scale[m] * x[m, c] over all N columns (the
// masked scaled mean; the caller folds mask and divisor into scale) and the
// per-row squared norms over the valid prefix, sq[m] = sum_{c < d} x[m, c]^2
// (for Delta_max, Eq. 15).
//
// What bounds it on an H100: memory. Each element is read once and costs
// three floating-point operations (a multiply-add for the mean, a square-add
// for the norm), far below the card's ~20 fp32 operations per byte of memory
// rate; the output is N + M floats. At the flat Qwen2-0.5B round ([4,
// 494,075,904]) that is 9.88 GB, 2.95 ms at 3.35 TB/s. At the softmax
// round ([10, 65,536], 2.9 MB) it is 0.86 us of bytes: there the launch and
// the round trips on the critical path set the time.
//
// What the design does about it:
// - One launch. A block walks the column tiles blockIdx.x, blockIdx.x +
//   gridDim.x, ... (the grid is as many blocks as the card holds at once,
//   or one per tile where there are fewer). A tile is 256 threads x PER
//   16-byte vectors a row: thread t owns the vectors j * 256 + t, j < PER,
//   and keeps their PER x 4 mean accumulators in registers while it walks
//   the M rows in ascending order, so the mean is the plain version's sum
//   (rows added in ascending m from zero, each term a float32 multiply then
//   add: the build never contracts them, --fmad=false).
// - The rows go in batches of RB = 16 / PER: all RB x PER loads of a batch
//   (and the batch's scales) are issued before any of them is used, so a
//   thread has 16 loads in flight instead of one row's worth. PER = 1
//   (1,024 columns a tile, 16 rows a batch) where the tiles of PER = 4 would
//   not fill the card, as at the softmax round; PER = 4 (4,096 columns, 4
//   rows a batch) otherwise.
// - The norms: a thread sums the squares of its elements of a row (vector
//   j ascending, then the four elements in order; columns at or beyond d
//   add nothing), the 32 lanes of a warp meet in an xor-shuffle tree
//   (offsets 16, ..., 1), and thread r of the block adds the 8 warp sums of
//   row r of the batch by a fixed tree ((w0 + w4) + (w2 + w6)) + ((w1 + w5)
//   + (w3 + w7)) and adds that to the block's partial of the row, tile by
//   tile in ascending order, in device memory: no shared memory per row,
//   so M has no limit. The last block to finish, known from an atomic
//   ticket that counts finished blocks and carries no value, sums each row's
//   partials: half-warp h takes rows h, h + 16, ... (one round for up to 16
//   rows), lane l the partials l, l + 16, ... in ascending order, then the
//   xor-shuffle tree (offsets 8, ..., 1). It resets the ticket to 0 for the
//   next call. Every sum has a fixed order, so a result
//   is the same from run to run; kernels/zo_aircomp.py:aircomp_sq_order_sum
//   is that order in torch.
// - Rows are read as 16-byte vectors when x and mean are 16-byte aligned
//   and N is a multiple of 4 (every row then starts aligned); otherwise the
//   same lane layout takes scalar loads, so the order, and the result, are
//   the same. Ragged N is masked by the kernel.
//
// The previous design, two launches (one thread of a second kernel summing
// all of a row's block partials in series: 482,496 of them at the Qwen2-0.5B
// width), is kept below only so chip_smoke.py can time it beside this one.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;            // floats in a 16-byte vector
constexpr int kLoadsInFlight = 16; // RB x PER vectors a thread issues at once
constexpr int kFinishAhead = 8;    // loads in flight in the finish
constexpr int kFinishLanes = 16;   // lanes that sum a row's partials

template <int PER>
constexpr int kTileCols = kThreads * kVec * PER;

template <int PER, bool VEC>
__global__ void __launch_bounds__(kThreads)
    aircomp_reduce_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          float* __restrict__ mean,
                          float* __restrict__ partial,
                          unsigned* __restrict__ ticket,
                          float* __restrict__ sq, int M, int N, int d,
                          int n_tiles) {
  constexpr int RB = kLoadsInFlight / PER;
  __shared__ float ws[RB][kWarps];
  __shared__ bool last;
  const int G = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int tile = blockIdx.x; tile < n_tiles; tile += G) {
    // column of this thread's vector j: base + j * 1024
    const long long base = static_cast<long long>(tile) * kTileCols<PER> +
                           threadIdx.x * kVec;
    float acc[PER][kVec];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[j][k] = 0.0f;
    }
    for (int m0 = 0; m0 < M; m0 += RB) {
      // the batch's loads, all issued before any is used
      float v[RB][PER][kVec];
      float sc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const bool row_ok = m0 + r < M;
        sc[r] = row_ok ? scale[m0 + r] : 0.0f;
        const float* xm = x + static_cast<size_t>(row_ok ? m0 + r : 0) * N;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const long long c = base + j * kThreads * kVec;
          if constexpr (VEC) {
            float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (row_ok && c < N) t = *reinterpret_cast<const float4*>(xm + c);
            v[r][j][0] = t.x;
            v[r][j][1] = t.y;
            v[r][j][2] = t.z;
            v[r][j][3] = t.w;
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
              v[r][j][k] = (row_ok && c + k < N) ? xm[c + k] : 0.0f;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (m0 + r >= M) break;  // uniform over the block
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const long long c = base + j * kThreads * kVec;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float e = v[r][j][k];
            acc[j][k] = acc[j][k] + sc[r] * e;
            if (c + k < d) s = s + e * e;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          s = s + __shfl_xor_sync(0xffffffffu, s, o);
        }
        if (lane == 0) ws[r][warp] = s;
      }
      __syncthreads();
      const int r = threadIdx.x;
      if (r < RB && m0 + r < M) {
        const float t = ((ws[r][0] + ws[r][4]) + (ws[r][2] + ws[r][6])) +
                        ((ws[r][1] + ws[r][5]) + (ws[r][3] + ws[r][7]));
        float* p = partial + static_cast<size_t>(m0 + r) * G + blockIdx.x;
        *p = tile == static_cast<int>(blockIdx.x) ? t : *p + t;
      }
      __syncthreads();  // ws is free for the next batch
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long c = base + j * kThreads * kVec;
      if constexpr (VEC) {
        if (c < N) {
          *reinterpret_cast<float4*>(mean + c) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (c + k < N) mean[c + k] = acc[j][k];
        }
      }
    }
  }

  // The block's partials are written (the barrier), then thread 0 takes
  // the ticket with acquire-release semantics at device scope: the release
  // publishes the block's writes before the count, the acquire makes every
  // other block's visible to the last one (the barrier-and-release pattern
  // of CUTLASS's inter-block barrier). The last block reads the partials
  // from L2 (ld.global.cg), never from a stale L1 line.
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned done;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(done) : "l"(ticket) : "memory");
    last = done == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (!last) return;
  // kFinishLanes lanes a row: rows h, h + 16, ... for half-warp h
  const int h = threadIdx.x / kFinishLanes;
  const int l = threadIdx.x % kFinishLanes;
  for (int m0 = 0; m0 < M; m0 += kThreads / kFinishLanes) {
    const int m = m0 + h;  // the loop is uniform over the warp
    const float* p = partial + static_cast<size_t>(m < M ? m : 0) * G;
    float f = 0.0f;
    if (m < M) {
      int c = l;
      for (; c + (kFinishAhead - 1) * kFinishLanes < G;
           c += kFinishAhead * kFinishLanes) {
        float a[kFinishAhead];
#pragma unroll
        for (int u = 0; u < kFinishAhead; ++u) {
          a[u] = __ldcg(p + c + u * kFinishLanes);
        }
#pragma unroll
        for (int u = 0; u < kFinishAhead; ++u) f = f + a[u];
      }
      for (; c < G; c += kFinishLanes) f = f + __ldcg(p + c);
    }
#pragma unroll
    for (int o = kFinishLanes / 2; o > 0; o >>= 1) {
      f = f + __shfl_xor_sync(0xffffffffu, f, o);
    }
    if (m < M && l == 0) sq[m] = f;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <int PER>
int resident_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, aircomp_reduce_kernel<PER, true>, kThreads, 0);
  }
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(err);
}

template <int PER>
int launch(const float* x, const float* scale, float* mean, float* partial,
           unsigned* ticket, float* sq, int M, int N, int d, int grid,
           cudaStream_t s) {
  const int n_tiles = (N + kTileCols<PER> - 1) / kTileCols<PER>;
  // every block must own a tile, or the finish would read a partial that
  // no block wrote
  if (grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(mean)) % 16 == 0 &&
                   N % kVec == 0;
  if (vec) {
    aircomp_reduce_kernel<PER, true><<<grid, kThreads, 0, s>>>(
        x, scale, mean, partial, ticket, sq, M, N, d, n_tiles);
  } else {
    aircomp_reduce_kernel<PER, false><<<grid, kThreads, 0, s>>>(
        x, scale, mean, partial, ticket, sq, M, N, d, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the previous design (two launches), kept only for timing

constexpr int kOldCols = 4;
constexpr int kOldBlockCols = kThreads * kOldCols;  // 1024 columns per block

__global__ void twopass_reduce_kernel(const float* __restrict__ x,
                                      const float* __restrict__ scale,
                                      float* __restrict__ mean,
                                      float* __restrict__ partial, int M,
                                      int N, int d, int n_blocks) {
  extern __shared__ float warp_sums[];  // [M][kWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kOldBlockCols + threadIdx.x;
  float acc[kOldCols];
#pragma unroll
  for (int j = 0; j < kOldCols; ++j) acc[j] = 0.0f;
  for (int m = 0; m < M; ++m) {
    const float sc = scale[m];
    const float* xm = x + static_cast<size_t>(m) * N;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kOldCols; ++j) {
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
  for (int j = 0; j < kOldCols; ++j) {
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

// The launch geometry for N columns on the current device: *per, the
// vectors a thread takes of a row in a tile (1 or 4), and *grid, the
// blocks (at most one per tile). The caller sizes partial as M x grid.
int aircomp_geometry(int N, int* per, int* grid) {
  int resident4 = 0, resident1 = 0;
  int err = resident_blocks<4>(&resident4);
  if (err != 0) return err;
  const int tiles4 = (N + kTileCols<4> - 1) / kTileCols<4>;
  if (tiles4 >= resident4) {
    *per = 4;
    *grid = resident4;
    return 0;
  }
  err = resident_blocks<1>(&resident1);
  if (err != 0) return err;
  const int tiles1 = (N + kTileCols<1> - 1) / kTileCols<1>;
  *per = 1;
  *grid = tiles1 < resident1 ? tiles1 : resident1;
  return 0;
}

// One launch. per, grid: from aircomp_geometry for this N; partial: scratch
// of M * grid floats; ticket: a counter that is 0 when the call starts and
// is 0 again when it ends (the caller zeroes it once, when it allocates it).
int aircomp_reduce_launch(const float* x, const float* scale, float* mean,
                          float* partial, unsigned* ticket, float* sq, int M,
                          int N, int d, int per, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (per == 4) {
    return launch<4>(x, scale, mean, partial, ticket, sq, M, N, d, grid, s);
  }
  if (per == 1) {
    return launch<1>(x, scale, mean, partial, ticket, sq, M, N, d, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The previous design, for timing only: partial is scratch of
// M * ceil(N / 1024) floats; at most twopass_max_rows() rows.
int aircomp_twopass_block_cols() { return kOldBlockCols; }

int aircomp_twopass_max_rows() {
  return (48 * 1024) / (kWarps * sizeof(float));
}

int aircomp_reduce_twopass_launch(const float* x, const float* scale,
                                  float* mean, float* partial, float* sq,
                                  int M, int N, int d, void* stream) {
  const int n_blocks = (N + kOldBlockCols - 1) / kOldBlockCols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(M) * kWarps * sizeof(float);
  twopass_reduce_kernel<<<n_blocks, kThreads, smem, s>>>(x, scale, mean,
                                                        partial, M, N, d,
                                                        n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_row_partials_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, sq, M, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
