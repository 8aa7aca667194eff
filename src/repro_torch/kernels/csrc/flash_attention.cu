// Blocked online-softmax (flash) attention, forward, with GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): out = softmax(scale * q k^T + mask) v for each (batch,
// query head), the kv head being h / (Hq / Hkv), with causal and sliding-window
// masks by position (q and k positions both start at 0). Layout is the
// reference wrapper's [B, S, H, D] (repro/kernels/ops.py:attention), read in
// place: no transpose and no padding to a block multiple. v and out may have
// a head dim DV apart from q's and k's DQK, as in the Pallas kernel (v [B,
// Sk, Hkv, DV], out [B, Sq, Hq, DV]). Two bodies behind one launcher: float32
// on the FMA pipes, bfloat16 on the tensor cores.
//
// What bounds it on an H100: at the Qwen2-0.5B train step (B 4, S 128, Hq 14,
// Hkv 2, D 64, causal) a call needs 0.12 GFLOP and moves 4.2 MB in float32
// (2.1 MB in bfloat16). In float32 that is 1.8 us of FMA work at 67 TFLOP/s
// and 1.3 us of bytes; in bfloat16 0.12 us of tensor-core work and 0.63 us
// of bytes. Neither bound is near: a call this small is bound by latency
// (the K/V fetch, the dependent chain of a tile's products, the launch) and
// by how many warps are in flight to hide it.
//
// What the design does about it:
// - Both bodies are templated on the pair (DQK, DV). Equal pairs: head dims
//   16, 32, 64, 128 and 256, each its own instantiation, and in float32 also
//   8 (the neural transformer track at its test and figure sizes: d_model 16
//   over 2 heads). bfloat16 at D = 8 is not built: Q.K^T there is half of
//   one m16n8k16 k-step. Unequal pairs: (192, 128) in both dtypes (DeepSeek
//   MLA's prefill: nope 128 + rope 64 against v 128) and (24, 16) in float32
//   (its smoke size: nope 16 + rope 8 against v 16; 24 is no whole number of
//   16-wide bf16 k-steps). Q.K^T walks DQK, P.V and the output DV; K and V
//   are staged as rows of their own widths. Equal pairs compile to the code
//   they had before the pair was split. At (192, 128) a float32 block holds
//   201,728 bytes of shared memory (q 25,088, two stages of K and V 167,936,
//   the p strips 8,704), a bfloat16 block 162,816 (three q pieces 76,800,
//   two stages 86,016): both double-buffered, one block an SM.
// - The grid is (x blocks of a batch row x B, Hq): the batch is folded into
//   grid.x (up to 2^31 - 1 blocks), not put in grid.z, whose 65,535 the
//   wide FedZO route passes (B = M.b2.b1 = 5,000 rows at the paper's
//   settings, twice that under a central difference).
// - K/V tiles of 64 keys of the kv head (the plain version's BLOCK_K) are
//   staged with 16-byte cp.async, the whole tile issued at once by all
//   threads, into two buffers: tile t+1 loads while tile t computes. Where
//   two stages do not fit in the 227 KB of shared memory a block may have
//   (D = 256 in float32: 266 KB of K/V alone; bfloat16 D = 256 with three q
//   pieces), one buffer is staged after the previous tile is consumed. Keys
//   beyond Sk are zero-filled by the copy (src-size 0) and masked by
//   position. Rows are padded by 16 bytes so that the row-wise 16-byte
//   shared-memory reads (float4 loads, ldmatrix) hit distinct banks.
// - float32 (flash_fwd_f32): a block of 256 threads takes 32 q rows; a
//   thread owns 2 rows and, for the scores, 4 keys of the tile (tx + 16c),
//   for the output D/16 columns of those rows (one at D = 16, sixteen at
//   D = 256; at D = 8 lanes tx and tx + 8 both compute column tx % 8 and
//   the lower one writes it). The q tile (pre-scaled, as
//   the reference scales q) sits in shared memory; each thread computes a
//   2 x 4 register tile of scores from float4 reads of q and K, so one
//   shared-memory read feeds 8 multiply-adds. A row's max is taken over the
//   16 lanes that share it by an xor-shuffle tree (a max is exact in any
//   order); p goes through a per-row strip of shared memory, from which
//   each lane of the half-warp sums the row's p and adds p.v to its columns.
//   At the main shape: 224 blocks of 8 warps (1,792 warps on 132 SMs), and a
//   thread's state is 2 x D/16 accumulators instead of 2 x D floats of a row.
//   Every float32 sum keeps the order of one thread per q row: each score
//   over ascending d, the sum of p and each output column over ascending
//   keys, each term a separate multiply and add (--fmad=false). So the
//   output does not depend on how the work is spread over lanes, and is the
//   same bit for bit as a kernel with one thread per row. That matters
//   beyond the tolerance: at the train step's mu the full-width ZO
//   coefficients are differences of one loss ulp, so the forward's
//   rounding decides which of them are nonzero.
// - bfloat16 (flash_fwd_bf16): a block of 4 warps takes 64 q rows, a warp 16
//   of them. Q.K^T and P.V run on mma.sync.m16n8k16 (bf16 in, float32
//   accumulators); the A and B fragments come from shared memory by
//   ldmatrix (.trans for V). Scores stay in the accumulator layout: a row's
//   max and sum are quad shuffles, and the score accumulators of two
//   n-tiles are the A fragment of P.V. The output is held to the reference
//   (float32 math on bf16 inputs) within one bf16 ulp, and near zero that
//   means within about one float32 ulp of max |out|, so both products
//   carry float32 operands as sums of bf16 pieces, exact products of which
//   the tensor cores add in float32:
//   q is scaled in float32 first, as the reference scales it; for a power
//   of two (D = 64: 1/8) bf16(q * scale) is exact (one piece), otherwise it
//   takes three pieces (NQ = 3). p stays float32 for the sum l and goes
//   into P.V as three pieces (p_hi = bf16(p), p_mid = bf16(p - p_hi), ...,
//   under 2^-26 |p| left out). Two pieces of p (16 bits, 2^-17) missed the
//   bound by up to 7 ulp at the main shape, in the card test and in the
//   CPU emulation of the design (tests/test_torch_lm_kernels.py). The extra
//   products are cheap here: the tensor cores are not what bounds the call.
//   Each 16-wide k-step's products (all pieces, the smallest first) go
//   into a zeroed accumulator that is then added to the running sums with
//   float32 adds, so the tensor cores' own accumulation spans 16 products:
//   chained over whole tiles it moved a non-causal output by 2 bf16 ulp.
//   At D >= 128 D/64 blocks share a q tile, each with 64 of the output
//   columns (the float32 accumulators of all 128 spilled registers), each
//   computing the whole Q.K^T and softmax. At D = 16, Q.K^T is one k-step
//   and P.V two n-tiles; a 32-byte row padded to 48 bytes keeps the eight
//   rows of an ldmatrix on distinct banks.
// - Running max, denominator and accumulator are float32 and follow the
//   reference's order per tile: m_new = max(m, max_j s_j), corr = exp(m -
//   m_new), l = l * corr + sum_j p_j, acc = acc * corr + sum_j p_j v_j, with
//   masked scores set to -1e30 (not -inf); out = acc / max(l, 1e-30).
// - q rows beyond Sq are computed on zeros and not written.
// - Under the causal mask, tiles wholly above the diagonal of the whole q tile
//   are skipped. That is bitwise neutral: every row meets its diagonal key in
//   an earlier, processed tile, so m is a finite score and such a tile would
//   give p = exp(-1e30 - m) = 0 exactly and corr = 1.
// - Both are held to the reference within a tolerance, not bitwise (the
//   bfloat16 body's products run on the tensor cores). No atomics, and
//   every sum has a fixed order, so results repeat exactly.
// - The dynamic shared-memory size is set once per instantiation and
//   device, not on every launch.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;  // keys per K/V tile (the plain version's BLOCK_K)
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use

constexpr int kF32Rows = 32;      // q rows per float32 block
constexpr int kF32Threads = 256;  // 16 row pairs x 16 lanes
constexpr int kBfWarps = 4;
constexpr int kBfRows = 16 * kBfWarps;  // q rows per bfloat16 block
constexpr int kBfThreads = 32 * kBfWarps;
// output columns per bfloat16 block: at D = 128 two blocks share a q tile,
// each with half of the float32 accumulators (64 registers of a thread
// otherwise, and spills), each computing the whole Q.K^T and softmax
template <int D>
constexpr int kBfOutCols = D < 64 ? D : 64;

// ---- asynchronous copies and tensor-core fragments (sm_80+ PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src-size 0, no
// byte read, src stays a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
// volatile, as the fragment loads are: each product stays beside its loads,
// so the compiler does not hoist a whole tile's fragments into registers.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a += t, four float32 adds (round to nearest)
__device__ __forceinline__ void add4(float (&a)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = a[i] + t[i];
}

// two bf16 in one register, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}
constexpr int kPPieces = 3;  // bf16 pieces of p in P.V
// A float32 x as the sum of NP bf16 pieces: x_0 = bf16(x), x_1 = bf16(x -
// x_0), ... (each difference is exact in float32; three pieces leave under
// 2^-26 |x|). pc[piece][i] is the pair (x0, x1)'s piece, register i of an
// A fragment.
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&pc)[NP][4], int i) {
#pragma unroll
  for (int piece = 0; piece < NP; ++piece) {
    const bf16 h0 = __float2bfloat16_rn(x0);
    const bf16 h1 = __float2bfloat16_rn(x1);
    pc[piece][i] = pack2(h0, h1);
    x0 -= __bfloat162float(h0);
    x1 -= __bfloat162float(h1);
  }
}

// Stage keys [k0, k0 + kKeys) of kv head hk of one of K or V into xs
// ([kKeys][D + pad] elements, pad = 16 bytes): every thread issues its
// share of 16-byte copies; keys beyond Sk are zero-filled.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_rows(T* xs, const T* __restrict__ x,
                                           int hk, int Sk, int Hkv, int k0,
                                           int tid) {
  constexpr int kEl = 16 / static_cast<int>(sizeof(T));  // per copy
  constexpr int kCpr = D / kEl;                          // copies per row
  constexpr int kStride = D + kEl;
  constexpr int kCopies = kKeys * kCpr;
#pragma unroll
  for (int i = 0; i < (kCopies + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (kCopies % NT != 0 && c >= kCopies) break;
    const int j = c / kCpr;
    const int e = (c % kCpr) * kEl;
    const int kp = k0 + j;
    const bool ok = kp < Sk;
    const size_t off =
        (static_cast<size_t>(ok ? kp : 0) * Hkv + hk) * D + e;
    cp_async16(xs + j * kStride + e, x + off, ok);
  }
}

// Stage keys [k0, k0 + kKeys) of kv head hk into ks ([kKeys][DK + pad]) and
// vs ([kKeys][DV + pad]). Equal widths share one loop over the copies.
template <typename T, int DK, int DV, int NT>
__device__ __forceinline__ void stage_tile(T* ks, T* vs,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v, int hk,
                                           int Sk, int Hkv, int k0, int tid) {
  if constexpr (DK != DV) {
    stage_rows<T, DK, NT>(ks, k, hk, Sk, Hkv, k0, tid);
    stage_rows<T, DV, NT>(vs, v, hk, Sk, Hkv, k0, tid);
  } else {
    constexpr int D = DK;
    constexpr int kEl = 16 / static_cast<int>(sizeof(T));  // per copy
    constexpr int kCpr = D / kEl;                          // copies per row
    constexpr int kStride = D + kEl;
    constexpr int kCopies = kKeys * kCpr;
#pragma unroll
    for (int i = 0; i < (kCopies + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (kCopies % NT != 0 && c >= kCopies) break;  // D = 8: half the block
      const int j = c / kCpr;
      const int e = (c % kCpr) * kEl;
      const int kp = k0 + j;
      const bool ok = kp < Sk;
      const size_t off =
          (static_cast<size_t>(ok ? kp : 0) * Hkv + hk) * D + e;
      cp_async16(ks + j * kStride + e, k + off, ok);
      cp_async16(vs + j * kStride + e, v + off, ok);
    }
  }
}

__device__ __forceinline__ bool key_ok(int qi, int kp, int Sk, int causal,
                                       int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && (qi >= kp);
  if (window) ok = ok && (qi - kp < window);
  return ok;
}

__device__ __forceinline__ int causal_tiles(int Sk, int causal, int q_end) {
  int n = (Sk + kKeys - 1) / kKeys;
  if (causal) n = min(n, (q_end - 1) / kKeys + 1);
  return n;
}

// ---------------------------------------------------------------- float32

template <int DK, int DV>
constexpr size_t f32_smem_bytes(int stages) {
  // q tile, the stages of K and V, the p strips
  return (static_cast<size_t>(kF32Rows) * (DK + 4) +
          stages * static_cast<size_t>(kKeys) * (DK + 4 + DV + 4) +
          static_cast<size_t>(kF32Rows) * (kKeys + 4)) *
         sizeof(float);
}
template <int DK, int DV>
constexpr int kF32Stages = f32_smem_bytes<DK, DV>(2) <= kMaxSmem ? 2 : 1;

// output columns a float32 thread holds: D / 16, and one at D = 8
template <int D>
constexpr int kCols = D < 16 ? 1 : D / 16;

// the output columns of lane tx: D / 16 of them, as float4 (D >= 64), a
// float2 (D = 32) or one float (D = 16), each group contiguous so the
// half-warp reads a V row in one sweep
template <int D>
__device__ __forceinline__ int out_col(int tx, int i) {
  if constexpr (D == 8) {
    return tx & 7;
  } else if constexpr (D == 16) {
    return tx;
  } else if constexpr (D == 32) {
    return 2 * tx + i;
  } else {
    return 64 * (i / 4) + 4 * tx + (i % 4);
  }
}

template <int D>
__device__ __forceinline__ void read_cols(const float* row, int tx,
                                          float (&o)[kCols<D>]) {
  if constexpr (D == 8) {
    o[0] = row[tx & 7];
  } else if constexpr (D == 16) {
    o[0] = row[tx];
  } else if constexpr (D == 32) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * tx);
    o[0] = t.x;
    o[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(row + 64 * g + 4 * tx);
      o[4 * g] = t.x;
      o[4 * g + 1] = t.y;
      o[4 * g + 2] = t.z;
      o[4 * g + 3] = t.w;
    }
  }
}

// DK: the head dim of q and k (the scores); DV: that of v and out
template <int DK, int DV>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int Sq,
                  int Sk, int Hq, int Hkv, int causal, int window,
                  float scale, int xb) {
  constexpr int kS = DK + 4;      // padded row of q and K
  constexpr int kSV = DV + 4;     // padded row of V
  constexpr int kPS = kKeys + 4;  // padded p strip
  constexpr int CW = kCols<DV>;   // output columns per thread
  constexpr int kStages = kF32Stages<DK, DV>;
  constexpr int kStage = kKeys * (kS + kSV);  // K and V of one stage
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kF32Rows][kS]
  float* kv0 = qs + kF32Rows * kS;  // kStages x (K [kKeys][kS], V [kKeys][kSV])
  float* ps = kv0 + kStages * kStage;  // [kF32Rows][kPS]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = 2 * (tid >> 4);  // this thread's rows r0, r0 + 1
  const int bx = blockIdx.x / xb;  // xb q tiles per batch row
  const int q0 = (blockIdx.x - bx * xb) * kF32Rows;
  // the batch row as a pointer offset: no index register lives on
  q += static_cast<size_t>(bx) * Sq * Hq * DK;
  out += static_cast<size_t>(bx) * Sq * Hq * DV;
  k += static_cast<size_t>(bx) * Sk * Hkv * DK;
  v += static_cast<size_t>(bx) * Sk * Hkv * DV;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int n_tiles = causal_tiles(Sk, causal, min(q0 + kF32Rows, Sq));

  stage_tile<float, DK, DV, kF32Threads>(kv0, kv0 + kKeys * kS, k, v, hk, Sk,
                                         Hkv, 0, tid);
  cp_async_commit();
  // the q tile, scaled as the reference scales q; rows beyond Sq are zeros
  for (int c = tid; c < kF32Rows * DK / 4; c += kF32Threads) {
    const int r = c / (DK / 4);
    const int e = (c % (DK / 4)) * 4;
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < Sq) {
      t = *reinterpret_cast<const float4*>(
          q + (static_cast<size_t>(q0 + r) * Hq + h) * DK + e);
      t.x *= scale;
      t.y *= scale;
      t.z *= scale;
      t.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * kS + e) = t;
  }

  float acc[2][CW];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[r][i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (kStages == 2 && t + 1 < n_tiles) {
      float* nk = kv0 + ((t + 1) & 1) * kStage;
      stage_tile<float, DK, DV, kF32Threads>(nk, nk + kKeys * kS, k, v, hk,
                                             Sk, Hkv, (t + 1) * kKeys, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (kStages == 1 && t > 0) {  // the one buffer is free again
        stage_tile<float, DK, DV, kF32Threads>(kv0, kv0 + kKeys * kS, k, v,
                                               hk, Sk, Hkv, t * kKeys, tid);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, the q tile) is in place
    const float* ks = kv0 + (kStages == 2 ? (t & 1) : 0) * kStage;
    const float* vs = ks + kKeys * kS;
    const int k0 = t * kKeys;

    // a 2 x 4 register tile of scores: rows r0, r0 + 1, keys tx + 16c
    float s[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[0][c] = s[1][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + r0 * kS + d);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + (r0 + 1) * kS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * kS + d);
        s[0][c] = s[0][c] + qa.x * kk.x;
        s[0][c] = s[0][c] + qa.y * kk.y;
        s[0][c] = s[0][c] + qa.z * kk.z;
        s[0][c] = s[0][c] + qa.w * kk.w;
        s[1][c] = s[1][c] + qb.x * kk.x;
        s[1][c] = s[1][c] + qb.y * kk.y;
        s[1][c] = s[1][c] + qb.z * kk.z;
        s[1][c] = s[1][c] + qb.w * kk.w;
      }
    }

    // mask and running max; a row's 64 keys are spread over the 16 lanes of
    // its half-warp (a max is exact in any order)
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + r;
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!key_ok(qi, k0 + tx + 16 * c, Sk, causal, window)) {
          s[r][c] = kNegInf;
        }
        mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_new = fmaxf(m[r], mt);
      corr[r] = expf(m[r] - m_new);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ps[(r0 + r) * kPS + tx + 16 * c] = expf(s[r][c] - m_new);
      }
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[r][i] = acc[r][i] * corr[r];
    }
    __syncwarp();  // the half-warp's p strips are written

    // acc += p . v and the row sums of p, both in ascending key order
    float psum[2] = {0.0f, 0.0f};
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + r0 * kPS + j);
      const float4 pb =
          *reinterpret_cast<const float4*>(ps + (r0 + 1) * kPS + j);
      const float pav[4] = {pa.x, pa.y, pa.z, pa.w};
      const float pbv[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CW];
        read_cols<DV>(vs + (j + u) * kSV, tx, vv);
        psum[0] = psum[0] + pav[u];
        psum[1] = psum[1] + pbv[u];
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          acc[0][i] = acc[0][i] + pav[u] * vv[i];
          acc[1][i] = acc[1][i] + pbv[u] * vv[i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
    __syncthreads();  // every thread is done with this stage and its strip
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + r;
    if (qi < Sq && (DV >= 16 || tx < DV)) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* orow = out + (static_cast<size_t>(qi) * Hq + h) * DV;
#pragma unroll
      for (int i = 0; i < CW; ++i) orow[out_col<DV>(tx, i)] = acc[r][i] / denom;
    }
  }
}

// ---------------------------------------------------------------- bfloat16

template <int DK, int DV, int NQ>
constexpr size_t bf16_smem_bytes(int stages) {
  // NQ bf16 pieces of the q tile, the stages of K and V
  return (static_cast<size_t>(NQ) * kBfRows * (DK + 8) +
          static_cast<size_t>(stages) * kKeys * (DK + 8 + DV + 8)) *
         sizeof(bf16);
}
template <int DK, int DV, int NQ>
constexpr int kBfStages = bf16_smem_bytes<DK, DV, NQ>(2) <= kMaxSmem ? 2 : 1;

// NQ = 1: the scale is a power of two and bf16(q * scale) is exact. NQ = 3:
// float32 q * scale is held as the sum of three bf16 pieces (24 bits). DK:
// the head dim of q and k; DV: that of v and out.
template <int DK, int DV, int NQ>
__global__ void __launch_bounds__(kBfThreads)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int window,
                   float scale, int xb) {
  constexpr int kS = DK + 8;   // padded row of q and K (16 bytes)
  constexpr int kSV = DV + 8;  // padded row of V
  constexpr int KD = DK / 16;  // k-steps of Q.K^T over DK
  constexpr int DVB = kBfOutCols<DV>;  // output columns of this block
  constexpr int ND = DVB / 8;          // their n-tiles
  constexpr int kStages = kBfStages<DK, DV, NQ>;
  constexpr int kStage = kKeys * (kS + kSV);  // K and V of one stage
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // NQ x [kBfRows][kS]
  // kStages x (K [kKeys][kS], V [kKeys][kSV])
  bf16* kv0 = qs + NQ * kBfRows * kS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int tq = lane & 3;  // accumulator columns 2 tq, 2 tq + 1
  const int bx = blockIdx.x / xb;  // xb = q tiles x column groups per row
  const int xi = blockIdx.x - bx * xb;
  // the batch row as a pointer offset: no index register lives on
  q += static_cast<size_t>(bx) * Sq * Hq * DK;
  out += static_cast<size_t>(bx) * Sq * Hq * DV;
  k += static_cast<size_t>(bx) * Sk * Hkv * DK;
  v += static_cast<size_t>(bx) * Sk * Hkv * DV;
  const int q0 = xi / (DV / DVB) * kBfRows;
  const int c0 = xi % (DV / DVB) * DVB;  // first output column
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int n_tiles = causal_tiles(Sk, causal, min(q0 + kBfRows, Sq));

  stage_tile<bf16, DK, DV, kBfThreads>(kv0, kv0 + kKeys * kS, k, v, hk, Sk,
                                       Hkv, 0, tid);
  cp_async_commit();

  // the q tile, scaled in float32 as the reference scales q, as NQ bf16
  // pieces; rows beyond Sq are zeros
  for (int c = tid; c < kBfRows * DK / 8; c += kBfThreads) {
    const int r = c / (DK / 8);
    const int e = (c % (DK / 8)) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) {
      raw = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(q0 + r) * Hq + h) * DK + e);
    }
    // a bf16 is the high half of a float32
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    float rest[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rest[2 * i] = __uint_as_float(in[i] << 16) * scale;
      rest[2 * i + 1] = __uint_as_float(in[i] & 0xffff0000u) * scale;
    }
#pragma unroll
    for (int piece = 0; piece < NQ; ++piece) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16 h0 = __float2bfloat16_rn(rest[2 * i]);
        const bf16 h1 = __float2bfloat16_rn(rest[2 * i + 1]);
        w[i] = pack2(h0, h1);
        rest[2 * i] -= __bfloat162float(h0);
        rest[2 * i + 1] -= __bfloat162float(h1);
      }
      *reinterpret_cast<uint4*>(qs + (piece * kBfRows + r) * kS + e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const int ra = q0 + warp * 16 + g;  // this lane's accumulator rows
  const int rb = ra + 8;
  const bf16* qw = qs + warp * 16 * kS;  // this warp's 16 rows

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // rows ra, rb
  float l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    if (kStages == 2 && t + 1 < n_tiles) {
      bf16* nk = kv0 + ((t + 1) & 1) * kStage;
      stage_tile<bf16, DK, DV, kBfThreads>(nk, nk + kKeys * kS, k, v, hk, Sk,
                                           Hkv, (t + 1) * kKeys, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (kStages == 1 && t > 0) {  // the one buffer is free again
        stage_tile<bf16, DK, DV, kBfThreads>(kv0, kv0 + kKeys * kS, k, v,
                                             hk, Sk, Hkv, t * kKeys, tid);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv0 + (kStages == 2 ? (t & 1) : 0) * kStage;
    const bf16* vs = ks + kKeys * kS;
    const int k0 = t * kKeys;

    // s = q . k^T: 8 n-tiles of 8 keys. Per k-step, ldmatrix x4 gives the A
    // fragment of each q piece (rows 0..15, columns 16 kk + 0..15) and the B
    // fragments of two n-tiles (keys 16 np + 0..15)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll 1
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[NQ][4];
#pragma unroll
      for (int piece = 0; piece < NQ; ++piece) {
        const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = 16 * kk + ((lane >> 4) << 3);
        ldmatrix_x4(qf[piece], qw + (piece * kBfRows + row) * kS + col);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        const int col = 16 * kk + (((lane >> 3) & 1) << 3);
        ldmatrix_x4(bk, ks + key * kS + col);
        float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int piece = NQ - 1; piece >= 0; --piece) {
          mma_bf16(t0, qf[piece], bk[0], bk[1]);
          mma_bf16(t1, qf[piece], bk[2], bk[3]);
        }
        add4(s[2 * np], t0);
        add4(s[2 * np + 1], t1);
      }
    }

    // mask, online-softmax update; a row's keys are spread over the four
    // lanes of its quad
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? ra : rb;
        const int kp = k0 + 8 * n + 2 * tq + (e & 1);
        if (!key_ok(qi, kp, Sk, causal, window)) s[n][e] = kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    }
    float corr[2];
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        psum[e >> 1] = psum[e >> 1] + s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] = psum[r] + __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] = psum[r] + __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p . v, 16 keys per k-step, p as kPPieces bf16 pieces
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the score accumulators of n-tiles 2 kk and 2 kk + 1 are the A
      // fragment: rows g / g + 8, keys 2 tq, + 1 and 8 + 2 tq, + 1
      uint32_t pf[kPPieces][4];
      split_pair(s[2 * kk][0], s[2 * kk][1], pf, 0);
      split_pair(s[2 * kk][2], s[2 * kk][3], pf, 1);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], pf, 2);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], pf, 3);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bv[4];
        const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = c0 + 16 * dp + ((lane >> 4) << 3);
        ldmatrix_x4_trans(bv, vs + key * kSV + col);
        float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int piece = kPPieces - 1; piece >= 0; --piece) {
          mma_bf16(t0, pf[piece], bv[0], bv[1]);
          mma_bf16(t1, pf[piece], bv[2], bv[3]);
        }
        add4(o[2 * dp], t0);
        add4(o[2 * dp + 1], t1);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  const float da = fmaxf(l[0], 1e-30f);
  const float db = fmaxf(l[1], 1e-30f);
  uint32_t* oa = reinterpret_cast<uint32_t*>(
      out + (static_cast<size_t>(ra) * Hq + h) * DV + c0);
  uint32_t* ob = reinterpret_cast<uint32_t*>(
      out + (static_cast<size_t>(rb) * Hq + h) * DV + c0);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (ra < Sq) oa[4 * n + tq] = pack_bf16(o[n][0] / da, o[n][1] / da);
    if (rb < Sq) ob[4 * n + tq] = pack_bf16(o[n][2] / db, o[n][3] / db);
  }
}

// ---------------------------------------------------------------- launch

constexpr int kMaxDevices = 64;
constexpr long long kMaxGridX = 2147483647;  // grid.x limit (grid.y: 65,535)

// Allow `bytes` of dynamic shared memory for `kernel` on the current device,
// once: the attribute belongs to the device that is current when it is set.
// done[] is the instantiation's own per-device flag.
template <typename Kernel>
int set_smem_once(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

template <int DK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int Hq, int Hkv, int causal, int window,
               float scale, cudaStream_t s) {
  constexpr size_t smem = f32_smem_bytes<DK, DV>(kF32Stages<DK, DV>);
  static_assert(smem <= kMaxSmem, "float32 tile fits in shared memory");
  static bool done[kMaxDevices] = {};
  const int attr = set_smem_once(flash_fwd_f32<DK, DV>, smem, done);
  if (attr != 0) return attr;
  const long long xb = (Sq + kF32Rows - 1) / kF32Rows;
  if (xb * B > kMaxGridX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(xb * B), Hq, 1);
  flash_fwd_f32<DK, DV><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq, Hkv,
      causal, window, scale, static_cast<int>(xb));
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV, int NQ>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                float scale, cudaStream_t s) {
  constexpr size_t smem =
      bf16_smem_bytes<DK, DV, NQ>(kBfStages<DK, DV, NQ>);
  static_assert(smem <= kMaxSmem, "bfloat16 tile fits in shared memory");
  static bool done[kMaxDevices] = {};
  const int attr = set_smem_once(flash_fwd_bf16<DK, DV, NQ>, smem, done);
  if (attr != 0) return attr;
  const long long xb = static_cast<long long>((Sq + kBfRows - 1) / kBfRows) *
                       (DV / kBfOutCols<DV>);
  if (xb * B > kMaxGridX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(xb * B), Hq, 1);
  flash_fwd_bf16<DK, DV, NQ><<<grid, kBfThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, Hq, Hkv,
      causal, window, scale, static_cast<int>(xb));
  return static_cast<int>(cudaGetLastError());
}

// the bfloat16 body needs whole 16-wide k-steps over DK and n-tile pairs
// over DV
template <int DK, int DV>
constexpr bool kBfBuilt = DK % 16 == 0 && DV % 16 == 0;

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           float scale, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    return launch_f32<DK, DV>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                              window, scale, s);
  }
  if constexpr (!kBfBuilt<DK, DV>) {
    if (dtype == 1) return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == 1) {
    int e2 = 0;
    if (std::frexp(scale, &e2) == 0.5f) {  // a power of two
      return launch_bf16<DK, DV, 1>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                                    window, scale, s);
    }
    return launch_bf16<DK, DV, 3>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                                  window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Whether a launch takes head dims (D of q and k, Dv of v and out) in dtype
// (0 float32, 1 bfloat16): the kernel is instantiated per pair.
int flash_head_dim_ok(int D, int Dv, int dtype) {
  if (D == Dv) {
    if (D == 8) return dtype == 0;
    return D == 16 || D == 32 || D == 64 || D == 128 || D == 256;
  }
  if (D == 192 && Dv == 128) return 1;
  if (D == 24 && Dv == 16) return dtype == 0;
  return 0;
}

// q [B, Sq, Hq, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, Dv], out [B, Sq, Hq,
// Dv], all contiguous, 16-byte aligned and of one dtype (code 0 float32, 1
// bfloat16). window 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int D, int Dv, int causal, int window, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (addr_bits % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (Hq > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
#define FLASH_PAIR(DK, DV)                                                  \
  if (D == DK && Dv == DV) {                                                \
    return launch<DK, DV>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, \
                          scale, dtype, s);                                 \
  }
  FLASH_PAIR(8, 8)
  FLASH_PAIR(16, 16)
  FLASH_PAIR(32, 32)
  FLASH_PAIR(64, 64)
  FLASH_PAIR(128, 128)
  FLASH_PAIR(256, 256)
  FLASH_PAIR(192, 128)
  FLASH_PAIR(24, 16)
#undef FLASH_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
