// The server's Eq. 6 aggregate, in two entry points over three variants of
// one product, and a third entry with the fused one's normalize stage alone.
//
// repro_fused_relevance_aggregate replaces the Pallas TPU kernel
// src/repro/kernels/relevance_aggregate.py:fused_relevance_aggregate
// (_fused_kernel), Eq. 5 -> 6 in column-block form:
//
//   Wm = where(i == j, 0, W)          (no self-relevance; junk, even NaN,
//                                      on the diagonal never leaks)
//   Wn = where(rowsum(Wm) > 0, Wm / rowsum(Wm), 0)   (zero rows stay zero)
//   B  = Wn[:, lo:hi] @ Theta         (fp32 sums)
//
// with W (C, C) raw decayed relevance and Theta (hi - lo, P) the client
// parameters of rows lo..hi, both fp32; outputs B (C, P) and the whole Wn
// (C, C) fp32. At lo = 0, hi = C it is the stacked round's fused tail (B =
// Wn @ Theta); on the sharded engine each rank passes its own row block of
// Theta and gets its partial product, which a reduce-scatter sums. Every
// launch normalizes the whole W, as the Pallas kernel recomputes
// _normalized_w in every grid step, so Wn never waits on another launch.
//
// repro_relevance_aggregate replaces
// src/repro/kernels/relevance_aggregate.py:relevance_aggregate
// (_agg_kernel), the plain product B = W @ Theta with W (R, C) already
// normalized, B (R, P): on the host server the rows of clients with
// relevant neighbours (R <= C).
//
// repro_normalize_relevance is the fused entry's first stage alone (W ->
// Wn), with no main-path caller: the fused entry's Wn bit for bit.
//
// What bounds them on an H100: B does 2 R C P FLOPs over about 4 (R + C) P
// bytes, about R / 4 FLOP per byte at R = C, against the card's fp32 ridge
// of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B. So the round's shapes (C = 5, R
// <= 5, P = 37696) are bytes (1.5 MB, 0.45 us), in practice one launch's
// latency; above C ~ 80 it is fp32 FMAs: 1.72 ms at C = 1000, P = 57664.
// The ground rule is IEEE fp32 (no TF32), so the FMA pipes, not the tensor
// cores, set that floor. Every variant sums each output by fp32 FMAs in
// ascending k from 0.
//
// Variants (chosen by _plan in relevance_aggregate.py; both entries take
// all three; for the fused entry R is W's C and the contraction hi - lo):
//   skinny  R, C <= SKINNY_MAX_C (32), Theta 16-byte aligned, P % 4 == 0:
//           one launch streams Theta with float4 loads; a thread keeps the
//           8 x 4 outputs of its 8 rows and 4 columns in registers, each
//           group of 8 rows a block of its own (Theta from L2 after the
//           first), its rows' weights k-major in shared memory. The fused
//           entry's blocks each normalize the tiny W in shared memory, as
//           the Pallas kernel recomputes _normalized_w in every grid step;
//           block 0 writes Wn, and the k loop reads Wn's columns lo..hi.
//           One launch where the tile takes three: it beat the tile at
//           every C <= 32 on the card.
//   tiled   larger C, aligned: a prologue writes the rows of W k-major, WT
//           (C, ld) with ld = R rounded up to 4, into the caller's scratch
//           (the fused entry first normalizes W into Wn, one block a row,
//           then transposes Wn's columns lo..hi in place: Wn + lo, row
//           stride C). The product runs 128 x 128 output tiles,
//           256 threads each holding an 8 x 8 block in registers, read as
//           two float4 halves 64 apart in rows and in columns (a warp's
//           loads hit no bank twice): per k a thread issues 4 LDS.128 for
//           64 FFMAs. Operand tiles of 32 k by 128 rows of WT and of Theta
//           arrive by TMA (zeros past R, C and P, so only the stores are
//           masked) into a ring of 3 stages completing on mbarriers; the
//           warps release a stage on an "empty" mbarrier, and thread 0
//           refills the stage of the step before the one it just left, so
//           it seldom waits. Two blocks fit on an SM (at most 128
//           registers, 96 KB of shared memory each). Blocks run the row
//           tiles of one 128-column slab of Theta next to each other, so
//           the slab (512 KB at C = 1000) comes from HBM about once and from
//           L2 for the other row tiles; WT (4 MB) stays in the 50 MB L2.
//           It runs at ~74% of the FMA bound at C = 1000: 5% is the
//           1024-row padding of 1000 rows and the last of 14 waves; the
//           rest is not split by any tool on the card (no profiler of
//           stalls). Per k a warp's 4 LDS.128 ask as many shared-memory
//           cycles as its 64 FFMAs ask FMA cycles, if the card serves them
//           by quarter-warps; larger thread blocks (16 x 8, 8 x 16), 16 or
//           8 k a stage and full unrolling all ran slower there.
//   ragged  P % 4 != 0 or a Theta base off 16 bytes, where no TMA map can
//           be encoded: the same tile fed by 4-byte cp.async (zero-filled
//           past the edges) in the same ring, one __syncthreads a stage.
#include "sm90_common.cuh"

namespace {

enum Variant { kSkinny = 0, kTiled = 1, kRagged = 2 };

constexpr int kTM = 128;             // output rows (clients) per tile
constexpr int kTN = 128;             // output columns (parameters) per tile
constexpr int kTK = 32;              // contraction (source clients) a stage
constexpr int kStages = 3;
constexpr int kUnroll = 16;          // k steps the TMA tile unrolls
constexpr int kMA = 2;               // float4 row groups a thread holds
constexpr int kNB = 2;               // float4 column groups a thread holds
constexpr int kMinBlocks = 2;        // blocks an SM holds
constexpr int kRowT = 32 / kMA;      // threads down a tile
constexpr int kColT = 32 / kNB;      // threads across a tile
constexpr int kThreads = kRowT * kColT;
constexpr int kAM = 4 * kMA, kBN = 4 * kNB;   // a thread's outputs
constexpr int kRowGap = kTM / kMA, kColGap = kTN / kNB;
constexpr int kTileFloats = kTK * kTM;              // one operand's tile
constexpr int kStageBytes = 2 * kTileFloats * 4;    // WT tile, Theta tile
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kSmemBytes = kRingBytes + 16 * kStages + 128;  // + bars, align
constexpr int kPrepThreads = 256;    // the prologue's blocks
constexpr int kSkinnyThreads = 128;   // a float4 column of B a thread
constexpr int kSkinnyRows = 8;        // rows of B a thread keeps
constexpr int kSkinnyMaxC = 32;

// ---------------------------------------------------------------------------
// the tile: 8 x 8 outputs a thread, rows {4 ty .. 4 ty + 3, 64 + 4 ty ..}
// and columns {4 tx .., 64 + 4 tx ..} of the block's 128 x 128
// ---------------------------------------------------------------------------

// one stage: as (kTK x kTM, k-major rows of W), bs (kTK x kTN of Theta),
// unrolled kU steps at a time
template <int kU>
__device__ __forceinline__ void mma_stage(const float* as, const float* bs,
                                          int ty, int tx,
                                          float (&acc)[kAM][kBN]) {
#pragma unroll 1
  for (int k0 = 0; k0 < kTK; k0 += kU) {
#pragma unroll
    for (int k = k0; k < k0 + kU; ++k) {
      float a[kAM], b[kBN];
#pragma unroll
      for (int m = 0; m < kMA; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + k * kTM + m * kRowGap + 4 * ty);
        a[4 * m] = v.x, a[4 * m + 1] = v.y, a[4 * m + 2] = v.z,
        a[4 * m + 3] = v.w;
      }
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + k * kTN + n * kColGap + 4 * tx);
        b[4 * n] = v.x, b[4 * n + 1] = v.y, b[4 * n + 2] = v.z,
        b[4 * n + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kAM; ++i)
#pragma unroll
        for (int j = 0; j < kBN; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ b,
                                           const float (&acc)[kAM][kBN],
                                           int r0, long long p0, int ty,
                                           int tx, int R, long long P) {
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
#pragma unroll
  for (int i = 0; i < kAM; ++i) {
    const int row = r0 + (i / 4) * kRowGap + 4 * ty + i % 4;
    if (row >= R) continue;
    float* o = b + (size_t)row * P;
#pragma unroll
    for (int h = 0; h < kNB; ++h) {
      const long long col = p0 + h * kColGap + 4 * tx;
      if (vec && col + 3 < P) {
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < P) o[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

// the block's tile: row tiles of one column slab are neighbours in launch
// order
__device__ __forceinline__ void tile_origin(int R, int& r0, long long& p0) {
  const int row_tiles = (R + kTM - 1) / kTM;
  r0 = (int)(blockIdx.x % row_tiles) * kTM;
  p0 = (long long)(blockIdx.x / row_tiles) * kTN;
}

__device__ __forceinline__ void thread_coords(int& ty, int& tx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ty = (warp / (kColT / 8)) * 4 + lane / 8;   // a warp: 4 thread rows x 8
  tx = (warp % (kColT / 8)) * 8 + lane % 8;   // thread columns
}

// stage kt of the k loop: WT's tile, then Theta's, completing on bar
__device__ __forceinline__ void issue_stage(const CUtensorMap* ta,
                                            const CUtensorMap* tt,
                                            uint32_t dst, uint32_t bar,
                                            int r0, long long p0, int kt) {
  mbar_expect_tx(bar, kStageBytes);
  tma_load(dst, ta, bar, r0, kt * kTK, 0);
  tma_load(dst + kTileFloats * 4, tt, bar, (int)p0, kt * kTK, 0);
}

// the tiled variant: ta the map of WT (R columns, C rows), tt of Theta (P
// columns, C rows), both boxes kTM x kTK
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_tma_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tt,
                float* __restrict__ b, int R, int C, long long P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (128u - (raw & 127u)) & 127u;  // TMA: 128-byte dst
  const float* ring = reinterpret_cast<const float*>(smem_raw + pad);
  const uint32_t base = raw + pad;
  const uint32_t full = base + kRingBytes, empty = full + 8 * kStages;
  int r0, ty, tx;
  long long p0;
  tile_origin(R, r0, p0);
  thread_coords(ty, tx);
  const int nk = (C + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < nk; ++s)
      issue_stage(&ta, &tt, base + s * kStageBytes, full + 8 * s, r0, p0, s);
  }
  __syncthreads();

  float acc[kAM][kBN];
#pragma unroll
  for (int i = 0; i < kAM; ++i)
#pragma unroll
    for (int j = 0; j < kBN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const float* st = ring + s * (kStageBytes / 4);
    mma_stage<kUnroll>(st, st + kTileFloats, ty, tx, acc);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * s);
    // thread 0 refills the stage of step kt - 1, which the other warps have
    // most likely left by now, with step kt - 1 + kStages
    const int old = kt - 1, next = old + kStages;
    if (threadIdx.x == 0 && old >= 0 && next < nk) {
      const int so = old % kStages;
      mbar_wait(empty + 8 * so, (old / kStages) & 1);
      issue_stage(&ta, &tt, base + so * kStageBytes, full + 8 * so, r0, p0,
                  next);
    }
  }
  store_tile(b, acc, r0, p0, ty, tx, R, P);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// stage kt of the k loop by 4-byte copies, zeros past R, C and P
__device__ __forceinline__ void load_stage(const float* __restrict__ wt,
                                           int ld,
                                           const float* __restrict__ theta,
                                           uint32_t dst, int r0, long long p0,
                                           int kt, int R, int C, long long P) {
#pragma unroll 4
  for (int e = threadIdx.x; e < 2 * kTileFloats; e += kThreads) {
    const int k = (e % kTileFloats) / kTM, c = e % kTM;
    const int kk = kt * kTK + k;
    if (e < kTileFloats) {
      const bool ok = kk < C && r0 + c < R;
      cp_async4(dst + 4 * e, ok ? wt + (size_t)kk * ld + r0 + c : wt, ok);
    } else {
      const bool ok = kk < C && p0 + c < P;
      cp_async4(dst + 4 * e, ok ? theta + (size_t)kk * P + p0 + c : theta,
                ok);
    }
  }
}

// the ragged variant: the tile of the tiled one, its stages filled by
// 4-byte cp.async (zeros past R, C and P)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_ragged_kernel(const float* __restrict__ wt, int ld,
                   const float* __restrict__ theta, float* __restrict__ b,
                   int R, int C, long long P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (128u - (raw & 127u)) & 127u;
  const float* ring = reinterpret_cast<const float*>(smem_raw + pad);
  const uint32_t base = raw + pad;
  int r0, ty, tx;
  long long p0;
  tile_origin(R, r0, p0);
  thread_coords(ty, tx);
  const int nk = (C + kTK - 1) / kTK;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(wt, ld, theta, base + s * kStageBytes, r0, p0, s, R, C, P);
    cp_async_commit();
  }

  float acc[kAM][kBN];
#pragma unroll
  for (int i = 0; i < kAM; ++i)
#pragma unroll
    for (int j = 0; j < kBN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();                 // stage kt landed; kt - 1's is free
    const float* st = ring + (kt % kStages) * (kStageBytes / 4);
    mma_stage<kTK>(st, st + kTileFloats, ty, tx, acc);
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage(wt, ld, theta, base + (next % kStages) * kStageBytes, r0,
                 p0, next, R, C, P);
    cp_async_commit();
  }
  store_tile(b, acc, r0, p0, ty, tx, R, P);
}

// the sum of x over the warp, in every lane: an xor tree (the order of the
// normalizations' row sums, so every variant's Wn is the same)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// the tile's prologue: the fused entry's W (C, C) raw -> Wn, then (both
// entries) W's rows (R, C) -> WT (C, ld) k-major
// ---------------------------------------------------------------------------

// one block a row: the diagonal replaced by 0 (a select, as the TPU
// kernel's `where`), the row sum reduced in the block (each thread's
// strided sum, then each warp's xor tree, then the warps' partials in
// order), each entry divided by it with a correctly rounded __fdiv_rn; a
// row whose sum is not > 0 (all zero, or NaN off the diagonal) is written
// as zeros
__global__ void __launch_bounds__(kPrepThreads)
normalize_kernel(const float* __restrict__ w, float* __restrict__ wn, int C) {
  __shared__ float partial[kPrepThreads / 32];
  __shared__ float total;
  const int i = blockIdx.x;
  const float* wr = w + (size_t)i * C;
  float s = 0.f;
  for (int j = threadIdx.x; j < C; j += kPrepThreads)
    s += (j == i) ? 0.f : wr[j];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < kPrepThreads / 32; ++k) t += partial[k];
    total = t;
  }
  __syncthreads();
  const float rows = total;
  const bool pos = rows > 0.f;  // false for 0 and for NaN
  float* out = wn + (size_t)i * C;
  for (int j = threadIdx.x; j < C; j += kPrepThreads)
    out[j] = (pos && j != i) ? __fdiv_rn(wr[j], rows) : 0.f;
}

// a 32 x 32 block of w (R, C; row stride ldw) -> its transpose in wt (C,
// ld): both sides coalesced through shared memory
__global__ void __launch_bounds__(kPrepThreads)
transpose_kernel(const float* __restrict__ w, float* __restrict__ wt, int R,
                 int C, int ldw, int ld) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += kPrepThreads / 32)
    if (r0 + i < R && j0 + tx < C)
      tile[i][tx] = w[(size_t)(r0 + i) * ldw + j0 + tx];
  __syncthreads();
  for (int i = ty; i < 32; i += kPrepThreads / 32)
    if (j0 + i < C && r0 + tx < R)
      wt[(size_t)(j0 + i) * ld + r0 + tx] = tile[tx][i];
}

int run_transpose(const float* w, float* wt, int R, int C, int ldw, int ld,
                  cudaStream_t s) {
  const dim3 grid((C + 31) / 32, (R + 31) / 32);
  transpose_kernel<<<grid, kPrepThreads, 0, s>>>(w, wt, R, C, ldw, ld);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the skinny variant
// ---------------------------------------------------------------------------

// block g * groups + h: rows [8 h, 8 h + 8) of B, columns [512 g, 512 g +
// 512): the row groups of one column block are neighbours, so they share
// its Theta in L2. w is (R, C); the product contracts its columns lo ..
// lo + K against Theta's K rows (the plain entry: lo = 0, K = C)
template <bool kFused>
__global__ void __launch_bounds__(kSkinnyThreads)
skinny_kernel(const float* __restrict__ w, const float4* __restrict__ theta,
              float4* __restrict__ b, float* __restrict__ wn, int R, int C,
              int lo, int K, long long P4) {
  __shared__ float ws[kSkinnyMaxC * kSkinnyMaxC];
  __shared__ __align__(16) float wk[kSkinnyMaxC][kSkinnyRows];  // k-major
  const int groups = (R + kSkinnyRows - 1) / kSkinnyRows;
  const int r0 = (int)(blockIdx.x % groups) * kSkinnyRows;
  const long long q =
      (long long)(blockIdx.x / groups) * kSkinnyThreads + threadIdx.x;
  for (int e = threadIdx.x; e < R * C; e += kSkinnyThreads) ws[e] = w[e];
  __syncthreads();
  if (kFused) {              // R = C: warp w, rows w, w + 4, ...; lane j
    const int lane = threadIdx.x % 32;
    for (int i = threadIdx.x / 32; i < R; i += kSkinnyThreads / 32) {
      const float v = (lane < C && lane != i) ? ws[i * C + lane] : 0.f;
      const float s = warp_sum(v);            // normalize_kernel's order
      const bool pos = s > 0.f;               // false for 0 and for NaN
      if (lane < C) {
        const float x = pos ? __fdiv_rn(v, s) : 0.f;
        ws[i * C + lane] = x;
        if (blockIdx.x == 0) wn[i * C + lane] = x;
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < K * kSkinnyRows; e += kSkinnyThreads) {
    const int k = e / kSkinnyRows, r = e % kSkinnyRows;
    wk[k][r] = r0 + r < R ? ws[(r0 + r) * C + lo + k] : 0.f;
  }
  __syncthreads();
  if (q >= P4) return;
  float4 acc[kSkinnyRows];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 t = __ldg(theta + (size_t)k * P4 + q);
    const float4 a0 = *reinterpret_cast<const float4*>(&wk[k][0]);
    const float4 a1 = *reinterpret_cast<const float4*>(&wk[k][4]);
    const float a[kSkinnyRows] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < kSkinnyRows; ++r) {
      acc[r].x = fmaf(a[r], t.x, acc[r].x);
      acc[r].y = fmaf(a[r], t.y, acc[r].y);
      acc[r].z = fmaf(a[r], t.z, acc[r].z);
      acc[r].w = fmaf(a[r], t.w, acc[r].w);
    }
  }
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
    if (r0 + r < R) b[(size_t)(r0 + r) * P4 + q] = acc[r];
}

template <bool kFused>
int run_skinny(const float* w, const float* theta, float* b, float* wn,
               int R, int C, int lo, int K, long long P, long long grid,
               cudaStream_t s) {
  if (C > kSkinnyMaxC || R > kSkinnyMaxC || P % 4 ||
      reinterpret_cast<uintptr_t>(theta) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  skinny_kernel<kFused><<<(unsigned)grid, kSkinnyThreads, 0, s>>>(
      w, reinterpret_cast<const float4*>(theta), reinterpret_cast<float4*>(b),
      wn, R, C, lo, K, P / 4);
  return (int)cudaGetLastError();
}

// the tiled or ragged product from WT (C, ld) already in scratch
int run_tile(int variant, const float* wt, int ld, const float* theta,
             float* b, int R, int C, long long P, long long grid,
             cudaStream_t s) {
  if (grid == 0) return 0;
  if (variant == kTiled) {
    CUtensorMap ta, tt;
    if (int rc = make_map_2d(&ta, wt, R, C, ld, kTM, kTK)) return rc;
    if (int rc = make_map_2d(&tt, theta, P, C, P, kTN, kTK)) return rc;
    if (cudaError_t rc = cudaFuncSetAttribute(
            tile_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kSmemBytes))
      return (int)rc;
    tile_tma_kernel<<<(unsigned)grid, kThreads, kSmemBytes, s>>>(ta, tt, b,
                                                                  R, C, P);
  } else {
    if (cudaError_t rc = cudaFuncSetAttribute(
            tile_ragged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kSmemBytes))
      return (int)rc;
    tile_ragged_kernel<<<(unsigned)grid, kThreads, kSmemBytes, s>>>(
        wt, ld, theta, b, R, C, P);
  }
  return (int)cudaGetLastError();
}

bool bad_plan(int variant, int R, int C, long long P, int ld,
              long long grid) {
  return R < 1 || C < 0 || P < 0 || grid < 0 || grid >= (1ll << 31) ||
         (variant == kTiled && C < 1) ||
         (variant != kSkinny && (ld < R || ld % 4)) ||
         (variant != kSkinny && variant != kTiled && variant != kRagged);
}

}  // namespace

// w (C, C) raw relevance, theta (hi - lo, P) the rows lo..hi of the client
// parameters, b (C, P) = Wn[:, lo:hi] @ theta, wn (C, C) the whole Wn; wt
// the scratch (hi - lo, ld) of the tiled and ragged variants (ld = C
// rounded up to 4; null for the skinny one); all fp32, contiguous, on the
// current device; 0 <= lo < hi <= C. variant and grid (blocks of the
// product) as _plan(C, hi - lo, P) gives them. B is bit for bit the plain
// entry's on the sliced Wn (the same product, fp32 FMAs in ascending k
// from lo), Wn repro_normalize_relevance's. Returns cudaGetLastError()
// after the last launch (cudaErrorInvalidValue for a plan or a block the
// operands do not allow).
extern "C" int repro_fused_relevance_aggregate(const void* w,
                                               const void* theta, void* b,
                                               void* wn, void* wt, int C,
                                               int lo, int hi, long long P,
                                               int variant, int ld,
                                               long long grid,
                                               void* stream) {
  if (C == 0) return 0;
  if (lo < 0 || hi <= lo || hi > C) return (int)cudaErrorInvalidValue;
  const int K = hi - lo;
  if (bad_plan(variant, C, K, P, ld, grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kSkinny)
    return run_skinny<true>((const float*)w, (const float*)theta, (float*)b,
                            (float*)wn, C, C, lo, K, P, grid, s);
  normalize_kernel<<<C, kPrepThreads, 0, s>>>((const float*)w, (float*)wn, C);
  if (int err = (int)cudaGetLastError()) return err;
  if (int err = run_transpose((const float*)wn + lo, (float*)wt, C, K, C, ld,
                              s))
    return err;
  return run_tile(variant, (const float*)wt, ld, (const float*)theta,
                  (float*)b, C, K, P, grid, s);
}

// the fused entry's first stage alone: w (C, C) raw relevance -> wn (C, C)
// (the diagonal masked, rows normalized, zero rows kept zero), fp32,
// contiguous, on the current device; one normalize_kernel launch, so wn is
// the fused entry's Wn bit for bit (the skinny variant's one-warp sum adds
// the same terms in the same order at C <= 32). No main path calls it: it
// stays as the stage's standalone counterpart. Returns cudaGetLastError().
extern "C" int repro_normalize_relevance(const void* w, void* wn, int C,
                                         void* stream) {
  if (C == 0) return 0;
  if (C < 0) return (int)cudaErrorInvalidValue;
  normalize_kernel<<<C, kPrepThreads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (float*)wn, C);
  return (int)cudaGetLastError();
}

// w (R, C) normalized rows, theta (C, P), b (R, P); wt the scratch (C, ld)
// of the tiled and ragged variants (ld = R rounded up to 4; null for the
// skinny one); all fp32, contiguous, on the current device. variant and
// grid as _plan gives them. Returns cudaGetLastError() after the last
// launch.
extern "C" int repro_relevance_aggregate(const void* w, const void* theta,
                                         void* b, void* wt, int R, int C,
                                         long long P, int variant, int ld,
                                         long long grid, void* stream) {
  if (R == 0 || P == 0) return 0;
  if (bad_plan(variant, R, C, P, ld, grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kSkinny)
    return run_skinny<false>((const float*)w, (const float*)theta, (float*)b,
                             nullptr, R, C, 0, C, P, grid, s);
  if (int err = run_transpose((const float*)w, (float*)wt, R, C, C, ld, s))
    return err;
  return run_tile(variant, (const float*)wt, ld, (const float*)theta,
                  (float*)b, R, C, P, grid, s);
}
