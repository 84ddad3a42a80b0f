// The server's Eq. 6 aggregate, in two entry points over one tile product.
//
// fused_relevance_aggregate replaces the Pallas TPU kernel
// src/repro/kernels/relevance_aggregate.py:fused_relevance_aggregate
// (_fused_kernel), the stacked round's Eq. 5 -> 6 tail:
//
//   Wm = where(i == j, 0, W)          (no self-relevance; junk, even NaN,
//                                      on the diagonal never leaks)
//   Wn = where(rowsum(Wm) > 0, Wm / rowsum(Wm), 0)   (zero rows stay zero)
//   B  = Wn @ Theta                   (fp32 sums)
//
// with W (C, C) raw decayed relevance and Theta (C, P) the stacked client
// parameters, both fp32; outputs B (C, P) and Wn (C, C) fp32.
//
// relevance_aggregate replaces
// src/repro/kernels/relevance_aggregate.py:relevance_aggregate (_agg_kernel),
// the host server's plain product B = W @ Theta with W (R, C) already
// normalized, R <= C (the rows of clients with relevant neighbours), B (R, P).
//
// What bounds them on an H100: B does 2 R C P FLOPs over about 4 (R + C) P
// bytes, about R/4 FLOP per byte at R = C, against the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B. At C = 5 it is bytes (0.7 us at
// P = 57 664); above C ~ 80 it is fp32 FMAs (1.72 ms at C = 1000), not
// bandwidth.
//
// Design: the fused entry is two launches on the caller's stream, the plain
// entry the second alone.
//   1. The prologue normalizes W, one block per row: the diagonal is
//      replaced by 0 (a select, as the TPU kernel's `where`), the row sum
//      is reduced in the block, and each entry is divided by it with a
//      correctly rounded __fdiv_rn; a row whose sum is not > 0 (all zero,
//      or NaN off the diagonal) is written as zeros. Wn is written once.
//   2. The product W Theta with K = C, in 64 x 64 output tiles (64 rows of
//      W x 64 parameter columns), 4 x 4 outputs per thread in registers,
//      the W tile staged k-major and the Theta tile row-major in shared
//      memory (one float4 read each per k), IEEE fp32 FMAs in ascending k
//      (no TF32). Theta is read along P by neighbouring threads, so every
//      load is coalesced; B is written once. Ragged R, C and P are masked in
//      the loads and the stores.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 64;   // output rows (clients) per tile
constexpr int kTP = 64;   // output columns (parameters) per tile
constexpr int kTK = 32;   // contraction (source clients) per step
constexpr int kPad = 4;

__global__ void __launch_bounds__(kThreads)
normalize_kernel(const float* __restrict__ w, float* __restrict__ wn, int C) {
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  const int i = blockIdx.x;
  const float* wr = w + (size_t)i * C;
  float s = 0.f;
  for (int j = threadIdx.x; j < C; j += kThreads)
    s += (j == i) ? 0.f : wr[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) t += partial[k];
    total = t;
  }
  __syncthreads();
  const float rows = total;
  const bool pos = rows > 0.f;  // false for 0 and for NaN
  float* out = wn + (size_t)i * C;
  for (int j = threadIdx.x; j < C; j += kThreads)
    out[j] = (pos && j != i) ? __fdiv_rn(wr[j], rows) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
aggregate_tile_kernel(const float* __restrict__ wn,
                      const float* __restrict__ theta, float* __restrict__ b,
                      int R, int C, long long P) {
  __shared__ __align__(16) float ws[kTK][kTR + kPad];
  __shared__ __align__(16) float ts[kTK][kTP + kPad];

  const int r0 = blockIdx.y * kTR;
  const long long p0 = (long long)blockIdx.x * kTP;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kTK) {
    // W tile: neighbouring threads read neighbouring k of one row
    for (int e = tid; e < kTR * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int row = r0 + r, kk = k0 + k;
      ws[k][r] = (row < R && kk < C) ? wn[(size_t)row * C + kk] : 0.f;
    }
    // Theta tile: neighbouring threads read neighbouring parameters
    for (int e = tid; e < kTK * kTP; e += kThreads) {
      const int k = e / kTP, c = e % kTP;
      const int kk = k0 + k;
      const long long col = p0 + c;
      ts[k][c] = (kk < C && col < P) ? theta[(size_t)kk * P + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&ws[k][ty * 4]);
      const float4 t4 = *reinterpret_cast<const float4*>(&ts[k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], tv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long col = p0 + tx * 4;
  const bool vec = (P % 4 == 0) && (col + 3 < P);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= R) break;
    float* o = b + (size_t)row * P + col;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < P) o[j] = acc[i][j];
    }
  }
}

int launch_product(const float* w, const float* theta, float* b, int R,
                   int C, long long P, cudaStream_t s) {
  if (R == 0 || P == 0) return 0;
  const long long tiles = (P + kTP - 1) / kTP;
  const dim3 grid((unsigned)tiles, (R + kTR - 1) / kTR);
  aggregate_tile_kernel<<<grid, kThreads, 0, s>>>(w, theta, b, R, C, P);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (C, C), theta: (C, P), b: (C, P), wn: (C, C); all fp32, contiguous, on
// the current device. Returns cudaGetLastError() after the second launch.
extern "C" int repro_fused_relevance_aggregate(const void* w,
                                               const void* theta, void* b,
                                               void* wn, int C, long long P,
                                               void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  normalize_kernel<<<C, kThreads, 0, s>>>((const float*)w, (float*)wn, C);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_product((const float*)wn, (const float*)theta, (float*)b, C,
                        C, P, s);
}

// w: (R, C), theta: (C, P), b: (R, P); all fp32, contiguous, on the current
// device. Returns cudaGetLastError().
extern "C" int repro_relevance_aggregate(const void* w, const void* theta,
                                         void* b, int R, int C, long long P,
                                         void* stream) {
  return launch_product((const float*)w, (const float*)theta, (float*)b, R, C,
                        P, (cudaStream_t)stream);
}
