// Shared tile body of the three squared-distance kernels (pairwise_dist.cu,
// cluster_dist.cu and int8_dist.cu): for every client c, query row b and
// gallery row g,
//
//   kFp32:       out[c, b, g] = |q_b|^2 + |g_g|^2 - 2 (q_b . g_g)
//   kFp32Norms:  out[c, b, g] = |q_b|^2 + n2[c, g] - 2 (q_b . g_g)
//   kInt8:       out[c, b, g] = |q_b|^2 + n2[c, g] - 2 ((q_b . code_g) s[c, g])
//
// Grid: (ceil(G / kTG), ceil(B / kTB), C). A block of 256 threads owns a
// kTB x kTG output tile; thread (ty, tx) of the 16 x 16 layout owns the 4 x 4
// register block of query rows ty*4.. and gallery rows tx*4... The feature
// axis is walked in steps of kTK columns: each step stages the q tile and the
// g tile (int8 codes widened to fp32 here) in shared memory, k-major so that
// a thread reads its 4 query values and its 4 gallery values as one float4
// each, and accumulates 16 products with IEEE fp32 FMAs (no TF32, no tensor
// cores: near-ties in the ranking depend on full fp32 sums). |q|^2, and for
// kFp32 |g|^2, are reduced from the same staged tiles, as the TPU kernels
// reduce them from their VMEM blocks; kFp32Norms and kInt8 read the given
// norms n2, as theirs do. The ragged B and G edges are
// masked in the loads and the stores; the wrapper pads nothing.
//
// The epilogue writes each thread's 4 consecutive outputs of a row as one
// float4 when G % 4 == 0 (every row then starts 16-byte aligned), so a warp
// stores two runs of 256 contiguous bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_dist {

constexpr int kTB = 64;       // query rows per block
constexpr int kTG = 64;       // gallery rows per block
constexpr int kTK = 32;       // feature columns staged per step
constexpr int kPad = 4;       // row padding that keeps float4 alignment
constexpr int kThreads = 256;

enum Gallery { kFp32 = 0, kFp32Norms = 1, kInt8 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

template <typename GT, int kMode>
__global__ void __launch_bounds__(kThreads)
dist_tile_kernel(const float* __restrict__ q, const GT* __restrict__ g,
                 const float* __restrict__ gscale,
                 const float* __restrict__ gn2, float* __restrict__ out,
                 int B, int G, int F) {
  __shared__ __align__(16) float qs[kTK][kTB + kPad];
  __shared__ __align__(16) float gs[kTK][kTG + kPad];

  const int c = blockIdx.z;
  const int b0 = blockIdx.y * kTB;
  const int g0 = blockIdx.x * kTG;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* qc = q + (size_t)c * B * F;
  const GT* gc = g + (size_t)c * G * F;

  float acc[4][4];
  float qq[4], gg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qq[i] = 0.f;
    gg[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < F; k0 += kTK) {
    // neighbouring threads read neighbouring feature columns of one row
    for (int e = tid; e < kTB * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int b = b0 + r, f = k0 + k;
      qs[k][r] = (b < B && f < F) ? qc[(size_t)b * F + f] : 0.f;
    }
    for (int e = tid; e < kTG * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int gi = g0 + r, f = k0 + k;
      gs[k][r] = (gi < G && f < F) ? widen(gc[(size_t)gi * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float v[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = fmaf(a[i], a[i], qq[i]);
        if (kMode == kFp32) gg[i] = fmaf(v[i], v[i], gg[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // per-column terms: |g|^2 and, for int8 codes, the row scale
  float n2[4], s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gi = g0 + tx * 4 + j;
    const bool in = gi < G;
    n2[j] = kMode == kFp32 ? gg[j] : (in ? gn2[(size_t)c * G + gi] : 0.f);
    s[j] = kMode == kInt8 && in ? gscale[(size_t)c * G + gi] : 1.f;
  }

  float* oc = out + (size_t)c * B * G;
  const int gcol = g0 + tx * 4;
  const bool vec = (G % 4 == 0) && (gcol + 3 < G);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) break;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = kMode == kInt8 ? qq[i] + n2[j] - 2.f * (acc[i][j] * s[j])
                            : qq[i] + n2[j] - 2.f * acc[i][j];
    float* row = oc + (size_t)b * G + gcol;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gcol + j < G) row[j] = r[j];
    }
  }
}

template <typename GT, int kMode>
int launch_dist(const float* q, const GT* g, const float* gscale,
                const float* gn2, float* out, int C, int B, int G, int F,
                cudaStream_t stream) {
  if ((long long)C * B * G == 0) return 0;
  const dim3 grid((G + kTG - 1) / kTG, (B + kTB - 1) / kTB, C);
  dist_tile_kernel<GT, kMode><<<grid, kThreads, 0, stream>>>(
      q, g, gscale, gn2, out, B, G, F);
  return (int)cudaGetLastError();
}

}  // namespace repro_dist
