// kl_similarity: pairwise KL task similarity (paper Eq. 4).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kl_similarity.py:kl_similarity (_kl_kernel):
//
//   S[i, j] = exp(-(h_i - p_i . logq_j)),   p_i = softmax(a_i),
//   h_i = sum_d p_i[d] logp_i[d],           logq_j = log_softmax(b_j)
//
// (exp(-KL(p_i || q_j))).
//
// with a (N, D) and b (M, D) fp32, S (N, M) fp32. On the server's main path
// N = C (each client's newest task feature), M = C k (every client's ring
// of k task features) and D = 128.
//
// What bounds it on an H100: at C = 1000, k = 6 the product is 2 N M D =
// 1.5 GFLOP of fp32 FMA (23 us at 67 TFLOP/s) against 28 MB moved (8 us
// at 3.35 TB/s), so operations; at C = 5 it is a few microseconds of
// launch.
//
// Conditioning: h and p . logq are each about -log D for near-uniform rows,
// and S depends on their difference. Both are taken over logp + log D and
// logq + log D instead (the shift cancels exactly: both weigh it by the
// same p), which centres the summands near 0 and cuts the fp32 rounding
// of the difference from a few ulps of log D (~2e-6 in S at D = 128) to
// ~2e-7. The wrapper passes the fp32 log D that the plain version uses.
//
// Design: two launches on the caller's stream.
//   1. A row pass, one warp per row of a and of b: the lanes stride over D
//      (neighbouring lanes on neighbouring addresses), the max and the sum
//      of exp(x - max) are reduced with xor shuffles, then a's rows write
//      p = exp(x - max) / sum and h = sum p (logp + log D), and b's rows
//      write logq + log D = x - max - log(sum) + log D. The wrapper owns
//      the two fp32 scratch matrices; nothing is recomputed per tile.
//   2. The product p logq^T in 64 x 64 output tiles, 4 x 4 outputs per
//      thread in registers, both operands staged k-major in shared memory
//      (one float4 read each per k), IEEE fp32 FMAs in ascending d (no
//      TF32, no tensor cores: near-ties in the relevance feed the ranking
//      of neighbours), and the epilogue exp(cross - h_i). The ragged N and
//      M edges are masked in the loads and the stores.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 64;   // rows of a per tile
constexpr int kTM = 64;   // rows of b per tile
constexpr int kTK = 32;   // feature columns staged per step
constexpr int kPad = 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [0, N) are a's (write p and h), rows [N, N + M) are b's (write logq)
__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ p, float* __restrict__ h,
                float* __restrict__ logq, int N, int M, int D,
                float shift) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N + M) return;  // uniform across the warp
  const bool is_a = row < N;
  const float* x = is_a ? a + (size_t)row * D : b + (size_t)(row - N) * D;

  float m = -INFINITY;
  for (int d = lane; d < D; d += 32) m = fmaxf(m, x[d]);
  m = warp_max(m);
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += expf(x[d] - m);
  s = warp_sum(s);
  const float lse = logf(s);

  if (is_a) {
    float* pr = p + (size_t)row * D;
    float hh = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float sh = x[d] - m;
      const float pd = __fdiv_rn(expf(sh), s);
      pr[d] = pd;
      hh = fmaf(pd, (sh - lse) + shift, hh);
    }
    hh = warp_sum(hh);
    if (lane == 0) h[row] = hh;
  } else {
    float* lr = logq + (size_t)(row - N) * D;
    for (int d = lane; d < D; d += 32) lr[d] = ((x[d] - m) - lse) + shift;
  }
}

__global__ void __launch_bounds__(kThreads)
cross_tile_kernel(const float* __restrict__ p, const float* __restrict__ logq,
                  const float* __restrict__ h, float* __restrict__ out,
                  int N, int M, int D) {
  __shared__ __align__(16) float ps[kTK][kTN + kPad];
  __shared__ __align__(16) float qs[kTK][kTM + kPad];

  const int i0 = blockIdx.y * kTN;
  const int j0 = blockIdx.x * kTM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kTK) {
    for (int e = tid; e < kTN * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int i = i0 + r, d = k0 + k;
      ps[k][r] = (i < N && d < D) ? p[(size_t)i * D + d] : 0.f;
    }
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      const int r = e / kTK, k = e % kTK;
      const int j = j0 + r, d = k0 + k;
      qs[k][r] = (j < M && d < D) ? logq[(size_t)j * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&ps[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&qs[k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int jcol = j0 + tx * 4;
  const bool vec = (M % 4 == 0) && (jcol + 3 < M);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= N) break;
    const float hi = h[row];
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = expf(acc[i][j] - hi);
    float* o = out + (size_t)row * M + jcol;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (jcol + j < M) o[j] = r[j];
    }
  }
}

}  // namespace

// a: (N, D), b: (M, D), out: (N, M); scratch p: (N, D), h: (N,),
// logq: (M, D). All fp32, contiguous, on the current device; shift is the
// fp32 log(D). Returns cudaGetLastError() after the second launch (0 when
// both were accepted).
extern "C" int repro_kl_similarity(const void* a, const void* b, void* out,
                                   void* p, void* h, void* logq, int N, int M,
                                   int D, float shift, void* stream) {
  if ((long long)N * M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = N + M;
  row_pass_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      (const float*)a, (const float*)b, (float*)p, (float*)h, (float*)logq, N,
      M, D, shift);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN);
  cross_tile_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)p, (const float*)logq, (const float*)h, (float*)out, N, M,
      D);
  return (int)cudaGetLastError();
}
