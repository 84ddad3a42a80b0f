// batched_ivf_shortlist_scores: score the probed buckets of the bucket-major
// int8 IVF image.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ivf.py:batched_ivf_shortlist_scores (_shortlist_kernel):
//
//   d[c, b, j, k]   = n2 - 2 ((q[c, b] . code) s)        for the slot k of
//   ids[c, b, j, k] = id                                  bucket probe[c, b, j]
//
// with q (C, B, F) fp32, probe (C, B, P) int32 bucket ids, bq (C, L, K, F)
// int8 bucket rows (empty slots zeroed) and pack (C, L, 3, K) fp32, the
// sidecar [row scale; |dequantized row|^2; row id bitcast int32 -> fp32].
// Outputs d (C, B, P, K) fp32 and ids (C, B, P, K) int32 (-1 on empty
// slots). This kernel writes the ids itself from the sidecar's third row,
// which the reference's dispatcher gathers in a second pass
// (take_along_axis); the caller adds |q|^2 and masks ids < 0.
//
// On the TPU the data-dependent bucket gather is scalar-prefetch BlockSpec
// indexing. Here a block reads its own probe id and offsets its pointers
// into bq[c, probe] (K * F contiguous bytes) and pack[c, probe]. A probe id
// outside [0, L) scores as an empty bucket (ids -1) instead of reading out
// of bounds.
//
// What bounds it on an H100: bytes. At the serving shapes (C=4, B=64, P=8,
// K=384, F=64) each probe reads one 24 KiB bucket plus its 4.5 KiB sidecar,
// 2048 probes in all, and writes 2048 * 384 distances and ids (6.3 MB);
// the 100 MFLOP of FMAs are far below the fp32 peak.
//
// Design: one block of 128 threads per (c, b, j); the block stages q (F
// floats) in shared memory once, then each thread owns slots k, k + 128,
// ...: it reads its row's codes as 16-byte vectors (when F % 16 == 0; byte
// loads otherwise), widens them to fp32 and accumulates q . code with IEEE
// fp32 FMAs in ascending feature order, then writes n2 - 2 (dot s) in that
// order and the id. Consecutive threads read consecutive rows, so a warp's
// loads walk 32 rows of one bucket; the ids and distances it writes are
// contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
shortlist_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                 const int8_t* __restrict__ bq, const float* __restrict__ pack,
                 float* __restrict__ d, int* __restrict__ ids, int B, int P,
                 int L, int K, int F) {
  extern __shared__ float qs[];
  const int j = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const size_t cb = (size_t)c * B + b;
  for (int f = threadIdx.x; f < F; f += kThreads) qs[f] = q[cb * F + f];
  __syncthreads();

  const int l = probe[cb * P + j];
  const size_t out0 = (cb * P + j) * K;
  if (l < 0 || l >= L) {
    for (int k = threadIdx.x; k < K; k += kThreads) {
      d[out0 + k] = 0.f;
      ids[out0 + k] = -1;
    }
    return;
  }
  const size_t bucket = (size_t)c * L + l;
  const int8_t* rows = bq + bucket * K * F;
  const float* scale = pack + bucket * 3 * K;
  const float* n2 = scale + K;
  const float* idf = n2 + K;

  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int8_t* row = rows + (size_t)k * F;
    float acc = 0.f;
    if (F % 16 == 0) {
      for (int f0 = 0; f0 < F; f0 += 16) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(row + f0));
        const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float x = (float)(int8_t)(w[e / 4] >> (8 * (e % 4)));
          acc = fmaf(qs[f0 + e], x, acc);
        }
      }
    } else {
      for (int f = 0; f < F; ++f) acc = fmaf(qs[f], (float)row[f], acc);
    }
    d[out0 + k] = n2[k] - 2.f * (acc * scale[k]);
    ids[out0 + k] = __float_as_int(idf[k]);
  }
}

}  // namespace

extern "C" int repro_batched_ivf_shortlist_scores(
    const void* q, const void* probe, const void* bq, const void* pack,
    void* d, void* ids, int C, int B, int P, int L, int K, int F,
    void* stream) {
  if ((long long)C * B * P * K == 0) return 0;
  const dim3 grid(P, B, C);
  shortlist_kernel<<<grid, kThreads, F * sizeof(float),
                     (cudaStream_t)stream>>>(
      (const float*)q, (const int*)probe, (const int8_t*)bq,
      (const float*)pack, (float*)d, (int*)ids, B, P, L, K, F);
  return (int)cudaGetLastError();
}
