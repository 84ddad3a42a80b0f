// batched_cluster_dist: IVF coarse distances, fp32 queries against each
// client's centroids.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ivf.py:batched_cluster_dist (_cdist_kernel):
//
//   out[c, b, l] = |q[c, b]|^2 + cn2[c, l] - 2 (q[c, b] . cent[c, l])
//
// with q (C, B, F) fp32, cent (C, L, F) fp32 centroids and cn2 (C, L) their
// squared norms, given (computed once at index refresh), not recomputed;
// out (C, B, L) fp32. The caller picks the nprobe nearest buckets from it
// with a stable sort (ties to the lowest bucket id).
//
// What bounds it on an H100: at the serving shapes (C=4, B=64, L=512, F=64)
// about 1.1 MB move against 16.8 MFLOP of fp32 FMA, a third of a
// microsecond either way: the launch itself (a few microseconds) bounds it.
//
// Design (dist_tile.cuh, mode kFp32Norms, variant from _plan in
// pairwise_dist.py): the same two variants as the other distance kernels,
// summing in the same order (IEEE fp32 FMAs, no TF32: probe selection
// ranks near-ties), |q|^2 chained from the staged query tile, the centroid
// norms read from cn2. At this shape the tile variant runs 16 tiles on 16
// SMs, one block's latency chain; it still ran a little ahead of the
// ragged variant's 32 blocks on the card, so the aligned case takes it.
#include "dist_tile.cuh"

extern "C" int repro_batched_cluster_dist(const void* q, const void* cent,
                                          const void* cn2, void* out, int C,
                                          int B, int L, int F, int variant,
                                          void* stream) {
  return repro_dist::launch_dist<float, repro_dist::kFp32Norms>(
      (const float*)q, (const float*)cent, nullptr, (const float*)cn2,
      (float*)out, C, B, L, F, variant, (cudaStream_t)stream);
}
