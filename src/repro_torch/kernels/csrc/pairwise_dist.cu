// batched_pairwise_dist: per-client squared euclidean distance matrices, and
// pairwise_dist, the same for one query set and one gallery.
//
// batched_pairwise_dist replaces the Pallas TPU kernel
// src/repro/kernels/pairwise_dist.py:batched_pairwise_dist (_bdist_kernel):
//
//   out[c, i, j] = |q[c, i]|^2 + |g[c, j]|^2 - 2 (q[c, i] . g[c, j])
//
// with q (C, Q, D) and g (C, G, D) fp32, out (C, Q, G) fp32. Used by the
// fp32 serving path and by the batched retrieval evaluation.
//
// pairwise_dist replaces src/repro/kernels/pairwise_dist.py:pairwise_dist
// (_dist_kernel), the 2-D form (Q, D) x (G, D) -> (Q, G): the same tile
// launched for one client. Neither package calls it on a main path (the
// per-query baseline takes the plain version, as the reference does).
//
// What bounds it on an H100: at the fp32 serving shapes (C=4, Q=64,
// G=32768, D=64) 67 MB move against 1.07 GFLOP of fp32 FMA, about 20 us and
// 16 us at the data-sheet rates: bytes by a little, with the output write
// the larger half of the bytes.
//
// Design (dist_tile.cuh): 64 x 64 output tiles, 4 x 4 outputs per thread in
// registers, both operands staged k-major in shared memory, IEEE fp32 FMAs,
// |q|^2 and |g|^2 reduced from the staged tiles in the same pass as the dot
// products (no separate norm pass over the gallery), float4 output stores.
#include "dist_tile.cuh"

extern "C" int repro_batched_pairwise_dist(const void* q, const void* g,
                                           void* out, int C, int Q, int G,
                                           int D, void* stream) {
  return repro_dist::launch_dist<float, repro_dist::kFp32>(
      (const float*)q, (const float*)g, nullptr, nullptr, (float*)out, C, Q,
      G, D, (cudaStream_t)stream);
}

extern "C" int repro_pairwise_dist(const void* q, const void* g, void* out,
                                   int Q, int G, int D, void* stream) {
  return repro_dist::launch_dist<float, repro_dist::kFp32>(
      (const float*)q, (const float*)g, nullptr, nullptr, (float*)out, 1, Q,
      G, D, (cudaStream_t)stream);
}
