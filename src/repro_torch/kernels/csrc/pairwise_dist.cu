// batched_pairwise_dist: per-client squared euclidean distance matrices, and
// pairwise_dist, the same for one query set and one gallery.
//
// batched_pairwise_dist replaces the Pallas TPU kernel
// src/repro/kernels/pairwise_dist.py:batched_pairwise_dist (_bdist_kernel):
//
//   out[c, i, j] = |q[c, i]|^2 + |g[c, j]|^2 - 2 (q[c, i] . g[c, j])
//
// with q (C, Q, D) and g (C, G, D) fp32, out (C, Q, G) fp32. Used by the
// fp32 serving path and by the batched retrieval evaluation of every round
// path.
//
// pairwise_dist replaces src/repro/kernels/pairwise_dist.py:pairwise_dist
// (_dist_kernel), the 2-D form (Q, D) x (G, D) -> (Q, G): the same body
// launched for one client. Neither package calls it on a main path (the
// per-query baseline takes the plain version, as the reference does).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at the fp32 serving shape (C=4, Q=64, G=32768, D=64) 67 MB move,
// half of it the output, against 1.07 GFLOP: 20 us of bytes, 16 us of
// FMAs, so bytes bound it by a little. At the round's evaluation shape
// ((5, 576, 64) x (5, 2304, 64)) 0.85 GFLOP against 30 MB: 12.7 us of FMAs
// against 9 us of bytes, so the FMA pipes do.
//
// Design (dist_tile.cuh, mode kFp32, variant from _plan): the tile variant
// holds an 8 x 8 block of outputs a thread (64 x 256 tiles, one query tile
// covers serving's 64 queries), stages both operands by 16-byte cp.async
// in a 2-stage ring with two blocks an SM, so copies, FMAs and the
// output's stores of the two blocks overlap, and chains |q|^2 and |g|^2
// once per row of a block instead of once per output; shapes without
// 16-byte rows or bases run the ragged variant (the 64 x 64, 4 x 4 tile).
// Both sum in the same order, so their outputs are equal bit for bit.
#include "dist_tile.cuh"

extern "C" int repro_batched_pairwise_dist(const void* q, const void* g,
                                           void* out, int C, int Q, int G,
                                           int D, int variant, void* stream) {
  return repro_dist::launch_dist<float, repro_dist::kFp32>(
      (const float*)q, (const float*)g, nullptr, nullptr, (float*)out, C, Q,
      G, D, variant, (cudaStream_t)stream);
}

extern "C" int repro_pairwise_dist(const void* q, const void* g, void* out,
                                   int Q, int G, int D, int variant,
                                   void* stream) {
  return repro_dist::launch_dist<float, repro_dist::kFp32>(
      (const float*)q, (const float*)g, nullptr, nullptr, (float*)out, 1, Q,
      G, D, variant, (cudaStream_t)stream);
}
