// batched_int8_pairwise_dist: fp32 queries against the int8 resident
// gallery of the serving index.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/int8_dist.py:batched_int8_pairwise_dist (_i8dist_kernel):
//
//   out[c, b, g] = |q[c, b]|^2 + gn2[c, g] - 2 * ((q[c, b] . gq[c, g]) * gscale[c, g])
//
// with q (C, B, F) fp32, gq (C, G, F) int8 codes, gscale and gn2 (C, G) fp32
// (per-row scale and the squared norm of the dequantized row, computed once
// at index refresh), out (C, B, G) fp32.
//
// What bounds it on an H100: at the serving shapes (C=4, B=64, G=131072,
// F=64) about 172 MB move, of which 134 MB is the (C, B, G) output, against
// 4.3 GFLOP of fp32 FMA: the two bounds are close (about 51 us of bytes and
// 64 us of fp32 FMA at the data-sheet rates), so the kernel must both keep
// the FMA pipes busy and stream its output under them.
//
// Design (dist_tile.cuh, mode kInt8, variant from _plan in pairwise_dist.py):
// the tile variant (F % 16 == 0, 16-byte bases) copies the codes as bytes
// by 16-byte cp.async (the gallery crosses HBM once, as int8), widens them
// to fp32 once a stage into shared memory by byte permutes and an exact
// subtraction (no I2F, which would run at an eighth of the FMA rate), and
// multiplies them against the block's 64 queries, all of serving's batch,
// as 8 x 8 register blocks over 64 x 256 tiles with the next stage's copy
// in flight and two blocks an SM, so one block's output stores run under
// the other's FMAs. |q|^2 is chained once per query row of a block; gn2 and
// gscale are read once per block. Other widths and bases run the ragged
// variant (the 64 x 64, 4 x 4 tile). The ranking that follows reads the
// whole matrix, as the reference's does; cutting those output bytes is the
// rank stage's work (ROADMAP, Queue 1 item 0b), not this kernel's.
#include "dist_tile.cuh"

extern "C" int repro_batched_int8_pairwise_dist(
    const void* q, const void* gq, const void* gscale, const void* gn2,
    void* out, int C, int B, int G, int F, int variant, void* stream) {
  return repro_dist::launch_dist<int8_t, repro_dist::kInt8>(
      (const float*)q, (const int8_t*)gq, (const float*)gscale,
      (const float*)gn2, (float*)out, C, B, G, F, variant,
      (cudaStream_t)stream);
}
