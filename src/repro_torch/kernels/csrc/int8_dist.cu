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
// 64 us of fp32 FMA at the data-sheet rates), so the kernel must both stream
// its output at full width and keep the FMA pipes busy.
//
// Design (dist_tile.cuh): 64 x 64 output tiles, 4 x 4 outputs per thread in
// registers, codes widened to fp32 while they are staged in shared memory
// (the gallery crosses HBM once, as int8), IEEE fp32 FMAs over F, |q|^2
// reduced in the kernel, float4 output stores. Top-k is not fused here, so
// the full (C, B, G) matrix is written and read back by the ranking; fusing
// the selection into this kernel is the redesign that removes the output
// bytes.
#include "dist_tile.cuh"

extern "C" int repro_batched_int8_pairwise_dist(
    const void* q, const void* gq, const void* gscale, const void* gn2,
    void* out, int C, int B, int G, int F, void* stream) {
  return repro_dist::launch_dist<int8_t, repro_dist::kInt8>(
      (const float*)q, (const int8_t*)gq, (const float*)gscale,
      (const float*)gn2, (float*)out, C, B, G, F, (cudaStream_t)stream);
}
